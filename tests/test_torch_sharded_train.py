"""The port's sharded LLaMA train step (``paddle_tpu_torch.models.llama``:
``param_specs``, ``batch_spec``, ``shard_params`` and the sharded path of
``forward``, ``loss_fn`` and ``make_train_step``) against the JAX
package's and against the port's own serial step, on the same weights.

The mesh is dp 2 x mp 2 x sharding 2: JAX's over the 8-device CPU mesh of
``tests/conftest.py``, the port's over ``["cpu"] * 8`` (one controller
over a placement). The config is ``tests/test_llama.py``'s tiny one
(vocab 96, hidden 32, 2 layers, 4 heads, 2 kv heads) at fp32, weights
from the JAX ``init_params`` through ``params_from_jax``, ids from numpy
with a seed. Tolerances are the reference's ``TestShardedTraining``: the
loss within 1e-5 and every parameter within 1e-3 after one AdamW step
(Adam's first step normalises by sqrt(v), so near-zero gradients turn
fp32 reduction-order noise into visible steps). With ``use_kernels`` and
``use_fused_norm`` the JAX side runs its Pallas kernels in interpret mode
and the port its kernels' plain CPU versions. The dp replicas of every
leaf and moment must be bit-equal; the sentinel's skipped step leaves
every coordinate's bits; the ZeRO layout's bytes a placement entry stay
below 0.6 x the replicated layout's (``tests/test_llama.py:168``); the
checkpoint files cross both ways with JAX's sharded saves, bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

from paddle_tpu.distributed import checkpoint as JC
from paddle_tpu.distributed.topology import build_mesh as jbuild_mesh
from paddle_tpu.models import llama as JL
from paddle_tpu_torch.distributed import checkpoint as TC
from paddle_tpu_torch.distributed.sharding import (ShardedTensor, assemble,
                                                   shard_to_mesh)
from paddle_tpu_torch.distributed.topology import build_mesh
from paddle_tpu_torch.health.sentinel import sentinel_init, unpack_health
from paddle_tpu_torch.models import llama as TL
from paddle_tpu_torch.models.convert import (config_from_jax,
                                             params_from_jax,
                                             specs_from_jax, to_numpy)

torch.set_num_threads(2)

DEG = {"dp": 2, "mp": 2, "sharding": 2}
CPU8 = ["cpu"] * 8
B, S = 4, 16


def tiny_cfg(**kw):
    base = dict(vocab_size=96, hidden_size=32, intermediate_size=64,
                num_hidden_layers=2, num_attention_heads=4,
                num_key_value_heads=2, use_kernels=False)
    base.update(kw)
    return JL.LlamaConfig(**base)


def _setup(seed=5, **kw):
    jcfg = tiny_cfg(**kw)
    jp = JL.init_params(jcfg, jax.random.PRNGKey(seed))
    return jcfg, config_from_jax(jcfg), jp


def _port(jp):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")


def _ids(seed=1):
    return np.random.default_rng(seed).integers(0, 96, (B, S)).astype(
        np.int32)


def _meshes(deg=DEG):
    n = int(np.prod(list(deg.values())))
    return jbuild_mesh(deg, jax.devices()[:n]), build_mesh(deg, ["cpu"] * n)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def _coord(jmesh, device):
    return tuple(int(i) for i in np.argwhere(jmesh.devices == device)[0])


def _replicas_equal(tree):
    """Every coordinate holding the same slice of a leaf holds the same
    bits."""
    for name, st in _flat(tree).items():
        for idx, c in st.unique():
            for c2 in st.mesh.coords():
                if st.index(c2) == idx:
                    assert torch.equal(st.local(c2), st.local(c)), (name, c2)


def _close(got, want, atol, what):
    for k, a in _flat(want).items():
        np.testing.assert_allclose(_flat(got)[k], np.asarray(a), atol=atol,
                                   rtol=0, err_msg=f"{what}: {k}")


# ---------------------------------------------------------------------------
# the layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["dense", "tied", "moe"])
@pytest.mark.parametrize("mp", [None, "mp"])
@pytest.mark.parametrize("fs", [None, "sharding"])
def test_param_specs_match_jax(kind, mp, fs):
    kw = {"dense": {}, "tied": {"tie_word_embeddings": True},
          "moe": {"moe_num_experts": 4}}[kind]
    jcfg = tiny_cfg(**kw)
    assert TL.param_specs(config_from_jax(jcfg), mp, fs) == \
        specs_from_jax(JL.param_specs(jcfg, mp, fs))


def test_batch_spec_matches_jax():
    for axes in (("dp",), ("dp", "sharding"), ("dp", None)):
        assert TL.batch_spec(axes) == tuple(JL.batch_spec(axes))
    assert TL.batch_spec(("dp",), "sep") == tuple(JL.batch_spec(("dp",),
                                                                "sep"))


@pytest.mark.parametrize("kind", ["dense", "tied"])
def test_shards_equal_jax_addressable_shards(kind):
    """Each coordinate's local tensor is the data JAX's array holds on the
    device at that coordinate, and params_from_jax of JAX's sharded tree
    is the serial tree."""
    jcfg, tcfg, jp = _setup(tie_word_embeddings=kind == "tied")
    jmesh, tmesh = _meshes()
    jps = JL.shard_params(jp, jmesh, jcfg, mp_axis="mp",
                          fsdp_axis="sharding")
    tps = TL.shard_params(_port(jp), tmesh, tcfg, mp_axis="mp",
                          fsdp_axis="sharding")
    assert TL.is_sharded(tps) and not TL.is_sharded(_port(jp))
    jflat, tflat = _flat(jps), _flat(tps)
    assert sorted(jflat) == sorted(tflat)
    for name, ja in jflat.items():
        st = tflat[name]
        assert st.spec == tuple(ja.sharding.spec) + (None,) * (
            len(st.spec) - len(tuple(ja.sharding.spec)))
        seen = set()
        for sh in ja.addressable_shards:
            c = _coord(jmesh, sh.device)
            seen.add(c)
            np.testing.assert_array_equal(st.local(c).numpy(),
                                          np.asarray(sh.data), err_msg=name)
            assert st.index(c) == tuple((s.start or 0, s.stop, s.step or 1)
                                        for s in sh.index)
        assert len(seen) == 8
    serial = to_numpy(_port(jp))
    for k, a in _flat(to_numpy(_port(jax.tree_util.tree_map(np.asarray,
                                                            jps)))).items():
        np.testing.assert_array_equal(a, _flat(serial)[k])
    for k, a in _flat(to_numpy(tps)).items():
        np.testing.assert_array_equal(a, _flat(serial)[k])


def test_indivisible_layouts_raise():
    _, tmesh = _meshes()
    _, tcfg, jp = _setup()
    p = _port(jp)
    p97 = dict(p, embed=torch.zeros(97, 32))
    with pytest.raises(ValueError, match=r"params\.embed: dim 0 \(size 97"
                       r".*mesh axis 'mp' \(size 2\)"):
        TL.shard_params(p97, tmesh, tcfg)
    mp4 = build_mesh({"mp": 4, "dp": 2}, CPU8)
    with pytest.raises(ValueError, match=r"wk: 2 heads do not split over "
                       r"mesh axis 'mp' \(size 4\)"):
        TL.shard_params(p, mp4, tcfg)
    with pytest.raises(ValueError, match="input_ids"):
        shard_to_mesh(torch.zeros(3, 4), tmesh, TL.batch_spec(), "input_ids")


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------

def _jax_steps(jcfg, jp, ids, dp_axes, lr=1e-2):
    """(serial (params, loss), sharded (params, loss)) of one JAX step."""
    init_opt, step = JL.make_train_step(jcfg, lr=lr)
    idj = jnp.asarray(ids)
    p1, _, l1 = jax.jit(step)(jp, init_opt(jp), idj, idj)
    jmesh, _ = _meshes()
    ps = JL.shard_params(jp, jmesh, jcfg, mp_axis="mp", fsdp_axis="sharding")
    ids_s = jax.device_put(idj, NamedSharding(jmesh, JL.batch_spec(dp_axes)))
    p2, _, l2 = jax.jit(step)(ps, jax.device_put(init_opt(ps)), ids_s, ids_s)
    tree = jax.tree_util.tree_map(np.asarray, (p1, p2))
    return (tree[0], float(l1)), (tree[1], float(l2))


def _port_steps(tcfg, jp, ids, dp_axes, steps=1, lr=1e-2, check=None):
    """(serial (params, losses), sharded (params tree, losses, opt))."""
    init_opt, step = TL.make_train_step(tcfg, lr=lr)
    idt = torch.from_numpy(ids)
    p, o = _port(jp), None
    o = init_opt(p)
    serial = []
    for _ in range(steps):
        p, o, l_ = step(p, o, idt, idt)
        serial.append(float(l_))
    _, tmesh = _meshes()
    ps = TL.shard_params(_port(jp), tmesh, tcfg, mp_axis="mp",
                         fsdp_axis="sharding")
    ids_s = shard_to_mesh(idt, tmesh, TL.batch_spec(dp_axes))
    os_ = init_opt(ps)
    sharded = []
    for _ in range(steps):
        ps, os_, l_ = step(ps, os_, ids_s, ids_s)
        sharded.append(float(l_))
        if check is not None:
            check(ps, os_)
    return (to_numpy(p), serial), (ps, sharded, os_)


@pytest.mark.parametrize("kernels", [False, True],
                         ids=["plain", "kernels"])
@pytest.mark.parametrize("dp_axes", [("dp",), ("dp", "sharding")],
                         ids=["dp", "dp-sharding"])
def test_one_step_matches_jax_and_serial(dp_axes, kernels):
    jcfg, tcfg, jp = _setup(use_kernels=kernels, use_fused_norm=kernels)
    ids = _ids()
    (jser, jl1), (jsh, jl2) = _jax_steps(jcfg, jp, ids, dp_axes)
    (tser, (tl1,)), (ps, (tl2,), opt) = _port_steps(tcfg, jp, ids, dp_axes)
    assert abs(tl2 - jl2) <= 1e-5 and abs(tl2 - tl1) <= 1e-5
    assert abs(jl1 - jl2) <= 1e-5
    got = to_numpy(ps)
    _close(got, jsh, 1e-3, "port sharded vs JAX sharded")
    _close(got, tser, 1e-3, "port sharded vs port serial")
    _replicas_equal(ps)
    _replicas_equal(opt["m"])
    _replicas_equal(opt["v"])
    assert int(opt["step"]) == 1


@pytest.mark.parametrize("case", ["tied", "ce_chunks", "remat"])
def test_step_variants_match_serial(case):
    """Tied embeddings (the head is the transposed vocab-parallel embed),
    token-chunked vocab-parallel cross-entropy, and full remat: two steps
    against the port's serial step (losses 1e-5, params 1e-3), the first
    also against JAX's sharded step, replicas bit-equal after each."""
    kw = {"tied": {"tie_word_embeddings": True},
          "ce_chunks": {"ce_chunks": 2},
          "remat": {"remat": True, "use_kernels": True}}[case]
    jcfg, tcfg, jp = _setup(**kw)
    ids = _ids(2)
    (tser, l1), (ps, l2, _) = _port_steps(
        tcfg, jp, ids, ("dp", "sharding"), steps=2,
        check=lambda p, o: (_replicas_equal(p), _replicas_equal(o["m"])))
    np.testing.assert_allclose(l2, l1, atol=1e-5, rtol=0)
    _close(to_numpy(ps), tser, 1e-3, case)
    if case == "tied":
        _, (jsh, jl2) = _jax_steps(jcfg, jp, ids, ("dp", "sharding"))
        (_, _), (ps1, (tl,), _) = _port_steps(tcfg, jp, ids,
                                              ("dp", "sharding"))
        assert abs(tl - jl2) <= 1e-5
        _close(to_numpy(ps1), jsh, 1e-3, "tied vs JAX sharded")


def test_forward_logits_match_serial():
    jcfg, tcfg, jp = _setup()
    _, tmesh = _meshes()
    ps = TL.shard_params(_port(jp), tmesh, tcfg, mp_axis="mp",
                         fsdp_axis="sharding")
    ids = torch.from_numpy(_ids())
    want = TL.forward(_port(jp), ids, tcfg)
    ids_s = shard_to_mesh(ids, tmesh, TL.batch_spec(("dp", "sharding")))
    for given in (ids, ids_s):      # a plain batch splits over dp
        got = TL.forward(ps, given, tcfg)
        assert got.shape == (B, S, 96)
        torch.testing.assert_close(got, want, atol=2e-5, rtol=0)
    hid = TL.forward(ps, ids_s, tcfg, return_hidden=True)
    torch.testing.assert_close(
        hid, TL.forward(_port(jp), ids, tcfg, return_hidden=True),
        atol=2e-5, rtol=0)


def test_sentinel_skips_a_nan_batch_and_oov_gives_nan():
    """An out-of-vocab id embeds as NaN: the sharded loss is NaN, as the
    serial one is; the sentinel step judges it bad on the lead device and
    every coordinate's params and moments keep their bits, the step count
    too; the next clean step updates."""
    jcfg, tcfg, jp = _setup()
    _, tmesh = _meshes()
    ps = TL.shard_params(_port(jp), tmesh, tcfg, mp_axis="mp",
                         fsdp_axis="sharding")
    bad = _ids()
    bad[1, 3] = 96
    bad_t, good = torch.from_numpy(bad), torch.from_numpy(_ids())
    assert torch.isnan(TL.loss_fn(_port(jp), bad_t, good, tcfg))
    assert torch.isnan(TL.loss_fn(ps, bad_t, good, tcfg))
    init_opt, step = TL.make_train_step(tcfg, lr=1e-2, sentinel=True)
    opt, sent = init_opt(ps), sentinel_init("cpu")
    ps, opt, sent, h = step(ps, opt, sent, good, good)
    assert not unpack_health(h)[1]
    before = {k: {c: t.clone() for c, t in st.locals.items()}
              for k, st in _flat({"p": ps, "m": opt["m"],
                                  "v": opt["v"]}).items()}
    ids_s = shard_to_mesh(bad_t, tmesh, TL.batch_spec(("dp", "sharding")))
    lbl_s = shard_to_mesh(good, tmesh, TL.batch_spec(("dp", "sharding")))
    ps, opt, sent, h = step(ps, opt, sent, ids_s, lbl_s)
    assert unpack_health(h)[1] and int(opt["step"]) == 1
    for k, st in _flat({"p": ps, "m": opt["m"], "v": opt["v"]}).items():
        for c, t in st.locals.items():
            assert torch.equal(t, before[k][c]), (k, c)
    ps, opt, sent, h = step(ps, opt, sent, good, good)
    assert not unpack_health(h)[1] and int(opt["step"]) == 2
    assert not torch.equal(ps["embed"].local((0,) * 6),
                           before["p.embed"][(0,) * 6])
    _replicas_equal(ps)


def test_unported_layouts_refused():
    """A named remat_policy raises NotImplementedError naming what is not
    ported; a pp degree > 1 has no ``shard_params`` layout (JAX's
    ``param_specs`` has none either) and the error names the pp layout.
    MoE layouts (refused until expert parallelism was ported) lay out:
    the experts whole on every entry without an ``ep_axis``
    (``tests/test_torch_ep.py`` holds the sharded MoE step)."""
    _, tmesh = _meshes()
    jcfg, tcfg, jp = _setup()
    p = _port(jp)
    moe_j = tiny_cfg(moe_num_experts=4)
    moe_p = _port(JL.init_params(moe_j, jax.random.PRNGKey(0)))
    moe_s = TL.shard_params(moe_p, tmesh, config_from_jax(moe_j))
    assert moe_s["layers"]["w_gate"].spec == (None, None, None, "mp")
    import dataclasses
    with pytest.raises(NotImplementedError, match="to_pp_layout and "
                       "pp_param_specs"):
        TL.shard_params(p, build_mesh({"pp": 2, "dp": 4}, CPU8), tcfg)
    ps = TL.shard_params(p, tmesh, tcfg)
    ids = torch.from_numpy(_ids())
    pol = dataclasses.replace(tcfg, remat=True, remat_policy="save_flash")
    with pytest.raises(NotImplementedError, match="remat_policy"):
        TL.loss_fn(ps, ids, ids, pol)


def test_sep_layout_matches_serial():
    """``sep_axis`` in the sharded path (it was refused): at dp 2 x sep 4,
    the batch over ``batch_spec(("dp",), "sep")`` and S 32 (8 tokens a
    sequence part, so a part's RoPE rows from the wrong offset would
    show), the loss within 1e-5 of the serial step's and every gradient
    slice within 1e-5 x max|g|, ring and Ulysses."""
    import dataclasses
    jcfg, tcfg, jp = _setup(num_key_value_heads=4)
    p = _port(jp)
    ids = torch.from_numpy(np.random.default_rng(4).integers(
        0, 96, (2, 32)).astype(np.int32))
    for p_ in TL._leaves(p):
        p_.requires_grad_(True)
    loss = TL.loss_fn(p, ids, ids, tcfg)
    want = dict(zip([n for n, _ in TL._named(p)],
                    torch.autograd.grad(loss, TL._leaves(p))))
    mesh = build_mesh({"dp": 2, "sep": 4}, CPU8)
    for impl in ("ring", "ulysses"):
        cfg = dataclasses.replace(tcfg, sep_axis="sep", cp_impl=impl)
        ps = TL.shard_params(_port(jp), mesh, cfg, mp_axis=None)
        b = shard_to_mesh(ids, mesh, TL.batch_spec(("dp",), "sep"))
        got, grads = TL._sharded_grads(ps, b, b, cfg)
        assert abs(got.item() - loss.item()) <= 1e-5
        for n, st in TL._named(ps):
            g = want[n]
            for c, gc in grads[n].items():
                sl = tuple(slice(a, b_) for a, b_, _ in st.index(c))
                assert (gc - g[sl]).abs().max() <= 1e-5 * g.abs().max(), n


def test_zero_bytes_a_placement_entry():
    """``tests/test_llama.py:168`` on the port: at dp 2 x sharding 4 with
    the batch over both, params + m + v + gradients a placement entry
    under the fsdp layout are below 0.6 x the replicated layout's."""
    jcfg = tiny_cfg(vocab_size=512, hidden_size=128, intermediate_size=256,
                    num_hidden_layers=4, num_attention_heads=4,
                    num_key_value_heads=4)
    tcfg = config_from_jax(jcfg)
    p = _port(JL.init_params(jcfg, jax.random.PRNGKey(0)))
    _, tmesh = _meshes({"dp": 2, "sharding": 4})
    ids = shard_to_mesh(torch.zeros((8, 8), dtype=torch.int32), tmesh,
                        TL.batch_spec(("dp", "sharding")))
    c0 = (0,) * 6

    def footprint(fsdp):
        ps = TL.shard_params(p, tmesh, tcfg, mp_axis=None, fsdp_axis=fsdp)
        init_opt, _ = TL.make_train_step(tcfg, lr=1e-3)
        opt = init_opt(ps)
        _, grads = TL._sharded_grads(ps, ids, ids, tcfg)
        g = sum(gs[c0].numel() * gs[c0].element_size()
                for gs in grads.values())
        return (TL.placement_bytes(ps, c0) + TL.placement_bytes(opt, c0)
                + g)

    fs, rp = footprint("sharding"), footprint(None)
    assert fs < 0.6 * rp, (fs, rp)


# ---------------------------------------------------------------------------
# checkpoints of a sharded state
# ---------------------------------------------------------------------------

def test_jax_sharded_checkpoint_loads_into_port_shards(tmp_path):
    jcfg, tcfg, jp = _setup(seed=7)
    jmesh, tmesh = _meshes()
    jps = JL.shard_params(jp, jmesh, jcfg, mp_axis="mp",
                          fsdp_axis="sharding")
    JC.save_state_dict({"params": jps}, str(tmp_path / "j"))
    dst = TL.shard_params(TL.init_params(tcfg, seed=0, device="cpu"), tmesh,
                          tcfg, mp_axis="mp", fsdp_axis="sharding")
    TC.load_state_dict({"params": dst}, str(tmp_path / "j"))
    for name, ja in _flat(jps).items():
        st = _flat(dst)[name]
        for sh in ja.addressable_shards:
            np.testing.assert_array_equal(
                st.local(_coord(jmesh, sh.device)).numpy(),
                np.asarray(sh.data), err_msg=name)


def test_port_sharded_checkpoint_loads_in_jax(tmp_path):
    jcfg, tcfg, jp = _setup(seed=8)
    jmesh, tmesh = _meshes()
    ps = TL.shard_params(_port(jp), tmesh, tcfg, mp_axis="mp",
                         fsdp_axis="sharding")
    TC.save_state_dict({"params": ps}, str(tmp_path / "t"))
    zeros = jax.tree_util.tree_map(jnp.zeros_like, jp)
    jdst = {"params": JL.shard_params(zeros, jmesh, jcfg, mp_axis="mp",
                                      fsdp_axis="sharding")}
    JC.load_state_dict(jdst, str(tmp_path / "t"))
    for name, ja in _flat(jdst["params"]).items():
        np.testing.assert_array_equal(np.asarray(ja),
                                      _flat(to_numpy(ps))[name])
        assert ja.sharding.spec == _flat(JL.param_specs(
            jcfg, "mp", "sharding"))[name]
    # each distinct slice is written once: embed's 4 of its 8 coordinates
    import pickle
    with open(tmp_path / "t" / "metadata.pkl", "rb") as f:
        recs = pickle.load(f)
    assert len(recs["params.embed"]["shards"]) == 4
    assert len(recs["params.ln_f"]["shards"]) == 1


def test_async_checkpointer_round_trips_a_sharded_state(tmp_path):
    """A sharded train state (params, m, v after a step, the step count)
    saved by AsyncCheckpointer restores bit-equal into a serial state and
    into a fresh sharded one."""
    jcfg, tcfg, jp = _setup()
    _, tmesh = _meshes()
    ps = TL.shard_params(_port(jp), tmesh, tcfg, mp_axis="mp",
                         fsdp_axis="sharding")
    init_opt, step = TL.make_train_step(tcfg, lr=1e-2)
    ids = shard_to_mesh(torch.from_numpy(_ids()), tmesh, TL.batch_spec())
    ps, opt, _ = step(ps, init_opt(ps), ids, ids)
    ck = TC.AsyncCheckpointer(str(tmp_path / "series"))
    ck.save({"params": ps, "opt": opt}, 1)
    ck.wait()
    serial = {"params": TL.init_params(tcfg, seed=3, device="cpu")}
    serial["opt"] = init_opt(serial["params"])
    assert ck.restore(serial) == 1
    fresh = TL.shard_params(TL.init_params(tcfg, seed=3, device="cpu"),
                            tmesh, tcfg, mp_axis="mp", fsdp_axis="sharding")
    sharded = {"params": fresh, "opt": init_opt(fresh)}
    assert ck.restore(sharded) == 1
    src = _flat({"params": ps, "opt": {"m": opt["m"], "v": opt["v"]}})
    for name, st in src.items():
        np.testing.assert_array_equal(
            _flat(to_numpy(serial))[name], assemble(st).numpy(), name)
        dst = _flat(sharded)[name]
        for c in tmesh.coords():
            assert torch.equal(dst.local(c), st.local(c)), (name, c)
    assert isinstance(_flat(sharded)["params.embed"], ShardedTensor)

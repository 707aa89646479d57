"""The port's expert parallelism (``LlamaConfig.ep_axis``, the ep layout of
``param_specs`` / ``shard_params`` / ``pp_param_specs``, the sharded MoE
step, pp x ep in ``make_pp_train_step``, and
``paddle_tpu_torch.distributed.moe_utils``) against the JAX package's and
against the port's own serial step, on the same weights.

The config is ``TestLlamaMoE``'s tiny one (``tests/test_llama.py:277``:
vocab 128, hidden 64, 2 layers, 4 heads, 4 experts, top-2) at fp32,
weights from the JAX ``init_params`` through ``params_from_jax``, ids from
numpy with a seed. JAX's meshes are built over the 8-device CPU mesh of
``tests/conftest.py``, the port's over ``["cpu"] * n`` (one controller
over a placement).

Tolerances: the sharded loss within 1e-5 of JAX's sharded step and of the
port's serial loss, every gradient leaf within 1e-5 x max|g| of the
serial gradient, the parameters after one AdamW step (lr 1e-3) within
1e-3 of JAX's and of the serial step's (the reference's
``TestShardedTraining`` rule: Adam's first step turns fp32
reduction-order noise in near-zero gradients into visible steps); the
pipelined loss within 2e-5 of JAX's pp step and of the serial
micro-batched oracle (``tests/test_llama.py:366-417``), its parameters
within 1e-3. The router runs over the global batch, so its kept counts
equal the serial step's; at capacity factor 1.0 tokens drop, and routing
each dp piece alone would keep a different number (the trap test).
``moe_utils`` equals JAX's exactly on ``tests/test_legacy_ops.py:464``'s
inputs, and ``global_scatter`` / ``global_gather`` equal JAX's under dp 8.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding

import paddle_tpu.distributed as jdist
from paddle_tpu.distributed import fleet as jfleet
from paddle_tpu.distributed.topology import build_mesh as jbuild_mesh
from paddle_tpu.models import llama as JL
import paddle_tpu_torch.distributed as tdist
from paddle_tpu_torch.distributed import fleet as tfleet
from paddle_tpu_torch.distributed import moe_utils as TM
from paddle_tpu_torch.distributed.sharding import assemble, shard_tree
from paddle_tpu_torch.distributed.topology import build_mesh
from paddle_tpu_torch.models import llama as TL
from paddle_tpu_torch.models.convert import (config_from_jax,
                                             params_from_jax,
                                             specs_from_jax, to_numpy)

torch.set_num_threads(2)

CPU8 = ["cpu"] * 8
EXPERT = ("w_gate", "w_up", "w_down")


def moe_cfg(**kw):
    base = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
                num_hidden_layers=2, num_attention_heads=4,
                num_key_value_heads=4, max_position_embeddings=64,
                use_kernels=False, moe_num_experts=4, moe_top_k=2,
                ep_axis="ep")
    base.update(kw)
    return JL.LlamaConfig(**base)


def _port(jp):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def _ids(B, S, seed):
    return np.random.default_rng(seed).integers(0, 128, (B, S)).astype(
        np.int32)


def _whole(tree, grads):
    """``{name: whole gradient}`` from the sharded step's slice gradients."""
    out = {}
    for n, st in TL._named(tree):
        full = torch.empty(st.shape, dtype=st.dtype)
        for idx, c in st.unique():
            full[tuple(slice(a, b) for a, b, _ in idx)] = grads[n][c]
        out[n] = full
    return out


def _serial_grads(tp, ids, cfg):
    leaves = TL._leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    loss = TL.loss_fn(tp, ids, ids, cfg)
    gs = torch.autograd.grad(loss, leaves)
    for p in leaves:
        p.requires_grad_(False)
    return float(loss), dict(zip([n for n, _ in TL._named(tp)], gs))


def _replicas_equal(tree):
    for name, st in _flat(tree).items():
        for idx, c in st.unique():
            for c2 in st.mesh.coords():
                if st.index(c2) == idx:
                    assert torch.equal(st.local(c2), st.local(c)), (name, c2)


# ---------------------------------------------------------------------------
# the config and the layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mp", [None, "mp"])
@pytest.mark.parametrize("fs", [None, "sharding"])
def test_ep_specs_match_jax(mp, fs):
    """``config_from_jax`` carries ``ep_axis``; ``param_specs`` names it on
    the expert dim as JAX does, and ``pp_param_specs`` too."""
    jcfg = moe_cfg()
    tcfg = config_from_jax(jcfg)
    assert tcfg.ep_axis == "ep"
    assert TL.param_specs(tcfg, mp, fs) == \
        specs_from_jax(JL.param_specs(jcfg, mp, fs))
    assert TL.param_specs(tcfg, mp, fs)["layers"]["w_gate"] == \
        (None, "ep", fs, mp)
    want = jax.tree_util.tree_map(tuple, JL.pp_param_specs(jcfg, "pp", "ep"),
                                  is_leaf=lambda x: not isinstance(x, dict))
    assert TL.pp_param_specs(tcfg, "pp", "ep") == want


def test_expert_leaves_a_quarter_per_entry():
    """dp 2 x ep 4: every coordinate holds the data JAX's array holds on
    the device there, each expert leaf 1/4 of its bytes (E/ep = 1 of 4
    experts), the rest whole."""
    jcfg = moe_cfg()
    jp = JL.init_params(jcfg, jax.random.PRNGKey(2))
    jmesh = jbuild_mesh({"dp": 2, "ep": 4}, jax.devices()[:8])
    tmesh = build_mesh({"dp": 2, "ep": 4}, CPU8)
    jps = JL.shard_params(jp, jmesh, jcfg, mp_axis=None)
    tp = _port(jp)
    tps = TL.shard_params(tp, tmesh, config_from_jax(jcfg), mp_axis=None)
    c0 = (0,) * 6
    for k in EXPERT:
        st = tps["layers"][k]
        assert st.nbytes_at(c0) * 4 == tp["layers"][k].numel() * 4, k
    assert tps["layers"]["wq"].nbytes_at(c0) == tp["layers"]["wq"].numel() * 4
    for name, ja in _flat(jps).items():
        st = _flat(tps)[name]
        for sh in ja.addressable_shards:
            c = tuple(int(i) for i in np.argwhere(jmesh.devices
                                                  == sh.device)[0])
            np.testing.assert_array_equal(st.local(c).numpy(),
                                          np.asarray(sh.data), err_msg=name)


def test_experts_must_split_over_ep():
    jcfg = moe_cfg(moe_num_experts=6)
    tp = _port(JL.init_params(jcfg, jax.random.PRNGKey(0)))
    with pytest.raises(ValueError, match="do not split over mesh axis 'ep'"):
        TL.shard_params(tp, build_mesh({"dp": 2, "ep": 4}, CPU8),
                        config_from_jax(jcfg), mp_axis=None)
    with pytest.raises(ValueError, match="not an axis"):
        TL.shard_params(tp, build_mesh({"dp": 8}, CPU8),
                        config_from_jax(moe_cfg(ep_axis="xp")), mp_axis=None)


# ---------------------------------------------------------------------------
# the dp x ep sharded step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cf", [1.0, 100.0])
def test_sharded_step_matches_jax_and_serial(cf):
    """``TestLlamaMoE.test_ep_sharded_train_step``'s layout (dp 2 x ep 4,
    B 8 x S 16 over dp): the loss equals JAX's sharded step and the
    port's serial loss, every gradient the serial one, one AdamW step
    JAX's and the serial step's parameters; the kept counts equal the
    serial router's (at cf 1.0 some tokens drop, at 100 none); dp
    replicas stay bit-equal and the expert leaves stay a quarter an
    entry."""
    jcfg = moe_cfg(moe_capacity_factor=cf)
    tcfg = config_from_jax(jcfg)
    jp = JL.init_params(jcfg, jax.random.PRNGKey(2))
    ids = _ids(8, 16, 2)
    jmesh = jbuild_mesh({"dp": 2, "ep": 4}, jax.devices()[:8])
    jps = jax.tree_util.tree_map(
        lambda p, s: jax.device_put(p, NamedSharding(jmesh, s)), jp,
        JL.param_specs(jcfg, mp_axis=None))
    init_j, step_j = JL.make_train_step(jcfg, lr=1e-3)
    jids = jax.device_put(ids, NamedSharding(jmesh, JL.batch_spec(("dp",))))
    jnew, _, jl = jax.jit(step_j)(jps, jax.device_put(init_j(jps)), jids,
                                  jids)

    tids = torch.from_numpy(ids)
    tp = _port(jp)
    sl, sg = _serial_grads(tp, tids, tcfg)
    tmesh = build_mesh({"dp": 2, "ep": 4}, CPU8)
    tps = TL.shard_params(_port(jp), tmesh, tcfg, mp_axis=None)
    kept = TL.moe_kept(tps, tids, tcfg)
    want_kept = TL.moe_kept(tp, tids, tcfg)
    assert kept == want_kept
    full = 8 * 16 * 2
    if cf == 1.0:
        assert all(k < full for k in kept), kept       # tokens dropped
    else:
        assert kept == [full] * 2
    loss, grads = TL._sharded_grads(tps, tids, tids, tcfg)
    assert abs(float(loss) - sl) < 1e-5
    assert abs(float(loss) - float(jl)) < 1e-5
    for n, g in _whole(tps, grads).items():
        np.testing.assert_allclose(g.numpy(), sg[n].numpy(), rtol=0,
                                   atol=1e-5 * float(sg[n].abs().max()),
                                   err_msg=n)

    init_t, step_t = TL.make_train_step(tcfg, lr=1e-3)
    tps, _, tl = step_t(tps, init_t(tps), tids, tids)
    init_s, step_s = TL.make_train_step(tcfg, lr=1e-3)
    ps, _, _ = step_s(tp, init_s(tp), tids, tids)
    got = {n: assemble(st) for n, st in TL._named(tps)}
    jflat = {n: np.asarray(a) for n, a in TL._named(jnew)}
    for n, a in TL._named(ps):
        np.testing.assert_allclose(got[n].numpy(), a.detach().numpy(),
                                   atol=1e-3, rtol=0, err_msg=n)
        np.testing.assert_allclose(got[n].numpy(), jflat[n], atol=1e-3,
                                   rtol=0, err_msg=n)
    _replicas_equal(tps)
    c0 = (0,) * 6
    for k in EXPERT:
        assert tps["layers"][k].nbytes_at(c0) * 4 == \
            tp["layers"][k].numel() * 4


def test_routing_each_piece_alone_keeps_another_count():
    """The trap: a dp piece that routed its own tokens alone would have
    the capacity of B/dp rows, and at capacity factor 1.0 it keeps another
    number of (token, choice) pairs than the global router, which the
    sharded step matches."""
    jcfg = moe_cfg(moe_capacity_factor=1.0)
    tcfg = config_from_jax(jcfg)
    tp = _port(JL.init_params(jcfg, jax.random.PRNGKey(2)))
    tids = torch.from_numpy(_ids(8, 16, 2))
    whole = TL.moe_kept(tp, tids, tcfg)
    alone = [a + b for a, b in zip(TL.moe_kept(tp, tids[:4], tcfg),
                                   TL.moe_kept(tp, tids[4:], tcfg))]
    assert alone != whole, (alone, whole)
    tps = TL.shard_params(tp, build_mesh({"dp": 2, "ep": 4}, CPU8), tcfg,
                          mp_axis=None)
    assert TL.moe_kept(tps, tids, tcfg) == whole


def test_sharded_moe_with_mp_and_fsdp_matches_serial():
    """dp 2 x ep 2 x mp 2 (experts' intermediate dim over mp), the same
    with the batch over dp and ep (two pieces on each expert entry), and
    sharding 2 x ep 2 x mp 2 with the batch over the sharding axis (the
    experts' hidden dim gathered over it): loss, gradients and kept counts
    equal the serial step's, at capacity factor 1.0."""
    jcfg = moe_cfg(moe_capacity_factor=1.0)
    tcfg = config_from_jax(jcfg)
    jp = JL.init_params(jcfg, jax.random.PRNGKey(4))
    tp = _port(jp)
    tids = torch.from_numpy(_ids(4, 16, 4))
    sl, sg = _serial_grads(tp, tids, tcfg)
    for deg, fs, dp_axes in (({"dp": 2, "ep": 2, "mp": 2}, None, ("dp",)),
                             ({"sharding": 2, "ep": 2, "mp": 2}, "sharding",
                              ("sharding",)),
                             ({"dp": 2, "ep": 2, "mp": 2}, None,
                              ("dp", "ep"))):
        tmesh = build_mesh(deg, CPU8)
        tps = TL.shard_params(_port(jp), tmesh, tcfg, mp_axis="mp",
                              fsdp_axis=fs)
        ids_s = tdist.shard_to_mesh(tids, tmesh, TL.batch_spec(dp_axes))
        assert TL.moe_kept(tps, ids_s, tcfg) == TL.moe_kept(tp, tids, tcfg)
        loss, grads = TL._sharded_grads(tps, ids_s, ids_s, tcfg)
        assert abs(float(loss) - sl) < 1e-5, deg
        for n, g in _whole(tps, grads).items():
            np.testing.assert_allclose(g.numpy(), sg[n].numpy(), rtol=0,
                                       atol=1e-5 * float(sg[n].abs().max()),
                                       err_msg=f"{deg} {n}")


def test_fewer_slots_than_pieces_matches_serial():
    """Capacity 1 at dp 4 x ep 2 (B 4 x S 2, capacity factor 0.1): three
    pieces run no slot; loss and gradients still equal the serial
    step's."""
    jcfg = moe_cfg(moe_capacity_factor=0.1)
    tcfg = config_from_jax(jcfg)
    jp = JL.init_params(jcfg, jax.random.PRNGKey(6))
    tp = _port(jp)
    tids = torch.from_numpy(_ids(4, 2, 6))
    assert TL._capacity(8, tcfg) == 1
    sl, sg = _serial_grads(tp, tids, tcfg)
    tps = TL.shard_params(_port(jp), build_mesh({"dp": 4, "ep": 2}, CPU8),
                          tcfg, mp_axis=None)
    loss, grads = TL._sharded_grads(tps, tids, tids, tcfg)
    assert abs(float(loss) - sl) < 1e-5
    for n, g in _whole(tps, grads).items():
        np.testing.assert_allclose(g.numpy(), sg[n].numpy(), rtol=0,
                                   atol=1e-5 * float(sg[n].abs().max()),
                                   err_msg=n)


# ---------------------------------------------------------------------------
# pp x ep
# ---------------------------------------------------------------------------

def _serial_mb_loss(jp, ids, jcfg, MB):
    """``tests/test_llama.py:393``'s serial micro-batched oracle."""
    B = ids.shape[0]

    def loss(params):
        tot_l, tot_c, auxes = 0.0, 0, []
        for m in range(MB):
            i_m = ids[m * (B // MB):(m + 1) * (B // MB)]
            logits, aux = JL.forward(params, i_m, jcfg, return_aux=True)
            logits = logits.astype(jnp.float32)
            lse = jax.nn.logsumexp(logits, -1)
            tgt = jnp.take_along_axis(logits, i_m[..., None], -1)[..., 0]
            tot_l = tot_l + (lse - tgt).sum()
            tot_c = tot_c + i_m.size
            auxes.append(aux)
        return tot_l / tot_c + jcfg.moe_aux_weight * jnp.mean(
            jnp.asarray(auxes))
    return float(loss(jp))


@pytest.mark.parametrize("layout", ["pp2_ep2", "dp2_pp2_ep2_v2"])
def test_pp_by_ep_matches_jax(layout):
    """pp x ep (it was refused): ``test_pp_moe_parity_vs_serial``'s pp 2 x
    ep 2 (M 2, no dp) and ``test_pp_moe_hybrid_dp_pp_ep_trains``'s dp 2 x
    pp 2 x ep 2 at V 2 (M 4): the loss equals JAX's pipelined step and
    (pp 2 x ep 2) the serial micro-batched oracle; one AdamW step's
    parameters equal JAX's; the expert leaves hold half the experts an
    entry; dp replicas stay bit-equal."""
    jcfg = moe_cfg(num_hidden_layers=4)
    tcfg = config_from_jax(jcfg)
    jp = JL.init_params(jcfg, jax.random.PRNGKey(0))
    if layout == "pp2_ep2":
        deg, V, MB, dp, ids = {"pp": 2, "ep": 2}, 1, 2, None, _ids(4, 16, 0)
        jmesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("pp", "ep"))
    else:
        deg, V, MB, dp, ids = ({"dp": 2, "pp": 2, "ep": 2}, 2, 4, "dp",
                               _ids(8, 16, 1))
        jmesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 2, 2),
                     ("dp", "pp", "ep"))
    n = int(np.prod(list(deg.values())))
    jpp = jax.tree_util.tree_map(
        lambda p, s: jax.device_put(p, NamedSharding(jmesh, s)),
        JL.to_pp_layout(jp, 2, circular_repeats=V),
        JL.pp_param_specs(jcfg, "pp", "ep"))
    init_j, step_j = JL.make_pp_train_step(
        jcfg, jmesh, micro_batches=MB, dp_axis=dp, circular_repeats=V,
        lr=1e-2)
    jnew, _, jl = jax.jit(step_j)(jpp, init_j(jpp), jnp.asarray(ids),
                                  jnp.asarray(ids))

    tmesh = build_mesh(deg, ["cpu"] * n)
    tpp = shard_tree(TL.to_pp_layout(_port(jp), 2, circular_repeats=V),
                     tmesh, TL.pp_param_specs(tcfg, "pp", "ep"))
    c0 = (0,) * 6
    for k in EXPERT:     # 1 of 2 stages x 1 of 2 expert halves
        full = int(np.prod(tpp["layers"][k].shape)) * 4
        assert tpp["layers"][k].nbytes_at(c0) * 4 == full, k
    init_t, step_t = TL.make_pp_train_step(
        tcfg, tmesh, micro_batches=MB, dp_axis=dp, circular_repeats=V,
        lr=1e-2)
    tids = torch.from_numpy(ids)
    tpp, _, tl = step_t(tpp, init_t(tpp), tids, tids)
    assert abs(float(tl) - float(jl)) < 2e-5, (float(tl), float(jl))
    if dp is None:
        assert abs(float(tl) - _serial_mb_loss(jp, jnp.asarray(ids), jcfg,
                                               MB)) < 2e-5
    jback = _flat(jax.tree_util.tree_map(np.asarray,
                                         JL.from_pp_layout(
                                             jax.device_get(jnew))))
    for k, a in _flat(to_numpy(TL.from_pp_layout(tpp))).items():
        np.testing.assert_allclose(a, jback[k], atol=1e-3, rtol=0,
                                   err_msg=k)
    _replicas_equal(tpp)


# ---------------------------------------------------------------------------
# moe_utils
# ---------------------------------------------------------------------------

def _np(x):
    return np.asarray(x.numpy() if hasattr(x, "numpy") else x)


MOE_UTILS = {
    "number_count": lambda m: m.number_count(np.array([0, 1, 1, 3]), 4),
    "expert_count": lambda m: m.expert_count(np.array([0, 1, -1, 1]), 2),
    "assign_pos": lambda m: m.assign_pos(np.array([1, 0, 1, 0]),
                                         np.array([2, 4])),
    "limit_by_capacity": lambda m: m.limit_by_capacity(np.array([5, 1]),
                                                       np.array([2, 2])),
    "prune_gate_by_capacity": lambda m: m.prune_gate_by_capacity(
        np.array([0, 0, 0, 1]), np.array([2, 2]), 2),
    "random_routing": lambda m: m.random_routing(
        np.array([[0, 1], [2, 3]]),
        np.array([[0.6, 0.4], [0.9, 0.05]], np.float32),
        np.array([0.5, 0.5], np.float32)),
}


@pytest.mark.parametrize("name", sorted(MOE_UTILS))
def test_moe_utils_match_jax(name):
    """``TestMoEInfraOps``'s inputs through both packages: equal values."""
    got = _np(MOE_UTILS[name](tdist))
    want = _np(MOE_UTILS[name](jdist))
    np.testing.assert_array_equal(got, want)
    assert got.tolist() == _np(MOE_UTILS[name](TM)).tolist()


def test_global_scatter_gather_match_jax():
    """Under dp 8 (JAX: ``fleet.init``; the port: ``["cpu"] * 8``) the
    grouped all-to-all equals JAX's and ``global_gather`` inverts it; the
    per-rank list form runs ``alltoall_ranks``; a group of one rank is the
    identity."""
    x = np.arange(64 * 3, dtype=np.float32).reshape(64, 3)
    assert TM.global_scatter(torch.from_numpy(x), None, None).numpy() \
        .tolist() == x.tolist()                     # the default: 1 rank
    jfleet.init(is_collective=True)
    tfleet.init(is_collective=True, devices=CPU8)
    try:
        want = _np(jdist.global_scatter(x, None, None)).reshape(64, 3)
        got = TM.global_scatter(torch.from_numpy(x), None, None)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(
            TM.global_gather(got, None, None).numpy(), x)
        xs = list(torch.from_numpy(x).chunk(8))
        lst = TM.global_scatter(xs, None, None)
        np.testing.assert_array_equal(torch.cat(lst).numpy(), want)
    finally:
        jdist.set_hybrid_communicate_group(None)
        tdist.set_hybrid_communicate_group(None)

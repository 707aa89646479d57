"""The port's context parallelism (``paddle_tpu_torch.distributed.
context_parallel`` and the ``sep_axis`` route of ``models.llama``) against
the JAX package's, on the same numpy inputs and weights.

The meshes are ``tests/test_context_parallel.py``'s: dp 2 x sep 4, JAX's
over the 8-device CPU mesh of ``tests/conftest.py`` and the port's over
``["cpu"] * 8`` (one controller over a placement), both built by their
``fleet.init``. Tolerances are the reference tests': attention outputs
within 2e-5 (3e-5 at S 128), model logits within 3e-5; gradients within
1e-5 x max|g| of the serial ``_sdpa`` gradient (the same fp32 arithmetic
merged block by block); losses within 1e-5 and three-step loss
trajectories within 1e-4 relative (Adam's ``m / sqrt(v)`` magnifies fp32
noise on near-zero gradients); the sharded sep step's parameters within
1e-3 after one AdamW step (``TestShardedTraining``'s rule). The
``use_kernels`` cases run the port's flash Function (its plain CPU path,
the backward taking the lse's cotangent) and JAX's Pallas kernels in
interpret mode. The model cases use S 32 over sep 4, long enough that a
sequence part's RoPE rows taken from the wrong offset move the logits
past the tolerance.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import paddle_tpu as paddle
from paddle_tpu.core.jax_compat import shard_map
from paddle_tpu.distributed import fleet as jfleet
from paddle_tpu.distributed.context_parallel import _sdpa as jax_sdpa
from paddle_tpu.distributed.context_parallel import (
    ring_flash_attention as jax_ring,
    sep_parallel_attention as jax_sep_attention)
from paddle_tpu.distributed.topology import \
    set_hybrid_communicate_group as jax_set_group
from paddle_tpu.models import llama as JL
from paddle_tpu_torch.distributed import fleet as tfleet
from paddle_tpu_torch.distributed.context_parallel import (
    ring_flash_attention, sep_parallel_attention, ulysses_attention)
from paddle_tpu_torch.distributed.sharding import shard_to_mesh
from paddle_tpu_torch.distributed.topology import (
    build_mesh, set_hybrid_communicate_group)
from paddle_tpu_torch.models import llama as TL
from paddle_tpu_torch.models.convert import (config_from_jax,
                                             params_from_jax, to_numpy)

torch.set_num_threads(2)

CPU8 = ["cpu"] * 8


def _init(deg):
    jst, tst = jfleet.DistributedStrategy(), tfleet.DistributedStrategy()
    jst.hybrid_configs = tst.hybrid_configs = dict(deg)
    jfleet.init(is_collective=True, strategy=jst)
    tfleet.init(is_collective=True, strategy=tst, devices=CPU8)
    return (jfleet.get_hybrid_communicate_group(),
            tfleet.get_hybrid_communicate_group())


@pytest.fixture
def sep_mesh():
    yield _init({"dp_degree": 2, "sep_degree": 4, "mp_degree": 1})
    jax_set_group(None)
    set_hybrid_communicate_group(None)


def _qkv(B=2, S=32, H=4, D=8, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((B, S, H, D)).astype("float32")
                 for _ in range(3))


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


def _jax_serial_grads(q, k, v, causal):
    def loss(a, b, c):
        return (jax_sdpa(a, b, c, causal)[0].astype(jnp.float32) ** 2).sum()
    return [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))]


def _port_grads(q, k, v, causal, impl, use_kernels, mesh):
    ts = [_t(a, True) for a in (q, k, v)]
    out = sep_parallel_attention(*ts, causal=causal, impl=impl, mesh=mesh,
                                 use_kernels=use_kernels)
    return torch.autograd.grad((out.float() ** 2).sum(), ts)


# ---------------------------------------------------------------------------
# the attention functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_parity_vs_serial_and_jax(sep_mesh, impl, causal, use_kernels):
    """``TestRingAttention`` / ``TestUlysses.test_parity_vs_serial`` and
    ``test_parity_with_flash_kernel``: the port's output against JAX's
    serial ``_sdpa`` and JAX's own sep attention (its kernel path in
    interpret mode at the reference's B 1 x H 2 shape)."""
    jh, th = sep_mesh
    shape = dict(B=1, S=32, H=4 if impl == "ulysses" else 2, D=8) \
        if use_kernels else {}
    q, k, v = _qkv(**shape)
    ref, _ = jax_sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal)
    jout = jax_sep_attention(paddle.to_tensor(q), paddle.to_tensor(k),
                             paddle.to_tensor(v), causal=causal, impl=impl,
                             use_kernels=use_kernels).numpy()
    out = sep_parallel_attention(_t(q), _t(k), _t(v), causal=causal,
                                 impl=impl, use_kernels=use_kernels)
    tol = 2e-4 if use_kernels else 2e-5      # the reference's kernel rule
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5,
                               rtol=2e-5)
    np.testing.assert_allclose(out.numpy(), jout, atol=tol, rtol=tol)


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_grads_match_serial(sep_mesh, impl, causal, use_kernels):
    """``test_grads_match_serial``: dq, dk, dv of ``sum(out**2)`` through
    the port's ring or Ulysses against JAX's serial ``_sdpa`` gradient,
    within 1e-5 x max|g| (the kernel path through the flash Function,
    whose backward takes the lse's cotangent)."""
    _, th = sep_mesh
    q, k, v = _qkv(S=16)
    want = _jax_serial_grads(q, k, v, causal)
    got = _port_grads(q, k, v, causal, impl, use_kernels, th.mesh)
    for name, a, b in zip("qkv", got, want):
        err = np.abs(a.numpy() - b).max() / np.abs(b).max()
        assert err <= 1e-5, (name, err)


def test_ring_kernel_grads_take_the_lse_cotangent(sep_mesh):
    """The lse-gradient repair, at the case that shows the fault: causal,
    B 1 x S 32 x H 2 x D 8 at dp 2 x sep 4, loss ``sum(out**2)``. The
    port's ring through ``flash_attention_with_lse`` gives dq, dk and dv
    within 1e-5 x max|g| of the serial gradient; the ring's merge weights
    depend on every block's lse, so a backward that drops ``dlse`` is off
    by tenths of max|dq| here (next test)."""
    _, th = sep_mesh
    q, k, v = _qkv(B=1, S=32, H=2, D=8)
    want = _jax_serial_grads(q, k, v, True)
    got = _port_grads(q, k, v, True, "ring", True, th.mesh)
    for name, a, b in zip("qkv", got, want):
        err = np.abs(a.numpy() - b).max() / np.abs(b).max()
        assert err <= 1e-5, (name, err)


def test_reference_kernel_ring_drops_the_lse_cotangent(sep_mesh):
    """The fault as it stands in the JAX package (ROADMAP.md section C):
    its flash kernel's VJP does ``do, _ = g``, so its kernel ring's dq is
    off by more than 0.1 x max|dq| at the same case (measured: 0.474 x
    max|dq|, dk 0.374 x max|dk|; dv, which does not depend on ``delta``,
    agrees). The JAX package is not edited."""
    jh, _ = sep_mesh
    q, k, v = _qkv(B=1, S=32, H=2, D=8)
    spec = P(None, "sep")

    def ring_loss(a, b, c):
        f = shard_map(lambda x, y, z: jax_ring(x, y, z, "sep", True, True),
                      mesh=jh.mesh, in_specs=(spec, spec, spec),
                      out_specs=spec, check_vma=False)
        return (f(a, b, c).astype(jnp.float32) ** 2).sum()

    got = jax.grad(ring_loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = _jax_serial_grads(q, k, v, True)
    rel = [float(np.abs(np.asarray(a) - b).max() / np.abs(b).max())
           for a, b in zip(got, want)]
    assert rel[0] > 0.1 and rel[1] > 0.1, rel
    assert rel[2] <= 1e-5, rel


def test_ulysses_head_divisibility(sep_mesh):
    """2 heads over sep 4: the JAX message."""
    jh, th = sep_mesh
    q, k, v = _qkv(H=2)
    spec = P(None, "sep")
    from paddle_tpu.distributed.context_parallel import \
        ulysses_attention as jax_ulysses
    sm = shard_map(lambda a, b, c: jax_ulysses(a, b, c, "sep", False, False),
                   mesh=jh.mesh, in_specs=(spec, spec, spec),
                   out_specs=spec, check_vma=False)
    with pytest.raises(ValueError, match="divisible") as want:
        sm(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    shards = [list(_t(a).chunk(4, 1)) for a in (q, k, v)]
    with pytest.raises(ValueError, match="divisible") as got:
        ulysses_attention(*shards, causal=False, use_kernels=False)
    assert str(got.value) == str(want.value)


def test_impl_must_be_named(sep_mesh):
    q, k, v = (_t(a) for a in _qkv())
    with pytest.raises(ValueError, match="'ring' or 'ulysses'"):
        sep_parallel_attention(q, k, v, impl="tree")


def test_backward_through_tensor_wrapper(sep_mesh):
    """``test_backward_through_tensor_wrapper``: Ulysses, causal, on full
    tensors; every gradient finite and within 1e-5 x max|g| of serial."""
    q, k, v = _qkv()
    got = _port_grads(q, k, v, True, "ulysses", False, None)
    for a, b in zip(got, _jax_serial_grads(q, k, v, True)):
        assert torch.isfinite(a).all()
        assert np.abs(a.numpy() - b).max() <= 1e-5 * np.abs(b).max()


def test_ring_long_sequence_smoke(sep_mesh):
    """S 128 over 4 ranks: each rank sees S/4 of K/V at a time."""
    q, k, v = _qkv(B=1, S=128, H=4, D=8)
    out = sep_parallel_attention(_t(q), _t(k), _t(v), causal=True,
                                 impl="ring", use_kernels=False)
    ref, _ = jax_sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=3e-5,
                               rtol=3e-5)


def test_ring_causal_launch_count(sep_mesh):
    """Under ``causal`` rank i runs i + 1 attention calls (the later blocks
    are skipped, not weighted 0): n (n + 1) / 2 = 10 at sep 4."""
    calls = []
    import paddle_tpu_torch.distributed.context_parallel as CP
    real = CP._attn_with_lse

    def counted(*a):
        calls.append(a[3])
        return real(*a)
    q, k, v = (list(_t(a).chunk(4, 1)) for a in _qkv())
    CP._attn_with_lse = counted
    try:
        ring_flash_attention(q, k, v, causal=True, use_kernels=False)
        assert calls == [True, True, False, True, False, False, True,
                         False, False, False]
        calls.clear()
        ring_flash_attention(q, k, v, causal=False, use_kernels=False)
        assert len(calls) == 16
    finally:
        CP._attn_with_lse = real


# ---------------------------------------------------------------------------
# the model: the sep route of _attention on unsharded params
# ---------------------------------------------------------------------------

def _model(seed, **kw):
    base = dict(vocab_size=96, hidden_size=32, intermediate_size=64,
                num_hidden_layers=2, num_attention_heads=4,
                num_key_value_heads=4, use_kernels=False)
    base.update(kw)
    jcfg = JL.LlamaConfig(**base)
    jp = JL.init_params(jcfg, jax.random.PRNGKey(seed))
    return jcfg, jp, params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                     device="cpu")


@pytest.mark.parametrize("impl,kv,seed,B", [("ring", 4, 0, 2),
                                            ("ulysses", 2, 1, 1)])
def test_llama_cp_matches_serial(sep_mesh, impl, kv, seed, B):
    """``test_llama_ring_cp_matches_serial`` / ``..._ulysses_...``: the
    forward with ``sep_axis`` equals JAX's sep forward and the serial one
    (GQA expanded inside for Ulysses)."""
    jcfg, jp, tp = _model(seed, num_key_value_heads=kv)
    ids = np.arange(B * 32).reshape(B, 32) % jcfg.vocab_size
    ref = np.asarray(JL.forward(jp, jnp.asarray(ids), jcfg))
    jcp = dataclasses.replace(jcfg, sep_axis="sep", cp_impl=impl)
    jgot = np.asarray(JL.forward(jp, jnp.asarray(ids), jcp))
    tcfg = config_from_jax(jcp)
    assert (tcfg.sep_axis, tcfg.cp_impl) == ("sep", impl)
    got = TL.forward(tp, torch.from_numpy(ids), tcfg).detach().numpy()
    np.testing.assert_allclose(got, ref, atol=3e-5, rtol=3e-5)
    np.testing.assert_allclose(got, jgot, atol=3e-5, rtol=3e-5)


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_llama_cp_train_step(sep_mesh, impl):
    """``test_llama_ring_cp_train_step``: unsharded params, the batch laid
    out over ``batch_spec(("dp",), "sep")``; three steps give finite,
    falling losses equal to JAX's within 1e-4 relative."""
    jh, th = sep_mesh
    jcfg, jp, tp = _model(2)
    jcfg = dataclasses.replace(jcfg, sep_axis="sep", cp_impl=impl)
    tcfg = config_from_jax(jcfg)
    ids = np.random.default_rng(0).integers(0, 96, (2, 32)).astype(np.int32)
    init_j, step_j = JL.make_train_step(jcfg, lr=1e-2)
    jids = jax.device_put(jnp.asarray(ids), NamedSharding(
        jh.mesh, JL.batch_spec(("dp",), "sep")))
    opt_j, jstep = init_j(jp), jax.jit(step_j)
    init_t, step_t = TL.make_train_step(tcfg, lr=1e-2)
    tids = shard_to_mesh(torch.from_numpy(ids), th.mesh,
                         TL.batch_spec(("dp",), "sep"))
    opt_t = init_t(tp)
    want, got = [], []
    for _ in range(3):
        jp, opt_j, lj = jstep(jp, opt_j, jids, jids)
        tp, opt_t, lt = step_t(tp, opt_t, tids, tids)
        want.append(float(lj))
        got.append(float(lt))
    assert all(np.isfinite(got)) and got[-1] < got[0]
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_sep_refuses_packed_batches(sep_mesh):
    """``tests/test_llama.py:265``: segment_ids under sep raise the JAX
    ``NotImplementedError`` ("packed")."""
    jcfg, jp, tp = _model(3)
    jcp = dataclasses.replace(jcfg, sep_axis="sep")
    seg = np.zeros((1, 16), np.int32)
    with pytest.raises(NotImplementedError, match="packed") as want:
        JL.forward(jp, jnp.zeros((1, 16), jnp.int32), jcp,
                   segment_ids=jnp.asarray(seg))
    with pytest.raises(NotImplementedError, match="packed") as got:
        TL.forward(tp, torch.zeros((1, 16), dtype=torch.int32),
                   config_from_jax(jcp), segment_ids=torch.from_numpy(seg))
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# sep in the sharded path
# ---------------------------------------------------------------------------

SHARDED = [
    ({"dp": 2, "sep": 4}, None, None, ("dp",), "ring"),
    ({"dp": 2, "sep": 4}, None, None, ("dp",), "ulysses"),
    ({"sharding": 2, "sep": 4}, None, "sharding", ("sharding",), "ring"),
    ({"sharding": 2, "sep": 4}, None, "sharding", ("sharding",), "ulysses"),
    ({"mp": 2, "sep": 4}, "mp", None, (), "ring"),
]


@pytest.mark.parametrize("deg,mp,fs,dp_axes,impl", SHARDED)
def test_sharded_sep_step_matches_jax(deg, mp, fs, dp_axes, impl):
    """``shard_params`` at dp 2 x sep 4, sharding 2 x sep 4 and mp 2 x sep 4
    with the batch over ``batch_spec(dp_axes, "sep")``: the loss within
    1e-5 of JAX's sharded step and of the port's serial one, every
    parameter within 1e-3 of JAX's after one AdamW step at lr 1e-2, and
    the replicas along dp, sharding and sep bit-equal."""
    jcfg, jp, tp = _model(5, num_key_value_heads=2)
    jcfg = dataclasses.replace(jcfg, sep_axis="sep", cp_impl=impl)
    tcfg = config_from_jax(jcfg)
    ids = np.random.default_rng(1).integers(0, 96, (2, 32)).astype(np.int32)
    # JAX's sep route takes its mesh from the hybrid group
    try:
        jh, _ = _init({f"{a}_degree": n for a, n in deg.items()})
        jmesh, tmesh = jh.mesh, build_mesh(deg, CPU8)
        assert dict(jmesh.shape) == tmesh.shape
        _sharded_steps(jcfg, tcfg, jp, tp, ids, jmesh, tmesh, mp, fs,
                       dp_axes)
    finally:
        jax_set_group(None)
        set_hybrid_communicate_group(None)


def _sharded_steps(jcfg, tcfg, jp, tp, ids, jmesh, tmesh, mp, fs, dp_axes):
    init_j, step_j = JL.make_train_step(jcfg, lr=1e-2)
    jps = JL.shard_params(jp, jmesh, jcfg, mp_axis=mp, fsdp_axis=fs)
    jids = jax.device_put(jnp.asarray(ids), NamedSharding(
        jmesh, JL.batch_spec(dp_axes, "sep")))
    jnew, _, jl = jax.jit(step_j)(jps, jax.device_put(init_j(jps)), jids,
                                  jids)
    serial = float(TL.loss_fn(tp, torch.from_numpy(ids),
                              torch.from_numpy(ids),
                              dataclasses.replace(tcfg, sep_axis=None)))
    init_t, step_t = TL.make_train_step(tcfg, lr=1e-2)
    tps = TL.shard_params(tp, tmesh, tcfg, mp_axis=mp, fsdp_axis=fs)
    tids = shard_to_mesh(torch.from_numpy(ids), tmesh,
                         TL.batch_spec(dp_axes, "sep"))
    tps, _, tl = step_t(tps, init_t(tps), tids, tids)
    assert abs(float(tl) - float(jl)) <= 1e-5
    assert abs(float(tl) - serial) <= 1e-5
    want = jax.tree_util.tree_map(np.asarray, jnew)
    got = to_numpy(tps)
    for name in got:
        if name == "layers":
            for k in got[name]:
                np.testing.assert_allclose(got[name][k], want[name][k],
                                           atol=1e-3, rtol=0, err_msg=k)
        else:
            np.testing.assert_allclose(got[name], want[name], atol=1e-3,
                                       rtol=0, err_msg=name)
    for st in TL._leaves(tps):
        for idx, c in st.unique():
            for c2 in tmesh.coords():
                if st.index(c2) == idx:
                    assert torch.equal(st.local(c2), st.local(c))


def test_sharded_ulysses_under_mp_is_refused():
    """mp 2 x sep 4 under Ulysses: 2 local heads a model-parallel shard do
    not split over sep 4 (JAX gathers the heads over mp inside its
    region); the port raises naming item 5a's rest."""
    jcfg, jp, tp = _model(5)
    tcfg = dataclasses.replace(config_from_jax(jcfg), sep_axis="sep",
                               cp_impl="ulysses")
    tmesh = build_mesh({"mp": 2, "sep": 4}, CPU8)
    tps = TL.shard_params(tp, tmesh, tcfg, mp_axis="mp")
    ids = torch.zeros((2, 32), dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="5a's rest"):
        TL.loss_fn(tps, ids, ids, tcfg)


def test_sharded_sep_forward_joins_the_sequence():
    """The sharded forward's logits with the sequence over sep 4 come back
    whole, in batch and sequence order: equal to the serial forward's
    within 3e-5 (a wrong RoPE offset for a sequence part moves them by
    far more at S 32)."""
    jcfg, jp, tp = _model(6)
    tcfg = dataclasses.replace(config_from_jax(jcfg), sep_axis="sep")
    tmesh = build_mesh({"dp": 2, "sep": 4}, CPU8)
    tps = TL.shard_params(tp, tmesh, tcfg, mp_axis=None)
    ids = torch.from_numpy(np.random.default_rng(2).integers(
        0, 96, (2, 32)).astype(np.int32))
    got = TL.forward(tps, ids, tcfg).detach().numpy()
    ref = TL.forward(tp, ids, dataclasses.replace(
        tcfg, sep_axis=None)).detach().numpy()
    np.testing.assert_allclose(got, ref, atol=3e-5, rtol=3e-5)

"""The port's pipeline parallelism (``paddle_tpu_torch.distributed.
pipeline`` and ``models.llama``'s ``to_pp_layout`` / ``pp_param_specs`` /
``make_pp_train_step``) against the JAX package's, on the same numpy
inputs and weights.

The mesh is ``tests/test_pipeline.py``'s dp 2 x pp 4: JAX's over the
8-device CPU mesh of ``tests/conftest.py``, the port's over ``["cpu"] *
8`` (one controller over a placement), both built by their ``fleet.init``.
Tolerances are the reference tests': the schedule's outputs within 1e-5 of
JAX's and of the serial chain, gradients within 1e-4 (remat against no
remat 1e-5, the single-stage mesh 1e-6); the pipelined LLaMA loss within
1e-4 + 1e-5 x |loss| of the serial loss and of JAX's pipelined step, and
one AdamW step (lr 1e-3) within 2e-4 of the serial step's parameters and
of JAX's. The pp MoE case (no ``ep`` axis) holds the port's pipelined
loss to JAX's within the same rule.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

from paddle_tpu.distributed import fleet as jfleet
from paddle_tpu.distributed.pipeline import pipeline_scan as jax_scan
from paddle_tpu.distributed.pipeline import pipeline_ticks as jax_ticks
from paddle_tpu.distributed.topology import (
    HybridCommunicateGroup as JHCG,
    build_mesh as jbuild_mesh,
    set_hybrid_communicate_group as jax_set_group)
from paddle_tpu.models import llama as JL
from paddle_tpu_torch.distributed import fleet as tfleet
from paddle_tpu_torch.distributed.pipeline import (pipeline_scan,
                                                   pipeline_ticks,
                                                   ring_schedule)
from paddle_tpu_torch.distributed.sharding import shard_tree
from paddle_tpu_torch.distributed.topology import (
    HybridCommunicateGroup, build_mesh, set_hybrid_communicate_group)
from paddle_tpu_torch.models import llama as TL
from paddle_tpu_torch.models.convert import (config_from_jax,
                                             params_from_jax, to_numpy)

torch.set_num_threads(2)

CPU8 = ["cpu"] * 8


@pytest.fixture
def pp_mesh():
    jst, tst = jfleet.DistributedStrategy(), tfleet.DistributedStrategy()
    jst.hybrid_configs = tst.hybrid_configs = {
        "dp_degree": 2, "mp_degree": 1, "pp_degree": 4}
    jfleet.init(is_collective=True, strategy=jst)
    tfleet.init(is_collective=True, strategy=tst, devices=CPU8)
    yield (jfleet.get_hybrid_communicate_group(),
           tfleet.get_hybrid_communicate_group())
    jax_set_group(None)
    set_hybrid_communicate_group(None)


def _jax_stage(params, x):
    w, b = params
    return jnp.tanh(x @ w + b)


def _stage(params, x):
    w, b = params
    return torch.tanh(x @ w + b)


def _params(chunks, H, seed):
    rng = np.random.RandomState(seed)
    return ((rng.randn(chunks, H, H) * 0.3).astype(np.float32),
            (rng.randn(chunks, H) * 0.1).astype(np.float32))


def _t(params, grad=True):
    return tuple(torch.from_numpy(p).requires_grad_(grad) for p in params)


def _serial(ws, bs, xs):
    y = xs
    for c in range(ws.shape[0]):
        y = torch.tanh(y @ ws[c] + bs[c])
    return y


# ---------------------------------------------------------------------------
# the schedule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("V,M", [(1, 6), (2, 4), (2, 6)])
def test_forward_parity(pp_mesh, V, M):
    """``TestPipelineScan.test_forward_parity`` (V 1) and
    ``TestCircularSchedule.test_forward_parity`` (V 2, M == S and M > S):
    JAX's schedule, the port's and the serial chain agree."""
    jh, th = pp_mesh
    S, B, H = 4, 2, 8
    ws, bs = _params(S * V, H, 3 + V)
    xs = np.random.RandomState(3).randn(M, B, H).astype(np.float32)
    want = np.asarray(jax_scan(_jax_stage, (jnp.asarray(ws), jnp.asarray(bs)),
                               jnp.asarray(xs), mesh=jh.mesh,
                               circular_repeats=V))
    got = pipeline_scan(_stage, _t((ws, bs), False), torch.from_numpy(xs),
                        mesh=th.mesh, circular_repeats=V)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    ref = _serial(*_t((ws, bs), False), torch.from_numpy(xs))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-5)


@pytest.mark.parametrize("V,M,seed", [(1, 5, 1), (2, 4, 1)])
def test_grad_parity(pp_mesh, V, M, seed):
    """``test_grad_parity`` of both classes: the gradient of
    ``outs.sum()`` against JAX's and the serial chain's, within 1e-4."""
    jh, th = pp_mesh
    S, B, H = 4, 2, 8
    ws, bs = _params(S * V, H, seed)
    xs = np.random.RandomState(4).randn(M, B, H).astype(np.float32)
    jg = jax.grad(lambda p: jax_scan(_jax_stage, p, jnp.asarray(xs),
                                     mesh=jh.mesh,
                                     circular_repeats=V).sum())(
        (jnp.asarray(ws), jnp.asarray(bs)))
    p = _t((ws, bs))
    got = torch.autograd.grad(pipeline_scan(
        _stage, p, torch.from_numpy(xs), mesh=th.mesh,
        circular_repeats=V).sum(), p)
    p2 = _t((ws, bs))
    ref = torch.autograd.grad(_serial(*p2, torch.from_numpy(xs)).sum(), p2)
    for a, b, c in zip(got, jg, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4)
        np.testing.assert_allclose(a.numpy(), c.numpy(), atol=1e-4)


def test_remat_matches(pp_mesh):
    _, th = pp_mesh
    ws, bs = _params(4, 8, 2)
    xs = torch.from_numpy(np.random.RandomState(2).randn(4, 2, 8).astype(
        np.float32))
    grads = []
    for remat in (False, True):
        p = _t((ws, bs))
        grads.append(torch.autograd.grad(pipeline_scan(
            _stage, p, xs, mesh=th.mesh, remat=remat).sum(), p))
    for a, b in zip(*grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)


def test_batch_spec_splits_the_rings(pp_mesh):
    """``batch_spec=(None, "dp")``: one ring per dp rank on its half of
    dim 1, the halves joined; equal to the replicated schedule."""
    _, th = pp_mesh
    ws, bs = _params(4, 8, 5)
    xs = torch.from_numpy(np.random.RandomState(5).randn(4, 4, 8).astype(
        np.float32))
    a = pipeline_scan(_stage, _t((ws, bs), False), xs, mesh=th.mesh,
                      batch_spec=(None, "dp"))
    b = pipeline_scan(_stage, _t((ws, bs), False), xs, mesh=th.mesh)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)


def test_single_stage_mesh():
    """pp 1 degenerates to the chunks in order on each micro-batch."""
    ws = np.ones((1, 4, 4), np.float32) * 0.1
    bs = np.zeros((1, 4), np.float32)
    xs = np.ones((3, 2, 4), np.float32)
    jout = jax_scan(_jax_stage, (jnp.asarray(ws), jnp.asarray(bs)),
                    jnp.asarray(xs), mesh=JHCG(dp=8).mesh)
    out = pipeline_scan(_stage, _t((ws, bs), False), torch.from_numpy(xs),
                        mesh=HybridCommunicateGroup(dp=8,
                                                    devices=CPU8).mesh)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-6)
    np.testing.assert_allclose(out.numpy(),
                               np.tanh(xs @ ws[0] + bs[0]), atol=1e-6)


def test_leading_dim_and_circular_errors(pp_mesh):
    """The JAX messages: stage params whose leading dim is not S x V, and
    the circular schedule with M < S."""
    jh, th = pp_mesh
    ws, bs = _params(8, 8, 0)
    xs = np.zeros((2, 2, 8), np.float32)
    for V in (1, 2):
        with pytest.raises(ValueError) as want:
            jax_scan(_jax_stage, (jnp.asarray(ws), jnp.asarray(bs)),
                     jnp.asarray(xs), mesh=jh.mesh, circular_repeats=V)
        with pytest.raises(ValueError) as got:
            pipeline_scan(_stage, _t((ws, bs), False), torch.from_numpy(xs),
                          mesh=th.mesh, circular_repeats=V)
        assert str(got.value) == str(want.value)
    assert "micro_batches >= stages" in str(got.value)


def test_tick_count_and_bubble(pp_mesh):
    """``test_tick_count_and_bubble``: ``pipeline_ticks`` is JAX's ``V*M +
    S - 1`` and the bubble shrinks with V; the schedule walks that many
    ticks and applies a chunk exactly ``V*M*S`` times (bubble ticks do no
    work), each stage its own chunks in lap order."""
    S, M = 4, 8
    for V in (1, 2, 4):
        assert pipeline_ticks(M, S, V) == jax_ticks(M, S, V) == V * M + S - 1
    cost = {V: pipeline_ticks(M, S, V) / V for V in (1, 2, 4)}
    assert cost[4] < cost[2] < cost[1]
    bubble = {V: (cost[V] - M) / cost[V] for V in (1, 2, 4)}
    assert bubble[2] < bubble[1] and bubble[4] < bubble[2]
    for V, M_ in ((1, 4), (2, 4), (2, 6)):
        seen = []

        def stage(p, x):
            seen.append(int(p[0]))
            return x + p[0]
        params = [torch.tensor([[float(v * S + s)] for v in range(V)])
                  for s in range(S)]
        xs = torch.zeros(M_, 1)
        out = ring_schedule(stage, params, xs, circular_repeats=V)
        assert len(seen) == V * M_ * S
        assert torch.equal(out, torch.full((M_, 1),
                                           float(sum(range(S * V)))))
        for s in range(S):
            mine = [c for c in seen if c % S == s]
            assert mine == sorted(mine)


# ---------------------------------------------------------------------------
# the pipelined LLaMA step
# ---------------------------------------------------------------------------

def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def _setup(tie=False, V=2, **kw):
    base = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
                num_hidden_layers=8, num_attention_heads=4,
                num_key_value_heads=2, max_position_embeddings=64,
                use_kernels=False, tie_word_embeddings=tie)
    base.update(kw)
    jcfg = JL.LlamaConfig(**base)
    jmesh = jbuild_mesh({"dp": 2, "pp": 4}, jax.devices()[:8])
    tmesh = build_mesh({"dp": 2, "pp": 4}, CPU8)
    jp = JL.init_params(jcfg, jax.random.PRNGKey(0))
    jpp = jax.tree_util.tree_map(
        lambda p, s: jax.device_put(p, NamedSharding(jmesh, s)),
        JL.to_pp_layout(jp, 4, V), JL.pp_param_specs(jcfg))
    tcfg = config_from_jax(jcfg)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                         device="cpu")
    tpp = shard_tree(TL.to_pp_layout(tp, 4, V), tmesh, TL.pp_param_specs(tcfg))
    return jcfg, tcfg, jmesh, tmesh, jp, jpp, tp, tpp


def _batch(seed, B=8, T=16, vocab=128):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (B, T)).astype(np.int32)
    labels = rng.integers(0, vocab, (B, T)).astype(np.int32)
    return ids, labels


def test_pp_specs_and_layout_match_jax():
    """``pp_param_specs`` is JAX's as tuples (dense, tied, MoE); the
    laid-out tree holds at every coordinate the data JAX's array holds
    there; ``from_pp_layout`` gives the serial tree back."""
    for kw in ({}, {"tie_word_embeddings": True}, {"moe_num_experts": 4}):
        jcfg = JL.LlamaConfig(vocab_size=128, hidden_size=64,
                              intermediate_size=128, num_hidden_layers=8,
                              num_attention_heads=4, **kw)
        want = jax.tree_util.tree_map(tuple, JL.pp_param_specs(jcfg),
                                      is_leaf=lambda x: not isinstance(
                                          x, dict))
        assert TL.pp_param_specs(config_from_jax(jcfg)) == want
    _, _, jmesh, tmesh, _, jpp, tp, tpp = _setup()
    for name, ja in _flat(jpp).items():
        st = _flat(tpp)[name]
        for sh in ja.addressable_shards:
            c = tuple(int(i) for i in np.argwhere(jmesh.devices
                                                  == sh.device)[0])
            np.testing.assert_array_equal(st.local(c).numpy(),
                                          np.asarray(sh.data), err_msg=name)
    back = TL.from_pp_layout(tpp)
    for k, a in _flat(to_numpy(back)).items():
        np.testing.assert_array_equal(a, _flat(to_numpy(tp))[k])


def test_loss_and_update_parity(pp_mesh):
    """``TestPipelinedLlama.test_loss_and_update_parity``: dp 2 x pp 4 x V
    2, M 4, labels with ignored positions; the loss against the serial
    loss and JAX's pipelined step, one AdamW step against the serial
    step's and JAX's parameters; dp replicas bit-equal."""
    jcfg, tcfg, jmesh, tmesh, jp, jpp, tp, tpp = _setup()
    ids, labels = _batch(0)
    labels[0, :3] = -100
    init_j, step_j = JL.make_pp_train_step(jcfg, jmesh, micro_batches=4,
                                           circular_repeats=2, lr=1e-3)
    jnew, _, jl = jax.jit(step_j)(jpp, jax.device_put(init_j(jpp)), ids,
                                  labels)
    init_t, step_t = TL.make_pp_train_step(tcfg, tmesh, micro_batches=4,
                                           circular_repeats=2, lr=1e-3)
    tpp, opt, tl = step_t(tpp, init_t(tpp), torch.from_numpy(ids),
                          torch.from_numpy(labels))
    serial = float(TL.loss_fn(tp, torch.from_numpy(ids),
                              torch.from_numpy(labels), tcfg))
    assert abs(float(tl) - serial) < 1e-4 + 1e-5 * abs(serial)
    assert abs(float(tl) - float(jl)) < 1e-4 + 1e-5 * abs(float(jl))
    init_s, step_s = TL.make_train_step(tcfg, lr=1e-3)
    ps, _, _ = step_s(tp, init_s(tp), torch.from_numpy(ids),
                      torch.from_numpy(labels))
    got = _flat(to_numpy(TL.from_pp_layout(tpp)))
    jback = _flat(jax.tree_util.tree_map(np.asarray,
                                         JL.from_pp_layout(jnew)))
    for k, a in _flat(to_numpy(ps)).items():
        np.testing.assert_allclose(got[k], a, atol=2e-4, err_msg=k)
        np.testing.assert_allclose(got[k], jback[k], atol=2e-4, err_msg=k)
    assert int(opt["step"]) == 1
    for st in TL._leaves(tpp):
        for idx, c in st.unique():
            for c2 in tmesh.coords():
                if st.index(c2) == idx:
                    assert torch.equal(st.local(c2), st.local(c))


def test_tied_embeddings(pp_mesh):
    """``test_tied_embeddings``: V 1, the head is the vocab-sharded embed."""
    jcfg, tcfg, jmesh, tmesh, jp, jpp, tp, tpp = _setup(tie=True, V=1)
    ids, labels = _batch(1)
    init_j, step_j = JL.make_pp_train_step(jcfg, jmesh, micro_batches=4,
                                           lr=1e-3)
    _, _, jl = jax.jit(step_j)(jpp, init_j(jpp), ids, labels)
    init_t, step_t = TL.make_pp_train_step(tcfg, tmesh, micro_batches=4,
                                           lr=1e-3)
    _, _, tl = step_t(tpp, init_t(tpp), torch.from_numpy(ids),
                      torch.from_numpy(labels))
    serial = float(TL.loss_fn(tp, torch.from_numpy(ids),
                              torch.from_numpy(labels), tcfg))
    assert abs(float(tl) - serial) < 1e-4 + 1e-5 * abs(serial)
    assert abs(float(tl) - float(jl)) < 1e-4 + 1e-5 * abs(float(jl))


def test_block_weights_sharded(pp_mesh):
    """``test_block_weights_sharded``: a placement entry holds 1/S of every
    block weight and of the vocab-sharded embedding."""
    _, _, _, tmesh, _, _, tp, tpp = _setup()
    c0 = (0,) * 6
    for name in ("wq", "w_gate", "w_down"):
        st = tpp["layers"][name]
        assert st.nbytes_at(c0) * 4 == tp["layers"][name].numel() * 4, name
    assert tpp["embed"].nbytes_at(c0) * 4 == tp["embed"].numel() * 4


def test_validation_errors(pp_mesh):
    """``test_validation_errors``: 6 layers over 4 stages x 2 laps, the
    JAX message; a vocab that does not split over pp; a batch that does
    not split into the micro-batches."""
    jmesh = jbuild_mesh({"dp": 2, "pp": 4}, jax.devices()[:8])
    tmesh = build_mesh({"dp": 2, "pp": 4}, CPU8)
    for kw in (dict(vocab_size=128, num_hidden_layers=6),
               dict(vocab_size=126, num_hidden_layers=8)):
        jcfg = JL.LlamaConfig(hidden_size=32, intermediate_size=64,
                              num_attention_heads=2, **kw)
        with pytest.raises(ValueError, match="not divisible") as want:
            JL.make_pp_train_step(jcfg, jmesh, micro_batches=4,
                                  circular_repeats=2)
        with pytest.raises(ValueError, match="not divisible") as got:
            TL.make_pp_train_step(config_from_jax(jcfg), tmesh,
                                  micro_batches=4, circular_repeats=2)
        assert str(got.value) == str(want.value)
    _, tcfg, _, _, _, _, _, tpp = _setup(V=1)
    init_t, step_t = TL.make_pp_train_step(tcfg, tmesh, micro_batches=3)
    ids = torch.zeros((8, 16), dtype=torch.int32)
    with pytest.raises(ValueError, match="not divisible by micro_batches"):
        step_t(tpp, init_t(tpp), ids, ids)


def test_moe_without_ep_matches_jax(pp_mesh):
    """A pp MoE config with no ``ep`` axis runs through ``with_aux``, the
    aux over every (layer, micro-batch) / ``L * M`` averaged over dp: the
    loss equals JAX's pipelined MoE step's within 1e-4 + 1e-5 x |loss|;
    one AdamW step's parameters within 2e-4 of JAX's."""
    jcfg, tcfg, jmesh, tmesh, _, jpp, _, tpp = _setup(
        V=1, moe_num_experts=4, moe_top_k=2, intermediate_size=32)
    ids, labels = _batch(2)
    init_j, step_j = JL.make_pp_train_step(jcfg, jmesh, micro_batches=4,
                                           lr=1e-3)
    jnew, _, jl = jax.jit(step_j)(jpp, init_j(jpp), ids, labels)
    init_t, step_t = TL.make_pp_train_step(tcfg, tmesh, micro_batches=4,
                                           lr=1e-3)
    tpp, _, tl = step_t(tpp, init_t(tpp), torch.from_numpy(ids),
                        torch.from_numpy(labels))
    assert abs(float(tl) - float(jl)) < 1e-4 + 1e-5 * abs(float(jl))
    jback = _flat(jax.tree_util.tree_map(np.asarray,
                                         JL.from_pp_layout(jnew)))
    for k, a in _flat(to_numpy(TL.from_pp_layout(tpp))).items():
        np.testing.assert_allclose(a, jback[k], atol=2e-4, err_msg=k)


def test_pp_by_ep_and_shard_params_refused(pp_mesh):
    """pp x ep (refused until expert parallelism was ported) runs: at pp 4
    x ep 2 the loss equals the same pp step with the experts whole on
    every entry (``tests/test_torch_ep.py`` holds it to JAX);
    ``shard_params`` on a pp mesh keeps refusing (JAX's ``param_specs``
    has no pp entry) and names the pp layout."""
    jcfg = JL.LlamaConfig(vocab_size=128, hidden_size=32,
                          intermediate_size=32, num_hidden_layers=4,
                          num_attention_heads=2, moe_num_experts=4)
    tcfg = config_from_jax(jcfg)
    ep_mesh = build_mesh({"pp": 4, "ep": 2}, CPU8)
    moe_p = TL.init_params(tcfg, seed=0, device="cpu")
    ids = torch.from_numpy(_batch(3)[0])
    losses = []
    for ep in ("ep", None):
        pp = shard_tree(TL.to_pp_layout(moe_p, 4), ep_mesh,
                        TL.pp_param_specs(tcfg, "pp", ep))
        init_t, step_t = TL.make_pp_train_step(tcfg, ep_mesh,
                                               micro_batches=4)
        losses.append(float(step_t(pp, init_t(pp), ids, ids)[2]))
    assert abs(losses[0] - losses[1]) < 1e-6, losses
    dense = config_from_jax(JL.LlamaConfig(
        vocab_size=128, hidden_size=32, intermediate_size=32,
        num_hidden_layers=4, num_attention_heads=2))
    params = TL.init_params(dense, seed=0, device="cpu")
    with pytest.raises(NotImplementedError,
                       match="to_pp_layout and pp_param_specs"):
        TL.shard_params(params, build_mesh({"pp": 4, "dp": 2}, CPU8), dense)
    init_t, step_t = TL.make_pp_train_step(
        dense, build_mesh({"pp": 4, "dp": 2}, CPU8), micro_batches=4)
    with pytest.raises(ValueError, match="pp_param_specs"):
        step_t(params, init_t(params), torch.zeros((8, 4)),
               torch.zeros((8, 4)))

"""The port's GShard MoE FFN (``paddle_tpu_torch.distributed.moe``,
``models.llama._moe_ffn``) in training and in the paged serving path,
against the JAX package on the same weights and inputs.

* ``gshard_routing``: combine and dispatch equal, aux rtol 1e-6, on random
  logits at a capacity that drops, and on rows whose probabilities tie
  exactly (``lax.top_k`` breaks ties toward the lower index).
* ``_moe_ffn``: the output within atol 1e-5 (fp32) and the drop count
  (``T * top_k`` less the port's kept count) equal; at bf16 within one
  bf16 step of the output's scale.
* Training: ``forward(return_aux=True)`` (logits atol 2e-5, aux rtol
  1e-5), ``loss_fn`` and every gradient leaf (loss rtol 1e-5, leaves 1e-5
  x max|g|), and three AdamW steps' losses (rtol 1e-4), with full remat,
  ``save_flash`` and no remat. ``num_params`` equals JAX's and the leaf
  count.
* Serving: each paged entry point (prefill, chunk, mixed, decode, verify)
  gives JAX's logits (atol 1e-4) and drop count (equal), at a capacity
  factor that drops nothing (4.0) and one that drops (0.5), on fp and
  int8 KV pools; the engine's greedy, sampled and speculative streams and
  dispatch counters equal the JAX engine's (capacity factor 4.0, as
  ``tests/test_generation.py`` uses), and speculation on gives the
  streams of speculation off.
* Null-block writes: under MoE every row that writes a pool cell stores
  that cell's last writer's values (``_write_src``; on a card the
  scatter keeps an unspecified duplicate), and a decode whose freed
  slots share the null block's cell matches JAX at a capacity that drops.
* ``quantize="int8"`` with MoE raises ``ValueError`` (the JAX package's
  int8 MoE path is at fault: ROADMAP.md section C).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.distributed.moe import gshard_routing as jax_routing
from paddle_tpu.inference.serving.engine import ServingConfig as JConfig
from paddle_tpu.inference.serving.engine import ServingEngine as JEngine
from paddle_tpu.models import generation as JG
from paddle_tpu.models import llama as JL
from paddle_tpu_torch.distributed.moe import gshard_routing
from paddle_tpu_torch.inference.serving.engine import ServingConfig as TConfig
from paddle_tpu_torch.inference.serving.engine import ServingEngine as TEngine
from paddle_tpu_torch.models import generation as TG
from paddle_tpu_torch.models import llama as TL
from paddle_tpu_torch.models.convert import config_from_jax, params_from_jax

torch.set_num_threads(2)

VOCAB = 97


def _cfg(**kw):
    base = dict(vocab_size=VOCAB, hidden_size=32, intermediate_size=48,
                num_hidden_layers=2, num_attention_heads=4,
                num_key_value_heads=2, moe_num_experts=4, moe_top_k=2)
    base.update(kw)
    return JL.LlamaConfig(**base)


def _model(seed=0, **kw):
    jcfg = _cfg(**kw)
    jp = JL.init_params(jcfg, jax.random.PRNGKey(seed))
    np_p = jax.tree_util.tree_map(np.asarray, jp)
    return jcfg, jp, config_from_jax(jcfg), params_from_jax(np_p,
                                                            device="cpu")


# ---------------------------------------------------------------------------
# routing and the FFN
# ---------------------------------------------------------------------------

def _route_both(logits, k, cap):
    jc, jd, ja = jax_routing(jnp.asarray(logits), k, cap)
    tc, td, ta = gshard_routing(torch.from_numpy(logits), k, cap)
    return (np.asarray(jc), np.asarray(jd), float(ja)), \
        (tc.numpy(), td.numpy(), float(ta))


@pytest.mark.parametrize("T,E,k,cap", [(16, 4, 2, 3), (24, 8, 2, 4),
                                       (12, 4, 1, 2), (10, 6, 3, 20)])
def test_gshard_routing_matches_jax(T, E, k, cap):
    logits = np.random.default_rng(T + E).normal(size=(T, E)) \
        .astype(np.float32)
    (jc, jd, ja), (tc, td, ta) = _route_both(logits, k, cap)
    np.testing.assert_array_equal(td, jd)
    np.testing.assert_allclose(tc, jc, rtol=0, atol=1e-7)
    np.testing.assert_allclose(ta, ja, rtol=1e-6)
    kept = T * k - jd.sum()
    assert (kept > 0) == (cap * E < T * k)


def test_gshard_routing_exact_ties_take_the_lower_index():
    """Rows whose top probabilities tie exactly: the first choice is the
    lowest tied expert, as ``lax.top_k`` picks it."""
    logits = np.zeros((8, 4), np.float32)
    logits[1] = [1.0, 2.0, 2.0, 2.0]
    logits[2] = [3.0, 3.0, 0.5, 3.0]
    logits[3] = [0.0, -1.0, 0.0, -1.0]
    logits[5] = [7.0, 7.0, 7.0, 7.0]
    (jc, jd, ja), (tc, td, ta) = _route_both(logits, 2, 3)
    np.testing.assert_array_equal(td, jd)
    np.testing.assert_allclose(tc, jc, rtol=0, atol=1e-7)
    np.testing.assert_allclose(ta, ja, rtol=1e-6)
    # row 1's first choice is expert 1, row 2's expert 0
    assert jd[1, 1].any() and jd[2, 0].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cf", [0.5, 1.25, 4.0])
def test_moe_ffn_matches_jax(cf, dtype):
    jcfg, jp, tcfg, tp = _model(1, moe_capacity_factor=cf,
                                dtype=getattr(jnp, dtype))
    h = np.random.default_rng(3).normal(size=(3, 7, 32)).astype(np.float32)
    jlp = jax.tree_util.tree_map(lambda a: a[0], jp["layers"])
    jy, jaux, jdrop = JL._moe_ffn(jlp, jnp.asarray(h, jcfg.dtype), jcfg)
    tlp = {k: v[0] for k, v in tp["layers"].items()}
    ty, taux, tkept = TL._moe_ffn(tlp, torch.from_numpy(h).to(tcfg.dtype),
                                  tcfg)
    tdrop = 3 * 7 * tcfg.moe_top_k - float(tkept)
    jy = np.asarray(jy.astype(jnp.float32))
    atol = 1e-5 if dtype == "float32" else 2 ** -7 * np.abs(jy).max()
    np.testing.assert_allclose(ty.float().numpy(), jy, rtol=0, atol=atol)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)
    assert float(tdrop) == float(jdrop)
    assert (float(tdrop) > 0) == (cf == 0.5)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

B, S = 2, 16
REMAT = {"plain": dict(), "full-remat": dict(remat=True),
         "save_flash": dict(use_kernels=True, remat=True,
                            remat_policy="save_flash")}


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, VOCAB, (B, S)).astype(np.int32)
    labels = rng.integers(0, VOCAB, (B, S)).astype(np.int32)
    labels[1, :4] = -100
    return ids, labels


def _assert_leaves(got, want, rel):
    for a, b in zip(TL._leaves(got), TL._leaves(want)):
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=rel * np.abs(b).max())


@pytest.mark.parametrize("mode", list(REMAT))
def test_moe_forward_loss_grads_match_jax(mode):
    jcfg, jp, tcfg, tp = _model(2, moe_capacity_factor=1.0, ce_chunks=4,
                                **REMAT[mode])
    ids, labels = _batch(1)
    jl, jaux = JL.forward(jp, jnp.asarray(ids), jcfg, return_aux=True)
    tl_, taux = TL.forward(tp, torch.from_numpy(ids), tcfg, return_aux=True)
    np.testing.assert_allclose(tl_.detach().numpy(), np.asarray(jl),
                               rtol=0, atol=2e-5)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)
    jloss, jg = jax.jit(jax.value_and_grad(
        lambda p: JL.loss_fn(p, jnp.asarray(ids), jnp.asarray(labels),
                             jcfg)))(jp)
    leaves = TL._leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    tloss = TL.loss_fn(tp, torch.from_numpy(ids), torch.from_numpy(labels),
                       tcfg)
    grads = torch.autograd.grad(tloss, leaves)
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5)
    it = iter(g.numpy() for g in grads)
    _assert_leaves(TL._tree_map(lambda _: next(it), tp),
                   jax.tree_util.tree_map(np.asarray, jg), 1e-5)
    # the load-balancing term is in the loss (ce_chunks is ignored)
    dense = JL.loss_fn(jp, jnp.asarray(ids), jnp.asarray(labels),
                       jcfg.__class__(**{**jcfg.__dict__,
                                         "moe_aux_weight": 0.0}))
    assert abs(float(jloss) - float(dense) - 0.01 * float(jaux)) < 1e-5


@pytest.mark.parametrize("mode", list(REMAT))
def test_moe_train_steps_match_jax(mode):
    jcfg, jp, tcfg, tp = _model(3, **REMAT[mode])
    init_j, jstep = JL.make_train_step(jcfg, lr=1e-2)
    init_t, tstep = TL.make_train_step(tcfg, lr=1e-2)
    jo, to = init_j(jp), init_t(tp)
    jfn = jax.jit(jstep)
    want, got = [], []
    for i in range(3):
        ids, labels = _batch(10 + i)
        jp, jo, jl = jfn(jp, jo, jnp.asarray(ids), jnp.asarray(labels))
        tp, to, tl_ = tstep(tp, to, torch.from_numpy(ids),
                            torch.from_numpy(labels))
        want.append(float(jl))
        got.append(tl_.item())
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert int(to["step"]) == 3


def test_moe_num_params_and_config():
    for kw in (dict(), dict(moe_num_experts=8, moe_top_k=1,
                            tie_word_embeddings=True)):
        jcfg, _, tcfg, tp = _model(0, **kw)
        n = sum(p.numel() for p in TL._leaves(tp))
        assert n == TL.num_params(tcfg) == JL.num_params(jcfg)
        own = TL.init_params(tcfg, device="cpu")
        assert {k: tuple(v.shape) for k, v in own["layers"].items()} == \
            {k: tuple(v.shape) for k, v in tp["layers"].items()}
        for f in ("moe_num_experts", "moe_top_k", "moe_capacity_factor",
                  "moe_aux_weight"):
            assert getattr(tcfg, f) == getattr(jcfg, f)
    d = TL.LlamaConfig()
    j = JL.LlamaConfig()
    assert (d.moe_top_k, d.moe_capacity_factor, d.moe_aux_weight) == \
        (j.moe_top_k, j.moe_capacity_factor, j.moe_aux_weight)


# ---------------------------------------------------------------------------
# the paged entry points
# ---------------------------------------------------------------------------

BS, W, N = 4, 6, 24
TABLES = np.array([[1, 2, 3, 4, 0, 0], [5, 6, 7, 8, 0, 0],
                   [9, 10, 11, 12, 13, 0], [0] * W], np.int32)
STEPS = ("prefill", "chunk", "mixed", "decode", "spec")
COMBOS = {"cf4": (4.0, None), "cf0.5": (0.5, None),
          "cf1.25-int8pool": (1.25, "int8")}


def _scenario(side, params, cfg, kv_quant, use_kernel=False):
    """prefill (2 live rows + 2 inactive), a chunk, a mixed step, a decode
    step and a verify, in order, from one zeroed pool; returns [(logits,
    drops)] as numpy / float. Tokens are fixed, so both sides see the same
    inputs."""
    rng = np.random.default_rng(5)
    if side == "jax":
        G, A = JG, jnp.asarray
        pool = JG.init_paged_pool(cfg, N, BS, kv_quant=kv_quant)
        kw = {}
    else:
        G = TG

        def A(x):
            return torch.from_numpy(np.ascontiguousarray(x))
        pool = TG.init_paged_pool(cfg, N, BS, kv_quant=kv_quant,
                                  device="cpu")
        kw = dict(use_kernel=use_kernel)
    rec = []

    def keep(r):
        rec.append((np.asarray(r[0]) if side == "jax"
                    else r[0].numpy(), float(r[2])))
        return r[1]

    ids = np.zeros((4, 8), np.int32)
    ids[0, :7] = rng.integers(0, VOCAB, 7)
    ids[1, :5] = rng.integers(0, VOCAB, 5)
    pool = keep(G.paged_prefill(
        params, cfg, A(ids), A(np.array([7, 5, 1, 1], np.int32)),
        A(np.concatenate([TABLES[:2], np.zeros((2, W), np.int32)])), pool,
        A(np.array([True, True, False, False]))))
    cid = np.zeros((1, 8), np.int32)
    cid[0, :6] = rng.integers(0, VOCAB, 6)
    start, n = 0, 6
    if side == "jax":
        start, n = jnp.int32(0), jnp.int32(6)
    pool = keep(G.paged_prefill_chunk(params, cfg, A(cid), start, n,
                                      A(TABLES[2:3]), pool))
    act = np.array([True, True, True, False])
    toks = rng.integers(0, VOCAB, (4, 3)).astype(np.int32)
    pool = keep(G.paged_mixed_step(
        params, cfg, A(toks), A(np.array([7, 5, 6, 0], np.int32)),
        A(np.array([1, 1, 3, 1], np.int32)), A(TABLES), pool, A(act), **kw))
    pool = keep(G.paged_decode_step(
        params, cfg, A(toks[:, 0]), A(np.array([8, 6, 9, 0], np.int32)),
        A(TABLES), pool, A(act), **kw))
    spec = rng.integers(0, VOCAB, (4, 4)).astype(np.int32)
    keep(G.paged_spec_step(
        params, cfg, A(spec), A(np.array([9, 7, 10, 0], np.int32)),
        A(np.array([3, 0, 2, 1], np.int32)), A(TABLES), pool, A(act), **kw))
    return rec


@pytest.fixture(scope="module")
def paged_runs():
    cache = {}

    def get(combo):
        if combo not in cache:
            cf, kvq = COMBOS[combo]
            jcfg, jp, tcfg, tp = _model(4, moe_capacity_factor=cf)
            cache[combo] = {"jax": _scenario("jax", jp, jcfg, kvq)}
            for use in (False, True):
                cache[combo][use] = _scenario("torch", tp, tcfg, kvq, use)
        return cache[combo]
    return get


CASES = [(c, s, k) for c in COMBOS for s in STEPS
         for k in ((False, True) if s in ("mixed", "decode", "spec")
                   else (False,))]


@pytest.mark.parametrize(
    "combo,step,use_kernel", CASES,
    ids=[f"{c}-{s}-{'kernel' if k else 'gather'}" for c, s, k in CASES])
def test_paged_entry_point_matches_jax(paged_runs, combo, step, use_kernel):
    r = paged_runs(combo)
    i = STEPS.index(step)
    (lg, drops), (want_lg, want_drops) = r[use_kernel][i], r["jax"][i]
    live = {"prefill": 2, "chunk": 1}.get(step, 3)
    assert np.isfinite(lg[:live]).all()
    np.testing.assert_allclose(lg[:live], want_lg[:live], rtol=0, atol=1e-4)
    assert drops == want_drops
    if combo == "cf0.5" and step in ("prefill", "mixed", "spec"):
        assert drops > 0


def test_dense_entry_points_report_no_drops():
    jcfg, jp, tcfg, tp = _model(4, moe_num_experts=0)
    for lg, drops in _scenario("torch", tp, tcfg, None):
        assert drops == 0.0


_LAYOUTS = {
    # a decode: four freed slots (phys 0, off 0) around two live ones
    "decode": (np.array([0, 0, 3, 0, 7, 0]), np.array([0, 0, 1, 0, 2, 0])),
    # a prefill: two rows padded into the null block at every offset
    "prefill": (np.array([[1, 1, 0, 0], [0, 0, 0, 0]]),
                np.array([[0, 1, 2, 3], [0, 1, 2, 3]])),
    "random": (np.random.default_rng(2).integers(0, 3, 40),
               np.random.default_rng(3).integers(0, 2, 40)),
}


@pytest.mark.parametrize("layout", list(_LAYOUTS))
def test_write_src_keeps_each_cells_last_writer(layout):
    """Each row of a K/V write list stores the values of the last row
    that writes its pool cell (the value XLA's CPU scatter keeps); a dense
    model keeps its write as it is."""
    phys, off = _LAYOUTS[layout]
    cfg = _model(0)[2]
    src = TG._write_src(cfg, torch.from_numpy(phys), torch.from_numpy(off),
                        BS).numpy()
    key = (phys * BS + off).reshape(-1)
    want = [max(j for j in range(key.size) if key[j] == key[i])
            for i in range(key.size)]
    assert src.tolist() == want
    assert len(set(key[src])) == len(set(key))
    dense = _model(0, moe_num_experts=0)[2]
    assert TG._write_src(dense, torch.from_numpy(phys),
                         torch.from_numpy(off), BS) is None


class _Writes:
    """A pool tensor that records what is written to it."""

    dtype = torch.float32

    def __init__(self):
        self.done = []

    def __setitem__(self, idx, value):
        self.done.append((idx, value))


@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_kv_store_gives_every_writer_of_a_cell_one_value(kv_quant):
    """Under MoE every row that writes a pool cell hands the scatter the
    same values, its cell's last writer's: which duplicate a CUDA
    ``index_put_`` keeps cannot change the pool."""
    phys, off = (torch.from_numpy(a) for a in _LAYOUTS["decode"])
    k, v = torch.randn(2, 6, 2, 8, generator=torch.Generator().manual_seed(0))
    names = ("k", "v") + (("k_scale", "v_scale") if kv_quant else ())
    pool = {n: _Writes() for n in names}
    src = TG._write_src(_model(0)[2], phys, off, BS)
    ka, va = TG._kv_store(pool, phys, off, k, v, src)
    # the attend view stays each row's own (prefill attends it)
    for got, want in ((ka, k), (va, v)):
        tol = 0 if kv_quant is None else want.abs().max() / 127
        assert (got - want).abs().max() <= tol
    cells = (phys * BS + off).tolist()
    last = {c: i for i, c in enumerate(cells)}
    for n in names:
        (idx, val), = pool[n].done
        assert torch.equal(idx[0], phys) and torch.equal(idx[1], off)
        for i, c in enumerate(cells):
            assert torch.equal(val[i], val[last[c]])
    if kv_quant is None:
        assert torch.equal(pool["k"].done[0][1], k[src])


@pytest.mark.parametrize("kv_quant", [None, "int8"])
@pytest.mark.parametrize("use_kernel", [False, True],
                         ids=["gather", "kernel"])
def test_inactive_slots_sharing_the_null_block_match_jax(kv_quant,
                                                         use_kernel):
    """A decode whose four freed slots (distinct tokens, so distinct K/V)
    all write the null block's cell (0, 0) ahead of two live slots in the
    experts' queues, at a capacity that drops: every row's logits (atol
    1e-4) and the drop count equal JAX's."""
    jcfg, jp, tcfg, tp = _model(6, moe_capacity_factor=0.5)
    rng = np.random.default_rng(7)
    toks = rng.permutation(VOCAB)[:6].astype(np.int32)
    lens = np.array([0, 0, 0, 0, 5, 3], np.int32)
    tables = np.zeros((6, W), np.int32)
    tables[4, :2], tables[5, :1] = (1, 2), (3,)
    act = np.array([False] * 4 + [True] * 2)
    jpool = JG.init_paged_pool(jcfg, N, BS, kv_quant=kv_quant)
    jl, _, jd = JG.paged_decode_step(jp, jcfg, jnp.asarray(toks),
                                     jnp.asarray(lens), jnp.asarray(tables),
                                     jpool, jnp.asarray(act))
    tpool = TG.init_paged_pool(tcfg, N, BS, kv_quant=kv_quant, device="cpu")
    tl, _, td = TG.paged_decode_step(
        tp, tcfg, torch.from_numpy(toks), torch.from_numpy(lens),
        torch.from_numpy(tables), tpool, torch.from_numpy(act),
        use_kernel=use_kernel)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=1e-4)
    assert float(td) == float(jd) > 0


# ---------------------------------------------------------------------------
# the serving engine
# ---------------------------------------------------------------------------

SAMPLED = dict(temperature=0.8, top_k=20, top_p=0.95)
_COUNTERS = ("prefill_dispatches", "decode_dispatches", "mixed_dispatches",
             "spec_dispatches", "spec_drafted", "spec_accepted", "chunks",
             "steps", "preemptions", "prefix_hit_tokens")
_BASE = dict(block_size=4, max_slots=3, max_model_len=96, decode_chunk=4,
             queue_depth=16, prefill_chunk=8, spec_ngram=2)


@pytest.fixture(scope="module")
def served():
    jcfg, jp, tcfg, tp = _model(0, moe_capacity_factor=4.0,
                                hidden_size=64, intermediate_size=96)
    return jcfg, jp, tcfg, tp


def _drain(engine, prompts, news, knobs, max_iters=None):
    before = {k: engine.stats()[k] for k in _COUNTERS}
    rids = [engine.submit(p, max_new_tokens=n, eos_token_id=None, seed=i,
                          **knobs[i])
            for i, (p, n) in enumerate(zip(prompts, news))]
    while engine.pending:
        engine.step(max_iters)
    st = engine.stats()
    if isinstance(engine, TEngine):
        assert st["blocks_in_use"] == 0
    return ([list(engine.request(r).tokens) for r in rids],
            {k: st[k] - before[k] for k in _COUNTERS})


def _prompts(served):
    """Three prompts that continue the model's own greedy stream (drafts
    fire on them) and three random ones, one past the prefill chunk."""
    jcfg, jp = served[0], served[1]
    rng = np.random.default_rng(1)
    out = []
    for _ in range(3):
        base = rng.integers(0, VOCAB, (6,)).astype(np.int32)
        gen = np.asarray(JG.generate(jp, jnp.asarray(base[None]), jcfg,
                                     max_new_tokens=24))[0]
        out.append(np.concatenate([base, gen[:24]]).astype(np.int32))
    for n in (5, 19, 11):
        out.append(rng.integers(0, VOCAB, (n,)).astype(np.int32))
    return out, [10, 12, 8, 9, 11, 7]


@pytest.mark.parametrize("spec", [0, 4], ids=["spec-off", "spec-on"])
@pytest.mark.parametrize("sampled", [False, True],
                         ids=["greedy", "sampled"])
def test_moe_engine_streams_match_jax(served, sampled, spec):
    jcfg, jp, tcfg, tp = served
    prompts, news = _prompts(served)
    knobs = [SAMPLED if sampled else {}] * len(prompts)
    sc = dict(_BASE, spec_decode=spec)
    want, jd = _drain(JEngine(jp, jcfg, JConfig(**sc)), prompts, news,
                      knobs, max_iters=2)
    for knob in ("off", "on"):
        got, td = _drain(TEngine(tp, tcfg, TConfig(paged_kernel=knob, **sc),
                                 device="cpu"), prompts, news, knobs,
                         max_iters=2)
        assert got == want
        assert td == jd
    if spec:
        assert jd["spec_dispatches"] > 0
        off, _ = _drain(TEngine(tp, tcfg, TConfig(**dict(sc, spec_decode=0)),
                                device="cpu"), prompts, news, knobs,
                        max_iters=2)
        assert off == want


def test_moe_int8_weights_raise_and_int8_pool_serves(served):
    _, _, tcfg, tp = served
    with pytest.raises(ValueError, match="moe_num_experts") as e:
        TEngine(tp, tcfg, TConfig(quantize="int8"), device="cpu")
    assert "quantize" in str(e.value)
    with pytest.raises(ValueError, match="moe_num_experts"):
        TL.ensure_quantized(tp, "int8")
    with pytest.raises(ValueError, match="moe_num_experts"):
        TL.quantize_params(tp)
    eng = TEngine(tp, tcfg, TConfig(kv_quant="int8", **_BASE),
                  device="cpu")
    out = eng.run([np.arange(9, dtype=np.int32)], max_new_tokens=5,
                  eos_token_id=None)
    assert len(out[0]) == 5


def test_reference_int8_moe_fault():
    """The JAX package's int8 MoE forward (the fault the port refuses to
    copy, ROADMAP.md section C): its logits part from the fp forward's by
    far more than the dense model's int8 error on the same inputs."""
    ids = jnp.asarray(np.random.default_rng(0).integers(0, VOCAB, (2, 8)))
    err = {}
    for ex in (4, 0):
        jcfg = _cfg(moe_num_experts=ex)
        jp = JL.init_params(jcfg, jax.random.PRNGKey(0))
        fp = np.asarray(JL.forward(jp, ids, jcfg))
        q8 = np.asarray(JL.forward(JL.quantize_params(jp), ids, jcfg))
        err[ex] = (float(np.abs(q8 - fp).max()), float(np.abs(fp).max()))
    print(f"int8 vs fp logits (max |diff|, max |logit|): MoE {err[4]}, "
          f"dense {err[0]}")
    assert err[4][0] > 10 * err[0][0]

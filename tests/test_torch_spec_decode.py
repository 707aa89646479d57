"""Seeded sampling and speculative decoding in the port's serving engine,
against the JAX package on the same weights and traces.

* ``paged_spec_step``: logits within 1e-4 and pools within 1e-5 (int8
  pools: one rounding step at x.5 boundaries, rarely) of the JAX verify
  step, fp and int8 pools, the gather path.
* ``ServingEngine`` with sampled requests (``temperature``, ``top_k``,
  ``top_p``, ``seed``): the same streams and dispatch counters as the JAX
  engine, fresh, under preemption pressure, on the two-phase path and
  with mixed batching.
* ``ServingEngine(spec_decode=4, spec_ngram=2)``: streams equal to the
  same engine with speculation off, bit for bit, greedy and sampled;
  equal to the JAX spec engine's streams with equal ``spec_*`` counter
  deltas; EOS inside an accepted run truncates; rollback leaves every
  live slot at ``blocks_for(seq_len)`` blocks and the pool empty after
  the drain; prompts that never repeat fall through to decode.
* A step that drafts dispatches verify and never mixed as well (the
  contract of ``tests/test_serving_mixed.py::TestMixedDispatchShape``,
  held here on a prompt that repeats a segment, so drafts fire by
  construction).

Prompts use vocab 97: the self-continuation prompts (a base plus the
model's own greedy stream, as ``tests/test_serving.py::
TestSpeculativeDecoding._cycled_prompts`` builds them) give the drafter
cycles to hit. JAX engines of one program shape share compiled programs
(``programs=``) and so one counter dict; counters are compared as deltas.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.inference.serving.engine import ServingConfig as JConfig
from paddle_tpu.inference.serving.engine import ServingEngine as JEngine
from paddle_tpu.models import generation as JG
from paddle_tpu.models import llama as JL
from paddle_tpu_torch.inference.serving.engine import ServingConfig as TConfig
from paddle_tpu_torch.inference.serving.engine import ServingEngine as TEngine
from paddle_tpu_torch.models import generation as TG
from paddle_tpu_torch.models.convert import config_from_jax, params_from_jax

torch.set_num_threads(2)

VOCAB = 97
SAMPLED = dict(temperature=0.8, top_k=20, top_p=0.95)
_COUNTERS = ("prefill_dispatches", "decode_dispatches", "mixed_dispatches",
             "spec_dispatches", "spec_drafted", "spec_accepted", "chunks",
             "steps", "preemptions", "prefix_hit_tokens", "recomputed_tokens")


@pytest.fixture(scope="module")
def model():
    cfg = JL.LlamaConfig(vocab_size=VOCAB, hidden_size=64,
                         intermediate_size=128, num_hidden_layers=2,
                         num_attention_heads=4, num_key_value_heads=2)
    params = JL.init_params(cfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                              device="cpu")
    return cfg, params, config_from_jax(cfg), tparams, {}


def _jax_engine(model, sc):
    cfg, params, _, _, programs = model
    key = (sc.get("spec_decode", 0), sc.get("kv_quant"))
    eng = JEngine(params, cfg, JConfig(**sc), programs=programs.get(key))
    programs.setdefault(key, eng.programs)
    return eng


def _drain(engine, prompts, news, knobs, eos=None, max_iters=None,
           check_rollback=False):
    """Submit every prompt (request i with ``seed=i`` and ``knobs[i]``),
    drain with ``step(max_iters)``; returns (streams, counter deltas,
    stats).
    ``check_rollback``: after every verify dispatch, each live decoding
    slot holds exactly ``blocks_for(seq_len)`` blocks."""
    before = {k: engine.stats()[k] for k in _COUNTERS}
    rids = [engine.submit(p, max_new_tokens=n, eos_token_id=eos, seed=i,
                          **knobs[i])
            for i, (p, n) in enumerate(zip(prompts, news))]
    while engine.pending:
        s0 = engine.stats()["spec_dispatches"]
        engine.step(max_iters)
        if check_rollback and engine.stats()["spec_dispatches"] > s0:
            bf = engine.cache.manager.blocks_for
            for r in engine._sched.decoding:
                if not r.finished:
                    assert len(r.blocks) == bf(int(engine._seq_lens[r.slot]))
    st = engine.stats()
    return ([list(engine.request(r).tokens) for r in rids],
            {k: st[k] - before[k] for k in _COUNTERS}, st)


def _trace(seed=0):
    """Six prompts, one past prefill_chunk, three sharing a prefix."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, VOCAB, size=12)
    prompts = []
    for i, n in enumerate([14, 5, 30, 19, 3, 16]):
        p = rng.integers(0, VOCAB, size=n)
        if i in (0, 3, 5):
            p[:12] = prefix
        prompts.append(p.astype(np.int32))
    return prompts, [10, 6, 8, 12, 9, 7]


def _spec_prompts(model, n=3, pre=32):
    """Self-continuation prompts plus one that quotes a segment of itself
    (its trailing n-gram occurs earlier by construction)."""
    cfg, params = model[0], model[1]
    rng = np.random.default_rng(1)
    base = [rng.integers(0, VOCAB, (8,)).astype(np.int32) for _ in range(n)]
    longs = [np.asarray(JG.generate(params, jnp.asarray(b[None]), cfg,
                                    max_new_tokens=pre + 16))[0]
             for b in base]
    seg = rng.integers(0, VOCAB, (12,)).astype(np.int32)
    return ([np.concatenate([b, l[:pre]]) for b, l in zip(base, longs)]
            + [np.concatenate([seg, seg, seg[:6]])])


# ---------------------------------------------------------------------------
# paged_spec_step
# ---------------------------------------------------------------------------

def _spec_inputs(cfg, kv_quant, M=4, Q=5, bs=4, W=6, seed=0):
    rng = np.random.default_rng(seed)
    N = M * W + 3
    L, Hk, D = cfg.num_hidden_layers, cfg.kv_heads, cfg.head_dim
    shape = (L, N, bs, Hk, D)
    if kv_quant == "int8":
        pool = {"k": rng.integers(-127, 128, shape).astype(np.int8),
                "v": rng.integers(-127, 128, shape).astype(np.int8),
                "k_scale": rng.uniform(0.005, 0.02, shape[:-1])
                .astype(np.float32),
                "v_scale": rng.uniform(0.005, 0.02, shape[:-1])
                .astype(np.float32)}
    else:
        pool = {"k": rng.normal(size=shape).astype(np.float32),
                "v": rng.normal(size=shape).astype(np.float32)}
    tables = (1 + rng.permutation(M * W)).reshape(M, W).astype(np.int32)
    seq_lens = np.array([3, 9, 0, 14], np.int32)[:M]
    draft_lens = np.array([Q - 1, 0, 2, 1], np.int32)[:M]
    tokens = rng.integers(0, VOCAB, (M, Q)).astype(np.int32)
    active = np.array([True, True, True, False])[:M]
    return tokens, seq_lens, draft_lens, tables, pool, active


@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_paged_spec_step_matches_jax(model, kv_quant):
    cfg, params, tcfg, tparams, _ = model
    toks, sl, dl, tbl, pool, act = _spec_inputs(cfg, kv_quant)
    want_lg, want_pool, _ = JG.paged_spec_step(
        params, cfg, jnp.asarray(toks), jnp.asarray(sl), jnp.asarray(dl),
        jnp.asarray(tbl), {k: jnp.asarray(v) for k, v in pool.items()},
        jnp.asarray(act), use_kernel=False)
    T = torch.from_numpy
    tpool = {k: T(v.copy()) for k, v in pool.items()}
    lg, tpool, _ = TG.paged_spec_step(tparams, tcfg, T(toks), T(sl), T(dl),
                                      T(tbl), tpool, T(act),
                                      use_kernel=False)
    assert lg.shape == (4, 5, VOCAB) and lg.dtype == torch.float32
    np.testing.assert_allclose(lg.numpy()[act], np.asarray(want_lg)[act],
                               rtol=0, atol=1e-4)
    for name, w in want_pool.items():
        g, w = tpool[name].numpy()[:, 1:], np.asarray(w)[:, 1:]
        if name.endswith("_scale"):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=0)
        elif g.dtype == np.int8:
            diff = np.abs(g.astype(np.int32) - w.astype(np.int32))
            assert diff.max() <= 1 and (diff > 0).mean() < 1e-3, name
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# sampled serving against the JAX engine
# ---------------------------------------------------------------------------

_BASE = dict(block_size=4, max_slots=3, max_model_len=64, decode_chunk=4,
             queue_depth=16)
SAMPLED_CASES = {
    "fresh": (dict(prefill_chunk=None, prefix_cache=None),
              lambda d: d["prefill_dispatches"] > 0),
    "preemption": (dict(num_blocks=12, prefill_chunk=8),
                   lambda d: d["preemptions"] >= 1),
    "two_phase": (dict(mixed_batch=False, prefill_chunk=8,
                       prefix_cache=None),
                  lambda d: d["mixed_dispatches"] == 0
                  and d["prefill_dispatches"] > 6),
    "mixed": (dict(prefill_chunk=8), lambda d: d["mixed_dispatches"] > 0),
}


@pytest.mark.parametrize("case", list(SAMPLED_CASES))
def test_sampled_streams_match_jax(model, case):
    """Every request samples except request 1, which stays greedy inside
    sampled dispatches."""
    _, _, tcfg, tparams, _ = model
    over, shows = SAMPLED_CASES[case]
    sc = {**_BASE, **over}
    prompts, news = _trace()
    knobs = [SAMPLED] * len(prompts)
    knobs[1] = dict(temperature=0.0)
    want, jd, _ = _drain(_jax_engine(model, sc), prompts, news, knobs)
    got, td, st = _drain(TEngine(tparams, tcfg, TConfig(**sc), device="cpu"),
                         prompts, news, knobs)
    assert got == want
    assert td == jd
    assert shows(td), td
    assert st["blocks_in_use"] == 0
    greedy, _, _ = _drain(TEngine(tparams, tcfg, TConfig(**sc),
                                  device="cpu"), prompts, news,
                          [{}] * len(prompts))
    assert greedy[1] == got[1]
    assert sum(g != s for g, s in zip(greedy, got)) >= 4


# ---------------------------------------------------------------------------
# speculative decoding
# ---------------------------------------------------------------------------

_SPEC = dict(block_size=4, max_slots=3, max_model_len=96, decode_chunk=4,
             queue_depth=16, spec_ngram=2)
# the drafter looks once a step: steps of at most 2 decode iterations (a
# streaming client's cadence) give it the chances a whole-tail decode
# burst would not
STREAM = 2


@pytest.mark.parametrize("kv_quant", [None, "int8"])
@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
def test_spec_streams_match_non_spec_and_jax(model, sampled, kv_quant):
    _, _, tcfg, tparams, _ = model
    prompts = _spec_prompts(model)
    news = [12] * len(prompts)
    knobs = [SAMPLED if sampled else {}] * len(prompts)
    sc = dict(_SPEC, kv_quant=kv_quant)
    want, jd, _ = _drain(_jax_engine(model, dict(sc, spec_decode=4)),
                         prompts, news, knobs, max_iters=STREAM)
    off, _, _ = _drain(TEngine(tparams, tcfg, TConfig(spec_decode=0, **sc),
                               device="cpu"), prompts, news, knobs,
                       max_iters=STREAM)
    for knob in ("off", "on"):        # "on": the kernel wrapper's plain path
        eng = TEngine(tparams, tcfg,
                      TConfig(spec_decode=4, paged_kernel=knob, **sc),
                      device="cpu")
        got, td, st = _drain(eng, prompts, news, knobs, max_iters=STREAM,
                             check_rollback=True)
        assert got == off
        assert got == want
        assert td == jd
        assert td["spec_dispatches"] > 0 and st["spec_decode"] == 4
        assert st["blocks_in_use"] == 0
        if not sampled:
            assert td["spec_accepted"] > 0


def test_sampled_verify_accepts_every_true_draft(model):
    """A drafter that proposes the non-speculative stream's own
    continuation: every sampled draft is accepted and the streams agree —
    which holds only when verify position q draws with the key of sample
    index ``len(req.tokens) + q``. (Sampling breaks the cycles the n-gram
    drafter feeds on, so a sampled run of the real drafter accepts too
    rarely to show this.)"""
    _, _, tcfg, tparams, _ = model
    prompts = _spec_prompts(model)
    news = [12] * len(prompts)
    knobs = [SAMPLED] * len(prompts)
    off, _, _ = _drain(TEngine(tparams, tcfg, TConfig(spec_decode=0, **_SPEC),
                               device="cpu"), prompts, news, knobs)
    eng = TEngine(tparams, tcfg, TConfig(spec_decode=4, **_SPEC),
                  device="cpu")

    def oracle(req):
        k = min(4, int(eng._steps_left[req.slot]) - 1)
        t = len(req.tokens)
        return off[req.rid][t:t + k] if k > 0 else []

    eng._draft_tokens = oracle
    got, td, st = _drain(eng, prompts, news, knobs, max_iters=STREAM,
                         check_rollback=True)
    assert got == off
    assert td["spec_accepted"] == td["spec_drafted"] > 0
    assert st["blocks_in_use"] == 0


def test_spec_eos_truncates_like_non_spec(model):
    """EOS inside an accepted run: the token is picked from a verify that
    emitted at least three tokens of one stream (two accepted drafts and
    the next token), at its first occurrence in that stream."""
    _, _, tcfg, tparams, _ = model
    prompts = _spec_prompts(model)
    news = [12] * len(prompts)
    knobs = [{}] * len(prompts)
    eng = TEngine(tparams, tcfg, TConfig(spec_decode=4, **_SPEC),
                  device="cpu")
    rids = [eng.submit(p, max_new_tokens=n, eos_token_id=None)
            for p, n in zip(prompts, news)]
    streams = {r: [] for r in rids}
    eos = None
    while eng.pending:
        s0 = eng.stats()["spec_dispatches"]
        out = eng.step(STREAM)
        verified = eng.stats()["spec_dispatches"] > s0
        for rid, toks in out.items():
            if eos is None and verified and len(toks) >= 3 and \
                    toks[1] not in streams[rid] + toks[:1]:
                eos, which = toks[1], rids.index(rid)
                cut = len(streams[rid]) + 2
            streams[rid] += toks
    assert eos is not None, "no verify accepted two drafts"
    run = dict(eos=eos, max_iters=STREAM)
    off, _, _ = _drain(TEngine(tparams, tcfg, TConfig(spec_decode=0, **_SPEC),
                               device="cpu"), prompts, news, knobs, **run)
    eng = TEngine(tparams, tcfg, TConfig(spec_decode=4, **_SPEC),
                  device="cpu")
    got, td, st = _drain(eng, prompts, news, knobs, **run)
    want, _, _ = _drain(_jax_engine(model, dict(_SPEC, spec_decode=4)),
                        prompts, news, knobs, **run)
    assert got == off == want
    assert len(got[which]) == cut and got[which][-1] == eos
    assert td["spec_dispatches"] > 0 and st["blocks_in_use"] == 0


def test_incoherent_prompts_fall_through_to_decode(model):
    """Prompts of distinct tokens and short outputs: no n-gram repeats, so
    no verify is dispatched and the decode loop serves the trace."""
    _, _, tcfg, tparams, _ = model
    rng = np.random.default_rng(3)
    prompts = [rng.permutation(VOCAB)[:20].astype(np.int32)
               for _ in range(3)]
    news = [3, 3, 3]
    knobs = [{}] * 3
    sc = dict(_SPEC, spec_ngram=3)
    off, _, _ = _drain(TEngine(tparams, tcfg, TConfig(spec_decode=0, **sc),
                               device="cpu"), prompts, news, knobs,
                       max_iters=1)
    got, td, _ = _drain(TEngine(tparams, tcfg, TConfig(spec_decode=4, **sc),
                                device="cpu"), prompts, news, knobs,
                        max_iters=1)
    assert got == off
    assert td["spec_dispatches"] == 0 and td["spec_drafted"] == 0
    assert td["decode_dispatches"] > 0


def test_spec_decode_precedence(model):
    """A step whose decode rows draft dispatches VERIFY, never verify and
    mixed in one step; drafts fire; with a long prompt mid-prefill, steps
    with drafts verify and steps without carry the chunk in a mixed
    dispatch. The prompt repeats the segment ``[a, t]`` for every token
    ``t`` and ends in ``a``: whatever token ``t0`` the model emits first,
    the bigram ``(a, t0)`` occurs earlier, so the first decode step drafts
    by construction."""
    _, _, tcfg, tparams, _ = model
    eng = TEngine(tparams, tcfg, TConfig(
        block_size=4, max_slots=3, max_model_len=256, decode_chunk=2,
        queue_depth=16, prefill_chunk=16, spec_decode=3, spec_ngram=2),
        device="cpu")
    a = 5
    rep = np.append(np.stack([np.full(VOCAB, a), np.arange(VOCAB)], 1)
                    .reshape(-1), a).astype(np.int32)

    def drain():
        seen = {"spec": False, "mixed": False}
        while eng.pending:
            s0 = eng.stats()
            eng.step()
            s1 = eng.stats()
            d_spec = s1["spec_dispatches"] - s0["spec_dispatches"]
            d_mixed = s1["mixed_dispatches"] - s0["mixed_dispatches"]
            assert d_spec + d_mixed <= 1
            seen["spec"] |= d_spec > 0
            seen["mixed"] |= d_mixed > 0
        return seen

    eng.submit(rep, max_new_tokens=8, eos_token_id=None)
    drain()
    assert eng.stats()["spec_dispatches"] > 0
    eng.submit(rep, max_new_tokens=8, eos_token_id=None)
    eng.submit(np.random.default_rng(5).integers(0, VOCAB, (40,)),
               max_new_tokens=4, eos_token_id=None)
    assert drain() == {"spec": True, "mixed": True}
    assert eng.stats()["blocks_in_use"] == 0


# ---------------------------------------------------------------------------
# probes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("knobs", [dict(temperature=-1), dict(top_k=0),
                                   dict(top_p=0.0), dict(top_p=1.5)])
def test_submit_rejects_unsupported_sampling(model, knobs):
    _, _, tcfg, tparams, _ = model
    eng = TEngine(tparams, tcfg, TConfig(**_BASE), device="cpu")
    with pytest.raises(ValueError, match="supported knobs"):
        eng.submit([1, 2, 3], max_new_tokens=2, **knobs)
    assert not eng.pending


@pytest.mark.parametrize("knobs", [dict(spec_decode=-1), dict(spec_ngram=0)])
def test_config_rejects_bad_spec_knobs(knobs):
    with pytest.raises(ValueError, match="spec_"):
        TConfig(**knobs)

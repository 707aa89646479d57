"""Multi-adapter LoRA serving in the port (``paddle_tpu_torch.models.lora``
and the paged engine) against the JAX package's, plus the port-side
mirrors of ``tests/test_lora.py``.

* The factors (``lora_param_shapes``, ``lora_init_params``),
  ``lora_delta`` and ``merge_lora`` equal JAX's.
* Every paged entry point, given a ``lora`` operand that mixes the base
  slot 0 with loaded slots, matches JAX's logits, pool and MoE drops on
  the same weights, adapters and inputs.
* The port's engine and the JAX engine, on one trace over five adapters
  on two slots, give equal token streams, ``stats()["lora"]`` and
  dispatch counters: greedy and sampled, fp32 and int8 KV, gather and
  the kernel wrapper's plain version, with speculation, two-phase, MoE.
* The mirrors: base traffic through a LoRA engine equals the LoRA-less
  engine bit for bit; an adapter's greedy stream equals the LoRA-less
  engine on ``merge_lora(params, adapter)``; the prefix cache is
  namespaced by adapter; churn evicts and reloads bit-exactly without
  moving the pool's storage; pins hold running adapters; validation
  errors carry JAX's messages.

Tolerances at fp32: logits 1e-4, pools 1e-5, factors equal, deltas and
merged weights 1e-6 x max|ref| (the deltas reach ~15 here, where an fp32
ulp is ~1e-6); token streams and counters equal.
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
from paddle_tpu.models import lora as JLoRA
from paddle_tpu_torch.inference.serving import paged_cache as TPC
from paddle_tpu_torch.inference.serving.engine import ServingConfig as TConfig
from paddle_tpu_torch.inference.serving.engine import ServingEngine as TEngine
from paddle_tpu_torch.models import generation as TG
from paddle_tpu_torch.models import lora as TLoRA
from paddle_tpu_torch.models.convert import config_from_jax, params_from_jax

torch.set_num_threads(2)

CFG = JL.LlamaConfig(vocab_size=128, hidden_size=64, intermediate_size=96,
                     num_hidden_layers=2, num_attention_heads=8,
                     num_key_value_heads=4, max_position_embeddings=128)
MOE_CFG = JL.LlamaConfig(vocab_size=128, hidden_size=64,
                         intermediate_size=96, num_hidden_layers=2,
                         num_attention_heads=8, num_key_value_heads=4,
                         max_position_embeddings=128, moe_num_experts=4,
                         moe_top_k=2)
RANK = 4
BASE = dict(block_size=8, max_slots=4, max_model_len=96, queue_depth=16,
            decode_chunk=4)
LORA = dict(lora_rank=RANK, lora_slots=2, lora_pool=8)


def _port(params):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                           device="cpu")


@pytest.fixture(scope="module")
def model():
    jp = JL.init_params(CFG, jax.random.PRNGKey(0))
    return jp, _port(jp), config_from_jax(CFG)


@pytest.fixture(scope="module")
def adapters():
    """Five adapters over a two-slot pool; scale 0.5 so adapter streams
    part from base on this tiny model."""
    return {f"a{i}": TLoRA.lora_init_params(CFG, RANK, seed=i, scale=0.5)
            for i in range(1, 6)}


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.default_rng(7)
    return [rng.integers(0, CFG.vocab_size, (int(s),)).astype(np.int32)
            for s in (5, 8, 6, 7)]


def mk(tparams, tcfg, lora=True, adapters=None, **kw):
    """A port engine on the CPU at the module's shape (+ the pool)."""
    sc = {**BASE, **(LORA if lora else {}), **kw}
    eng = TEngine(tparams, tcfg, TConfig(**sc), device="cpu")
    for name, ap in (adapters or {}).items():
        eng.register_adapter(name, ap)
    return eng


def run_wave(eng, prompts, adapter_ids=None, n=10, **kw):
    """Submit one wave (optionally per-request adapter ids) and drain."""
    ids = adapter_ids or [None] * len(prompts)
    rids = [eng.submit(p, max_new_tokens=n, eos_token_id=None,
                       adapter_id=a, **kw)
            for p, a in zip(prompts, ids)]
    while eng.pending:
        eng.step()
    return [np.asarray(eng.request(r).output()) for r in rids]


def _parity(a, b):
    return len(a) == len(b) and all(
        np.array_equal(np.asarray(x), np.asarray(y)) for x, y in zip(a, b))


@pytest.fixture(scope="module")
def lora1(model, adapters):
    """The workhorse: a LoRA engine (fp pool, gather path) with every
    adapter registered."""
    _, tp, tcfg = model
    return mk(tp, tcfg, adapters=adapters)


@pytest.fixture(scope="module")
def base1(model):
    _, tp, tcfg = model
    return mk(tp, tcfg, lora=False)


@pytest.fixture(scope="module")
def oracle(base1, prompts):
    return [np.asarray(o) for o in
            base1.run(prompts, max_new_tokens=10, eos_token_id=None)]


# ---------------------------------------------------------------------------
# the factors, the delta and the merge against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rank,seed", [(4, 0), (8, 3)])
def test_factors_match_jax(rank, seed):
    want = JLoRA.lora_init_params(CFG, rank, seed=seed, scale=0.3)
    got = TLoRA.lora_init_params(CFG, rank, seed=seed, scale=0.3)
    assert TLoRA.lora_param_shapes(CFG, rank) == \
        JLoRA.lora_param_shapes(CFG, rank)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], want[k])
    assert TLoRA._TARGETS == JLoRA._TARGETS


def test_lora_delta_and_gather_match_jax(adapters):
    """JAX's per-layer ``lora_delta`` against the port's, and against the
    port's once-per-dispatch gather + ``gathered_delta`` layer by layer."""
    pool = TLoRA.AdapterPool(CFG, RANK, 2, 4, device="cpu")
    for name in ("a1", "a2"):
        pool.register(name, adapters[name])
        pool.acquire(name)
    ids = np.array([1, 0, 2, 1], np.int32)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, 3, CFG.hidden_size)).astype(np.float32)
    tids = torch.from_numpy(ids)
    g = TLoRA.gather_adapters(pool.layers, tids, torch.float32)
    for l in range(CFG.num_hidden_layers):
        la = pool.layers["qA"][l].numpy()
        lb = pool.layers["qB"][l].numpy()
        want = np.asarray(JLoRA.lora_delta(jnp.asarray(x), jnp.asarray(la),
                                           jnp.asarray(lb), jnp.asarray(ids),
                                           jnp.float32))
        got = TLoRA.lora_delta(torch.from_numpy(x), pool.layers["qA"][l],
                               pool.layers["qB"][l], tids, torch.float32)
        np.testing.assert_allclose(got.numpy(), want,
                                   atol=1e-6 * np.abs(want).max(), rtol=0)
        both = TLoRA.gathered_delta(torch.from_numpy(x), g["qA"][l],
                                    g["qB"][l])
        np.testing.assert_array_equal(both.numpy(), got.numpy())
        # the base rows' delta is an exact zero
        assert (got.numpy()[1] == 0).all()


def test_merge_lora_matches_jax(model, adapters):
    jp, tp, _ = model
    want = JLoRA.merge_lora(jp, adapters["a2"])
    got = TLoRA.merge_lora(tp, adapters["a2"])
    for name in ("wq", "wk", "wv", "wo", "w_up"):
        ref = np.asarray(want["layers"][name])
        np.testing.assert_allclose(got["layers"][name].numpy(), ref,
                                   atol=1e-6 * np.abs(ref).max(), rtol=0)
    # a copy: the input params are untouched
    np.testing.assert_array_equal(tp["layers"]["wq"].numpy(),
                                  np.asarray(jp["layers"]["wq"]))


# ---------------------------------------------------------------------------
# every paged entry point with a mixed lora operand
# ---------------------------------------------------------------------------

NB, BS, W = 24, 4, 6
TABLES = np.array([[1, 2, 3, 4, 0, 0], [5, 6, 7, 8, 0, 0],
                   [9, 10, 11, 12, 13, 0], [0] * W], np.int32)
ENTRIES = ("prefill", "chunk", "decode_gather", "decode_kernel", "mixed",
           "spec")
LORA_IDS = np.array([1, 0, 2, 1], np.int32)   # pad row 3 keeps a slot too


def _entry_inputs(name):
    """(function name, args after (params, cfg), kwargs) as numpy."""
    rng = np.random.default_rng(5)
    tok = lambda *s: rng.integers(0, 128, s).astype(np.int32)  # noqa: E731
    act = np.array([True, True, True, False])
    if name == "prefill":
        return ("paged_prefill", [tok(4, 8), np.array([7, 5, 8, 1], np.int32),
                                  TABLES, None, act], {}, LORA_IDS)
    if name == "chunk":
        return ("paged_prefill_chunk", [tok(1, 8), 4, 6, TABLES[2:3], None],
                {}, np.array([2], np.int32))
    seq = np.array([9, 5, 12, 0], np.int32)
    if name.startswith("decode"):
        return ("paged_decode_step", [tok(4), seq, TABLES, None, act],
                {"use_kernel": name == "decode_kernel"}, LORA_IDS)
    if name == "mixed":
        return ("paged_mixed_step", [tok(4, 4), seq,
                                     np.array([1, 3, 2, 1], np.int32),
                                     TABLES, None, act],
                {"use_kernel": True}, LORA_IDS)
    return ("paged_spec_step", [tok(4, 3), seq,
                                np.array([2, 0, 1, 0], np.int32), TABLES,
                                None, act], {"use_kernel": True}, LORA_IDS)


def _start_pool(cfg):
    """A fp32 pool whose blocks (the null block too) hold random K/V."""
    rng = np.random.default_rng(3)
    shape = (cfg.num_hidden_layers, NB, BS, cfg.num_key_value_heads,
             cfg.hidden_size // cfg.num_attention_heads)
    return {k: rng.standard_normal(shape).astype(np.float32)
            for k in ("k", "v")}


@pytest.fixture(scope="module")
def entry_models():
    """Per config: JAX params + its adapter pool with a1 in slot 1 and a2
    in slot 2 (at ``lora_init_params``' default scale, 0.05, which keeps
    the activations at the base model's size, where the 1e-5 pool
    tolerance was set), and the port's counterparts."""
    adapters = {f"a{i}": TLoRA.lora_init_params(CFG, RANK, seed=i)
                for i in (1, 2)}
    out = {}
    for tag, cfg in (("dense", CFG), ("moe", MOE_CFG)):
        jp = JL.init_params(cfg, jax.random.PRNGKey(4))
        jpool = JLoRA.AdapterPool(cfg, RANK, 2, 4)
        tpool = TLoRA.AdapterPool(config_from_jax(cfg), RANK, 2, 4,
                                  device="cpu")
        for pool in (jpool, tpool):
            for name in ("a1", "a2"):
                pool.register(name, adapters[name])
                assert pool.acquire(name) == int(name[1])
        out[tag] = (cfg, jp, jpool, config_from_jax(cfg), _port(jp), tpool)
    return out


@pytest.mark.parametrize("tag", ["dense", "moe"])
@pytest.mark.parametrize("entry", ENTRIES)
def test_entry_point_with_lora_matches_jax(entry_models, entry, tag):
    cfg, jp, jpool, tcfg, tp, tpool = entry_models[tag]
    fn, args, kw, ids = _entry_inputs(entry)
    start = _start_pool(cfg)
    pi = next(i for i, a in enumerate(args) if a is None)
    jargs = [jnp.asarray(a) if isinstance(a, np.ndarray) else
             jnp.asarray(a, jnp.int32) for a in args[:pi]] + \
        [{k: jnp.asarray(v) for k, v in start.items()}] + \
        [jnp.asarray(a) for a in args[pi + 1:]]
    jkw = dict(kw, use_kernel=False) if "use_kernel" in kw else dict(kw)
    jl, jpl, jd = getattr(JG, fn)(jp, cfg, *jargs, **jkw, lora={
        "ids": jnp.asarray(ids), "layers": jpool.layers})
    targs = [torch.from_numpy(a) if isinstance(a, np.ndarray) else a
             for a in args[:pi]] + \
        [{k: torch.from_numpy(v.copy()) for k, v in start.items()}] + \
        [torch.from_numpy(a) for a in args[pi + 1:]]
    tl, tpl, td = getattr(TG, fn)(tp, tcfg, *targs, **kw, lora={
        "ids": torch.from_numpy(ids), "layers": tpool.layers})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=0)
    for k in ("k", "v"):
        # block 0 takes every masked lane's write: compare the rest
        np.testing.assert_allclose(tpl[k][:, 1:].numpy(),
                                   np.asarray(jpl[k])[:, 1:], atol=1e-5,
                                   rtol=0)
    assert float(td) == float(jd)
    if tag == "moe" and entry == "prefill":
        assert float(jd) > 0                 # the capacity did drop pairs
    # the adapters moved the result: the same call without them differs
    targs[pi] = {k: torch.from_numpy(v.copy()) for k, v in start.items()}
    base = getattr(TG, fn)(tp, tcfg, *targs, **kw)[0]
    assert not torch.allclose(base, tl, atol=1e-3)


@pytest.fixture(scope="module")
def entry_models_half(entry_models):
    """The same models with a1 / a2 at scale 0.5 — this file's engine
    fixture's scale and the JAX tests' — where the adapters lift K/V to
    about four times the base model's size."""
    adapters = {f"a{i}": TLoRA.lora_init_params(CFG, RANK, seed=i,
                                                scale=0.5)
                for i in (1, 2)}
    out = {}
    for tag, (cfg, jp, _, tcfg, tp, _) in entry_models.items():
        jpool = JLoRA.AdapterPool(cfg, RANK, 2, 4)
        tpool = TLoRA.AdapterPool(tcfg, RANK, 2, 4, device="cpu")
        for pool in (jpool, tpool):
            for name in ("a1", "a2"):
                pool.register(name, adapters[name])
                assert pool.acquire(name) == int(name[1])
        out[tag] = (cfg, jp, jpool, tcfg, tp, tpool)
    return out


@pytest.mark.parametrize("tag", ["dense", "moe"])
@pytest.mark.parametrize("entry", ENTRIES)
def test_entry_point_with_lora_scale_half_matches_jax(entry_models_half,
                                                      entry, tag):
    """At scale 0.5 the K/V the adapters write grow to max|K/V| ~ 14, and
    the absolute gap to JAX grows with them (up to 1.8e-5); relative to
    max|ref| it stays at fp32 rounding (<= 1.3e-6 measured on this grid;
    the same ratio as at scale 0.05, 1 and 2). So the tolerance here is
    relative, as for ``lora_delta`` and ``merge_lora``."""
    cfg, jp, jpool, tcfg, tp, tpool = entry_models_half[tag]
    fn, args, kw, ids = _entry_inputs(entry)
    start = _start_pool(cfg)
    pi = next(i for i, a in enumerate(args) if a is None)
    jargs = [jnp.asarray(a) if isinstance(a, np.ndarray) else
             jnp.asarray(a, jnp.int32) for a in args[:pi]] + \
        [{k: jnp.asarray(v) for k, v in start.items()}] + \
        [jnp.asarray(a) for a in args[pi + 1:]]
    jkw = dict(kw, use_kernel=False) if "use_kernel" in kw else dict(kw)
    jl, jpl, jd = getattr(JG, fn)(jp, cfg, *jargs, **jkw, lora={
        "ids": jnp.asarray(ids), "layers": jpool.layers})
    targs = [torch.from_numpy(a) if isinstance(a, np.ndarray) else a
             for a in args[:pi]] + \
        [{k: torch.from_numpy(v.copy()) for k, v in start.items()}] + \
        [torch.from_numpy(a) for a in args[pi + 1:]]
    tl, tpl, td = getattr(TG, fn)(tp, tcfg, *targs, **kw, lora={
        "ids": torch.from_numpy(ids), "layers": tpool.layers})
    ref = np.asarray(jl)
    np.testing.assert_allclose(tl.numpy(), ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())
    for k in ("k", "v"):
        ref = np.asarray(jpl[k])[:, 1:]
        np.testing.assert_allclose(tpl[k][:, 1:].numpy(), ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max())
    assert float(td) == float(jd)
    # the adapters lifted K/V past the base model's size (~3)
    assert float(tpl["k"][:, 1:].abs().max()) > 8


def test_base_slots_leave_entry_points_unchanged(entry_models):
    """An all-zero ``ids`` operand gives the lora=None computation bit for
    bit (every delta is an exact +0.0)."""
    _, _, _, tcfg, tp, tpool = entry_models["dense"]
    fn, args, kw, ids = _entry_inputs("mixed")
    pi = next(i for i, a in enumerate(args) if a is None)
    outs = []
    for lora in (None, {"ids": torch.zeros(4, dtype=torch.int32),
                        "layers": tpool.layers}):
        targs = [torch.from_numpy(a) for a in args[:pi]] + \
            [{k: torch.from_numpy(v) for k, v in
              _start_pool(CFG).items()}] + \
            [torch.from_numpy(a) for a in args[pi + 1:]]
        outs.append(getattr(TG, fn)(tp, tcfg, *targs, **kw, lora=lora))
    assert torch.equal(outs[0][0], outs[1][0])
    for k in ("k", "v"):
        assert torch.equal(outs[0][1][k], outs[1][1][k])


# ---------------------------------------------------------------------------
# the engine against the JAX engine
# ---------------------------------------------------------------------------

ENGINE_CASES = {
    "fp32": dict(),
    "kv_int8": dict(kv_quant="int8"),
    "two_phase": dict(mixed_batch=False),
    "spec": dict(spec_decode=3, spec_ngram=2),
    "moe": dict(),
}
_COUNTERS = ("prefill_dispatches", "decode_dispatches", "mixed_dispatches",
             "spec_dispatches", "chunks", "steps", "prefix_hit_tokens",
             "preemptions", "spec_drafted", "spec_accepted")
SAMPLED = dict(temperature=0.9, top_k=17, top_p=0.9, seed=42)


def _engine_trace():
    """Eight requests over five adapters and base: two pairs share a
    16-token prefix under different adapters (the namespaces), one 30-
    token prompt chunks (prefill_chunk 8), two prompts quote themselves
    (drafts under speculation)."""
    rng = np.random.default_rng(11)
    prefix = rng.integers(0, 128, 16)
    seg = rng.integers(0, 128, 6)
    prompts = [np.concatenate([prefix, rng.integers(0, 128, 4)]),
               rng.integers(0, 128, 5),
               np.concatenate([prefix, rng.integers(0, 128, 3)]),
               rng.integers(0, 128, 30),
               np.tile(seg, 3),
               np.concatenate([prefix, rng.integers(0, 128, 2)]),
               np.tile(seg[::-1], 3),
               rng.integers(0, 128, 9)]
    ids = [None, "a1", "a2", "a3", "a1", "a4", None, "a5"]
    news = [10, 6, 8, 12, 9, 7, 11, 5]
    return [p.astype(np.int32) for p in prompts], ids, news


def _drive(eng, prompts, ids, news, knobs):
    before = {k: eng.stats()[k] for k in _COUNTERS}
    rids = [eng.submit(p, max_new_tokens=n, eos_token_id=None,
                       adapter_id=a, **knobs)
            for p, a, n in zip(prompts, ids, news)]
    while eng.pending:
        eng.step(2)                 # a streaming client: drafts can fire
    st = eng.stats()
    outs = [np.asarray(eng.request(r).output()) for r in rids]
    return outs, {k: st[k] - before[k] for k in _COUNTERS}, st


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_engine_matches_jax(model, adapters, case):
    if case == "moe":
        cfg = MOE_CFG
        jp = JL.init_params(cfg, jax.random.PRNGKey(2))
        tp, tcfg = _port(jp), config_from_jax(cfg)
    else:
        cfg = CFG
        jp, tp, tcfg = model
    kw = {**BASE, **LORA, "prefill_chunk": 8, **ENGINE_CASES[case]}
    prompts, ids, news = _engine_trace()
    if case == "spec":
        # longer outputs: the tiny model's streams fall into the cycles
        # the n-gram drafter hits
        news = [2 * n for n in news]
    jeng = JEngine(jp, cfg, JConfig(**kw))
    for name, ap in adapters.items():
        jeng.register_adapter(name, ap)
    teng = {knob: TEngine(tp, tcfg, TConfig(paged_kernel=knob, **kw),
                          device="cpu") for knob in ("off", "on")}
    for eng in teng.values():
        for name, ap in adapters.items():
            eng.register_adapter(name, ap)
    seen = {}
    for knobs in ({}, SAMPLED):
        want, jd, jst = _drive(jeng, prompts, ids, news, knobs)
        seen = {k: seen.get(k, 0) + v for k, v in jd.items()}
        for knob, eng in teng.items():
            got, td, tst = _drive(eng, prompts, ids, news, knobs)
            for i, (g, w) in enumerate(zip(got, want)):
                np.testing.assert_array_equal(
                    g, w, err_msg=f"{knob} {knobs} request {i}")
            assert td == jd, (knob, knobs)
            assert tst["lora"] == jst["lora"], (knob, knobs)
            assert tst["blocks_in_use"] == 0
    assert jst["lora"]["adapter_evictions"] > 0
    assert jst["lora"]["adapter_pins"] == 0
    if case == "spec":
        assert seen["spec_dispatches"] > 0
    if case == "two_phase":
        assert seen["mixed_dispatches"] == 0
    else:
        assert seen["mixed_dispatches"] > 0


# ---------------------------------------------------------------------------
# mirrors of tests/test_lora.py
# ---------------------------------------------------------------------------

class TestZeroAdapterParity:
    def test_base_traffic_fp_gather(self, lora1, oracle, prompts):
        """Base traffic through the pool is bit-identical to the LoRA-less
        engine, and the pool's storage never moved."""
        ptrs = {k: v.data_ptr() for k, v in lora1._lora.layers.items()}
        outs = run_wave(lora1, prompts)
        assert _parity(outs, oracle)
        assert {k: v.data_ptr() for k, v in
                lora1._lora.layers.items()} == ptrs

    @pytest.mark.parametrize("kv", [None, "int8"], ids=["fp32", "int8"])
    @pytest.mark.parametrize("kernel", ["off", "on"],
                             ids=["gather", "kernel"])
    def test_matrix_tp1(self, model, adapters, prompts, kv, kernel):
        """Every pool-dtype x attention-path combination: greedy and
        seeded-sampled streams through the zero adapter match the
        LoRA-less engine bitwise."""
        _, tp, tcfg = model
        base = mk(tp, tcfg, lora=False, kv_quant=kv, paged_kernel=kernel)
        lora = mk(tp, tcfg, kv_quant=kv, paged_kernel=kernel,
                  adapters=adapters)
        assert _parity(run_wave(lora, prompts), run_wave(base, prompts))
        kw = dict(temperature=0.9, top_k=17, top_p=0.9, seed=42)
        assert _parity(run_wave(lora, prompts, **kw),
                       run_wave(base, prompts, **kw))

    def test_int8_weights(self, model, adapters, prompts):
        """quantize='int8': the delta adds outside the int8 matmul, and
        base traffic still equals the LoRA-less int8 engine."""
        _, tp, tcfg = model
        base = mk(tp, tcfg, lora=False, quantize="int8")
        lora = mk(tp, tcfg, quantize="int8", adapters=adapters)
        assert _parity(run_wave(lora, prompts), run_wave(base, prompts))
        got = run_wave(lora, prompts, adapter_ids=["a1"] * len(prompts))
        assert not _parity(got, run_wave(base, prompts))


class TestMergedDenseOracle:
    def test_single_adapter_matches_merged_dense(self, model, adapters,
                                                 lora1, prompts):
        """submit(adapter_id='a1') greedy streams equal a plain engine on
        W + A@B dense weights, token for token."""
        _, tp, tcfg = model
        merged = mk(TLoRA.merge_lora(tp, adapters["a1"]), tcfg, lora=False)
        want = run_wave(merged, prompts)
        got = run_wave(lora1, prompts, adapter_ids=["a1"] * len(prompts))
        assert _parity(got, want)

    def test_adapters_actually_diverge(self, lora1, oracle, prompts):
        got = run_wave(lora1, prompts, adapter_ids=["a1"] * len(prompts))
        assert any(not np.array_equal(g, o) for g, o in zip(got, oracle))

    def test_mixed_wave_each_matches_own_oracle(self, model, adapters,
                                                lora1, prompts):
        """One batched wave mixing base + two adapters: every request
        matches its own oracle (base or merged) bitwise."""
        _, tp, tcfg = model
        oracles = {None: mk(tp, tcfg, lora=False),
                   "a1": mk(TLoRA.merge_lora(tp, adapters["a1"]), tcfg,
                            lora=False),
                   "a2": mk(TLoRA.merge_lora(tp, adapters["a2"]), tcfg,
                            lora=False)}
        ids = [None, "a1", "a2", "a1"]
        got = run_wave(lora1, prompts, adapter_ids=ids)
        for g, p, a in zip(got, prompts, ids):
            np.testing.assert_array_equal(g, run_wave(oracles[a], [p])[0],
                                          err_msg=str(a))

    def test_chain_key_namespace_unit(self):
        """Adapter namespaces hash into disjoint key spaces over identical
        tokens; None is the un-namespaced chain; resumption from a prior
        key is namespace-oblivious."""
        ids = list(range(16))
        base = list(TPC.prefix_block_chain(ids, 8, 16))
        a = list(TPC.prefix_block_chain(ids, 8, 16, namespace="a1"))
        b = list(TPC.prefix_block_chain(ids, 8, 16, namespace="a2"))
        assert base == list(TPC.prefix_block_chain(ids, 8, 16,
                                                   namespace=None))
        assert [t for _, t in base] == [t for _, t in a]
        assert {k for k, _ in base}.isdisjoint(k for k, _ in a)
        assert {k for k, _ in a}.isdisjoint(k for k, _ in b)
        tail = list(TPC.prefix_block_chain(ids[8:], 8, 16, start=1,
                                           prev_key=a[0][0], base=8,
                                           namespace="a1"))
        assert tail == a[1:]

    def test_prefix_cache_is_adapter_namespaced(self, model, adapters):
        """A base wave's cached blocks never prefix-hit a same-prompt
        adapter request; the adapter's own resubmission hits its own chain
        and stays equal to the dense ``generate`` on merged weights."""
        _, tp, tcfg = model
        eng = mk(tp, tcfg, adapters=adapters)
        rng = np.random.default_rng(11)
        p = rng.integers(0, CFG.vocab_size, (12,)).astype(np.int32)
        run_wave(eng, [p])                             # seed the base chain
        hit0 = eng.stats()["prefix_hit_tokens"]
        got = run_wave(eng, [p], adapter_ids=["a1"])
        assert eng.stats()["prefix_hit_tokens"] == hit0   # no cross-hit
        want = TG.generate(TLoRA.merge_lora(tp, adapters["a1"]), p[None],
                           tcfg, max_new_tokens=10).numpy()[0]
        np.testing.assert_array_equal(got[0], want)
        got2 = run_wave(eng, [p], adapter_ids=["a1"])  # own chain DOES hit
        assert eng.stats()["prefix_hit_tokens"] > hit0
        np.testing.assert_array_equal(got2[0], got[0])


class TestPoolChurn:
    def test_churn_keeps_pool_storage(self, lora1, prompts):
        """Five adapters through two slots: every wave evicts and reloads,
        and every pool leaf keeps its storage (loads write in place)."""
        ptrs = {k: v.data_ptr() for k, v in lora1._lora.layers.items()}
        run_wave(lora1, prompts[:2], adapter_ids=["a1", "a2"], n=4)
        loads0 = lora1.stats()["lora"]["adapter_loads"]
        for name in ("a3", "a4", "a5", "a1", "a2"):
            run_wave(lora1, prompts[:2], adapter_ids=[name, None], n=4)
        after = lora1.stats()["lora"]
        assert after["adapter_loads"] > loads0
        assert after["adapter_evictions"] > 0
        assert {k: v.data_ptr() for k, v in
                lora1._lora.layers.items()} == ptrs

    def test_evict_reload_bit_exact(self, lora1, prompts):
        first = run_wave(lora1, prompts[:1], adapter_ids=["a1"])
        for name in ("a3", "a4", "a5"):
            run_wave(lora1, prompts[:1], adapter_ids=[name], n=2)
        assert "a1" in lora1.adapter_partition()["evicted"]
        again = run_wave(lora1, prompts[:1], adapter_ids=["a1"])
        assert _parity(first, again)

    def test_running_adapter_pinned_against_eviction(self, lora1, prompts):
        """More distinct adapters in flight than slots: admission gates
        the overflow instead of evicting a running adapter; every running
        adapter request sits at its adapter's resident slot with a pin;
        everyone finishes and the pins drain to zero."""
        ids = ["a1", "a2", "a3", "a4"]          # 4 adapters, 2 slots
        rids = [lora1.submit(p, max_new_tokens=6, eos_token_id=None,
                             adapter_id=a)
                for p, a in zip(prompts, ids)]
        steps = 0
        while lora1.pending:
            lora1.step()
            part = lora1.adapter_partition()
            assert len(part["resident"]) <= LORA["lora_slots"]
            assert set(part["resident"]) | set(part["evicted"]) == \
                set(part["registered"])
            for rid, (name, slot) in part["running"].items():
                assert part["resident"][name] == slot
                assert part["pinned"].get(name, 0) >= 1
            steps += 1
            assert steps < 200
        for r in rids:
            assert lora1.request(r).state == "finished"
        part = lora1.adapter_partition()
        assert part["pinned"] == {}
        assert part["running"] == {}

    def test_corrupt_host_copy_refused(self, adapters):
        pool = TLoRA.AdapterPool(CFG, RANK, 1, 4, device="cpu")
        pool.register("x", adapters["a1"])
        pool.register("y", adapters["a2"])
        pool.acquire("x")                       # y stays cold
        pool.release("x")                       # unpinned -> evictable
        assert pool.corrupt_one() == "y"
        with pytest.raises(RuntimeError, match="checksum"):
            pool.acquire("y")

    def test_preempted_request_keeps_pin(self, model, adapters, prompts):
        """Under pool pressure a preempted adapter request keeps its pin
        and slot (the gate is idempotent per request) and still finishes
        equal to an unpressured run."""
        _, tp, tcfg = model
        want = run_wave(mk(tp, tcfg, adapters=adapters), prompts,
                        adapter_ids=["a1", "a2", "a1", None], n=24)
        eng = mk(tp, tcfg, adapters=adapters, num_blocks=9)
        got = run_wave(eng, prompts, adapter_ids=["a1", "a2", "a1", None],
                       n=24)
        assert eng.stats()["preemptions"] >= 1
        assert _parity(got, want)
        assert eng.stats()["lora"]["adapter_pins"] == 0


class TestLifecycleAndObservability:
    def test_stats_snapshot_partition_fields(self, lora1, base1):
        st = lora1.stats()["lora"]
        for k in ("adapters_registered", "adapters_resident",
                  "adapter_loads", "adapter_evictions", "adapter_pins"):
            assert k in st, k
        assert st["adapters_registered"] == 5
        snap = lora1._lora.snapshot()
        assert snap["slots"] == LORA["lora_slots"]
        assert snap["rank"] == RANK
        assert base1.stats()["lora"] is None
        assert base1.adapter_partition() is None
        assert lora1.adapter_registered("a1")
        assert not base1.adapter_registered("a1")
        resident = lora1.adapter_partition()["resident"]
        for name in ("a1", "a2", "a3", "a4", "a5"):
            assert lora1.adapter_resident(name) == (name in resident)
        assert not base1.adapter_resident("a1")

    def test_submit_validation(self, model, adapters, base1, lora1, prompts):
        """The port raises JAX's errors, with JAX's messages."""
        jp, _, _ = model
        jbase = JEngine(jp, CFG, JConfig(**BASE))
        jlora = JEngine(jp, CFG, JConfig(**BASE, **LORA))
        for name, ap in adapters.items():
            jlora.register_adapter(name, ap)
        cases = [((base1, jbase), dict(adapter_id="a1")),
                 ((lora1, jlora), dict(adapter_id="zz"))]
        for (t, j), kw in cases:
            with pytest.raises(ValueError) as te:
                t.submit(prompts[0], max_new_tokens=2, **kw)
            with pytest.raises(ValueError) as je:
                j.submit(prompts[0], max_new_tokens=2, **kw)
            assert str(te.value) == str(je.value)
        with pytest.raises(ValueError) as te:
            base1.register_adapter("a1", adapters["a1"])
        with pytest.raises(ValueError) as je:
            jbase.register_adapter("a1", adapters["a1"])
        assert str(te.value) == str(je.value)
        assert "lora_slots" in str(te.value)

    def test_config_and_registry_errors_match_jax(self, adapters):
        for kw in (dict(lora_slots=-1), dict(lora_slots=4, lora_pool=2)):
            with pytest.raises(ValueError) as te:
                TConfig(**kw)
            with pytest.raises(ValueError) as je:
                JConfig(**kw)
            assert str(te.value) == str(je.value)
        bad_rank = TLoRA.lora_init_params(CFG, RANK + 1, seed=1)
        missing = {k: v for k, v in adapters["a1"].items() if k != "oB"}
        tpool = TLoRA.AdapterPool(CFG, RANK, 1, 1, device="cpu")
        jpool = JLoRA.AdapterPool(CFG, RANK, 1, 1)
        for args in (("b", bad_rank), ("m", missing), ("", adapters["a1"])):
            with pytest.raises(ValueError) as te:
                tpool.register(*args)
            with pytest.raises(ValueError) as je:
                jpool.register(*args)
            assert str(te.value) == str(je.value)
        for pool in (tpool, jpool):
            pool.register("a1", adapters["a1"])
        with pytest.raises(ValueError) as te:
            tpool.register("a2", adapters["a2"])
        with pytest.raises(ValueError) as je:
            jpool.register("a2", adapters["a2"])
        assert str(te.value) == str(je.value)
        for args in ((CFG, 0, 1, 1), (CFG, RANK, 0, 1), (CFG, RANK, 2, 1)):
            with pytest.raises(ValueError) as te:
                TLoRA.AdapterPool(*args, device="cpu")
            with pytest.raises(ValueError) as je:
                JLoRA.AdapterPool(*args)
            assert str(te.value) == str(je.value)

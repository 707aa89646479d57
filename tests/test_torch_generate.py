"""The port's dense generation tier (``paddle_tpu_torch.models.generation``:
``generate``, ``DecodeSession``, ``prefill``, ``decode_step``;
``paddle_tpu_torch.inference.GenerationPredictor``) against the JAX
package's, plus the port-side mirrors of ``tests/test_generation.py``.

* ``prng.split`` equals ``jax.random.split`` bit for bit.
* ``left_align`` equals JAX's; ``prefill`` and ``decode_step`` match
  JAX's logits (1e-4), cache (1e-5) and MoE drops on the same weights.
* ``generate``'s greedy and seeded streams, ``DecodeSession``'s argmax
  stream and the predictor's batch / stream / serve outputs equal JAX's:
  MHA, GQA, MoE, ragged rows, EOS, int8 weights.
* The mirrors: greedy generate equals an iterative full-forward argmax
  (``llama.forward``, no cache); EOS stops a row and pads it; sampled
  tokens lie in the top-k / top-p support; the session's capacity guard
  and prompt-length error; MoE drop detection; the seed resolution.
* The serving engine's greedy streams equal ``generate``'s on the same
  prompts (the contract the dense tier is the oracle of).

The eager-layer test (``TestWrappers::test_eager_layer_generate``) needs
the framework's eager layers, which the port does not have yet.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.inference.generation import \
    GenerationPredictor as JPredictor
from paddle_tpu.models import generation as JG
from paddle_tpu.models import llama as JL
from paddle_tpu_torch import prng
from paddle_tpu_torch.inference import GenerationConfig, GenerationPredictor
from paddle_tpu_torch.inference.serving import ServingConfig, ServingEngine
from paddle_tpu_torch.models import generation as TG
from paddle_tpu_torch.models.convert import config_from_jax, params_from_jax
from paddle_tpu_torch.models.llama import forward

torch.set_num_threads(2)


def tiny_cfg(**kw):
    base = dict(vocab_size=97, hidden_size=64, intermediate_size=96,
                num_hidden_layers=3, num_attention_heads=4,
                num_key_value_heads=2, max_position_embeddings=64)
    base.update(kw)
    return JL.LlamaConfig(**base)


def _both(cfg, seed):
    """(JAX params, port params, port config) from one JAX init."""
    jp = JL.init_params(cfg, jax.random.PRNGKey(seed))
    return jp, params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                               device="cpu"), config_from_jax(cfg)


def greedy_oracle(params, ids, cfg, n):
    """Iterative full forward (no cache), argmax decode, in the port."""
    cur = torch.as_tensor(ids)
    outs = []
    for _ in range(n):
        logits = forward(params, cur, cfg)
        nxt = torch.argmax(logits[:, -1].float(), -1).to(cur.dtype)
        outs.append(nxt)
        cur = torch.cat([cur, nxt[:, None]], 1)
    return torch.stack(outs, 1).numpy()


@pytest.fixture(scope="module")
def setup():
    cfg = tiny_cfg()
    jp, tp, tcfg = _both(cfg, 0)
    rng = np.random.default_rng(0)
    ids = rng.integers(0, cfg.vocab_size, (2, 9)).astype(np.int32)
    return cfg, jp, tcfg, tp, ids


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------

def test_split_matches_jax():
    rng = np.random.default_rng(0)
    for _ in range(64):
        k = rng.integers(0, 2**32, size=2, dtype=np.uint64).astype(np.uint32)
        for num in (2, 3, 5):
            want = np.asarray(jax.random.split(jnp.asarray(k), num))
            got = prng.split(torch.from_numpy(k.astype(np.int64)), num)
            np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    # a batch of keys splits each key (jax.vmap over the keys)
    ks = rng.integers(0, 2**32, size=(4, 2), dtype=np.uint64)
    want = np.asarray(jax.vmap(jax.random.split)(
        jnp.asarray(ks.astype(np.uint32))))
    got = prng.split(torch.from_numpy(ks.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_left_align_matches_jax():
    rng = np.random.default_rng(1)
    ids = rng.integers(1, 97, (4, 10)).astype(np.int32)
    plens = np.array([10, 3, 7, 1], np.int32)
    for pad in (0, 5):
        want = np.asarray(JG.left_align(jnp.asarray(ids), jnp.asarray(plens),
                                        pad))
        got = TG.left_align(torch.from_numpy(ids), torch.from_numpy(plens),
                            pad)
        np.testing.assert_array_equal(got.numpy(), want)


MODELS = {"gqa": dict(), "mha": dict(num_key_value_heads=4),
          "moe": dict(moe_num_experts=4, moe_top_k=2,
                      moe_capacity_factor=0.5)}


@pytest.mark.parametrize("name", list(MODELS))
def test_prefill_decode_step_match_jax(name):
    """Ragged prefill, then three decode steps fed JAX's greedy tokens:
    logits, the whole cache and the drop counts agree."""
    cfg = tiny_cfg(**MODELS[name])
    jp, tp, tcfg = _both(cfg, 3)
    rng = np.random.default_rng(2)
    ids = rng.integers(0, cfg.vocab_size, (3, 8)).astype(np.int32)
    plens = np.array([8, 5, 2], np.int32)
    C = 12
    jc = JG.init_cache(cfg, 3, C)
    tc = TG.init_cache(tcfg, 3, C, device="cpu")
    jl, jc, jd = JG.prefill(jp, cfg, jnp.asarray(ids), jnp.asarray(plens), jc)
    tl, tc, td = TG.prefill(tp, tcfg, torch.from_numpy(ids),
                            torch.from_numpy(plens), tc)
    for t in range(4):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=0, err_msg=f"step {t}")
        for k in ("k", "v"):
            np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                       atol=1e-5, rtol=0)
        assert float(td) == float(jd)
        if t == 3:
            break
        tok = np.argmax(np.asarray(jl), -1).astype(np.int32)
        jl, jc, jd = JG.decode_step(jp, cfg, jnp.asarray(tok), jnp.int32(t),
                                    jnp.asarray(plens), jnp.int32(8), jc)
        tl, tc, td = TG.decode_step(tp, tcfg, torch.from_numpy(tok), t,
                                    torch.from_numpy(plens), 8, tc)
    if name == "moe":
        assert float(JG.prefill(jp, cfg, jnp.asarray(ids), jnp.asarray(plens),
                                JG.init_cache(cfg, 3, C))[2]) > 0


GEN_CASES = {
    "greedy": dict(),
    "greedy_ragged_eos": dict(eos="first", ragged=True),
    "sampled": dict(temperature=0.8, top_k=20, top_p=0.9, seed=3),
    "sampled_ragged": dict(temperature=1.1, seed=11, ragged=True),
}


@pytest.mark.parametrize("model", list(MODELS))
@pytest.mark.parametrize("case", list(GEN_CASES))
def test_generate_matches_jax(model, case):
    cfg = tiny_cfg(**MODELS[model])
    jp, tp, tcfg = _both(cfg, 5)
    kw = dict(GEN_CASES[case])
    rng = np.random.default_rng(4)
    ids = rng.integers(0, cfg.vocab_size, (3, 7)).astype(np.int32)
    plens = np.array([7, 4, 6], np.int32) if kw.pop("ragged", False) \
        else None
    if kw.pop("eos", None):
        # an EOS a row emits early: the first greedy token of row 1
        # (the same pad id: under MoE pad tokens take capacity places)
        kw["pad_token_id"] = 96
        first = np.asarray(JG.generate(jp, ids, cfg, max_new_tokens=1,
                                       prompt_lens=plens, pad_token_id=96))
        kw["eos_token_id"] = int(first[1, 0])
    want = np.asarray(JG.generate(jp, ids, cfg, max_new_tokens=8,
                                  prompt_lens=plens, **kw))
    got = TG.generate(tp, ids, tcfg, max_new_tokens=8, prompt_lens=plens,
                      **kw)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    if "eos_token_id" in kw:
        assert (want[1, 1:] == 96).all()


def test_generate_return_drops_matches_jax():
    cfg = tiny_cfg(**MODELS["moe"])
    jp, tp, tcfg = _both(cfg, 6)
    ids = np.random.default_rng(5).integers(0, 97, (2, 10)).astype(np.int32)
    plens = np.array([10, 10], np.int32)
    jt, jd = JG.make_generate_fn(cfg, max_new_tokens=4, return_drops=True)(
        jp, jnp.asarray(ids), jnp.asarray(plens), jax.random.PRNGKey(0))
    tt, td = TG.make_generate_fn(tcfg, max_new_tokens=4, return_drops=True)(
        tp, torch.from_numpy(ids), torch.from_numpy(plens), TG.seed_key(0))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    assert float(td) == float(jd) > 0


def test_int8_generate_matches_jax(setup):
    """quantize='int8': the predictor's batch and stream outputs equal
    the JAX predictor's (every projection through the int8 route)."""
    cfg, jp, tcfg, tp, ids = setup
    gc = dict(max_new_tokens=5)
    jpred = JPredictor(jp, cfg, JG.GenerationConfig(**gc), quantize="int8")
    tpred = GenerationPredictor(tp, tcfg, GenerationConfig(**gc),
                                quantize="int8", device="cpu")
    assert "wq_s" in tpred._params["layers"]
    np.testing.assert_array_equal(tpred.generate(ids), jpred.generate(ids))
    np.testing.assert_array_equal(np.stack(list(tpred.stream(ids)), 1),
                                  np.stack(list(jpred.stream(ids)), 1))


def test_session_matches_jax_session(setup):
    cfg, jp, tcfg, tp, ids = setup
    js = JG.DecodeSession(jp, cfg, capacity=16)
    ts = TG.DecodeSession(tp, tcfg, capacity=16)
    plens = np.array([9, 6], np.int32)
    jl = js.prefill(jnp.asarray(ids), jnp.asarray(plens))
    tl = ts.prefill(ids, plens)
    for _ in range(4):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=0)
        tok = np.argmax(np.asarray(jl), -1).astype(np.int32)
        jl, tl = js.step(jnp.asarray(tok)), ts.step(tok)
    assert ts.dropped_tokens == js.dropped_tokens == 0.0


def test_serving_engine_equals_generate(setup):
    """The serving engine's greedy streams equal ``generate``'s on the
    same prompts (ragged, one per request)."""
    cfg, _, tcfg, tp, _ = setup
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, 97, (int(n),)).astype(np.int32)
               for n in (9, 4, 13, 6)]
    eng = ServingEngine(tp, tcfg, ServingConfig(
        block_size=4, max_slots=3, max_model_len=40, prefill_chunk=8),
        device="cpu")
    served = eng.run(prompts, max_new_tokens=10, eos_token_id=None)
    S = max(len(p) for p in prompts)
    ids = np.zeros((len(prompts), S), np.int32)
    for i, p in enumerate(prompts):
        ids[i, :len(p)] = p
    dense = TG.generate(tp, ids, tcfg, max_new_tokens=10,
                        prompt_lens=[len(p) for p in prompts]).numpy()
    for i, s in enumerate(served):
        np.testing.assert_array_equal(np.asarray(s), dense[i])


# ---------------------------------------------------------------------------
# mirrors of tests/test_generation.py
# ---------------------------------------------------------------------------

class TestGreedyParity:
    def test_matches_full_forward(self, setup):
        _, _, tcfg, tp, ids = setup
        got = TG.generate(tp, ids, tcfg, max_new_tokens=6)
        np.testing.assert_array_equal(got.numpy(),
                                      greedy_oracle(tp, ids, tcfg, 6))

    def test_single_token(self, setup):
        _, _, tcfg, tp, ids = setup
        got = TG.generate(tp, ids, tcfg, max_new_tokens=1)
        np.testing.assert_array_equal(got.numpy(),
                                      greedy_oracle(tp, ids, tcfg, 1))

    def test_gqa_and_mha(self, setup):
        ids = setup[4]
        for kvh in (4, 1):  # MHA and max-GQA
            _, tp, tcfg = _both(tiny_cfg(num_key_value_heads=kvh), 1)
            got = TG.generate(tp, ids, tcfg, max_new_tokens=4)
            np.testing.assert_array_equal(got.numpy(),
                                          greedy_oracle(tp, ids, tcfg, 4))

    def test_moe_config(self, setup):
        ids = setup[4]
        _, tp, tcfg = _both(tiny_cfg(moe_num_experts=4, moe_top_k=2), 2)
        got = TG.generate(tp, ids, tcfg, max_new_tokens=3)
        np.testing.assert_array_equal(got.numpy(),
                                      greedy_oracle(tp, ids, tcfg, 3))


class TestRaggedBatch:
    def test_ragged_rows_match_solo_runs(self, setup):
        _, _, tcfg, tp, ids = setup
        got = TG.generate(tp, ids, tcfg, max_new_tokens=5,
                          prompt_lens=[9, 5]).numpy()
        full = TG.generate(tp, ids, tcfg, max_new_tokens=5).numpy()
        solo = TG.generate(tp, ids[1:2, :5], tcfg, max_new_tokens=5).numpy()
        np.testing.assert_array_equal(got[0], full[0])
        np.testing.assert_array_equal(got[1], solo[0])


class TestEos:
    def test_eos_stops_row_and_pads(self, setup):
        _, _, tcfg, tp, ids = setup
        oracle = greedy_oracle(tp, ids, tcfg, 6)
        eos = int(oracle[0, 1])  # force an eos hit at step 1 on row 0
        row = TG.generate(tp, ids, tcfg, max_new_tokens=6, eos_token_id=eos,
                          pad_token_id=0).numpy()[0]
        stop = int(np.argmax(oracle[0] == eos))
        np.testing.assert_array_equal(row[:stop + 1], oracle[0][:stop + 1])
        assert (row[stop + 1:] == 0).all()

    def test_all_rows_done_exits_early(self, setup, monkeypatch):
        """Once every row has emitted EOS the loop stops dispatching."""
        _, _, tcfg, tp, ids = setup
        first = TG.generate(tp, ids[:1], tcfg, max_new_tokens=1).numpy()
        calls = []
        real = TG.decode_step
        monkeypatch.setattr(TG, "decode_step",
                            lambda *a, **k: calls.append(1) or real(*a, **k))
        out = TG.generate(tp, ids[:1], tcfg, max_new_tokens=6,
                          eos_token_id=int(first[0, 0]),
                          pad_token_id=3).numpy()
        assert calls == []
        np.testing.assert_array_equal(out[0], [first[0, 0]] + [3] * 5)


class TestSampling:
    def _last_logits(self, tp, tcfg, ids):
        return forward(tp, torch.from_numpy(ids), tcfg)[:, -1].float() \
            .numpy()

    def test_top_p_support_set(self, setup):
        _, _, tcfg, tp, ids = setup
        logits = self._last_logits(tp, tcfg, ids)
        for b in range(ids.shape[0]):
            srt = np.sort(logits[b])[::-1]
            probs = np.exp(srt - srt.max())
            probs /= probs.sum()
            keep = np.cumsum(probs) - probs < 0.7
            nucleus = set(np.nonzero(logits[b] >= srt[keep].min())[0]
                          .tolist())
            for seed in range(5):
                got = TG.generate(tp, ids, tcfg, max_new_tokens=1,
                                  temperature=1.0, top_p=0.7,
                                  key=TG.seed_key(seed))
                assert int(got[b, 0]) in nucleus

    def test_top_k_support_set(self, setup):
        _, _, tcfg, tp, ids = setup
        logits = self._last_logits(tp, tcfg, ids)
        for b in range(ids.shape[0]):
            topk = set(np.argsort(logits[b])[-3:].tolist())
            for seed in range(5):
                got = TG.generate(tp, ids, tcfg, max_new_tokens=1,
                                  temperature=1.0, top_k=3,
                                  key=TG.seed_key(seed))
                assert int(got[b, 0]) in topk


class TestStreaming:
    def test_session_matches_oracle(self, setup):
        _, _, tcfg, tp, ids = setup
        sess = TG.DecodeSession(tp, tcfg, capacity=9 + 6)
        logits = sess.prefill(ids)
        toks = []
        for t in range(6):
            tok = torch.argmax(logits, -1).to(torch.int32)
            toks.append(tok)
            if t < 5:
                logits = sess.step(tok)
        np.testing.assert_array_equal(torch.stack(toks, 1).numpy(),
                                      greedy_oracle(tp, ids, tcfg, 6))

    def test_capacity_guard(self, setup):
        _, _, tcfg, tp, ids = setup
        sess = TG.DecodeSession(tp, tcfg, capacity=10)
        sess.prefill(ids)  # S=9; one decode slot left
        logits = sess.step(torch.zeros((2,), dtype=torch.int32))
        assert logits.shape == (2, tcfg.vocab_size)
        with pytest.raises(RuntimeError, match="capacity"):
            sess.step(torch.zeros((2,), dtype=torch.int32))

    def test_prompt_too_long_raises(self, setup):
        _, _, tcfg, tp, ids = setup
        sess = TG.DecodeSession(tp, tcfg, capacity=4)
        with pytest.raises(ValueError, match="exceeds capacity"):
            sess.prefill(ids)
        with pytest.raises(RuntimeError, match="prefill"):
            TG.DecodeSession(tp, tcfg, capacity=4).step([1, 2])


class TestWrappers:
    def test_generation_predictor_batch_and_stream(self, setup):
        _, _, tcfg, tp, ids = setup
        oracle = greedy_oracle(tp, ids, tcfg, 4)
        pred = GenerationPredictor(tp, tcfg, GenerationConfig(
            max_new_tokens=4), device="cpu")
        np.testing.assert_array_equal(pred.generate(ids), oracle)
        streamed = np.stack(list(pred.stream(ids)), 1)
        np.testing.assert_array_equal(streamed, oracle)

    def test_generation_predictor_serve(self, setup):
        """serve() keeps its warm engine across calls (the second call's
        prompts hit the first call's prefix cache) and equals the JAX
        predictor's serve and its own generate."""
        cfg, jp, tcfg, tp, ids = setup
        gc = dict(max_new_tokens=5)
        pred = GenerationPredictor(tp, tcfg, GenerationConfig(**gc),
                                   device="cpu")
        sc = ServingConfig(block_size=4, max_slots=2, max_model_len=32)
        prompts = [ids[0], ids[1, :6]]
        got = pred.serve(prompts, serving_config=sc)
        eng = pred._engine
        again = pred.serve(prompts, serving_config=sc)
        assert pred._engine is eng
        assert eng.stats()["prefix_hit_tokens"] > 0
        from paddle_tpu.inference.serving import ServingConfig as JSC
        want = JPredictor(jp, cfg, JG.GenerationConfig(**gc)).serve(
            prompts, serving_config=JSC(block_size=4, max_slots=2,
                                        max_model_len=32))
        for g, a, w, p in zip(got, again, want, prompts):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
            np.testing.assert_array_equal(np.asarray(a), np.asarray(w))
            np.testing.assert_array_equal(
                np.asarray(g), pred.generate(p[None])[0])


class TestMoeDropDetection:
    def _moe_cfg(self, capacity_factor):
        return JL.LlamaConfig(hidden_size=32, intermediate_size=64,
                              num_hidden_layers=2, num_attention_heads=2,
                              vocab_size=61, max_position_embeddings=64,
                              dtype=jnp.float32, remat=False,
                              moe_num_experts=4, moe_top_k=2,
                              moe_capacity_factor=capacity_factor)

    def test_no_drops_in_normal_regime_and_session_exposes_zero(self):
        _, tp, tcfg = _both(self._moe_cfg(capacity_factor=4.0), 0)
        gen = TG.make_generate_fn(tcfg, max_new_tokens=4, return_drops=True)
        ids = torch.from_numpy(np.random.default_rng(1).integers(
            0, 61, (2, 6)).astype(np.int32))
        _, drops = gen(tp, ids, torch.tensor([6, 6]), TG.seed_key(2))
        assert float(drops) == 0.0
        sess = TG.DecodeSession(tp, tcfg, capacity=16)
        sess.prefill(ids)
        sess.step(torch.tensor([1, 2]))
        assert sess.dropped_tokens == 0.0

    def test_drops_detected_under_tiny_capacity(self):
        _, tp, tcfg = _both(self._moe_cfg(capacity_factor=0.05), 0)
        gen = TG.make_generate_fn(tcfg, max_new_tokens=2, return_drops=True)
        ids = torch.from_numpy(np.random.default_rng(1).integers(
            0, 61, (2, 16)).astype(np.int32))
        _, drops = gen(tp, ids, torch.tensor([16, 16]), TG.seed_key(2))
        assert float(drops) > 0.0


class TestSeedConfig:
    def test_default_seed_matches_key_zero(self, setup):
        _, _, tcfg, tp, ids = setup
        a = TG.generate(tp, ids[:1], tcfg, max_new_tokens=4, temperature=0.8)
        b = TG.generate(tp, ids[:1], tcfg, max_new_tokens=4, temperature=0.8,
                        key=TG.seed_key(0))
        np.testing.assert_array_equal(a.numpy(), b.numpy())

    def test_seed_param_equals_explicit_key(self, setup):
        _, _, tcfg, tp, ids = setup
        kw = dict(max_new_tokens=4, temperature=0.8)
        a = TG.generate(tp, ids[:1], tcfg, seed=123, **kw)
        b = TG.generate(tp, ids[:1], tcfg, key=np.asarray(
            jax.random.PRNGKey(123)), **kw)
        c = TG.generate(tp, ids[:1], tcfg, seed=7, **kw)
        np.testing.assert_array_equal(a.numpy(), b.numpy())
        assert not np.array_equal(a.numpy(), c.numpy())
        again = TG.generate(tp, ids[:1], tcfg, seed=123, **kw)
        np.testing.assert_array_equal(a.numpy(), again.numpy())

    def test_config_resolve_seed_sentinels(self):
        base = TG.GenerationConfig(seed=5)
        assert TG.GenerationConfig().seed == 0
        assert TG.GenerationConfig.resolve(base).seed == 5
        assert TG.GenerationConfig.resolve(base, seed="unset").seed == 5
        assert TG.GenerationConfig.resolve(base, seed=None).seed == 5
        assert TG.GenerationConfig.resolve(base, seed=9).seed == 9

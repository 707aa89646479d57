"""The port's serving stack (``paddle_tpu_torch.inference.serving``) against
the JAX package's, plus the port's packaging rules.

* The host-side ``BlockManager``: one randomized alloc / share / register
  / free / evict sequence leaves both implementations in the same state.
* ``ServingEngine``: given the same parameters, config and trace, the
  port's engine and the JAX engine emit EQUAL greedy token streams and
  equal dispatch counters, with mixed batching on, on the two-phase path,
  with the prefix cache, with chunked prefill, under preemption pressure,
  with an int8 KV pool and with int8 weights.
* The ``FLAGS_serving_*`` the port reads have the JAX package's names,
  defaults and environment override.
* Importing every module of ``paddle_tpu_torch`` pulls in neither ``jax``
  nor ``paddle_tpu`` (checked in a fresh interpreter).
* Entry points that create tensors raise when no card is present and no
  ``device="cpu"`` was given.

JAX engines of one program shape share their compiled programs
(``programs=``) to keep compile time down.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from paddle_tpu.inference.serving import paged_cache as JPC
from paddle_tpu.inference.serving.engine import ServingConfig as JConfig
from paddle_tpu.inference.serving.engine import ServingEngine as JEngine
from paddle_tpu.models import llama as JL
from paddle_tpu_torch.inference.serving import paged_cache as TPC
from paddle_tpu_torch.inference.serving.engine import ServingConfig as TConfig
from paddle_tpu_torch.inference.serving.engine import ServingEngine as TEngine
from paddle_tpu_torch.models.convert import config_from_jax, params_from_jax

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# BlockManager: the same op sequence, the same state
# ---------------------------------------------------------------------------

def _bm_state(bm):
    return {"free": list(bm._free), "ref": dict(bm._ref),
            "hash2block": dict(bm._hash2block),
            "block2hash": dict(bm._block2hash),
            "tokens": dict(bm._block_tokens),
            "evictable": list(bm._evictable),
            "block_tenant": dict(bm._block_tenant),
            "tenant_cached": dict(bm._tenant_cached),
            "evictions": bm.evictions, "free_blocks": bm.free_blocks,
            "cached": bm.cached_blocks, "in_use": bm.blocks_in_use}


@pytest.mark.parametrize("quota", [None, 2])
@pytest.mark.parametrize("seed", range(3))
def test_block_manager_fuzz_same_state(seed, quota):
    rng = np.random.default_rng(seed)
    jbm, tbm = JPC.BlockManager(12, 4, quota), TPC.BlockManager(12, 4, quota)
    held = []                    # one entry per live reference
    keys = {}                    # key -> tokens it was registered with
    for _ in range(300):
        op = rng.choice(["alloc", "free", "register", "share", "lookup"])
        if op == "alloc":
            n = int(rng.integers(1, 4))
            assert jbm.can_alloc(n) == tbm.can_alloc(n)
            if jbm.can_alloc(n):
                got = jbm.alloc(n)
                assert tbm.alloc(n) == got
                held.extend(got)
        elif op == "free" and held:
            b = held.pop(int(rng.integers(len(held))))
            jbm.free([b])
            tbm.free([b])
        elif op == "register" and held:
            b = held[int(rng.integers(len(held)))]
            key = int(rng.integers(0, 20))
            toks = keys.setdefault(key, tuple(rng.integers(0, 9, size=4)))
            tenant = str(rng.choice(["a", "b"]))
            jbm.register(key, b, toks, tenant=tenant)
            tbm.register(key, b, toks, tenant=tenant)
        elif op in ("share", "lookup"):
            key = int(rng.integers(0, 20))
            toks = keys.get(key)
            b = jbm.lookup(key, toks)
            assert tbm.lookup(key, toks) == b
            if op == "share" and b is not None:
                assert jbm.share(b) == tbm.share(b) == b
                held.append(b)
        assert _bm_state(tbm) == _bm_state(jbm)
    jbm.free(held)
    tbm.free(held)
    assert _bm_state(tbm) == _bm_state(jbm)
    assert tbm.blocks_in_use == 0


def test_block_manager_errors_match():
    for bm in (JPC.BlockManager(4, 2), TPC.BlockManager(4, 2)):
        [b] = bm.alloc(1)
        bm.free([b])
        with pytest.raises(RuntimeError, match="double"):
            bm.free([b])
        with pytest.raises(RuntimeError, match="share"):
            bm.share(b)


def test_prefix_block_chain_keys_match():
    ids = np.arange(23) % 7
    for ns in (None, "adapter"):
        want = list(JPC.prefix_block_chain(ids, 4, 21, namespace=ns))
        assert list(TPC.prefix_block_chain(ids, 4, 21, namespace=ns)) == want


# ---------------------------------------------------------------------------
# ServingEngine: equal token streams and dispatch counters
# ---------------------------------------------------------------------------

_BASE = dict(block_size=4, max_slots=3, max_model_len=64, decode_chunk=4)
# name -> (ServingConfig overrides, what the trace must show on both sides)
ENGINE_CASES = {
    "mixed": (dict(prefill_chunk=8, prefix_cache=None),
              lambda s: s["mixed_dispatches"] > 0),
    "two_phase": (dict(mixed_batch=False, prefill_chunk=None,
                       prefix_cache=None),
                  lambda s: s["mixed_dispatches"] == 0),
    "prefix_cache": (dict(prefix_cache=True),
                     lambda s: s["prefix_hit_tokens"] > 0),
    "chunked": (dict(mixed_batch=False, prefill_chunk=8, prefix_cache=None),
                lambda s: s["mixed_dispatches"] == 0
                and s["prefill_dispatches"] > 6),
    "preemption": (dict(num_blocks=10, prefill_chunk=8),
                   lambda s: s["preemptions"] >= 1),
    "kv_int8": (dict(kv_quant="int8", prefill_chunk=8),
                lambda s: s["mixed_dispatches"] > 0),
    "weights_int8": (dict(quantize="int8", prefill_chunk=8),
                     lambda s: s["mixed_dispatches"] > 0),
}
_COUNTERS = ("prefill_dispatches", "decode_dispatches", "mixed_dispatches",
             "chunks", "steps", "preemptions", "prefix_hit_tokens",
             "recomputed_tokens")


def _trace(vocab):
    """Six prompts: three share a 12-token prefix, one is 30 tokens long
    (past prefill_chunk), more requests than slots; mixed output lengths."""
    rng = np.random.default_rng(0)
    prefix = rng.integers(0, vocab, size=12)
    lens = [14, 5, 30, 19, 3, 16]
    prompts = []
    for i, n in enumerate(lens):
        p = rng.integers(0, vocab, size=n)
        if i in (0, 3, 5):
            p[:12] = prefix
        prompts.append(p.astype(np.int32))
    return prompts, [10, 6, 8, 12, 9, 7]


@pytest.fixture(scope="module")
def model():
    cfg = JL.LlamaConfig(vocab_size=128, hidden_size=64,
                         intermediate_size=128, num_hidden_layers=2,
                         num_attention_heads=4, num_key_value_heads=2)
    params = JL.init_params(cfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                              device="cpu")
    return cfg, params, config_from_jax(cfg), tparams, {}


def _drive(engine, prompts, news):
    """Run the trace; returns (outputs, stats) with the dispatch counters
    as this run's deltas (JAX engines sharing ``programs=`` share one
    counter dict)."""
    before = {k: engine.stats()[k] for k in _COUNTERS}
    outs = engine.run(prompts, max_new_tokens=news, eos_token_id=None)
    st = engine.stats()
    st.update({k: st[k] - before[k] for k in _COUNTERS})
    return [np.asarray(o) for o in outs], st


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_engine_matches_jax(model, case):
    cfg, params, tcfg, tparams, programs = model
    over, shows = ENGINE_CASES[case]
    kw = {**_BASE, **over}
    # programs are keyed by the engine shape: quantize/kv_quant change it
    shape = (kw.get("quantize"), kw.get("kv_quant"))
    prompts, news = _trace(cfg.vocab_size)
    jeng = JEngine(params, cfg, JConfig(**kw), programs=programs.get(shape))
    programs.setdefault(shape, jeng.programs)
    want, jst = _drive(jeng, prompts, news)
    knobs = ("off", "on") if case == "mixed" else ("auto",)
    for knob in knobs:         # "on": the kernel wrapper's plain version
        teng = TEngine(tparams, tcfg, TConfig(paged_kernel=knob, **kw),
                       device="cpu")
        got, tst = _drive(teng, prompts, news)
        for i, (g, w) in enumerate(zip(got, want)):
            np.testing.assert_array_equal(g, w, err_msg=f"request {i}")
        assert {k: tst[k] for k in _COUNTERS} == \
            {k: jst[k] for k in _COUNTERS}
        assert shows(tst), tst
        assert tst["blocks_in_use"] == 0
        assert tst["free_blocks"] == jst["free_blocks"]


def test_engine_stream_and_cancel(model):
    """stream() yields the same events as run(); a cancelled request frees
    its blocks and stays cancelled."""
    _, _, tcfg, tparams, _ = model
    prompts, news = _trace(tcfg.vocab_size)
    sc = dict(_BASE, prefill_chunk=8)
    ref, _ = _drive(TEngine(tparams, tcfg, TConfig(**sc), device="cpu"),
                    prompts, news)
    eng = TEngine(tparams, tcfg, TConfig(**sc), device="cpu")
    rids = [eng.submit(p, max_new_tokens=n, eos_token_id=None)
            for p, n in zip(prompts, news)]
    got = {r: [] for r in rids}
    for rid, tok in eng.stream():
        got[rid].append(tok)
    for r, want in zip(rids, ref):
        assert got[r] == list(want)
    eng2 = TEngine(tparams, tcfg, TConfig(**sc), device="cpu")
    r0 = eng2.submit(prompts[0], max_new_tokens=20, eos_token_id=None)
    eng2.step(max_iters=1)
    assert eng2.cancel(r0) and not eng2.cancel(r0)
    assert eng2.request(r0).state == "cancelled"
    assert eng2.stats()["blocks_in_use"] == 0


def test_unported_features_raise(model):
    _, _, tcfg, tparams, _ = model
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TConfig(tp=2)
    # LoRA, the offload tier, the journal and the embeddings endpoint are
    # ported: an adapter on a pool-less engine is a usage error
    assert TConfig(lora_slots=1).lora_slots == 1
    assert TConfig(offload=True).offload is True
    eng = TEngine(tparams, tcfg, TConfig(**_BASE), device="cpu")
    with pytest.raises(ValueError, match="lora_slots"):
        eng.submit([1, 2, 3], max_new_tokens=2, adapter_id="a")
    with pytest.raises(ValueError, match="embed_model"):
        eng.submit_embedding([1, 2, 3])
    # the live-migration surface is ported: nothing to move is a benign
    # miss, a foreign KV layout a structured refusal
    from paddle_tpu_torch.inference.serving import AdoptError
    assert eng.serialize_request(0) is None
    assert eng.export_chain([]) is None
    assert eng.graft_chain(None) == {"grafted": 0, "present": 0,
                                     "corrupt": 0}
    with pytest.raises(AdoptError, match="layout mismatch"):
        eng.graft_chain({"shape_key": ("foreign",), "blocks": []})
    with pytest.raises(ValueError, match="options"):
        TConfig(kv_quant="fp4")


# ---------------------------------------------------------------------------
# packaging rules
# ---------------------------------------------------------------------------

def test_port_imports_neither_jax_nor_paddle_tpu():
    code = (
        "import importlib, pkgutil, sys\n"
        "import paddle_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "'paddle_tpu_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or "
        "k.startswith(('jax.', 'jaxlib')) or k == 'paddle_tpu' or "
        "k.startswith('paddle_tpu.'))\n"
        "assert not bad, bad\n"
        "print(len(mods))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 13        # every ported module


_FLAGS = ("block_size", "max_slots", "max_model_len", "queue_depth",
          "decode_chunk", "prefix_cache", "prefill_chunk", "mixed_batch",
          "preempt", "paged_kernel", "kv_quant", "policy", "ttft_slo_s",
          "tenant_cache_quota", "retry_after_s", "spec_decode",
          "spec_ngram", "lora_rank", "lora_slots", "lora_pool")


def test_serving_flags_match_jax():
    """The port's FLAGS_serving_* defaults equal the JAX package's, and
    the FLAGS_<name> environment override reaches both (checked in a
    fresh interpreter, where the registries are built)."""
    from paddle_tpu import flags as JF
    from paddle_tpu_torch import flags as TF
    for name in _FLAGS:
        key = "FLAGS_serving_" + name
        assert TF.flag(key) == JF.flag(key), key
    code = ("from paddle_tpu_torch.flags import flag\n"
            "print(flag('FLAGS_serving_block_size'), "
            "flag('FLAGS_serving_mixed_batch'))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(FLAGS_serving_block_size="32", FLAGS_serving_mixed_batch="0")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == ["32", "False"]


def test_entry_points_need_a_device_without_a_card(monkeypatch):
    from paddle_tpu_torch import resolve_device
    from paddle_tpu_torch.models import generation as TG
    from paddle_tpu_torch.models.llama import LlamaConfig, init_params
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = LlamaConfig(vocab_size=32, hidden_size=16, intermediate_size=32,
                      num_hidden_layers=1, num_attention_heads=2)
    for call in (lambda: resolve_device(),
                 lambda: init_params(cfg),
                 lambda: TG.init_paged_pool(cfg, 4, 4),
                 lambda: params_from_jax({"w": np.zeros(2)}),
                 lambda: TEngine(init_params(cfg, device="cpu"), cfg,
                                 TConfig(**_BASE))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert resolve_device("cpu") == torch.device("cpu")
    assert init_params(cfg, device="cpu")["embed"].device.type == "cpu"

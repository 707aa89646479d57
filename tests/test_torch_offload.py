"""The port's host KV offload tier
(``paddle_tpu_torch.inference.serving.offload``) against the JAX package's.

* ``block_crc``: the same bytes (fp32, bf16, int8) give the reference's
  CRC32.
* ``HostOffloadTier`` unit contract: a verified ``take`` is a MOVE, token
  and checksum mismatches drop as counted corrupt misses, the bound evicts
  oldest-first, ``resize`` shrinks live, ``discard`` drops a stale copy,
  ``peek`` leaves the entry and its counters alone, and ``corrupt_one``
  flips the same byte of the same entry as the reference for a seed.
* The engine with the tier on (fp pool, int8 pool, the paged-attention
  kernel wrapper's plain version, a corrupted host block, live host
  pressure): given the same parameters and trace as the JAX engine, equal
  token streams, equal ``stats()["offload"]`` counters, equal prefix-hit
  and recompute counts, equal pool partitions — and the revisit
  recomputes nothing.

JAX engines of one program shape share their compiled programs.
"""

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from paddle_tpu.inference.serving import offload as JO
from paddle_tpu.inference.serving.engine import ServingConfig as JConfig
from paddle_tpu.inference.serving.engine import ServingEngine as JEngine
from paddle_tpu.models import llama as JL
from paddle_tpu_torch.inference.serving import offload as TO
from paddle_tpu_torch.inference.serving.engine import ServingConfig as TConfig
from paddle_tpu_torch.inference.serving.engine import ServingEngine as TEngine
from paddle_tpu_torch.models.convert import config_from_jax, params_from_jax

torch.set_num_threads(2)

PRE, TAIL, OUT = 12, 3, 4          # 3 full blocks of prefix at bs=4
# device pool sized so the churn wave LRU-evicts every family's chain
# (2 slots x 5 blocks live + a little headroom)
TIER = dict(block_size=4, max_slots=2, max_model_len=32, decode_chunk=2,
            queue_depth=64, num_blocks=12, prefix_cache=True,
            offload=True, offload_blocks=32)


# ---------------------------------------------------------------------------
# the checksum and the tier's unit contract
# ---------------------------------------------------------------------------

def test_block_crc_matches_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 4, 2, 8)).astype(np.float32)
    q = rng.integers(-127, 128, (3, 4, 2, 8)).astype(np.int8)
    cases = [(x, torch.from_numpy(x)),
             (x.astype(ml_dtypes.bfloat16),
              torch.from_numpy(x).to(torch.bfloat16)),
             (q, torch.from_numpy(q))]
    for ref, t in cases:
        assert TO.block_crc(t) == JO.block_crc(ref)
        assert TO.block_crc(ref) == JO.block_crc(ref)
    # a strided view checksums its logical (contiguous) bytes
    t = torch.from_numpy(x)
    assert TO.block_crc(t[:, 1]) == JO.block_crc(x[:, 1])


def _mk(v):
    return {"k": np.full((2, 4), v, np.float32)}


def test_tier_unit_move_semantics_and_bound():
    for T in (JO.HostOffloadTier, TO.HostOffloadTier):
        t = T(capacity_blocks=2, block_size=4)
        t.put(1, (1, 2, 3, 4), _mk(1.0))
        t.put(2, (5, 6, 7, 8), _mk(2.0))
        assert t.blocks == 2
        got = t.take(1, (1, 2, 3, 4))
        np.testing.assert_array_equal(np.asarray(got["k"]), _mk(1.0)["k"])
        assert t.take(1, (1, 2, 3, 4)) is None          # moved out
        assert t.tier_hits == 1 and t.tier_misses == 1
        assert t.take(2, (9, 9, 9, 9)) is None          # token mismatch
        assert t.corrupt_drops == 1 and t.blocks == 0
        t = T(capacity_blocks=2, block_size=4, pending_depth=0)
        t.put(3, (0,) * 4, _mk(3.0))
        t.put(4, (0,) * 4, _mk(4.0))
        t.put(5, (0,) * 4, _mk(5.0))
        assert t.blocks == 2 and t.tier_evictions == 1
        assert t.take(3, (0,) * 4) is None              # evicted
        t.discard(4)
        assert t.take(4, (0,) * 4) is None
        assert t.stats()["capacity"] == 2


def test_tier_resize_peek_and_stats_match_reference():
    """The same op sequence leaves both tiers with equal counters and equal
    host bytes: pending window, peek, resize to a smaller bound and back."""
    tiers = (JO.HostOffloadTier(6, 4), TO.HostOffloadTier(6, 4))
    for t in tiers:
        for k in range(5):
            t.put(k, (k,) * 4, _mk(float(k)))
        assert t.peek(3, (3,) * 4) is not None           # pending -> read
        assert t.peek(3, (9,) * 4) is None               # no drop, no count
        t.resize(3)
        t.put(7, (7,) * 4, _mk(7.0))
        t.resize(8)
        t.flush()
    assert tiers[1].stats() == tiers[0].stats()
    assert sorted(tiers[1].keys()) == sorted(tiers[0].keys())
    for k in tiers[0].keys():
        np.testing.assert_array_equal(
            np.asarray(tiers[1].peek(k, (k,) * 4)["k"]),
            tiers[0].peek(k, (k,) * 4)["k"])


@pytest.mark.parametrize("seed", [0, 1, 5])
def test_corrupt_one_flips_the_same_byte_and_misses(seed):
    rng = np.random.default_rng(seed)
    tiers = (JO.HostOffloadTier(8, 4), TO.HostOffloadTier(8, 4))
    blocks = {k: {"k": rng.standard_normal((2, 4, 3)).astype(np.float32),
                  "v": rng.standard_normal((2, 4, 3)).astype(np.float32)}
              for k in range(3)}
    for t in tiers:
        for k, d in blocks.items():
            t.put(k, (k,) * 4, {n: a.copy() for n, a in d.items()})
    keys = [t.corrupt_one(seed) for t in tiers]
    assert keys[0] == keys[1] is not None
    j_e = tiers[0]._entries[keys[0]]["data"]
    t_e = tiers[1]._entries[keys[1]]["data"]
    for n in ("k", "v"):
        np.testing.assert_array_equal(t_e[n].numpy(), j_e[n])
    for t in tiers:
        assert t.take(keys[0], (keys[0],) * 4) is None
        assert t.corrupt_drops == 1 and t.tier_misses == 1
    assert tiers[1].stats() == tiers[0].stats()


# ---------------------------------------------------------------------------
# the engine with the tier on, against the JAX engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def model():
    cfg = JL.LlamaConfig(vocab_size=97, hidden_size=32,
                         intermediate_size=64, num_hidden_layers=2,
                         num_attention_heads=4, num_key_value_heads=2,
                         max_position_embeddings=64)
    params = JL.init_params(cfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                              device="cpu")
    return cfg, params, config_from_jax(cfg), tparams, {}


def _trace(seed, fams=3, per=2):
    rng = np.random.default_rng(seed)
    prefixes = [rng.integers(0, 97, (PRE,)).astype(np.int32)
                for _ in range(fams)]
    return [np.concatenate([pre, rng.integers(0, 97, (TAIL,))
                            .astype(np.int32)])
            for pre in prefixes for _ in range(per)]


def _engines(model, **kw):
    """A JAX engine (programs shared per shape) and a port engine of one
    config."""
    cfg, params, tcfg, tparams, programs = model
    sc = {**TIER, **kw}
    shape = (sc.get("kv_quant"), sc.get("paged_kernel"))
    jeng = JEngine(params, cfg, JConfig(**sc), programs=programs.get(shape))
    programs.setdefault(shape, jeng.programs)
    return jeng, TEngine(tparams, tcfg, TConfig(**sc), device="cpu")


_SAME = ("prefix_hit_tokens", "recomputed_tokens", "preemptions",
         "evictions", "cached_blocks", "free_blocks")


def _churn_and_revisit(eng, prompts, revisit, between=None):
    eng.run(prompts, max_new_tokens=OUT, eos_token_id=None)
    if between is not None:
        between(eng)
    before = {k: eng.stats()[k] for k in ("prefix_hit_tokens",
                                          "recomputed_tokens")}
    outs = eng.run(revisit, max_new_tokens=OUT, eos_token_id=None)
    st = eng.stats()
    return ([np.asarray(o).tolist() for o in outs], st,
            {k: st[k] - before[k] for k in before})


CASES = {
    "fp": (dict(), 7, 3, 2),
    "int8_pool": (dict(kv_quant="int8"), 11, 3, 2),
    "kernel": (dict(paged_kernel="on"), 13, 2, 1),
}


@pytest.mark.parametrize("case", list(CASES))
def test_roundtrip_matches_jax(model, case):
    over, seed, fams, nrev = CASES[case]
    prompts = _trace(seed, fams)
    revisit = prompts[:nrev]
    jeng, teng = _engines(model, **over)
    j_out, j_st, j_d = _churn_and_revisit(jeng, prompts, revisit)
    t_out, t_st, t_d = _churn_and_revisit(teng, prompts, revisit)
    assert t_out == j_out
    assert t_st["offload"] == j_st["offload"]
    assert {k: t_st[k] for k in _SAME} == {k: j_st[k] for k in _SAME}
    assert teng.block_partition() == jeng.block_partition()
    off = t_st["offload"]
    assert off["swap_outs"] > 0 and off["swap_ins"] > 0
    assert off["tier_hits"] > 0 and off["corrupt_drops"] == 0
    assert t_d["recomputed_tokens"] == 0 and t_d["prefix_hit_tokens"] > 0
    # tier off: the same streams, the revisit re-prefills
    _, off_eng = _engines(model, **over, offload=False)
    o_out, o_st, _ = _churn_and_revisit(off_eng, prompts, revisit)
    assert o_out == t_out and o_st["offload"] is None
    # device XOR host residency, and nothing held after the drain
    bm = teng.cache.manager
    assert not set(teng.cache.offload.keys()) & set(bm._hash2block)
    assert bm.blocks_in_use == 0


def test_corrupt_block_degrades_to_recompute(model):
    prompts = _trace(17)
    revisit = prompts[:2]
    got = []
    for eng in _engines(model):
        out, st, d = _churn_and_revisit(
            eng, prompts, revisit,
            between=lambda e: e.cache.offload.corrupt_one(1))
        got.append((out, st["offload"], d))
    (j_out, j_off, j_d), (t_out, t_off, t_d) = got
    assert t_out == j_out and t_off == j_off and t_d == j_d
    assert t_off["corrupt_drops"] == 1


def test_host_pressure_shrinks_then_recovers(model):
    prompts = _trace(19)
    revisit = prompts[:2]
    got = []
    for eng in _engines(model):
        out, st, d = _churn_and_revisit(
            eng, prompts, revisit,
            between=lambda e: e.cache.offload.resize(0))
        tier = eng.cache.offload
        tier.resize(32)
        swaps0 = tier.swap_outs
        eng.run(prompts[2:], max_new_tokens=OUT, eos_token_id=None)
        assert tier.swap_outs > swaps0
        got.append((out, eng.stats()["offload"], d))
    assert got[1] == got[0]


def test_offload_resolves_through_flags(monkeypatch):
    from paddle_tpu_torch import flags as F
    assert TConfig().offload is False
    assert TConfig().offload_blocks == 256
    monkeypatch.setattr(F._registry["FLAGS_serving_offload"], "value", True)
    monkeypatch.setattr(F._registry["FLAGS_serving_offload_blocks"],
                        "value", 7)
    c = TConfig()
    assert (c.offload, c.offload_blocks) == (True, 7)
    assert TConfig(offload=False, offload_blocks=None).offload_blocks == 0

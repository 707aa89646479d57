"""Tensor-parallel serving in the port (``ServingConfig(tp=...)``), against
the port's own TP=1 engine and, in a few module-scoped cases, against the
JAX package's ``tp=2`` engine.

The port is one controller over a placement of ``tp`` devices (here
``device="cpu"``, i.e. ``[cpu] * tp``, the counterpart of the suite's
virtual host devices): the QKV projections and the paged KV pool are cut
on their heads axis into separate contiguous per-shard tensors, each
shard's attention runs against its own pool shard, and the heads merge by
an exact concatenation, so every contract here is EQUALITY of token
streams — TP=2 and TP=4 against TP=1 (greedy, seeded, int8, kernel and
gather, prefix cache, chunked prefill, preemption, mixed, spec decode,
LoRA, the offload tier, migration, the supervisor's rebuild, a router of
TP replicas), and TP=2 against the JAX TP=2 engine on the same weights.
The reference's ``tests/test_serving_tp.py`` contracts are mirrored class
by class; where it pins a flat ``decode_traces`` counter (no recompile),
the port pins the storage (``data_ptr``) of every sharded leaf (no
re-shard, no second copy).

Model and knobs: the reference's tiny config (vocab 128, hidden 64, 2
layers, 8 query / 4 kv heads) and its ``BASE`` engine shape.
"""

import json

import jax
import numpy as np
import pytest
import torch

from paddle_tpu.distributed.sharding import shard_dim_spec as j_shard_dim_spec
from paddle_tpu.distributed.topology import tp_mesh
from paddle_tpu.inference.serving import ServingConfig as JConfig
from paddle_tpu.inference.serving import ServingEngine as JEngine
from paddle_tpu.models import generation as JG
from paddle_tpu.models import llama as JL
from paddle_tpu_torch.distributed import topology as TT
from paddle_tpu_torch.distributed.sharding import shard_dim_spec, shard_tensor
from paddle_tpu_torch.inference.serving import EngineSupervisor, ServingRouter
from paddle_tpu_torch.inference.serving import workload as TW
from paddle_tpu_torch.inference.serving.engine import (HEALTH_SNAPSHOT_KEYS,
                                                       AdoptError)
from paddle_tpu_torch.inference.serving.engine import ServingConfig as TConfig
from paddle_tpu_torch.inference.serving.engine import ServingEngine as TEngine
from paddle_tpu_torch.inference.serving.paged_cache import prefix_block_chain
from paddle_tpu_torch.models import generation as TG
from paddle_tpu_torch.models.convert import config_from_jax, params_from_jax
from paddle_tpu_torch.models.llama import (LlamaConfig, init_params,
                                           shard_serving_params)
from paddle_tpu_torch.models.lora import lora_init_params
from paddle_tpu_torch.testing.chaos import engine_crash

torch.set_num_threads(2)

CFG = JL.LlamaConfig(vocab_size=128, hidden_size=64, intermediate_size=96,
                     num_hidden_layers=2, num_attention_heads=8,
                     num_key_value_heads=4, max_position_embeddings=128)
TCFG = config_from_jax(CFG)
BASE = dict(block_size=8, max_slots=4, max_model_len=96, queue_depth=16,
            decode_chunk=4)
SAMPLED = dict(temperature=0.9, top_k=17, top_p=0.9)


@pytest.fixture(scope="module")
def jparams():
    return JL.init_params(CFG, jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def params(jparams):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                           device="cpu")


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.default_rng(7)
    return [rng.integers(0, CFG.vocab_size, (int(s),)).astype(np.int32)
            for s in (5, 8, 6, 7)]


def mk(params, tp, device="cpu", **kw):
    return TEngine(params, TCFG, TConfig(**{**BASE, **kw}, tp=tp),
                   device=device)


def run(eng, prompts, new=10, seeded=False, adapters=None):
    """Greedy streams of a wave; ``seeded`` samples every other row with
    its own seed; ``adapters`` names each row's adapter."""
    rids = []
    for i, p in enumerate(prompts):
        kw = dict(SAMPLED, seed=100 + i) if seeded and i % 2 else {}
        if adapters is not None:
            kw["adapter_id"] = adapters[i]
        rids.append(eng.submit(p, max_new_tokens=new, eos_token_id=None,
                               **kw))
    while eng.pending:
        eng.step()
    return [list(eng.request(r).output()) for r in rids]


@pytest.fixture(scope="module")
def eng1(params):
    return mk(params, 1)


@pytest.fixture(scope="module")
def eng2(params):
    return mk(params, 2)


@pytest.fixture(scope="module")
def oracle(eng1, prompts):
    return run(eng1, prompts)


def sharded_ptrs(eng):
    """The storage of every per-shard tensor an engine holds: the q/k/v
    column shards and the pool shards."""
    lay = eng.prepared_params["layers"]
    ptrs = [t.data_ptr() for n in ("wq", "wk", "wv") for t in lay[n]]
    return ptrs + [a.data_ptr() for sh in eng.cache.shards
                   for a in sh.values()]


class TestTPBitParity:
    def test_greedy_gather(self, eng2, oracle, prompts):
        """TP=2 greedy streams equal TP=1 on the fp pool through the
        gather path, run after run, and no run moves the sharded weights
        or the pool shards."""
        ptrs = sharded_ptrs(eng2)
        assert run(eng2, prompts) == oracle
        assert eng2.stats()["tp_degree"] == 2
        assert run(eng2, prompts) == oracle
        assert run(eng2, prompts) == oracle
        assert sharded_ptrs(eng2) == ptrs

    def test_greedy_kernel(self, params, prompts):
        """The paged-attention wrapper (its plain version on the CPU) at
        the shard's 4 query / 2 kv heads gives TP=1's streams."""
        want = run(mk(params, 1, paged_kernel="on"), prompts)
        assert run(mk(params, 2, paged_kernel="on"), prompts) == want

    @pytest.mark.parametrize("kernel", ["off", "on"])
    def test_int8_pool(self, params, prompts, kernel):
        """int8 pools cut k/v and their scale planes identically."""
        want = run(mk(params, 1, kv_quant="int8", paged_kernel=kernel),
                   prompts)
        e2 = mk(params, 2, kv_quant="int8", paged_kernel=kernel)
        assert run(e2, prompts) == want
        for sh in e2.cache.shards:
            assert sh["k"].shape[3] == sh["k_scale"].shape[3] == 2
            assert sh["k"].dtype == torch.int8

    def test_seeded_sampling(self, eng1, eng2, prompts):
        """Seeded rows draw from the merged logits on the lead device:
        the per-token-index keys see no sharding."""
        assert run(eng2, prompts, seeded=True) == \
            run(eng1, prompts, seeded=True)

    def test_tp4(self, params, prompts, oracle):
        """Degree 4: one kv head and two query heads a shard."""
        e4 = mk(params, 4)
        assert run(e4, prompts) == oracle
        assert [sh["k"].shape[3] for sh in e4.cache.shards] == [1] * 4


class TestTPSchedulerComposition:
    def test_chunked_prefill_and_prefix_cache(self, params):
        rng = np.random.default_rng(3)
        pre = rng.integers(0, CFG.vocab_size, (24,)).astype(np.int32)
        shared = [np.concatenate(
            [pre, rng.integers(0, CFG.vocab_size, (6,)).astype(np.int32)])
            for _ in range(5)]
        e1 = mk(params, 1, prefill_chunk=8)
        e2 = mk(params, 2, prefill_chunk=8)
        assert run(e2, shared, 8) == run(e1, shared, 8)
        assert e2.stats()["prefix_hit_tokens"] > 0
        assert e2.stats()["prefix_hit_tokens"] == \
            e1.stats()["prefix_hit_tokens"]

    def test_preemption_pressure(self, params):
        """A 9-block pool forces preempt-and-recompute from decode
        growth; streams equal and no block leaks."""
        rng = np.random.default_rng(11)
        ps = [rng.integers(0, CFG.vocab_size, (8,)).astype(np.int32)
              for _ in range(6)]
        e1 = mk(params, 1, num_blocks=9, prefix_cache=None)
        e2 = mk(params, 2, num_blocks=9, prefix_cache=None)
        assert run(e2, ps, 24) == run(e1, ps, 24)
        assert e2.stats()["preemptions"] >= 1
        assert e2.stats()["preemptions"] == e1.stats()["preemptions"]
        assert e1.cache.manager.blocks_in_use == 0
        assert e2.cache.manager.blocks_in_use == 0

    def test_spec_decode(self, params):
        """The multi-query verify on every shard: drafts fire and are
        accepted, and spec TP=2 equals spec TP=1 and plain decode."""
        ps = []
        for s in (21, 24):
            base = np.random.default_rng(s).integers(
                0, CFG.vocab_size, (8,)).astype(np.int32)
            long = TG.generate(params, base[None], TCFG,
                               max_new_tokens=40)[0].numpy()
            ps.append(np.concatenate([base, long[:24]]))
        plain = run(mk(params, 1), ps, 16)
        s1 = mk(params, 1, spec_decode=4, spec_ngram=2)
        s2 = mk(params, 2, spec_decode=4, spec_ngram=2)
        o1 = run(s1, ps, 16)
        assert run(s2, ps, 16) == o1 == plain
        assert s2.stats()["spec_accepted"] > 0
        assert s2.stats()["spec_accepted"] == s1.stats()["spec_accepted"]
        assert s2.cache.manager.blocks_in_use == 0


class TestTPSharing:
    """The reference keys compiled programs by mesh shape; the port's
    counterpart is the prepared (sharded) params: engines of one
    placement share them, engines of another refuse them."""

    def test_same_placement_shares(self, params, eng2, prompts, oracle):
        twin = TEngine(eng2.prepared_params, TCFG, TConfig(**BASE, tp=2),
                       device="cpu")
        assert run(twin, prompts) == oracle
        for n in ("wq", "wk", "wv"):
            assert [t.data_ptr() for t in twin.prepared_params["layers"][n]] \
                == [t.data_ptr() for t in eng2.prepared_params["layers"][n]]

    def test_different_placement_refuses(self, eng1, eng2):
        with pytest.raises(ValueError, match="cannot serve an engine"):
            TEngine(eng2.prepared_params, TCFG, TConfig(**BASE, tp=1),
                    device="cpu")
        with pytest.raises(ValueError, match="cannot serve an engine"):
            TEngine(eng2.prepared_params, TCFG, TConfig(**BASE, tp=4),
                    device="cpu")
        # TP=1 params are unsharded: a TP=2 engine shards them itself
        assert TEngine(eng1.prepared_params, TCFG, TConfig(**BASE, tp=2),
                       device="cpu").stats()["tp_degree"] == 2

    def test_supervisor_rebuild_reuses_tp_params(self, params, prompts,
                                                 oracle):
        """A crashed TP replica rebuilds on the dead engine's sharded
        params: streams exact, the weight shards' storage unchanged."""
        sup = EngineSupervisor(params, TCFG, TConfig(**BASE, tp=2),
                               device="cpu")
        lay = sup.engine.prepared_params["layers"]
        before = [t.data_ptr() for n in ("wq", "wk", "wv") for t in lay[n]]
        rids = [sup.submit(p, max_new_tokens=10, eos_token_id=None)
                for p in prompts]
        engine_crash(sup, at_step=1)
        while sup.pending:
            sup.step()
        assert [list(sup.result(r)) for r in rids] == oracle
        assert sup.restarts == 1
        lay = sup.engine.prepared_params["layers"]
        assert [t.data_ptr() for n in ("wq", "wk", "wv")
                for t in lay[n]] == before
        assert sup.engine.stats()["tp_degree"] == 2


class TestTPFleet:
    def test_router_of_tp_replicas(self, params, prompts, oracle):
        """Two TP=2 replicas hold ONE sharded copy of the weights, serve
        TP=1's streams, lose nothing and hold no block at the end."""
        router = ServingRouter(params, TCFG, TConfig(**BASE, tp=2),
                               replicas=2, device="cpu")
        rids = [router.submit(p, max_new_tokens=10, eos_token_id=None)
                for p in prompts]
        while router.pending:
            router.step()
        assert [list(router.result(r)) for r in rids] == oracle
        assert router.health_snapshot()["counters"]["failed"] == 0
        for part in router.block_partitions().values():
            assert part["in_use"] == 0
        wq = [tuple(t.data_ptr() for t in
                    rep.sup.engine.prepared_params["layers"]["wq"])
              for rep in router._replicas.values()]
        assert len(wq) == 2 and len(set(wq)) == 1


class TestTPCapacityAndObservability:
    def test_pool_actually_sharded(self, eng2):
        """Every pool leaf and every q/k/v weight is a separate,
        contiguous tensor a shard at Hk/tp heads (the CUDA kernels take
        contiguous operands, never strided views)."""
        assert isinstance(eng2.cache.pool, list) and eng2.cache.tp == 2
        ptrs = set()
        for sh in eng2.cache.shards:
            for name, leaf in sh.items():
                assert leaf.shape[3] == CFG.num_key_value_heads // 2, name
                assert leaf.is_contiguous()
                ptrs.add(leaf.data_ptr())
        assert len(ptrs) == 2 * len(eng2.cache.shards[0])
        lay = eng2.prepared_params["layers"]
        D = CFG.hidden_size // CFG.num_attention_heads
        for n, heads in (("wq", 8), ("wk", 4), ("wv", 4)):
            assert len(lay[n]) == 2
            for t in lay[n]:
                assert t.is_contiguous()
                assert t.shape == (2, CFG.hidden_size, heads // 2 * D)
        assert not isinstance(lay["wo"], tuple)

    def test_block_bytes_arithmetic(self):
        full = TG.paged_pool_block_bytes(TCFG, 8)
        assert TG.paged_pool_block_bytes(TCFG, 8, tp=2) * 2 == full
        assert TG.paged_pool_block_bytes(TCFG, 8, kv_quant="int8",
                                         tp=2) * 2 == \
            TG.paged_pool_block_bytes(TCFG, 8, kv_quant="int8")

    def test_kv_bytes_per_shard(self, eng1, eng2):
        assert eng2.cache.kv_bytes() == \
            eng2.cache.kv_bytes(per_shard=True) * 2
        assert eng2.cache.kv_bytes() == eng1.cache.kv_bytes()
        assert eng1.cache.kv_bytes() == eng1.cache.kv_bytes(per_shard=True)

    def test_snapshot_fields_registered(self, eng2):
        snap, st = eng2.health_snapshot(), eng2.stats()
        for payload in (snap, st):
            assert payload["tp_degree"] == 2
            assert payload["kv_pool_shard_bytes"] * 2 == \
                payload["kv_pool_bytes"]
        for field in ("tp_degree", "kv_pool_shard_bytes"):
            assert field in HEALTH_SNAPSHOT_KEYS
        json.dumps(snap)


class TestTPStructuredErrors:
    def test_indivisible_kv_heads(self, params):
        with pytest.raises(ValueError) as e:
            mk(params, 3)
        assert "num_kv_heads" in str(e.value) and "tp=3" in str(e.value)

    def test_not_enough_devices(self, params, monkeypatch):
        """A placement never shrinks and never moves to the CPU: too few
        CUDA devices, or a device list of another length, raise."""
        with pytest.raises(ValueError, match="placement lists 3"):
            mk(params, 2, device=["cpu"] * 3)
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
        with pytest.raises(ValueError, match="needs 2 devices but the "
                                             "platform has 1"):
            TT.tp_devices(2, "cuda")
        with pytest.raises(ValueError, match="needs 4 devices"):
            TT.tp_devices(4, None)

    def test_config_rejects_nonpositive(self):
        with pytest.raises(ValueError, match=">= 1"):
            TConfig(**BASE, tp=0)
        with pytest.raises(ValueError, match=">= 1"):
            TT.tp_devices(0, "cpu")

    def test_shard_dim_spec_structured(self, tp_platform):
        """The reference's two messages, word for word; the splitter
        returns separately allocated contiguous copies."""
        mesh = tp_mesh(2)
        for shape, dim, name in (((4, 7), 1, "pool.k"),
                                 ((4, 8), 5, "pool.k_scale")):
            with pytest.raises(ValueError) as want:
                j_shard_dim_spec(shape, mesh, "tp", dim=dim, name=name)
            with pytest.raises(ValueError) as got:
                shard_dim_spec(shape, 2, "tp", dim=dim, name=name)
            assert str(got.value) == str(want.value)
        assert "'tp'" in str(got.value) or "out of range" in str(got.value)
        t = torch.arange(24.0).reshape(2, 12)
        parts = shard_tensor(t, ["cpu", "cpu"], dim=-1)
        assert all(p.is_contiguous() and p.shape == (2, 6) for p in parts)
        assert len({p.data_ptr() for p in parts} | {t.data_ptr()}) == 3
        assert torch.equal(torch.cat(parts, dim=-1), t)

    def test_pool_specs_structured(self, tp_platform):
        bad = JL.LlamaConfig(vocab_size=128, hidden_size=64,
                             intermediate_size=96, num_hidden_layers=1,
                             num_attention_heads=6, num_key_value_heads=6)
        with pytest.raises(ValueError) as want:
            JG.paged_pool_specs(JG.init_paged_pool(bad, 4, 8), tp_mesh(4))
        with pytest.raises(ValueError) as got:
            TG.init_paged_pool(config_from_jax(bad), 4, 8,
                               devices=[torch.device("cpu")] * 4)
        assert "paged_pool.k" in str(got.value)
        assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# mixed batching and LoRA at TP=2
# ---------------------------------------------------------------------------

def test_mixed_parity_tp2(params):
    """Mixed batching on and off at TP=1 and TP=2 (chunked prefill armed,
    so mid-flight prefill chunks ride the decode dispatches, on the
    reference's mixed trace): one set of streams."""
    rng = np.random.default_rng(11)
    prefix = rng.integers(0, CFG.vocab_size, (8,)).astype(np.int32)
    ps = [np.concatenate([prefix, rng.integers(0, CFG.vocab_size, (n,))
                          .astype(np.int32)]) for n in (2, 13, 5, 21, 9, 3)]
    news = (6, 4, 8, 3, 6, 5)
    sc = dict(block_size=4, max_slots=3, max_model_len=64, decode_chunk=2,
              queue_depth=16, prefill_chunk=4)
    streams = {}
    for mixed in (False, True):
        for tp in (1, 2):
            eng = TEngine(params, TCFG, TConfig(**sc, mixed_batch=mixed,
                                                tp=tp), device="cpu")
            rids = [eng.submit(p, max_new_tokens=n, eos_token_id=None)
                    for p, n in zip(ps, news)]
            while eng.pending:
                eng.step()
            streams[(mixed, tp)] = [list(eng.request(r).output())
                                    for r in rids]
            if mixed:
                assert eng.stats()["mixed_dispatches"] > 0
    assert len({tuple(map(tuple, v)) for v in streams.values()}) == 1


LORA = dict(lora_rank=4, lora_slots=2, lora_pool=4)


@pytest.fixture(scope="module")
def adapters():
    return {f"a{i}": lora_init_params(TCFG, 4, seed=i, scale=0.5)
            for i in (1, 2)}


@pytest.mark.parametrize("kv", [None, "int8"], ids=["fp32", "int8"])
@pytest.mark.parametrize("kernel", ["off", "on"], ids=["gather", "kernel"])
def test_lora_matrix_tp2(params, adapters, prompts, oracle, kv, kernel):
    """A wave mixing base rows and two adapters, greedy and seeded: TP=2
    equals TP=1. The B factors of q/k/v are column shards, the rest stays
    on the lead device."""
    outs = {}
    for tp in (1, 2):
        eng = mk(params, tp, kv_quant=kv, paged_kernel=kernel, **LORA)
        for name, a in adapters.items():
            eng.register_adapter(name, a)
        ids = [None, "a1", "a2", "a1"]
        outs[tp] = (run(eng, prompts, adapters=ids),
                    run(eng, prompts, seeded=True, adapters=ids))
        if tp == 2:
            lay = eng._lora.layers
            assert isinstance(lay["qB"], tuple) and len(lay["qB"]) == 2
            assert lay["qB"][0].shape[-1] * 2 == CFG.hidden_size
            assert not isinstance(lay["oB"], tuple)
    assert outs[2] == outs[1]
    if kv is None:
        # the adapters move the streams: the parity is not vacuous
        assert outs[1][0] != oracle


def test_lora_deeper_than_tp(prompts):
    """Three layers at tp 2 (more layers than shards, so a per-layer
    view can never be confused with a per-shard one): adapter traffic
    at TP=2 equals TP=1."""
    cfg = LlamaConfig(vocab_size=128, hidden_size=64, intermediate_size=96,
                      num_hidden_layers=3, num_attention_heads=8,
                      num_key_value_heads=4, max_position_embeddings=128)
    p = init_params(cfg, seed=3, device="cpu")
    ad = {f"a{i}": lora_init_params(cfg, 4, seed=i, scale=0.5)
          for i in (1, 2)}
    outs = []
    for tp in (1, 2):
        eng = TEngine(p, cfg, TConfig(**BASE, **LORA, tp=tp), device="cpu")
        for name, a in ad.items():
            eng.register_adapter(name, a)
        outs.append(run(eng, prompts, seeded=True,
                        adapters=["a1", None, "a2", "a1"]))
    assert outs[1] == outs[0]


# ---------------------------------------------------------------------------
# the port's own: the offload tier, migration, the layout key, the replay
# ---------------------------------------------------------------------------

TIER = dict(block_size=4, max_slots=2, max_model_len=32, decode_chunk=2,
            queue_depth=64, num_blocks=12, prefix_cache=True, offload=True,
            offload_blocks=32)


def tier_trace(seed, fams=3, per=2):
    rng = np.random.default_rng(seed)
    pres = [rng.integers(0, CFG.vocab_size, (12,)).astype(np.int32)
            for _ in range(fams)]
    return [np.concatenate([p, rng.integers(0, CFG.vocab_size, (3,))
                            .astype(np.int32)]) for p in pres
            for _ in range(per)]


def test_offload_tier_tp2_equals_tp1(params):
    """Churn a device pool through the host tier, revisit: TP=2 streams,
    tier counters and the host copies' bytes (global layout, heads in
    order) equal TP=1's; a corrupted host block is still a counted miss
    that recomputes."""
    prompts = tier_trace(7)
    got = {}
    for tp in (1, 2):
        for corrupt in (False, True):
            eng = TEngine(params, TCFG, TConfig(**TIER, tp=tp),
                          device="cpu")
            outs = run(eng, prompts, 4)
            eng.cache.offload.flush()
            host = {k: {n: t.clone() for n, t in e["data"].items()}
                    for k, e in eng.cache.offload._entries.items()}
            if corrupt:
                eng.cache.offload.corrupt_one(1)
            outs += run(eng, prompts[:2], 4)
            st = eng.stats()
            got[(tp, corrupt)] = (outs, st["offload"],
                                  st["prefix_hit_tokens"])
            if not corrupt:
                got[(tp, "host")] = host
    for corrupt in (False, True):
        assert got[(2, corrupt)] == got[(1, corrupt)]
    assert got[(1, False)][1]["tier_hits"] > 0
    assert got[(2, True)][1]["corrupt_drops"] == 1
    # the corrupt block and the chain behind it recompute: fewer hits
    assert got[(2, True)][2] < got[(2, False)][2]
    h1, h2 = got[(1, "host")], got[(2, "host")]
    assert h1.keys() == h2.keys() and h1
    for k in h1:
        for n in h1[k]:
            assert h2[k][n].shape == h1[k][n].shape
            assert torch.equal(h2[k][n], h1[k][n]), n


@pytest.mark.parametrize("kvq", [None, "int8"])
def test_migration_between_tp2_engines(params, prompts, kvq):
    """Requests serialized mid-decode on one TP=2 engine and adopted by
    another finish with the unmoved stream; the payload's KV is the
    global layout, byte-equal to a TP=1 engine's at the same point."""
    want = run(mk(params, 1, kv_quant=kvq), prompts, 7)
    payloads = {}
    for tp in (1, 2):
        a, b = mk(params, tp, kv_quant=kvq), mk(params, tp, kv_quant=kvq)
        rids = [a.submit(p, max_new_tokens=7, eos_token_id=None)
                for p in prompts]
        got, after = {}, {}
        for _ in range(2):
            for rid, toks in a.step(1).items():
                got.setdefault(rid, []).extend(int(t) for t in toks)
        payloads[tp] = [a.serialize_request(r) for r in rids]
        moved = {}
        for r, p in zip(rids, payloads[tp]):
            moved[r] = b.adopt(p)
            a.cancel(r)
        while b.pending:
            for rid, toks in b.step(1).items():
                after.setdefault(rid, []).extend(int(t) for t in toks)
        streams = [got.get(r, []) + after.get(moved[r], []) for r in rids]
        assert streams == want
        assert b.stats()["recomputed_tokens"] == 0
        assert a.cache.manager.blocks_in_use == 0
        assert b.cache.manager.blocks_in_use == 0
    for p1, p2 in zip(payloads[1], payloads[2]):
        d1, d2 = p1["kv"]["data"], p2["kv"]["data"]
        assert d1.keys() == d2.keys()
        for n in d1:
            assert torch.equal(d1[n], d2[n]), n


def test_kv_shape_key_refuses_tp_mismatch(params, prompts, eng1, eng2):
    """A TP=1 engine refuses a TP=2 payload (and the reverse), migration
    and chain graft alike: the key carries tp beside the global leaf
    shapes, which are equal."""
    assert eng1.kv_shape_key()[3] == eng2.kv_shape_key()[3]
    assert eng1.kv_shape_key()[2] == 1 and eng2.kv_shape_key()[2] == 2
    for src, dst in ((mk(eng2.prepared_params, 2),
                      mk(eng1.prepared_params, 1)),
                     (mk(eng1.prepared_params, 1),
                      mk(eng2.prepared_params, 2))):
        rid = src.submit(prompts[1], max_new_tokens=6, eos_token_id=None)
        src.step(1)
        payload = src.serialize_request(rid)
        with pytest.raises(AdoptError, match="layout mismatch"):
            dst.adopt(payload)
        chain = list(prefix_block_chain(prompts[1], BASE["block_size"],
                                        len(prompts[1])))
        exported = src.export_chain(chain)
        assert exported is not None
        with pytest.raises(AdoptError, match="layout mismatch"):
            dst.graft_chain(exported)
        src.cancel(rid)


def test_replay_chips_count_distinct_devices(params):
    """``chips`` counts the distinct devices any shard of any replica
    holds: two TP=2 replicas with every shard on the CPU are one chip,
    and a TP=2 replay serves TP=1's streams."""
    spec = TW.WorkloadSpec(requests=24, seed=5, prefix_len=8,
                           tail_lens=(2, 3, 4), output_lens=(3, 4, 6),
                           horizon_steps=16, autoscale_every=0,
                           audit_every=4)
    reps = {}
    for tp in (1, 2):
        reps[tp] = TW.run_replay(
            params, TCFG, spec=spec, chaos=None, replicas=2,
            serving_config=TConfig(**BASE, tp=tp), record_streams=True,
            hbm_gb=16.0, device="cpu")
    assert reps[2]["tp"] == 2
    assert reps[2]["chips"] == reps[1]["chips"] == 1.0
    assert reps[2]["streams"] == reps[1]["streams"]
    assert reps[2]["outcomes"] == reps[1]["outcomes"]


# ---------------------------------------------------------------------------
# the port's TP=2 against the JAX package's TP=2 engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jeng2(tp_platform, jparams):
    return JEngine(jparams, CFG, JConfig(**BASE, tp=2, paged_kernel=False))


@pytest.mark.parametrize("seeded", [False, True], ids=["greedy", "seeded"])
def test_streams_equal_jax_tp2(tp_platform, jeng2, eng2, prompts, seeded):
    """The same weights, wave and seeds through the JAX TP=2 engine (its
    shard_map programs on two virtual host devices) and the port's TP=2
    engine: equal token streams (tolerance: none)."""
    want = [list(map(int, s)) for s in run(jeng2, prompts, seeded=seeded)]
    assert run(eng2, prompts, seeded=seeded) == want


def test_int8_streams_equal_jax_tp2(tp_platform, jparams, params, prompts):
    """int8 weights and an int8 KV pool at TP=2: the JAX engine and the
    port's give equal greedy streams (tolerance: none)."""
    kw = dict(quantize="int8", kv_quant="int8", paged_kernel=False)
    j = JEngine(jparams, CFG, JConfig(**BASE, tp=2, **kw))
    want = [list(map(int, s)) for s in run(j, prompts)]
    assert run(mk(params, 2, **kw), prompts) == want


def test_init_paged_pool_shards_equal_the_global_pool():
    """The per-shard pool allocation and the weight splitter agree with
    the global layout: concatenating the shards on the heads axis gives
    the single-device shapes."""
    cfg = LlamaConfig(vocab_size=32, hidden_size=32, intermediate_size=48,
                      num_hidden_layers=1, num_attention_heads=4,
                      num_key_value_heads=2)
    full = TG.init_paged_pool(cfg, 3, 4, kv_quant="int8", device="cpu")
    shards = TG.init_paged_pool(cfg, 3, 4, kv_quant="int8",
                                devices=[torch.device("cpu")] * 2)
    for name, leaf in full.items():
        assert torch.cat([s[name] for s in shards], dim=3).shape == \
            leaf.shape
    p = {"layers": {"wq": torch.randn(1, 32, 32), "wo": torch.randn(1, 32,
                                                                    32)}}
    sp = shard_serving_params(p, [torch.device("cpu")] * 2)
    assert torch.equal(torch.cat(sp["layers"]["wq"], dim=-1),
                       p["layers"]["wq"])
    assert sp["layers"]["wo"] is p["layers"]["wo"]

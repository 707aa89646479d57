"""The port's fleet cache directory and disaggregated prefill against the
JAX package's.

Mirrors ``tests/test_fleet_cache.py`` on both packages with the same
weights and traces, and holds the port's router to the JAX router's:

* **Pull and handoff parity** — a request pinned to a replica that does
  NOT hold its prefix chain pulls the blocks cross-replica (CRC-checked
  at both ends), and a long prompt prefills on the prefill-only replica
  and is adopted by a decode replica (``recomputed_tokens == 0``). Each
  stream equals a single-replica router's, greedy and seeded, on the
  diagonal of the (KV pool, decode path) matrix: fp with the plain
  gather path, int8 through the paged-attention kernel's wrapper (its
  plain version on the CPU). Streams and router counters equal the JAX
  fleet's.
* **Degrade to recompute** — a corrupt export and a stale directory
  entry both collapse to recompute with the stream unchanged.
* **Directory coherence fuzz** — random shared-prefix submits, eviction
  through an undersized pool and the offload tier, scale-in drains with
  migration and spawns, with the auditor after every step.
* **The prefill-aware retry hint.**
* :class:`CacheDirectory` units, held to the reference's directory on
  the same operation sequence.
"""

import random
import time
import types

import jax
import numpy as np
import pytest
import torch

import paddle_tpu.inference.serving as JV
from paddle_tpu.inference.serving.directory import CacheDirectory as JDir
from paddle_tpu.models import llama as JL

import paddle_tpu_torch.inference.serving as TV
from paddle_tpu_torch.inference.serving.directory import CacheDirectory
from paddle_tpu_torch.models.convert import config_from_jax, params_from_jax

torch.set_num_threads(2)

BASE = dict(block_size=4, max_slots=2, max_model_len=32, decode_chunk=2,
            queue_depth=8, prefix_cache=True)
JAX = types.SimpleNamespace(name="jax", V=JV)
PORT = types.SimpleNamespace(name="port", V=TV)
SAMP = dict(temperature=0.8, top_k=20, seed=5)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def setup():
    cfg = JL.LlamaConfig(vocab_size=97, hidden_size=64,
                         intermediate_size=96, num_hidden_layers=2,
                         num_attention_heads=4, num_key_value_heads=2,
                         max_position_embeddings=64)
    params = JL.init_params(cfg, jax.random.PRNGKey(0))
    return types.SimpleNamespace(
        cfg=cfg, params=params, tcfg=config_from_jax(cfg),
        tparams=params_from_jax(_np(params), device="cpu"), programs={})


def mk(s, ns, rc=None, replicas=2, **kw):
    sc = {**BASE, **kw}
    V = ns.V
    rkw = dict(router_config=V.RouterConfig(**rc) if rc is not None
               else None, replicas=None if rc is not None else replicas)
    if ns is JAX:
        key = tuple(sorted((k, str(v)) for k, v in kw.items()
                           if k not in ("num_blocks", "queue_depth",
                                        "offload", "offload_blocks")))
        r = V.ServingRouter(s.params, s.cfg, V.ServingConfig(**sc),
                            programs=s.programs.get(key), **rkw)
        s.programs.setdefault(key, r._programs)
        return r
    return V.ServingRouter(s.tparams, s.tcfg, V.ServingConfig(**sc),
                           device="cpu", **rkw)


def both(scenario, s, *args, **kw):
    want = scenario(s, JAX, *args, **kw)
    got = scenario(s, PORT, *args, **kw)
    assert got == want
    return got


def drain(r, n=None, cap=400):
    steps = 0
    while r.pending:
        r.step(n)
        steps += 1
        assert steps < cap


def quiesced(r):
    return sum(p["in_use"] for p in r.block_partitions().values())


def res(r, f):
    return [int(t) for t in r.result(f)]


def recomputed(r):
    return sum(rep.sup.engine.stats()["recomputed_tokens"]
               for rep in r._replicas.values())


class TestPullHandoffParity:
    @pytest.mark.parametrize("kvq,kern", [
        pytest.param(None, False, id="fp-gather"),
        pytest.param("int8", True, id="int8-kernel")])
    def test_pull_and_handoff_match_single_replica(self, setup, kvq, kern):
        def run(s, ns):
            rng = np.random.default_rng(17)
            sc = dict(kv_quant=kvq, paged_kernel=kern, prefill_chunk=4)
            prefixes = [rng.integers(0, 97, (12,)).astype(np.int32)
                        for _ in range(2)]

            def tailed(fam, n):
                return np.concatenate([prefixes[fam],
                                       rng.integers(0, 97, (n,))
                                       .astype(np.int32)])

            place = [tailed(0, 2), tailed(1, 3)]
            pulls = [tailed(0, 3), tailed(1, 2)]
            longs = [rng.integers(0, 97, (16,)).astype(np.int32)
                     for _ in range(2)]
            oracle = mk(s, ns, replicas=1, **sc)
            want = {}
            for name, p, kw, n in (("pull0", pulls[0], {}, 4),
                                   ("pull1", pulls[1], SAMP, 4),
                                   ("long0", longs[0], {}, 6),
                                   ("long1", longs[1], SAMP, 6)):
                f = oracle.submit(p, max_new_tokens=n, eos_token_id=None,
                                  **kw)
                drain(oracle)
                want[name] = res(oracle, f)

            fleet = mk(s, ns, rc=dict(replicas=2), **sc)
            r0, r1 = fleet.replicas
            for p in place:
                fleet.submit(p, max_new_tokens=2, eos_token_id=None,
                             replica=r0)
                drain(fleet)
            f0 = fleet.submit(pulls[0], max_new_tokens=4, eos_token_id=None,
                              replica=r1)
            drain(fleet)
            f1 = fleet.submit(pulls[1], max_new_tokens=4, eos_token_id=None,
                              replica=r1, **SAMP)
            drain(fleet)
            pull_c = dict(fleet.health_snapshot()["counters"])
            assert [res(fleet, f0), res(fleet, f1)] == \
                [want["pull0"], want["pull1"]]
            assert quiesced(fleet) == 0
            ns.V.InvariantAuditor().check(fleet)

            disagg = mk(s, ns, rc=dict(replicas=1, prefill_replicas=1,
                                       prefill_len_threshold=8), **sc)
            g0 = disagg.submit(longs[0], max_new_tokens=6,
                               eos_token_id=None)
            drain(disagg, 1)
            g1 = disagg.submit(longs[1], max_new_tokens=6,
                               eos_token_id=None, **SAMP)
            drain(disagg, 1)
            roles = [disagg._replicas[disagg.request(g).replica].role
                     for g in (g0, g1)]
            assert [res(disagg, g0), res(disagg, g1)] == \
                [want["long0"], want["long1"]]
            assert quiesced(disagg) == 0
            ns.V.InvariantAuditor().check(disagg)
            return (want, pull_c,
                    dict(disagg.health_snapshot()["counters"]), roles,
                    recomputed(disagg))

        _, pull_c, dis_c, roles, rc = both(run, setup)
        assert pull_c["cache_pulls"] >= 2 and pull_c["pulled_blocks"] >= 6
        assert pull_c["pull_fallbacks"] == 0
        assert dis_c["prefill_routed"] == 2
        assert dis_c["prefill_handoffs"] == 2 and dis_c["failed"] == 0
        assert roles == ["decode", "decode"] and rc == 0


class TestPullDegradesToRecompute:
    def _two(self, s, ns, seed):
        rng = np.random.default_rng(seed)
        prefix = rng.integers(0, 97, (12,)).astype(np.int32)
        a = np.concatenate([prefix, rng.integers(0, 97, (2,))
                            .astype(np.int32)])
        b = np.concatenate([prefix, rng.integers(0, 97, (3,))
                            .astype(np.int32)])
        fleet = mk(s, ns, rc=dict(replicas=2))
        r0, _ = fleet.replicas
        fleet.submit(a, max_new_tokens=2, eos_token_id=None, replica=r0)
        drain(fleet)
        return fleet, prefix, b, rng

    def test_corrupt_export_falls_back_bit_exact(self, setup):
        def run(s, ns):
            fleet, _, b, _ = self._two(s, ns, 23)
            r0, r1 = fleet.replicas
            fleet._replicas[r0].sup.engine._corrupt_next_export = True
            f = fleet.submit(b, max_new_tokens=4, eos_token_id=None,
                             replica=r1)
            drain(fleet)
            ref = mk(s, ns, replicas=1)
            g = ref.submit(b, max_new_tokens=4, eos_token_id=None)
            drain(ref)
            return (dict(fleet.health_snapshot()["counters"]), res(fleet, f),
                    res(ref, g), quiesced(fleet))

        c, out, want, q = both(run, setup)
        assert c["pull_fallbacks"] == 1 and c["pulled_blocks"] == 0
        assert c["failed"] == 0 and out == want and q == 0

    def test_stale_entry_is_a_benign_miss(self, setup):
        def run(s, ns):
            fleet, prefix, b, rng = self._two(s, ns, 29)
            r0, r1 = fleet.replicas
            mgr = fleet._replicas[r0].sup.engine.cache.manager
            for key in list(mgr._hash2block):
                blk = mgr._hash2block.pop(key)
                mgr._block2hash.pop(blk, None)
                mgr._block_tokens.pop(blk, None)
            f = fleet.submit(b, max_new_tokens=4, eos_token_id=None,
                             replica=r1)
            drain(fleet)
            c1 = dict(fleet.health_snapshot()["counters"])
            c = np.concatenate([prefix, rng.integers(0, 97, (2,))
                                .astype(np.int32)])
            fleet.submit(c, max_new_tokens=2, eos_token_id=None, replica=r1)
            drain(fleet)
            return c1, dict(fleet.health_snapshot()["counters"]), \
                res(fleet, f)

        c1, c2, _ = both(run, setup)
        assert c1["pull_fallbacks"] >= 1 and c1["failed"] == 0
        assert c2["pull_fallbacks"] == c1["pull_fallbacks"]
        assert c2["cache_pulls"] == c1["cache_pulls"]


class TestDirectoryCoherenceFuzz:
    def test_randomized_churn_keeps_directory_coherent(self, setup):
        def run(s, ns):
            fleet = mk(s, ns, rc=dict(replicas=2, max_replicas=4,
                                      migrate=True),
                       num_blocks=10, offload=True, offload_blocks=16)
            auditor = ns.V.InvariantAuditor()
            rng = np.random.default_rng(31)
            pyrng = random.Random(31)
            prefixes = [rng.integers(0, 97, (8,)).astype(np.int32)
                        for _ in range(3)]
            live, dirs = [], []
            for _ in range(40):
                op = pyrng.random()
                rids = fleet.replicas
                if op < 0.45:
                    fam = pyrng.randrange(len(prefixes))
                    p = np.concatenate([prefixes[fam],
                                        rng.integers(0, 97, (3,))
                                        .astype(np.int32)])
                    pin = pyrng.choice(rids + [None])
                    try:
                        live.append(fleet.submit(
                            p, max_new_tokens=2, eos_token_id=None,
                            replica=pin))
                    except (ns.V.ServingUnavailable,
                            ns.V.ServingQueueFull):
                        live.append(None)
                elif op < 0.55 and len(rids) > 2:
                    fleet.drain_replica(pyrng.choice(rids))
                elif op < 0.65 and len(rids) < 4:
                    fleet.spawn_replica()
                fleet.step()
                auditor.check(fleet)
                dirs.append(fleet._directory.snapshot()["entries"])
            drain(fleet)
            auditor.check(fleet)
            snap = fleet.health_snapshot()
            assert quiesced(fleet) == 0
            return (dict(snap["counters"]), dirs,
                    [None if f is None else res(fleet, f) for f in live])

        c, _, _ = both(run, setup)
        assert c["failed"] == 0
        assert c["cache_pulls"] + c["pull_fallbacks"] >= 1


class TestPrefillAwareRetryAfter:
    def test_hint_scales_with_prefill_backlog(self, setup):
        eng = TV.ServingEngine(setup.tparams, setup.tcfg,
                               TV.ServingConfig(**BASE), device="cpu")
        sched = eng._sched
        t = time.time()
        sched._finish_times.extend([t, t + 0.1, t + 0.2])
        assert sched.retry_after_s() == pytest.approx(0.1, abs=1e-3)
        for _ in range(5):
            sched.queue.append(types.SimpleNamespace(prefilling=False))
        assert sched.prefill_queue_depth == 5
        assert sched.retry_after_s() == pytest.approx(0.5, abs=1e-3)

    def test_router_hint_binds_to_saturated_prefill_pool(self, setup):
        fleet = mk(setup, PORT, rc=dict(replicas=1, prefill_replicas=1,
                                        prefill_len_threshold=8))
        pre = next(r for r in fleet._replicas.values()
                   if r.role == "prefill")
        sched = pre.sup.engine._sched
        t = time.time()
        sched._finish_times.extend([t, t + 0.05, t + 0.1])
        for _ in range(8):
            sched.queue.append(types.SimpleNamespace(prefilling=False))
        pre.routable = lambda: False
        assert fleet._retry_after() == pytest.approx(0.4, abs=1e-3)
        pre.routable = lambda: True
        assert fleet._retry_after() != pytest.approx(0.4, abs=1e-3)


class TestCacheDirectory:
    def test_ops_match_reference(self):
        """A random operation sequence gives the reference directory's
        lookups, holders, snapshots and consistency verdicts."""
        rng = random.Random(7)
        dirs = [JDir(max_entries=12), CacheDirectory(max_entries=12)]
        for _ in range(400):
            op = rng.random()
            rid, key = rng.randrange(3), rng.randrange(20)
            for d in dirs:
                if op < 0.5:
                    d.add(rid, key)
                elif op < 0.8:
                    d.drop(rid, key)
                elif op < 0.85:
                    d.drop_replica(rid)
            chain = [rng.randrange(20) for _ in range(4)]
            views = [(d.longest(chain), d.holders(key), d.entries,
                      d.replica_keys(rid), d.items(), d.snapshot(),
                      d.check_consistency()) for d in dirs]
            assert views[0] == views[1]
            assert views[1][-1] == []
        assert dirs[1].snapshot()["evicted"] > 0

    def test_longest_needs_contiguity_and_breaks_ties_low(self):
        d = CacheDirectory()
        for k in (1, 2, 3):
            d.add(5, k)
        d.add(2, 1)
        d.add(2, 3)                     # holds a middle gap: depth 1 only
        assert d.longest([1, 2, 3]) == (5, 3)
        assert d.longest([1]) == (2, 1)
        assert d.longest([9, 1]) == (None, 0)
        assert d.drop_replica(5) == 3
        assert d.longest([1, 2, 3]) == (2, 1)

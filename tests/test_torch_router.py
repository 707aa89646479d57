"""The port's serving fleet router against the JAX package's.

Every scenario runs twice — once on the JAX ``ServingRouter`` and once on
the port's, with the same weights, config, trace, seed and fault — and
what each run observes must be equal: delivered token streams (per step
and final), the replica each request ended on, and the router counters.
P2C draws from ``random.Random(RouterConfig.seed)`` in both, so the
placements match too. Where a scenario depends on wall-clock time (a
hedge delay, a breaker cooldown) the streams are compared and the
reference's own assertions run on both.

Mirrors ``tests/test_router.py``: routing (P2C, affinity, directory
hits), failover, circuit breakers, hedging, rolling restarts, autoscale,
the snapshot registry, the failover fuzz (three trials), the review
regressions, sampled failover and live migration. The JAX package's
chaos injectors (``replica_kill``, ``slow_replica``, ``flaky_probe``,
``engine_crash``) drive the port's router unchanged: they reach the same
attribute names.
"""

import json
import os
import time
import types

import jax
import numpy as np
import pytest
import torch

import paddle_tpu.inference.serving as JV
from paddle_tpu.distributed.launch.main import (read_rejoin_count,
                                                write_rejoin_file)
from paddle_tpu.models import llama as JL
from paddle_tpu.testing import chaos

import paddle_tpu_torch.inference.serving as TV
from paddle_tpu_torch.inference.serving.supervisor import (
    consume_rejoin_file as t_consume_rejoin_file)
from paddle_tpu_torch.inference.serving.supervisor import (
    write_rejoin_file as t_write_rejoin_file)
from paddle_tpu_torch.models.convert import config_from_jax, params_from_jax

torch.set_num_threads(2)

BASE = dict(block_size=4, max_slots=2, max_model_len=32, decode_chunk=2,
            queue_depth=8)
JAX = types.SimpleNamespace(name="jax", V=JV)
PORT = types.SimpleNamespace(name="port", V=TV)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def setup():
    cfg = JL.LlamaConfig(vocab_size=97, hidden_size=64,
                         intermediate_size=96, num_hidden_layers=2,
                         num_attention_heads=4, num_key_value_heads=2,
                         max_position_embeddings=64)
    params = JL.init_params(cfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 97, (s,)).astype(np.int32)
               for s in [9, 5, 12, 7]]
    donor = JV.ServingRouter(params, cfg, JV.ServingConfig(**BASE),
                             replicas=1)
    donor.run(prompts[:2], max_new_tokens=[2] * 2, eos_token_id=None)
    return types.SimpleNamespace(
        cfg=cfg, params=params, tcfg=config_from_jax(cfg),
        tparams=params_from_jax(_np(params), device="cpu"),
        prompts=prompts, programs={(4, 2, 32): donor._programs})


def mk(s, ns, replicas=2, rc=None, **sc_kw):
    """A router of either package at BASE (+ overrides). ``rc`` is the
    RouterConfig's keyword arguments. JAX routers share compiled programs
    per (block_size, max_slots, max_model_len), as the reference's tests
    do."""
    sc = {**BASE, **sc_kw}
    V = ns.V
    rkw = dict(router_config=V.RouterConfig(**rc) if rc is not None
               else None, replicas=None if rc is not None else replicas)
    if ns is JAX:
        key = (sc["block_size"], sc["max_slots"], sc["max_model_len"])
        r = V.ServingRouter(s.params, s.cfg, V.ServingConfig(**sc),
                            programs=s.programs.get(key), **rkw)
        s.programs.setdefault(key, r._programs)
        return r
    return V.ServingRouter(s.tparams, s.tcfg, V.ServingConfig(**sc),
                           device="cpu", **rkw)


def both(scenario, s, *args, **kw):
    """Run ``scenario(s, ns, ...)`` on the JAX package and on the port;
    the two observations must be equal. Returns the port's."""
    want = scenario(s, JAX, *args, **kw)
    got = scenario(s, PORT, *args, **kw)
    assert got == want
    return got


def res(r, frids):
    return [[int(t) for t in r.result(f)] for f in frids]


def homes(r, frids):
    return [r.request(f).replica for f in frids]


def counters(r, *drop):
    c = dict(r.health_snapshot()["counters"])
    for k in drop:
        c.pop(k)
    return c


def drain(r, n=None, cap=400):
    steps = 0
    out = {}
    while r.pending or r.rolling:
        for f, toks in r.step(n).items():
            out.setdefault(f, []).extend(int(t) for t in toks)
        steps += 1
        assert steps < cap, "fleet did not drain"
    return out


def audit(ns, r, auditor=None):
    """The fleet invariants through the package's own auditor (raises a
    named InvariantViolation)."""
    (auditor if auditor is not None else ns.V.InvariantAuditor()).check(r)


def balanced(ns, r, auditor=None):
    audit(ns, r, auditor)
    parts = r.block_partitions()
    assert all(p["in_use"] == 0 for p in parts.values()), parts
    return parts


# ---------------------------------------------------------------------------
# routing: health-probed picks, P2C load balance, affinity stickiness
# ---------------------------------------------------------------------------

class TestRouting:
    def test_fleet_parity(self, setup):
        def run(s, ns):
            r = mk(s, ns, replicas=3)
            outs = r.run(s.prompts, max_new_tokens=8, eos_token_id=None)
            frids = sorted(r._reqs)
            balanced(ns, r)
            admitted = [rep.sup.engine.stats()["admitted"]
                        for rep in r._replicas.values()]
            return ([[int(t) for t in o] for o in outs], homes(r, frids),
                    counters(r), admitted)

        outs, _, _, admitted = both(run, setup)
        assert sum(1 for a in admitted if a) >= 2, admitted
        assert all(len(o) == 8 for o in outs)

    def test_weights_held_once(self, setup):
        """Every replica, a spawn and a roll's rebuild hold the first
        engine's prepared weights: the same tensors, not copies."""
        r = mk(setup, PORT, replicas=2)
        r.spawn_replica()
        ptrs = {rid: rep.sup.engine.prepared_params["layers"]["wq"]
                .data_ptr() for rid, rep in r._replicas.items()}
        assert len(set(ptrs.values())) == 1
        assert r.rolling_restart() == 3
        assert {rep.sup.engine.prepared_params["layers"]["wq"].data_ptr()
                for rep in r._replicas.values()} == set(ptrs.values())

    def test_prefix_affinity_sticks_to_cache_holder(self, setup):
        def run(s, ns):
            r = mk(s, ns, replicas=2)
            rng = np.random.default_rng(3)
            prefix = rng.integers(0, 97, (8,)).astype(np.int32)
            wave = [np.concatenate([prefix, rng.integers(0, 97, (3,))
                                    .astype(np.int32)]) for _ in range(4)]
            frids = []
            for p in wave:
                frids.append(r.submit(p, max_new_tokens=2,
                                      eos_token_id=None))
                drain(r)
            home = r._replicas[r.request(frids[0]).replica]
            return (res(r, frids), homes(r, frids), counters(r),
                    home.sup.engine.stats()["prefix_hit_tokens"])

        _, hs, c, hit = both(run, setup)
        assert len(set(hs)) == 1 and c["sticky_hits"] >= 3 and hit > 0

    def test_shared_chain_lands_on_directory_holder(self, setup):
        def run(s, ns):
            r = mk(s, ns, replicas=2)
            rng = np.random.default_rng(11)
            prefix = rng.integers(0, 97, (12,)).astype(np.int32)
            a = np.concatenate([prefix,
                                rng.integers(0, 97, (2,)).astype(np.int32)])
            b = np.concatenate([prefix,
                                rng.integers(0, 97, (3,)).astype(np.int32)])
            fa = r.submit(a, max_new_tokens=2, eos_token_id=None)
            drain(r)
            r._affinity.clear()           # the first-block map can't help
            fb = r.submit(b, max_new_tokens=2, eos_token_id=None)
            drain(r)
            home = r._replicas[r.request(fb).replica]
            balanced(ns, r)
            return (res(r, [fa, fb]), homes(r, [fa, fb]), counters(r),
                    home.sup.engine.stats()["prefix_hit_tokens"])

        _, hs, c, hit = both(run, setup)
        assert hs[0] == hs[1] and c["directory_hits"] >= 1 and hit >= 12

    def test_p2c_prefers_shallower_replica(self, setup):
        def run(s, ns):
            r = mk(s, ns, replicas=2, queue_depth=16)
            rid0, rid1 = r.replicas
            for _ in range(6):
                r.submit(s.prompts[0], max_new_tokens=8, eos_token_id=None,
                         replica=rid0)
            frid = r.submit(s.prompts[1], max_new_tokens=2,
                            eos_token_id=None)
            drain(r)
            balanced(ns, r)
            return r.request(frid).replica, res(r, sorted(r._reqs))

        assert both(run, setup)[0] == 1

    def test_no_replica_raises_structured_503(self, setup):
        def run(s, ns):
            r = mk(s, ns, replicas=2)
            for rid in list(r.replicas):
                chaos.replica_kill(r, rid=rid)
            r.step()
            r.step()
            with pytest.raises(ns.V.ServingUnavailable) as ei:
                r.submit(s.prompts[0], max_new_tokens=2, eos_token_id=None)
            snap = r.health_snapshot()
            return (ei.value.reason, snap["accepting"],
                    snap["supervisor"]["broken"])

        assert both(run, setup) == ("no_replica", False, True)


# ---------------------------------------------------------------------------
# failover: replica death mid-stream
# ---------------------------------------------------------------------------

class TestFailover:
    def test_replica_kill_mid_stream_no_repeats(self, setup):
        def run(s, ns):
            r = mk(s, ns, replicas=2)
            frids = [r.submit(p, max_new_tokens=8, eos_token_id=None)
                     for p in s.prompts]
            delivered = {f: [] for f in frids}
            steps = []
            for f, toks in r.step(2).items():
                delivered[f].extend(int(t) for t in toks)
            victim = chaos.replica_kill(r, rid=r.replicas[0])
            n = 0
            while r.pending and n < 300:
                out = r.step(2)
                steps.append({f: [int(t) for t in v]
                              for f, v in out.items()})
                for f, toks in out.items():
                    delivered[f].extend(int(t) for t in toks)
                audit(ns, r)
                n += 1
            snap = r.health_snapshot()
            assert delivered == {f: [int(t) for t in r.result(f)]
                                 for f in frids}
            balanced(ns, r)
            return (steps, res(r, frids), homes(r, frids), counters(r),
                    snap["replicas"][str(victim)]["broken"], snap["ok"],
                    snap["accepting"])

        _, outs, _, c, broken, ok, acc = both(run, setup)
        assert c["failovers"] >= 1 and c["failed"] == 0
        assert broken and ok and acc
        assert all(len(o) == 8 for o in outs)

    def test_failover_request_finished_by_delivered_tokens(self, setup):
        def run(s, ns):
            r = mk(s, ns, replicas=2)
            frid = r.submit(s.prompts[1], max_new_tokens=2,
                            eos_token_id=None, replica=r.replicas[0])
            got = []
            steps = 0
            while len(got) < 2 and steps < 50:
                got += [int(t) for t in r.step(1).get(frid, [])]
                steps += 1
            if not r.request(frid).terminal:
                chaos.replica_kill(r, rid=r.replicas[0])
                drain(r)
            return got, r.request(frid).state, res(r, [frid])

        got, state, out = both(run, setup)
        assert state == "finished" and out == [got]


# ---------------------------------------------------------------------------
# circuit breaker: open -> half-open probe -> rejoin
# ---------------------------------------------------------------------------

class TestCircuitBreaker:
    def test_flaky_probe_opens_half_open_reprobes_rejoins(self, setup):
        def run(s, ns):
            r = mk(s, ns, replicas=2)
            rid0 = r.replicas[0]
            rep0 = r._replicas[rid0]
            rep0.breaker.cooldown_s = 60.0
            st = chaos.flaky_probe(r, rid=rid0, fails=3)
            hs = []
            for _ in range(4):
                f = r.submit(s.prompts[0], max_new_tokens=2,
                             eos_token_id=None)
                hs.append(r.request(f).replica)
                drain(r)
            assert rep0.breaker.state == "open"
            with pytest.raises(ns.V.ServingUnavailable):
                r.submit(s.prompts[0], max_new_tokens=2, eos_token_id=None,
                         replica=rid0)
            snap = r.health_snapshot()
            opened = dict(snap["replicas"][str(rid0)]["breaker"])
            rep0.breaker.cooldown_s = 0.05
            time.sleep(0.07)
            r.submit(s.prompts[0], max_new_tokens=2, eos_token_id=None)
            drain(r)
            closed = rep0.breaker.snapshot()
            f = r.submit(s.prompts[2], max_new_tokens=3, eos_token_id=None,
                         replica=rid0)
            drain(r)
            return (hs, opened, snap["counters"]["probe_failures"],
                    closed, res(r, [f]), st["calls"])

        hs, opened, pf, closed, _, calls = both(run, setup)
        assert all(h != 0 for h in hs)
        assert opened["state"] == "open" and opened["opens"] >= 1
        assert pf >= 3 and calls == 3
        assert closed["state"] == "closed"
        assert closed["half_open_probes"] >= 1 and closed["reclosures"] >= 1

    def test_half_open_failure_reopens(self, setup):
        def run(s, ns):
            r = mk(s, ns, replicas=2)
            rep0 = r._replicas[r.replicas[0]]
            rep0.breaker.cooldown_s = 0.05
            chaos.flaky_probe(r, rid=rep0.rid, fails=100)
            for _ in range(3):
                r.submit(s.prompts[0], max_new_tokens=2, eos_token_id=None)
                drain(r)
            state0, opens0 = rep0.breaker.state, rep0.breaker.opens
            time.sleep(0.07)
            r.submit(s.prompts[0], max_new_tokens=2, eos_token_id=None)
            drain(r)
            b = rep0.breaker.snapshot()
            return (state0, b["state"], b["opens"] > opens0,
                    b["half_open_probes"] >= 1)

        assert both(run, setup) == ("open", "open", True, True)

    def test_crash_loop_opens_breaker_and_evacuates(self, setup):
        def run(s, ns):
            r = mk(s, ns, replicas=2)
            rid0 = r.replicas[0]
            sup0 = r._replicas[rid0].sup
            sup0.max_restarts = 10
            frid = r.submit(s.prompts[0], max_new_tokens=6,
                            eos_token_id=None, replica=rid0)
            r.step(1)
            for _ in range(r.config.breaker_threshold):
                chaos.engine_crash(sup0, at_step=1)
                r.step(1)
            snap = r.health_snapshot()
            drain(r)
            balanced(ns, r)
            return (snap["replicas"][str(rid0)]["breaker"]["state"],
                    snap["counters"]["failovers"], res(r, [frid]),
                    homes(r, [frid]), counters(r))

        state, fo, _, _, _ = both(run, setup)
        assert state == "open" and fo >= 1


# ---------------------------------------------------------------------------
# hedged retries
# ---------------------------------------------------------------------------

class TestHedging:
    def test_slow_replica_hedges_first_token_wins_no_leak(self, setup):
        def run(s, ns):
            r = mk(s, ns, rc=dict(replicas=2, hedge_ttft_mult=2.0,
                                  ttft_slo_s=0.01, seed=1))
            chaos.slow_replica(r, rid=r.replicas[0], stall_steps=100,
                               delay_s=0.01)
            frid = r.submit(s.prompts[0], max_new_tokens=6,
                            eos_token_id=None, replica=r.replicas[0])
            delivered = []
            steps = 0
            while r.pending and steps < 300:
                delivered += [int(t) for t in r.step(2).get(frid, [])]
                steps += 1
            c = counters(r)
            balanced(ns, r)
            return (delivered, res(r, [frid]), homes(r, [frid]),
                    c["hedges"], c["hedge_wins"], c["hedges_cancelled"])

        got = both(run, setup)
        assert got[3:] == (1, 1, 1) and got[2] == [1]
        assert [got[0]] == got[1]

    def test_fast_primary_cancels_hedge(self, setup):
        def run(s, ns):
            r = mk(s, ns, rc=dict(replicas=2, hedge_ttft_mult=1.0,
                                  ttft_slo_s=0.001, seed=1),
                   queue_depth=16)
            rid0, rid1 = r.replicas
            fillers = [r.submit(s.prompts[2], max_new_tokens=20,
                                eos_token_id=None, replica=rid1)
                       for _ in range(2)]
            chaos.slow_replica(r, rid=rid0, stall_steps=1, delay_s=0.002)
            frid = r.submit(s.prompts[0], max_new_tokens=4,
                            eos_token_id=None, replica=rid0)
            time.sleep(0.005)
            delivered = []
            while r.pending:
                delivered += [int(t) for t in r.step(1).get(frid, [])]
            c = counters(r)
            balanced(ns, r)
            return (delivered, r.request(frid).replica, res(r, fillers),
                    c["hedges"], c["hedge_wins"], c["hedges_cancelled"])

        got = both(run, setup)
        assert got[1] == 0 and got[3:] == (1, 0, 1)

    def test_hedging_off_by_default(self, setup):
        def run(s, ns):
            r = mk(s, ns, replicas=2)
            assert r.config.hedge_after_s is None
            out = r.run(s.prompts[:2], max_new_tokens=2, eos_token_id=None)
            return [[int(t) for t in o] for o in out], counters(r)

        assert both(run, setup)[1]["hedges"] == 0


# ---------------------------------------------------------------------------
# rolling restarts
# ---------------------------------------------------------------------------

class TestRollingRestart:
    def test_roll_serves_live_trace_zero_failed(self, setup):
        def run(s, ns):
            r = mk(s, ns, replicas=2)
            frids = [r.submit(p, max_new_tokens=8, eos_token_id=None)
                     for p in s.prompts]
            r.start_rolling_restart()
            mid = False
            steps = 0
            while (r.pending or r.rolling) and steps < 500:
                r.step(2)
                audit(ns, r)
                if not mid and r.rolling:
                    frids.append(r.submit(s.prompts[0], max_new_tokens=4,
                                          eos_token_id=None))
                    mid = True
                steps += 1
            snap = r.health_snapshot()
            balanced(ns, r)
            return (mid, r.rolling, res(r, frids), homes(r, frids),
                    counters(r),
                    sorted(x["generation"]
                           for x in snap["replicas"].values()),
                    [r.request(f).state for f in frids])

        mid, rolling, _, _, c, gens, states = both(run, setup)
        assert mid and not rolling and gens == [1, 1]
        assert c["replica_restarts"] == 2 and c["rolls_completed"] == 1
        assert c["failed"] == 0 and set(states) == {"finished"}

    def test_roll_deadline_fails_over_stragglers(self, setup):
        def run(s, ns):
            r = mk(s, ns, replicas=2)
            frids = [r.submit(p, max_new_tokens=8, eos_token_id=None)
                     for p in s.prompts]
            r.step(1)
            r.start_rolling_restart(drain_deadline_s=0.0)
            drain(r, 2, cap=500)
            balanced(ns, r)
            return res(r, frids), counters(r)

        _, c = both(run, setup)
        assert c["failed"] == 0 and c["replica_restarts"] == 2


# ---------------------------------------------------------------------------
# autoscale actuation + rejoin-file handshake
# ---------------------------------------------------------------------------

class TestAutoscale:
    def test_scale_up_spawns_and_writes_rejoin_file(self, setup, tmp_path):
        def run(s, ns):
            r = mk(s, ns, rc=dict(replicas=1, max_replicas=3, seed=0))
            for p in s.prompts * 2:
                r.submit(p, max_new_tokens=4, eos_token_id=None)
            path = str(tmp_path / f"rejoin-{ns.name}")
            sig = r.autoscale(rejoin_file=path, workers=2)
            n = len(r.replicas)
            drain(r)
            balanced(ns, r)
            return (sig["action"], sig.get("spawned"), n,
                    read_rejoin_count(path), res(r, sorted(r._reqs)))

        assert both(run, setup)[:4] == ("scale_up", 1, 2, 2)

    def test_scale_in_drains_least_loaded_never_below_one(self, setup):
        def run(s, ns):
            r = mk(s, ns, rc=dict(replicas=2, seed=0))
            r.run(s.prompts[:2], max_new_tokens=2, eos_token_id=None)
            sig1 = r.autoscale()
            for _ in range(5):
                r.step()
            n1 = len(r.replicas)
            sig2 = r.autoscale()
            out = r.run([s.prompts[0]], max_new_tokens=3,
                        eos_token_id=None)[0]
            return (sig1["action"], sig1.get("retiring"), n1,
                    "retiring" in sig2, len(r.replicas),
                    [int(t) for t in out])

        got = both(run, setup)
        assert got[0] == "scale_in" and got[2] == 1
        assert got[3] is False and got[4] == 1

    def test_scale_in_frees_the_retired_replica(self, setup):
        """A retired replica leaves nothing behind: not in the router's
        maps, and its engine dropped (the pool's storage freed, not left
        to a later garbage-collection pass)."""
        import weakref
        r = mk(setup, PORT, rc=dict(replicas=2, seed=0, migrate=True))
        r.run(setup.prompts[:2], max_new_tokens=2, eos_token_id=None)
        victim = r._replicas[r.replicas[0]]
        pool = weakref.ref(victim.sup.engine.cache.pool["k"])
        r.drain_replica(victim.rid)
        r.step()
        assert victim.rid not in r._replicas
        assert victim.rid not in r._routes
        assert victim.sup.engine is None and pool() is None

    def test_poll_rejoin_consumes_signal(self, setup, tmp_path):
        def run(s, ns):
            r = mk(s, ns, rc=dict(replicas=1, max_replicas=2, seed=0))
            path = str(tmp_path / f"rejoin-{ns.name}")
            (write_rejoin_file if ns is JAX else t_write_rejoin_file)(
                path, 5)
            spawned = r.poll_rejoin(path)
            return (spawned, len(r.replicas), os.path.exists(path),
                    r.poll_rejoin(path))

        assert both(run, setup) == ([1], 2, False, [])


# ---------------------------------------------------------------------------
# snapshot registry
# ---------------------------------------------------------------------------

class TestRouterSnapshot:
    def test_snapshot_pinned_to_registry_and_serializable(self, setup):
        def run(s, ns):
            r = mk(s, ns, replicas=2)
            r.run(s.prompts[:2], max_new_tokens=2, eos_token_id=None)
            snap = r.health_snapshot()
            assert set(snap) == set(ns.V.ROUTER_HEALTH_FIELDS)
            json.dumps(snap)
            return (sorted(snap), sorted(snap["counters"]),
                    sorted(snap["replicas"]["0"]), sorted(snap["fleet"]),
                    sorted(snap["directory"]))

        both(run, setup)
        assert TV.ROUTER_HEALTH_FIELDS.keys() == \
            JV.ROUTER_HEALTH_FIELDS.keys()


# ---------------------------------------------------------------------------
# randomized failover fuzz at every lifecycle point
# ---------------------------------------------------------------------------

class TestFailoverFuzz:
    @pytest.mark.parametrize("trial", range(3))
    def test_fault_at_every_lifecycle_point(self, setup, trial):
        def run(s, ns):
            rng = np.random.default_rng(100 + trial)
            r = mk(s, ns, replicas=2, num_blocks=10, prefill_chunk=4,
                   queue_depth=16)
            auditor = ns.V.InvariantAuditor()
            long_prompt = rng.integers(0, 97, (14,)).astype(np.int32)
            reqs = {}
            for i in range(6):
                p = long_prompt if i % 3 == 0 else s.prompts[i % 4]
                n = int(rng.integers(2, 9))
                reqs[r.submit(p, max_new_tokens=n, eos_token_id=None)] = \
                    [n, []]

            def pump():
                out = r.step(1)
                auditor.observe(out, lookup=r._reqs.get)
                for f, toks in out.items():
                    reqs[f][1].extend(int(t) for t in toks)
                audit(ns, r, auditor)

            for _ in range(int(rng.integers(0, 6))):
                pump()
            fault = ["kill", "slow", "flaky", "roll"][int(rng.integers(0,
                                                                       4))]
            victim = r.replicas[int(rng.integers(0, 2))]
            if fault == "kill":
                chaos.replica_kill(r, rid=victim)
            elif fault == "slow":
                chaos.slow_replica(r, rid=victim, stall_steps=3,
                                   delay_s=0.002)
            elif fault == "flaky":
                r._replicas[victim].breaker.cooldown_s = 0.02
                chaos.flaky_probe(r, rid=victim, fails=4)
            else:
                r.start_rolling_restart()
            reqs[r.submit(s.prompts[0], max_new_tokens=3,
                          eos_token_id=None)] = [3, []]
            steps = 0
            while (r.pending or r.rolling) and steps < 600:
                pump()
                steps += 1
            assert steps < 600
            assert r.health_snapshot()["counters"]["failed"] == 0
            for f, (n, delivered) in reqs.items():
                assert delivered == [int(t) for t in r.result(f)]
                assert len(delivered) == n
            auditor.quiesce(r)
            balanced(ns, r, auditor)
            return fault, {f: d for f, (_, d) in reqs.items()}

        both(run, setup)


# ---------------------------------------------------------------------------
# review regressions
# ---------------------------------------------------------------------------

class TestReviewRegressions:
    def test_terminal_records_bounded_recent_results_readable(self, setup):
        def run(s, ns):
            r = mk(s, ns, replicas=2)
            r._keep_finished = 3
            frids = []
            for i in range(6):
                frids.append(r.submit(s.prompts[i % 4], max_new_tokens=2,
                                      eos_token_id=None))
                drain(r)
            assert len(r._reqs) <= 3 + len(r._active)
            return frids[0] in r._reqs, res(r, frids[-1:])

        assert both(run, setup)[0] is False

    def test_roll_deadline_drops_hedge_copy_cleanly(self, setup):
        def run(s, ns):
            r = mk(s, ns, rc=dict(replicas=2, hedge_ttft_mult=2.0,
                                  ttft_slo_s=0.005, seed=1))
            rid0, rid1 = r.replicas
            chaos.slow_replica(r, rid=rid1, stall_steps=1000,
                               delay_s=0.002)
            frid = r.submit(s.prompts[0], max_new_tokens=4,
                            eos_token_id=None, replica=rid1)
            time.sleep(0.01)
            steps = 0
            while r.request(frid).hedge is None and steps < 50:
                r.step(1)
                steps += 1
            hedge_host = r.request(frid).hedge[0]
            r.start_rolling_restart(drain_deadline_s=0.0)
            for _ in range(3):
                r.step(1)
            dangling = r.request(frid).hedge
            chaos.replica_kill(r, rid=rid1)
            drain(r, 1)
            balanced(ns, r)
            return (hedge_host, dangling, r.request(frid).state,
                    res(r, [frid]), counters(r)["failed"])

        got = both(run, setup)
        assert got[:3] == (0, None, "finished") and got[4] == 0

    def test_fleet_wide_queue_full_sheds_429_not_503(self, setup):
        def run(s, ns):
            r = mk(s, ns, replicas=2, queue_depth=1, max_slots=1)
            for _ in range(2):
                r.submit(s.prompts[0], max_new_tokens=8, eos_token_id=None)
            with pytest.raises(ns.V.ServingQueueFull) as ei:
                r.submit(s.prompts[1], max_new_tokens=2, eos_token_id=None)
            shed = sum(rep.sup.engine.stats()["shed"]
                       for rep in r._replicas.values())
            drain(r)
            balanced(ns, r)
            return ei.value.retry_after_s is not None, shed, \
                res(r, sorted(r._reqs))

        got = both(run, setup)
        assert got[0] and got[1] >= 1

    def test_scale_in_never_drains_last_healthy_replica(self, setup):
        def run(s, ns):
            r = mk(s, ns, rc=dict(replicas=2, seed=0))
            r.run(s.prompts[:2], max_new_tokens=2, eos_token_id=None)
            chaos.replica_kill(r, rid=r.replicas[0])
            r.step()
            sig = r.autoscale()
            for _ in range(3):
                r.step()
            out = r.run([s.prompts[0]], max_new_tokens=3,
                        eos_token_id=None)[0]
            return "retiring" in sig, [int(t) for t in out]

        assert both(run, setup)[0] is False

    def test_roll_reaches_broken_replica_behind_last_routable_head(
            self, setup):
        def run(s, ns):
            r = mk(s, ns, replicas=2)
            rid0, rid1 = r.replicas
            chaos.replica_kill(r, rid=rid1)
            r.step()
            assert r._replicas[rid1].sup.broken
            n = r.rolling_restart()
            snap = r.health_snapshot()
            out = r.run([s.prompts[0]], max_new_tokens=3,
                        eos_token_id=None)[0]
            return (n, snap["counters"]["failed"],
                    snap["fleet"]["routable"], [int(t) for t in out])

        assert both(run, setup)[:3] == (2, 0, 2)

    def test_half_open_probe_bypasses_probe_cache(self, setup):
        def run(s, ns):
            r = mk(s, ns, rc=dict(replicas=2, seed=0, probe_ttl_s=60.0))
            rep0 = r._replicas[r.replicas[0]]
            r.run([s.prompts[0]], max_new_tokens=2, eos_token_id=None)
            cached = rep0.probe_cache is not None
            rep0.breaker.cooldown_s = 0.01
            st = chaos.flaky_probe(r, rid=rep0.rid, fails=100)
            rep0.breaker.trip()
            rep0.probe_cache = {"accepting": True}
            time.sleep(0.02)
            r.submit(s.prompts[0], max_new_tokens=2, eos_token_id=None)
            drain(r)
            return cached, st["calls"] >= 1, rep0.breaker.state

        assert both(run, setup) == (True, True, "open")

    def test_zero_count_rejoin_file_is_consumed(self, tmp_path):
        path = str(tmp_path / "rejoin0")
        t_write_rejoin_file(path, 0)
        assert read_rejoin_count(path) == 0
        assert t_consume_rejoin_file(path) == 0
        assert not os.path.exists(path)
        t_write_rejoin_file(path)              # empty: take what you need
        assert t_consume_rejoin_file(path) == 10 ** 9

    def test_lifetime_counters_survive_roll_and_scale_in(self, setup):
        def run(s, ns):
            r = mk(s, ns, replicas=2)
            sup0 = r._replicas[r.replicas[0]].sup
            sup0.max_restarts = 5
            r.submit(s.prompts[0], max_new_tokens=4, eos_token_id=None,
                     replica=r.replicas[0])
            chaos.engine_crash(sup0, at_step=1)
            drain(r, 1)
            r._replicas[r.replicas[1]].breaker.trip()
            before = r.health_snapshot()
            r._replicas[r.replicas[1]].breaker.record_success()
            r.rolling_restart()
            r.drain_replica(r.replicas[1])
            for _ in range(3):
                r.step()
            after = r.health_snapshot()
            return ([before["supervisor"]["restarts"],
                     before["counters"]["breaker_opens"]],
                    [after["supervisor"]["restarts"],
                     after["counters"]["breaker_opens"]], r.replicas)

        before, after, reps = both(run, setup)
        assert before[0] >= 1 and before[1] >= 1
        assert after[0] >= before[0] and after[1] >= before[1]
        assert reps == [0]


class TestSampledFailover:
    def test_replica_kill_sampled_bit_exact(self, setup):
        kw = dict(max_new_tokens=8, eos_token_id=None, temperature=0.7,
                  top_p=0.9)

        def run(s, ns):
            ref = mk(s, ns, replicas=2)
            rr = [ref.submit(p, seed=i, **kw)
                  for i, p in enumerate(s.prompts)]
            drain(ref)
            r = mk(s, ns, replicas=2)
            frids = [r.submit(p, seed=i, **kw)
                     for i, p in enumerate(s.prompts)]
            r.step(2)
            chaos.replica_kill(r, rid=r.replicas[0])
            drain(r)
            balanced(ns, r)
            return res(ref, rr), res(r, frids), counters(r)

        want, got, c = both(run, setup)
        assert got == want and c["failovers"] >= 1 and c["failed"] == 0


# ---------------------------------------------------------------------------
# live KV migration: drain / roll / scale-in move in-flight state
# ---------------------------------------------------------------------------

BASE4 = dict(max_slots=4)


def _recomputed(r):
    return sum(rep.sup.engine.stats()["recomputed_tokens"]
               for rep in r._replicas.values())


class TestMigration:
    def _mk(self, s, ns, migrate=True, **kw):
        return mk(s, ns, rc=dict(replicas=2, migrate=migrate),
                  **{**BASE4, **kw})

    def test_scale_in_drain_migrates_bit_exact(self, setup):
        def run(s, ns):
            r = self._mk(s, ns)
            frids = [r.submit(p, max_new_tokens=6, eos_token_id=None)
                     for p in s.prompts]
            r.step(1)
            r.drain_replica(r.replicas[0])
            drain(r, 1)
            balanced(ns, r)
            return (res(r, frids), homes(r, frids), counters(r),
                    _recomputed(r),
                    ns.V.InvariantAuditor().check(r, collect=True))

        _, _, c, rc, verdict = both(run, setup)
        assert c["migrations"] >= 1 and c["failed"] == 0
        assert rc == 0 and verdict == []

    def test_rolling_restart_migrates(self, setup):
        def run(s, ns):
            r = self._mk(s, ns)
            frids = [r.submit(p, max_new_tokens=8, eos_token_id=None)
                     for p in s.prompts]
            r.step(1)
            r.start_rolling_restart(drain_deadline_s=5.0)
            drain(r, 1, cap=500)
            balanced(ns, r)
            return res(r, frids), counters(r), _recomputed(r)

        _, c, rc = both(run, setup)
        assert c["migrations"] >= 1 and c["failed"] == 0 and rc == 0
        assert c["replica_restarts"] >= 2

    def test_fallback_to_resubmit_when_slots_full(self, setup):
        def run(s, ns):
            r = mk(s, ns, rc=dict(replicas=2, migrate=True))
            frids = [r.submit(p, max_new_tokens=6, eos_token_id=None)
                     for p in s.prompts]
            r.step(1)
            r.drain_replica(r.replicas[0])
            drain(r, 1)
            balanced(ns, r)
            return res(r, frids), counters(r)

        _, c = both(run, setup)
        assert c["migration_fallbacks"] >= 1 and c["failed"] == 0

    def test_migrate_off_uses_resubmit(self, setup):
        def run(s, ns):
            r = self._mk(s, ns, migrate=False)
            frids = [r.submit(p, max_new_tokens=6, eos_token_id=None)
                     for p in s.prompts]
            r.step(1)
            r.drain_replica(r.replicas[0])
            drain(r, 1)
            balanced(ns, r)
            return res(r, frids), counters(r)

        _, c = both(run, setup)
        assert c["migrations"] == 0 and c["migration_tokens"] == 0
        assert c["failed"] == 0

    def test_mid_chunked_prefill_migrates(self, setup):
        def run(s, ns):
            rng = np.random.default_rng(23)
            longs = [rng.integers(0, 97, (24,)).astype(np.int32)
                     for _ in range(2)]
            r = self._mk(s, ns, prefill_chunk=8)
            frids = [r.submit(p, max_new_tokens=6, eos_token_id=None)
                     for p in longs]
            r.step(1)
            r.drain_replica(r.replicas[0])
            drain(r, 1)
            balanced(ns, r)
            return res(r, frids), counters(r), _recomputed(r)

        _, c, rc = both(run, setup)
        assert c["failed"] == 0 and rc == 0

    def test_preempted_requeued_request_survives_drain(self, setup):
        def run(s, ns):
            rng = np.random.default_rng(29)
            ps = [rng.integers(0, 97, (10,)).astype(np.int32)
                  for _ in range(4)]
            r = self._mk(s, ns, num_blocks=14)
            frids = [r.submit(p, max_new_tokens=8, eos_token_id=None)
                     for p in ps]
            for _ in range(3):
                r.step(1)
            r.drain_replica(r.replicas[0])
            drain(r, 1)
            balanced(ns, r)
            stats = [rep.sup.engine.stats() for rep in r._replicas.values()]
            return (res(r, frids), counters(r),
                    sum(x["oom_truncated"] for x in stats),
                    sum(x["preemptions"] for x in stats))

        _, c, oom, pre = both(run, setup)
        assert c["failed"] == 0 and oom == 0 and pre >= 1

"""The port's engine supervisor, journal recovery, hang watchdog and health
snapshot against the JAX package's.

Every scenario runs twice — once on the JAX ``EngineSupervisor`` and once
on the port's, with the same weights, config, trace and fault — and what
each run observes must be equal: token streams (per step and final),
request states, restart / resubmit / recovery counters, drain reports and
the ``health_snapshot`` keys. The JAX package's own tests hold its streams
to the dense oracle; here the port is held to the JAX package.

* Crash barrier: a crash with requests queued and decoding, mid chunked
  prefill, after a request finished but before its sweep, a second crash
  during recovery, the restart budget running out, a hang-watchdog trip
  inside a serving section, sampled streams.
* Graceful drain, the SIGTERM glue, autoscale telemetry and the rejoin
  file, bounded record retention.
* Journal cold restart: kill points across the run, a second kill during
  recovery, a torn tail plus a corrupt snapshot, int8 weights and the
  paged-attention kernel wrapper, a kill while draining, and recovery of
  an adapter request (with and without its adapter re-registered).
* The hang watchdog's unit contract, the engine's serving sections, and
  the health snapshot's shape, tenant breakdown and overflow folding.

The crash and kill injectors are the JAX package's ``testing.chaos``
helpers: they patch the engine's ``_step`` or abandon the journal, and
work on either package's objects.
"""

import os
import signal
import time
import types

import jax
import numpy as np
import pytest
import torch

import paddle_tpu.health.watchdog as JW
import paddle_tpu.inference.serving.supervisor as JS
from paddle_tpu.distributed.launch.main import read_rejoin_count
from paddle_tpu.inference.serving.engine import (HEALTH_SNAPSHOT_FIELDS,
                                                 SUPERVISOR_SNAPSHOT_KEYS)
from paddle_tpu.inference.serving.engine import ServingConfig as JConfig
from paddle_tpu.inference.serving.journal import RequestJournal as JRJ
from paddle_tpu.inference.serving.scheduler import \
    ServingQueueFull as JQueueFull
from paddle_tpu.models import llama as JL
from paddle_tpu.models.bert import BertConfig as JBertConfig
from paddle_tpu.models.bert import bert_init_params as j_bert_init
from paddle_tpu.models.lora import lora_init_params
from paddle_tpu.testing import chaos

import paddle_tpu_torch.health.watchdog as TW
import paddle_tpu_torch.inference.serving.supervisor as TS
from paddle_tpu_torch.inference.serving.engine import HEALTH_SNAPSHOT_KEYS
from paddle_tpu_torch.inference.serving.engine import \
    SUPERVISOR_SNAPSHOT_KEYS as T_SUP_KEYS
from paddle_tpu_torch.inference.serving.engine import ServingConfig as TConfig
from paddle_tpu_torch.inference.serving.journal import RequestJournal as TRJ
from paddle_tpu_torch.inference.serving.scheduler import \
    ServingQueueFull as TQueueFull
from paddle_tpu_torch.models.bert import BertConfig as TBertConfig
from paddle_tpu_torch.models.convert import (bert_params_from_jax,
                                             config_from_jax, params_from_jax)

torch.set_num_threads(2)

BASE = dict(block_size=4, max_slots=2, max_model_len=32, decode_chunk=2,
            queue_depth=8)

JAX = types.SimpleNamespace(name="jax", S=JS, Config=JConfig, RJ=JRJ,
                            QueueFull=JQueueFull, wd=JW)
PORT = types.SimpleNamespace(name="port", S=TS, Config=TConfig, RJ=TRJ,
                             QueueFull=TQueueFull, wd=TW)


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
    donor = JS.EngineSupervisor(params, cfg, JConfig(**BASE), journal=None)
    donor.run(prompts, max_new_tokens=[2] * 4, eos_token_id=None)
    return {"cfg": cfg, "params": params, "tcfg": config_from_jax(cfg),
            "tparams": params_from_jax(_np(params), device="cpu"),
            "prompts": prompts, "programs": {(): donor.engine.programs}}


def _shape_key(kw):
    """The JAX program-sharing key of a config override (the knobs that
    change compiled shapes)."""
    return tuple(sorted((k, v) for k, v in kw.items()
                        if k not in ("queue_depth", "prefill_chunk")))


def mk(setup, ns, journal=None, embed=None, **kw):
    """A supervisor of either package at BASE (+ overrides); JAX ones share
    compiled programs per shape."""
    sup_kw = {k: kw.pop(k) for k in list(kw)
              if k in ("max_restarts", "drain_deadline_s")}
    sc = {**BASE, **kw}
    if ns is JAX:
        shape = _shape_key(kw)
        sup = JS.EngineSupervisor(
            setup["params"], setup["cfg"], JConfig(**sc),
            programs=setup["programs"].get(shape), journal=journal,
            embed_model=embed, **sup_kw)
        setup["programs"].setdefault(shape, sup.engine.programs)
        return sup
    return TS.EngineSupervisor(setup["tparams"], setup["tcfg"],
                               TConfig(**sc), journal=journal,
                               embed_model=embed, device="cpu", **sup_kw)


def both(scenario, setup, *args, **kw):
    """Run ``scenario(setup, ns, ...)`` on the JAX package and the port;
    the two observations must be equal. Returns the port's."""
    want = scenario(setup, JAX, *args, **kw)
    got = scenario(setup, PORT, *args, **kw)
    assert got == want
    return got


def results(sup, srids):
    return [[int(t) for t in sup.result(s)] for s in srids]


def drain_steps(sup, n=2, cap=300):
    steps = 0
    while sup.pending:
        sup.step(n)
        steps += 1
        assert steps < cap, "did not drain"


def in_use(sup):
    return sup.engine.block_partition()["in_use"]


def sup_counters(sup):
    return {k: getattr(sup, k) for k in
            ("restarts", "resubmitted", "recovered_tokens", "completed",
             "broken")}


# ---------------------------------------------------------------------------
# crash barrier + restart budget
# ---------------------------------------------------------------------------

class TestSupervisorRecovery:
    def test_engine_crash_mid_trace(self, setup):
        def run(setup, ns):
            sup = mk(setup, ns)
            srids = [sup.submit(p, max_new_tokens=8, eos_token_id=None)
                     for p in setup["prompts"]]
            first = sup.step(2)
            assert first and sup.pending
            chaos.engine_crash(sup, at_step=1)
            crashed = sup.step(2)
            counters = sup_counters(sup)
            drain_steps(sup)
            return {"first": first, "crashed": crashed,
                    "counters": counters, "out": results(sup, srids),
                    "in_use": in_use(sup)}

        got = both(run, setup)
        assert got["crashed"] == {} and got["counters"]["restarts"] == 1
        assert got["counters"]["resubmitted"] == 4
        assert got["counters"]["recovered_tokens"] > 0
        assert got["in_use"] == 0
        # the same trace uninterrupted: the same streams
        ref = mk(setup, PORT)
        rr = [ref.submit(p, max_new_tokens=8, eos_token_id=None)
              for p in setup["prompts"]]
        drain_steps(ref)
        assert results(ref, rr) == got["out"]

    def test_no_delivered_token_repeats_across_restart(self, setup):
        def run(setup, ns):
            sup = mk(setup, ns)
            srid = sup.submit(setup["prompts"][0], max_new_tokens=8,
                              eos_token_id=None)
            got = list(sup.step(2).get(srid, []))
            got += sup.step(2).get(srid, [])
            chaos.engine_crash(sup, at_step=1)
            sup.step(2)
            while sup.pending:
                got += sup.step(2).get(srid, [])
            assert got == [int(t) for t in sup.result(srid)]
            return [int(t) for t in got]

        assert len(both(run, setup)) == 8

    def test_crash_mid_chunked_prefill_recovers(self, setup):
        def run(setup, ns):
            sup = mk(setup, ns, prefill_chunk=4)
            long_p = np.concatenate([setup["prompts"][2],
                                     setup["prompts"][3]])
            srid = sup.submit(long_p, max_new_tokens=4, eos_token_id=None)
            sup.step(1)
            mid = bool(sup.engine._sched.live[0].prefilling)
            chaos.engine_crash(sup, at_step=1)
            sup.step(1)
            drain_steps(sup)
            return mid, sup.restarts, results(sup, [srid]), in_use(sup)

        assert both(run, setup)[:2] == (True, 1)

    def test_finished_unswept_request_recorded_not_rerun(self, setup):
        def run(setup, ns):
            sup = mk(setup, ns)
            srid = sup.submit(setup["prompts"][1], max_new_tokens=3,
                              eos_token_id=None)
            rec = sup._reqs[srid]
            while not rec.finished_by_tokens:
                sup.step(1)
            if rec.terminal:                  # re-arm: unswept state
                rec.state = "running"
                sup._by_erid[rec.erid] = rec
            chaos.engine_crash(sup, at_step=1)
            sup.step(1)
            return (sup._reqs[srid].state, results(sup, [srid]),
                    sup.completed, sup.resubmitted)

        assert both(run, setup)[0] == "finished"

    def test_second_crash_during_recovery(self, setup):
        """A crash right after a recovery, while the resubmitted requests
        are still queued, recovers again to the same streams."""
        def run(setup, ns):
            sup = mk(setup, ns)
            srids = [sup.submit(p, max_new_tokens=6, eos_token_id=None)
                     for p in setup["prompts"]]
            sup.step(2)
            chaos.engine_crash(sup, at_step=1)
            sup.step(2)
            chaos.engine_crash(sup, at_step=1)     # before any progress
            sup.step(2)
            counters = sup_counters(sup)
            drain_steps(sup)
            return counters, results(sup, srids), in_use(sup)

        counters, _, leaked = both(run, setup)
        assert counters["restarts"] == 2 and leaked == 0

    def test_restart_budget_exhausted_flips_not_accepting(self, setup):
        def run(setup, ns):
            sup = mk(setup, ns, max_restarts=1)
            srid = sup.submit(setup["prompts"][0], max_new_tokens=8,
                              eos_token_id=None)
            chaos.engine_crash(sup, at_step=1)
            sup.step(2)
            mid = (sup.restarts, sup.broken, sup.accepting)
            chaos.engine_crash(sup, at_step=1)
            sup.step(2)
            with pytest.raises(ns.S.ServingUnavailable) as ei:
                sup.submit(setup["prompts"][0])
            snap = sup.health_snapshot()
            partial = [int(t) for t in sup.result(srid)]
            return {"mid": mid, "broken": sup.broken,
                    "accepting": sup.accepting,
                    "state": sup.request(srid).state,
                    "reason": ei.value.reason, "partial": partial,
                    "snap": (snap["accepting"], snap["supervisor"]["broken"],
                             snap["supervisor"]["restarts"]),
                    "pending": sup.pending, "in_use": in_use(sup)}

        got = both(run, setup)
        assert got["mid"] == (1, False, True)
        assert got["state"] == TS.FAILED == "failed"
        assert got["reason"] == "broken" and got["in_use"] == 0

    def test_watchdog_trip_on_serving_section_restarts(self, setup):
        def run(setup, ns):
            sup = mk(setup, ns)
            ns.wd.install(0.3, on_hang=lambda d: None)
            try:
                srid = sup.submit(setup["prompts"][0], max_new_tokens=6,
                                  eos_token_id=None)
                real = sup.engine._step

                def stalled(max_iters=None):
                    time.sleep(0.8)        # > timeout, inside serving.step
                    return real(max_iters)

                sup.engine._step = stalled
                sup.step(2)
                sup.step(2)
                restarted = sup.restarts
                fresh = (ns.wd.current() is not None
                         and not ns.wd.current().fired.is_set())
                drain_steps(sup)
                return restarted, fresh, results(sup, [srid])
            finally:
                ns.wd.uninstall()

        assert both(run, setup)[:2] == (1, True)

    def test_resubmit_rejects_finished_and_validates(self, setup):
        def run(setup, ns):
            eng = mk(setup, ns).engine
            p = setup["prompts"]
            with pytest.raises(ValueError, match="finished"):
                eng.resubmit(p[0], tokens=[1, 2], max_new_tokens=2)
            with pytest.raises(ValueError, match="finished"):
                eng.resubmit(p[0], tokens=[5, 7], max_new_tokens=8,
                             eos_token_id=7)
            ref = eng.submit(p[0], max_new_tokens=4, eos_token_id=None)
            while eng.pending:
                eng.step()
            want = [int(t) for t in eng.request(ref).output()]
            for _ in range(BASE["queue_depth"]):
                eng.submit(p[1], max_new_tokens=2, eos_token_id=None)
            rid = eng.resubmit(p[0], tokens=[want[0]], max_new_tokens=4,
                               eos_token_id=None)
            while eng.pending:
                eng.step()
            got = [int(t) for t in eng.request(rid).output()]
            assert got == want
            return got

        both(run, setup)


class TestSampledStreamRecovery:
    KW = dict(max_new_tokens=8, eos_token_id=None, temperature=0.8,
              top_k=30, top_p=0.95)

    def test_crash_mid_sampled_trace(self, setup):
        def run(setup, ns):
            ref = mk(setup, ns)
            rr = [ref.submit(p, seed=i, **self.KW)
                  for i, p in enumerate(setup["prompts"])]
            drain_steps(ref)
            sup = mk(setup, ns)
            srids = [sup.submit(p, seed=i, **self.KW)
                     for i, p in enumerate(setup["prompts"])]
            assert sup.step(2)
            chaos.engine_crash(sup, at_step=1)
            assert sup.step(2) == {}
            drain_steps(sup)
            out = results(sup, srids)
            assert out == results(ref, rr)
            return out, sup.restarts, in_use(sup)

        both(run, setup)

    def test_tracked_record_mirrors_resolved_sampling(self, setup):
        def run(setup, ns):
            sup = mk(setup, ns)
            srid = sup.submit(setup["prompts"][0], max_new_tokens=4,
                              eos_token_id=None, temperature=0.6, top_k=12,
                              top_p=0.9, seed=77)
            rec = sup.request(srid)
            knobs = (rec.temperature, rec.top_k, rec.top_p, rec.seed)
            drain_steps(sup)
            return knobs, results(sup, [srid])

        assert both(run, setup)[0] == (0.6, 12, 0.9, 77)


# ---------------------------------------------------------------------------
# graceful drain, autoscale, retention
# ---------------------------------------------------------------------------

class TestGracefulDrain:
    def test_drain_completes_inflight_and_rejects_new(self, setup):
        def run(setup, ns):
            sup = mk(setup, ns)
            srids = [sup.submit(p, max_new_tokens=4, eos_token_id=None)
                     for p in setup["prompts"]]
            rep = sup.drain(deadline_s=30.0)
            with pytest.raises(ns.S.ServingUnavailable) as ei:
                sup.submit(setup["prompts"][0])
            ra = ei.value.retry_after_s
            return {"completed": rep["completed"],
                    "cancelled": rep["cancelled"],
                    "leaked": rep["leaked_blocks"],
                    "out": results(sup, srids), "reason": ei.value.reason,
                    "retry_after": ra is not None and ra > 0,
                    "accepting": sup.health_snapshot()["accepting"]}

        got = both(run, setup)
        assert (got["completed"], got["cancelled"], got["leaked"]) == \
            (4, 0, 0)
        assert got["reason"] == "draining" and got["retry_after"]

    def test_drain_deadline_cancels_remainder_no_leak(self, setup):
        def run(setup, ns):
            sup = mk(setup, ns)
            for p in setup["prompts"]:
                sup.submit(p, max_new_tokens=8, eos_token_id=None)
            rep = sup.drain(deadline_s=0.0)
            return rep["cancelled"], rep["leaked_blocks"], in_use(sup)

        assert both(run, setup) == (4, 0, 0)

    def test_sigterm_requests_drain_with_preempt_grace(self, setup):
        def run(setup, ns):
            sup = mk(setup, ns)
            os.environ["PADDLE_PREEMPT_GRACE"] = "10"
            try:
                assert sup.install_signal_handler() is not None
                deadline_s = sup.drain_deadline_s
                srid = sup.submit(setup["prompts"][0], max_new_tokens=4,
                                  eos_token_id=None)
                os.kill(os.getpid(), signal.SIGTERM)
                t_end = time.time() + 5
                while not sup.drain_requested and time.time() < t_end:
                    time.sleep(0.01)
                rep = sup.drain()
                return (deadline_s, sup.drain_requested, rep["completed"],
                        rep["leaked_blocks"], results(sup, [srid]))
            finally:
                sup.uninstall_signal_handler()
                del os.environ["PADDLE_PREEMPT_GRACE"]

        assert both(run, setup)[:4] == (8.0, True, 1, 0)


class TestAutoscale:
    def test_scale_up_on_queue_pressure_writes_rejoin_file(self, setup,
                                                           tmp_path):
        def run(setup, ns):
            sup = mk(setup, ns, queue_depth=4)
            for p in setup["prompts"]:
                sup.submit(p, max_new_tokens=4, eos_token_id=None)
            rejoin = str(tmp_path / f"rejoin-{ns.name}")
            sig = sup.autoscale_signal(rejoin_file=rejoin, workers=3)
            drain_steps(sup)
            sig.pop("rejoin_file")
            return sig, read_rejoin_count(rejoin)

        sig, count = both(run, setup)
        assert sig["action"] == "scale_up" and count == 3

    def test_scale_up_on_shed_delta(self, setup):
        def run(setup, ns):
            sup = mk(setup, ns, queue_depth=2)
            sup.autoscale_signal()
            for _ in range(2):
                sup.submit(setup["prompts"][1], max_new_tokens=2,
                           eos_token_id=None)
            with pytest.raises(ns.QueueFull):
                sup.engine.submit(setup["prompts"][1], max_new_tokens=2,
                                  eos_token_id=None)
            sig = sup.autoscale_signal()
            drain_steps(sup)
            return sig["action"], sig["shed_delta"]

        assert both(run, setup) == ("scale_up", 1)

    def test_scale_in_idle_and_hold_mid_load(self, setup):
        def run(setup, ns):
            sup = mk(setup, ns)
            snaps = [{"queued": 1, "queue_limit": 8, "live_slots": 2,
                      "max_slots": 2, "retry_after_s": 1.0},
                     {"queued": 0, "queue_limit": 8, "live_slots": 2,
                      "max_slots": 2, "retry_after_s": 1.0}]
            return (sup.autoscale_signal()["action"],
                    [ns.S.autoscale_signal(s) for s in snaps])

        got = both(run, setup)
        assert got[0] == "scale_in"
        assert [s["action"] for s in got[1]] == ["hold", "hold"]


class TestSupervisorRecordRetention:
    def test_terminal_tracked_requests_bounded(self, setup):
        def run(setup, ns):
            sup = mk(setup, ns, queue_depth=2)
            keep = sup._keep_finished
            last = None
            for i in range(keep + 4):
                last = sup.submit(setup["prompts"][i % 4], max_new_tokens=2,
                                  eos_token_id=None)
                drain_steps(sup)
            return (keep, len(sup._reqs), len(sup._by_erid),
                    0 in sup._reqs, results(sup, [last]))

        keep, n, live, has0, _ = both(run, setup)
        assert n <= keep + live and not has0


# ---------------------------------------------------------------------------
# journal cold restart
# ---------------------------------------------------------------------------

SC = dict(queue_depth=64)


def trace_spec():
    """Mixed trace; the last request samples with a seed."""
    rng = np.random.default_rng(3)

    def p(n):
        return [int(t) for t in rng.integers(0, 97, (n,))]

    return [dict(prompt=p(12), max_new_tokens=5),
            dict(prompt=p(5), max_new_tokens=6),
            dict(prompt=p(7), max_new_tokens=4),
            dict(prompt=p(4), max_new_tokens=7),
            dict(prompt=p(6), max_new_tokens=5, temperature=0.8, top_k=20,
                 seed=11)]


def submit_trace(sup, spec=None):
    return [sup.submit(np.asarray(s["prompt"], np.int32), eos_token_id=None,
                       **{k: v for k, v in s.items() if k != "prompt"})
            for s in (spec or trace_spec())]


def drive_by_jid(sup, pre=None, steps=None):
    """Step one iteration at a time (``steps`` of them, or to drain);
    returns the streams delivered, keyed by journal record id."""
    out = {} if pre is None else pre
    n = 0
    while sup.pending and (steps is None or n < steps):
        for srid, toks in sup.step(max_iters=1).items():
            out.setdefault(sup._reqs[srid].jid, []).extend(
                int(t) for t in toks)
        n += 1
        assert n < 400
    return out


def killed_then_recovered(setup, ns, jdir, k, kw=None, spec=None,
                          snapshot_every=None, damage=None, second=False,
                          drain_at=None):
    """A journaled run killed after ``k`` steps, then a cold restart
    driven to drain. Returns (original jids, pre-kill and post-recovery
    streams by jid, final results by jid, journal stats)."""
    kw = kw or {}
    j = ns.RJ(str(jdir), snapshot_every=snapshot_every)
    sup = mk(setup, ns, journal=j, **SC, **kw)
    srids = submit_trace(sup, spec)
    jids = [sup._reqs[s].jid for s in srids]
    pre = {}
    if drain_at is not None:
        drive_by_jid(sup, pre, steps=drain_at)
        sup.request_drain()
        k -= drain_at
    drive_by_jid(sup, pre, steps=k)
    chaos.process_kill(sup)
    if damage:
        assert chaos.torn_journal_tail(str(jdir))["enabled"]
        assert chaos.corrupt_snapshot(str(jdir))["enabled"]
    sc = {**BASE, **SC, **kw}
    kwargs = ({"device": "cpu"} if ns is PORT else
              {"programs": setup["programs"][_shape_key(kw)]})
    params = setup["tparams"] if ns is PORT else setup["params"]
    cfg = setup["tcfg"] if ns is PORT else setup["cfg"]
    if second:
        first = ns.S.EngineSupervisor.recover(str(jdir), params, cfg,
                                              ns.Config(**sc), **kwargs)
        chaos.process_kill(first)
    rec = ns.S.EngineSupervisor.recover(str(jdir), params, cfg,
                                        ns.Config(**sc), **kwargs)
    post = drive_by_jid(rec)
    final = {r.jid: [int(t) for t in rec.result(s)]
             for s, r in rec._reqs.items()}
    return (jids, pre, post, final, rec._journal.stats(),
            in_use(rec))


@pytest.fixture(scope="module")
def oracle(setup):
    """The unkilled, journal-less run of the trace, on the port."""
    sup = mk(setup, PORT, **SC)
    srids = submit_trace(sup)
    out = {}
    steps = 0
    while sup.pending:
        for s, toks in sup.step(max_iters=1).items():
            out.setdefault(s, []).extend(int(t) for t in toks)
        steps += 1
    return [out.get(s, []) for s in srids], steps


class TestKillPointFuzz:
    @pytest.mark.parametrize("where", ["first", "early", "middle", "last"])
    def test_kill_is_exactly_once(self, setup, oracle, tmp_path, where):
        want, total = oracle
        k = {"first": 0, "early": 2, "middle": total // 2,
             "last": total - 1}[where]
        got = both(lambda s, ns: killed_then_recovered(
            s, ns, tmp_path / ns.name, k, snapshot_every=3), setup)
        jids, pre, post, _, _, leaked = got
        for i, jid in enumerate(jids):
            assert pre.get(jid, []) + post.get(jid, []) == want[i]
        assert leaked == 0

    def test_recovery_survives_a_second_kill(self, setup, oracle, tmp_path):
        want, total = oracle
        jids, pre, post, _, _, _ = both(lambda s, ns: killed_then_recovered(
            s, ns, tmp_path / ns.name, max(2, total // 2), second=True),
            setup)
        for i, jid in enumerate(jids):
            assert pre.get(jid, []) + post.get(jid, []) == want[i]

    def test_torn_tail_and_corrupt_snapshot_degrade_to_last_good(
            self, setup, oracle, tmp_path):
        want, total = oracle
        jids, _, _, final, st, _ = both(lambda s, ns: killed_then_recovered(
            s, ns, tmp_path / ns.name, max(3, total // 2), snapshot_every=2,
            damage=True), setup)
        assert st["torn_tail_bytes"] > 0 and st["snapshot_fallbacks"] >= 1
        for i, jid in enumerate(jids):
            assert final[jid] == want[i]

    @pytest.mark.parametrize("variant", ["int8", "kernel"])
    def test_variant_engines_recover(self, setup, tmp_path, variant):
        kw = ({"quantize": "int8"} if variant == "int8"
              else {"paged_kernel": True})
        spec = trace_spec()[1:4]
        # the unkilled run of the same variant, on the port
        ref = mk(setup, PORT, **SC, **kw)
        srids = submit_trace(ref, spec)
        drain_steps(ref, n=1)
        want = results(ref, srids)
        jids, pre, post, _, _, _ = both(lambda s, ns: killed_then_recovered(
            s, ns, tmp_path / ns.name, 3, kw=kw, spec=spec), setup)
        for i, jid in enumerate(jids):
            assert pre.get(jid, []) + post.get(jid, []) == want[i]

    def test_kill_while_draining(self, setup, oracle, tmp_path):
        want, _ = oracle
        jids, pre, post, _, _, _ = both(lambda s, ns: killed_then_recovered(
            s, ns, tmp_path / ns.name, 4, drain_at=2), setup)
        for i, jid in enumerate(jids):
            assert pre.get(jid, []) + post.get(jid, []) == want[i]


# ---------------------------------------------------------------------------
# durability with adapters and an encoder attached
# ---------------------------------------------------------------------------

LCFG = JL.LlamaConfig(vocab_size=128, hidden_size=64, intermediate_size=96,
                      num_hidden_layers=2, num_attention_heads=8,
                      num_key_value_heads=4, max_position_embeddings=128)
BCFG = dict(vocab_size=128, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=64,
            max_position_embeddings=64)
LBASE = dict(block_size=8, max_slots=4, max_model_len=96, queue_depth=16,
             decode_chunk=4, lora_rank=4, lora_slots=2, lora_pool=8)


@pytest.fixture(scope="module")
def lora_setup():
    params = JL.init_params(LCFG, jax.random.PRNGKey(0))
    bp = j_bert_init(JBertConfig(**BCFG), seed=3)
    adapters = {f"a{i}": lora_init_params(LCFG, 4, seed=i, scale=0.5)
                for i in range(1, 3)}
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, 128, (int(s),)).astype(np.int32)
               for s in (5, 8)]
    return {
        JAX.name: (params, LCFG, (JBertConfig(**BCFG), bp)),
        PORT.name: (params_from_jax(_np(params), device="cpu"),
                    config_from_jax(LCFG),
                    (TBertConfig(**BCFG),
                     bert_params_from_jax(_np(bp), device="cpu"))),
        "adapters": adapters, "prompts": prompts, "programs": {}}


def _lora_sup(ls, ns, journal=None):
    params, cfg, bert = ls[ns.name]
    if ns is JAX:
        sup = JS.EngineSupervisor(params, cfg, JConfig(**LBASE),
                                  programs=ls["programs"].get("lora"),
                                  journal=journal, embed_model=bert)
        ls["programs"].setdefault("lora", sup.engine.programs)
        return sup
    return TS.EngineSupervisor(params, cfg, TConfig(**LBASE),
                               journal=journal, embed_model=bert,
                               device="cpu")


def _lora_recover(ls, ns, jdir, adapters=None):
    params, cfg, bert = ls[ns.name]
    kw = ({"programs": ls["programs"]["lora"]} if ns is JAX
          else {"device": "cpu"})
    return ns.S.EngineSupervisor.recover(
        str(jdir), params, cfg, ns.Config(**LBASE), embed_model=bert,
        adapters=adapters, **kw)


class TestDurabilityAndFleet:
    def test_journal_recovery_preserves_adapter(self, lora_setup, tmp_path):
        ls = lora_setup

        def run(_, ns):
            jdir = tmp_path / ns.name
            sup = _lora_sup(ls, ns, journal=ns.RJ(str(jdir)))
            for name, ap in ls["adapters"].items():
                sup.register_adapter(name, ap)
            p = ls["prompts"]
            r1 = sup.submit(p[0], max_new_tokens=10, eos_token_id=None,
                            adapter_id="a1")
            r2 = sup.submit(p[1], max_new_tokens=10, eos_token_id=None)
            sup.step(max_iters=1)
            jids = [sup.request(r).jid for r in (r1, r2)]
            chaos.process_kill(sup)
            rec = _lora_recover(ls, ns, jdir, adapters=ls["adapters"])
            drain_steps(rec, n=None)
            by_jid = {tr.jid: s for s, tr in rec._reqs.items()}
            return ([[int(t) for t in rec.result(by_jid[j])] for j in jids],
                    rec._reqs[by_jid[jids[0]]].adapter_id)

        out, aid = both(run, None)
        assert aid == "a1" and out[0] != out[1]

    def test_recovery_without_adapter_fails_structured(self, lora_setup,
                                                       tmp_path):
        ls = lora_setup

        def run(_, ns):
            jdir = tmp_path / ns.name
            sup = _lora_sup(ls, ns, journal=ns.RJ(str(jdir)))
            sup.register_adapter("a1", ls["adapters"]["a1"])
            rid = sup.submit(ls["prompts"][0], max_new_tokens=10,
                             eos_token_id=None, adapter_id="a1")
            sup.step(max_iters=1)
            jid = sup.request(rid).jid
            chaos.process_kill(sup)
            rec = _lora_recover(ls, ns, jdir)
            tr = next(t for t in rec._reqs.values() if t.jid == jid)
            return tr.state, tr.finish["reason"]

        state, reason = both(run, None)
        assert state == "failed" and "a1" in reason
        assert "not registered" in reason

    def test_supervisor_embeddings(self, lora_setup):
        """Embeddings through the supervisor are untracked and equal the
        JAX supervisor's rows within fp32 rounding."""
        ls = lora_setup
        rows = {}
        for ns in (JAX, PORT):
            sup = _lora_sup(ls, ns)
            e = [sup.submit_embedding(p) for p in ls["prompts"]]
            assert sup.embedding(e[0]) is None      # still queued
            sup.step()
            rows[ns.name] = np.stack([sup.embedding(x) for x in e])
            assert not sup._reqs
        ref = rows["jax"]
        np.testing.assert_allclose(rows["port"], ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max())


# ---------------------------------------------------------------------------
# hang watchdog, serving sections, health snapshot
# ---------------------------------------------------------------------------

class TestHangWatchdog:
    def test_fires_with_section_diagnosis(self):
        fired = []
        wd = TW.HangWatchdog(timeout=0.3, name="t", on_hang=fired.append,
                             poll=0.05)
        try:
            with wd.section("collective:all_reduce"):
                time.sleep(0.8)
            assert wd.fired.is_set()
            assert "collective:all_reduce" in fired[0]
            assert "Thread stacks" in fired[0]
            with pytest.raises(TW.WatchdogAlarm):
                wd.check()
        finally:
            wd.stop()

    def test_ticks_keep_it_quiet(self):
        wd = TW.HangWatchdog(timeout=0.4, name="t", poll=0.05,
                             on_hang=lambda d: None)
        try:
            for _ in range(10):
                wd.tick()
                time.sleep(0.06)
            assert not wd.fired.is_set()
        finally:
            wd.stop()

    def test_global_install_touch_section(self):
        fired = []
        wd = TW.install(timeout=0.3, on_hang=fired.append, poll=0.05)
        try:
            assert TW.current() is wd
            with TW.section("collective:barrier"):
                time.sleep(0.7)
            assert wd.fired.is_set() and "collective:barrier" in fired[0]
        finally:
            TW.uninstall()
        assert TW.current() is None
        TW.touch()

    def test_install_flag_off_is_noop_and_names_match(self):
        assert TW.install() is None
        assert TW.HUNG_EXIT_RC == JW.HUNG_EXIT_RC
        assert set(TW.__all__) == set(JW.__all__)


class TestServingWatchdog:
    def test_frozen_decode_names_serving_section(self, setup):
        eng = mk(setup, PORT, prefix_cache=None).engine
        eng.run([setup["prompts"][1]], max_new_tokens=2, eos_token_id=None)
        diagnoses = []
        real = eng._decode_burst

        def frozen(*a, **kw):
            time.sleep(0.6)
            return real(*a, **kw)

        eng._decode_burst = frozen
        wd = TW.install(timeout=0.2, on_hang=diagnoses.append)
        try:
            eng.run([setup["prompts"][1]], max_new_tokens=4,
                    eos_token_id=None)
            assert wd.fired.wait(2.0)
        finally:
            TW.uninstall()
        assert diagnoses and "serving.decode" in diagnoses[0]
        assert eng.health_snapshot()["watchdog"]["installed"] is False

    def test_snapshot_reflects_fired_watchdog(self, setup):
        eng = mk(setup, PORT).engine
        wd = TW.install(timeout=0.05, on_hang=lambda d: None)
        try:
            assert wd.fired.wait(2.0)
            snap = eng.health_snapshot()
            assert snap["ok"] is False and snap["watchdog"]["fired"] is True
        finally:
            TW.uninstall()


def _shape(d):
    """The nested key structure of a snapshot (tenant rows by name)."""
    return {k: _shape(v) if isinstance(v, dict) else None
            for k, v in d.items()}


class TestHealthSnapshot:
    def test_snapshot_shape_and_tenant_breakdown(self, setup):
        import json

        def run(setup, ns):
            sup = mk(setup, ns)
            for i, p in enumerate(setup["prompts"]):
                sup.submit(p, max_new_tokens=3, eos_token_id=None,
                           tenant="a" if i % 2 else "b")
            drain_steps(sup)
            eng_snap = sup.engine.health_snapshot()
            snap = sup.health_snapshot()
            json.dumps(snap)
            dl = snap.pop("dispatch_latency")
            for t in snap["tenants"].values():
                for k in [k for k in t if k.endswith("_s")]:
                    assert t[k] is not None
                    t[k] = None                # wall-clock values
            snap.pop("retry_after_s")
            snap["autoscale"].pop("retry_after_s")
            # JAX engines sharing programs share their dispatch counters
            return _shape(eng_snap), snap, _shape(dl)

        eng_shape, snap, _ = both(run, setup)
        assert set(eng_shape) == \
            set(HEALTH_SNAPSHOT_FIELDS) - set(SUPERVISOR_SNAPSHOT_KEYS)
        assert set(HEALTH_SNAPSHOT_KEYS) == set(HEALTH_SNAPSHOT_FIELDS)
        assert set(T_SUP_KEYS) == set(SUPERVISOR_SNAPSHOT_KEYS)
        assert snap["counters"]["retired"] == 4
        assert set(snap["tenants"]) == {"a", "b"}

    def test_snapshot_folds_overflow_tenants(self, setup):
        from paddle_tpu.inference.serving.scheduler import Scheduler as JSch
        from paddle_tpu_torch.inference.serving.scheduler import \
            Scheduler as TSch

        def run(setup, ns):
            Sch = JSch if ns is JAX else TSch
            sup = mk(setup, ns, queue_depth=512)
            old = Sch.MAX_TENANTS
            Sch.MAX_TENANTS = 2
            try:
                for i in range(4):
                    sup.submit(setup["prompts"][0], max_new_tokens=2,
                               eos_token_id=None, tenant=f"mint-{i}")
                ov = sup.engine.health_snapshot()["tenants"][
                    Sch._OVERFLOW_TENANT]
                ov = {k: v for k, v in ov.items() if not k.endswith("_s")}
            finally:
                Sch.MAX_TENANTS = old
            drain_steps(sup)
            return ov

        ov = both(run, setup)
        assert ov["submitted"] >= 2 and ov["queued"] >= 1

    def test_snapshot_not_accepting_when_queue_full_and_partition(
            self, setup):
        def run(setup, ns):
            sup = mk(setup, ns, queue_depth=1)
            sup.submit(setup["prompts"][0], max_new_tokens=2,
                       eos_token_id=None)
            full = sup.engine.health_snapshot()["accepting"]
            depth = sup.depth()
            drain_steps(sup)
            return (full, depth, sup.engine.health_snapshot()["accepting"],
                    sup.block_partition(), sup.engine.depth())

        assert both(run, setup)[:3] == (False, 1, True)


_ROBUSTNESS_FLAGS = (
    "FLAGS_serving_offload", "FLAGS_serving_offload_blocks",
    "FLAGS_serving_journal_dir", "FLAGS_serving_journal_sync",
    "FLAGS_serving_snapshot_every", "FLAGS_serving_max_restarts",
    "FLAGS_serving_drain_deadline_s", "FLAGS_health_watchdog_timeout_s")


@pytest.mark.parametrize("key", _ROBUSTNESS_FLAGS)
def test_robustness_flags_match_jax(key):
    from paddle_tpu import flags as JF
    from paddle_tpu_torch import flags as TF
    a, b = JF._registry[key], TF._registry[key]
    assert (b.default, b.type, b.help) == (a.default, a.type, a.help)
    assert "FLAGS_serving_tp" not in TF._registry

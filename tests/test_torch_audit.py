"""The port's invariant auditor against the JAX package's.

Mirrors ``TestInvariantAuditor`` of ``tests/test_replay.py``: every
seeded corruption is caught by the check the reference names, and the
port's auditor over the port's engine or router gives the same verdict
(the same check names) as the JAX auditor over the JAX engine or router
with the same corruption. Also covers the fleet-scope checks the router
tests do not corrupt on purpose — ``router_routes``,
``migration_exactly_once``, ``directory_coherence``, ``tier_partition``,
``durable_exactly_once`` and ``adapter_pool_partition`` — and
``router.audit()`` / ``health_snapshot()["audit"]`` behind
``FLAGS_serving_audit``.
"""

import json
import types

import jax
import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu.inference.serving as JV
from paddle_tpu.models import llama as JL
from paddle_tpu.models.lora import lora_init_params

import paddle_tpu_torch.flags as TF
import paddle_tpu_torch.inference.serving as TV
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
    return types.SimpleNamespace(
        cfg=cfg, params=params, tcfg=config_from_jax(cfg),
        tparams=params_from_jax(_np(params), device="cpu"), programs={})


def engine(s, ns, **kw):
    sc = {**BASE, **kw}
    if ns is JAX:
        key = ("eng",) + tuple(sorted((k, str(v)) for k, v in kw.items()))
        eng = JV.ServingEngine(s.params, s.cfg, JV.ServingConfig(**sc),
                               programs=s.programs.get(key))
        s.programs.setdefault(key, eng.programs)
        return eng
    return TV.ServingEngine(s.tparams, s.tcfg, TV.ServingConfig(**sc),
                            device="cpu")


def router(s, ns, journal=None, **rc):
    V = ns.V
    rcfg = V.RouterConfig(**{"replicas": 2, "hedge_ttft_mult": 0.0, **rc})
    kw = {} if journal is None else {"journal": journal}
    if ns is JAX:
        r = V.ServingRouter(s.params, s.cfg, V.ServingConfig(**BASE),
                            router_config=rcfg,
                            programs=s.programs.get("router"), **kw)
        s.programs.setdefault("router", r._programs)
        return r
    return V.ServingRouter(s.tparams, s.tcfg, V.ServingConfig(**BASE),
                           router_config=rcfg, device="cpu", **kw)


def both(scenario, s, *args, **kw):
    want = scenario(s, JAX, *args, **kw)
    got = scenario(s, PORT, *args, **kw)
    assert got == want
    return got


def caught(ns, target, auditor=None):
    """The check name of the first violation ``check`` raises."""
    with pytest.raises(ns.V.InvariantViolation) as e:
        (auditor or ns.V.InvariantAuditor()).check(target)
    return e.value.check


def verdict(ns, target):
    return sorted({v.check for v in
                   ns.V.InvariantAuditor().check(target, collect=True)})


P = np.arange(1, 9, dtype=np.int32)


def finished_engine(s, ns, n=2, **kw):
    eng = engine(s, ns, **kw)
    eng.submit(P, max_new_tokens=n, eos_token_id=None, **kw.get("sub", {}))
    while eng.pending:
        eng.step()
    return eng


class TestRegistry:
    def test_registry_is_the_reference_and_the_default_check_set(self):
        assert list(TV.AUDIT_CHECKS) == list(JV.AUDIT_CHECKS)
        assert len(TV.AUDIT_CHECKS) == 13
        assert TV.InvariantAuditor().checks == tuple(TV.AUDIT_CHECKS)
        with pytest.raises(ValueError, match="unknown audit checks"):
            TV.InvariantAuditor(checks=["nope"])


class TestEngineChecks:
    def test_clean_engine_passes_every_step(self, setup):
        def run(s, ns):
            eng = engine(s, ns)
            aud = ns.V.InvariantAuditor()
            for _ in range(3):
                eng.submit(P, max_new_tokens=4, eos_token_id=None)
            while eng.pending:
                aud.observe(eng.step(1), lookup=eng._sched.find)
                aud.check(eng)
            aud.quiesce(eng)
            return aud.violations, aud.digest()

        vs, digest = both(run, setup)
        assert vs == [] and digest["trail_len"] > 0

    def test_partition_corruption_caught(self, setup):
        def run(s, ns):
            eng = engine(s, ns)
            eng.cache.manager._free.pop()
            with pytest.raises(ns.V.InvariantViolation) as e:
                ns.V.InvariantAuditor(manifest="m-tag").check(eng)
            return e.value.check, e.value.manifest, "m-tag" in str(e.value)

        assert both(run, setup) == ("block_partition", "m-tag", True)

    def test_refcount_and_bijection_corruption_caught(self, setup):
        def run(s, ns):
            eng = engine(s, ns)
            bm = eng.cache.manager
            b = bm.alloc(1)[0]
            bm._ref[b] = 0
            first = caught(ns, eng)
            bm._ref[b] = 1
            bm._block2hash[b] = 12345
            return first, verdict(ns, eng)

        first, v = both(run, setup)
        assert first in ("block_partition", "block_consistency")
        assert "block_consistency" in v

    def test_quiesce_leak_caught(self, setup):
        def run(s, ns):
            eng = engine(s, ns)
            eng.cache.manager.alloc(2)
            return caught(ns, eng)

        assert both(run, setup) == "quiesce_leaks"

    def test_exactly_once_repeat_and_overrun_caught(self, setup):
        def run(s, ns):
            eng = engine(s, ns)
            rid = eng.submit(P, max_new_tokens=4, eos_token_id=None)
            aud = ns.V.InvariantAuditor()
            first = eng.step(1)
            aud.observe(first, lookup=eng._sched.find)
            with pytest.raises(ns.V.InvariantViolation) as e:
                aud.observe(first, lookup=eng._sched.find)
            aud2 = ns.V.InvariantAuditor()
            while eng.pending:
                aud2.observe(eng.step(1), lookup=eng._sched.find)
            rec = eng.request(rid)
            forged = types.SimpleNamespace(state=rec.state,
                                           tokens=list(rec.tokens) + [1])
            with pytest.raises(ns.V.InvariantViolation) as e2:
                aud2.close_request(rid, forged)
            return e.value.check, e2.value.check

        assert both(run, setup) == ("exactly_once", "exactly_once")

    def test_emission_after_terminal_caught(self):
        def run(_, ns):
            aud = ns.V.InvariantAuditor()
            rec = types.SimpleNamespace(state="finished", tokens=[5],
                                        max_new_tokens=1, eos_token_id=None)
            aud.observe({7: [5]}, lookup=lambda rid: rec)
            aud.close_request(7, rec)
            with pytest.raises(ns.V.InvariantViolation) as e:
                aud.observe({7: [9]}, lookup=lambda rid: rec)
            return e.value.check, aud.trail

        assert both(run, None)[0] == "exactly_once"

    def test_lifecycle_forgery_caught(self, setup):
        def run(s, ns):
            eng = finished_engine(s, ns, n=3)
            rid = next(iter(eng._sched.finished))
            eng._sched.finished[rid].tokens.append(1)
            return caught(ns, eng)

        assert both(run, setup) == "lifecycle"

    def test_counter_regression_caught(self, setup):
        def run(s, ns):
            eng = finished_engine(s, ns)
            aud = ns.V.InvariantAuditor()
            aud.check(eng)
            eng._sched.retired -= 1
            return caught(ns, eng, aud)

        assert both(run, setup) == "counters_monotonic"

    def test_tenant_closure_corruption_caught(self, setup):
        def run(s, ns):
            eng = engine(s, ns)
            eng.submit(P, max_new_tokens=2, eos_token_id=None, tenant="a")
            while eng.pending:
                eng.step()
            eng._sched.tenants["a"]["submitted"] += 2
            return caught(ns, eng)

        assert both(run, setup) == "tenant_closure"

    def test_tier_shadowed_key_caught(self, setup):
        """A key resident on device AND in the host tier breaks the XOR
        residency the tier promises."""
        def run(s, ns):
            eng = engine(s, ns, prefix_cache=True, offload=True,
                         offload_blocks=8)
            eng.submit(P, max_new_tokens=2, eos_token_id=None)
            while eng.pending:
                eng.step()
            bm = eng.cache.manager
            key = next(iter(bm._hash2block))
            toks = bm._block_tokens[bm._hash2block[key]]
            eng.cache.offload._entries[key] = {"tokens": toks, "data": {},
                                               "crc": {}}
            return verdict(ns, eng)

        assert both(run, setup) == ["tier_partition"]

    def test_adapter_pin_corruption_caught(self, setup):
        lora = dict(block_size=8, max_model_len=48, lora_rank=4,
                    lora_slots=2, lora_pool=8)
        ap = lora_init_params(setup.cfg, 4, seed=1, scale=0.5)

        def run(s, ns):
            eng = engine(s, ns, **lora)
            eng.register_adapter("a1", ap)
            eng.submit(P, max_new_tokens=6, eos_token_id=None,
                       adapter_id="a1")
            eng.step(1)
            clean = verdict(ns, eng)
            pool = eng._lora
            pool._pins.clear()          # the running request loses its pin
            return clean, verdict(ns, eng)

        assert both(run, setup) == ([], ["adapter_pool_partition"])


class TestRouterChecks:
    def test_router_audit_hook_and_flag(self, setup, monkeypatch):
        def run(s, ns):
            r = router(s, ns)
            v0 = r.audit()
            snap = r.health_snapshot()
            off = snap["audit"]
            if ns is JAX:
                paddle_tpu.set_flags({"FLAGS_serving_audit": True})
            else:
                monkeypatch.setattr(TF._registry["FLAGS_serving_audit"],
                                    "value", True)
            try:
                on = r.health_snapshot()["audit"]
                json.dumps(on)
            finally:
                if ns is JAX:
                    paddle_tpu.set_flags({"FLAGS_serving_audit": False})
                else:
                    monkeypatch.undo()
            r._replicas[r.replicas[0]].sup.engine.cache.manager._free.pop()
            v1 = r.audit()
            return (v0, off, on, v1["ok"],
                    [x.split(":")[0] for x in v1["violations"]])

        v0, off, on, ok1, names = both(run, setup)
        assert v0["ok"] and v0["violations"] == []
        assert off == {"enabled": False}
        assert on["enabled"] is True and on["ok"] is True
        assert not ok1 and any("block_partition" in n for n in names)
        assert not TF.flag("FLAGS_serving_audit")

    def test_route_to_unknown_request_caught(self, setup):
        def run(s, ns):
            r = router(s, ns)
            r._routes[r.replicas[0]][99] = 12345
            return verdict(ns, r)

        assert both(run, setup) == ["router_routes"]

    def test_migration_mirror_divergence_caught(self, setup):
        """The router's delivered mirror must be a prefix of the serving
        replica's record: a repeated token is caught."""
        def run(s, ns):
            r = router(s, ns)
            f = r.submit(P, max_new_tokens=6, eos_token_id=None)
            r.step(1)
            clean = verdict(ns, r)
            req = r._reqs[f]
            req.tokens = [req.tokens[0]] + req.tokens
            return clean, verdict(ns, r)

        assert both(run, setup) == ([], ["migration_exactly_once"])

    def test_stale_authoritative_directory_entry_caught(self, setup):
        def run(s, ns):
            r = router(s, ns)
            r.submit(np.arange(1, 14, dtype=np.int32), max_new_tokens=2,
                     eos_token_id=None)
            while r.pending:
                r.step()
            clean = verdict(ns, r)
            r._directory.add(r.replicas[1], 424242)
            return clean, verdict(ns, r), r._directory.entries

        clean, dirty, n = both(run, setup)
        assert clean == [] and dirty == ["directory_coherence"] and n == 4

    def test_journal_double_owner_caught(self, setup, tmp_path):
        def run(s, ns):
            r = router(s, ns, journal=ns.V.RequestJournal(
                str(tmp_path / ns.name)))
            f0 = r.submit(P, max_new_tokens=6, eos_token_id=None,
                          replica=0)
            r.submit(P[:5], max_new_tokens=6, eos_token_id=None, replica=1)
            r.step(1)
            clean = verdict(ns, r)
            jid = r._reqs[f0].jid
            eng1 = r._replicas[1].sup.engine
            rid1 = next(iter(eng1._jlive))
            eng1._jlive[rid1] = jid       # a second live owner
            return clean, verdict(ns, r)

        assert both(run, setup) == ([], ["durable_exactly_once"])

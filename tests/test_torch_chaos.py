"""The port's chaos injectors (``paddle_tpu_torch.testing.chaos``) against
the JAX package's.

Each serving scenario runs twice: the JAX injector on the JAX engine,
supervisor, server or router, and the port's injector on the port's, with
the same weights, prompts and fault. What the run observes (injector
results, request states, served tokens, shed and cancel counters,
breaker states) must be equal, and every clean request equals the JAX
dense oracle, as ``tests/test_chaos.py`` holds the reference. Mirrors its
``TestServingChaos``, ``TestFrontlineChaos`` and ``TestFleetChaos``; adds
the port's ``flood_tenant`` counting its sheds on a port engine (the
reference's injector catches the reference's ``ServingQueueFull`` only,
so aimed at a port engine its first shed escaped), the file injectors
bit for bit, ``kill_self`` and ``adapter_churn``.
"""

import asyncio
import os
import subprocess
import sys
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.inference.serving as JV
from paddle_tpu.models import generation as JG
from paddle_tpu.models import llama as JL
from paddle_tpu.models.lora import lora_init_params
from paddle_tpu.testing import chaos as jchaos

import paddle_tpu_torch.inference.serving as TV
from paddle_tpu_torch.models.convert import config_from_jax, params_from_jax
from paddle_tpu_torch.testing import chaos as tchaos

pytestmark = pytest.mark.chaos

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = dict(block_size=4, max_slots=2, max_model_len=32, decode_chunk=2,
            queue_depth=8)
JAX = types.SimpleNamespace(name="jax", V=JV, chaos=jchaos)
PORT = types.SimpleNamespace(name="port", V=TV, chaos=tchaos)


@pytest.fixture(scope="module")
def s():
    cfg = JL.LlamaConfig(vocab_size=97, hidden_size=64,
                         intermediate_size=96, num_hidden_layers=2,
                         num_attention_heads=4, num_key_value_heads=2,
                         max_position_embeddings=64)
    params = JL.init_params(cfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 97, (n,)).astype(np.int32)
               for n in [9, 5, 12, 7]]
    return types.SimpleNamespace(
        cfg=cfg, params=params, prompts=prompts, tcfg=config_from_jax(cfg),
        tparams=params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                                device="cpu"),
        oracle={})


def dense(s, prompt, n):
    key = (tuple(int(t) for t in prompt), n)
    if key not in s.oracle:
        s.oracle[key] = [int(t) for t in np.asarray(JG.generate(
            s.params, jnp.asarray(prompt[None]), s.cfg,
            max_new_tokens=n))[0]]
    return s.oracle[key]


def weights(s, ns):
    return (s.params, s.cfg, {}) if ns is JAX else \
        (s.tparams, s.tcfg, {"device": "cpu"})


def engine(s, ns, **kw):
    params, cfg, dev = weights(s, ns)
    return ns.V.ServingEngine(params, cfg, ns.V.ServingConfig(
        **{**BASE, **kw}), **dev)


def supervisor(s, ns, **kw):
    params, cfg, dev = weights(s, ns)
    return ns.V.EngineSupervisor(params, cfg, ns.V.ServingConfig(
        **{**BASE, **kw}), **dev)


def router(s, ns, router_config=None, replicas=2, **kw):
    params, cfg, dev = weights(s, ns)
    rkw = {"router_config": router_config} if router_config is not None \
        else {"replicas": replicas}
    return ns.V.ServingRouter(params, cfg, ns.V.ServingConfig(
        **{**BASE, **kw}), **rkw, **dev)


def both(scenario, s, *args, **kw):
    """``scenario(s, ns, ...)`` with the JAX injectors on JAX objects and
    the port's on the port's; the observations must be equal. Returns
    the port's."""
    want = scenario(s, JAX, *args, **kw)
    got = scenario(s, PORT, *args, **kw)
    assert got == want
    return got


def toks(xs):
    return [int(t) for t in xs]


def recovered(s, eng, prompt):
    """The shared recovery oracle: pool accounting balanced, a fresh
    request accepted and served equal to the dense oracle."""
    assert eng.stats()["free_blocks"] == eng.cache.manager.num_blocks - 1
    assert eng.cache.manager.blocks_in_use == 0
    assert eng.health_snapshot()["accepting"] is True
    out = toks(eng.run([prompt], max_new_tokens=4, eos_token_id=None)[0])
    assert out == dense(s, prompt, 4)
    return out


class TestServingChaos:
    def test_stalled_consumer_frees_blocks(self, s):
        def scenario(s, ns):
            eng = engine(s, ns)
            for p in s.prompts:
                eng.submit(p, max_new_tokens=8, eos_token_id=None)
            r = ns.chaos.stalled_consumer(eng, events=3)
            assert not eng.pending
            recovered(s, eng, s.prompts[0])
            return r

        r = both(scenario, s)
        assert r["events"] == 3 and r["cancelled"] >= 1

    def test_poison_prompt_contained(self, s):
        def scenario(s, ns):
            eng = engine(s, ns, max_slots=3)
            clean = s.prompts[0]
            seen = []
            for mode in ("oov", "neg"):
                bad = ns.chaos.poison_prompt(s.prompts[2], s.cfg.vocab_size,
                                             mode=mode)
                rid_bad = eng.submit(bad, max_new_tokens=6,
                                     eos_token_id=None)
                rid_ok = eng.submit(clean, max_new_tokens=6,
                                    eos_token_id=None)
                while eng.pending:
                    eng.step()
                assert toks(eng.request(rid_ok).output()) == \
                    dense(s, clean, 6)
                seen.append((bad.tolist(), len(eng.request(rid_bad).tokens)))
            with pytest.raises(ValueError, match="prompt"):
                eng.submit(ns.chaos.poison_prompt(
                    s.prompts[2], s.cfg.vocab_size, mode="empty"),
                    max_new_tokens=4)
            recovered(s, eng, s.prompts[1])
            return seen

        assert [n for _, n in both(scenario, s)] == [6, 6]

    def test_poison_prompt_null_block_containment(self, s):
        def scenario(s, ns):
            eng = engine(s, ns, tenant_cache_quota=2)
            for p in s.prompts:
                eng.submit(p, max_new_tokens=8, eos_token_id=None)
            ns.chaos.stalled_consumer(eng, events=3)
            bad = ns.chaos.poison_prompt(s.prompts[2], s.cfg.vocab_size,
                                         mode="oov")
            eng.submit(bad, max_new_tokens=4, eos_token_id=None)
            rid = eng.submit(s.prompts[0], max_new_tokens=4,
                             eos_token_id=None)
            while eng.pending:
                eng.step()
            hit = eng.request(rid).prefix_hit_tokens
            assert hit > 0
            assert toks(eng.request(rid).output()) == \
                dense(s, s.prompts[0], 4)
            outs = eng.run(s.prompts, max_new_tokens=6, eos_token_id=None)
            for o, p in zip(outs, s.prompts):
                assert toks(o) == dense(s, p, 6)
            recovered(s, eng, s.prompts[1])
            return hit

        both(scenario, s)

    def test_flood_tenant_shed_and_fair_share(self, s):
        def scenario(s, ns):
            eng = engine(s, ns, max_slots=1, queue_depth=6, policy="fair")
            eng.run([s.prompts[1]], max_new_tokens=2, eos_token_id=None)
            eng.run([s.prompts[1]], max_new_tokens=2, eos_token_id=None)
            r = ns.chaos.flood_tenant(eng, "flood", n=10, prompt_len=8,
                                      max_new_tokens=6,
                                      vocab_size=s.cfg.vocab_size,
                                      eos_token_id=None)
            assert r["retry_after_s"] is not None and r["retry_after_s"] > 0
            eng.step()
            quiet = eng.submit(s.prompts[1], max_new_tokens=6,
                               eos_token_id=None, tenant="quiet")
            while eng.pending:
                eng.step()
            qreq = eng.request(quiet)
            flood_seqs = [eng.request(rid).admit_seq for rid in r["rids"]]
            assert qreq.admit_seq < max(flood_seqs)
            assert toks(qreq.output()) == dense(s, s.prompts[1], 6)
            snap = eng.health_snapshot()
            recovered(s, eng, s.prompts[0])
            return (len(r["rids"]), r["shed"], qreq.admit_seq, flood_seqs,
                    snap["tenants"]["flood"]["shed"],
                    snap["counters"]["shed"])

        got = both(scenario, s)
        assert got[1] >= 1 and got[4] >= 1 and got[5] >= 1

    def test_flood_tenant_cache_quota_protects_system_prompt(self, s):
        def scenario(s, ns):
            eng = engine(s, ns, tenant_cache_quota=2, queue_depth=16)
            sys_p = s.prompts[2]
            eng.run([sys_p], max_new_tokens=2, eos_token_id=None)
            r = ns.chaos.flood_tenant(eng, "spam", n=8, prompt_len=12,
                                      max_new_tokens=2,
                                      vocab_size=s.cfg.vocab_size,
                                      eos_token_id=None)
            while eng.pending:
                eng.step()
            cached = eng.cache.manager.tenant_cached("spam")
            assert cached <= 2
            before = eng.stats()["prefix_hit_tokens"]
            out = toks(eng.run([sys_p], max_new_tokens=4,
                               eos_token_id=None)[0])
            assert out == dense(s, sys_p, 4)
            hits = eng.stats()["prefix_hit_tokens"] - before
            assert hits > 0
            recovered(s, eng, s.prompts[0])
            return len(r["rids"]), r["shed"], cached, hits

        both(scenario, s)

    def test_port_flood_tenant_counts_sheds_on_a_port_engine(self, s):
        """The port's injector catches the port's ``ServingQueueFull``:
        every refused submit is counted, none escapes, and the engine's
        own shed counter agrees. The reference's injector, aimed at the
        same engine, lets the first shed through."""
        eng = engine(s, PORT, max_slots=1, queue_depth=2)
        r = tchaos.flood_tenant(eng, "flood", n=9, prompt_len=6,
                                max_new_tokens=2,
                                vocab_size=s.cfg.vocab_size,
                                eos_token_id=None)
        assert len(r["rids"]) == 2 and r["shed"] == 7
        assert eng.health_snapshot()["counters"]["shed"] == 7
        assert r["retry_after_s"] is not None and r["retry_after_s"] > 0
        with pytest.raises(TV.ServingQueueFull):
            jchaos.flood_tenant(engine(s, PORT, max_slots=1, queue_depth=2),
                                "flood", n=9, prompt_len=6,
                                vocab_size=s.cfg.vocab_size)
        while eng.pending:
            eng.step()
        recovered(s, eng, s.prompts[0])


class TestFrontlineChaos:
    def test_injector_registry_has_frontline_trio(self):
        for name in ("engine_crash", "disconnect_mid_stream",
                     "slow_client"):
            assert tchaos.INJECTORS[name] is getattr(tchaos, name)

    def test_engine_crash_supervisor_recovers_bit_exact(self, s):
        def scenario(s, ns):
            sup = supervisor(s, ns)
            srids = [sup.submit(p, max_new_tokens=8, eos_token_id=None)
                     for p in s.prompts]
            sup.step(2)
            ns.chaos.engine_crash(sup, at_step=1)
            sup.step(2)
            assert sup.restarts == 1
            while sup.pending:
                sup.step(2)
            outs = [toks(sup.result(x)) for x in srids]
            for o, p in zip(outs, s.prompts):
                assert o == dense(s, p, 8)
            recovered(s, sup.engine, s.prompts[0])
            return outs, sup.resubmitted, sup.recovered_tokens

        both(scenario, s)

    def test_disconnect_mid_stream_frees_blocks(self, s):
        def scenario(s, ns):
            sup = supervisor(s, ns)

            async def main():
                srv = ns.V.ServingServer(sup)
                async with srv.running():
                    async def good():
                        out = []
                        async for ev in srv.agenerate(s.prompts[1],
                                                      max_new_tokens=6,
                                                      eos_token_id=None):
                            if ev["type"] == "token":
                                out.append(ev["token"])
                        return out
                    good_toks, r = await asyncio.gather(
                        good(), ns.chaos.disconnect_mid_stream(
                            srv, s.prompts[0], events=2, max_new_tokens=24,
                            eos_token_id=None))
                    deadline = time.time() + 10
                    while sup.pending and time.time() < deadline:
                        await asyncio.sleep(0.01)
                assert srv.pump_error is None
                return good_toks, r

            good_toks, r = asyncio.run(asyncio.wait_for(main(), 120))
            assert good_toks == dense(s, s.prompts[1], 6)
            assert sup.engine.stats()["cancelled"] >= 1
            recovered(s, sup.engine, s.prompts[0])
            return good_toks, r["events"]

        assert both(scenario, s)[1] == 2

    def test_slow_client_disconnected_not_pinning(self, s):
        def scenario(s, ns):
            sup = supervisor(s, ns)

            async def main():
                srv = ns.V.ServingServer(sup, client_queue=2)
                async with srv.running():
                    r = await ns.chaos.slow_client(
                        srv, s.prompts[0], read_events=1,
                        max_new_tokens=24, eos_token_id=None)
                    deadline = time.time() + 10
                    while sup.pending and time.time() < deadline:
                        await asyncio.sleep(0.01)
                return r

            r = asyncio.run(asyncio.wait_for(main(), 120))
            assert sup.engine.stats()["cancelled"] >= 1
            recovered(s, sup.engine, s.prompts[0])
            return r["events"], r["dropped"], r["disconnected"]

        assert both(scenario, s) == (1, True, True)


class TestFleetChaos:
    def test_injector_registry_has_fleet_trio(self):
        """The port's registry holds every reference injector but the
        launcher's ``stall_heartbeat``, and the kind tuples are the
        reference's."""
        for name in ("replica_kill", "slow_replica", "flaky_probe"):
            assert name in tchaos.INJECTORS
        for kinds in ("TIER", "DISAGG", "DURABLE", "LORA"):
            tup = getattr(tchaos, f"{kinds}_INJECTORS")
            assert tup == getattr(jchaos, f"{kinds}_INJECTORS")
            for name in tup:
                assert name in tchaos.INJECTORS
                assert name not in tchaos.TIMELINE_INJECTORS
        assert tchaos.TIMELINE_INJECTORS == jchaos.TIMELINE_INJECTORS
        assert set(tchaos.INJECTORS) == set(jchaos.INJECTORS) - {
            "stall_heartbeat"}
        assert len(tchaos.INJECTORS) == 25

    @staticmethod
    def balanced(r):
        for rid, part in r.block_partitions().items():
            assert part["in_use"] == 0, (rid, part)
            assert part["free"] + part["evictable"] + part["in_use"] == \
                part["usable"], (rid, part)

    def test_replica_kill_router_fails_over_bit_exact(self, s):
        def scenario(s, ns):
            r = router(s, ns)
            frids = [r.submit(p, max_new_tokens=8, eos_token_id=None)
                     for p in s.prompts]
            r.step(2)
            victim = ns.chaos.replica_kill(r, rid=r.replicas[0])
            while r.pending:
                r.step(2)
            c = r.health_snapshot()["counters"]
            assert c["failovers"] >= 1 and c["failed"] == 0
            outs = [toks(r.result(f)) for f in frids]
            for o, p in zip(outs, s.prompts):
                assert o == dense(s, p, 8)
            self.balanced(r)
            return victim, outs, c["failovers"]

        both(scenario, s)

    def test_slow_replica_hedge_recovers(self, s):
        def scenario(s, ns):
            rc = ns.V.RouterConfig(replicas=2, hedge_ttft_mult=2.0,
                                   ttft_slo_s=0.01, seed=1)
            r = router(s, ns, router_config=rc)
            ns.chaos.slow_replica(r, rid=r.replicas[0], stall_steps=100,
                                  delay_s=0.01)
            frid = r.submit(s.prompts[0], max_new_tokens=6,
                            eos_token_id=None, replica=r.replicas[0])
            steps = 0
            while r.pending and steps < 300:
                r.step(2)
                steps += 1
            c = r.health_snapshot()["counters"]
            assert c["hedges"] >= 1 and c["hedges_cancelled"] >= 1
            out = toks(r.result(frid))
            assert out == dense(s, s.prompts[0], 6)
            self.balanced(r)
            return out

        both(scenario, s)

    def test_flaky_probe_breaker_opens_and_rejoins(self, s):
        def scenario(s, ns):
            r = router(s, ns)
            rep0 = r._replicas[r.replicas[0]]
            rep0.breaker.cooldown_s = 60.0
            st = ns.chaos.flaky_probe(r, rid=rep0.rid, fails=3)
            homes = []
            for _ in range(3):
                f = r.submit(s.prompts[0], max_new_tokens=2,
                             eos_token_id=None)
                homes.append(r.request(f).replica)
                while r.pending:
                    r.step()
            assert rep0.rid not in homes
            opened = rep0.breaker.state
            rep0.breaker.cooldown_s = 0.02
            time.sleep(0.03)
            f = r.submit(s.prompts[1], max_new_tokens=3, eos_token_id=None)
            while r.pending:
                r.step()
            out = toks(r.result(f))
            assert out == dense(s, s.prompts[1], 3)
            self.balanced(r)
            return homes, opened, rep0.breaker.state, st["calls"], out

        got = both(scenario, s)
        assert got[1:4] == ("open", "closed", 3)


class TestInjectorUnits:
    def test_file_injectors_equal_reference(self, tmp_path):
        """``truncate_file`` and ``flip_bits`` hit the same bytes as the
        reference's for the same seed; ``fail_nth`` raises on exactly the
        Nth call and restores the real function."""
        data = bytes(range(256)) * 8
        out = {}
        for ns in (JAX, PORT):
            p = tmp_path / f"{ns.name}.bin"
            p.write_bytes(data)
            size = ns.chaos.truncate_file(str(p), frac=0.25)
            off = ns.chaos.flip_bits(str(p), nbits=5, seed=3)
            out[ns.name] = (size, off, p.read_bytes())
        assert out["port"] == out["jax"]
        size, off, got = out["port"]
        assert size == len(got) == len(data) // 4
        assert got[off] != data[off] and got[:off] == data[:off]
        real = os.path.exists
        with tchaos.fail_nth(os.path, "exists", n=2) as st:
            assert os.path.exists(str(tmp_path))
            with pytest.raises(OSError, match="call #2"):
                os.path.exists(str(tmp_path))
            assert os.path.exists(str(tmp_path))
        assert st["calls"] == 3 and os.path.exists is real

    def test_kill_self_dies_without_grace(self):
        code = ("import atexit, sys\n"
                "from paddle_tpu_torch.testing.chaos import kill_self\n"
                "atexit.register(lambda: print('atexit ran'))\n"
                "kill_self()\n")
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                             env=env, capture_output=True, text=True,
                             timeout=120)
        assert res.returncode == -9 and "atexit ran" not in res.stdout

    def test_adapter_churn_equals_reference(self, s):
        """Seeded cold-adapter rounds on an engine with two adapter slots
        and five adapters touch the same adapters, with the same loads
        and evictions, in both packages; served streams stay equal."""
        def scenario(s, ns):
            eng = engine(s, ns, lora_rank=4, lora_slots=2, lora_pool=8)
            assert ns.chaos.adapter_churn(eng)["enabled"] is False
            for i in range(5):
                eng.register_adapter(f"a{i}", lora_init_params(
                    s.cfg, 4, seed=i, scale=0.5))
            out = []
            for seed in (0, 1):
                r = ns.chaos.adapter_churn(eng, rounds=4, seed=seed)
                out.append((r["touched"], r["loads"], r["evictions"]))
                rid = eng.submit(s.prompts[0], max_new_tokens=4,
                                 eos_token_id=None, adapter_id="a3")
                while eng.pending:
                    eng.step()
                out.append(toks(eng.request(rid).output()))
            return out

        got = both(scenario, s)
        assert got[1] == got[3]
        assert got[0][1] >= 1

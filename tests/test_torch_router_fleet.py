"""The port's fleet router under durability, adapters, embeddings and the
fleet injectors, against the JAX package's.

Mirrors ``TestRouterColdStart`` (``tests/test_journal.py``), the router
tests of ``TestDurabilityAndFleet`` and ``TestEmbeddings``
(``tests/test_lora.py``) and ``TestFleetChaos`` (``tests/test_chaos.py``).
Each scenario runs on the JAX ``ServingRouter`` and on the port's with
the same weights and trace; streams and router counters must be equal.
The JAX package's chaos injectors — ``process_kill``, ``replica_kill``,
``slow_replica``, ``flaky_probe``, ``kill_prefill_replica`` and
``stale_directory`` — drive the port's router unchanged.
"""

import time
import types

import jax
import numpy as np
import pytest
import torch

import paddle_tpu.inference.serving as JV
from paddle_tpu.models import llama as JL
from paddle_tpu.models.bert import BertConfig as JBertConfig
from paddle_tpu.models.bert import bert_init_params as j_bert_init
from paddle_tpu.models.lora import lora_init_params
from paddle_tpu.testing import chaos

import paddle_tpu_torch.inference.serving as TV
from paddle_tpu_torch.models.bert import BertConfig as TBertConfig
from paddle_tpu_torch.models.convert import (bert_params_from_jax,
                                             config_from_jax, params_from_jax)

torch.set_num_threads(2)

JAX = types.SimpleNamespace(name="jax", V=JV)
PORT = types.SimpleNamespace(name="port", V=TV)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def both(scenario, s, *args, **kw):
    want = scenario(s, JAX, *args, **kw)
    got = scenario(s, PORT, *args, **kw)
    assert got == want
    return got


def counters(r):
    return dict(r.health_snapshot()["counters"])


def res(r, frids):
    return [[int(t) for t in r.result(f)] for f in frids]


def balanced(ns, r):
    ns.V.InvariantAuditor().check(r)
    parts = r.block_partitions()
    assert all(p["in_use"] == 0 for p in parts.values()), parts


# ---------------------------------------------------------------------------
# router cold start from one fleet-wide journal
# ---------------------------------------------------------------------------

SC = dict(block_size=4, max_slots=2, max_model_len=32, decode_chunk=2,
          queue_depth=64)


def trace_spec():
    rng = np.random.default_rng(3)

    def p(n):
        return [int(t) for t in rng.integers(0, 97, (n,))]

    return [dict(prompt=p(12), max_new_tokens=5),
            dict(prompt=p(5), max_new_tokens=6),
            dict(prompt=p(7), max_new_tokens=4),
            dict(prompt=p(4), max_new_tokens=7),
            dict(prompt=p(6), max_new_tokens=5, temperature=0.8, top_k=20,
                 seed=11)]


def submit_trace(target):
    return [target.submit(np.asarray(s["prompt"], np.int32),
                          eos_token_id=None,
                          **{k: v for k, v in s.items() if k != "prompt"})
            for s in trace_spec()]


@pytest.fixture(scope="module")
def jsetup():
    cfg = JL.LlamaConfig(vocab_size=97, hidden_size=64,
                         intermediate_size=96, num_hidden_layers=3,
                         num_attention_heads=4, num_key_value_heads=2,
                         max_position_embeddings=64)
    params = JL.init_params(cfg, jax.random.PRNGKey(0))
    sup = JV.EngineSupervisor(params, cfg, JV.ServingConfig(**SC),
                              journal=None)
    srids = submit_trace(sup)
    out = {}
    while sup.pending:
        for rid, toks in sup.step(max_iters=1).items():
            out.setdefault(rid, []).extend(int(t) for t in toks)
    return types.SimpleNamespace(
        jax=(params, cfg, {"programs": sup.engine.programs}),
        port=(params_from_jax(_np(params), device="cpu"),
              config_from_jax(cfg), {"device": "cpu"}),
        want=[out.get(s, []) for s in srids])


class TestRouterColdStart:
    def _drive(self, rt, pre):
        steps = 0
        while rt.pending:
            for frid, toks in rt.step(max_iters=1).items():
                pre.setdefault(rt._reqs[frid].jid, []).extend(
                    int(t) for t in toks)
            assert rt.audit()["violations"] == []
            steps += 1
            assert steps < 400
        return pre

    def _kill_and_recover(self, s, ns, jdir, rc, kill_at):
        params, cfg, kw = getattr(s, ns.name)
        V = ns.V
        rt = V.ServingRouter(params, cfg, V.ServingConfig(**SC),
                             router_config=V.RouterConfig(**rc),
                             journal=V.RequestJournal(str(jdir)), **kw)
        frids = submit_trace(rt)
        jids = [rt._reqs[f].jid for f in frids]
        pre = {jid: [] for jid in jids}
        for _ in range(kill_at):
            for frid, toks in rt.step(max_iters=1).items():
                pre[rt._reqs[frid].jid].extend(int(t) for t in toks)
        assert chaos.process_kill(rt)["enabled"]
        rt2 = V.ServingRouter.cold_start(str(jdir), params, cfg,
                                         V.ServingConfig(**SC),
                                         router_config=V.RouterConfig(**rc),
                                         **kw)
        recovered = rt2.cold_recovered
        got = self._drive(rt2, pre)
        return [got[j] for j in jids], recovered, counters(rt2)

    @pytest.mark.parametrize("kill_at", [0, 2, 6])
    def test_cold_start_resumes_the_fleet(self, jsetup, tmp_path, kill_at):
        rc = dict(replicas=2, hedge_ttft_mult=0)

        def run(s, ns):
            return self._kill_and_recover(s, ns, tmp_path / ns.name, rc,
                                          kill_at)

        got, recovered, _ = both(run, jsetup)
        assert got == jsetup.want
        assert recovered >= 1 or kill_at == 0

    def test_cold_start_through_disagg_handoff(self, jsetup, tmp_path):
        rc = dict(replicas=2, hedge_ttft_mult=0, prefill_replicas=1,
                  prefill_len_threshold=8)

        def run(s, ns):
            return [self._kill_and_recover(s, ns,
                                           tmp_path / f"{ns.name}{k}", rc,
                                           k)
                    for k in (1, 2, 3, 4)]

        for got, _, _ in both(run, jsetup):
            assert got == jsetup.want


# ---------------------------------------------------------------------------
# adapters and embeddings through the fleet
# ---------------------------------------------------------------------------

LCFG = JL.LlamaConfig(vocab_size=128, hidden_size=64, intermediate_size=128,
                      num_hidden_layers=2, num_attention_heads=4,
                      num_key_value_heads=2, max_position_embeddings=128)
BCFG = dict(vocab_size=128, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=64,
            max_position_embeddings=64)
LBASE = dict(block_size=8, max_slots=4, max_model_len=96, queue_depth=16,
             decode_chunk=4, lora_rank=4, lora_slots=2, lora_pool=8)


@pytest.fixture(scope="module")
def lsetup():
    params = JL.init_params(LCFG, jax.random.PRNGKey(0))
    bp = j_bert_init(JBertConfig(**BCFG), seed=3)
    rng = np.random.default_rng(7)
    return types.SimpleNamespace(
        jax=(params, LCFG, (JBertConfig(**BCFG), bp)),
        port=(params_from_jax(_np(params), device="cpu"),
              config_from_jax(LCFG),
              (TBertConfig(**BCFG), bert_params_from_jax(_np(bp),
                                                         device="cpu"))),
        adapters={f"a{i}": lora_init_params(LCFG, 4, seed=i, scale=0.5)
                  for i in range(1, 3)},
        prompts=[rng.integers(0, 128, (int(n),)).astype(np.int32)
                 for n in (5, 8)],
        programs={})


def lrouter(ls, ns, replicas=2):
    params, cfg, bert = getattr(ls, ns.name)
    V = ns.V
    if ns is JAX:
        r = V.ServingRouter(params, cfg, V.ServingConfig(**LBASE),
                            replicas=replicas, embed_model=bert,
                            programs=ls.programs.get("lora"))
        ls.programs.setdefault("lora", r._programs)
        return r
    return V.ServingRouter(params, cfg, V.ServingConfig(**LBASE),
                           replicas=replicas, embed_model=bert,
                           device="cpu")


def lone(ls, ns, prompts, aids):
    """The single-engine oracle: one replica, no fault."""
    r = lrouter(ls, ns, replicas=1)
    for name, ap in ls.adapters.items():
        r.register_adapter(name, ap)
    frids = [r.submit(p, max_new_tokens=10, eos_token_id=None, adapter_id=a)
             for p, a in zip(prompts, aids)]
    while r.pending:
        r.step()
    return res(r, frids)


class TestAdaptersAndEmbeddings:
    def test_failover_preserves_adapter(self, lsetup):
        def run(ls, ns):
            aids = ["a1", "a2"]
            want = lone(ls, ns, ls.prompts, aids)
            r = lrouter(ls, ns)
            for name, ap in ls.adapters.items():
                r.register_adapter(name, ap)
            frids = [r.submit(p, max_new_tokens=10, eos_token_id=None,
                              adapter_id=a)
                     for p, a in zip(ls.prompts, aids)]
            delivered = {f: [] for f in frids}
            for f, toks in r.step(1).items():
                delivered[f].extend(int(t) for t in toks)
            chaos.replica_kill(r, rid=r.replicas[0])
            steps = 0
            while r.pending and steps < 300:
                for f, toks in r.step(2).items():
                    delivered[f].extend(int(t) for t in toks)
                steps += 1
            balanced(ns, r)
            return want, [delivered[f] for f in frids], counters(r)

        want, got, c = both(run, lsetup)
        assert got == want and want[0] != want[1]
        assert c["failed"] == 0 and c["failovers"] >= 1

    def test_router_rejects_unregistered_adapter(self, lsetup):
        def run(ls, ns):
            r = lrouter(ls, ns, replicas=1)
            with pytest.raises(ValueError, match="not registered"):
                r.submit(ls.prompts[0], max_new_tokens=2, adapter_id="nope")
            return r.adapter_registered("nope")

        assert both(run, lsetup) is False

    def test_adapter_affinity_routing(self, lsetup):
        def run(ls, ns):
            r = lrouter(ls, ns)
            for name, ap in ls.adapters.items():
                r.register_adapter(name, ap)
            frids = []
            for _ in range(4):
                frids.append(r.submit(ls.prompts[0], max_new_tokens=2,
                                      eos_token_id=None, adapter_id="a1"))
                while r.pending:
                    r.step()
            return ([r.request(f).state for f in frids], res(r, frids),
                    counters(r))

        states, _, c = both(run, lsetup)
        assert set(states) == {"finished"}
        assert c["adapter_affinity_hits"] >= 3 and c["adapter_loads"] >= 1

    def test_router_embed_batch(self, lsetup):
        rows = {}
        for ns in (JAX, PORT):
            r = lrouter(lsetup, ns)
            rng = np.random.default_rng(9)
            ps = [rng.integers(0, 128, (int(n),)).astype(np.int32)
                  for n in (5, 8)]
            rows[ns.name] = r.embed(ps)
            assert rows[ns.name].shape == (2, BCFG["hidden_size"])
            assert r.routed == 2
        ref = rows["jax"]
        np.testing.assert_allclose(rows["port"], ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max())


# ---------------------------------------------------------------------------
# the fleet injectors on the port's router
# ---------------------------------------------------------------------------

FBASE = dict(block_size=4, max_slots=2, max_model_len=32, decode_chunk=2,
             queue_depth=8)


@pytest.fixture(scope="module")
def fsetup():
    cfg = JL.LlamaConfig(vocab_size=97, hidden_size=64,
                         intermediate_size=96, num_hidden_layers=2,
                         num_attention_heads=4, num_key_value_heads=2,
                         max_position_embeddings=64)
    params = JL.init_params(cfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    return types.SimpleNamespace(
        jax=(params, cfg), port=(params_from_jax(_np(params), device="cpu"),
                                 config_from_jax(cfg)),
        prompts=[rng.integers(0, 97, (s,)).astype(np.int32)
                 for s in [9, 5, 12, 7]], programs={})


def frouter(fs, ns, rc=None, **kw):
    params, cfg = getattr(fs, ns.name)
    V = ns.V
    sc = {**FBASE, **kw}
    rkw = dict(router_config=V.RouterConfig(**rc) if rc else None,
               replicas=None if rc else 2)
    if ns is JAX:
        r = V.ServingRouter(params, cfg, V.ServingConfig(**sc),
                            programs=fs.programs.get("f"), **rkw)
        fs.programs.setdefault("f", r._programs)
        return r
    return V.ServingRouter(params, cfg, V.ServingConfig(**sc),
                           device="cpu", **rkw)


class TestFleetChaos:
    def test_replica_kill_router_fails_over_bit_exact(self, fsetup):
        def run(fs, ns):
            r = frouter(fs, ns)
            frids = [r.submit(p, max_new_tokens=8, eos_token_id=None)
                     for p in fs.prompts]
            r.step(2)
            chaos.replica_kill(r, rid=r.replicas[0])
            while r.pending:
                r.step(2)
            balanced(ns, r)
            return res(r, frids), counters(r)

        _, c = both(run, fsetup)
        assert c["failovers"] >= 1 and c["failed"] == 0

    def test_slow_replica_hedge_recovers(self, fsetup):
        def run(fs, ns):
            r = frouter(fs, ns, rc=dict(replicas=2, hedge_ttft_mult=2.0,
                                        ttft_slo_s=0.01, seed=1))
            chaos.slow_replica(r, rid=r.replicas[0], stall_steps=100,
                               delay_s=0.01)
            frid = r.submit(fs.prompts[0], max_new_tokens=6,
                            eos_token_id=None, replica=r.replicas[0])
            steps = 0
            while r.pending and steps < 300:
                r.step(2)
                steps += 1
            balanced(ns, r)
            c = counters(r)
            return res(r, [frid]), c["hedges"] >= 1, \
                c["hedges_cancelled"] >= 1

        assert both(run, fsetup)[1:] == (True, True)

    def test_flaky_probe_breaker_opens_and_rejoins(self, fsetup):
        def run(fs, ns):
            r = frouter(fs, ns)
            rep0 = r._replicas[r.replicas[0]]
            rep0.breaker.cooldown_s = 60.0
            chaos.flaky_probe(r, rid=rep0.rid, fails=3)
            hs = []
            for _ in range(3):
                f = r.submit(fs.prompts[0], max_new_tokens=2,
                             eos_token_id=None)
                hs.append(r.request(f).replica)
                while r.pending:
                    r.step()
            opened = rep0.breaker.state
            rep0.breaker.cooldown_s = 0.02
            time.sleep(0.03)
            f = r.submit(fs.prompts[1], max_new_tokens=3, eos_token_id=None)
            while r.pending:
                r.step()
            balanced(ns, r)
            return hs, opened, rep0.breaker.state, res(r, [f])

        hs, opened, closed, _ = both(run, fsetup)
        assert 0 not in hs and opened == "open" and closed == "closed"

    def test_kill_prefill_replica_collapses_to_unified(self, fsetup):
        """A prefill replica dying with long prompts staged on it: every
        request lands on a decode replica through failover, zero failed,
        and later long prompts take the unified path."""
        def run(fs, ns):
            rng = np.random.default_rng(41)
            longs = [rng.integers(0, 97, (16,)).astype(np.int32)
                     for _ in range(3)]
            r = frouter(fs, ns, rc=dict(replicas=2, prefill_replicas=1,
                                        prefill_len_threshold=8),
                        prefill_chunk=4)
            frids = [r.submit(p, max_new_tokens=4, eos_token_id=None)
                     for p in longs[:2]]
            r.step(1)
            st = chaos.kill_prefill_replica(r)
            r.step(1)                     # the armed crash fires
            frids.append(r.submit(longs[2], max_new_tokens=4,
                                  eos_token_id=None))
            steps = 0
            while r.pending and steps < 300:
                r.step(1)
                steps += 1
            roles = [r._replicas[r.request(f).replica].role for f in frids]
            balanced(ns, r)
            return st, res(r, frids), roles, counters(r)

        st, _, roles, c = both(run, fsetup)
        assert st == {"rid": 2, "enabled": True}
        assert roles == ["decode"] * 3 and c["failed"] == 0
        assert c["prefill_routed"] == 2

    def test_stale_directory_degrades_to_recompute(self, fsetup):
        def run(fs, ns):
            rng = np.random.default_rng(43)
            prefix = rng.integers(0, 97, (12,)).astype(np.int32)
            r = frouter(fs, ns, prefix_cache=True)
            r0, r1 = r.replicas
            r.submit(np.concatenate([prefix, [3]]), max_new_tokens=2,
                     eos_token_id=None, replica=r0)
            while r.pending:
                r.step()
            st = chaos.stale_directory(r, seed=0)
            f = r.submit(np.concatenate([prefix, [4, 5]]), max_new_tokens=4,
                         eos_token_id=None, replica=r1)
            while r.pending:
                r.step()
            balanced(ns, r)
            return st["enabled"], st["rid"], res(r, [f]), counters(r)

        enabled, rid, _, c = both(run, fsetup)
        assert enabled and rid == 0
        assert c["pull_fallbacks"] == 1 and c["failed"] == 0

"""The port's workload replay (``paddle_tpu_torch.inference.serving.workload``)
and chaos timeline against the JAX package's.

* The trace is the same pure function of the spec in both packages:
  ``generate_trace`` equal field by field for the default spec, a bursty
  one, an adapter mix and a long-prompt mix.
* The manifest is the same record: ``ReplayManifest.to_json`` equal for
  the same spec, configs and chaos, and a manifest the JAX package wrote
  replays in the port to the JAX run's report.
* ``chaos_timeline`` schedules, the kind tuples and ``capacity_report``
  (fp / int8 x tp 1/2/4/8 at ``hbm_gb=16.0``) are equal.
* ``run_replay`` on both packages with one manifest gives equal outcomes,
  completed, retries, sheds and steps, equal step-indexed TTFT
  percentiles, equal chaos, autoscale and audit logs and equal recorded
  streams — mirrors of ``tests/test_replay.py``'s ``TestRetryBackoff``,
  ``TestReplayDeterminism``, ``TestReplaySmoke``,
  ``TestSurvivableKVReplay``, ``TestDisaggReplay`` and
  ``TestMixedBatchReplay``, each holding the port to the reference's own
  assertions as well. Wall-clock fields (seconds, ``*_s`` percentiles,
  goodput) and ``chips`` are not compared: the port counts devices where
  the reference counts replicas.

Both packages' ``ServingConfig`` take ``paged_kernel=False`` here: the
reference resolves its ``"auto"`` to ``False`` off the TPU at
construction, the port keeps ``"auto"`` until the engine resolves it
for its device, and the manifests record the resolved field.
"""

import dataclasses
import types

import jax
import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu.inference.serving as JV
from paddle_tpu.models import generation as JG
from paddle_tpu.models import llama as JL
from paddle_tpu.testing import chaos as jchaos

import paddle_tpu_torch.inference.serving as TV
from paddle_tpu_torch import flags as TF
from paddle_tpu_torch.inference.serving import workload as TW
from paddle_tpu_torch.models import generation as TG
from paddle_tpu_torch.models.convert import config_from_jax, params_from_jax
from paddle_tpu_torch.testing import chaos as tchaos

pytestmark = pytest.mark.replay

torch.set_num_threads(2)

BASE = dict(block_size=4, max_slots=2, max_model_len=32, decode_chunk=2,
            queue_depth=4, prefill_chunk=None, paged_kernel=False)
FLEET = dict(breaker_cooldown_s=0.0, hedge_ttft_mult=0.0)
JAX = types.SimpleNamespace(name="jax", V=JV, chaos=jchaos)
PORT = types.SimpleNamespace(name="port", V=TV, chaos=tchaos)

# every report field keyed to steps, counts or the trace (not the clock)
STEP_KEYS = ("requests", "outcomes", "completed", "failed", "gave_up",
             "retries", "shed_submits", "steps", "tokens_delivered",
             "good_tokens", "mean_fleet", "tp", "ttft_steps_p50",
             "ttft_steps_p99", "arrival_ttft_steps_p50",
             "arrival_ttft_steps_p99", "pre_spawn_ttft_p99_steps",
             "post_spawn_ttft_p99_steps", "ttft_p99_at_spawn_steps",
             "ttft_p99_after_spawn_steps", "autoscale", "chaos_fired",
             "chaos_kinds", "violations", "audit", "audit_trail",
             "router_failed", "adapter_requests", "adapter_affinity_hits",
             "adapter_loads", "leaked_blocks", "prompt_len_mean",
             "manifest_json")


def tiny_cfg():
    return JL.LlamaConfig(vocab_size=97, hidden_size=64,
                          intermediate_size=96, num_hidden_layers=2,
                          num_attention_heads=4, num_key_value_heads=2,
                          max_position_embeddings=64)


@pytest.fixture(scope="module")
def setup():
    cfg = tiny_cfg()
    params = JL.init_params(cfg, jax.random.PRNGKey(0))
    donor = JV.ServingRouter(params, cfg, JV.ServingConfig(**BASE),
                             replicas=1)
    p = np.arange(1, 8, dtype=np.int32)
    donor.run([p, p[:4]], max_new_tokens=[2, 2], eos_token_id=None)
    return types.SimpleNamespace(
        cfg=cfg, params=params, programs=donor._programs,
        tcfg=config_from_jax(cfg),
        tparams=params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                                device="cpu"))


def small_spec(ns=PORT, **kw):
    base = dict(requests=60, seed=5, prefix_len=8, tail_lens=(2, 3, 4),
                output_lens=(3, 4, 6), horizon_steps=36,
                autoscale_every=8, audit_every=4)
    base.update(kw)
    return ns.V.WorkloadSpec(**base)


def replay(s, ns, spec_kw=None, sc_kw=None, rc_kw=None, kinds=None,
           events=None, seed_offset=1, programs=True, **kw):
    """``run_replay`` of package ``ns`` on the module's weights: the spec,
    the ServingConfig and RouterConfig overrides and the chaos timeline
    are built from plain arguments in that package (``kinds``/``events``
    give an explicit ``chaos_timeline``)."""
    V = ns.V
    if spec_kw is not None:
        kw["spec"] = small_spec(ns, **spec_kw)
        if kinds is not None:
            kw["chaos"] = ns.chaos.chaos_timeline(
                kw["spec"].seed + seed_offset, kw["spec"].horizon,
                kinds=kinds, events=events)
    if sc_kw is not None:
        kw["serving_config"] = V.ServingConfig(**{**BASE, **sc_kw})
    if rc_kw is not None:
        kw["router_config"] = V.RouterConfig(**{**FLEET, **rc_kw})
    if ns is JAX:
        return V.run_replay(s.params, s.cfg,
                            programs=s.programs if programs else None, **kw)
    kw.setdefault("hbm_gb", 16.0)
    return V.run_replay(s.tparams, s.tcfg, device="cpu", **kw)


def assert_same(want, got, streams=False):
    for k in STEP_KEYS + (("streams",) if streams else ()):
        assert got[k] == want[k], (k, want[k], got[k])
    for k in set(want["capacity"]) - {"measured", "sizing"}:
        assert got["capacity"][k] == want["capacity"][k], k


def both(s, **kw):
    """The same replay on the JAX package and the port; every step-keyed
    field equal. Returns (jax report, port report)."""
    want = replay(s, JAX, **kw)
    got = replay(s, PORT, **kw)
    assert_same(want, got, streams=kw.get("record_streams", False))
    return want, got


def check_clean(rep):
    """The reference's acceptance spelling of a clean replay."""
    assert rep["violations"] == []
    assert rep["failed"] == 0 and rep["router_failed"] == 0
    assert rep["gave_up"] == 0
    assert rep["leaked_blocks"] == 0
    assert rep["drain_report"]["leaked_blocks"] == 0


# ---------------------------------------------------------------------------
# the trace, the manifest, the timeline, the capacity arithmetic
# ---------------------------------------------------------------------------

TRACE_SPECS = {
    "default": {},
    "bursty": dict(arrival="bursty", burstiness=6.0, burst_frac=0.3),
    "adapters": dict(adapters=5, adapter_frac=0.6),
    "long_prompts": dict(long_prompt_frac=0.4, long_prompt_len=64),
}


@pytest.mark.parametrize("name", sorted(TRACE_SPECS))
def test_generate_trace_equals_reference(name):
    kw = TRACE_SPECS[name]
    want = JV.generate_trace(JV.WorkloadSpec(**kw))
    got = TV.generate_trace(TV.WorkloadSpec(**kw))
    assert len(got) == len(want) == JV.WorkloadSpec().requests
    for a, b in zip(want, got):
        for f in dataclasses.fields(JV.TraceRequest):
            x, y = getattr(a, f.name), getattr(b, f.name)
            if f.name == "prompt":
                assert x.dtype == y.dtype
                np.testing.assert_array_equal(x, y)
            else:
                assert x == y and type(x) is type(y), (f.name, x, y)


class TestManifest:
    def test_to_json_equals_reference(self):
        out = {}
        for ns in (JAX, PORT):
            spec = small_spec(ns)
            tl = ns.chaos.chaos_timeline(7, spec.horizon, events=4)
            m = ns.V.ReplayManifest.capture(
                spec, tl, serving_config=ns.V.ServingConfig(**BASE),
                router_config=ns.V.RouterConfig(replicas=2, **FLEET),
                replicas=2)
            out[ns.name] = m
        assert out["port"].to_json() == out["jax"].to_json()
        assert out["port"].tag == out["jax"].tag
        assert "FLAGS_serving_client_queue" in out["port"].flags
        # each package reads the other's JSON
        for src, dst in (("jax", TV), ("port", JV)):
            m = dst.ReplayManifest.from_json(out[src].to_json())
            assert m.workload().asdict() == small_spec().asdict()
            assert m.timeline().spec() == out[src].timeline().spec()

    def test_jax_manifest_replays_in_port(self, setup):
        want = replay(setup, JAX, spec_kw=dict(requests=30, seed=11,
                                               horizon_steps=20),
                      sc_kw={}, replicas=2, chaos_events=3,
                      record_streams=True)
        m = TV.ReplayManifest.from_json(want["manifest_json"])
        got = replay(setup, PORT, manifest=m, record_streams=True)
        assert_same(want, got, streams=True)


@pytest.mark.parametrize("extra", ["", "TIER", "DISAGG", "DURABLE", "LORA"])
def test_chaos_timeline_equals_reference(extra):
    kinds = {}
    for ns in (JAX, PORT):
        kinds[ns.name] = ns.chaos.TIMELINE_INJECTORS + (
            getattr(ns.chaos, f"{extra}_INJECTORS") if extra else ())
    assert kinds["port"] == kinds["jax"]
    for seed, horizon, events in ((3, 100, 6), (11, 37, 9), (0, 2000, 8)):
        want = jchaos.chaos_timeline(seed, horizon, kinds=kinds["jax"],
                                     events=events)
        got = tchaos.chaos_timeline(seed, horizon, kinds=kinds["port"],
                                    events=events)
        assert got.spec() == want.spec()


def test_chaos_timeline_seeded_and_step_indexed():
    tl = tchaos.chaos_timeline(3, 100, events=6)
    assert tl.spec() == tchaos.chaos_timeline(3, 100, events=6).spec()
    assert {e.name for e in tl.events} == set(tchaos.TIMELINE_INJECTORS)
    assert all(0 < e.step < 100 for e in tl.events)
    due = tl.due(100)
    assert len(due) == 6 and tl.remaining == 0


def a_width_cfg():
    """The full-width model's shape (vocab 32000, hidden 2048, 16 kv
    heads): every tp of 1/2/4/8 divides its kv heads."""
    return JL.LlamaConfig(vocab_size=32000, hidden_size=2048,
                          intermediate_size=5504, num_hidden_layers=12,
                          num_attention_heads=16, num_key_value_heads=16)


MEASURED = {"req_s": 3.5, "mean_fleet": 2.5, "goodput_tok_s_per_chip": 41.2,
            "ttft_s_p50": 0.12, "ttft_s_p99": 0.9, "tpot_s_p50": 0.02,
            "tpot_s_p99": 0.05}


@pytest.mark.parametrize("model", ["tiny", "a_width"])
@pytest.mark.parametrize("kv_quant", [None, "int8"])
@pytest.mark.parametrize("tier", ["off", "blocks", "host_gb"])
def test_capacity_report_equals_reference(model, kv_quant, tier):
    cfg = tiny_cfg() if model == "tiny" else a_width_cfg()
    sc = dict(block_size=16, max_slots=8, kv_quant=kv_quant)
    if tier != "off":
        sc.update(offload=True, offload_blocks=64)
    host_gb = 2.0 if tier == "host_gb" else 0.0
    want = JV.capacity_report(cfg, JV.ServingConfig(**sc),
                              measured=MEASURED, mean_seq_tokens=57.3,
                              hbm_gb=16.0, host_gb=host_gb)
    got = TV.capacity_report(config_from_jax(cfg), TV.ServingConfig(**sc),
                             measured=MEASURED, mean_seq_tokens=57.3,
                             hbm_gb=16.0, host_gb=host_gb)
    assert got == want
    layouts = {f"{kv}_tp{tp}" for kv in ("fp", "int8") for tp in (1, 2)}
    if model == "a_width":
        layouts |= {f"{kv}_tp{tp}" for kv in ("fp", "int8") for tp in (4, 8)}
    assert set(got["layouts"]) == layouts


def test_paged_pool_block_bytes_and_validate_tp_equal_reference():
    for cfg in (tiny_cfg(), a_width_cfg()):
        tcfg = config_from_jax(cfg)
        for tp in (0, 1, 2, 3, 4, 8, 16, 32):
            for kv in (None, "int8"):
                try:
                    want = JG.paged_pool_block_bytes(cfg, 16, kv_quant=kv,
                                                     tp=tp)
                except ValueError as e:
                    with pytest.raises(ValueError) as got:
                        TG.paged_pool_block_bytes(tcfg, 16, kv_quant=kv,
                                                  tp=tp)
                    assert str(got.value) == str(e)
                    continue
                assert TG.paged_pool_block_bytes(
                    tcfg, 16, kv_quant=kv, tp=tp) == want
    # the degrees the arithmetic covers are served: tp=2 is accepted
    assert TV.ServingConfig(tp=2).tp == 2


def test_hbm_budget_defaults_to_the_device_memory(monkeypatch):
    """``hbm_gb=None`` reads the card's memory; the CPU has none to read
    and asks for the budget."""
    cfg, sc = config_from_jax(tiny_cfg()), TV.ServingConfig(block_size=16)
    with pytest.raises(ValueError, match="hbm_gb"):
        TW._device_memory_gb("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda d: types.SimpleNamespace(
                            total_memory=80 * 2**30))
    assert TV.capacity_report(cfg, sc) == \
        TV.capacity_report(cfg, sc, hbm_gb=80.0)


# ---------------------------------------------------------------------------
# run_replay, both packages on one manifest
# ---------------------------------------------------------------------------

class TestRetryBackoff:
    SPEC = dict(requests=40, horizon_steps=10, seed=9, output_lens=(4, 6),
                misbehavior_frac=0.0, deadline_frac=0.0, autoscale_every=0,
                audit_every=8)

    def _replay(self, s, ns, policy):
        return replay(s, ns, spec_kw=dict(self.SPEC, retry_policy=policy),
                      sc_kw=dict(queue_depth=3), replicas=1, chaos=None)

    def test_storm_sheds_honoring_converges(self, setup):
        """Storm and fixed backoff are step-keyed: equal in both
        packages. The hint policy honors the wall clock, so it runs on
        the port alone, held to the reference's assertions."""
        runs = {}
        for policy in ("storm", "fixed"):
            want = self._replay(setup, JAX, policy)
            runs[policy] = self._replay(setup, PORT, policy)
            assert_same(want, runs[policy])
        TF.set_flags({"FLAGS_serving_retry_after_s": 0.05})
        try:
            honor = self._replay(setup, PORT, "hint")
        finally:
            TF.set_flags({"FLAGS_serving_retry_after_s": 1.0})
        storm, fixed = runs["storm"], runs["fixed"]
        assert honor["gave_up"] == 0 and honor["failed"] == 0
        assert honor["completed"] == honor["requests"]
        assert storm["shed_submits"] >= 1.5 * max(honor["shed_submits"], 1)
        assert storm["retries"] > honor["retries"]
        assert fixed["gave_up"] == 0
        assert fixed["completed"] == fixed["requests"]
        assert fixed["shed_submits"] < storm["shed_submits"]


class TestReplayDeterminism:
    def test_same_manifest_bit_identical_incl_rebuilt_router(self, setup):
        """Both packages' first replays are equal; the port's replay of
        its manifest onto a freshly built router repeats its streams,
        chaos order, audit trail and outcomes."""
        _, one = both(setup, spec_kw={}, sc_kw={}, replicas=2,
                      chaos_events=6, record_streams=True)
        assert one["violations"] == [] and one["leaked_blocks"] == 0
        rebuilt = TV.ServingRouter(
            setup.tparams, setup.tcfg, TV.ServingConfig(**BASE),
            router_config=TV.RouterConfig(replicas=2, **FLEET),
            device="cpu")
        two = replay(setup, PORT, manifest=one["manifest"], router=rebuilt,
                     record_streams=True)
        assert two["streams"] == one["streams"]
        assert two["chaos_fired"] == one["chaos_fired"]
        assert two["audit_trail"] == one["audit_trail"]
        assert two["audit"] == one["audit"]
        assert two["outcomes"] == one["outcomes"]
        rebuilt.close(0)

    def test_manifest_json_roundtrip_replays_identically(self, setup):
        _, one = both(setup, spec_kw=dict(requests=30, horizon_steps=20,
                                          seed=11),
                      sc_kw={}, replicas=2, chaos_events=3,
                      record_streams=True)
        m = TV.ReplayManifest.from_json(one["manifest_json"])
        two = replay(setup, PORT, manifest=m, sc_kw={}, replicas=2,
                     record_streams=True)
        assert two["streams"] == one["streams"]
        assert two["audit"] == one["audit"]


class TestReplaySmoke:
    def test_small_fleet_replay_clean(self, setup):
        _, rep = both(setup, spec_kw=dict(audit_every=2), sc_kw={},
                      replicas=3, chaos_events=6)
        check_clean(rep)
        assert rep["completed"] >= rep["requests"] * 0.7
        assert len(rep["chaos_kinds"]) >= 4
        assert rep["goodput_tok_s_per_chip"] > 0
        cap = rep["capacity"]
        assert cap["layouts"]["fp_tp1"]["concurrent_seqs_per_chip"] > 0
        assert cap["layouts"]["int8_tp1"]["blocks_per_chip"] > \
            cap["layouts"]["fp_tp1"]["blocks_per_chip"]
        assert "tp2" in "".join(cap["layouts"])      # kv_heads=2 shards
        assert "sizing" in cap and "req/s" in cap["sizing"]

    def test_autoscale_actuates_and_improves_arrival_p99(self, setup):
        spec = dict(requests=90, horizon_steps=40, output_lens=(3, 4, 6, 8))
        _, auto = both(setup, spec_kw=spec, sc_kw={}, replicas=2,
                       chaos_events=6)
        _, fixed = both(setup, spec_kw=dict(spec, autoscale_every=0),
                        sc_kw={}, replicas=2, chaos_events=6)
        assert auto["autoscale"]["spawns"] >= 1
        assert auto["autoscale"]["drains"] >= 1
        assert fixed["autoscale"]["spawns"] == 0
        assert auto["failed"] == 0 and fixed["failed"] == 0
        assert auto["arrival_ttft_steps_p99"] < \
            fixed["arrival_ttft_steps_p99"]
        assert auto["steps"] < fixed["steps"]

    def test_three_replicas_on_one_device_are_one_chip(self, setup):
        """The port counts devices, not replicas: a fleet of three
        replicas on one device reports ``chips == 1.0`` (the reference,
        one device a replica, reports its mean fleet size), and the
        goodput per chip is the fleet's goodput."""
        want, got = both(setup, spec_kw=dict(requests=30, horizon_steps=20,
                                             autoscale_every=0),
                         sc_kw={}, replicas=3, chaos=None)
        assert got["mean_fleet"] == want["mean_fleet"] == 3.0
        assert want["chips"] == want["mean_fleet"]
        assert got["chips"] == 1.0
        assert got["goodput_tok_s_per_chip"] == got["goodput_tok_s"]


@pytest.mark.slow
class TestFleetReplay10k:
    def test_10k_fleet_replay_and_bit_exact_rerun(self, setup):
        spec = dict(requests=10_000, horizon_steps=2000, tenants=16,
                    families=6, output_lens=(2, 3, 4, 6, 8, 12),
                    audit_every=64, autoscale_every=32, max_attempts=400)
        sc = dict(max_slots=4, queue_depth=16, max_model_len=40)
        one = replay(setup, PORT, spec_kw=spec, sc_kw=sc, replicas=3,
                     chaos_events=8, record_streams=True)
        check_clean(one)
        assert len(one["chaos_kinds"]) >= 4
        assert one["autoscale"]["spawns"] >= 1
        assert one["autoscale"]["drains"] >= 1
        assert one["goodput_tok_s_per_chip"] > 0
        assert one["capacity"]["sizing"]
        assert one["requests"] == 10_000
        two = replay(setup, PORT, manifest=one["manifest"], sc_kw=sc,
                     replicas=3, record_streams=True)
        assert two["streams"] == one["streams"]
        assert two["chaos_fired"] == one["chaos_fired"]
        assert two["audit_trail"] == one["audit_trail"]
        assert two["audit"] == one["audit"]


class TestSurvivableKVReplay:
    def test_tier_and_migration_replay_clean(self, setup):
        _, rep = both(setup, spec_kw={},
                      kinds=tchaos.TIMELINE_INJECTORS + tchaos.TIER_INJECTORS,
                      events=8,
                      sc_kw=dict(offload=True, offload_blocks=32),
                      rc_kw=dict(replicas=3, migrate=True), host_gb=1.0)
        check_clean(rep)
        assert {n for _, n, _ in rep["chaos_fired"]} & \
            set(tchaos.TIER_INJECTORS)
        cap = rep["capacity"]
        assert cap["host_budget_bytes_per_chip"] == 1 << 30
        fp1 = cap["layouts"]["fp_tp1"]
        assert fp1["host_blocks_per_chip"] > 0
        assert fp1["cached_tokens_hbm_plus_host"] > \
            fp1["cached_tokens_hbm"]
        assert cap["layouts"]["int8_tp1"]["host_blocks_per_chip"] > \
            fp1["host_blocks_per_chip"]


class TestDisaggReplay:
    def test_disagg_fleet_replay_clean_under_chaos(self, setup):
        _, rep = both(setup, spec_kw=dict(requests=36, horizon_steps=28),
                      kinds=(tchaos.TIMELINE_INJECTORS
                             + tchaos.DISAGG_INJECTORS),
                      events=8, seed_offset=2, sc_kw={},
                      rc_kw=dict(replicas=3, migrate=True,
                                 prefill_replicas=1,
                                 prefill_len_threshold=10))
        check_clean(rep)
        assert {n for _, n, _ in rep["chaos_fired"]} & \
            set(tchaos.DISAGG_INJECTORS)


class TestMixedBatchReplay:
    def test_long_prompt_knob_gated_last(self):
        base = TV.generate_trace(small_spec())
        again = TV.generate_trace(small_spec(long_prompt_frac=0.0))
        for x, y in zip(base, again):
            np.testing.assert_array_equal(x.prompt, y.prompt)
        long = TV.generate_trace(small_spec(long_prompt_frac=0.5,
                                            long_prompt_len=24))
        want = JV.generate_trace(small_spec(JAX, long_prompt_frac=0.5,
                                            long_prompt_len=24))
        for x, y in zip(want, long):
            np.testing.assert_array_equal(x.prompt, y.prompt)
        stretched = [y for y in long if len(y.prompt) == 24]
        assert len(stretched) >= len(base) // 4
        for x, y in zip(base, long):
            assert x.arrival_step == y.arrival_step
        by_fam = {}
        for y in stretched:
            if y.family is not None:
                by_fam.setdefault(y.family, []).append(y.prompt[:8])
        assert any(len(v) >= 2 for v in by_fam.values())
        for rows in by_fam.values():
            for p in rows[1:]:
                np.testing.assert_array_equal(rows[0], p)

    def test_mixed_fleet_replay_clean_under_chaos(self, setup):
        _, rep = both(setup, spec_kw=dict(requests=40, horizon_steps=30,
                                          long_prompt_frac=0.4,
                                          long_prompt_len=24,
                                          output_lens=(3, 4, 6)),
                      sc_kw=dict(prefill_chunk=4, mixed_batch=True),
                      replicas=2, chaos_events=6)
        check_clean(rep)
        assert rep["completed"] >= rep["requests"] * 0.7


class TestAdapterChurnReplay:
    def test_replay_fuzz_with_churn_under_auditor(self, setup):
        """Mirrors ``tests/test_lora.py``'s churn replay: a Zipf adapter
        mix through a 2-replica fleet with ``adapter_churn`` firing twice
        mid-traffic, the auditor's ``adapter_pool_partition`` check
        throughout; both packages equal, nothing failed or leaked."""
        runs = {}
        for ns in (JAX, PORT):
            tl = ns.chaos.ChaosTimeline([
                ns.chaos.ChaosEvent(3, "adapter_churn", rounds=3, seed=7),
                ns.chaos.ChaosEvent(6, "adapter_churn", rounds=2, seed=11)])
            spec = ns.V.WorkloadSpec(requests=16, seed=3, adapters=4,
                                     audit_every=4, autoscale_every=0,
                                     misbehavior_frac=0.0)
            runs[ns.name] = replay(setup, ns, spec=spec, replicas=2,
                                   chaos=tl, programs=False,
                                   sc_kw=dict(lora_slots=2, lora_pool=16,
                                              max_model_len=64),
                                   record_streams=True)
        assert_same(runs["jax"], runs["port"], streams=True)
        rep = runs["port"]
        assert rep["chaos_kinds"] == ["adapter_churn"]
        assert rep["violations"] == [] and rep["leaked_blocks"] == 0
        assert rep["adapter_requests"] > 0 and rep["failed"] == 0


def test_flag_registry_matches_reference():
    """The port's ``set_flags`` coerces to the flag's type and refuses an
    unknown name, as the reference's does."""
    before = TF.flag("FLAGS_serving_retry_after_s")
    TF.set_flags({"FLAGS_serving_retry_after_s": "0.5"})
    try:
        assert TF.flag("FLAGS_serving_retry_after_s") == 0.5
    finally:
        TF.set_flags({"FLAGS_serving_retry_after_s": before})
    with pytest.raises(ValueError, match="known flags"):
        TF.set_flags({"FLAGS_serving_bogus": 1})
    with pytest.raises(ValueError):
        paddle_tpu.set_flags({"FLAGS_serving_bogus": 1})
    serving = {k: v for k, v in TF.get_flags().items()
               if k.startswith("FLAGS_serving_")}
    want = {k: v for k, v in paddle_tpu.get_flags().items()
            if k.startswith("FLAGS_serving_")}
    assert serving == want

"""Deterministic workload generator + fleet-scale chaos replay —
counterpart of ``paddle_tpu/inference/serving/workload.py``.

Nothing else drives the whole stack — router -> supervisors -> engines
-> paged kernels — the way production traffic does, with faults
arriving mid-stream. Three composable pieces:

* **Deterministic workload generator.** :class:`WorkloadSpec` +
  :func:`generate_trace` emit a reproducible request stream keyed to
  engine-STEP indices (never wall-clock): diurnal/bursty arrival curves,
  Zipf-skewed tenants, Zipf-skewed multi-adapter LoRA mixes,
  shared-prefix prompt families, mixed greedy/sampled knobs, priorities
  and client-side deadlines, and client misbehavior — cancels,
  disconnect-mid-stream, abandoned streams, and retries after a 429/503
  that BACK OFF before resubmitting. The trace is a pure function of the
  spec (numpy only, draw for draw the reference's: one spec gives one
  trace in both packages).

* **Replay manifest.** :class:`ReplayManifest` records the seed, the
  spec, the chaos-timeline schedule and the live ``FLAGS_serving_*``
  values; its JSON is the reference's, so a manifest written by either
  package replays in the other. Any failure reproduces from it: same
  per-request token streams, same chaos firing order, same audit trail
  (``retry_policy="fixed"`` — the deterministic backoff; ``"hint"``
  honors the measured wall-clock ``retry_after_s``, which is the
  production behavior but makes shed counts host-load-dependent).

* **Replay + capacity report.** :func:`run_replay` drives the
  trace through a multi-replica :class:`~.router.ServingRouter` on one
  device (the card unless ``device="cpu"``) with a seeded
  :class:`~paddle_tpu_torch.testing.chaos.ChaosTimeline` interleaving
  the serving injectors mid-traffic while the autoscaler actuates, the
  :class:`~.audit.InvariantAuditor` sampling throughout and running
  exhaustively at quiesce. The run emits a capacity-planning report
  (:func:`capacity_report`: ``paged_pool_block_bytes`` arithmetic across
  fp/int8 x TP degree against the device's memory, plus the measured
  TTFT/TPOT percentile curves) and the ``serving_replay_goodput``
  record — SLO-met tokens per second per device.
"""

from __future__ import annotations

import dataclasses
import json
import math
import time
import zlib
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ...device import resolve_device
from ...flags import get_flags
from .audit import InvariantAuditor
from .scheduler import FINISHED, ServingQueueFull
from .supervisor import FAILED, ServingUnavailable

__all__ = ["WorkloadSpec", "TraceRequest", "generate_trace",
           "ReplayManifest", "run_replay", "capacity_report"]


@dataclasses.dataclass
class WorkloadSpec:
    """Everything that determines a trace. JSON-serializable (tuples
    round-trip as lists), so a :class:`ReplayManifest` embeds it
    verbatim and two replays of one manifest generate identical traces.
    All times are engine-STEP indices — a replay never keys behavior to
    wall-clock."""

    requests: int = 200
    seed: int = 0
    vocab_size: int = 97
    # ---- arrivals ----
    horizon_steps: int = 0            # 0 = auto (~2 arrivals per step)
    arrival: str = "diurnal"          # diurnal | bursty | uniform
    diurnal_periods: float = 1.0      # peak/trough cycles over the horizon
    diurnal_amp: float = 0.9          # peak rate = (1+amp) x mean
    burstiness: float = 4.0           # bursty: in-burst rate multiplier
    burst_frac: float = 0.15          # fraction of the horizon in bursts
    # ---- request mix ----
    tenants: int = 6                  # Zipf-skewed tenant population
    zipf_alpha: float = 1.2
    families: int = 3                 # shared-prefix prompt families
    family_frac: float = 0.6          # requests opening with a family prefix
    prefix_len: int = 16              # family prefix tokens (block-align
    #                                   it so router affinity keys engage)
    tail_lens: Tuple[int, ...] = (2, 4, 6, 10)
    output_lens: Tuple[int, ...] = (2, 3, 4, 6, 12)   # long-tailed
    eos_token_id: Optional[int] = None
    sampled_frac: float = 0.25        # temperature/top-k/top-p rows
    priorities: Tuple[int, ...] = (0, 0, 0, 1, 2)
    deadline_frac: float = 0.2        # client-side step deadlines
    deadline_steps: Tuple[int, ...] = (60, 120, 240)
    # ---- client misbehavior ----
    misbehavior_frac: float = 0.08    # cancel / disconnect / abandon
    # ---- multi-adapter LoRA mix ----
    # adapters=0 keeps the trace base-only AND rng-draw free: every
    # previously generated seed keeps its byte-identical trace. With
    # adapters>0 a Zipf-skewed adapter population rides the stream —
    # a few hot adapters dominating (the S-LoRA locality the router's
    # adapter affinity exploits) with a long cold tail (the churn the
    # device pool's LRU absorbs).
    adapters: int = 0                 # distinct adapters ("lora0"..)
    adapter_frac: float = 0.75        # requests carrying an adapter_id
    adapter_zipf_alpha: float = 1.2   # hot-adapter skew
    # ---- long-prompt mix ----
    # long_prompt_frac=0 keeps the trace rng-draw free (byte-identical
    # old seeds). >0 extends that fraction of prompts with fresh tokens
    # up to ~long_prompt_len — prompts that must CHUNK through
    # prefill_chunk-sized pieces, the mid-flight-prefill pressure mixed
    # batching (FLAGS_serving_mixed_batch) absorbs into the decode
    # dispatch. Extension is appended at the prompt END so family
    # prefixes (and router affinity keys) stay intact.
    long_prompt_frac: float = 0.0     # requests stretched to ~long len
    long_prompt_len: int = 48         # target total prompt length
    # ---- 429/503 retry policy ----
    # "fixed": back off retry_backoff_steps engine steps per attempt —
    # deterministic, the replay-determinism contract's setting. "hint":
    # honor the response's retry_after_s against the wall clock (the
    # production client contract; shed counts then track host load).
    # "storm": resubmit immediately, ignoring the hint — the misbehaving
    # client the backoff regression test measures against.
    retry_policy: str = "fixed"
    retry_backoff_steps: int = 8
    max_attempts: int = 100
    # ---- replay-loop knobs ----
    step_iters: int = 2               # decode iterations per replay step
    audit_every: int = 8              # structural audit sampling period
    #                                   (0 = only the exhaustive quiesce)
    autoscale_every: int = 16         # router.autoscale() polling period
    #                                   (0 = autoscaler off: the fixed-
    #                                   fleet counterfactual the p99
    #                                   effect is measured against)
    cooldown_steps: int = 48          # post-quiesce steps (scale-in lands)

    def __post_init__(self):
        if self.requests < 1:
            raise ValueError("requests must be >= 1")
        if self.arrival not in ("diurnal", "bursty", "uniform"):
            raise ValueError(f"unknown arrival curve {self.arrival!r}")
        if self.retry_policy not in ("fixed", "hint", "storm"):
            raise ValueError(f"unknown retry_policy {self.retry_policy!r}"
                             " (fixed | hint | storm)")
        if int(self.adapters) < 0:
            raise ValueError("adapters must be >= 0 (0 = base-only)")
        if int(self.retry_backoff_steps) < 1:
            raise ValueError(
                "retry_backoff_steps must be >= 1 (0 would re-bucket a "
                "shed client at the already-processed step and strand it)")
        for f in ("tail_lens", "output_lens", "priorities",
                  "deadline_steps"):
            setattr(self, f, tuple(int(x) for x in getattr(self, f)))

    @property
    def horizon(self) -> int:
        return int(self.horizon_steps) or max(8, self.requests // 2)

    def asdict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class TraceRequest:
    """One generated client request, fully resolved (the trace is the
    contract — run_replay never rolls dice)."""

    tid: int
    arrival_step: int
    tenant: str
    prompt: np.ndarray
    max_new_tokens: int
    family: Optional[int] = None
    temperature: float = 0.0
    top_k: Optional[int] = None
    top_p: Optional[float] = None
    seed: int = 0
    priority: int = 0
    eos_token_id: Optional[int] = None
    deadline_steps: Optional[int] = None
    behavior: str = "normal"          # normal | cancel | disconnect | abandon
    behavior_at: int = 0              # delivered tokens before it fires
    adapter_id: Optional[str] = None  # None = base-model traffic


def _arrival_weights(spec: WorkloadSpec, rng) -> np.ndarray:
    H = spec.horizon
    s = np.arange(H, dtype=np.float64)
    if spec.arrival == "uniform":
        w = np.ones(H)
    elif spec.arrival == "diurnal":
        # trough at step 0, peak mid-horizon: the replay sees ramp-up,
        # saturation (autoscale's scale-up window) and ramp-down
        # (its scale-in window) in one pass
        w = 1.0 + spec.diurnal_amp * np.sin(
            2 * math.pi * spec.diurnal_periods * s / H - math.pi / 2)
    else:                                             # bursty
        w = np.ones(H)
        n_bursts = max(1, int(round(H * spec.burst_frac / 8)))
        for _ in range(n_bursts):
            at = rng.integers(0, max(1, H - 8))
            w[at:at + 8] *= spec.burstiness
    w = np.clip(w, 1e-3, None)
    return w / w.sum()


def generate_trace(spec: WorkloadSpec) -> List[TraceRequest]:
    """The seeded trace: a pure function of the spec, sorted by arrival
    step (ties by tid). Prompts for one family share a ``prefix_len``
    token prefix — sized to the serving block size, that is exactly the
    unit the prefix cache registers and the router's affinity key hashes."""
    rng = np.random.default_rng(int(spec.seed))
    w = _arrival_weights(spec, rng)
    arrivals = np.sort(rng.choice(spec.horizon, size=spec.requests, p=w))
    zipf = 1.0 / np.power(np.arange(1, spec.tenants + 1), spec.zipf_alpha)
    zipf /= zipf.sum()
    prefixes = [rng.integers(0, spec.vocab_size,
                             (spec.prefix_len,)).astype(np.int32)
                for _ in range(max(1, spec.families))]
    fam_w = 1.0 / np.power(np.arange(1, len(prefixes) + 1), spec.zipf_alpha)
    fam_w /= fam_w.sum()
    ad_w = None
    if spec.adapters > 0:
        ad_w = 1.0 / np.power(np.arange(1, spec.adapters + 1),
                              spec.adapter_zipf_alpha)
        ad_w /= ad_w.sum()
    out: List[TraceRequest] = []
    for tid in range(spec.requests):
        tenant = f"t{int(rng.choice(spec.tenants, p=zipf))}"
        fam = None
        tail = rng.integers(0, spec.vocab_size,
                            (int(rng.choice(spec.tail_lens)),)
                            ).astype(np.int32)
        if rng.random() < spec.family_frac:
            fam = int(rng.choice(len(prefixes), p=fam_w))
            prompt = np.concatenate([prefixes[fam], tail])
        else:
            prompt = np.concatenate(
                [rng.integers(0, spec.vocab_size, (2,)).astype(np.int32),
                 tail])
        tr = TraceRequest(
            tid=tid, arrival_step=int(arrivals[tid]), tenant=tenant,
            prompt=prompt, family=fam,
            max_new_tokens=int(rng.choice(spec.output_lens)),
            priority=int(rng.choice(spec.priorities)),
            eos_token_id=spec.eos_token_id)
        if rng.random() < spec.sampled_frac:
            tr.temperature = round(float(rng.uniform(0.3, 1.2)), 3)
            tr.top_k = int(rng.integers(2, 40))
            tr.top_p = round(float(rng.uniform(0.6, 1.0)), 3)
            tr.seed = int(rng.integers(0, 1 << 20))
        if rng.random() < spec.deadline_frac:
            tr.deadline_steps = int(rng.choice(spec.deadline_steps))
        if rng.random() < spec.misbehavior_frac:
            tr.behavior = str(rng.choice(["cancel", "disconnect",
                                          "abandon"]))
            tr.behavior_at = int(rng.integers(1, 4))
        # gated LAST so adapters=0 specs draw nothing here and every
        # previously generated seed keeps its byte-identical trace
        if spec.adapters > 0 and rng.random() < spec.adapter_frac:
            tr.adapter_id = \
                f"lora{int(rng.choice(spec.adapters, p=ad_w))}"
        # also gated LAST (after the adapter draw) for the same reason:
        # long_prompt_frac=0 draws nothing, old seeds stay byte-identical
        if spec.long_prompt_frac > 0 and \
                rng.random() < spec.long_prompt_frac:
            ext = int(spec.long_prompt_len) - len(tr.prompt)
            if ext > 0:
                tr.prompt = np.concatenate(
                    [tr.prompt,
                     rng.integers(0, spec.vocab_size,
                                  (ext,)).astype(np.int32)])
        out.append(tr)
    return out


@dataclasses.dataclass
class ReplayManifest:
    """Everything a bit-exact reproduction needs: the workload spec, the
    chaos schedule, and the serving flags in force. Emitted with every
    replay (and stamped into each :class:`~.audit.InvariantViolation`),
    so 'it failed at fleet scale' always comes with 'run THIS to see it
    again'."""

    spec: Dict[str, Any]
    chaos: List[Any]
    flags: Dict[str, Any]
    # the engine + fleet shape the run actually used: the resolved
    # ServingConfig / RouterConfig scalar fields + the starting replica
    # count — run_replay(manifest=) re-applies all three (unless the
    # caller overrides), because admission / shed / preemption /
    # breaker / autoscale behavior depends on them and a reproduction
    # with a different queue_depth or max_replicas is not a
    # reproduction. ``flags`` is the operator's reference record of the
    # FLAGS_serving_* environment; it is NOT auto-applied (both configs
    # resolved from it eagerly, so the shape fields already carry the
    # values that mattered).
    serving: Dict[str, Any] = dataclasses.field(default_factory=dict)
    router: Dict[str, Any] = dataclasses.field(default_factory=dict)
    replicas: int = 0
    version: int = 1

    @staticmethod
    def _scalars(config) -> Dict[str, Any]:
        # ServingConfig/RouterConfig resolve their flag-backed fields
        # eagerly at construction, so the scalar fields ARE the shape;
        # non-scalar leftovers (cache_dtype objects) re-resolve from
        # defaults at replay
        return {k: v for k, v in
                sorted(dataclasses.asdict(config).items())
                if isinstance(v, (bool, int, float, str)) or v is None}

    @classmethod
    def capture(cls, spec: WorkloadSpec, timeline=None,
                serving_config=None, router_config=None,
                replicas: int = 0) -> "ReplayManifest":
        flags = {k: v for k, v in sorted(get_flags().items())
                 if k.startswith("FLAGS_serving_")
                 and isinstance(v, (int, float, str, bool))}
        return cls(spec=spec.asdict(),
                   chaos=timeline.spec() if timeline is not None else [],
                   flags=flags,
                   serving=(cls._scalars(serving_config)
                            if serving_config is not None else {}),
                   router=(cls._scalars(router_config)
                           if router_config is not None else {}),
                   replicas=int(replicas))

    def workload(self) -> WorkloadSpec:
        return WorkloadSpec(**self.spec)

    def timeline(self):
        from ...testing.chaos import ChaosTimeline
        return ChaosTimeline.from_spec(self.chaos)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "ReplayManifest":
        return cls(**json.loads(s))

    @property
    def tag(self) -> str:
        """Short stable identifier (what violations carry)."""
        return (f"replay seed={self.spec.get('seed')} "
                f"requests={self.spec.get('requests')} "
                f"crc={zlib.crc32(self.to_json().encode()):08x}")

    def __str__(self) -> str:
        return self.tag


class _Client:
    """Replay-side state for one trace request: submission attempts,
    retry backoff, the delivered-token stream, and the misbehavior
    script."""

    __slots__ = ("tr", "state", "next_step", "backoff_until", "attempts",
                 "retries", "frid", "delivered", "submit_step",
                 "first_step", "finish_step", "submit_t", "first_t",
                 "finish_t", "outcome", "behavior_fired")

    def __init__(self, tr: TraceRequest):
        self.tr = tr
        self.state = "waiting"        # waiting | backoff | live | done
        self.next_step = tr.arrival_step
        self.backoff_until = None     # wall-clock stamp (hint policy)
        self.attempts = 0
        self.retries = 0
        self.frid = None
        self.delivered: List[int] = []
        self.submit_step = None
        self.first_step = None
        self.finish_step = None
        self.submit_t = None
        self.first_t = None
        self.finish_t = None
        self.outcome = None           # finished | cancelled | deadline |
        #                               disconnected | gave_up | failed
        self.behavior_fired = False


def _pct(xs, q):
    return round(float(np.percentile(np.asarray(xs, np.float64), q)), 4) \
        if len(xs) else None


def run_replay(params, model_config, spec: Optional[WorkloadSpec] = None,
               manifest: Optional[ReplayManifest] = None,
               serving_config=None, router_config=None,
               replicas: Optional[int] = None,
               chaos: Any = "auto", chaos_events: int = 6,
               prefill_replicas: int = 0,
               router=None, collect_violations: bool = False,
               record_streams: bool = False,
               hbm_gb: Optional[float] = None, host_gb: float = 0.0,
               max_steps: Optional[int] = None,
               device=None) -> Dict[str, Any]:
    """Drive one generated trace through a multi-replica router under a
    seeded chaos timeline, auditing throughout. Returns the replay
    report (counters, percentile curves, chaos log, autoscale log, the
    auditor digest, the capacity report and the manifest).

    The fleet runs on ``device`` (the card unless ``"cpu"``). Pass
    ``manifest=`` to REPLAY a previous run bit-exactly (spec and chaos
    schedule come from it); pass ``router=`` to replay onto an existing
    fleet — the caller then owns its lifecycle. ``hbm_gb`` sizes the
    capacity report's device budget: ``None`` reads the memory of the
    fleet's device (on the CPU the caller passes it). The report's
    ``chips`` counts the distinct devices held by any shard of any
    replica, averaged over the same per-step samples as ``mean_fleet``:
    three replicas on one card are ``chips == 1.0``, so are three TP2
    replicas with both shards on it (``device=["cuda:0", "cuda:0"]``),
    and
    ``goodput_tok_s_per_chip`` divides by that. By default violations RAISE
    (:class:`~.audit.InvariantViolation` naming check/replica/manifest);
    ``collect_violations=True`` switches to the production spelling —
    everything runs, the report carries the list."""
    from ...testing.chaos import chaos_timeline as _mk_timeline
    from ...testing import chaos as _chaos
    from .engine import ServingConfig
    from .router import RouterConfig, ServingRouter

    fresh_manifest = manifest is None
    if manifest is not None:
        spec = manifest.workload()
        timeline = manifest.timeline()
        # reproduce the captured ENGINE + FLEET SHAPE too (admission/
        # shed/preemption/breaker/autoscale behavior depends on them),
        # unless the caller overrides
        if serving_config is None and manifest.serving:
            serving_config = ServingConfig(**manifest.serving)
        if router_config is None and manifest.router:
            router_config = RouterConfig(**manifest.router)
        if replicas is None and manifest.replicas:
            replicas = manifest.replicas
    else:
        spec = spec or WorkloadSpec()
        if chaos == "auto":
            timeline = _mk_timeline(spec.seed + 1, spec.horizon,
                                    events=chaos_events)
        elif chaos in (None, False):
            timeline = _mk_timeline(spec.seed + 1, spec.horizon, events=0)
        else:
            timeline = chaos
    if replicas is None:
        replicas = 3

    own_router = router is None
    if own_router:
        if serving_config is None:
            # a LoRA-mixed trace needs an adapter pool; size the device
            # slots BELOW the adapter population so the replay exercises
            # LRU eviction + reload under traffic, not just residency
            serving_config = ServingConfig(
                lora_slots=max(2, (spec.adapters + 1) // 2),
                lora_pool=max(16, spec.adapters)) \
                if spec.adapters > 0 else ServingConfig()
        if router_config is None:
            # deterministic fleet defaults: hedging off (wall-clock
            # race), breaker cooldown 0 (an opened breaker half-open
            # probes on the next routing pass instead of after a
            # wall-clock cooldown), probe caching off
            # prefill_replicas adds a disaggregated prefill pool —
            # captured in the manifest like every other RouterConfig
            # scalar, so a replay rebuilds the same split fleet
            router_config = RouterConfig(replicas=replicas,
                                         breaker_cooldown_s=0.0,
                                         hedge_ttft_mult=0.0,
                                         prefill_replicas=prefill_replicas)
        router = ServingRouter(params, model_config, serving_config,
                               router_config=router_config, device=device)
    tp = int(router.decode_config.tp)
    if spec.adapters > 0:
        # the trace's adapter population, seeded off the spec so a
        # replay regenerates identical adapter weights; scale well above
        # init-noise so adapter outputs genuinely diverge from base
        from ...models.lora import lora_init_params
        rank = int(router.decode_config.lora_rank)
        for i in range(int(spec.adapters)):
            name = f"lora{i}"
            if not router.adapter_registered(name):
                router.register_adapter(
                    name, lora_init_params(model_config, rank,
                                           seed=int(spec.seed) * 1000 + i,
                                           scale=0.5))
    if fresh_manifest:
        # capture AFTER the router exists: the manifest records the
        # resolved configs + starting fleet size actually in force
        manifest = ReplayManifest.capture(
            spec, timeline, serving_config=router.decode_config,
            router_config=router.config,
            replicas=len(router._replicas))

    auditor = InvariantAuditor(manifest=manifest.tag)
    clients = [_Client(tr) for tr in generate_trace(spec)]
    live: Dict[int, _Client] = {}         # frid -> client (bounded by
    #                                        fleet queue + slot capacity)
    retry_buckets: Dict[int, List[_Client]] = {}   # step -> fixed backoffs
    backoff: List[_Client] = []           # hint-policy wall-clock waits
    done_count = 0
    arrival_cursor = 0
    shed_submits = 0
    disconnects_pending = 0
    spawn_steps: List[int] = []
    drain_steps: List[int] = []
    autoscale_log: List[Tuple[int, str]] = []
    fleet_sizes: List[int] = []
    fleet_devices: List[int] = []
    step = 0
    budget = max_steps if max_steps is not None else \
        spec.horizon * 40 + spec.requests * 40 + 2000
    t_start = time.time()
    cooldown_left = None

    def _adoptable_rids() -> List[int]:
        # replicas that can ADOPT failed-over work (Replica.adoptable:
        # a FULL admission queue still qualifies, resubmit bypasses the
        # queue bound) — so a kill at peak saturation is coverable
        return [rid for rid, rep in router._replicas.items()
                if rep.adoptable()]

    def _submit(cl: _Client) -> None:
        nonlocal shed_submits, done_count
        tr = cl.tr
        cl.attempts += 1
        try:
            frid = router.submit(
                tr.prompt, max_new_tokens=tr.max_new_tokens,
                eos_token_id=tr.eos_token_id, tenant=tr.tenant,
                priority=tr.priority, temperature=tr.temperature,
                top_k=tr.top_k, top_p=tr.top_p, seed=tr.seed,
                adapter_id=tr.adapter_id)
        except (ServingQueueFull, ServingUnavailable) as e:
            shed_submits += 1
            if cl.attempts >= spec.max_attempts:
                cl.state, cl.outcome = "done", "gave_up"
                done_count += 1
                return
            cl.retries += 1
            if spec.retry_policy == "hint":
                # honor the 429/503's retry_after_s against the wall
                # clock: no resubmit before the hint elapses
                ra = getattr(e, "retry_after_s", None) or 1.0
                cl.state = "backoff"
                cl.backoff_until = time.time() + float(ra)
                backoff.append(cl)
                return
            # "storm" ignores the hint (the misbehaving client the
            # backoff regression test measures against); "fixed" waits a
            # deterministic step count
            back = 1 if spec.retry_policy == "storm" \
                else spec.retry_backoff_steps
            cl.state = "waiting"
            retry_buckets.setdefault(step + back, []).append(cl)
            return
        cl.frid = frid
        cl.state = "live"
        cl.submit_step = step if cl.submit_step is None else cl.submit_step
        cl.submit_t = cl.submit_t or time.time()
        live[frid] = cl

    def _fire(ev) -> None:
        nonlocal disconnects_pending
        adoptable = _adoptable_rids()
        if ev.name == "replica_kill":
            if len(adoptable) < 2:
                timeline.log(step, ev.name, "skipped: no failover cover")
                return
            rid = max(adoptable)
            _chaos.replica_kill(router, rid=rid)
            timeline.log(step, ev.name, {"rid": rid})
        elif ev.name == "slow_replica":
            if not adoptable:
                timeline.log(step, ev.name, "skipped: none healthy")
                return
            rid = max(adoptable)
            _chaos.slow_replica(router, rid=rid, **ev.kwargs)
            timeline.log(step, ev.name, {"rid": rid, **ev.kwargs})
        elif ev.name == "flaky_probe":
            if not adoptable:
                timeline.log(step, ev.name, "skipped: none healthy")
                return
            rid = min(adoptable)
            _chaos.flaky_probe(router, rid=rid, **ev.kwargs)
            timeline.log(step, ev.name, {"rid": rid, **ev.kwargs})
        elif ev.name == "flood_tenant":
            try:
                res = _chaos.flood_tenant(
                    router, tenant="_flood", prompt_len=6,
                    max_new_tokens=2, vocab_size=spec.vocab_size,
                    eos_token_id=spec.eos_token_id, **ev.kwargs)
                timeline.log(step, ev.name,
                             {"admitted": len(res["rids"]),
                              "shed": res["shed"]})
            except ServingUnavailable:
                # "skipped" prefix: a flood that never reached the
                # admission path did not exercise this chaos kind, so
                # chaos_kinds must not count it
                timeline.log(step, ev.name, "skipped: fleet not admitting")
        elif ev.name == "poison_prompt":
            base = np.arange(1, 9, dtype=np.int32) % spec.vocab_size
            poisoned = _chaos.poison_prompt(base, spec.vocab_size,
                                            **ev.kwargs)
            try:
                frid = router.submit(poisoned, max_new_tokens=2,
                                     eos_token_id=None, tenant="_poison")
                timeline.log(step, ev.name, {"frid": frid, **ev.kwargs})
            except (ServingQueueFull, ServingUnavailable):
                # the poisoned prompt never entered an engine: skipped
                timeline.log(step, ev.name, "skipped: shed")
        elif ev.name == "host_pressure":
            if not adoptable:
                timeline.log(step, ev.name, "skipped: none healthy")
                return
            rid = min(adoptable)
            res = _chaos.host_pressure(router, rid=rid, **ev.kwargs)
            if res["enabled"]:
                timeline.log(step, ev.name, res)
            else:
                # the tier is off: the fault had nothing to squeeze
                timeline.log(step, ev.name, "skipped: offload tier off")
        elif ev.name == "corrupt_offload_block":
            # aim at a replica whose tier actually holds a block — a
            # corruption that touched nothing did not exercise the
            # checksum path and must not count as fired
            for rid in adoptable:
                res = _chaos.corrupt_offload_block(router, rid=rid,
                                                   **ev.kwargs)
                if res["enabled"] and res["key"] is not None:
                    timeline.log(step, ev.name, res)
                    return
            timeline.log(step, ev.name, "skipped: tier off or empty")
        elif ev.name == "kill_prefill_replica":
            res = _chaos.kill_prefill_replica(router, **ev.kwargs)
            if res["enabled"]:
                timeline.log(step, ev.name, res)
            else:
                # no prefill pool in this fleet: nothing to kill
                timeline.log(step, ev.name, "skipped: no prefill replica")
        elif ev.name == "stale_directory":
            res = _chaos.stale_directory(router, **ev.kwargs)
            if res["enabled"]:
                timeline.log(step, ev.name, res)
            else:
                # a poisoning that armed nothing did not exercise the
                # pull-checksum path and must not count as fired
                timeline.log(step, ev.name,
                             "skipped: directory off or empty")
        elif ev.name == "adapter_churn":
            if not adoptable:
                timeline.log(step, ev.name, "skipped: none healthy")
                return
            rid = min(adoptable)
            res = _chaos.adapter_churn(router, rid=rid, **ev.kwargs)
            if res["enabled"]:
                timeline.log(step, ev.name, res)
            else:
                # no pool / nothing registered: nothing to churn
                timeline.log(step, ev.name,
                             "skipped: multi-adapter serving off")
        elif ev.name == "disconnect_mid_stream":
            # logged when a live stream is ACTUALLY cut (or as skipped
            # at quiesce if none ever was) — an armed-but-never-fired
            # disconnect must not count as an exercised chaos kind
            disconnects_pending += 1
        else:
            raise ValueError(f"chaos timeline cannot fire {ev.name!r}")

    try:
        while True:
            for ev in timeline.due(step):
                _fire(ev)
            # arrivals due this step, fixed-backoff retries due this step,
            # hint-policy backoffs whose wall-clock hint elapsed — all O(due)
            while arrival_cursor < len(clients) and \
                    clients[arrival_cursor].tr.arrival_step <= step:
                _submit(clients[arrival_cursor])
                arrival_cursor += 1
            for cl in retry_buckets.pop(step, ()):
                if cl.state == "waiting":
                    _submit(cl)
            if backoff:
                if not live and not router.pending and not retry_buckets \
                        and arrival_cursor == len(clients):
                    # every remaining client is waiting out a wall-clock
                    # retry_after_s hint and the fleet is idle: sleep to the
                    # earliest hint instead of burning the step budget
                    # spinning empty engine steps (hint policy only — the
                    # deterministic policies never populate ``backoff``)
                    time.sleep(max(0.0,
                                   min(c.backoff_until for c in backoff)
                                   - time.time()))
                now = time.time()
                due = [cl for cl in backoff if now >= cl.backoff_until]
                if due:
                    backoff[:] = [cl for cl in backoff
                                  if now < cl.backoff_until]
                    for cl in due:
                        cl.state, cl.backoff_until = "waiting", None
                        _submit(cl)
            emitted = router.step(spec.step_iters)
            auditor.observe(emitted, lookup=router._reqs.get)
            now = time.time()
            for frid, toks in emitted.items():
                cl = live.get(frid)
                if cl is None:
                    continue                       # flood/poison side traffic
                if cl.first_step is None and toks:
                    cl.first_step, cl.first_t = step, now
                if not (cl.behavior_fired and cl.tr.behavior == "abandon"):
                    cl.delivered.extend(int(t) for t in toks)
            # client misbehavior + deadlines + armed disconnects — O(live)
            for frid, cl in list(live.items()):
                tr = cl.tr
                if tr.behavior != "normal" and not cl.behavior_fired and \
                        len(cl.delivered) >= tr.behavior_at:
                    cl.behavior_fired = True
                    if tr.behavior in ("cancel", "disconnect"):
                        router.cancel(frid)
                    # abandon: the client stops READING; the stream runs on
                    # and the replay cancels it a few steps later — the GC of
                    # an abandoned iterator, made deterministic
                if tr.behavior == "abandon" and cl.behavior_fired and \
                        cl.first_step is not None and \
                        step - cl.first_step >= tr.behavior_at + 3:
                    router.cancel(frid)
                if tr.deadline_steps is not None and \
                        cl.submit_step is not None and \
                        step - cl.submit_step > tr.deadline_steps:
                    rec = router._reqs.get(frid)
                    if rec is not None and not rec.terminal:
                        router.cancel(frid)
                        cl.outcome = "deadline"
                if disconnects_pending and tr.behavior == "normal" \
                        and cl.delivered and cl.outcome is None:
                    rec = router._reqs.get(frid)
                    if rec is not None and not rec.terminal:
                        disconnects_pending -= 1
                        router.cancel(frid)
                        cl.outcome = "disconnected"
                        timeline.log(step, "disconnect_mid_stream",
                                     {"frid": frid})
            # terminal sweep (authoritative tokens/state from the router)
            for frid, cl in list(live.items()):
                rec = router._reqs.get(frid)
                if rec is None or not rec.terminal:
                    continue
                auditor.close_request(frid, rec)
                del live[frid]
                cl.state = "done"
                done_count += 1
                cl.finish_step, cl.finish_t = step, time.time()
                cl.delivered = [int(t) for t in rec.tokens]
                if rec.state == FAILED:
                    cl.outcome = "failed"
                elif rec.state == FINISHED:
                    cl.outcome = cl.outcome or "finished"
                else:
                    cl.outcome = cl.outcome or "cancelled"
            if spec.autoscale_every and step \
                    and step % spec.autoscale_every == 0:
                sig = router.autoscale()
                autoscale_log.append((step, sig["action"]))
                if "spawned" in sig:
                    spawn_steps.append(step)
                if "retiring" in sig:
                    drain_steps.append(step)
            if spec.audit_every and step and step % spec.audit_every == 0:
                auditor.check(router, collect=collect_violations)
            fleet_sizes.append(len(router._replicas))
            fleet_devices.append(len({str(d) for rep
                                      in router._replicas.values()
                                      for d in rep.sup.engine.devices}))
            step += 1
            if step > budget:
                raise RuntimeError(
                    f"replay exceeded its step budget ({budget}); "
                    f"{len(clients) - done_count} client(s) unfinished "
                    f"[{manifest.tag}]")
            done = arrival_cursor == len(clients) \
                and done_count == len(clients) and not backoff \
                and not router.pending
            if done and cooldown_left is None:
                cooldown_left = spec.cooldown_steps
            if cooldown_left is not None:
                cooldown_left -= 1
                # a chaos event firing inside the cooldown window (flood /
                # poison side traffic) re-opens work: keep stepping until the
                # fleet genuinely drains, so quiesce audits an idle fleet
                if cooldown_left <= 0 and not router.pending \
                        and not timeline.remaining:
                    break

        auditor.quiesce(router, collect=collect_violations)
        if disconnects_pending:
            # armed disconnects that never found an eligible live
            # stream: recorded as skipped so chaos_kinds stays honest
            timeline.log(step, "disconnect_mid_stream",
                         f"skipped: {disconnects_pending} armed, no "
                         f"eligible stream")
    except BaseException:
        # a raising replay (InvariantViolation, step-budget overrun,
        # KeyboardInterrupt) must not strand the fleet it built —
        # close frees every replica's KV pool and supervisor state
        if own_router:
            try:
                router.close(0)
            except Exception:
                pass
        raise
    elapsed = time.time() - t_start

    # ---- metrics ----------------------------------------------------------
    finished = [c for c in clients if c.outcome == "finished"]
    ttft_steps = [c.first_step - c.submit_step for c in clients
                  if c.first_step is not None and c.submit_step is not None]
    # arrival -> first token: the latency the CLIENT feels — includes
    # every shed-and-retry wait, which submit-based TTFT hides (a fleet
    # that sheds half its arrivals shows a flattering submit-TTFT while
    # clients burn retry rounds). The autoscale-effect comparison reads
    # THIS curve.
    arrival_ttft = [c.first_step - c.tr.arrival_step for c in clients
                    if c.first_step is not None]
    ttft_s = [c.first_t - c.submit_t for c in clients
              if c.first_t and c.submit_t]
    tpot_s = [(c.finish_t - c.first_t) / (len(c.delivered) - 1)
              for c in finished
              if c.finish_t and c.first_t and len(c.delivered) > 1]
    first_spawn = spawn_steps[0] if spawn_steps else None
    pre = [c.first_step - c.submit_step for c in clients
           if c.first_step is not None and c.submit_step is not None
           and (first_spawn is None or c.submit_step < first_spawn)]
    post = [c.first_step - c.submit_step for c in clients
            if c.first_step is not None and c.submit_step is not None
            and first_spawn is not None and c.submit_step >= first_spawn]
    # the autoscale-effect windows: requests submitted INTO the
    # saturation that triggered the first spawn vs requests submitted
    # after the spawned capacity had time to absorb the queue — both
    # STEP-indexed, so the comparison is deterministic per manifest and
    # host-load-immune (the measured effect that closes the
    # signal -> spawn -> effect loop)
    w = spec.autoscale_every
    at_spawn = [c.first_step - c.submit_step for c in clients
                if c.first_step is not None and c.submit_step is not None
                and first_spawn is not None
                and first_spawn - w <= c.submit_step < first_spawn]
    after_spawn = [c.first_step - c.submit_step for c in clients
                   if c.first_step is not None
                   and c.submit_step is not None
                   and first_spawn is not None
                   and c.submit_step >= first_spawn + w]
    good = [c for c in finished
            if c.tr.deadline_steps is None
            or (c.finish_step - c.submit_step) <= c.tr.deadline_steps]
    good_tokens = sum(len(c.delivered) for c in good)
    mean_fleet = float(np.mean(fleet_sizes)) if fleet_sizes else 1.0
    # devices, not replicas: the distinct devices any shard of any
    # replica holds (replicas and their tensor-parallel shards may share)
    chips = max(1e-9, float(np.mean(fleet_devices))
                if fleet_devices else 1.0)
    goodput = good_tokens / max(elapsed, 1e-9)
    outcomes: Dict[str, int] = {}
    for c in clients:
        outcomes[c.outcome or c.state] = \
            outcomes.get(c.outcome or c.state, 0) + 1
    prompt_lens = [len(c.tr.prompt) for c in clients]
    mean_seq = float(np.mean([len(c.tr.prompt) + c.tr.max_new_tokens
                              for c in clients]))

    report: Dict[str, Any] = {
        "manifest": manifest,
        "manifest_json": manifest.to_json(),
        "requests": len(clients),
        "outcomes": outcomes,
        "completed": len(finished),
        "failed": outcomes.get("failed", 0),
        "gave_up": outcomes.get("gave_up", 0),
        "retries": sum(c.retries for c in clients),
        "shed_submits": shed_submits,
        "steps": step,
        "elapsed_s": round(elapsed, 3),
        "req_s": round(len(finished) / max(elapsed, 1e-9), 2),
        "tokens_delivered": sum(len(c.delivered) for c in clients),
        "good_tokens": good_tokens,
        "goodput_tok_s": round(goodput, 2),
        "goodput_tok_s_per_chip": round(goodput / chips, 2),
        "chips": round(chips, 2),
        "mean_fleet": round(mean_fleet, 2),
        "tp": tp,
        "ttft_steps_p50": _pct(ttft_steps, 50),
        "ttft_steps_p99": _pct(ttft_steps, 99),
        "arrival_ttft_steps_p50": _pct(arrival_ttft, 50),
        "arrival_ttft_steps_p99": _pct(arrival_ttft, 99),
        "ttft_s_p50": _pct(ttft_s, 50),
        "ttft_s_p99": _pct(ttft_s, 99),
        "tpot_s_p50": _pct(tpot_s, 50),
        "tpot_s_p99": _pct(tpot_s, 99),
        "pre_spawn_ttft_p99_steps": _pct(pre, 99),
        "post_spawn_ttft_p99_steps": _pct(post, 99),
        "ttft_p99_at_spawn_steps": _pct(at_spawn, 99),
        "ttft_p99_after_spawn_steps": _pct(after_spawn, 99),
        "autoscale": {"spawns": len(spawn_steps),
                      "drains": len(drain_steps),
                      "spawn_steps": spawn_steps,
                      "drain_steps": drain_steps,
                      "log": autoscale_log},
        "chaos_fired": list(timeline.fired),
        "chaos_kinds": sorted({name for _, name, d in timeline.fired
                               if not (isinstance(d, str)
                                       and d.startswith("skipped"))}),
        # the FULL accumulated set (collecting mode retains what the
        # sampled mid-replay audits found too, not just the quiesce
        # pass — a transient violation that self-healed still fails
        # the run)
        "violations": [str(v) for v in auditor.violations],
        "audit": auditor.digest(),
        "audit_trail": list(auditor.trail),
        "router_failed": int(router.failed),
        "adapter_requests": sum(1 for c in clients
                                if c.tr.adapter_id is not None),
        "adapter_affinity_hits": int(router.adapter_affinity_hits),
        "adapter_loads": int(router.adapter_loads),
        "leaked_blocks": sum(p["in_use"] for p in
                             router.block_partitions().values()),
        "prompt_len_mean": round(float(np.mean(prompt_lens)), 2),
    }
    if record_streams:
        report["streams"] = {c.tr.tid: list(c.delivered) for c in clients}
    if hbm_gb is None:
        hbm_gb = _device_memory_gb(next(iter(
            router._replicas.values())).sup.engine.device)
    report["capacity"] = capacity_report(
        model_config, router.decode_config, measured=report,
        mean_seq_tokens=mean_seq, hbm_gb=hbm_gb, host_gb=host_gb)
    if own_router:
        drain = router.close(0)
        report["drain_report"] = drain
    return report


def _device_memory_gb(device=None) -> float:
    """The memory of a CUDA ``device`` (``None``: the current one), GiB —
    the budget :func:`capacity_report` sizes pools against. The CPU has
    none to read: pass ``hbm_gb`` there."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"no device memory to read on {dev}: pass hbm_gb")
    return torch.cuda.get_device_properties(dev).total_memory / 2**30


def capacity_report(model_config, serving_config, measured: Optional[Dict]
                    = None, mean_seq_tokens: Optional[float] = None,
                    hbm_gb: Optional[float] = None, host_gb: float = 0.0,
                    tp_degrees: Sequence[int] = (1, 2, 4, 8)
                    ) -> Dict[str, Any]:
    """The capacity-planning arithmetic + the measured curves in one
    record: per-block bytes across fp/int8 x TP degree
    (:func:`~paddle_tpu_torch.models.generation.paged_pool_block_bytes`),
    the concurrent sequences one device's memory budget (``hbm_gb``;
    ``None`` reads the current CUDA device's, :func:`_device_memory_gb`)
    backs at the trace's mean sequence length, the EFFECTIVE cached
    tokens once the host-RAM offload tier extends the prefix cache past
    device memory (``host_gb`` sizes the tier; 0 falls back to the
    configured ``offload_blocks`` bound when the tier is on, since an
    int8 host block is ~3.5x cheaper the same host budget holds ~3.5x the
    cached tokens), and — when a replay's ``measured`` record is given —
    the 'X replicas of config Y serve Z req/s within SLO' sizing line the
    report exists for. The keys are the reference's (``*_per_chip``
    means per device)."""
    from ...models.generation import paged_pool_block_bytes, validate_tp
    if hbm_gb is None:
        hbm_gb = _device_memory_gb()
    bs = int(serving_config.block_size)
    hbm = int(hbm_gb * (1 << 30))
    host = int(host_gb * (1 << 30))
    tier_on = bool(getattr(serving_config, "offload", False))
    tier_blocks = int(getattr(serving_config, "offload_blocks", 0) or 0) \
        if tier_on else 0
    seq = float(mean_seq_tokens
                if mean_seq_tokens is not None
                else serving_config.max_model_len)
    blocks_per_seq = max(1, math.ceil(seq / bs))
    layouts: Dict[str, Dict[str, Any]] = {}
    for kv in (None, "int8"):
        for tp in tp_degrees:
            try:
                validate_tp(model_config, tp)
            except ValueError:
                continue
            bb = paged_pool_block_bytes(model_config, bs, kv_quant=kv,
                                        tp=tp)
            blocks = hbm // bb
            # host-tier column: an explicit host budget wins; otherwise
            # the configured tier bound (0 rows when the tier is off)
            host_blocks = (host // bb) if host else tier_blocks
            layouts[f"{kv or 'fp'}_tp{tp}"] = {
                "block_bytes_per_chip": int(bb),
                "blocks_per_chip": int(blocks),
                "concurrent_seqs_per_chip": int(blocks // blocks_per_seq),
                "host_blocks_per_chip": int(host_blocks),
                "cached_tokens_hbm": int(blocks * bs),
                "cached_tokens_hbm_plus_host": int(
                    (blocks + host_blocks) * bs),
            }
    report: Dict[str, Any] = {
        "config": {
            "layers": model_config.num_hidden_layers,
            "kv_heads": model_config.kv_heads,
            "head_dim": model_config.head_dim,
            "block_size": bs,
            "kv_quant": serving_config.kv_quant,
            "tp": serving_config.tp,
            "max_slots": serving_config.max_slots,
            "offload": tier_on,
            "offload_blocks": tier_blocks,
        },
        "hbm_budget_bytes_per_chip": hbm,
        "host_budget_bytes_per_chip": host,
        "mean_seq_tokens": round(seq, 1),
        "blocks_per_seq": blocks_per_seq,
        "layouts": layouts,
    }
    if measured:
        per_replica_req_s = measured["req_s"] / max(
            measured.get("mean_fleet", 1.0), 1e-9)
        report["measured"] = {
            "req_s": measured["req_s"],
            "req_s_per_replica": round(per_replica_req_s, 3),
            "goodput_tok_s_per_chip": measured["goodput_tok_s_per_chip"],
            "ttft_s_p50": measured["ttft_s_p50"],
            "ttft_s_p99": measured["ttft_s_p99"],
            "tpot_s_p50": measured["tpot_s_p50"],
            "tpot_s_p99": measured["tpot_s_p99"],
            "mean_fleet": measured.get("mean_fleet"),
        }
        for target in (10, 100, 1000):
            report["measured"][f"replicas_for_{target}_req_s"] = \
                int(math.ceil(target / max(per_replica_req_s, 1e-9)))
        report["sizing"] = (
            f"{measured.get('mean_fleet')} replica(s) of "
            f"{model_config.num_hidden_layers}L/"
            f"{model_config.kv_heads}kvh/bs{bs}"
            f"{'/' + serving_config.kv_quant if serving_config.kv_quant else ''}"
            f"/tp{serving_config.tp} served "
            f"{measured['req_s']} req/s within SLO "
            f"(p99 TTFT {measured['ttft_s_p99']}s, "
            f"goodput {measured['goodput_tok_s_per_chip']} tok/s/chip)")
    return report

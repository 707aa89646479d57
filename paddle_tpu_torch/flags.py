"""Runtime flag registry — the ``FLAGS_serving_*`` and health subset the
port reads.

Counterpart of ``paddle_tpu/flags.py``: its ``define_flag`` / ``flag`` /
``get_flags`` / ``set_flags`` helpers and the same names, defaults and
``FLAGS_<name>=value`` environment override, limited to the serving
knobs the ported engine, offload tier, journal, supervisor, fleet router
and front-end server resolve when a field is left unset (every
``FLAGS_serving_*`` of the reference, so a replay manifest records the
same set), the checkpoint verification switch, the health ladder's
knobs (sentinel, monitor, the DataLoader's retries and worker restarts),
the hang watchdog's timeout, and the two core flags the eager tier reads
(``FLAGS_check_nan_inf``, ``FLAGS_retain_grad_for_all_tensor``).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Dict

__all__ = ["define_flag", "flag", "get_flags", "set_flags"]


@dataclass
class _FlagDef:
    name: str
    default: Any
    type: type
    help: str
    value: Any = None


_registry: Dict[str, _FlagDef] = {}


def _coerce(defn: _FlagDef, value: Any) -> Any:
    if defn.type is bool:
        if isinstance(value, str):
            return value.lower() in ("1", "true", "yes", "on")
        return bool(value)
    return defn.type(value)


def define_flag(name: str, default: Any, help: str = "",
                type: type = None) -> None:
    """Register a flag. Environment variable ``FLAGS_<name>`` overrides the
    default."""
    if not name.startswith("FLAGS_"):
        name = "FLAGS_" + name
    ftype = type if type is not None else default.__class__
    defn = _FlagDef(name=name, default=default, type=ftype, help=help)
    env = os.environ.get(name)
    defn.value = _coerce(defn, env) if env is not None else default
    _registry[name] = defn


_MISSING = object()


def flag(name: str, default: Any = _MISSING) -> Any:
    """Fast read of a single flag value. With ``default``, an unknown flag
    returns it instead of raising."""
    if not name.startswith("FLAGS_"):
        name = "FLAGS_" + name
    d = _registry.get(name)
    if d is None:
        if default is not _MISSING:
            return default
        raise KeyError(name)
    return d.value


def get_flags(names=None) -> Dict[str, Any]:
    """``{name: value}`` of every registered flag, or of ``names`` (one
    name or a list; each key as given)."""
    if names is None:
        return {k: d.value for k, d in _registry.items()}
    if isinstance(names, str):
        names = [names]
    return {n: _registry[n if n.startswith("FLAGS_") else "FLAGS_" + n]
            .value for n in names}


def set_flags(flags_dict: Dict[str, Any]) -> None:
    """Set registered flags at run time (coerced to each flag's type);
    an unknown name raises ``ValueError`` naming the known ones."""
    for name, value in flags_dict.items():
        key = name if name.startswith("FLAGS_") else "FLAGS_" + name
        d = _registry.get(key)
        if d is None:
            raise ValueError(f"unknown flag {name!r}; known flags: "
                             f"{sorted(_registry)}")
        d.value = _coerce(d, value)


# ---------------------------------------------------------------------------
# The eager tier (core/dispatch.py): the reference's core flags it honours.
# ---------------------------------------------------------------------------
define_flag("FLAGS_check_nan_inf", False,
            "Scan every eager op's output for NaN/Inf and raise naming the "
            "op (ref: FLAGS_check_nan_inf / nan_inf_utils_detail).", bool)
define_flag("FLAGS_retain_grad_for_all_tensor", False,
            "Keep .grad on non-leaf eager tensors too.", bool)


# ---------------------------------------------------------------------------
# Serving engine defaults (ServingConfig resolves these when a field is left
# unset; explicit ServingConfig values always win).
# ---------------------------------------------------------------------------
define_flag("FLAGS_serving_block_size", 16,
            "Paged-KV-cache block size (tokens per physical block).", int)
define_flag("FLAGS_serving_max_slots", 8,
            "Decode slots in the continuous-batching step — the fixed batch "
            "dimension of every decode dispatch.", int)
define_flag("FLAGS_serving_max_model_len", 2048,
            "Per-sequence KV capacity bound (prompt + generated - 1 KV "
            "entries); sets the block-table width ceil(len / block_size).",
            int)
define_flag("FLAGS_serving_queue_depth", 128,
            "Admission-queue bound: submits beyond this raise "
            "ServingQueueFull.", int)
define_flag("FLAGS_serving_decode_chunk", 8,
            "Cap on decode iterations per dispatch when a live request can "
            "retire early (EOS enabled), a prompt is mid-chunked-prefill, "
            "or the caller streams token events.", int)
define_flag("FLAGS_serving_prefix_cache", True,
            "Automatic prefix caching over content-hashed full KV blocks.",
            bool)
define_flag("FLAGS_serving_prefill_chunk", 256,
            "Chunked prefill: prompts longer than this prefill in chunks of "
            "this many tokens. 0 disables.", int)
define_flag("FLAGS_serving_mixed_batch", True,
            "Stall-free mixed batching: mid-flight prefill chunks ride the "
            "decode dispatch as extra query rows of one mixed step; False "
            "restores the two-phase path.", bool)
define_flag("FLAGS_serving_preempt", True,
            "On-demand KV paging with preemption; False restores the "
            "reservation-at-admission policy.", bool)
define_flag("FLAGS_serving_paged_kernel", "auto",
            "Decode attention path: 'auto' runs the CUDA paged-attention "
            "kernel on a card and the gather + masked-softmax path on the "
            "CPU; 'on' forces the kernel wrapper; 'off' forces the gather "
            "path.", str)
define_flag("FLAGS_serving_kv_quant", "",
            "Paged KV-cache quantization: 'int8' stores K/V blocks as int8 "
            "with per-token-per-head fp32 scales; '' = fp pool.", str)
define_flag("FLAGS_serving_spec_decode", 0,
            "Speculative decoding (ServingConfig.spec_decode): tokens "
            "drafted per verify dispatch by n-gram prompt lookup over the "
            "request's own prompt + generated context. Each verify runs one "
            "multi-query dispatch over the drafts and emits every accepted "
            "token plus the next one. Each position is drawn with the key "
            "of its own token index, so greedy and sampled streams equal "
            "non-speculative decode where the verify and decode routes "
            "round alike (fp32); at bf16 they may part where two candidates "
            "lie within rounding. 0 disables.", int)
define_flag("FLAGS_serving_spec_ngram", 3,
            "n-gram length the prompt-lookup drafter matches: a draft is "
            "proposed when the last n tokens reoccur earlier in the "
            "request's context, continuing from the most recent prior "
            "occurrence.", int)
define_flag("FLAGS_serving_policy", "fifo",
            "Default admission policy: fifo, priority, fair or edf.", str)
define_flag("FLAGS_serving_ttft_slo_s", 0.0,
            "Default time-to-first-token SLO (seconds) the EDF policy "
            "assumes for requests without a deadline. 0 = none.", float)
define_flag("FLAGS_serving_tenant_cache_quota", 0,
            "Max prefix-cache blocks one tenant may keep registered. 0 = "
            "unlimited.", int)
define_flag("FLAGS_serving_retry_after_s", 1.0,
            "Conservative retry-after hint (s) returned to shed clients "
            "before two retirements make an interval measurable.", float)
define_flag("FLAGS_serving_lora_rank", 8,
            "LoRA rank r of the device-resident adapter pool: every "
            "registered adapter's per-projection A/B factors are stored "
            "at this fixed rank so one stacked [L, slots, ...] pool serves "
            "every adapter. Registering an adapter with a different rank is "
            "a structured error naming this flag.", int)
define_flag("FLAGS_serving_lora_slots", 0,
            "Device-resident adapter slots of the paged adapter pool "
            "(slot 0 is the reserved zeroed BASE adapter and is not "
            "counted). 0 disables multi-adapter serving entirely — the "
            "engine runs exactly the base computation and base traffic is "
            "bit-identical to a LoRA-less build. With N slots, up to N "
            "distinct adapters decode concurrently; colder adapters "
            "LRU-evict to the host registry and reload on demand (counted "
            "as adapter_loads).", int)
define_flag("FLAGS_serving_lora_pool", 16,
            "Host-side adapter registry capacity — the most adapters "
            "register() accepts (resident + evicted; the zeroed base "
            "adapter is free). Registration past the bound is a structured "
            "error naming this flag. Must be >= FLAGS_serving_lora_slots.",
            int)

# host-RAM KV offload tier (ServingConfig.offload / offload_blocks)
define_flag("FLAGS_serving_offload", False,
            "Host-RAM KV offload tier (ServingConfig.offload): refcount-0 "
            "evictable blocks (including a preemption victim's registered "
            "blocks) swap to a bounded host-side pool instead of dying "
            "when device pressure evicts them — a later prefix hit or "
            "victim readmission H2D-restores the chain with zero "
            "recompute. Write-time checksums make a corrupt host block "
            "degrade to a cache MISS (recompute), never to wrong KV; the "
            "lookup() verification contract extends to the tier. Off by "
            "default: the tier costs host RAM and D2H bandwidth.", bool)
define_flag("FLAGS_serving_offload_blocks", 256,
            "Host-tier capacity bound in KV blocks "
            "(ServingConfig.offload_blocks): the offload pool holds at "
            "most this many swapped-out blocks, LRU-evicting beyond it "
            "(an evicted host block falls back to the recompute path "
            "bit-exactly). int8-quantized blocks are ~3.5x cheaper per "
            "block, so the same bound holds ~3.5x the cached tokens.", int)

define_flag("FLAGS_serving_migrate", False,
            "Live KV migration (RouterConfig.migrate): graceful drain, "
            "rolling restart, and scale-in transfer each in-flight "
            "request's KV block chain + resolved record to an adoptive "
            "replica (same shared-weights fleet, shapes always agree) "
            "instead of resubmitting for recompute — recomputed_tokens "
            "== 0 across a clean roll, token streams bit-identical. "
            "Falls back automatically to the resubmit path when the "
            "target can't take the blocks (pool-full, mid-crash, "
            "TP-shape mismatch). Off by default.", bool)

# engine supervisor: restart budget and graceful drain
define_flag("FLAGS_serving_max_restarts", 3,
            "EngineSupervisor restart budget: unexpected step-loop "
            "exceptions (or serving-section hang-watchdog trips) tear the "
            "engine down, rebuild it and re-submit every non-terminal "
            "request — past this many restarts the replica flips to "
            "not-accepting (/readyz 503) instead of crash-looping "
            "(docs/OPS.md runbook).", int)
define_flag("FLAGS_serving_drain_deadline_s", 30.0,
            "Graceful-drain deadline (s): on SIGTERM/close() the front "
            "line stops admissions (structured 503 + retry_after_s), "
            "finishes in-flight requests within this window, then cancels "
            "the remainder. The launcher's PADDLE_PREEMPT_GRACE (minus a "
            "2s margin) overrides when exported — the same preemption "
            "window the emergency-checkpoint path uses.", float)
define_flag("FLAGS_serving_client_queue", 64,
            "Per-client event-buffer bound in the asyncio serving server. "
            "A consumer that falls this many undelivered events behind is "
            "DISCONNECTED and its request cancelled through the normal "
            "lifecycle path (KV blocks freed immediately) — a stalled SSE "
            "reader cannot pin pool blocks or host memory.", int)
define_flag("FLAGS_serving_tp", 1,
            "Tensor-parallel degree for the serving engine "
            "(ServingConfig.tp): the QKV projections and the paged KV "
            "pool split their heads over a placement of this many devices "
            "(the engine's device= list; shards may share a card), one "
            "controller drives them and merges the heads by an exact "
            "concatenation. Requires num_kv_heads % tp == 0. 1 (the "
            "default) is the single-device engine.", int)

define_flag("FLAGS_serving_audit", False,
            "Run the serving InvariantAuditor's structural checks "
            "(block-pool partition conservation, zero leaks at idle, "
            "terminal-state consistency, per-tenant accounting closure, "
            "monotonic counters — the AUDIT_CHECKS registry) inside "
            "ServingRouter.health_snapshot(), surfacing the verdict on "
            "/metrics. Off by default: the checks walk every block map, "
            "a cost a hot serving loop should only pay when asked to.",
            bool)

# serving fleet router: multi-replica routing over supervised replicas
define_flag("FLAGS_serving_router_replicas", 2,
            "Replicas the ServingRouter spawns at construction when "
            "ServingRouter(replicas=) is left unset. All replicas share "
            "one set of weights (one device copy), so extra replicas cost "
            "KV-pool memory and host scheduling, never a second weight "
            "copy.", int)
define_flag("FLAGS_serving_router_max_replicas", 8,
            "Ceiling on fleet size: autoscale scale-up (and rejoin-file "
            "polls) stop spawning replicas at this many; scale-in never "
            "drains below 1.", int)
define_flag("FLAGS_serving_router_breaker_threshold", 3,
            "Per-replica circuit breaker: consecutive failures (probe "
            "raises, submit unavailability, supervisor restarts) before "
            "the breaker OPENS and the router stops routing to the "
            "replica.", int)
define_flag("FLAGS_serving_router_breaker_cooldown_s", 5.0,
            "Seconds an OPEN breaker waits before the router re-probes "
            "the replica HALF-OPEN (one health probe: success closes the "
            "breaker and the replica rejoins, failure re-opens with a "
            "fresh cooldown).", float)
define_flag("FLAGS_serving_router_hedge_ttft_mult", 0.0,
            "Hedged retry: a request still waiting for its FIRST token "
            "after mult x FLAGS_serving_ttft_slo_s seconds is duplicated "
            "onto a second healthy replica; whichever copy emits first "
            "wins and the loser is cancelled through the lifecycle path "
            "(KV freed — greedy outputs make the copies bit-identical, so "
            "the winner's stream is THE stream). 0 disables hedging; it "
            "also stays off while FLAGS_serving_ttft_slo_s is 0.", float)

# disaggregated prefill + fleet-wide cache directory
define_flag("FLAGS_serving_router_prefill_replicas", 0,
            "Prefill-only replicas the ServingRouter spawns in addition "
            "to its decode replicas (Splitwise/DistServe-style compute "
            "disaggregation): long prompts (see "
            "FLAGS_serving_prefill_len_threshold) run chunked prefill "
            "there, then hand the finished KV chain + resolved record to "
            "a decode replica via the live-migration adopt path with "
            "recomputed_tokens == 0. 0 disables the split — every prompt "
            "takes the unified path. The router also collapses to the "
            "unified path automatically when the pool is empty, draining "
            "or the transfer fails.", int)
define_flag("FLAGS_serving_prefill_len_threshold", 64,
            "Prompt length (tokens) at which the router classifies a "
            "request as LONG and routes its prefill to the prefill-only "
            "pool (when FLAGS_serving_router_prefill_replicas > 0). "
            "Shorter prompts always take the unified path — their "
            "prefill is too cheap to be worth a handoff.", int)
define_flag("FLAGS_serving_fleet_cache", True,
            "Fleet-wide KV cache directory: the router tracks which "
            "replica (device pool or host tier) holds each prefix-chain "
            "key, routes submits to the replica holding the LONGEST "
            "cached chain, and otherwise PULLS the cached blocks "
            "cross-replica (checksummed like offload puts — a mismatch "
            "degrades to recompute, never wrong KV). Off: each replica's "
            "prefix cache is an island and stickiness falls back to the "
            "first-block affinity map.", bool)

# durable serving: crash-safe request journal + cold-restart recovery
define_flag("FLAGS_serving_journal_dir", "",
            "Directory for the crash-safe serving request journal; empty "
            "disables durability. When set, EngineSupervisor and "
            "ServingRouter journal every submit / delivered-token cursor "
            "/ terminal transition there (crc32 + length framed WAL plus "
            "periodic snapshots), and EngineSupervisor.recover() / "
            "ServingRouter.cold_start() rebuild the fleet after a "
            "process death — every non-terminal request resubmitted "
            "bit-exactly from prompt + delivered-so-far, no delivered "
            "token ever re-emitted.", str)
define_flag("FLAGS_serving_journal_sync", "step",
            "Journal fsync policy: 'step' batches one fsync per engine "
            "step (the boundary at which tokens become visible to "
            "clients, so the journal never claims delivery of a token "
            "the caller could not have seen), 'always' fsyncs every "
            "record, 'off' leaves residency to the page cache (survives "
            "process death, not host death).", str)
define_flag("FLAGS_serving_snapshot_every", 64,
            "Engine steps (journal flushes) between serving-state "
            "snapshots; 0 disables periodic snapshots (the journal "
            "still snapshots once on graceful drain). Snapshots bound "
            "cold-restart replay to the WAL suffix written since the "
            "last good generation.", int)

# ---------------------------------------------------------------------------
# Checkpoint integrity (framework.io, distributed.checkpoint).
# ---------------------------------------------------------------------------
define_flag("FLAGS_checkpoint_verify", True,
            "Verify SHA-256 integrity (tier-1 footer, tier-3 shard manifests) "
            "on paddle.load / distributed checkpoint load; corruption raises "
            "CheckpointCorruptionError instead of unpickling garbage "
            "(docs/FAULT_TOLERANCE.md).", bool)
define_flag("FLAGS_emergency_ckpt_deadline_s", 10.0,
            "Default deadline (s) for the SIGTERM emergency checkpoint in "
            "elastic.install_preemption_handler when the launcher's "
            "PADDLE_PREEMPT_GRACE is not set; must sit inside the "
            "infrastructure's kill grace.", float)

# ---------------------------------------------------------------------------
# Run health (paddle_tpu_torch.health, the DataLoader's self-healing): the
# knobs sentinel_check, HealthMonitor and DataLoader read when their caller
# leaves them unset.
# ---------------------------------------------------------------------------
define_flag("FLAGS_health_sentinel", False,
            "Default for Model.prepare's sentinel knob: fuse the on-device "
            "NaN/Inf/loss-spike detector into the fused train step and skip "
            "bad updates. The fused step needs the jit package (ROADMAP "
            "section A, item 4); until then Model.prepare warns and ignores "
            "the knob.", bool)
define_flag("FLAGS_health_spike_factor", 0.0,
            "Loss-spike threshold: a step is bad when loss > factor * |EMA| "
            "(after FLAGS_health_spike_warmup good steps). 0 disables the "
            "spike test; NaN/Inf detection is always on when the sentinel "
            "is.", float)
define_flag("FLAGS_health_spike_warmup", 20,
            "Good steps required to seed the loss EMA before the spike test "
            "arms (early-training loss is legitimately volatile).", int)
define_flag("FLAGS_health_skip_threshold", 3,
            "K: consecutive bad steps before HealthMonitor escalates from "
            "skip to a last-good checkpoint restore.", int)
define_flag("FLAGS_health_max_restores", 3,
            "M: last-good restores before HealthMonitor aborts with a "
            "diagnosis (HealthAbortError) instead of burning more TPU "
            "hours.", int)
define_flag("FLAGS_health_lr_backoff", 1.0,
            "LR multiplier applied per health restore (HealthMonitor."
            "lr_scale; AnomalyMonitor applies it to the optimizer). 1.0 = "
            "no backoff.", float)
define_flag("FLAGS_health_data_retries", 0,
            "Default DataLoader retries for a failing Dataset.__getitem__ "
            "(bounded backoff between attempts). 0 keeps the raise-through "
            "behavior.", int)
define_flag("FLAGS_health_data_backoff_s", 0.05,
            "Base backoff (seconds, doubled per attempt) between "
            "Dataset.__getitem__ retries.", float)
define_flag("FLAGS_health_worker_restarts", 0,
            "Default max resurrections of a dead DataLoader worker "
            "(map-style datasets; in-flight batches are re-queued). 0 keeps "
            "the fail-fast behavior.", int)
define_flag("FLAGS_health_watchdog_timeout_s", 0.0,
            "health.watchdog.install() default: seconds without a progress "
            "tick before the in-process hang watchdog fires (stack-dump "
            "diagnosis; fatal=True exits HUNG_EXIT_RC). 0 = off.", float)
define_flag("FLAGS_profile_annotations", False,
            "Emit torch.profiler.record_function spans ('step') around the "
            "fused train step, jit_step and hapi's jit step so a trace "
            "attributes host time (profiler.annotate).", bool)

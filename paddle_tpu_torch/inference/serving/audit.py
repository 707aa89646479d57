"""Invariant auditor — one definition of every serving-stack invariant.

Counterpart of ``paddle_tpu/inference/serving/audit.py``
(``AUDIT_CHECKS``, ``InvariantViolation``, ``InvariantAuditor``), with the
same registry of named checks and the same verdicts, evaluated against the
port's live :class:`~.engine.ServingEngine`,
:class:`~.supervisor.EngineSupervisor` or :class:`~.router.ServingRouter`:

* **Per-step in tests** — the lifecycle and failover fuzzes call
  ``auditor.check(target)`` after every step instead of hand-rolling the
  partition sum.
* **In production** — :meth:`~.router.ServingRouter.audit` runs the
  structural checks under the fleet lock and
  ``router.health_snapshot()`` surfaces the result behind
  ``FLAGS_serving_audit`` (off by default: the checks walk every block
  map, which a hot serving loop should only pay when asked to).

The checks are pure host bookkeeping (block maps, scheduler records,
journal mirror, directory), so nothing here touches a device tensor.

A violation raises (or, in collecting mode, records) a structured
:class:`InvariantViolation` naming the CHECK, the REPLICA and the replay
MANIFEST that reproduces it. The auditor also keeps a deterministic
``trail`` — audit outcomes plus per-request emission digests — which two
runs of one trace must produce alike.
"""

from __future__ import annotations

import contextlib
import weakref
import zlib
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from .scheduler import (FINISHED, QUEUED, RUNNING, TERMINAL_STATES,
                        completes_by_tokens)

__all__ = ["InvariantAuditor", "InvariantViolation", "AUDIT_CHECKS"]


# check name -> what it proves; InvariantAuditor's check set is pinned to
# it (the same keys as the reference's registry).
AUDIT_CHECKS = {
    "block_partition": "pool conservation: free + evictable + in_use == "
                       "usable on every replica's BlockManager — the law "
                       "every admission/extension/preemption/terminal "
                       "path must preserve",
    "block_consistency": "ref-counted pool structure: every live "
                         "refcount >= 1, evictable ∩ in-use = ∅, free ∩ "
                         "in-use = ∅, the prefix-cache hash maps stay a "
                         "bijection, the null block is never owned, and "
                         "every live slot's block table points only at "
                         "blocks its request actually holds",
    "tier_partition": "host-tier conservation: a cached block "
                      "key is device-resident XOR host-resident (the "
                      "offload tier never shadows a registered key), the "
                      "tier never holds more blocks than its capacity "
                      "bound, every host entry carries exactly one "
                      "block's tokens with a checksum per pool leaf, and "
                      "the tier's swap/hit/drop counters never go "
                      "backwards (vacuously true with the tier off)",
    "quiesce_leaks": "zero leaked blocks at quiesce: a replica with no "
                     "queued or live work holds zero pool blocks "
                     "(vacuous mid-trace, enforced whenever a replica "
                     "idles and exhaustively at drain)",
    "lifecycle": "terminal-state consistency: queued/running requests "
                 "hold exactly the slot+blocks their state implies, "
                 "terminal records hold neither, token counts never "
                 "exceed the budget, and a FINISHED stream actually "
                 "completes (budget spent, EOS, or oom-truncated)",
    "tenant_closure": "per-tenant accounting closure: queued + live + "
                      "retired + cancelled + timed_out <= submitted <= "
                      "the same + shed, for every tenant row",
    "counters_monotonic": "lifetime counters never go backwards: "
                          "engine admitted/retired/cancelled/timed_out/"
                          "shed/preemptions, supervisor restarts, "
                          "breaker opens, router routed/failovers/"
                          "completed/failed/replica_restarts (baselines "
                          "re-key on rebuild, so a fresh engine's reset "
                          "is not a violation)",
    "exactly_once": "exactly-once token delivery (fed through "
                    "observe()): each request's delivered stream only "
                    "APPENDS — no repeats, no gaps, nothing after EOS "
                    "or past max_new_tokens, and the delivered ledger "
                    "matches the authoritative record — across "
                    "preemption, crash resubmit, failover and hedges",
    "migration_exactly_once": "live KV migration exactly-once: for "
                              "every primary route, the router's "
                              "delivered-token mirror is a "
                              "PREFIX of the serving replica's "
                              "authoritative record — an adopted "
                              "request resumed exactly where the origin "
                              "paused it, repeating no delivered token "
                              "and skipping none",
    "router_routes": "router bookkeeping: every (replica, srid) route "
                     "points at a live replica and a known request, and "
                     "the active set holds exactly the non-terminal "
                     "requests",
    "directory_coherence": "fleet cache directory: the "
                           "forward and reverse holder maps agree, no "
                           "entry has an empty holder set, the entry "
                           "bound holds, every holder rid names a "
                           "replica in the fleet, and NO entry is "
                           "stale-authoritative — each (key, replica) "
                           "claim is backed by that replica's device "
                           "prefix cache or host offload tier right now "
                           "(stale-missing is allowed by design: a pull "
                           "of a just-evicted chain degrades to "
                           "recompute; a stale-authoritative entry "
                           "would mean the invalidation callbacks "
                           "leaked) — vacuously true with the "
                           "directory off",
    "durable_exactly_once": "crash-safe journal coherence: "
                            "every live request owning a journal record "
                            "maps to a record that exists, is still "
                            "live, and mirrors the delivered token "
                            "stream EXACTLY; no journal record is owned "
                            "by two live requests at once (across the "
                            "whole fleet sharing one journal); a "
                            "terminal request's still-retained record "
                            "is terminal — so a kill -9 right now "
                            "recovers every stream from prompt + "
                            "delivered, losing nothing and re-emitting "
                            "nothing (vacuously true with the journal "
                            "off)",
    "adapter_pool_partition": "multi-adapter LoRA pool conservation: "
                              "every registered adapter is "
                              "device-resident XOR evicted, no two "
                              "resident adapters share a slot (slot 0 — "
                              "the zeroed base adapter — is never "
                              "assigned), every pinned adapter is "
                              "resident, and every RUNNING request "
                              "carrying an adapter_id runs on an adapter "
                              "that is resident at exactly the slot the "
                              "request carries and pinned against "
                              "eviction (vacuously true with "
                              "multi-adapter serving off)",
}


class InvariantViolation(AssertionError):
    """One named invariant failed. Structured so a fleet-scale replay
    failure names the CHECK that broke, the REPLICA it broke on, and the
    replay MANIFEST that reproduces it bit-exactly."""

    def __init__(self, check: str, message: str,
                 replica: Optional[str] = None,
                 manifest: Optional[Any] = None):
        self.check = check
        self.replica = replica
        self.manifest = manifest
        where = f" on {replica}" if replica else ""
        repro = f" [manifest: {manifest}]" if manifest is not None else ""
        super().__init__(f"invariant {check!r} violated{where}: "
                         f"{message}{repro}")


def _crc(tokens: Sequence[int]) -> int:
    """Deterministic digest of a token stream (the trail's compact
    spelling of 'these exact tokens, in this exact order')."""
    return zlib.crc32(b",".join(str(int(t)).encode() for t in tokens))


class InvariantAuditor:
    """Registry-driven auditor over live serving state. One instance per
    trace/replay: :meth:`observe` feeds the exactly-once ledger,
    :meth:`check` runs the structural checks (raising by default),
    :meth:`audit` is the non-raising production spelling, and
    :meth:`quiesce` is the exhaustive end-of-trace pass (every replica
    idle, zero blocks held, ledger closed against the final records)."""

    def __init__(self, manifest: Optional[Any] = None,
                 checks: Optional[Sequence[str]] = None,
                 history: Optional[int] = None):
        unknown = set(checks or ()) - set(AUDIT_CHECKS)
        if unknown:
            raise ValueError(f"unknown audit checks {sorted(unknown)}; "
                             f"registered: {sorted(AUDIT_CHECKS)}")
        self.manifest = manifest
        self.checks = tuple(checks) if checks is not None \
            else tuple(AUDIT_CHECKS)
        # ``history`` bounds the trail + retained-violation lists (the
        # PRODUCTION setting — a persistent auditor scraped forever must
        # not grow without bound); None = unbounded, the replay setting
        # (the determinism contract compares the FULL trail)
        self.history = history
        # exactly-once ledger: request id -> every token delivered so far
        self.ledger: Dict[Any, List[int]] = {}
        self._closed: Dict[Any, str] = {}       # id -> terminal state seen
        # monotonic-counter baselines: (label, owner type) -> (owner
        # identity, floors). The identity is a weakref where the owner
        # supports one (id() alone can COLLIDE when CPython reuses a
        # freed object's address), so an engine/supervisor REBUILD
        # re-bases instead of flagging the fresh object's reset counters
        # — and a replaced owner's stale entry is overwritten, not kept.
        self._bases: Dict[Tuple[str, str],
                          Tuple[Any, Dict[str, int]]] = {}
        # deterministic audit trail: ("emit", id, n, crc) per observe,
        # ("terminal", id, state, n, crc) per closure, ("audit", seq,
        # violations...) per structural pass — the replay-determinism
        # contract compares this list bit-for-bit across runs
        self.trail: List[Tuple] = []
        self._seq = 0
        self.violations: List[InvariantViolation] = []

    def _push(self, entry: Tuple) -> None:
        self.trail.append(entry)
        if self.history is not None and len(self.trail) > self.history:
            del self.trail[:len(self.trail) - self.history]

    def _retain(self, vs: Sequence[InvariantViolation]) -> None:
        self.violations.extend(vs)
        if self.history is not None \
                and len(self.violations) > self.history:
            del self.violations[:len(self.violations) - self.history]

    # ---- target resolution -------------------------------------------------

    @staticmethod
    def _engines(target) -> List[Tuple[str, Any]]:
        """(label, ServingEngine) per replica — a ServingRouter fans out,
        a supervisor/engine is a single-replica fleet of itself."""
        if hasattr(target, "_replicas"):                  # ServingRouter
            return [(f"replica {rid}", rep.sup.engine)
                    for rid, rep in target._replicas.items()]
        if hasattr(target, "engine"):                     # EngineSupervisor
            return [("replica", target.engine)]
        return [("engine", target)]                       # bare engine

    @contextlib.contextmanager
    def _locked(self, target):
        """Consistent multi-layer snapshot: the fleet lock (when present)
        then each engine lock — the same outer-to-inner order the router
        itself takes, so the auditor can run from any thread."""
        with contextlib.ExitStack() as stack:
            if hasattr(target, "_lock"):
                stack.enter_context(target._lock)
            engines = self._engines(target)
            for _, eng in engines:
                if hasattr(eng, "_lock"):
                    stack.enter_context(eng._lock)
            yield engines

    # ---- the exactly-once ledger -------------------------------------------

    def observe(self, emitted: Dict[Any, List[int]],
                lookup: Optional[Callable[[Any], Any]] = None) -> None:
        """Feed one step's ``{request id: [tokens emitted]}`` into the
        exactly-once ledger. ``lookup`` (id -> the authoritative record,
        or None) lets the ledger cross-check the delivered stream against
        the record's cumulative ``tokens`` — a repeat or a gap shows up
        as a divergence the moment it happens, not at quiesce."""
        if "exactly_once" not in self.checks:
            return
        for rid in sorted(emitted, key=repr):
            toks = [int(t) for t in emitted[rid]]
            if not toks:
                continue
            if rid in self._closed:
                self._fail("exactly_once",
                           f"request {rid} emitted {len(toks)} token(s) "
                           f"after reaching terminal state "
                           f"{self._closed[rid]!r}")
            rec = lookup(rid) if lookup is not None else None
            led = self.ledger.get(rid)
            if led is None and rec is not None:
                # first sight of a request that predates this auditor
                # (attached to a live fleet mid-flight): PRIME the
                # ledger from the authoritative record — the new tokens
                # must be its exact tail, and everything from here on is
                # tracked strictly. The budget/EOS checks below still
                # run: a request that overruns within its very first
                # observed emission must not slip through the priming.
                have = [int(t) for t in rec.tokens]
                if have[len(have) - len(toks):] != toks:
                    self._fail(
                        "exactly_once",
                        f"request {rid}: first observed emission "
                        f"({len(toks)} tokens) is not the tail of its "
                        f"record ({len(have)} tokens)")
                led = self.ledger[rid] = have
            else:
                if led is None:
                    led = self.ledger[rid] = []
                led.extend(toks)
            self._push(("emit", rid, len(led), _crc(led)))
            if rec is None:
                continue
            have = [int(t) for t in rec.tokens]
            if have != led:
                kind = ("repeat/gap" if len(have) != len(led)
                        else "token divergence")
                self._fail(
                    "exactly_once",
                    f"request {rid}: delivered ledger ({len(led)} tokens, "
                    f"crc {_crc(led)}) != authoritative record "
                    f"({len(have)} tokens, crc {_crc(have)}) — {kind}")
            mx = getattr(rec, "max_new_tokens", None)
            if mx is not None and len(led) > int(mx):
                self._fail("exactly_once",
                           f"request {rid} delivered {len(led)} tokens "
                           f"past its max_new_tokens={mx} budget")
            eos = getattr(rec, "eos_token_id", None)
            if eos is not None and int(eos) in led[:-1]:
                self._fail("exactly_once",
                           f"request {rid} delivered tokens after EOS "
                           f"({eos}) at position {led.index(int(eos))}")

    def close_request(self, rid, record) -> None:
        """Register a terminal record: the ledger for ``rid`` is frozen
        (any later emission is a violation) and the terminal state +
        stream digest land in the deterministic trail."""
        state = getattr(record, "state", "?")
        toks = [int(t) for t in record.tokens]
        led = self.ledger.get(rid)
        if "exactly_once" in self.checks and led is not None \
                and led != toks:
            self._fail("exactly_once",
                       f"request {rid} closed {state!r} with "
                       f"{len(toks)} tokens but the delivered ledger "
                       f"holds {len(led)}")
        self._closed[rid] = state
        self._push(("terminal", rid, state, len(toks), _crc(toks)))

    # ---- structural checks -------------------------------------------------

    def check(self, target, collect: bool = False
              ) -> List[InvariantViolation]:
        """Run every registered structural check against ``target``
        (router / supervisor / engine). Raises the first violation unless
        ``collect=True`` (then all violations are returned AND retained
        on ``self.violations``). Appends one deterministic trail entry
        per call."""
        found: List[InvariantViolation] = []

        def fail(check, msg, replica=None):
            v = InvariantViolation(check, msg, replica=replica,
                                   manifest=self.manifest)
            if not collect:
                self._push(("audit", self._seq, (check,)))
                self._seq += 1
                raise v
            found.append(v)

        with self._locked(target) as engines:
            for label, eng in engines:
                self._check_engine(label, eng, fail)
            if "durable_exactly_once" in self.checks:
                # fleet scope: the journal is SHARED across replicas,
                # so record ownership must be unique across all of them
                # — two live owners would double-deliver after a cold
                # restart (a vacated migration/hedge/handoff copy that
                # was never disowned)
                owners: Dict[int, List[str]] = {}
                for label, eng in engines:
                    if getattr(eng, "journal", None) is None:
                        continue
                    for rid, jid in eng._jlive.items():
                        owners.setdefault(int(jid), []).append(
                            f"{label} rid {rid}")
                for jid, who in sorted(owners.items()):
                    if len(who) > 1:
                        fail("durable_exactly_once",
                             f"journal record {jid} owned by "
                             f"{len(who)} live requests at once: "
                             f"{', '.join(who)}")
            if hasattr(target, "_replicas"):
                self._check_router(target, fail)
                if "counters_monotonic" in self.checks:
                    for rid, rep in target._replicas.items():
                        self._counter_floor(
                            f"replica {rid}", rep.sup,
                            ("restarts", "resubmitted", "adopted",
                             "migrated_in", "migrated_out",
                             "completed"), fail)
                        self._counter_floor(
                            f"replica {rid}", rep.breaker,
                            ("opens", "half_open_probes", "reclosures"),
                            fail)
            elif hasattr(target, "engine") \
                    and "counters_monotonic" in self.checks:
                self._counter_floor("replica", target,
                                    ("restarts", "resubmitted", "adopted",
                                     "migrated_in", "migrated_out",
                                     "completed"), fail)
        # prune baselines whose owner is gone (a drained/rebuilt
        # replica's supervisor, breaker, scheduler): a persistent
        # production auditor over an autoscaling fleet must not
        # accumulate an entry per dead replica id forever
        for k in [k for k, (r, _) in self._bases.items()
                  if isinstance(r, weakref.ref) and r() is None]:
            del self._bases[k]
        self._push(("audit", self._seq,
                    tuple(sorted(v.check for v in found))))
        self._seq += 1
        self._retain(found)
        return found

    def audit(self, target) -> Dict[str, Any]:
        """The production spelling (``router.audit()`` /
        ``FLAGS_serving_audit``): run everything, raise nothing, return a
        JSON-serializable verdict."""
        found = self.check(target, collect=True)
        return {"ok": not found,
                "checks": len(self.checks),
                "violations": [str(v) for v in found]}

    def quiesce(self, target, collect: bool = False
                ) -> List[InvariantViolation]:
        """The exhaustive end-of-trace pass: every structural check, plus
        'nothing is pending and nothing is held' enforced NON-vacuously
        on every replica."""
        found = self.check(target, collect=collect)

        def fail(check, msg, replica=None):
            v = InvariantViolation(check, msg, replica=replica,
                                   manifest=self.manifest)
            if not collect:
                raise v
            found.append(v)
            self._retain([v])

        with self._locked(target) as engines:
            for label, eng in engines:
                if eng._sched.pending:
                    fail("quiesce_leaks",
                         f"still pending at quiesce (queued="
                         f"{len(eng._sched.queue)}, live="
                         f"{len(eng._sched.live)})", replica=label)
                bm = eng.cache.manager
                if bm.blocks_in_use != 0:
                    fail("quiesce_leaks",
                         f"{bm.blocks_in_use} block(s) leaked at quiesce",
                         replica=label)
        return found

    # ---- per-engine checks -------------------------------------------------

    def _fail(self, check: str, msg: str, replica: Optional[str] = None):
        """Ledger-path failure (observe/close_request run outside a
        check() pass): record and raise immediately."""
        v = InvariantViolation(check, msg, replica=replica,
                               manifest=self.manifest)
        self._retain([v])
        raise v

    def _check_engine(self, label: str, eng, fail) -> None:
        bm = eng.cache.manager
        sched = eng._sched
        on = self.checks.__contains__
        if on("block_partition") or on("block_consistency"):
            self._check_manager(bm, lambda c, m: fail(c, m, label),
                                parts=on("block_partition"),
                                structure=on("block_consistency"))
        if on("block_consistency"):
            live = sched.live
            for req in live:
                for b in req.blocks or ():
                    if bm._ref.get(b, 0) < 1:
                        fail("block_consistency",
                             f"request {req.rid} holds block {b} with "
                             f"refcount {bm._ref.get(b, 0)}", label)
                if req.slot is not None:
                    row = set(int(b) for b in eng.cache.tables[req.slot])
                    extra = row - {0} - set(req.blocks or ())
                    if extra:
                        fail("block_consistency",
                             f"slot {req.slot} table maps foreign "
                             f"blocks {sorted(extra)} (request "
                             f"{req.rid} owns {req.blocks})", label)
        tier = getattr(eng.cache, "offload", None)
        if on("tier_partition") and tier is not None:
            self._check_tier(label, bm, tier, fail)
        if on("adapter_pool_partition") \
                and getattr(eng, "_lora", None) is not None:
            self._check_adapters(label, eng, fail)
        if on("durable_exactly_once"):
            self._check_durable(label, eng, fail)
        if on("quiesce_leaks") and not sched.pending \
                and bm.blocks_in_use != 0:
            fail("quiesce_leaks",
                 f"{bm.blocks_in_use} block(s) in use with no queued or "
                 f"live work", label)
        if on("lifecycle"):
            self._check_lifecycle(label, sched, fail)
        if on("tenant_closure"):
            self._check_tenants(label, sched, fail)
        if on("counters_monotonic"):
            self._counter_floor(
                label, sched,
                ("admitted", "retired", "cancelled", "timed_out", "shed",
                 "preemptions", "oom_truncated", "prefix_hit_tokens",
                 "recomputed_tokens", "spec_drafted", "spec_accepted"),
                fail)
            if tier is not None:
                self._counter_floor(
                    label, tier,
                    ("swap_outs", "swap_ins", "tier_hits", "tier_misses",
                     "corrupt_drops", "tier_evictions"), fail)
            pool = getattr(eng, "_lora", None)
            if pool is not None:
                self._counter_floor(label, pool,
                                    ("loads", "evictions"), fail)

    @staticmethod
    def _check_tier(label: str, bm, tier, fail) -> None:
        """The host-tier half of the conservation story: the
        tier stays inside its bound, holds only well-formed single-block
        entries, and never shadows a device-registered key — residency is
        device XOR host, so a prefix hit has exactly one authoritative
        source."""
        if tier.blocks > tier.capacity:
            fail("tier_partition",
                 f"host tier holds {tier.blocks} block(s) past its "
                 f"capacity bound {tier.capacity}", label)
        shadowed = set(bm._hash2block) & set(tier.keys())
        if shadowed:
            fail("tier_partition",
                 f"key(s) {sorted(shadowed)[:4]} resident on device AND "
                 f"in the host tier (residency must be XOR)", label)
        for key, e in tier._entries.items():
            if len(e["tokens"]) != tier.block_size:
                fail("tier_partition",
                     f"host entry {key} holds {len(e['tokens'])} tokens "
                     f"(exactly block_size={tier.block_size} expected)",
                     label)
            if set(e["crc"]) != set(e["data"]):
                fail("tier_partition",
                     f"host entry {key} checksum leaves "
                     f"{sorted(e['crc'])} != data leaves "
                     f"{sorted(e['data'])}", label)
        for key, (toks, _) in tier._pending.items():
            if len(toks) != tier.block_size:
                fail("tier_partition",
                     f"pending host entry {key} holds {len(toks)} tokens "
                     f"(exactly block_size={tier.block_size} expected)",
                     label)

    @staticmethod
    def _check_adapters(label: str, eng, fail) -> None:
        """The adapter-pool half of the multi-adapter story:
        residency is a partition of the registry, slots are exclusive,
        and a running request's adapter can never be evicted out from
        under its in-flight dispatches (the pin lifecycle's whole job).
        Vacuously true with multi-adapter serving off."""
        part = eng.adapter_partition()
        if part is None:
            return
        registered = set(part["registered"])
        resident = dict(part["resident"])
        evicted = set(part["evicted"])
        pinned = dict(part["pinned"])
        both = set(resident) & evicted
        if both:
            fail("adapter_pool_partition",
                 f"adapter(s) {sorted(both)} resident AND evicted "
                 f"(residency must be XOR)", label)
        neither = registered - set(resident) - evicted
        if neither:
            fail("adapter_pool_partition",
                 f"registered adapter(s) {sorted(neither)} neither "
                 f"resident nor evicted", label)
        stray = (set(resident) | evicted | set(pinned)) - registered
        if stray:
            fail("adapter_pool_partition",
                 f"unregistered adapter(s) {sorted(stray)} tracked by "
                 f"the pool", label)
        slots = list(resident.values())
        if 0 in slots:
            fail("adapter_pool_partition",
                 "an adapter occupies slot 0 (reserved for the zeroed "
                 "base adapter)", label)
        if len(set(slots)) != len(slots):
            fail("adapter_pool_partition",
                 f"two resident adapters share a slot: {resident}", label)
        for name in pinned:
            if name not in resident:
                fail("adapter_pool_partition",
                     f"pinned adapter {name!r} is not resident", label)
        for rid, (aid, slot) in sorted(part["running"].items()):
            if resident.get(aid) != slot:
                fail("adapter_pool_partition",
                     f"running request {rid} carries adapter {aid!r} at "
                     f"slot {slot} but the pool has it at "
                     f"{resident.get(aid)}", label)
            if pinned.get(aid, 0) < 1:
                fail("adapter_pool_partition",
                     f"running request {rid}'s adapter {aid!r} holds no "
                     f"pin — an eviction could swap its weights "
                     f"mid-stream", label)

    @staticmethod
    def _check_durable(label: str, eng, fail) -> None:
        """The journal half of the durability story: the
        in-memory journal mirror must be EXACTLY what cold-start
        recovery would rebuild from — a kill -9 after this step's fsync
        replays every live stream from prompt + delivered-so-far with
        nothing lost and nothing re-emitted. A disowned request
        (jid -1: hedge copy, vacated migration source) asserts nothing
        here; its logical request owns the record elsewhere. Vacuously
        true with the journal off."""
        journal = getattr(eng, "journal", None)
        if journal is None:
            return
        sched = eng._sched
        for req in list(sched.queue) + sched.live:
            if req.jid < 0:
                continue
            rec = journal.records.get(req.jid)
            if rec is None:
                fail("durable_exactly_once",
                     f"live request {req.rid} owns journal record "
                     f"{req.jid}, which does not exist", label)
                continue
            if rec.terminal:
                fail("durable_exactly_once",
                     f"live request {req.rid}'s journal record "
                     f"{req.jid} already closed {rec.state!r} — a cold "
                     f"restart would drop the stream", label)
                continue
            jt = [int(t) for t in rec.tokens]
            rt = [int(t) for t in req.tokens]
            if jt != rt:
                verb = "re-emit" if len(jt) < len(rt) else "skip"
                fail("durable_exactly_once",
                     f"request {req.rid}: journal record {req.jid} "
                     f"holds {len(jt)} token(s) (crc {_crc(jt)}) but "
                     f"the live request delivered {len(rt)} (crc "
                     f"{_crc(rt)}) — recovery would {verb} delivered "
                     f"tokens", label)
        for rid, req in sched.finished.items():
            if req.jid < 0:
                continue
            rec = journal.records.get(req.jid)
            if rec is None:
                continue       # bounded terminal retention pruned it
            if not rec.terminal:
                fail("durable_exactly_once",
                     f"terminal request {rid} ({req.state!r}) left "
                     f"journal record {req.jid} live — a cold restart "
                     f"would resurrect a stream the client saw end",
                     label)

    @staticmethod
    def _check_manager(bm, fail, parts: bool = True,
                       structure: bool = True) -> None:
        usable = bm.num_blocks - 1
        if parts:
            total = len(bm._free) + len(bm._evictable) + bm.blocks_in_use
            if total != usable:
                fail("block_partition",
                     f"free({len(bm._free)}) + evictable"
                     f"({len(bm._evictable)}) + in_use({bm.blocks_in_use}) "
                     f"= {total} != usable({usable})")
            if bm.free_blocks != usable - bm.blocks_in_use:
                fail("block_partition",
                     f"free_blocks {bm.free_blocks} != usable - in_use "
                     f"({usable - bm.blocks_in_use})")
        if not structure:
            return
        free, ref, evict = set(bm._free), set(bm._ref), set(bm._evictable)
        for name, s in (("free list", free), ("in-use set", ref),
                        ("evictable list", evict)):
            if 0 in s:
                fail("block_consistency", f"null block 0 on the {name}")
        if len(free) != len(bm._free):
            fail("block_consistency", "duplicate ids on the free list")
        for a, b, an, bn in ((free, ref, "free", "in-use"),
                             (evict, ref, "evictable", "in-use"),
                             (free, evict, "free", "evictable")):
            inter = a & b
            if inter:
                fail("block_consistency",
                     f"{an} ∩ {bn} = {sorted(inter)} (must be empty)")
        bad = [b for b, r in bm._ref.items() if r < 1]
        if bad:
            fail("block_consistency",
                 f"live refcount < 1 on blocks {sorted(bad)}")
        fwd = {k: b for k, b in bm._hash2block.items()}
        rev = {b: k for b, k in bm._block2hash.items()}
        if {b: k for k, b in fwd.items()} != rev:
            fail("block_consistency",
                 "prefix-cache hash maps are not a bijection "
                 f"({len(fwd)} keys vs {len(rev)} blocks)")
        for b in evict:
            if b not in rev:
                fail("block_consistency",
                     f"evictable block {b} is not registered (it should "
                     f"have returned to the free list)")

    @staticmethod
    def check_manager(bm) -> None:
        """Bare-BlockManager spelling of the pool checks (the fuzz tests
        that drive a manager without an engine around it)."""

        def fail(check, msg):
            raise InvariantViolation(check, msg)

        InvariantAuditor._check_manager(bm, fail)

    def _check_lifecycle(self, label: str, sched, fail) -> None:
        for req in sched.queue:
            if req.state != QUEUED:
                fail("lifecycle", f"queued request {req.rid} in state "
                     f"{req.state!r}", label)
            if req.slot is not None or req.blocks is not None:
                fail("lifecycle", f"queued request {req.rid} still holds "
                     f"slot={req.slot} blocks={req.blocks}", label)
        for m, req in enumerate(sched.slots):
            if req is None:
                continue
            if req.state != RUNNING:
                fail("lifecycle", f"slot {m} request {req.rid} in state "
                     f"{req.state!r}", label)
            if req.slot != m or req.blocks is None:
                fail("lifecycle", f"slot {m} request {req.rid} has "
                     f"slot={req.slot} blocks={req.blocks}", label)
            if len(req.tokens) > req.max_new_tokens:
                fail("lifecycle", f"request {req.rid} holds "
                     f"{len(req.tokens)} tokens past its "
                     f"{req.max_new_tokens} budget", label)
        for rid, req in sched.finished.items():
            if req.state not in TERMINAL_STATES:
                fail("lifecycle", f"recorded request {rid} in non-"
                     f"terminal state {req.state!r}", label)
            if req.slot is not None or req.blocks is not None:
                fail("lifecycle", f"terminal request {rid} still holds "
                     f"slot={req.slot} blocks={req.blocks}", label)
            if len(req.tokens) > req.max_new_tokens:
                fail("lifecycle", f"terminal request {rid} holds "
                     f"{len(req.tokens)} tokens past its "
                     f"{req.max_new_tokens} budget", label)
            if req.state == FINISHED and not req.oom_truncated \
                    and not completes_by_tokens(req.tokens,
                                                req.max_new_tokens,
                                                req.eos_token_id):
                fail("lifecycle", f"request {rid} recorded FINISHED with "
                     f"{len(req.tokens)}/{req.max_new_tokens} tokens, "
                     f"no EOS, not oom-truncated", label)

    def _check_tenants(self, label: str, sched, fail) -> None:
        # queued/live per tenant ROW, overflow-folded exactly as the
        # counters were at submit (Scheduler.by_tenant is the one folding)
        occupancy = sched.by_tenant()
        for name, t in sched.tenants.items():
            occ = occupancy[name]
            settled = (occ["queued"] + occ["live"] + t["retired"]
                       + t["cancelled"] + t["timed_out"])
            if not settled <= t["submitted"] <= settled + t["shed"]:
                fail("tenant_closure",
                     f"tenant {name!r}: submitted={t['submitted']} "
                     f"outside [{settled}, {settled + t['shed']}] "
                     f"(queued={occ['queued']} live={occ['live']} "
                     f"retired={t['retired']} "
                     f"cancelled={t['cancelled']} "
                     f"timed_out={t['timed_out']} shed={t['shed']})",
                     label)

    def _counter_floor(self, label: str, owner, names: Sequence[str],
                       fail) -> None:
        key = (label, type(owner).__name__)
        entry = self._bases.get(key)
        same = False
        if entry is not None:
            ident, base = entry
            # a live weakref proves it is the SAME object (id() alone can
            # collide: CPython reuses a freed object's address, and a
            # rebuilt owner landing on the old address must re-base, not
            # inherit the dead object's floors)
            same = (ident() is owner if isinstance(ident, weakref.ref)
                    else ident == id(owner))
        if not same:
            try:
                ident = weakref.ref(owner)
            except TypeError:          # __slots__ without __weakref__
                ident = id(owner)
            base = {}
            self._bases[key] = (ident, base)
        for n in names:
            v = int(getattr(owner, n, 0))
            if v < base.get(n, 0):
                fail("counters_monotonic",
                     f"{type(owner).__name__}.{n} went backwards: "
                     f"{base[n]} -> {v}", label)
            base[n] = max(v, base.get(n, 0))

    # ---- router-scope checks -----------------------------------------------

    def _check_router(self, router, fail) -> None:
        on = self.checks.__contains__
        if on("router_routes"):
            for rid, routes in router._routes.items():
                if rid not in router._replicas:
                    fail("router_routes",
                         f"routes held for unknown replica {rid}")
                for srid, frid in routes.items():
                    if frid not in router._reqs:
                        fail("router_routes",
                             f"route ({rid}, {srid}) -> unknown request "
                             f"{frid}")
            for frid, req in router._active.items():
                if req.terminal:
                    fail("router_routes",
                         f"terminal request {frid} ({req.state!r}) still "
                         f"in the active set")
            for frid, req in router._reqs.items():
                if not req.terminal and frid not in router._active:
                    fail("router_routes",
                         f"live request {frid} missing from the active "
                         f"set")
        if on("exactly_once"):
            # gated by (and named for) the delivery invariant it proves,
            # not the route-bookkeeping block it used to ride in
            for frid, req in router._reqs.items():
                if len(req.tokens) > req.max_new_tokens:
                    fail("exactly_once",
                         f"router request {frid} holds "
                         f"{len(req.tokens)} tokens past its "
                         f"{req.max_new_tokens} budget")
        if on("migration_exactly_once"):
            for rid, routes in router._routes.items():
                rep = router._replicas.get(rid)
                if rep is None:
                    continue
                for srid, frid in routes.items():
                    req = router._reqs.get(frid)
                    if req is None or req.terminal:
                        continue
                    if (req.replica, req.srid) != (rid, srid):
                        continue       # hedge copy: mirrors the primary
                    rec = rep.sup._reqs.get(srid)
                    if rec is None:
                        continue
                    have = [int(t) for t in rec.tokens]
                    mirror = [int(t) for t in req.tokens]
                    if have[:len(mirror)] != mirror:
                        fail("migration_exactly_once",
                             f"request {frid} on replica {rid}: the "
                             f"router's delivered mirror ({len(mirror)} "
                             f"tokens, crc {_crc(mirror)}) is not a "
                             f"prefix of the replica record "
                             f"({len(have)} tokens, crc {_crc(have)}) — "
                             f"a migration/failover repeated or skipped "
                             f"a delivered token")
        if on("directory_coherence"):
            d = getattr(router, "_directory", None)
            if d is not None:
                for msg in d.check_consistency():
                    fail("directory_coherence", msg)
                for key, holders in d.items():
                    for rid in holders:
                        rep = router._replicas.get(rid)
                        if rep is None:
                            fail("directory_coherence",
                                 f"key {key} names replica {rid}, which "
                                 f"is not in the fleet")
                            continue
                        try:
                            cache = rep.sup.engine.cache
                        except Exception:  # noqa: BLE001 — mid-rebuild;
                            continue       # _observe drops the rid next
                        dev = key in cache.manager._hash2block
                        host = (cache.offload is not None
                                and cache.offload.holds(key))
                        if not (dev or host):
                            fail("directory_coherence",
                                 f"stale-authoritative entry: key {key} "
                                 f"names replica {rid} but neither its "
                                 f"device pool nor its host tier holds "
                                 f"it", str(rid))
                if "counters_monotonic" in self.checks:
                    self._counter_floor("directory", d,
                                        ("adds", "drops", "evicted"),
                                        fail)
        if on("counters_monotonic"):
            self._counter_floor(
                "router", router,
                ("routed", "sticky_hits", "failovers", "failover_tokens",
                 "hedges", "hedge_wins", "hedges_cancelled",
                 "probe_failures", "replica_restarts", "rolls_completed",
                 "migrations", "migration_tokens", "migration_fallbacks",
                 "directory_hits", "cache_pulls", "pulled_blocks",
                 "pull_fallbacks", "prefill_routed", "prefill_handoffs",
                 "handoff_fallbacks",
                 "completed", "failed", "_shed_accum", "_opens_retired",
                 "_restarts_retired"), fail)

    # ---- determinism surface ----------------------------------------------

    def digest(self) -> Dict[str, Any]:
        """Deterministic summary for the replay-determinism contract:
        per-request final stream digests plus the full trail length. Two
        replays of one manifest must produce EQUAL digests (and equal
        ``trail`` lists)."""
        return {
            "requests": {repr(rid): (len(t), _crc(t))
                         for rid, t in sorted(self.ledger.items(),
                                              key=lambda kv: repr(kv[0]))},
            "terminal": {repr(rid): st
                         for rid, st in sorted(self._closed.items(),
                                               key=lambda kv: repr(kv[0]))},
            "trail_len": len(self.trail),
            "violations": [str(v) for v in self.violations],
        }

"""One serving replica as the router sees it: a supervised engine stack
plus the health machinery that decides whether traffic may land on it.

Counterpart of ``paddle_tpu/inference/serving/replica.py``
(``CircuitBreaker``, ``Replica``), pure host logic with the same
contract. A :class:`Replica` wraps one :class:`~.supervisor.
EngineSupervisor` (crash barrier, restart budget, graceful drain) behind
the two things a router needs:

* **A probe surface.** :meth:`Replica.probe` is the in-process spelling of
  ``GET /readyz`` + ``health_snapshot()``: it returns the supervisor's
  snapshot, or raises — and a raising probe is ITSELF a health signal the
  circuit breaker consumes (a replica whose ops surface is wedged even
  though the engine might not be).

* **A circuit breaker.** :class:`CircuitBreaker` is the classic three
  states: CLOSED passes traffic and counts consecutive failures; at the
  threshold it OPENS and the router routes around the replica entirely; a
  cooldown later the router re-probes HALF-OPEN — one probe, no user
  traffic at risk — and the breaker either closes (the replica rejoins
  the candidate set) or re-opens with a fresh cooldown. Every transition
  is counted (``opens`` / ``half_open_probes`` / ``reclosures``) and
  surfaced in the router's ``health_snapshot()``.

The replica also carries the rolling-restart bookkeeping (``generation``
bumps every rebuild, ``draining``/``retiring`` gate routing) — the router
owns the policy, the replica owns the state.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional

from ...flags import flag
from .supervisor import EngineSupervisor

__all__ = ["CircuitBreaker", "Replica",
           "BREAKER_CLOSED", "BREAKER_OPEN", "BREAKER_HALF_OPEN"]

BREAKER_CLOSED = "closed"          # traffic flows; failures counted
BREAKER_OPEN = "open"              # no traffic until the cooldown elapses
BREAKER_HALF_OPEN = "half_open"    # one probe in flight decides the rest


class CircuitBreaker:
    """Consecutive-failure breaker: ``threshold`` failures in a row OPEN
    it, ``cooldown_s`` later one HALF-OPEN probe decides between closing
    (success) and re-opening (failure). A failure while HALF-OPEN always
    re-opens — a single bad probe must not let a sick replica flap back
    into rotation."""

    def __init__(self, threshold: Optional[int] = None,
                 cooldown_s: Optional[float] = None):
        self.threshold = int(
            threshold if threshold is not None
            else flag("FLAGS_serving_router_breaker_threshold"))
        self.cooldown_s = float(
            cooldown_s if cooldown_s is not None
            else flag("FLAGS_serving_router_breaker_cooldown_s"))
        self.state = BREAKER_CLOSED
        self.consecutive_failures = 0
        self.opened_t: Optional[float] = None
        self.opens = 0
        self.half_open_probes = 0
        self.reclosures = 0            # closed again from half-open

    def allow(self) -> bool:
        """Whether the router may route traffic here right now. Only a
        CLOSED breaker passes traffic; HALF_OPEN passes only the health
        probe (which goes through :meth:`probe_started`, not here)."""
        return self.state == BREAKER_CLOSED

    def ready_to_probe(self, now: Optional[float] = None) -> bool:
        """An OPEN breaker whose cooldown has elapsed wants its half-open
        probe."""
        if self.state != BREAKER_OPEN:
            return False
        now = time.time() if now is None else now
        return self.opened_t is None or now - self.opened_t >= self.cooldown_s

    def probe_started(self) -> None:
        self.state = BREAKER_HALF_OPEN
        self.half_open_probes += 1

    def record_success(self) -> None:
        if self.state == BREAKER_HALF_OPEN:
            self.reclosures += 1
        self.consecutive_failures = 0
        self.state = BREAKER_CLOSED

    def record_failure(self, now: Optional[float] = None) -> None:
        self.consecutive_failures += 1
        if self.state == BREAKER_HALF_OPEN or \
                self.consecutive_failures >= self.threshold:
            self.trip(now)

    def trip(self, now: Optional[float] = None) -> None:
        """Force OPEN immediately (a broken replica does not get to count
        down the threshold)."""
        if self.state != BREAKER_OPEN:
            self.opens += 1
        self.state = BREAKER_OPEN
        self.opened_t = time.time() if now is None else now
        self.consecutive_failures = max(self.consecutive_failures,
                                        self.threshold)

    def reset(self) -> None:
        """A rebuilt replica starts with a clean breaker (the counters
        survive — flapping history is an ops signal)."""
        self.state = BREAKER_CLOSED
        self.consecutive_failures = 0
        self.opened_t = None

    def snapshot(self) -> Dict[str, Any]:
        return {"state": self.state,
                "consecutive_failures": self.consecutive_failures,
                "threshold": self.threshold,
                "cooldown_s": self.cooldown_s,
                "opens": self.opens,
                "half_open_probes": self.half_open_probes,
                "reclosures": self.reclosures}


class Replica:
    """One supervised engine stack plus its router-side state. The
    supervisor object is REPLACEABLE (rolling restarts swap in a fresh
    one, bumping ``generation``); the replica identity — rid, breaker
    history, restart counters — survives the swap."""

    def __init__(self, rid: int, supervisor: EngineSupervisor,
                 breaker: Optional[CircuitBreaker] = None,
                 role: str = "decode"):
        self.rid = rid
        self.sup = supervisor
        self.breaker = breaker if breaker is not None else CircuitBreaker()
        # "decode" serves the full lifecycle; "prefill" (disaggregated
        # prefill) only runs prompts to their first token and
        # hands the chain to a decode replica — the router's candidate
        # sets filter on this, the role never changes after spawn
        self.role = role
        self.generation = 0            # bumps per rolling-restart rebuild
        self.retiring = False          # scale-in: remove once drained
        self.restarts_seen = 0         # supervisor restarts already counted
        self.broken_seen = False       # broken already failed over
        self.shed_seen = 0             # cumulative shed already folded into
        #                                the router's monotonic fleet total
        self.probe_cache: Optional[Dict[str, Any]] = None
        self.probe_t = 0.0             # router's probe TTL cache
        self.probe_depth = 0           # queued+live from the last probe
        #                                (the P2C comparison key)

    # ---- health ------------------------------------------------------------

    @property
    def draining(self) -> bool:
        return bool(self.sup.drain_requested or self.sup.draining)

    def probe(self) -> Dict[str, Any]:
        """The router's health probe: ``health_snapshot()`` (which folds
        in the ``/readyz`` predicate as ``accepting``). Raises when the
        replica's ops surface is wedged — the caller records that on the
        breaker."""
        return self.sup.health_snapshot()

    def routable(self) -> bool:
        """Whether NEW traffic may land here: breaker closed, not
        draining/retiring, restart budget intact, admission queue open.
        Never raises — a raising accepting-check counts as not routable
        (the probe path is where failures are charged)."""
        if not self.breaker.allow() or self.retiring or self.draining:
            return False
        try:
            return bool(self.sup.accepting)
        except Exception:              # noqa: BLE001 — wedged ops surface
            return False

    def adoptable(self) -> bool:
        """Whether work may still LAND here when the admission queue is
        full: breaker closed, not retiring/draining, restart budget
        intact. Weaker than :meth:`routable` (which also needs an open
        queue) — failover resubmit bypasses the queue bound (the work
        was accepted once, somewhere), and the submit path falls back to
        this set so plain overload sheds with the engine's structured
        429, not a misleading \"broken/circuit-broken\" 503."""
        return (self.breaker.allow() and not self.retiring
                and not self.draining and not self.sup.broken)

    def depth(self) -> int:
        """Queued + live work (the power-of-two-choices comparison key)."""
        return self.sup.depth()

    # ---- lifecycle ---------------------------------------------------------

    def replace(self, supervisor: EngineSupervisor) -> EngineSupervisor:
        """Swap in a freshly built supervisor (rolling restart): the old
        one is returned for inspection, the breaker resets to CLOSED and
        the crash bookkeeping re-bases on the new stack."""
        old, self.sup = self.sup, supervisor
        self.generation += 1
        self.restarts_seen = 0
        self.broken_seen = False
        self.shed_seen = 0             # the fresh supervisor counts from 0
        self.probe_cache = None        # never serve the dead stack's probe
        self.breaker.reset()
        return old

    def snapshot(self) -> Dict[str, Any]:
        """The per-replica row in the router's ``health_snapshot()``."""
        try:
            depth = self.depth()
        except Exception:              # noqa: BLE001
            depth = None
        return {"accepting": self.routable(),
                "role": self.role,
                "broken": bool(self.sup.broken),
                "draining": self.draining,
                "retiring": self.retiring,
                "generation": self.generation,
                "restarts": self.sup.restarts,
                "depth": depth,
                "breaker": self.breaker.snapshot()}

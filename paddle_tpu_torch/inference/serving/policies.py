"""Pluggable admission policies — WHO gets the next free slot.

Counterpart of ``paddle_tpu/inference/serving/policies.py``, ported whole
(pure host logic). The :class:`~.scheduler.Scheduler` consults the policy
each iteration:

=============  =============================================================
policy         admission order
=============  =============================================================
``fifo``       submission order (the default, and the parity baseline:
               admission order must never change a request's tokens)
``priority``   higher ``Request.priority`` first; FIFO within a class
``fair``       weighted fair share across ``Request.tenant``: the queued
               tenant with the least weighted service (prefill + decode
               tokens, divided by its weight) admits next
``edf``        earliest deadline first: explicit deadline, else
               ``submit_t + default_ttft_slo_s``
=============  =============================================================

Two properties every policy inherits from the scheduler: a PREEMPTED
request re-queued at the front readmits ahead of the policy's pick, and
admission is head-of-line per the policy's order (a pick whose blocks do
not fit waits for a retirement instead of being skipped). Policies only
reorder admission; greedy outputs are identical under every policy.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

__all__ = ["AdmissionPolicy", "FIFOPolicy", "PriorityPolicy",
           "FairSharePolicy", "EDFPolicy", "POLICIES", "resolve_policy"]


class AdmissionPolicy:
    """Strategy interface: pick which queued request admits next.

    ``select`` sees the live queue (never empty), the scheduler (for
    tenant service accounting), and the current time; it must return one
    of the queued requests and must not mutate the queue.
    """

    name = "fifo"

    def select(self, queue: Sequence, sched, now: float):
        return queue[0]


class FIFOPolicy(AdmissionPolicy):
    """Submission order — the default and the behavioral baseline."""


class PriorityPolicy(AdmissionPolicy):
    """Strict priority classes: highest ``Request.priority`` first, FIFO
    within a class. No aging — a saturated high class starves lower ones
    by design (pair with deadlines/timeouts if that is not acceptable)."""

    name = "priority"

    def select(self, queue, sched, now):
        return max(queue, key=lambda r: (r.priority, -r.rid))


class FairSharePolicy(AdmissionPolicy):
    """Weighted fair share across tenants: admit the queued tenant with
    the least weighted service so far. Service is the tokens the engine
    has actually spent on the tenant (prompt tokens at admission + decode
    tokens at retirement, ``Scheduler.tenant()['service_tokens']``);
    weights default to 1.0 per tenant, so a tenant flooding the queue
    gets the same share as everyone else instead of the whole engine —
    the ``flood_tenant`` chaos injector's recovery proof."""

    name = "fair"

    def __init__(self, weights: Optional[Dict[str, float]] = None):
        self.weights = dict(weights or {})

    def select(self, queue, sched, now):
        def share(t: str) -> float:
            w = max(self.weights.get(t, 1.0), 1e-9)
            return sched.tenant(t)["service_tokens"] / w

        best = min({r.tenant for r in queue}, key=lambda t: (share(t), t))
        return next(r for r in queue if r.tenant == best)


class EDFPolicy(AdmissionPolicy):
    """Earliest deadline first. A request's effective deadline is its
    explicit one (``submit(timeout_s=/deadline_s=)``) or ``submit_t +
    default_ttft_slo_s`` when the policy carries a default SLO; requests
    with neither sort last (FIFO among themselves). The engine sheds
    queued requests whose explicit deadline already passed before they
    waste prefill — EDF orders the rest so the tightest feasible SLOs are
    met first (the overload bench row's p99-TTFT win over FIFO)."""

    name = "edf"

    def __init__(self, default_ttft_slo_s: Optional[float] = None):
        self.default_ttft_slo_s = (float(default_ttft_slo_s)
                                   if default_ttft_slo_s else None)

    def _deadline(self, req) -> float:
        if req.deadline is not None:
            return req.deadline
        if self.default_ttft_slo_s is not None:
            return req.submit_t + self.default_ttft_slo_s
        return float("inf")

    def select(self, queue, sched, now):
        return min(queue, key=lambda r: (self._deadline(r), r.rid))


POLICIES = {
    "fifo": FIFOPolicy,
    "priority": PriorityPolicy,
    "fair": FairSharePolicy,
    "edf": EDFPolicy,
}


def resolve_policy(spec, ttft_slo_s: Optional[float] = None
                   ) -> AdmissionPolicy:
    """An :class:`AdmissionPolicy` from a config value: an instance
    passes through (programmatic weights/SLOs), a name constructs the
    registered class (``edf`` picks up ``ttft_slo_s`` — the
    ``FLAGS_serving_ttft_slo_s`` default), None means FIFO."""
    if isinstance(spec, AdmissionPolicy):
        return spec
    if spec is None:
        return FIFOPolicy()
    name = str(spec).lower().replace("-", "_").replace("fair_share", "fair")
    if name not in POLICIES:
        raise ValueError(f"unknown admission policy {spec!r}; "
                         f"options: {sorted(POLICIES)}")
    if name == "edf":
        return EDFPolicy(default_ttft_slo_s=ttft_slo_s)
    return POLICIES[name]()

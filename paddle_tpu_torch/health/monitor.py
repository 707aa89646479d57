"""Run-health recovery policy: skip -> restore last-good -> abort —
counterpart of ``paddle_tpu/health/monitor.py``, the same ladder and
records.

The sentinel (sentinel.py) CONTAINS a bad step on the device — state
stays intact, the step is a no-op. This module decides what happens NEXT
(docs/FAULT_TOLERANCE.md "Runtime anomalies" ladder):

1. **skip** — isolated anomalies (one corrupt batch, a transient numeric
   edge) cost one skipped step and nothing else;
2. **restore** — ``skip_threshold`` (K) CONSECUTIVE bad steps mean the
   run state itself is poisoned (the NaN is upstream of the update:
   diverged weights, a stuck scale) — restore the last-good commit via
   ``distributed.checkpoint.AsyncCheckpointer.restore()`` and optionally
   back the LR off (``lr_backoff``);
3. **abort** — ``max_restores`` (M) restores without a recovery means
   retrying is burning device hours on a deterministic failure: raise
   :class:`HealthAbortError` with a diagnosis instead of looping.

Every verdict is recorded as a structured :class:`AnomalyRecord`
(``monitor.records``); a restore runs under a
``torch.profiler.record_function("health")`` span.
"""

from __future__ import annotations

import enum
import sys
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional

import numpy as np
import torch

from ..flags import flag as _flag

__all__ = ["HealthAction", "AnomalyRecord", "HealthAbortError",
           "HealthMonitor"]


class HealthAction(enum.Enum):
    OK = "ok"
    SKIP = "skip"          # bad step contained on device; keep going
    RESTORE = "restore"    # K consecutive bad: roll back to last-good


class HealthAbortError(RuntimeError):
    """The escalation ladder ran out: restores did not clear the anomaly.
    Carries the monitor's diagnosis (recent records + likely causes)."""


@dataclass
class AnomalyRecord:
    step: int
    loss: float
    kind: str              # "nan" | "spike" | "restore" | "abort"
    action: HealthAction
    streak: int            # consecutive bad steps at record time
    ema: float = float("nan")
    wall_time: float = field(default_factory=time.time)

    def __str__(self):
        return (f"[health] step {self.step}: {self.kind} "
                f"(loss={self.loss:.6g}, ema={self.ema:.6g}, "
                f"streak={self.streak}) -> {self.action.value}")


class HealthMonitor:
    """Host-side escalation over sentinel verdicts.

        mon = HealthMonitor(checkpointer=ck)           # K/M from flags
        for step in range(...):
            params, opt, sent, health = gstep(params, opt, sent, *batch)
            loss, bad, _ = unpack_health(health)
            rec = mon.observe(step, loss, bad)
            if rec.action is HealthAction.RESTORE:
                step = mon.restore(state) or step      # walks last-good

    ``restore()`` enforces the M bound (raises :class:`HealthAbortError`
    past it) and accumulates :attr:`lr_scale` (``lr_backoff ** restores``)
    for the caller to apply. With no checkpointer, ``restore()`` only
    counts + resets the streak — the caller owns the rollback.
    ``restore(state)`` refills ``state``'s tensors IN PLACE
    (``AsyncCheckpointer.restore``), so the live parameters and moments
    of the in-place LLaMA step roll back without a rebind.
    """

    def __init__(self, checkpointer=None,
                 skip_threshold: Optional[int] = None,
                 max_restores: Optional[int] = None,
                 lr_backoff: Optional[float] = None,
                 spike_factor: Optional[float] = None,
                 spike_warmup: Optional[int] = None,
                 ema_alpha: float = 0.1,
                 on_anomaly: Optional[Callable[[AnomalyRecord], None]] = None,
                 verbose: bool = True,
                 max_records: int = 256):
        # the host EMA is reseeded on restore; the caller's device-side
        # `sent` dict must be rebuilt with sentinel_init() after a restore
        # too — against rolled-back weights the stale (armed) EMA would
        # flag legitimate losses as spikes (the reference's imperative
        # Sentinel, which it resets here, waits for nn.Layer)
        self.checkpointer = checkpointer
        self.skip_threshold = int(
            skip_threshold if skip_threshold is not None
            else _flag("FLAGS_health_skip_threshold", 3))
        self.max_restores = int(
            max_restores if max_restores is not None
            else _flag("FLAGS_health_max_restores", 3))
        self.lr_backoff = float(
            lr_backoff if lr_backoff is not None
            else _flag("FLAGS_health_lr_backoff", 1.0))
        self.spike_factor = (
            float(_flag("FLAGS_health_spike_factor", 0.0))
            if spike_factor is None else float(spike_factor))
        self.spike_warmup = int(
            _flag("FLAGS_health_spike_warmup", 20)
            if spike_warmup is None else spike_warmup)
        self.ema_alpha = float(ema_alpha)
        self.on_anomaly = on_anomaly
        self.verbose = verbose
        self.max_records = int(max_records)

        self.records: List[AnomalyRecord] = []
        self.streak = 0            # consecutive bad steps
        self.bad_steps = 0         # total bad steps observed
        self.good_steps = 0
        self.restores = 0
        self.lr_scale = 1.0        # product of applied backoffs
        self._ema = float("nan")

    # -- observation ---------------------------------------------------------
    def observe(self, step: int, loss: float,
                bad: Optional[bool] = None) -> AnomalyRecord:
        """Record one step's outcome; returns the record whose ``action``
        the caller dispatches on. ``bad=None`` runs the host-side check
        (the eager-path equivalent of the on-device sentinel): NaN/Inf,
        plus the EMA spike test when ``spike_factor`` is set."""
        loss = float(loss)
        kind = "nan"
        if bad is None:
            bad = not np.isfinite(loss)
            # same arming rule as the device sentinel: the spike test only
            # fires once `spike_warmup` good steps seeded the EMA (early-
            # training loss is legitimately volatile)
            if (not bad and self.spike_factor > 0
                    and np.isfinite(self._ema)
                    and self.good_steps >= max(1, self.spike_warmup)):
                if loss > self.spike_factor * max(abs(self._ema), 1e-6):
                    bad = True
                    kind = "spike"
        elif np.isfinite(loss):
            kind = "spike"
        if not bad:
            self.good_steps += 1
            self.streak = 0
            self._ema = (loss if not np.isfinite(self._ema) else
                         (1 - self.ema_alpha) * self._ema
                         + self.ema_alpha * loss)
            return AnomalyRecord(step, loss, "ok", HealthAction.OK, 0,
                                 self._ema)
        self.bad_steps += 1
        self.streak += 1
        action = (HealthAction.RESTORE if self.streak >= self.skip_threshold
                  else HealthAction.SKIP)
        rec = AnomalyRecord(step, loss, kind, action, self.streak, self._ema)
        self._emit(rec)
        return rec

    # -- escalation ----------------------------------------------------------
    def restore(self, state_dict=None) -> Optional[int]:
        """Escalate: roll back to last-good. Returns the restored step when
        a checkpointer + state_dict are given (walks back past corrupt
        checkpoints), else None (caller-owned rollback). Past
        ``max_restores`` raises :class:`HealthAbortError` instead of
        burning another round."""
        if self.restores >= self.max_restores:
            self.abort("restore limit reached")
        self.restores += 1
        self.lr_scale *= self.lr_backoff
        restored = None
        with torch.profiler.record_function("health"):
            if self.checkpointer is not None and state_dict is not None:
                restored = self.checkpointer.restore(state_dict)
                if restored is None:
                    self.abort("no committed checkpoint to restore from")
        self.streak = 0
        self._ema = float("nan")   # re-seed the spike reference after rollback
        rec = AnomalyRecord(-1 if restored is None else restored,
                            float("nan"), "restore", HealthAction.RESTORE,
                            0, float("nan"))
        self._emit(rec)
        return restored

    def abort(self, reason: str):
        raise HealthAbortError(self.diagnosis(reason))

    # -- reporting -----------------------------------------------------------
    def diagnosis(self, reason: str = "") -> str:
        recent = "\n  ".join(str(r) for r in self.records[-8:]) or "(none)"
        return (
            f"run-health abort: {reason or 'escalation exhausted'} — "
            f"{self.bad_steps} bad / {self.good_steps} good steps, "
            f"{self.restores}/{self.max_restores} restores "
            f"(skip_threshold={self.skip_threshold}, "
            f"lr_scale={self.lr_scale:.3g}).\n"
            f"Recent anomalies:\n  {recent}\n"
            f"Likely causes: persistent bad data (check the loader's "
            f"quarantine warnings), a diverged run (lower the LR, or set "
            f"FLAGS_health_lr_backoff below 1.0 — it multiplies the LR per "
            f"restore), or a numerics bug upstream of the loss "
            f"(torch.autograd.set_detect_anomaly(True) localizes the op)."
        )

    def _emit(self, rec: AnomalyRecord):
        self.records.append(rec)
        if len(self.records) > self.max_records:
            del self.records[:len(self.records) - self.max_records]
        if self.verbose:
            print(str(rec), file=sys.stderr)
        if self.on_anomaly is not None:
            self.on_anomaly(rec)

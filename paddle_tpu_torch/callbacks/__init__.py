"""``paddle.callbacks`` — counterpart of ``paddle_tpu/callbacks``
(ref: ``python/paddle/hapi/callbacks.py``): the hooks ``hapi.Model.fit``
calls, progress logging, epoch checkpoints (``keep_last_k``,
``async_save`` over ``framework.io``), early stopping and LR plateaus (a
NaN metric never counts as an improvement), the LR scheduler's stepping,
and ``AnomalyMonitor``: the ``health.HealthMonitor`` ladder over the
per-batch loss with an in-memory last-good rollback."""

from __future__ import annotations

import time
from typing import List, Optional

import numpy as np

__all__ = ["Callback", "CallbackList", "ProgBarLogger", "ModelCheckpoint",
           "EarlyStopping", "LRScheduler", "ReduceLROnPlateau",
           "AnomalyMonitor"]


class Callback:
    def __init__(self):
        self.model = None
        self.params = {}

    def set_model(self, model):
        self.model = model

    def set_params(self, params):
        self.params = params or {}

    def on_train_begin(self, logs=None):
        pass

    def on_train_end(self, logs=None):
        pass

    def on_epoch_begin(self, epoch, logs=None):
        pass

    def on_epoch_end(self, epoch, logs=None):
        pass

    def on_train_batch_begin(self, step, logs=None):
        pass

    def on_train_batch_end(self, step, logs=None):
        pass

    def on_eval_begin(self, logs=None):
        pass

    def on_eval_end(self, logs=None):
        pass


class CallbackList:
    def __init__(self, callbacks: Optional[List[Callback]] = None):
        self.callbacks = list(callbacks or [])

    def append(self, cb):
        self.callbacks.append(cb)

    def set_model(self, model):
        for c in self.callbacks:
            c.set_model(model)

    def set_params(self, params):
        for c in self.callbacks:
            c.set_params(params)

    def __getattr__(self, name):
        if name.startswith("on_"):
            def call(*args, **kwargs):
                for c in self.callbacks:
                    getattr(c, name)(*args, **kwargs)
            return call
        raise AttributeError(name)


class ProgBarLogger(Callback):
    """ref: hapi ProgBarLogger — per-epoch progress lines."""

    def __init__(self, log_freq: int = 10, verbose: int = 2):
        super().__init__()
        self.log_freq = max(1, int(log_freq))
        self.verbose = verbose

    def on_epoch_begin(self, epoch, logs=None):
        self.epoch = epoch
        self.steps = self.params.get("steps")
        self._t0 = time.time()
        if self.verbose:
            print(f"Epoch {epoch + 1}/{self.params.get('epochs', '?')}")

    def on_train_batch_end(self, step, logs=None):
        if self.verbose > 1 and step % self.log_freq == 0:
            logs = logs or {}
            parts = " - ".join(f"{k}: {v:.4f}" for k, v in logs.items()
                               if isinstance(v, (int, float)))
            print(f"step {step + 1}/{self.steps or '?'} - {parts}")

    def on_epoch_end(self, epoch, logs=None):
        if self.verbose:
            logs = logs or {}
            dt = time.time() - self._t0
            parts = " - ".join(f"{k}: {v:.4f}" for k, v in logs.items()
                               if isinstance(v, (int, float)))
            print(f"epoch {epoch + 1} done in {dt:.1f}s - {parts}")


class ModelCheckpoint(Callback):
    """Epoch checkpoints with optional async writing + retention.

    ``async_save=True`` routes the save through the shared background
    checkpoint writer (framework.io.async_save) so the next epoch's compute
    overlaps the disk write; ``on_train_end`` drains pending writes.
    ``keep_last_k`` prunes older epoch checkpoints (the newest K and the
    ``final`` save are kept — docs/FAULT_TOLERANCE.md retention policy)."""

    def __init__(self, save_freq: int = 1, save_dir: Optional[str] = None,
                 keep_last_k: Optional[int] = None, async_save: bool = False):
        super().__init__()
        self.save_freq = int(save_freq)
        self.save_dir = save_dir
        self.keep_last_k = keep_last_k if keep_last_k is None \
            else max(1, int(keep_last_k))
        self.async_save = bool(async_save)

    def on_epoch_end(self, epoch, logs=None):
        if self.save_dir and self.model is not None and \
                (epoch + 1) % self.save_freq == 0:
            self.model.save(f"{self.save_dir}/{epoch}",
                            async_save=self.async_save)
            if self.keep_last_k is not None:
                if self.async_save:
                    # ride the writer queue BEHIND the save jobs (queue
                    # order guarantees the new files landed) — draining
                    # here would serialize the save and defeat the overlap
                    from ..framework.async_writer import default_writer
                    default_writer().submit(self._prune, label="ckpt-prune")
                else:
                    self._prune()

    def on_train_end(self, logs=None):
        if self.save_dir and self.model is not None:
            if self.async_save:
                from ..framework import io as fio
                fio.wait_save()   # drain epoch saves before the final one
            self.model.save(f"{self.save_dir}/final")

    def _prune(self):
        """Runs inline (sync mode) or ON the writer thread behind the save
        jobs (async mode) — either way every finished save is on disk and
        none is mid-write when we enumerate/unlink."""
        import os
        import re
        keep = set()
        epochs = []
        try:
            names = os.listdir(self.save_dir)
        except OSError:
            return
        for n in names:
            m = re.match(r"^(\d+)\.pdparams$", n)
            if m:
                epochs.append(int(m.group(1)))
        for e in sorted(epochs)[-self.keep_last_k:]:
            keep.add(e)
        for e in epochs:
            if e in keep:
                continue
            for suffix in (".pdparams", ".pdopt"):
                try:
                    os.remove(os.path.join(self.save_dir, f"{e}{suffix}"))
                except OSError:
                    pass


class EarlyStopping(Callback):
    """ref: hapi EarlyStopping — monitor an eval metric, stop on plateau."""

    def __init__(self, monitor: str = "loss", mode: str = "auto",
                 patience: int = 0, verbose: int = 1, min_delta: float = 0,
                 baseline=None, save_best_model: bool = True):
        super().__init__()
        self.monitor = monitor
        self.patience = int(patience)
        self.verbose = verbose
        self.min_delta = abs(float(min_delta))
        self.baseline = baseline
        if mode == "auto":
            mode = "max" if "acc" in monitor else "min"
        self.mode = mode
        self.wait = 0
        self.best = None

    def _better(self, cur, ref):
        if self.mode == "min":
            return cur < ref - self.min_delta
        return cur > ref + self.min_delta

    def on_epoch_end(self, epoch, logs=None):
        logs = logs or {}
        # explicit None check: `or` would misroute a metric of exactly 0.0
        # (falsy) to the eval_ fallback
        cur = logs.get(self.monitor)
        if cur is None:
            cur = logs.get(f"eval_{self.monitor}")
        if cur is None:
            return
        cur = float(cur)
        ref = self.best if self.best is not None else self.baseline
        # A NaN metric is NEVER an improvement: NaN comparisons are all
        # False, so an unguarded `ref is None` (first epoch) would adopt
        # NaN as `best` — which then can never be beaten — while a NaN
        # `cur` against a finite ref silently counts as a plateau epoch
        # with no hint the run diverged. Count it as no-improvement
        # explicitly so patience runs out on a NaN'd run.
        if not np.isnan(cur) and (ref is None or self._better(cur, ref)):
            self.best = cur
            self.wait = 0
            return
        self.wait += 1
        if self.wait >= self.patience and self.model is not None:
            self.model.stop_training = True
            if self.verbose:
                print(f"EarlyStopping: no {self.monitor} improvement for "
                      f"{self.wait} epochs; stopping")


class AnomalyMonitor(Callback):
    """hapi surface of the run-health subsystem (paddle_tpu_torch.health).

    Watches the per-batch loss through the HealthMonitor escalation
    ladder: isolated bad steps are logged;
    ``skip_threshold`` consecutive bad steps roll the model + optimizer
    back to the last-good snapshot (in-memory host copy, refreshed every
    ``snapshot_freq`` good batches) with an optional LR backoff;
    ``max_restores`` exhausted raises :class:`health.HealthAbortError`
    with a diagnosis instead of finishing a diverged fit.

    Thresholds default to the ``FLAGS_health_*`` flags. For sharded /
    large models pass an ``AsyncCheckpointer``-backed HealthMonitor to the
    train loop directly instead of the in-memory snapshot.

    Cost note: a snapshot is a full device->host copy of the model +
    optimizer state, so ``snapshot_freq`` trades rollback staleness
    against per-step overhead — the default refreshes every 25 good
    batches (a rollback then replays at most 25 steps); set it to 1 only
    for small models.
    """

    def __init__(self, skip_threshold=None, max_restores=None,
                 lr_backoff=None, spike_factor=None, snapshot_freq: int = 25,
                 verbose: int = 1):
        super().__init__()
        self._kw = dict(skip_threshold=skip_threshold,
                        max_restores=max_restores, lr_backoff=lr_backoff,
                        spike_factor=spike_factor)
        self.snapshot_freq = max(1, int(snapshot_freq))
        self.verbose = verbose
        self.monitor = None
        self._snap = None
        self._pending = None
        self._base_lr = None
        self._good_since_snap = 0

    # -- snapshot / rollback -------------------------------------------------
    def _state_pair(self):
        net = self.model.network
        opt = getattr(self.model, "_optimizer", None)
        return net, opt

    def _capture(self):
        net, opt = self._state_pair()

        def host_copy(sd):
            out = {}
            for k, v in sd.items():
                out[k] = (np.array(v.numpy(), copy=True)
                          if hasattr(v, "numpy") else v)
            return out

        return {
            "net": host_copy(net.state_dict()),
            "opt": (host_copy(opt.state_dict())
                    if opt is not None and hasattr(opt, "state_dict")
                    else None),
        }

    def _rollback(self):
        net, opt = self._state_pair()
        net.set_state_dict(self._snap["net"])
        if self._snap["opt"] is not None:
            opt.set_state_dict(self._snap["opt"])
        if (self._base_lr is not None and self.monitor.lr_backoff != 1.0
                and hasattr(opt, "set_lr")):
            # backoff from the PRE-training base LR: monitor.lr_scale is
            # already cumulative (backoff ** restores) — multiplying a
            # snapshot LR that itself carries earlier backoffs would
            # compound quadratically
            try:
                opt.set_lr(self._base_lr * self.monitor.lr_scale)
            except RuntimeError:
                # an LRScheduler owns the LR (set_lr refuses); a crash
                # here would abort the fit mid-recovery — roll back
                # without the backoff and say so once
                if not getattr(self, "_warned_sched_lr", False):
                    self._warned_sched_lr = True
                    import warnings
                    warnings.warn(
                        "AnomalyMonitor: lr_backoff has no effect when the "
                        "optimizer uses an LRScheduler (the scheduler owns "
                        "the LR); rolling back without it")

    # -- callback hooks ------------------------------------------------------
    def on_train_begin(self, logs=None):
        from ..health import HealthMonitor
        self.monitor = HealthMonitor(verbose=bool(self.verbose), **self._kw)
        opt = getattr(self.model, "_optimizer", None)
        self._base_lr = (opt.get_lr() if opt is not None
                         and hasattr(opt, "get_lr") else None)
        # seed the last-good snapshot from the PRE-training state: this
        # hook runs before any update, so even a run whose very first
        # batch diverges rolls back to sane (initial) weights — seeding
        # lazily from a post-update batch could capture poisoned state
        self._snap = self._capture()
        self._pending = None
        self._good_since_snap = 0

    def on_train_batch_begin(self, step, logs=None):
        # CERTIFIED snapshots only: batch N's loss is computed before
        # update N, so a finite loss certifies the state at batch BEGIN,
        # not the post-update state — capture the candidate here and
        # promote it once this batch's loss comes back good (a snapshot
        # taken after an exploding update would itself be poisoned)
        if self.monitor is None:
            return
        if self._good_since_snap >= self.snapshot_freq:
            self._pending = self._capture()

    def on_train_batch_end(self, step, logs=None):
        from ..health import HealthAction
        logs = logs or {}
        loss = logs.get("loss")
        if loss is None:
            return
        rec = self.monitor.observe(step, float(loss))
        if rec.action is HealthAction.OK:
            if self._pending is not None:
                self._snap = self._pending
                self._pending = None
                self._good_since_snap = 0
            else:
                self._good_since_snap += 1
            return
        self._pending = None   # uncertified candidate: discard
        if rec.action is HealthAction.RESTORE:
            from ..health import HealthAbortError
            try:
                self.monitor.restore()   # raises past max_restores
            except HealthAbortError:
                # terminal — but leave the model on last-good weights,
                # not the poisoned ones, so it can be inspected/saved
                self._rollback()
                raise
            self._rollback()
            self._good_since_snap = 0
            if self.verbose:
                print(f"AnomalyMonitor: rolled back to last-good snapshot "
                      f"(restore {self.monitor.restores}/"
                      f"{self.monitor.max_restores}, "
                      f"lr_scale={self.monitor.lr_scale:.3g})")


class LRScheduler(Callback):
    """Steps the optimizer's LRScheduler per epoch/step (ref parity)."""

    def __init__(self, by_step: bool = False, by_epoch: bool = True):
        super().__init__()
        self.by_step = by_step
        self.by_epoch = by_epoch

    def _sched(self):
        opt = getattr(self.model, "_optimizer", None)
        lr = getattr(opt, "_lr", None)
        from ..optimizer.lr import LRScheduler as Sched
        return lr if isinstance(lr, Sched) else None

    def on_epoch_end(self, epoch, logs=None):
        s = self._sched()
        if self.by_epoch and s is not None:
            s.step()

    def on_train_batch_end(self, step, logs=None):
        s = self._sched()
        if self.by_step and s is not None:
            s.step()


class ReduceLROnPlateau(Callback):
    def __init__(self, monitor: str = "loss", factor: float = 0.1,
                 patience: int = 10, verbose: int = 1, mode: str = "auto",
                 min_delta: float = 1e-4, cooldown: int = 0, min_lr: float = 0):
        super().__init__()
        self.monitor = monitor
        self.factor = factor
        self.patience = patience
        self.verbose = verbose
        self.mode = "max" if (mode == "auto" and "acc" in monitor) else \
            ("min" if mode == "auto" else mode)
        self.min_delta = min_delta
        self.cooldown = cooldown
        self.min_lr = min_lr
        self.best = None
        self.wait = 0
        self.cooldown_counter = 0

    def on_epoch_end(self, epoch, logs=None):
        logs = logs or {}
        cur = logs.get(self.monitor)
        if cur is None:   # not `or`: a metric of exactly 0.0 is falsy
            cur = logs.get(f"eval_{self.monitor}")
        if cur is None:
            return
        cur = float(cur)
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.wait = 0
        # same NaN audit as EarlyStopping: a NaN metric must count as "no
        # improvement" (and never become `best`), not slip through the
        # first-epoch `best is None` arm
        better = not np.isnan(cur) and (
            self.best is None or
            (cur < self.best - self.min_delta if self.mode == "min"
             else cur > self.best + self.min_delta))
        if better:
            self.best = cur
            self.wait = 0
            return
        self.wait += 1
        if self.wait >= self.patience:
            opt = getattr(self.model, "_optimizer", None)
            if opt is not None and not hasattr(opt._lr, "step"):
                new_lr = max(float(opt._lr) * self.factor, self.min_lr)
                opt.set_lr(new_lr)
                if self.verbose:
                    print(f"ReduceLROnPlateau: lr -> {new_lr:.2e}")
            self.cooldown_counter = self.cooldown
            self.wait = 0

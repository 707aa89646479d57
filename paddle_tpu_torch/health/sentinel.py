"""On-device NaN/Inf/loss-spike detection for the train step —
counterpart of ``paddle_tpu/health/sentinel.py``.

A bad step (a NaN loss from an overflowed reduction, a corrupt sample)
is detected ON THE DEVICE and its update skipped, with no host sync in
the step: :func:`sentinel_check` returns the verdict as a 0-d bool
tensor that ``models.llama._adamw_apply(skip=...)`` gates the update
with, and the host reads loss and verdict later from ONE packed ``[loss,
bad, ema]`` vector (:func:`pack_health` / :func:`unpack_health`).

Two spellings, one core:

* ``models.llama.make_train_step(sentinel=True)`` gates the in-place
  LLaMA step's update inside ``_adamw_apply(skip=bad)``;
* :func:`guard_step` wraps a PURE step ``(params, opt, *batch) ->
  (params, opt, loss)`` that returns new tensors into ``(params, opt,
  sent, *batch) -> (params, opt, sent, health)``, selecting the old
  values on a bad step with :func:`tree_where`. It cannot guard the
  in-place LLaMA step: that step has already overwritten the old values
  by the time the verdict exists, so it takes ``sentinel=True`` instead.

* the imperative :class:`Sentinel` guards an ``nn.Layer`` and its
  optimizer in the fused ``jit.TrainStep(sentinel=...)``: it copies
  :func:`health_state_tensors` before the step and gates them with
  ``torch.where`` after it. The reference keeps its snapshot by reference
  (JAX arrays are immutable); the port's optimizers write parameters in
  place, so the port's snapshot copies.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..device import resolve_device
from ..flags import flag as _flag

__all__ = ["sentinel_init", "sentinel_check", "tree_where", "guard_step",
           "pack_health", "unpack_health", "health_state_tensors",
           "Sentinel"]


def sentinel_init(device=None) -> Dict[str, torch.Tensor]:
    """Fresh sentinel state on ``device``: the loss EMA (fp32) and the
    good-step count (int32), both 0-d."""
    dev = resolve_device(device)
    return {"ema": torch.zeros((), dtype=torch.float32, device=dev),
            "count": torch.zeros((), dtype=torch.int32, device=dev)}


def sentinel_check(loss, sent: Dict, *, spike_factor: Optional[float] = None,
                   warmup: Optional[int] = None, ema_alpha: float = 0.1):
    """The verdict ``(bad, new_sent)``, on the device, with no host sync.

    ``bad`` is a 0-d bool tensor: the loss is NaN/Inf, or (once ``warmup``
    good steps seeded the EMA and ``spike_factor > 0``) the loss exceeds
    ``spike_factor * max(|ema|, 1e-6)``. A multi-element loss is judged
    by its sum. The EMA is seeded by the first good loss and, like the
    count, advances only on good steps. ``spike_factor`` / ``warmup``
    default to ``FLAGS_health_spike_factor`` / ``_warmup``."""
    if spike_factor is None:
        spike_factor = float(_flag("FLAGS_health_spike_factor"))
    if warmup is None:
        warmup = int(_flag("FLAGS_health_spike_warmup"))
    ema, count = sent["ema"], sent["count"]
    l32 = torch.as_tensor(loss, device=ema.device).detach().to(torch.float32)
    if l32.dim():
        l32 = l32.sum()
    bad = ~torch.isfinite(l32)
    if spike_factor and spike_factor > 0:
        seeded = count >= max(1, int(warmup))
        bad = bad | (seeded & (l32 > spike_factor
                               * torch.clamp(ema.abs(), min=1e-6)))
    good = ~bad
    new_ema = torch.where(
        good, torch.where(count == 0, l32,
                          (1.0 - ema_alpha) * ema + ema_alpha * l32), ema)
    return bad, {"ema": new_ema, "count": count + good.to(torch.int32)}


def tree_where(bad, old_tree, new_tree):
    """Per-leaf ``torch.where(bad, old, new)`` over nested dicts, lists and
    tuples of tensors — the gated update of a pure step. ``bad`` is a 0-d
    bool tensor; nothing syncs with the host."""
    if isinstance(old_tree, dict):
        return {k: tree_where(bad, old_tree[k], new_tree[k])
                for k in old_tree}
    if isinstance(old_tree, (list, tuple)):
        return type(old_tree)(tree_where(bad, o, n)
                              for o, n in zip(old_tree, new_tree))
    return torch.where(bad, old_tree, new_tree)


def guard_step(step_fn, *, spike_factor: Optional[float] = None,
               warmup: Optional[int] = None, ema_alpha: float = 0.1):
    """Wrap a PURE train step with the sentinel::

        gstep = guard_step(step)           # step(params, opt, *batch)
        sent = sentinel_init(device)       #   -> (params, opt, loss)
        params, opt, sent, health = gstep(params, opt, sent, *batch)
        loss, bad, ema = unpack_health(health)

    A bad step returns the INPUT params / opt state unchanged (a per-leaf
    select); the sentinel state still records the verdict. ``step_fn``
    must leave its inputs intact — the in-place LLaMA step takes
    ``make_train_step(sentinel=True)`` instead."""
    def guarded(params, opt_state, sent, *batch):
        new_p, new_o, loss = step_fn(params, opt_state, *batch)
        bad, new_sent = sentinel_check(loss, sent, spike_factor=spike_factor,
                                       warmup=warmup, ema_alpha=ema_alpha)
        return (tree_where(bad, params, new_p),
                tree_where(bad, opt_state, new_o), new_sent,
                pack_health(loss, bad, new_sent))

    return guarded


def pack_health(loss, bad, sent) -> torch.Tensor:
    """``[loss, bad, ema]`` as one fp32 ``[3]`` tensor: the host reads loss
    and verdict with one device-to-host copy."""
    ema = sent["ema"]
    l32 = torch.as_tensor(loss, device=ema.device).detach().to(torch.float32)
    if l32.dim():
        l32 = l32.sum()
    return torch.stack([l32, bad.to(torch.float32), ema])


def unpack_health(health) -> Tuple[float, bool, float]:
    """Host side of :func:`pack_health`: ``(loss, bad, ema)`` from one
    device-to-host read."""
    h = health.detach().cpu().tolist()
    return float(h[0]), bool(h[1] > 0.5), float(h[2])


def health_state_tensors(model=None, optimizer=None) -> List:
    """The mutable-state tensor set a skipped step must leave intact:
    parameters, BN running stats (buffers), optimizer accumulators and
    fp32 master weights. Collected fresh per step — lazily-created
    accumulators (first eager warmup call) join on the next call."""
    out, seen = [], set()

    def add(t):
        if t is not None and id(t) not in seen:
            seen.add(id(t))
            out.append(t)

    if model is not None:
        for p in model.parameters():
            add(p)
        if hasattr(model, "buffers"):
            for b in model.buffers():
                add(b)
    if optimizer is not None:
        for store in getattr(optimizer, "_accumulators", {}).values():
            for t in store.values():
                add(t)
        for t in getattr(optimizer, "_master_weights", {}).values():
            add(t)
    return out


class Sentinel:
    """Imperative/fused-path sentinel (``jit.train_step.TrainStep``).

    Holds its device state (EMA, count, last health vector) as framework
    Tensors, so a captured step carries them as program state; after the
    step runs, the host reads the verdict from them with no extra sync
    inside the step.

    Usage inside a step function (captured or eager)::

        snap = sentinel.snapshot(health_state_tensors(model, opt))
        ... forward / backward / optimizer.step() ...
        sentinel.gate(snap, loss)     # torch.where-gated rollback on bad

    Host side, after the step ran: :attr:`last_bad`, :attr:`last_loss`,
    :meth:`last_record`.
    """

    def __init__(self, spike_factor: Optional[float] = None,
                 warmup: Optional[int] = None, ema_alpha: float = 0.1):
        from ..core.place import torch_device
        from ..core.tensor import _wrap
        dev = torch_device()
        self.spike_factor = spike_factor
        self.warmup = warmup
        self.ema_alpha = ema_alpha
        # made here, not lazily inside a capture, so the capture sees them
        # as pre-existing state
        self._ema = _wrap(torch.zeros((), dtype=torch.float32, device=dev))
        self._count = _wrap(torch.zeros((), dtype=torch.int32, device=dev))
        self._health = _wrap(torch.zeros((3,), dtype=torch.float32,
                                         device=dev))
        self.steps = 0            # host-side call count (records only)

    # -- in-step (capture-safe) ---------------------------------------------
    def snapshot(self, tensors: Sequence) -> List[Tuple]:
        """``(tensor, copy of its value)`` pairs, taken BEFORE the
        mutating update: the optimizers write parameters in place, so a
        reference to the value would roll nothing back."""
        with torch.no_grad():
            return [(t, t._value.detach().clone()) for t in tensors]

    def gate(self, snapshot: Sequence[Tuple], loss,
             post_tensors: Optional[Sequence] = None):
        """Verdict + gated rollback, on the device; returns the 0-d bool
        ``bad``.

        ``post_tensors``: the state tensor set AFTER the update. Tensors in
        it that the snapshot never saw were CREATED during this step
        (lazily-built optimizer accumulators / master weights on the very
        first call) — they roll back to their unborn state: the creation
        fill the optimizer stamped on them (``_acc_init``), or the
        rolled-back source parameter for master weights (``_master_of``).
        Every tensor is written in place, so a parameter stays its leaf."""
        lv = loss._value if hasattr(loss, "_value") else loss
        lv = lv.detach()
        sent = {"ema": self._ema._value, "count": self._count._value}
        bad, new_sent = sentinel_check(
            lv, sent, spike_factor=self.spike_factor, warmup=self.warmup,
            ema_alpha=self.ema_alpha)
        self._ema._value = new_sent["ema"]
        self._count._value = new_sent["count"]
        self._health._value = pack_health(lv, bad, new_sent)
        seen = set()
        with torch.no_grad():
            for t, old in snapshot:
                seen.add(id(t))
                v = t._value
                v.copy_(torch.where(bad, old, v))
                t._version += 1
            for t in (post_tensors or ()):
                if id(t) in seen:
                    continue
                v = t._value
                src = getattr(t, "_master_of", None)
                if src is not None:   # after params gated: src rolled back
                    unborn = src._value.to(v.dtype)
                else:
                    unborn = torch.full_like(
                        v, float(getattr(t, "_acc_init", 0.0)))
                v.copy_(torch.where(bad, unborn, v))
                t._version += 1
        return bad

    # -- host side -----------------------------------------------------------
    @property
    def last_loss(self) -> float:
        return self.last_record()[0]

    @property
    def last_bad(self) -> bool:
        return self.last_record()[1]

    @property
    def ema(self) -> float:
        return float(self._ema._value)

    def last_record(self):
        """The last step's verdict as ``(loss, bad, ema)`` — one host read
        of the packed health vector."""
        return unpack_health(self._health._value)

    def reset(self):
        # rebind VALUES (not tensors): captured programs hold the tensor
        # identities as state, and copy a rebound value in
        self._ema._value = torch.zeros_like(self._ema._value)
        self._count._value = torch.zeros_like(self._count._value)
        self._health._value = torch.zeros_like(self._health._value)

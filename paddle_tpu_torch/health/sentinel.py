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

Ported: ``sentinel_init``, ``sentinel_check``, ``pack_health``,
``unpack_health``, ``tree_where`` and ``guard_step``. The imperative
``Sentinel`` and ``health_state_tensors`` work on ``nn.Layer`` and
optimizer accumulators, which the port does not have yet (ROADMAP item
11).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..device import resolve_device
from ..flags import flag as _flag

__all__ = ["sentinel_init", "sentinel_check", "tree_where", "guard_step",
           "pack_health", "unpack_health"]


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

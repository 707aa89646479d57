"""On-device NaN/Inf/loss-spike detection for the train step —
counterpart of ``paddle_tpu/health/sentinel.py``.

A bad step (a NaN loss from an overflowed reduction, a corrupt sample)
is detected ON THE DEVICE and its update skipped, with no host sync in
the step: :func:`sentinel_check` returns the verdict as a 0-d bool
tensor that ``models.llama._adamw_apply(skip=...)`` gates the update
with, and the host reads loss and verdict later from ONE packed ``[loss,
bad, ema]`` vector (:func:`pack_health` / :func:`unpack_health`).

Ported: the core four functions. The generic output-side wrapper
(``guard_step``, ``tree_where``), the imperative ``Sentinel`` and
``health_state_tensors`` belong to the JAX package's ``jit/train_step``
surface and wait for it.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..device import resolve_device
from ..flags import flag as _flag

__all__ = ["sentinel_init", "sentinel_check", "pack_health",
           "unpack_health"]


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

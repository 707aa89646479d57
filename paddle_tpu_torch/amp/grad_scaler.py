"""GradScaler (dynamic loss scaling) — counterpart of
``paddle_tpu/amp/grad_scaler.py`` (ref: ``python/paddle/amp/grad_scaler.py``:
scale the loss, unscale the gradients before the step, skip the step on
inf/nan, grow or shrink the scale).

``unscale_`` keeps the finiteness checks on the device: one
``isfinite().all()`` a gradient, stacked and reduced, and ONE read of
the verdict by the host a call, not one a parameter.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..core.tensor import Tensor

__all__ = ["GradScaler", "AmpScaler"]


class GradScaler:
    def __init__(self, enable: bool = True, init_loss_scaling: float = 2.0 ** 16,
                 incr_ratio: float = 2.0, decr_ratio: float = 0.5,
                 incr_every_n_steps: int = 2000,
                 decr_every_n_nan_or_inf: int = 1,
                 use_dynamic_loss_scaling: bool = True):
        self._enable = bool(enable)
        self._scale = float(init_loss_scaling)
        self._incr_ratio = float(incr_ratio)
        self._decr_ratio = float(decr_ratio)
        self._incr_every_n_steps = int(incr_every_n_steps)
        self._decr_every_n_nan_or_inf = int(decr_every_n_nan_or_inf)
        self._use_dynamic = bool(use_dynamic_loss_scaling)
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False
        self._unscaled = False

    # -- API ----------------------------------------------------------------
    def is_enable(self) -> bool:
        return self._enable

    def is_use_dynamic_loss_scaling(self) -> bool:
        return self._use_dynamic

    def scale(self, var: Tensor) -> Tensor:
        """loss * scale (identity when disabled)."""
        if not self._enable:
            return var
        return var * self._scale

    @torch.no_grad()
    def unscale_(self, optimizer):
        """Divide every gradient by the scale (in fp32, stored back in the
        gradient's dtype) and record whether any was not finite."""
        if not self._enable or self._unscaled:
            return
        inv = 1.0 / self._scale
        finite = []
        for p in optimizer._params():
            g = p._value.grad
            if g is None:
                continue
            g32 = g.to(torch.float32) * inv
            finite.append(torch.isfinite(g32).all())
            p._value.grad = g32.to(g.dtype)
        self._found_inf = bool(finite) and not bool(
            torch.stack(finite).all())          # the one read by the host
        self._unscaled = True

    def step(self, optimizer):
        """unscale (if not already) and run the optimizer step unless a
        gradient was not finite."""
        if not self._enable:
            optimizer.step()
            return
        self.unscale_(optimizer)
        if not self._found_inf:
            optimizer.step()

    def update(self):
        """Adjust the loss scale from the last step's found_inf."""
        if not self._enable or not self._use_dynamic:
            self._unscaled = False
            return
        if self._found_inf:
            self._bad_steps += 1
            self._good_steps = 0
            if self._bad_steps >= self._decr_every_n_nan_or_inf:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad_steps = 0
        else:
            self._good_steps += 1
            self._bad_steps = 0
            if self._good_steps >= self._incr_every_n_steps:
                self._scale *= self._incr_ratio
                self._good_steps = 0
        self._found_inf = False
        self._unscaled = False

    def minimize(self, optimizer, scaled_loss):
        """ref: scaler.minimize — backward already ran on the scaled loss."""
        self.step(optimizer)
        self.update()

    # -- scale accessors (reference names) -----------------------------------
    def get_init_loss_scaling(self):  # the reference returns the current scale
        return self._scale

    def set_init_loss_scaling(self, v: float):
        self._scale = float(v)

    def get_incr_ratio(self):
        return self._incr_ratio

    def set_incr_ratio(self, v: float):
        if v <= 1.0:
            raise ValueError("incr_ratio must be > 1")
        self._incr_ratio = float(v)

    def get_decr_ratio(self):
        return self._decr_ratio

    def set_decr_ratio(self, v: float):
        if not 0.0 < v < 1.0:
            raise ValueError("decr_ratio must be in (0, 1)")
        self._decr_ratio = float(v)

    def get_incr_every_n_steps(self):
        return self._incr_every_n_steps

    def set_incr_every_n_steps(self, v: int):
        self._incr_every_n_steps = int(v)

    def get_decr_every_n_nan_or_inf(self):
        return self._decr_every_n_nan_or_inf

    def set_decr_every_n_nan_or_inf(self, v: int):
        self._decr_every_n_nan_or_inf = int(v)

    def state_dict(self) -> Dict:
        return {"scale": np.float32(self._scale),
                "incr_ratio": self._incr_ratio,
                "decr_ratio": self._decr_ratio,
                "incr_every_n_steps": self._incr_every_n_steps,
                "decr_every_n_nan_or_inf": self._decr_every_n_nan_or_inf,
                "good_steps": self._good_steps,
                "bad_steps": self._bad_steps,
                "use_dynamic_loss_scaling": self._use_dynamic}

    def load_state_dict(self, state: Dict):
        self._scale = float(state["scale"])
        self._incr_ratio = float(state["incr_ratio"])
        self._decr_ratio = float(state["decr_ratio"])
        self._incr_every_n_steps = int(state["incr_every_n_steps"])
        self._decr_every_n_nan_or_inf = int(state["decr_every_n_nan_or_inf"])
        self._good_steps = int(state.get("good_steps", 0))
        self._bad_steps = int(state.get("bad_steps", 0))
        self._use_dynamic = bool(state.get("use_dynamic_loss_scaling", True))


AmpScaler = GradScaler  # legacy alias

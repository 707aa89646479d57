"""incubate.optimizer — counterpart of ``paddle_tpu/incubate/optimizer.py``
(Paddle's ``incubate/optimizer/lookahead.py`` and ``modelaverage.py``):
wrappers that keep slow or averaged copies of the parameters.

The copies live on the parameters' device and every update is device
work: a step reads nothing back to the host (the reference keeps host
numpy copies). ``ModelAverage`` keeps its sums in float32 whatever the
parameters' dtype. Both carry the reference's repaired contracts:
``LookAhead`` anchors its slow weights lazily on the first ``step()`` and
again after a ``set_state_dict`` without a slow entry; ``ModelAverage``
rotates its window and folds the previous window's pair into ``apply()``.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from ..core.tensor import _wrap, as_torch

__all__ = ["LookAhead", "ModelAverage"]


def _write(p, value: torch.Tensor):
    """``value`` into parameter ``p`` in place, on its device."""
    with torch.no_grad():
        p._value.copy_(value)
    p._version += 1


class LookAhead:
    """k-step lookahead (ref: incubate.optimizer.LookAhead): every ``k``
    inner steps the slow weights move ``alpha`` of the way toward the fast
    weights, and the fast weights are reset to them."""

    def __init__(self, inner_optimizer, alpha: float = 0.5, k: int = 5):
        self.inner = inner_optimizer
        self.alpha = float(alpha)
        self.k = int(k)
        self._step_count = 0
        # anchored on the first step(): a checkpoint loaded into the
        # parameters after construction must not be pulled back toward
        # the values they had then
        self._slow: Optional[List[torch.Tensor]] = None

    def _params(self) -> List:
        return self.inner._params()

    def step(self):
        params = self._params()
        if self._slow is None:
            self._slow = [p._value.detach().clone() for p in params]
        self.inner.step()
        self._step_count += 1
        if self._step_count % self.k:
            return
        with torch.no_grad():
            for slow, p in zip(self._slow, params):
                slow.add_(p._value - slow, alpha=self.alpha)
                _write(p, slow)

    def clear_grad(self):
        self.inner.clear_grad()

    def minimize(self, loss, **kw):
        loss.backward()
        self.step()
        return None, []

    def state_dict(self) -> Dict:
        # slow copies keyed by parameter order; {} before the first step
        return {"inner": self.inner.state_dict(),
                "slow": {str(i): _wrap(v.clone())
                         for i, v in enumerate(self._slow or [])},
                "step_count": self._step_count}

    def set_state_dict(self, state: Dict):
        if "inner" in state and hasattr(self.inner, "set_state_dict"):
            self.inner.set_state_dict(state["inner"])
        slow = state.get("slow", {})
        params = self._params()
        # no saved slow entry: anchor again on the next step()
        self._slow = [as_torch(slow[str(i)]).to(
            device=p._value.device, dtype=p._value.dtype).clone()
            for i, p in zip(range(len(slow)), params)] or None
        self._step_count = int(state.get("step_count", 0))


class ModelAverage:
    """The running average of the parameters for evaluation (ref:
    incubate.optimizer.ModelAverage): sums over a sliding window;
    ``apply()`` swaps the averages in, ``restore()`` swaps the parameters
    back, bit for bit."""

    def __init__(self, average_window_rate: float, parameters=None,
                 min_average_window: int = 10000,
                 max_average_window: int = 10000):
        self.rate = float(average_window_rate)
        self.params = list(parameters or [])
        self.min_window = int(min_average_window)
        self.max_window = int(max_average_window)
        self._sum: Dict[int, torch.Tensor] = {}
        self._num = 0
        # the previous window's completed (sum, count): apply() folds it
        # in, so right after a rotation the average covers about two
        # windows, never one sample
        self._old_sum: Dict[int, torch.Tensor] = {}
        self._old_num = 0
        self._total = 0
        self._backup: Dict[int, torch.Tensor] = {}

    def step(self):
        self._num += 1
        self._total += 1
        with torch.no_grad():
            for p in self.params:
                v = p._value.detach().to(torch.float32)
                acc = self._sum.get(id(p))
                if acc is None:
                    self._sum[id(p)] = v.clone()
                else:
                    acc.add_(v)
        # the window is rate * updates, clamped to [min, max]; past it the
        # finished window becomes the old pair and an empty one starts
        window = int(min(self.max_window,
                         max(self.min_window, self.rate * self._total)))
        if self._num > window:
            self._old_sum, self._old_num = self._sum, self._num
            self._sum, self._num = {}, 0

    def apply(self, executor=None, need_restore: bool = True):
        if not self._num and not self._old_num:
            return
        with torch.no_grad():
            for p in self.params:
                s, n = self._sum.get(id(p)), self._num
                old = self._old_sum.get(id(p))
                if old is not None and self._old_num:
                    s = old if s is None else s + old
                    n += self._old_num
                if s is None:
                    continue
                if need_restore:
                    self._backup[id(p)] = p._value.detach().clone()
                _write(p, (s / n).to(p._value.dtype))

    def restore(self, executor=None):
        for p in self.params:
            b = self._backup.pop(id(p), None)
            if b is not None:
                _write(p, b)

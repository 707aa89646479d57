"""The fused train step — counterpart of ``paddle_tpu/jit/train_step.py``.

Parity target: the reference's fused training executors (forward,
backward and the optimizer update as one Program run end to end) and
its ``paddle.incubate`` fused optimizer paths. The reference
functionalizes ``loss.backward(); opt.step()`` onto one ``jax.jit``
program with the state donated; the port captures the same step into one
CUDA graph (``trace.py``): the host launches one graph a step and does
no per-op Python dispatch. ``donate`` is the counterpart of XLA's
donation: the graph writes each rebound state value (Adam's moments, the
master weights, BatchNorm's statistics) into the very buffer the next
replay reads as soon as it is computed, so no second copy of the state
is live; without it the copies happen at the end of the step. It never
changes numerics.

Donation is on by default on CUDA and off on the CPU
(:func:`donation_supported`), as the reference's is off off-TPU.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Callable, Optional, Sequence

import torch

from ..core.tensor import Tensor, _wrap, to_tensor
from .api import StaticFunction, fallbacks
from .trace import flatten

__all__ = ["TrainStep", "make_train_step", "jit_step", "donation_supported"]


def donation_supported(backend: Optional[str] = None) -> bool:
    """True where the graph writes the state back into its own buffers as
    it goes (CUDA); the CPU's recorded program copies at the end of the
    step. ``backend`` defaults to the current place's device type."""
    if backend is None:
        from ..core.place import torch_device
        backend = torch_device().type
    return backend not in ("cpu",)


def jit_step(fn: Callable, donate_argnums: Sequence[int] = (),
             static_argnums: Sequence[int] = (), annotation: str = "step"):
    """A captured program of a pure function of torch tensors (nested in
    tuples, lists and dicts), with the perf-layer contract:

    * ``donate_argnums`` is kept only where :func:`donation_supported`
      (the argument's buffers are the program's own: the function must
      return its results, not write its arguments in place);
    * each call runs under ``profiler.annotate(annotation)`` (no-op
      unless ``FLAGS_profile_annotations``).

    Non-tensor arguments (``static_argnums`` among them) key the program
    cache. The program is available as ``wrapped._jitted``."""
    donate = tuple(donate_argnums) if donation_supported() else ()

    def tensors_in(x):
        return _wrap(x) if isinstance(x, torch.Tensor) else x

    def tensors_out(x):
        return x._value if isinstance(x, Tensor) else x

    def pure(*args, **kwargs):
        args, kwargs = _map((args, kwargs), tensors_out)
        return _map(fn(*args, **kwargs), tensors_in)

    sf = StaticFunction(pure, donate_states=bool(donate))

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        from ..profiler import annotate
        args, kwargs = _map((args, kwargs), tensors_in)
        with annotate(annotation):
            return _map(sf(*args, **kwargs), tensors_out)

    wrapped._jitted = sf
    wrapped._donate_argnums = donate
    return wrapped


def _map(tree, f):
    import torch.utils._pytree as pytree
    leaves, spec = flatten(tree)
    return pytree.tree_unflatten([f(l) for l in leaves], spec)


def _as_list(x):
    if x is None:
        return []
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _sum_losses(loss):
    if isinstance(loss, (list, tuple)):
        total = loss[0]
        for l in loss[1:]:
            total = total + l
        return total
    return loss


class TrainStep:
    """One captured program per input signature: forward + loss +
    backward + optimizer update (+ BN running-stat updates).

    ``step(inputs, labels)`` returns the loss Tensor (or ``(loss,
    outputs)`` with ``return_outputs=True`` — hapi needs outputs for
    metrics). The first call runs eagerly (lazy state — optimizer
    accumulators, lazily-built sublayers — initializes with real values,
    exactly like ``to_static``); the second captures the program, later
    calls replay it.

    ``scaler``: a GradScaler with dynamic loss scaling branches on
    ``isfinite`` host-side, which cannot live inside one captured program
    — an enabled scaler runs the step on the eager tape path instead, as
    the reference does (each such call counts on
    ``jit.api.fallbacks["scaler"]``).

    ``sentinel``: the run-health NaN/Inf/loss-spike detector
    (``health.sentinel.Sentinel``), fused INTO the step: the mutable state
    (params, optimizer accumulators, master weights, BN running stats) is
    copied before the update and ``torch.where``-gated after it, so a bad
    step is a state no-op, decided on the device with no host read inside
    the step. ``True`` builds a Sentinel from the FLAGS_health_* defaults;
    ``None`` follows ``FLAGS_health_sentinel``. The verdict is readable
    after each step via ``step.sentinel.last_record()``.
    """

    def __init__(self, model, optimizer, loss_fn: Callable, *,
                 amp: bool = False, amp_level: str = "O1",
                 amp_dtype: str = "bfloat16", scaler=None,
                 donate: Optional[bool] = None,
                 return_outputs: bool = False, sentinel=None):
        from ..nn.layer import Layer

        self.model = model
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self._amp = bool(amp)
        self._amp_level = amp_level
        self._amp_dtype = amp_dtype
        self._scaler = scaler
        self._return_outputs = bool(return_outputs)
        self.donate = donation_supported() if donate is None else bool(donate)
        self._eager_only = scaler is not None and scaler.is_enable()
        if sentinel is None:
            from ..flags import flag
            sentinel = bool(flag("FLAGS_health_sentinel"))
        if sentinel is True:
            from ..health.sentinel import Sentinel
            sentinel = Sentinel()
        self.sentinel = sentinel or None

        def _fn(ins, labs):
            from .. import amp as amp_mod
            from ..health.sentinel import health_state_tensors
            if self.sentinel is not None:
                # snapshot BEFORE forward: BN running stats mutate in the
                # forward pass and must also survive a skipped step
                snap = self.sentinel.snapshot(
                    health_state_tensors(self.model, self.optimizer))
            cm = (amp_mod.auto_cast(level=self._amp_level,
                                    dtype=self._amp_dtype)
                  if self._amp else contextlib.nullcontext())
            with cm:
                out = self.model(*ins)
                outs = list(out) if isinstance(out, (list, tuple)) else [out]
                loss = _sum_losses(self.loss_fn(*outs, *labs))
            if self._eager_only:
                self._scaler.scale(loss).backward()
                self._scaler.step(self.optimizer)
                self._scaler.update()
            else:
                loss.backward()
                self.optimizer.step()
            if self.sentinel is not None:
                # re-enumerate: accumulators/masters created BY this step
                # (first call) roll back to their unborn state
                self.sentinel.gate(snap, loss, health_state_tensors(
                    self.model, self.optimizer))
            self.optimizer.clear_grad()
            return (loss, out) if self._return_outputs else loss

        self._fn = _fn
        self._sf = None if self._eager_only else StaticFunction(
            _fn, donate_states=self.donate,
            layer=model if isinstance(model, Layer) else None)

    def __call__(self, inputs, labels=()):
        ins = [t if isinstance(t, Tensor) else to_tensor(t)
               for t in _as_list(inputs)]
        labs = [t if isinstance(t, Tensor) else to_tensor(t)
                for t in _as_list(labels)]
        self.model.train()
        from ..health import watchdog
        from ..profiler import annotate
        watchdog.touch()   # progress tick for the hang watchdog (free when off)
        with annotate("step"):
            if self._sf is None:
                fallbacks["scaler"] += 1
                return self._fn(ins, labs)
            return self._sf(ins, labs)


def make_train_step(model, optimizer, loss_fn: Callable,
                    **kwargs) -> TrainStep:
    """Build a captured train step over an imperative model.

        step = make_train_step(net, opt, nn.CrossEntropyLoss(), amp=True)
        for x, y in prefetch_to_device(loader):
            loss = step(x, y)

    See :class:`TrainStep` for the amp/scaler/donate knobs. hapi's
    ``Model.prepare(..., jit=True)`` rides this path; ``Optimizer.fuse``
    is the optimizer-side spelling.
    """
    return TrainStep(model, optimizer, loss_fn, **kwargs)

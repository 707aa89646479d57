"""Grad mode and the functional gradient API — counterpart of
``paddle_tpu/core/autograd.py``.

The reference records its own tape (one ``GradNode`` per op, a ``jax.vjp``
closure each). The port records nothing itself: every eager op runs
PyTorch operations on the tensors' torch values, so PyTorch's autograd
holds the graph, and this module maps the Paddle calls onto it —
``no_grad`` / ``enable_grad`` / ``set_grad_enabled`` onto torch's grad
mode, ``backward`` onto ``torch.Tensor.backward`` and :func:`grad` onto
``torch.autograd.grad`` (``create_graph``, ``retain_graph``,
``allow_unused``).
"""

from __future__ import annotations

import functools

import torch

__all__ = ["no_grad", "enable_grad", "set_grad_enabled", "is_grad_enabled",
           "backward", "grad"]


def is_grad_enabled() -> bool:
    return torch.is_grad_enabled()


def set_grad_enabled(mode: bool) -> None:
    torch.set_grad_enabled(bool(mode))


class _GradModeCtx:
    """Context manager *and* decorator, usable bare (``@no_grad``) or called
    (``with no_grad():``) — matching paddle.no_grad's dual use."""

    def __init__(self, mode: bool):
        self._mode = mode
        self._saved = []

    def __enter__(self):
        self._saved.append(torch.is_grad_enabled())
        torch.set_grad_enabled(self._mode)
        return self

    def __exit__(self, *exc):
        torch.set_grad_enabled(self._saved.pop())
        return False

    def __call__(self, fn=None):
        if fn is None:
            return _GradModeCtx(self._mode)
        mode = self._mode

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with _GradModeCtx(mode):
                return fn(*args, **kwargs)

        return wrapper


no_grad = _GradModeCtx(False)
enable_grad = _GradModeCtx(True)


def _value(t):
    from .tensor import Tensor
    return t._value if isinstance(t, Tensor) else t


def backward(tensors, grad_tensors=None, retain_graph: bool = False) -> None:
    """Reverse accumulation from ``tensors`` into the leaves' ``.grad``.
    A tensor with ``stop_gradient=True`` raises; a non-scalar one needs its
    ``grad_tensors`` entry; a second pass over a freed graph raises
    PyTorch's error, which names ``retain_graph``."""
    from .tensor import Tensor
    if isinstance(tensors, Tensor):
        tensors = [tensors]
    if grad_tensors is None or isinstance(grad_tensors, Tensor):
        grad_tensors = [grad_tensors] * len(tensors) \
            if grad_tensors is None else [grad_tensors]
    roots, seeds = [], []
    for t, g in zip(tensors, grad_tensors):
        if t.stop_gradient:
            raise RuntimeError(
                f"backward() called on a tensor with stop_gradient=True: {t!r}")
        v = t._value
        if g is None:
            if v.numel() != 1:
                raise RuntimeError(
                    "grad must be provided for non-scalar backward()")
            g = torch.ones_like(v)
        roots.append(v)
        seeds.append(_value(g).to(v.dtype))
    torch.autograd.backward(roots, seeds, retain_graph=retain_graph)


def grad(outputs, inputs, grad_outputs=None, retain_graph=None,
         create_graph=False, only_inputs=True, allow_unused=False):
    """``paddle.grad``: the gradients of ``outputs`` with respect to
    ``inputs``, leaving every ``.grad`` untouched. An input the outputs do
    not reach raises unless ``allow_unused`` (then its entry is None)."""
    from .tensor import Tensor, _wrap
    single_in = isinstance(inputs, Tensor)
    inputs = [inputs] if single_in else list(inputs)
    outputs = [outputs] if isinstance(outputs, Tensor) else list(outputs)
    if grad_outputs is not None:
        grad_outputs = [grad_outputs] if isinstance(grad_outputs, Tensor) \
            else list(grad_outputs)
        grad_outputs = [None if g is None else _value(g)
                        for g in grad_outputs]
    try:
        gs = torch.autograd.grad(
            [o._value for o in outputs], [t._value for t in inputs],
            grad_outputs=grad_outputs,
            retain_graph=bool(retain_graph) or create_graph,
            create_graph=create_graph, allow_unused=allow_unused)
    except RuntimeError as e:
        if "not have been used in the graph" in str(e):
            raise RuntimeError(
                "One of the differentiated tensors appears unused in the "
                "graph; pass allow_unused=True to return None for it.") from e
        raise
    results = [None if g is None else _wrap(g) for g in gs]
    return results[0] if single_in else results

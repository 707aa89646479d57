"""Shared plumbing for the op surface modules — counterpart of
``paddle_tpu/ops/_helpers.py``: each public op is a thin wrapper that
canonicalizes its arguments and enters the dispatcher with a torch
function."""

from __future__ import annotations

import sys
from typing import Callable, Sequence

import torch

from ..core.dispatch import forward_op, register_op
from ..core.tensor import Tensor, device_scalar, to_tensor

__all__ = ["ensure_tensor", "unary_factory", "binary_factory", "patch_methods",
           "forward_op", "register_op", "Tensor", "axes_arg", "dims_of"]


def ensure_tensor(x) -> Tensor:
    return x if isinstance(x, Tensor) else to_tensor(x)


def axes_arg(axis):
    """Canonicalize paddle-style axis arguments (int | list | tuple | None)."""
    if axis is None:
        return None
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) for a in axis)
    if isinstance(axis, Tensor):
        return tuple(int(a) for a in axis.numpy().reshape(-1))
    return int(axis)


def dims_of(v: torch.Tensor, axis):
    """A torch ``dim`` tuple for a paddle ``axis`` (every dim when None)."""
    ax = axes_arg(axis)
    if ax is None:
        return tuple(range(v.dim()))
    return (ax,) if isinstance(ax, int) else ax


def _binary_operand(y, like: Tensor):
    """A Python scalar becomes a 0-d tensor on ``like``'s device, which
    torch promotes as weakly as ``jnp`` promotes a Python scalar (a float
    scalar keeps a bf16 tensor bf16); anything else becomes a Tensor."""
    if isinstance(y, (bool, int, float, complex)):
        return device_scalar(y, like._value.device)
    return ensure_tensor(y)


def _caller_module() -> str:
    """The module whose top level called the factory: a generated op
    belongs to the module that defines it (``dispatch.op_module``)."""
    return sys._getframe(2).f_globals.get("__name__", __name__)


def unary_factory(name: str, tfn: Callable, doc: str = ""):
    register_op(name, tfn, doc, category="unary")

    def op(x, name=None):
        return forward_op(op.__name__, tfn, [ensure_tensor(x)])

    op.__name__ = name
    op.__qualname__ = name
    op.__doc__ = doc or f"Elementwise {name} (Paddle API parity)."
    op.__module__ = _caller_module()
    return op


def binary_factory(name: str, tfn: Callable, doc: str = ""):
    register_op(name, tfn, doc, category="binary")

    def op(x, y, name=None):
        if not isinstance(x, Tensor) and isinstance(y, Tensor):
            return forward_op(op.__name__, tfn,
                              [_binary_operand(x, y), y])
        x = ensure_tensor(x)
        return forward_op(op.__name__, tfn, [x, _binary_operand(y, x)])

    op.__name__ = name
    op.__qualname__ = name
    op.__doc__ = doc or f"Elementwise broadcasting {name} (Paddle API parity)."
    op.__module__ = _caller_module()
    return op


def patch_methods(pairs: Sequence[tuple]):
    """Attach (method_name, function) pairs to Tensor, mirroring Paddle's
    monkey-patching of python/paddle/tensor/* onto the C++ tensor class."""
    for mname, fn in pairs:
        setattr(Tensor, mname, fn)

"""``paddle.autograd`` — counterpart of ``paddle_tpu/autograd.py``: the
public namespace over ``core/autograd.py`` plus :class:`PyLayer`, a
user-defined forward / backward pair recorded as one autograd op.

The reference records the pair as one node of its own tape. Here it is
one ``torch.autograd.Function`` (one class a ``PyLayer`` subclass): its
forward calls the user's ``forward`` on the port's Tensors with grad mode
off, its backward calls the user's ``backward`` on Tensors of the
cotangents. ``ctx.save_for_backward`` saves through torch's saved-tensor
machinery (its version checks included); ``mark_non_differentiable``
and ``set_materialize_grads`` are torch's own.

``saved_tensors_hooks`` raises, as the reference does.
"""

from __future__ import annotations

import torch

from .core.autograd import (backward, enable_grad, grad, is_grad_enabled,
                            no_grad, set_grad_enabled)
from .core.tensor import Tensor, _wrap

__all__ = ["backward", "grad", "no_grad", "enable_grad", "set_grad_enabled",
           "is_grad_enabled", "PyLayer", "PyLayerContext",
           "saved_tensors_hooks"]


def _val(x):
    return x._value if isinstance(x, Tensor) else x


class PyLayerContext:
    """ref: paddle.autograd.PyLayerContext — ``save_for_backward`` /
    ``saved_tensor`` plus any attribute stashed between forward and
    backward; over torch's ``FunctionCtx`` ``fctx``."""

    def __init__(self, fctx):
        self._fctx = fctx
        self.materialize_grads = True

    def save_for_backward(self, *tensors):
        self._fctx.save_for_backward(*[_val(t) for t in tensors])

    def saved_tensor(self):
        return tuple(_wrap(v) if isinstance(v, torch.Tensor) else v
                     for v in self._fctx.saved_tensors)

    def set_materialize_grads(self, value: bool):
        self.materialize_grads = bool(value)
        self._fctx.set_materialize_grads(bool(value))

    def mark_not_inplace(self, *a):
        pass

    def mark_non_differentiable(self, *tensors):
        self._fctx.mark_non_differentiable(*[_val(t) for t in tensors])


class _Function(torch.autograd.Function):
    """The torch Function every PyLayer runs as: ``apply(layer, kwargs,
    *args)``."""

    @staticmethod
    def forward(fctx, layer, kwargs, *args):
        ctx = PyLayerContext(fctx)
        fctx.py_ctx, fctx.layer = ctx, layer
        fctx.tensor_idx = [i for i, a in enumerate(args)
                           if isinstance(a, torch.Tensor)]
        ins = [_wrap(a) if isinstance(a, torch.Tensor) else a for a in args]
        out = layer.forward(ctx, *ins, **kwargs)
        fctx.multi = isinstance(out, (tuple, list))
        outs = tuple(out) if fctx.multi else (out,)
        return tuple(_val(o) for o in outs) if fctx.multi else _val(out)

    @staticmethod
    def backward(fctx, *cots):
        layer = fctx.layer
        gt = [None if c is None else _wrap(c) for c in cots]
        gin = layer.backward(fctx.py_ctx, *gt)
        gin = gin if isinstance(gin, (tuple, list)) else (gin,)
        tidx = fctx.tensor_idx
        diff = [i for i, need in zip(tidx, [fctx.needs_input_grad[2 + i]
                                            for i in tidx]) if need]
        if len(gin) == len(tidx):
            slots = tidx
        elif len(gin) == len(diff):
            slots = diff
        else:
            raise RuntimeError(
                f"{layer.__name__}.backward returned {len(gin)} grads for "
                f"{len(diff)} differentiable inputs")
        n_args = len(fctx.needs_input_grad) - 2
        out = [None] * n_args
        for i, g in zip(slots, gin):
            out[i] = None if g is None else _val(g)
        return (None, None, *out)


class PyLayer:
    """User-defined differentiable op (ref: paddle.autograd.PyLayer).

    Subclass with ``@staticmethod forward(ctx, *args)`` and
    ``@staticmethod backward(ctx, *grads)``; call ``apply``. ``backward``
    returns one gradient a Tensor input, or one a differentiable one."""

    @staticmethod
    def forward(ctx, *args, **kwargs):
        raise NotImplementedError("PyLayer subclass must define forward")

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError("PyLayer subclass must define backward")

    @classmethod
    def apply(cls, *args, **kwargs):
        out = _Function.apply(cls, kwargs, *[_val(a) for a in args])
        if isinstance(out, tuple):
            return tuple(_wrap(o) if isinstance(o, torch.Tensor) else o
                         for o in out)
        return _wrap(out) if isinstance(out, torch.Tensor) else out


def saved_tensors_hooks(*a, **k):
    raise NotImplementedError(
        "saved_tensors_hooks: tensor offloading hooks are not supported, as "
        "in the reference; use recompute() for memory savings")

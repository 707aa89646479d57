"""Structured control flow over Tensors — counterpart of
``paddle_tpu/jit/control_flow.py`` (``paddle.static.nn.cond`` /
``while_loop`` and the loops dy2static lowers to).

The reference wraps ``lax.cond`` / ``lax.while_loop`` / ``lax.scan``.
A CUDA graph replays a fixed list of kernels, so the port lowers them
so:

* ``cond`` — eagerly the host reads the predicate and runs one branch;
  inside a capture (``jit/trace.py``) both branches run and
  ``torch.where`` selects, so the branches must be free of side effects,
  which the reference's rewrite already requires. Gradients flow to the
  operands through the selected branch.
* ``while_loop`` — forward-only, as the reference's. Eagerly a Python
  loop; inside a capture the loop ends the current graph and its body
  becomes a graph of its own, replayed while the host reads the
  predicate true (:meth:`trace.CompiledProgram._while_loop`).
* ``scan`` — differentiable; the loop is unrolled over the leading axis
  of ``xs`` (its trip count is static), so a capture holds every trip.
* ``fori_loop`` — forward-only; Python bounds unroll, Tensor bounds go
  through ``while_loop``.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..core import autograd
from ..core.dispatch import forward_op
from ..core.tensor import Tensor, _wrap, to_tensor
from .trace import current_ctx, flatten

__all__ = ["cond", "while_loop", "scan", "fori_loop"]


def _unflatten(leaves, spec):
    import torch.utils._pytree as pytree
    return pytree.tree_unflatten(list(leaves), spec)


def _select(pred: Tensor, a, b):
    if isinstance(a, Tensor) or isinstance(b, Tensor):
        return forward_op(
            "cond", lambda p, x, y: torch.where(p.reshape(()).to(torch.bool),
                                                x, y),
            [pred, a, b])
    if a != b:
        raise ValueError(f"cond: the branches returned different Python "
                         f"values ({a!r} and {b!r}); return tensors")
    return a


def cond(pred, true_fn: Callable, false_fn: Callable, *operands):
    """paddle.static.nn.cond parity, differentiable w.r.t. tensor
    operands. A Python predicate runs its branch."""
    if not isinstance(pred, Tensor):
        return true_fn(*operands) if pred else false_fn(*operands)
    if current_ctx() is None:
        return true_fn(*operands) if bool(pred) else false_fn(*operands)
    t_leaves, t_spec = flatten(true_fn(*operands))
    f_leaves, f_spec = flatten(false_fn(*operands))
    if t_spec != f_spec:
        raise ValueError(f"cond: the branches return different structures "
                         f"({t_spec} and {f_spec})")
    return _unflatten([_select(pred, a, b)
                       for a, b in zip(t_leaves, f_leaves)], t_spec)


def _as_tensor(v) -> Tensor:
    """A Python scalar as a 0-d Tensor on the current place, made on the
    device (a host-to-device copy cannot be captured)."""
    if isinstance(v, Tensor):
        return v
    if isinstance(v, (bool, int, float)):
        from ..core.place import torch_device
        return _wrap(torch.full((), v, device=torch_device()))
    return to_tensor(v)


def while_loop(cond_fn: Callable, body_fn: Callable, loop_vars):
    """paddle.static.nn.while_loop parity (forward-only)."""
    is_seq = isinstance(loop_vars, (list, tuple))
    vs = [_as_tensor(v) for v in (loop_vars if is_seq else [loop_vars])]

    def body(*xs):
        out = body_fn(*xs)
        return list(out) if isinstance(out, (list, tuple)) else [out]

    ctx = current_ctx()
    with autograd.no_grad():
        if ctx is not None:
            res = ctx.while_loop(cond_fn, body, vs)
        else:
            res = vs
            while bool(cond_fn(*res)):
                res = [_as_tensor(v) for v in body(*res)]
    return list(res) if is_seq else res[0]


def _stack(items):
    return forward_op("stack", lambda *vs: torch.stack(vs), list(items))


def scan(body_fn: Callable, init, xs=None, length=None, reverse=False):
    """Differentiable loop: ``carry, ys = scan(f, init, xs)`` with
    ``f(carry, x) -> (carry, y)`` over the leading axis of ``xs``."""
    x_leaves, x_spec = flatten(xs) if xs is not None else ([], None)
    n = length
    if x_leaves:
        n = x_leaves[0].shape[0]
    if n is None:
        raise ValueError("scan: pass xs or length")
    order = range(n - 1, -1, -1) if reverse else range(n)
    carry, ys = init, []
    for i in order:
        x = _unflatten([l[i] for l in x_leaves], x_spec) \
            if xs is not None else None
        carry, y = body_fn(carry, x)
        ys.append(y)
    if reverse:
        ys.reverse()
    if not ys:
        return carry, ys
    y_leaves = [flatten(y)[0] for y in ys]
    spec = flatten(ys[0])[1]
    stacked = [_stack(col) if isinstance(col[0], Tensor) else col[0]
               for col in zip(*y_leaves)]
    return carry, _unflatten(stacked, spec)


def fori_loop(lower, upper, body_fn: Callable, init):
    """``body_fn(i, vals) -> vals`` for ``i`` in ``[lower, upper)``
    (forward-only)."""
    if isinstance(lower, Tensor) or isinstance(upper, Tensor):
        leaves, spec = flatten(init)
        hi = _as_tensor(upper)

        def c(i, *ls):
            return i < hi

        def b(i, *ls):
            out = body_fn(i, _unflatten(ls, spec))
            return [i + 1] + list(flatten(out)[0])

        res = while_loop(c, b, [_as_tensor(lower)] + list(leaves))
        return _unflatten(res[1:], spec)
    vals = init
    with autograd.no_grad():
        for i in range(int(lower), int(upper)):
            vals = body_fn(_as_tensor(i), vals)
    return vals

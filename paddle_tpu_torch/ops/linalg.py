"""The matmul family — the part of ``paddle_tpu/ops/linalg.py`` this
slice's layers and operators use (``matmul``, ``mm``, ``bmm``, ``mv``,
``t``, ``norm``, ``einsum``). The decompositions and solvers are still to
be ported (ROADMAP §A item 11)."""

from __future__ import annotations

import torch

from ..core.tensor import Tensor
from ._helpers import axes_arg, ensure_tensor, forward_op, patch_methods


def matmul(x, y, transpose_x=False, transpose_y=False, name=None) -> Tensor:
    x, y = ensure_tensor(x), ensure_tensor(y)

    def impl(a, b):
        if transpose_x and a.dim() >= 2:
            a = a.transpose(-1, -2)
        if transpose_y and b.dim() >= 2:
            b = b.transpose(-1, -2)
        return torch.matmul(a, b)

    return forward_op("matmul", impl, [x, y])


def mm(input, mat2, name=None) -> Tensor:  # noqa: A002
    return matmul(input, mat2)


def bmm(x, y, name=None) -> Tensor:
    return matmul(x, y)


def mv(x, vec, name=None) -> Tensor:
    return matmul(x, vec)


def t(input, name=None) -> Tensor:  # noqa: A002
    input = ensure_tensor(input)
    if input.ndim > 2:
        raise ValueError("paddle.t only supports ndim<=2")
    return forward_op("t", lambda v: v.T, [input])


def norm(x, p=None, axis=None, keepdim=False, name=None) -> Tensor:
    x = ensure_tensor(x)
    ax = axes_arg(axis)
    if p is None:
        p = "fro" if (ax is None or isinstance(ax, tuple)) else 2

    def impl(v):
        if ax is None:
            flat = v.reshape(-1)
            if p in ("fro", 2):
                return torch.linalg.vector_norm(flat)
            return torch.linalg.vector_norm(flat, ord=p)
        if isinstance(ax, tuple) and len(ax) == 2:
            return torch.linalg.matrix_norm(v, ord=p, dim=ax, keepdim=keepdim)
        return torch.linalg.vector_norm(v, ord=2 if p == "fro" else p, dim=ax,
                                        keepdim=keepdim)

    return forward_op("norm", impl, [x])


def einsum(equation, *operands) -> Tensor:
    ts = [ensure_tensor(o) for o in operands]
    return forward_op("einsum", lambda *vs: torch.einsum(equation, *vs), ts)


patch_methods([("matmul", matmul), ("mm", mm), ("bmm", bmm), ("mv", mv),
               ("t", t), ("norm", norm)])

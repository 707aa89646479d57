"""Tensor creation ops — counterpart of ``paddle_tpu/ops/creation.py``.
Creation runs outside autograd (constants have no gradient) except the
ops over Tensor inputs (``assign``, ``clone``, ``diag``, ...)."""

from __future__ import annotations

import numpy as np
import torch

from ..core.dtype import canonical_dtype, get_default_dtype
from ..core.place import torch_device
from ..core.tensor import Parameter, Tensor, to_tensor
from ._helpers import ensure_tensor, forward_op, patch_methods

__all__ = [
    "to_tensor", "zeros", "ones", "full", "empty", "zeros_like", "ones_like",
    "full_like", "empty_like", "arange", "linspace", "logspace", "eye", "diag",
    "diagflat", "meshgrid", "tril", "triu", "tril_indices", "triu_indices", "assign",
    "clone", "numel", "complex", "one_hot", "create_parameter",
]


def _shape_arg(shape):
    if isinstance(shape, Tensor):
        return tuple(int(s) for s in shape.numpy().reshape(-1))
    if isinstance(shape, (int, np.integer)):
        return (int(shape),)
    return tuple(int(s.item()) if isinstance(s, Tensor) else int(s)
                 for s in shape)


def _dt(dtype):
    d = canonical_dtype(dtype)
    return get_default_dtype() if d is None else d


def _scalar(x):
    return x.item() if isinstance(x, Tensor) else x


def zeros(shape, dtype=None, name=None) -> Tensor:
    return Tensor(torch.zeros(_shape_arg(shape), dtype=_dt(dtype),
                              device=torch_device()))


def ones(shape, dtype=None, name=None) -> Tensor:
    return Tensor(torch.ones(_shape_arg(shape), dtype=_dt(dtype),
                             device=torch_device()))


def full(shape, fill_value, dtype=None, name=None) -> Tensor:
    fill_value = _scalar(fill_value)
    d = canonical_dtype(dtype)
    if d is None:
        d = get_default_dtype() if isinstance(fill_value, float) else (
            torch.bool if isinstance(fill_value, bool) else torch.int64)
    return Tensor(torch.full(_shape_arg(shape), fill_value, dtype=d,
                             device=torch_device()))


def empty(shape, dtype=None, name=None) -> Tensor:
    # zero-filled, as the reference's (its arrays have no uninitialized
    # memory); a caller reading "empty" memory sees zeros in both packages
    return zeros(shape, dtype)


def zeros_like(x, dtype=None, name=None) -> Tensor:
    x = ensure_tensor(x)
    return Tensor(torch.zeros_like(x._value, dtype=canonical_dtype(dtype)))


def ones_like(x, dtype=None, name=None) -> Tensor:
    x = ensure_tensor(x)
    return Tensor(torch.ones_like(x._value, dtype=canonical_dtype(dtype)))


def full_like(x, fill_value, dtype=None, name=None) -> Tensor:
    x = ensure_tensor(x)
    return Tensor(torch.full_like(x._value, _scalar(fill_value),
                                  dtype=canonical_dtype(dtype)))


def empty_like(x, dtype=None, name=None) -> Tensor:
    return zeros_like(x, dtype)


def arange(start=0, end=None, step=1, dtype=None, name=None) -> Tensor:
    start, end, step = _scalar(start), _scalar(end), _scalar(step)
    if end is None:
        start, end = 0, start
    d = canonical_dtype(dtype)
    if d is None and any(isinstance(v, float) for v in (start, end, step)):
        d = get_default_dtype()
    return Tensor(torch.arange(start, end, step, dtype=d,
                               device=torch_device()))


def linspace(start, stop, num, dtype=None, name=None) -> Tensor:
    return Tensor(torch.linspace(_scalar(start), _scalar(stop), int(_scalar(num)),
                                 dtype=_dt(dtype), device=torch_device()))


def logspace(start, stop, num, base=10.0, dtype=None, name=None) -> Tensor:
    return Tensor(torch.logspace(_scalar(start), _scalar(stop), int(_scalar(num)),
                                 base=_scalar(base), dtype=_dt(dtype),
                                 device=torch_device()))


def eye(num_rows, num_columns=None, dtype=None, name=None) -> Tensor:
    n = int(num_rows)
    m = int(num_columns) if num_columns is not None else n
    return Tensor(torch.eye(n, m, dtype=_dt(dtype), device=torch_device()))


def diag(x, offset=0, padding_value=0, name=None) -> Tensor:
    x = ensure_tensor(x)

    def impl(v):
        out = torch.diag(v, offset)
        if v.dim() == 1 and padding_value != 0:
            mask = torch.diag(torch.ones_like(v, dtype=torch.bool), offset)
            out = torch.where(mask, out, torch.full_like(out, padding_value))
        return out

    return forward_op("diag", impl, [x])


def diagflat(x, offset=0, name=None) -> Tensor:
    return forward_op("diagflat", lambda v: torch.diagflat(v, offset),
                      [ensure_tensor(x)])


def diag_embed(x, offset=0, dim1=-2, dim2=-1, name=None) -> Tensor:
    return forward_op("diag_embed",
                      lambda v: torch.diag_embed(v, offset, dim1, dim2),
                      [ensure_tensor(x)])


def meshgrid(*args, **kwargs):
    ts = [ensure_tensor(a) for a in (args[0] if len(args) == 1 and
                                     isinstance(args[0], (list, tuple)) else args)]
    outs = forward_op("meshgrid",
                      lambda *vs: tuple(torch.meshgrid(*vs, indexing="ij")), ts)
    return list(outs) if isinstance(outs, tuple) else [outs]


def tril(x, diagonal=0, name=None) -> Tensor:
    return forward_op("tril", lambda v: torch.tril(v, diagonal), [ensure_tensor(x)])


def triu(x, diagonal=0, name=None) -> Tensor:
    return forward_op("triu", lambda v: torch.triu(v, diagonal), [ensure_tensor(x)])


def tril_indices(row, col, offset=0, dtype="int64", name=None) -> Tensor:
    return Tensor(torch.tril_indices(int(row), int(col), int(offset),
                                     dtype=canonical_dtype(dtype),
                                     device=torch_device()))


def triu_indices(row, col=None, offset=0, dtype="int64", name=None) -> Tensor:
    col = col if col is not None else row
    return Tensor(torch.triu_indices(int(row), int(col), int(offset),
                                     dtype=canonical_dtype(dtype),
                                     device=torch_device()))


def assign(x, output=None):
    """paddle.assign: copy into ``output`` (or a fresh tensor); differentiable."""
    x = ensure_tensor(x)
    out = forward_op("assign", lambda v: v.clone(), [x])
    if output is not None:
        output._rebind(out)
        return output
    return out


def clone(x, name=None) -> Tensor:
    return ensure_tensor(x).clone()


def numel(x, name=None) -> Tensor:
    x = ensure_tensor(x)
    return Tensor(torch.tensor(x.size, dtype=torch.int64, device=x._value.device))


def complex(real, imag, name=None) -> Tensor:  # noqa: A001
    return forward_op("complex", torch.complex,
                      [ensure_tensor(real), ensure_tensor(imag)])


def polar(abs, angle, name=None) -> Tensor:  # noqa: A002
    return forward_op("polar", torch.polar,
                      [ensure_tensor(abs), ensure_tensor(angle)])


def one_hot(x, num_classes, name=None) -> Tensor:
    x = ensure_tensor(x)
    return forward_op(
        "one_hot",
        lambda v: torch.nn.functional.one_hot(v.long(), num_classes).to(
            get_default_dtype()),
        [x], differentiable=False)


def create_parameter(shape, dtype=None, name=None, attr=None, is_bias=False,
                     default_initializer=None) -> Parameter:
    """paddle.create_parameter parity (static-graph helper, eager here)."""
    from ..nn import initializer as init

    p = Parameter(torch.zeros(_shape_arg(shape), dtype=_dt(dtype),
                              device=torch_device()), name=name)
    if default_initializer is not None:
        default_initializer(p)
    elif is_bias:
        init.Constant(0.0)(p)
    else:
        init.XavierNormal()(p)
    return p


patch_methods([
    ("tril", tril), ("triu", triu), ("diag", diag), ("diagflat", diagflat),
])

"""Search / sort / selection ops — counterpart of
``paddle_tpu/ops/search.py``. Ops with data-dependent output shapes
(``nonzero``, ``mode``, ``bincount``) run on the host, as the
reference's."""

from __future__ import annotations

import numpy as np
import torch

from ..core.dtype import canonical_dtype
from ..core.tensor import Tensor, to_tensor
from ._helpers import ensure_tensor, forward_op, patch_methods


def argmax(x, axis=None, keepdim=False, dtype="int64", name=None) -> Tensor:
    x = ensure_tensor(x)
    dt = canonical_dtype(dtype)

    def impl(v):
        if axis is None:
            out = torch.argmax(v.reshape(-1))
            return (out.reshape((1,) * v.dim()) if keepdim else out).to(dt)
        return torch.argmax(v, dim=int(axis), keepdim=keepdim).to(dt)

    return forward_op("argmax", impl, [x], differentiable=False)


def argmin(x, axis=None, keepdim=False, dtype="int64", name=None) -> Tensor:
    x = ensure_tensor(x)
    dt = canonical_dtype(dtype)

    def impl(v):
        if axis is None:
            out = torch.argmin(v.reshape(-1))
            return (out.reshape((1,) * v.dim()) if keepdim else out).to(dt)
        return torch.argmin(v, dim=int(axis), keepdim=keepdim).to(dt)

    return forward_op("argmin", impl, [x], differentiable=False)


def argsort(x, axis=-1, descending=False, stable=False, name=None) -> Tensor:
    x = ensure_tensor(x)
    return forward_op("argsort",
                      lambda v: torch.argsort(v, dim=int(axis),
                                              descending=descending,
                                              stable=stable),
                      [x], differentiable=False)


def sort(x, axis=-1, descending=False, stable=False, name=None) -> Tensor:
    x = ensure_tensor(x)
    return forward_op("sort",
                      lambda v: torch.sort(v, dim=int(axis), descending=descending,
                                           stable=stable).values, [x])


def topk(x, k, axis=None, largest=True, sorted=True, name=None):  # noqa: A002
    x = ensure_tensor(x)
    kk = int(k.item()) if isinstance(k, Tensor) else int(k)
    ax = -1 if axis is None else int(axis)
    return forward_op("topk",
                      lambda v: tuple(torch.topk(v, kk, dim=ax, largest=largest,
                                                 sorted=True)), [x])


def kthvalue(x, k, axis=-1, keepdim=False, name=None):
    x = ensure_tensor(x)
    return forward_op("kthvalue",
                      lambda v: tuple(torch.kthvalue(v, int(k), dim=int(axis),
                                                     keepdim=keepdim)), [x])


def mode(x, axis=-1, keepdim=False, name=None):
    """Most frequent value along axis (on the host; uncommon op)."""
    x = ensure_tensor(x)
    arr = x.numpy()
    ax = int(axis) % arr.ndim
    moved = np.moveaxis(arr, ax, -1)
    flat = moved.reshape(-1, moved.shape[-1])
    out = np.empty(flat.shape[0], arr.dtype)
    idx = np.empty(flat.shape[0], np.int64)
    for i, row in enumerate(flat):
        uniq, inv, counts = np.unique(row, return_inverse=True, return_counts=True)
        winner = counts.argmax()
        out[i] = uniq[winner]
        idx[i] = np.where(inv == winner)[0][-1]  # paddle returns the last occurrence
    out = out.reshape(moved.shape[:-1])
    idx = idx.reshape(moved.shape[:-1])
    if keepdim:
        out = np.expand_dims(out, ax)
        idx = np.expand_dims(idx, ax)
    return to_tensor(out, place=x.place), to_tensor(idx, place=x.place)


def where(condition, x=None, y=None, name=None):
    condition = ensure_tensor(condition)
    if x is None and y is None:
        return nonzero(condition, as_tuple=True)
    x = ensure_tensor(x)
    y = ensure_tensor(y)
    return forward_op("where",
                      lambda c, a, b: torch.where(c.bool(), a, b),
                      [condition, x, y])


def where_(condition, x, y, name=None):
    out = where(condition, x, y)
    x._rebind(out)
    return x


def nonzero(x, as_tuple=False):
    """Eager-only (dynamic output shape)."""
    x = ensure_tensor(x)
    nz = torch.nonzero(x._value.detach())
    if as_tuple:
        return tuple(Tensor(nz[:, i].contiguous()) for i in range(nz.shape[1]))
    return Tensor(nz)


def searchsorted(sorted_sequence, values, out_int32=False, right=False, name=None) -> Tensor:
    return forward_op("searchsorted",
                      lambda s, v: torch.searchsorted(s, v.to(s.dtype),
                                                      out_int32=out_int32,
                                                      right=right),
                      [ensure_tensor(sorted_sequence), ensure_tensor(values)],
                      differentiable=False)


def bucketize(x, sorted_sequence, out_int32=False, right=False, name=None) -> Tensor:
    return searchsorted(sorted_sequence, x, out_int32=out_int32, right=right)


def index_fill(x, index, axis, value, name=None) -> Tensor:
    x, index = ensure_tensor(x), ensure_tensor(index)
    return forward_op("index_fill",
                      lambda v, i: torch.index_fill(v, int(axis),
                                                    i.reshape(-1).long(), value),
                      [x, index])


def histogram(input, bins=100, min=0, max=0, name=None) -> Tensor:  # noqa: A002
    input = ensure_tensor(input)

    def impl(v):
        v = v.reshape(-1).double()
        lo, hi = (v.min(), v.max()) if (min == 0 and max == 0) else \
            (torch.tensor(float(min), dtype=v.dtype, device=v.device),
             torch.tensor(float(max), dtype=v.dtype, device=v.device))
        if bool(hi == lo):
            lo, hi = lo - 0.5, hi + 0.5
        inside = (v >= lo) & (v <= hi)
        b = torch.clamp(((v - lo) / (hi - lo) * bins).floor().long(), 0, bins - 1)
        return torch.bincount(b[inside], minlength=bins)

    return forward_op("histogram", impl, [input], differentiable=False)


def bincount(x, weights=None, minlength=0, name=None) -> Tensor:
    x = ensure_tensor(x)
    w = weights.numpy() if isinstance(weights, Tensor) else weights
    return to_tensor(np.bincount(x.numpy(), weights=w, minlength=minlength),
                     place=x.place)


patch_methods([
    ("argmax", argmax), ("argmin", argmin), ("argsort", argsort), ("sort", sort),
    ("topk", topk), ("kthvalue", kthvalue), ("mode", mode), ("where", where),
    ("nonzero", nonzero), ("bucketize", bucketize), ("histogram", histogram),
    ("bincount", bincount), ("index_fill", index_fill),
])

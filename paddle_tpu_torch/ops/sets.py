"""Set operations on 1-D tensors — counterpart of
``paddle_tpu/ops/sets.py``.

The reference computes the data-dependent results on the host
(``_host_set_op``); here they are computed on the input's device with
``torch.unique`` / ``torch.sort`` / ``torch.isin``, by numpy's algorithms,
so the sorted (or, for ``setdiff1d(assume_unique=True)``, ordered) output
equals numpy's. ``in1d`` is the static-shaped mask form.
"""

from __future__ import annotations

import torch

from ._helpers import ensure_tensor, forward_op, register_op

__all__ = ["intersect1d", "setdiff1d", "union1d", "setxor1d", "in1d",
           "isin_1d"]


def _set_op(name, fn, x, y):
    return forward_op(name, lambda a, b: fn(a.reshape(-1), b.reshape(-1)),
                      [ensure_tensor(x), ensure_tensor(y)],
                      differentiable=False)


def _intersect(a, b, assume_unique):
    if not assume_unique:
        a, b = torch.unique(a), torch.unique(b)
    aux = torch.sort(torch.cat([a, b.to(a.dtype)])).values
    return aux[:-1][aux[1:] == aux[:-1]]


def intersect1d(x, y, assume_unique: bool = False, name=None):
    """Sorted unique values present in both tensors."""
    return _set_op("intersect1d",
                   lambda a, b: _intersect(a, b, assume_unique), x, y)


def setdiff1d(x, y, assume_unique: bool = False, name=None):
    """Sorted unique values in ``x`` that are not in ``y``."""
    def f(a, b):
        a = a if assume_unique else torch.unique(a)
        return a[~torch.isin(a, b.to(a.dtype))]
    return _set_op("setdiff1d", f, x, y)


def union1d(x, y, name=None):
    """Sorted union of unique values."""
    return _set_op("union1d",
                   lambda a, b: torch.unique(torch.cat([a, b.to(a.dtype)])),
                   x, y)


def setxor1d(x, y, assume_unique: bool = False, name=None):
    """Sorted values in exactly one of the tensors."""
    def f(a, b):
        if not assume_unique:
            a, b = torch.unique(a), torch.unique(b)
        aux = torch.sort(torch.cat([a, b.to(a.dtype)])).values
        if aux.numel() == 0:
            return aux
        edge = torch.ones(1, dtype=torch.bool, device=aux.device)
        flag = torch.cat([edge, aux[1:] != aux[:-1], edge])
        return aux[flag[1:] & flag[:-1]]
    return _set_op("setxor1d", f, x, y)


def in1d(x, test, assume_unique: bool = False, invert: bool = False,
         name=None):
    """Boolean mask over ``x.ravel()``: element present in ``test``.
    Static-shaped (mask, not values)."""
    return _set_op("in1d", lambda a, b: torch.isin(a, b.to(a.dtype),
                                                   invert=invert), x, test)


isin_1d = in1d

for _n, _f in (("intersect1d", intersect1d), ("setdiff1d", setdiff1d),
               ("union1d", union1d), ("setxor1d", setxor1d), ("in1d", in1d)):
    register_op(_n, _f, _f.__doc__ or "", differentiable=False,
                category="set", public=_f)

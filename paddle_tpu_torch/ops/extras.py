"""Secondary op surface — counterpart of ``paddle_tpu/ops/extras.py``:
stacking / splitting variants, distances and statistics, scatter-style
functional updates, complex views, misc math. Each op is torch functions
through the dispatcher; ``histogramdd`` counts on the host, as the
reference's does, and its outputs land on the input's device."""

from __future__ import annotations

import itertools

import numpy as np
import torch

from ._helpers import (dims_of, ensure_tensor, forward_op,
                       patch_methods, unary_factory)
from .creation import polar
from .manipulation import as_complex, as_real, rot90

__all__ = [
    "hstack", "vstack", "dstack", "column_stack", "row_stack", "tensor_split",
    "hsplit", "vsplit", "dsplit", "unflatten", "block_diag", "rot90",
    "diagonal_scatter", "select_scatter", "positive", "signbit", "sinc",
    "vander", "trapezoid", "cumulative_trapezoid", "renorm", "cdist", "pdist",
    "cartesian_prod", "combinations", "view_as_complex", "view_as_real",
    "is_complex", "is_floating_point", "aminmax", "baddbmm", "isin",
    "histogramdd", "as_complex", "as_real", "polar",
]


# -- stacking / splitting ----------------------------------------------------

def _tensors(xs):
    return [ensure_tensor(x) for x in xs]


def hstack(x, name=None):
    return forward_op("hstack", lambda *vs: torch.hstack(vs), _tensors(x))


def vstack(x, name=None):
    return forward_op("vstack", lambda *vs: torch.vstack(vs), _tensors(x))


def dstack(x, name=None):
    return forward_op("dstack", lambda *vs: torch.dstack(vs), _tensors(x))


def column_stack(x, name=None):
    return forward_op("column_stack", lambda *vs: torch.column_stack(vs),
                      _tensors(x))


row_stack = vstack


def tensor_split(x, num_or_indices, axis=0, name=None):
    t = ensure_tensor(x)
    if isinstance(num_or_indices, int):
        n, k = t.shape[axis], num_or_indices
        sizes = [n // k + 1] * (n % k) + [n // k] * (k - n % k)
        bounds = np.cumsum(sizes)[:-1].tolist()
    else:
        bounds = [int(b) for b in num_or_indices]
    outs = forward_op(
        "tensor_split",
        lambda v: tuple(torch.tensor_split(v, bounds, dim=axis)), [t])
    return list(outs)


def hsplit(x, num_or_indices, name=None):
    t = ensure_tensor(x)
    return tensor_split(t, num_or_indices, axis=0 if t.ndim == 1 else 1)


def vsplit(x, num_or_indices, name=None):
    return tensor_split(x, num_or_indices, axis=0)


def dsplit(x, num_or_indices, name=None):
    return tensor_split(x, num_or_indices, axis=2)


def unflatten(x, axis, shape, name=None):
    t = ensure_tensor(x)
    axis = axis % t.ndim
    shape = [int(s) for s in shape]
    full = list(t.shape)
    if -1 in shape:
        known = int(np.prod([s for s in shape if s != -1]))
        shape[shape.index(-1)] = full[axis] // known
    new = full[:axis] + shape + full[axis + 1:]
    return forward_op("unflatten", lambda v: v.reshape(new), [t])


def block_diag(inputs, name=None):
    return forward_op("block_diag", lambda *vs: torch.block_diag(*vs),
                      _tensors(inputs))


# -- scatter-style functional updates ---------------------------------------

def diagonal_scatter(x, y, offset=0, axis1=0, axis2=1, name=None):
    return forward_op(
        "diagonal_scatter",
        lambda v, src: torch.diagonal_scatter(v, src.to(v.dtype), offset,
                                              axis1, axis2),
        [ensure_tensor(x), ensure_tensor(y)])


def select_scatter(x, values, axis, index, name=None):
    return forward_op(
        "select_scatter",
        lambda v, src: torch.select_scatter(v, src.to(v.dtype), axis, index),
        [ensure_tensor(x), ensure_tensor(values)])


# -- elementwise / math ------------------------------------------------------

positive = unary_factory("positive", lambda v: +v)
signbit = unary_factory("signbit", torch.signbit)
sinc = unary_factory("sinc", lambda v: torch.sinc(
    v if v.is_floating_point() else v.to(torch.get_default_dtype())))


def vander(x, n=None, increasing=False, name=None):
    def f(v):
        out = torch.linalg.vander(v, N=n)          # increasing powers
        return out if increasing else out.flip(-1)
    return forward_op("vander", f, [ensure_tensor(x)])


def _trapezoid_avg(v, axis):
    n = v.shape[axis]
    return (v.narrow(axis, 1, n - 1) + v.narrow(axis, 0, n - 1)) / 2.0


def trapezoid(y, x=None, dx=None, axis=-1, name=None):
    t = ensure_tensor(y)
    if x is not None:
        return forward_op("trapezoid",
                          lambda v, xv: torch.trapezoid(v, xv, dim=axis),
                          [t, ensure_tensor(x)])
    d = 1.0 if dx is None else dx
    return forward_op("trapezoid",
                      lambda v: torch.trapezoid(v, dx=d, dim=axis), [t])


def cumulative_trapezoid(y, x=None, dx=None, axis=-1, name=None):
    t = ensure_tensor(y)

    def f(v, xv=None):
        avg = _trapezoid_avg(v, axis)
        if xv is not None:
            n = xv.shape[axis]
            d = xv.narrow(axis, 1, n - 1) - xv.narrow(axis, 0, n - 1)
        else:
            d = 1.0 if dx is None else dx
        return torch.cumsum(avg * d, dim=axis)
    if x is not None:
        return forward_op("cumulative_trapezoid", f, [t, ensure_tensor(x)])
    return forward_op("cumulative_trapezoid", f, [t])


def renorm(x, p, axis, max_norm, name=None):
    """Rescale each slice along ``axis`` whose p-norm exceeds ``max_norm``
    (the reference's formula: factor ``max_norm / (norm + 1e-7)``)."""
    def f(v):
        dims = tuple(d for d in range(v.dim()) if d != axis % v.dim())
        norms = torch.sum(v.abs() ** p, dim=dims, keepdim=True) ** (1.0 / p)
        factor = torch.where(norms > max_norm, max_norm / (norms + 1e-7),
                             torch.ones_like(norms))
        return v * factor
    return forward_op("renorm", f, [ensure_tensor(x)])


def baddbmm(input, x, y, beta=1.0, alpha=1.0, name=None):  # noqa: A002
    return forward_op(
        "baddbmm", lambda b, a, c: beta * b + alpha * torch.bmm(a, c),
        [ensure_tensor(input), ensure_tensor(x), ensure_tensor(y)])


def aminmax(x, axis=None, keepdim=False, name=None):
    def impl(v):
        dims = dims_of(v, axis)
        return (torch.amin(v, dim=dims, keepdim=keepdim),
                torch.amax(v, dim=dims, keepdim=keepdim))
    return forward_op("aminmax", impl, [ensure_tensor(x)])


def isin(x, test_x, assume_unique=False, invert=False, name=None):
    return forward_op(
        "isin", lambda v, tv: torch.isin(v, tv.to(v.dtype), invert=invert),
        [ensure_tensor(x), ensure_tensor(test_x)], differentiable=False)


# -- distances / statistics --------------------------------------------------

def _pnorm_last(diff, p):
    if p == 2.0:
        return torch.sqrt(torch.sum(diff * diff, dim=-1) + 1e-30)
    return torch.sum(diff.abs() ** p, dim=-1) ** (1.0 / p)


def cdist(x, y, p=2.0, compute_mode=None, name=None):
    """Pairwise p-norm distance [..., M, N] (ref: paddle.cdist; the
    reference's ``+ 1e-30`` inside the square root keeps p = 2
    differentiable at zero distance)."""
    return forward_op(
        "cdist",
        lambda a, b: _pnorm_last(a[..., :, None, :] - b[..., None, :, :], p),
        [ensure_tensor(x), ensure_tensor(y)])


def pdist(x, p=2.0, name=None):
    """Condensed pairwise distances of [N, D] -> [N*(N-1)/2]."""
    t = ensure_tensor(x)
    iu = np.triu_indices(int(t.shape[0]), k=1)

    def f(v):
        i = torch.as_tensor(iu[0], device=v.device)
        j = torch.as_tensor(iu[1], device=v.device)
        return _pnorm_last(v[i] - v[j], p)
    return forward_op("pdist", f, [t])


def histogramdd(x, bins=10, ranges=None, density=False, weights=None,
                name=None):
    """Counts on the host (one numpy pass yields histogram and edges, as the
    reference's); both land on the input's device as float32."""
    t = ensure_tensor(x)
    w = None if weights is None else ensure_tensor(weights).numpy()
    hist_np, edges_np = np.histogramdd(t.numpy(), bins=bins, range=ranges,
                                       density=density, weights=w)
    from ..core.tensor import to_tensor
    return (to_tensor(hist_np.astype(np.float32), place=t.place),
            [to_tensor(e.astype(np.float32), place=t.place)
             for e in edges_np])


def cartesian_prod(x, name=None):
    def f(*vs):
        grids = torch.meshgrid(*vs, indexing="ij")
        return torch.stack([g.reshape(-1) for g in grids], dim=-1)
    return forward_op("cartesian_prod", f, _tensors(x))


def combinations(x, r=2, with_replacement=False, name=None):
    t = ensure_tensor(x)
    n = int(t.shape[0])
    src = (itertools.combinations_with_replacement(range(n), r)
           if with_replacement else itertools.combinations(range(n), r))
    idx = np.asarray(list(src), np.int64).reshape(-1, r)
    return forward_op("combinations",
                      lambda v: v[torch.as_tensor(idx, device=v.device)], [t])


# -- complex views (single source of truth in ops/manipulation.py) -----------

view_as_complex = as_complex
view_as_real = as_real


def is_complex(x) -> bool:
    return ensure_tensor(x)._value.is_complex()


def is_floating_point(x) -> bool:
    return ensure_tensor(x)._value.is_floating_point()


patch_methods([
    ("unflatten", unflatten), ("rot90", rot90),
    ("diagonal_scatter", diagonal_scatter),
    ("select_scatter", select_scatter), ("signbit", signbit),
    ("sinc", sinc), ("trapezoid", trapezoid), ("renorm", renorm),
    ("cdist", cdist), ("pdist", pdist), ("aminmax", aminmax),
    ("isin", isin), ("baddbmm", baddbmm),
    ("is_complex", is_complex), ("is_floating_point", is_floating_point),
])

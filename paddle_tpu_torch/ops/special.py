"""Special functions and the remaining math / manipulation surface —
counterpart of ``paddle_tpu/ops/special.py``.

Most names map onto ``torch.special`` or one torch function. Where torch
computes a function but not every derivative the reference takes
(``igamma`` / ``igammac`` in ``a``, ``zeta`` in both arguments), the op is
an autograd Function whose missing partials are central differences of the
same torch function in float64 (step 1e-6 relative: the error is far below
float32's). ``betainc`` has no torch counterpart: it is the regularized
incomplete beta by Lentz's continued fraction (a fixed number of terms, so
no host read and the op can be captured), with the symmetry switch at
``x > (a + 1) / (a + b + 2)``, differentiable in ``x`` only, as JAX's.
The random fills (``cauchy_``, ``geometric_``, ``log_normal_``) draw from
the port's per-device generator.
"""

from __future__ import annotations

import math as _math

import numpy as np
import torch

from ..core.place import torch_device
from ..core.tensor import Tensor, to_tensor
from ._helpers import (axes_arg, binary_factory, dims_of, ensure_tensor,
                       forward_op, patch_methods, register_op, unary_factory)
from .math import _float_in
from .random import generator

__all__ = [
    "xlogy", "xlog1py", "exp2", "expit", "erfc", "erfcx", "igamma",
    "igammac", "logdet", "vdot", "addmv", "addr", "chain_matmul",
    "float_power", "std_mean", "var_mean", "gradient",
    "histogram_bin_edges", "fliplr", "flipud", "rollaxis", "swapdims",
    "narrow", "narrow_copy", "split_with_sizes", "concatenate", "arctan2",
    "entr", "rel_entr", "kl_div", "zeta", "betaln", "betainc", "sinc_pi",
    "log_ndtr", "ndtr", "ndtri", "spherical_bessel_j0", "cbrt",
    "nanargmax", "nanargmin", "nanstd", "nanvar",
]

_sp = torch.special


# -- partial derivatives torch does not provide ------------------------------

def _unbroadcast(g: torch.Tensor, shape) -> torch.Tensor:
    """Sum ``g`` down to ``shape`` (the inverse of broadcasting)."""
    while g.dim() > len(shape):
        g = g.sum(0)
    for i, n in enumerate(shape):
        if n == 1 and g.shape[i] != 1:
            g = g.sum(i, keepdim=True)
    return g


def _central_difference(f, vals, i):
    """d f / d vals[i] by a float64 central difference of ``f``."""
    v64 = [v.detach().double() for v in vals]
    h = 1e-6 * torch.clamp(v64[i].abs(), min=1.0)
    hi, lo = list(v64), list(v64)
    hi[i], lo[i] = v64[i] + h, v64[i] - h
    return (f(*hi) - f(*lo)) / (2 * h)


def _with_partials(f, partials):
    """``f`` as an autograd Function: ``partials[i](*vals)`` is the
    derivative in argument ``i`` (None: a float64 central difference of
    ``f``)."""

    class Fn(torch.autograd.Function):
        @staticmethod
        def forward(ctx, *vals):
            ctx.save_for_backward(*vals)
            return f(*vals)

        @staticmethod
        def backward(ctx, g):
            vals = ctx.saved_tensors
            grads = []
            for i, v in enumerate(vals):
                if not ctx.needs_input_grad[i]:
                    grads.append(None)
                    continue
                p = partials[i]
                d = _central_difference(f, vals, i) if p is None else p(*vals)
                grads.append(_unbroadcast(g * d.to(g.dtype), v.shape))
            return tuple(grads)

    def call(*vals):
        return Fn.apply(*vals)
    call.__name__ = f.__name__
    return call


def _float2(f):
    """``f`` on two values promoted to one float dtype (jnp's rule)."""
    def g(a, b):
        dt = torch.promote_types(a.dtype, b.dtype)
        if not dt.is_floating_point:
            dt = torch.get_default_dtype()
        return f(a.to(dt), b.to(dt))
    g.__name__ = f.__name__
    return g


def _gammainc(a, x):
    return _sp.gammainc(a, x)


def _gammaincc(a, x):
    return _sp.gammaincc(a, x)


def _zeta(x, q):
    return _sp.zeta(x, q)


def _dgammainc_dx(a, x):
    return torch.exp((a - 1) * torch.log(x) - x - torch.lgamma(a))


_gammainc_p = _float2(_with_partials(
    _gammainc, (None, _dgammainc_dx)))
_gammaincc_q = _float2(_with_partials(
    _gammaincc, (None, lambda a, x: -_dgammainc_dx(a, x))))
_zeta_fn = _float2(_with_partials(
    _zeta, (None, lambda x, q: -x * _sp.zeta(x + 1, q))))


def _rel_entr(x, y):
    pos = (x > 0) & (y > 0)
    zero = (x == 0) & (y >= 0)
    safe_x = torch.where(pos, x, torch.ones_like(x))
    safe_y = torch.where(pos, y, torch.ones_like(y))
    v = safe_x * torch.log(safe_x / safe_y)
    return torch.where(pos, v, torch.where(zero, torch.zeros_like(v),
                                           torch.full_like(v, float("inf"))))


def _kl_div(x, y):
    pos = (x > 0) & (y > 0)
    zero = (x == 0) & (y >= 0)
    safe_x = torch.where(pos, x, torch.ones_like(x))
    safe_y = torch.where(pos, y, torch.ones_like(y))
    v = safe_x * torch.log(safe_x / safe_y) - safe_x + safe_y
    return torch.where(pos, v, torch.where(zero, y,
                                           torch.full_like(v, float("inf"))))


def _betaln(a, b):
    return torch.lgamma(a) + torch.lgamma(b) - torch.lgamma(a + b)


def _spherical_j0(x):
    small = x.abs() < 1e-6
    safe = torch.where(x == 0, torch.ones_like(x), x)
    return torch.where(small, 1.0 - x * x / 6.0, torch.sin(safe) / safe)


# -- elementwise special fns (factories: the swept unary/binary ops) ---------

xlogy = binary_factory("xlogy", _float2(_sp.xlogy), "x*log(y), 0 at x==0.")
xlog1py = binary_factory("xlog1py", _float2(_sp.xlog1py),
                         "x*log1p(y), 0 at x==0.")
exp2 = unary_factory("exp2", _float_in(torch.exp2), "2**x elementwise.")
expit = unary_factory("expit", _float_in(torch.sigmoid),
                      "Logistic sigmoid (scipy name).")
erfc = unary_factory("erfc", _float_in(_sp.erfc), "1 - erf(x).")
erfcx = unary_factory("erfcx", _float_in(_sp.erfcx),
                      "Scaled complementary error function exp(x^2)*erfc(x).")
igamma = binary_factory("igamma", _gammainc_p,
                        "Regularized lower incomplete gamma P(a, x).")
igammac = binary_factory("igammac", _gammaincc_q,
                         "Regularized upper incomplete gamma Q(a, x).")
entr = unary_factory("entr", _float_in(_sp.entr),
                     "-x*log(x) for x>0; 0 at 0.")
rel_entr = binary_factory("rel_entr", _float2(_rel_entr),
                          "x*log(x/y) (KL integrand).")
kl_div = binary_factory("kl_div", _float2(_kl_div), "x*log(x/y) - x + y.")
zeta = binary_factory("zeta", _zeta_fn, "Hurwitz zeta(x, q).")
betaln = binary_factory("betaln", _float2(_betaln), "log|B(a, b)|.")
ndtr = unary_factory("ndtr", _float_in(_sp.ndtr), "Standard normal CDF.")
log_ndtr = unary_factory("log_ndtr", _float_in(_sp.log_ndtr),
                         "log of the normal CDF.")
ndtri = unary_factory("ndtri", _float_in(_sp.ndtri),
                      "Inverse of the normal CDF.")
cbrt = unary_factory(
    "cbrt", _float_in(lambda x: torch.sign(x) * x.abs().pow(1.0 / 3.0)),
    "Cube root, sign-preserving.")
sinc_pi = unary_factory("sinc_pi", _float_in(torch.sinc),
                        "Normalized sinc sin(pi x)/(pi x).")
spherical_bessel_j0 = unary_factory(
    "spherical_bessel_j0", _float_in(_spherical_j0),
    "Spherical Bessel function j0(x) = sin(x)/x.")


# -- the regularized incomplete beta -----------------------------------------

_BETACF_TERMS = 200
_TINY = 1e-300


def _betacf(a, b, x):
    """Lentz's continued fraction of I_x(a, b) (float64, fixed terms)."""
    def fix(v):
        return torch.where(v.abs() < _TINY, torch.full_like(v, _TINY), v)
    qab, qap, qam = a + b, a + 1.0, a - 1.0
    c = torch.ones_like(x)
    d = 1.0 / fix(1.0 - qab * x / qap)
    h = d
    for m in range(1, _BETACF_TERMS + 1):
        m2 = 2.0 * m
        aa = m * (b - m) * x / ((qam + m2) * (a + m2))
        d = 1.0 / fix(1.0 + aa * d)
        c = fix(1.0 + aa / c)
        h = h * d * c
        aa = -(a + m) * (qab + m) * x / ((a + m2) * (qap + m2))
        d = 1.0 / fix(1.0 + aa * d)
        c = fix(1.0 + aa / c)
        h = h * d * c
    return h


def _betainc64(a, b, x):
    a, b, x = torch.broadcast_tensors(a.double(), b.double(), x.double())
    swap = x > (a + 1.0) / (a + b + 2.0)
    aa, bb = torch.where(swap, b, a), torch.where(swap, a, b)
    xx = torch.where(swap, 1.0 - x, x)
    inner = (xx > 0) & (xx < 1)
    xs = torch.where(inner, xx, torch.full_like(xx, 0.5))
    front = torch.exp(aa * torch.log(xs) + bb * torch.log1p(-xs)
                      - _betaln(aa, bb))
    v = front * _betacf(aa, bb, xs) / aa
    v = torch.where(inner, v, torch.where(xx <= 0, torch.zeros_like(v),
                                          torch.ones_like(v)))
    return torch.where(swap, 1.0 - v, v)


class _Betainc(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, x):
        ctx.save_for_backward(a, b, x)
        dt = torch.promote_types(torch.promote_types(a.dtype, b.dtype),
                                 x.dtype)
        if not dt.is_floating_point:
            dt = torch.get_default_dtype()
        return _betainc64(a, b, x).to(dt)

    @staticmethod
    def backward(ctx, g):
        a, b, x = ctx.saved_tensors
        if ctx.needs_input_grad[0] or ctx.needs_input_grad[1]:
            raise ValueError("Betainc gradient with respect to a and b not "
                             "supported.")
        a64, b64, x64 = a.double(), b.double(), x.double()
        d = torch.exp((a64 - 1) * torch.log(x64) + (b64 - 1)
                      * torch.log1p(-x64) - _betaln(a64, b64))
        return None, None, _unbroadcast(g * d.to(g.dtype), x.shape)


def betainc(a, b, x, name=None):
    """Regularized incomplete beta I_x(a, b)."""
    return forward_op("betainc", _Betainc.apply,
                      [ensure_tensor(a), ensure_tensor(b), ensure_tensor(x)])


register_op("betainc", _Betainc.apply, betainc.__doc__, public=betainc)


# -- linalg-ish --------------------------------------------------------------

def logdet(x, name=None):
    """log|det(x)| for positive-determinant batches (torch.logdet parity)."""
    def impl(v):
        sign, ld = torch.linalg.slogdet(v)
        return torch.where(sign > 0, ld, torch.full_like(ld, float("nan")))
    return forward_op("logdet", impl, [ensure_tensor(x)])


def vdot(x, y, name=None):
    """Flattened dot product (conjugating for complex inputs)."""
    return forward_op("vdot", lambda a, b: torch.vdot(a.reshape(-1),
                                                      b.reshape(-1)),
                      [ensure_tensor(x), ensure_tensor(y)])


def addmv(input, mat, vec, beta: float = 1.0, alpha: float = 1.0, name=None):  # noqa: A002
    """beta*input + alpha*(mat @ vec)."""
    return forward_op(
        "addmv", lambda i, m, v: beta * i + alpha * (m @ v),
        [ensure_tensor(input), ensure_tensor(mat), ensure_tensor(vec)])


def addr(input, vec1, vec2, beta: float = 1.0, alpha: float = 1.0, name=None):  # noqa: A002
    """beta*input + alpha*outer(vec1, vec2)."""
    return forward_op(
        "addr", lambda i, a, b: beta * i + alpha * torch.outer(a, b),
        [ensure_tensor(input), ensure_tensor(vec1), ensure_tensor(vec2)])


def chain_matmul(*mats, name=None):
    """Product of a chain of matrices (``torch.linalg.multi_dot``)."""
    ts = [ensure_tensor(m) for m in (mats[0] if len(mats) == 1 and
                                     isinstance(mats[0], (list, tuple))
                                     else mats)]
    return forward_op("chain_matmul",
                      lambda *vs: torch.linalg.multi_dot(list(vs)), ts)


def float_power(x, y, name=None):
    """x**y in float32, the reference's widest float."""
    def impl(a, b):
        return torch.pow(a.to(torch.float32), b.to(torch.float32))
    return forward_op("float_power", impl,
                      [ensure_tensor(x), ensure_tensor(y)])


# -- statistics --------------------------------------------------------------

def std_mean(x, axis=None, unbiased: bool = True, keepdim: bool = False,
             name=None):
    """(std, mean) in one pass (torch.std_mean parity)."""
    def impl(v):
        dims = dims_of(v, axis)
        return torch.std_mean(v, dim=dims, correction=1 if unbiased else 0,
                              keepdim=keepdim)
    return forward_op("std_mean", impl, [ensure_tensor(x)])


def var_mean(x, axis=None, unbiased: bool = True, keepdim: bool = False,
             name=None):
    """(var, mean) in one pass (torch.var_mean parity)."""
    def impl(v):
        dims = dims_of(v, axis)
        return torch.var_mean(v, dim=dims, correction=1 if unbiased else 0,
                              keepdim=keepdim)
    return forward_op("var_mean", impl, [ensure_tensor(x)])


def _nanarg(v, axis, keepdim, largest):
    fill = float("-inf") if largest else float("inf")
    nan = torch.isnan(v)
    w = torch.where(nan, torch.full_like(v, fill), v)
    if axis is None:
        idx = (w.reshape(-1).argmax() if largest else w.reshape(-1).argmin())
        out = torch.where(nan.all(), torch.full_like(idx, -1), idx)
        return out.reshape((1,) * v.dim()) if keepdim else out
    idx = w.argmax(axis, keepdim=True) if largest else \
        w.argmin(axis, keepdim=True)
    idx = torch.where(nan.all(axis, keepdim=True), torch.full_like(idx, -1),
                      idx)
    return idx if keepdim else idx.squeeze(axis)


def nanargmax(x, axis=None, keepdim: bool = False, name=None):
    return forward_op("nanargmax",
                      lambda v: _nanarg(v, axes_arg(axis), keepdim, True),
                      [ensure_tensor(x)], differentiable=False)


def nanargmin(x, axis=None, keepdim: bool = False, name=None):
    return forward_op("nanargmin",
                      lambda v: _nanarg(v, axes_arg(axis), keepdim, False),
                      [ensure_tensor(x)], differentiable=False)


def _nanvar(v, axis, ddof, keepdim):
    dims = dims_of(v, axis)
    ok = ~torch.isnan(v)
    n = ok.sum(dims, keepdim=True).to(v.dtype)
    mean = torch.nansum(v, dims, keepdim=True) / n
    dev = torch.where(ok, v - mean, torch.zeros_like(v))
    var = (dev * dev).sum(dims, keepdim=True) / torch.clamp(n - ddof, min=0)
    return var if keepdim else var.reshape(
        [s for i, s in enumerate(v.shape) if i not in
         {d % max(v.dim(), 1) for d in dims}])


def nanstd(x, axis=None, unbiased: bool = True, keepdim: bool = False,
           name=None):
    return forward_op(
        "nanstd",
        lambda v: torch.sqrt(_nanvar(v, axis, 1 if unbiased else 0, keepdim)),
        [ensure_tensor(x)])


def nanvar(x, axis=None, unbiased: bool = True, keepdim: bool = False,
           name=None):
    return forward_op(
        "nanvar", lambda v: _nanvar(v, axis, 1 if unbiased else 0, keepdim),
        [ensure_tensor(x)])


def gradient(x, spacing: float = 1.0, axis=None, name=None):
    """Central-difference gradient (numpy.gradient parity; unit spacing or a
    scalar step; one-sided first-order differences at the edges)."""
    ax = axes_arg(axis)

    def impl(v):
        axes = range(v.dim()) if ax is None else \
            ([ax] if isinstance(ax, int) else ax)
        outs = [torch.gradient(v, spacing=spacing, dim=a, edge_order=1)[0]
                for a in axes]
        return tuple(outs) if len(outs) > 1 else outs[0]
    return forward_op("gradient", impl, [ensure_tensor(x)])


def _data_range(v, min, max):  # noqa: A002
    """The reference's (lo, hi): the data range when min == max == 0, and
    ``hi = lo + 1`` when the range is empty."""
    if min == 0 and max == 0:
        lo, hi = v.min(), v.max()
    else:
        lo = torch.tensor(min, dtype=v.dtype, device=v.device)
        hi = torch.tensor(max, dtype=v.dtype, device=v.device)
    return lo, torch.where(hi > lo, hi, lo + 1)


def _linspace(lo, hi, n):
    """``jnp.linspace(lo, hi, n)`` on device scalars (the last point is
    ``hi`` exactly)."""
    step = torch.arange(n, device=lo.device, dtype=lo.dtype) / (n - 1)
    out = lo + (hi - lo) * step
    return torch.cat([out[:-1], hi.reshape(1)])


def histogram_bin_edges(x, bins: int = 100, min=0, max=0, name=None):  # noqa: A002
    """Bin edges the way paddle.histogram computes them (min==max==0 ->
    data range)."""
    def impl(v):
        lo, hi = _data_range(v, min, max)
        return _linspace(lo, hi, bins + 1)
    return forward_op("histogram_bin_edges", impl, [ensure_tensor(x)],
                      differentiable=False)


# -- manipulation aliases/completions ---------------------------------------

def fliplr(x, name=None):
    return forward_op("fliplr", lambda v: torch.flip(v, (1,)),
                      [ensure_tensor(x)])


def flipud(x, name=None):
    return forward_op("flipud", lambda v: torch.flip(v, (0,)),
                      [ensure_tensor(x)])


def rollaxis(x, axis: int, start: int = 0, name=None):
    def impl(v):
        n = v.dim()
        a = axis % n
        s = start % (n + 1) if start < 0 else start
        if a < s:
            s -= 1
        return torch.movedim(v, a, s)
    return forward_op("rollaxis", impl, [ensure_tensor(x)])


def swapdims(x, dim0: int, dim1: int, name=None):
    return forward_op("swapdims", lambda v: torch.swapaxes(v, dim0, dim1),
                      [ensure_tensor(x)])


def narrow(x, axis: int, start: int, length: int, name=None):
    """Contiguous slice of ``length`` along ``axis`` (torch.narrow parity)."""
    return forward_op("narrow", lambda v: torch.narrow(v, axis, start,
                                                       length),
                      [ensure_tensor(x)])


narrow_copy = narrow


def split_with_sizes(x, sizes, axis: int = 0, name=None):
    """Split into chunks of the given sizes along ``axis``."""
    t = ensure_tensor(x)
    if sum(int(s) for s in sizes) != t.shape[axis]:
        raise ValueError(f"sizes {list(sizes)} do not sum to dim "
                         f"{t.shape[axis]}")
    return forward_op("split_with_sizes",
                      lambda v: tuple(torch.split(v, [int(s) for s in sizes],
                                                  dim=axis)), [t])


def concatenate(x, axis: int = 0, name=None):
    """numpy-name alias of concat."""
    ts = [ensure_tensor(t) for t in x]
    return forward_op("concatenate", lambda *vs: torch.cat(vs, dim=axis), ts)


def arctan2(x, y, name=None):
    return forward_op("arctan2", _float2(torch.atan2),
                      [ensure_tensor(x), ensure_tensor(y)])


for _n, _f in (
        ("logdet", logdet), ("vdot", vdot), ("addmv", addmv), ("addr", addr),
        ("chain_matmul", chain_matmul), ("float_power", float_power),
        ("std_mean", std_mean), ("var_mean", var_mean),
        ("gradient", gradient), ("histogram_bin_edges", histogram_bin_edges),
        ("fliplr", fliplr), ("flipud", flipud), ("rollaxis", rollaxis),
        ("swapdims", swapdims), ("narrow", narrow),
        ("narrow_copy", narrow_copy), ("split_with_sizes", split_with_sizes),
        ("concatenate", concatenate), ("arctan2", arctan2),
        ("nanargmax", nanargmax), ("nanargmin", nanargmin),
        ("nanstd", nanstd), ("nanvar", nanvar)):
    register_op(_n, _f, (_f.__doc__ or "").strip().split("\n")[0],
                public=_f)


# -- index / scatter / shift completions -------------------------------------

def index_copy(x, index, source, axis: int = 0, name=None):
    """Copy rows of ``source`` into ``x`` at ``index`` along ``axis``
    (torch.index_copy parity)."""
    return forward_op(
        "index_copy",
        lambda v, idx, src: torch.index_copy(v, axis, idx.long(),
                                             src.to(v.dtype)),
        [ensure_tensor(x), ensure_tensor(index), ensure_tensor(source)])


def scatter_add(x, index, updates, axis: int = 0, name=None):
    """Accumulating scatter along ``axis`` (torch.scatter_add semantics:
    per-element indices of the same rank as updates)."""
    return forward_op(
        "scatter_add",
        lambda v, idx, upd: torch.scatter_add(v, axis, idx.long(),
                                              upd.to(v.dtype)),
        [ensure_tensor(x), ensure_tensor(index), ensure_tensor(updates)])


_SCATTER_MODES = {"sum": "sum", "add": "sum", "prod": "prod",
                  "multiply": "prod", "amax": "amax", "amin": "amin",
                  "mean": "mean"}


def scatter_reduce(x, index, updates, reduce: str = "sum", axis: int = 0,
                   include_self: bool = True, name=None):
    """Reduce-scatter along ``axis`` with sum/prod/amax/amin/mean modes
    (torch.scatter_reduce parity; paddle: put_along_axis(reduce=...))."""
    if reduce not in _SCATTER_MODES:
        raise ValueError(f"unknown reduce {reduce!r}; options "
                         f"{sorted(_SCATTER_MODES)}")
    return forward_op(
        "scatter_reduce",
        lambda v, idx, upd: torch.scatter_reduce(
            v, axis, idx.long(), upd.to(v.dtype), _SCATTER_MODES[reduce],
            include_self=include_self),
        [ensure_tensor(x), ensure_tensor(index), ensure_tensor(updates)])


def diag_indices(n: int, ndim: int = 2, name=None):
    """Indices of the main diagonal of an ``ndim``-d array of side n."""
    dev = torch_device()

    def impl():
        r = torch.arange(n, device=dev)
        return tuple(r for _ in range(ndim))
    return forward_op("diag_indices", impl, [], differentiable=False)


def unravel_index(indices, shape, name=None):
    """Flat index -> coordinate tuple (numpy.unravel_index parity)."""
    return forward_op("unravel_index",
                      lambda i: tuple(torch.unravel_index(i, tuple(shape))),
                      [ensure_tensor(indices)], differentiable=False)


def ravel_multi_index(multi_index, shape, mode="raise", name=None):
    """Coordinate arrays -> flat indices (coordinates clipped, as the
    reference's ``mode="clip"``)."""
    ts = [ensure_tensor(m) for m in multi_index]

    def impl(*ms):
        flat = torch.zeros_like(ms[0])
        for m, n in zip(ms, shape):
            flat = flat * int(n) + torch.clamp(m, 0, int(n) - 1)
        return flat
    return forward_op("ravel_multi_index", impl, ts, differentiable=False)


def true_divide(x, y, name=None):
    return forward_op("true_divide", torch.true_divide,
                      [ensure_tensor(x), ensure_tensor(y)])


def trunc_divide(x, y, name=None):
    """Division rounded toward zero (paddle.trunc_divide)."""
    return forward_op("trunc_divide", lambda a, b: torch.trunc(a / b),
                      [ensure_tensor(x), ensure_tensor(y)])


def divide_no_nan(x, y, name=None):
    """x/y with 0 where y == 0."""
    def impl(a, b):
        safe = torch.where(b == 0, torch.ones_like(b), b)
        q = a / safe
        return torch.where(b == 0, torch.zeros_like(q), q)
    return forward_op("divide_no_nan", impl,
                      [ensure_tensor(x), ensure_tensor(y)])


def bitwise_invert(x, name=None):
    return forward_op("bitwise_invert", torch.bitwise_not, [ensure_tensor(x)],
                      differentiable=False)


def _cum(f, axis):
    def impl(v):
        if axis is None:
            return f(v.reshape(-1), 0)
        return f(v, axes_arg(axis))
    return impl


def cumulative_sum(x, axis=None, name=None):
    return forward_op("cumulative_sum", _cum(torch.cumsum, axis),
                      [ensure_tensor(x)])


def cumulative_prod(x, axis=None, name=None):
    return forward_op("cumulative_prod", _cum(torch.cumprod, axis),
                      [ensure_tensor(x)])


def clip_by_norm(x, max_norm: float, name=None):
    """Scale ``x`` so its L2 norm is at most ``max_norm``."""
    def impl(v):
        f = v.to(torch.float32)
        n = torch.sqrt(torch.sum(f * f))
        scale = torch.clamp(max_norm / torch.clamp(n, min=1e-12), max=1.0)
        return (f * scale).to(v.dtype)
    return forward_op("clip_by_norm", impl, [ensure_tensor(x)])


def clip_by_global_norm(t_list, clip_norm: float, name=None):
    """Scale a LIST of tensors by the global-norm clip factor (ref:
    ClipGradByGlobalNorm)."""
    ts = [ensure_tensor(t) for t in t_list]

    def impl(*vs):
        g2 = sum(torch.sum(v.to(torch.float32) ** 2) for v in vs)
        gn = torch.sqrt(g2)
        scale = clip_norm / torch.clamp(gn, min=clip_norm)
        return tuple((v.to(torch.float32) * scale).to(v.dtype) for v in vs)
    return forward_op("clip_by_global_norm", impl, ts)


for _n, _f in (("index_copy", index_copy), ("scatter_add", scatter_add),
               ("scatter_reduce", scatter_reduce),
               ("diag_indices", diag_indices),
               ("unravel_index", unravel_index),
               ("ravel_multi_index", ravel_multi_index),
               ("true_divide", true_divide), ("trunc_divide", trunc_divide),
               ("divide_no_nan", divide_no_nan),
               ("bitwise_invert", bitwise_invert),
               ("cumulative_sum", cumulative_sum),
               ("cumulative_prod", cumulative_prod),
               ("clip_by_norm", clip_by_norm),
               ("clip_by_global_norm", clip_by_global_norm)):
    register_op(_n, _f, (_f.__doc__ or "").strip().split("\n")[0], public=_f)
__all__ += ["index_copy", "scatter_add", "scatter_reduce", "diag_indices",
            "unravel_index", "ravel_multi_index", "true_divide",
            "trunc_divide", "divide_no_nan", "bitwise_invert",
            "cumulative_sum", "cumulative_prod", "clip_by_norm",
            "clip_by_global_norm"]


# -- aliases + in-place random fills -----------------------------------------

def take_along_dim(x, indices, dim: int = 0, name=None):
    """torch-name alias of take_along_axis."""
    return forward_op("take_along_dim",
                      lambda v, i: torch.take_along_dim(v, i.long(), dim),
                      [ensure_tensor(x), ensure_tensor(indices)])


def permute_dims(x, axes, name=None):
    """Array-API name for transpose-with-permutation."""
    return forward_op("permute_dims",
                      lambda v: v.permute(*[int(a) for a in axes]),
                      [ensure_tensor(x)])


def relu_(x, name=None):
    """In-place ReLU (ref: paddle.nn.functional.relu_)."""
    t = ensure_tensor(x)
    out = forward_op("relu_", torch.relu, [t])
    t._rebind(out)
    return t


def _random_fill(name, sampler_doc, dist):
    def op(x, *args, name_=None, **kw):
        t = ensure_tensor(x)

        def impl(v):
            gen = generator(v.device)
            shp = v.shape
            if dist == "cauchy":
                loc = args[0] if args else kw.get("loc", 0.0)
                scale = args[1] if len(args) > 1 else kw.get("scale", 1.0)
                u = torch.empty(shp, device=v.device).uniform_(
                    1e-6, 1 - 1e-6, generator=gen)
                s = loc + scale * torch.tan(_math.pi * (u - 0.5))
            elif dist == "geometric":
                p = args[0] if args else kw.get("probs", 0.5)
                u = torch.empty(shp, device=v.device).uniform_(
                    1e-9, 1.0, generator=gen)
                s = torch.floor(torch.log(u) / _math.log1p(-p)) + 1
            else:  # log_normal
                mean = args[0] if args else kw.get("mean", 1.0)
                std = args[1] if len(args) > 1 else kw.get("std", 2.0)
                s = torch.exp(mean + std * torch.randn(
                    shp, generator=gen, device=v.device))
            return s.to(v.dtype)
        out = forward_op(name, impl, [t], differentiable=False)
        t._rebind(out)
        return t

    op.__name__ = name
    op.__qualname__ = name
    op.__doc__ = sampler_doc
    register_op(name, op, sampler_doc, differentiable=False,
                category="random", public=op)
    return op


cauchy_ = _random_fill(
    "cauchy_", "Fill in place with Cauchy(loc, scale) samples "
    "(ref: Tensor.cauchy_).", "cauchy")
geometric_ = _random_fill(
    "geometric_", "Fill in place with Geometric(p) samples "
    "(ref: Tensor.geometric_).", "geometric")
log_normal_ = _random_fill(
    "log_normal_", "Fill in place with LogNormal(mean, std) samples "
    "(ref: Tensor.log_normal_).", "log_normal")


for _n, _f in (("take_along_dim", take_along_dim),
               ("permute_dims", permute_dims), ("relu_", relu_)):
    register_op(_n, _f, (_f.__doc__ or "").strip().split("\n")[0], public=_f)
__all__ += ["take_along_dim", "permute_dims", "relu_", "cauchy_",
            "geometric_", "log_normal_"]


patch_methods([("cauchy_", cauchy_), ("geometric_", geometric_),
               ("log_normal_", log_normal_),
               ("take_along_dim", take_along_dim), ("relu_", relu_),
               ("xlogy", xlogy), ("vdot", vdot),
               ("float_power", float_power), ("narrow", narrow),
               ("fliplr", fliplr), ("flipud", flipud),
               ("swapdims", swapdims), ("scatter_add", scatter_add),
               ("index_copy", index_copy), ("scatter_reduce", scatter_reduce),
               ("exp2", exp2), ("erfc", erfc), ("igamma", igamma),
               ("igammac", igammac)])


# creation/conversion aliases (torch/numpy-style entry points)

def asarray(data, dtype=None, name=None):
    """numpy-style alias of to_tensor."""
    return to_tensor(data, dtype=dtype)


def as_tensor(data, dtype=None, name=None):
    """torch-style alias of to_tensor (no copy when already a Tensor of the
    right dtype)."""
    from ..core.dtype import canonical_dtype
    if isinstance(data, Tensor) and (dtype is None or data._value.dtype ==
                                     canonical_dtype(dtype)):
        return data
    return to_tensor(data, dtype=dtype)


def from_numpy(array, name=None):
    """torch-style alias of to_tensor for numpy arrays."""
    return to_tensor(np.asarray(array))


def histc(x, bins: int = 100, min=0, max=0, name=None):  # noqa: A002
    """torch-name alias of histogram (counts only, in the input's float
    dtype): bins are half-open but the last, which holds the upper edge;
    values outside [lo, hi] are not counted."""
    def impl(v):
        lo, hi = _data_range(v, min, max)
        edges = _linspace(lo, hi, bins + 1)
        flat = v.reshape(-1)
        idx = torch.searchsorted(edges, flat.contiguous(), right=True)
        idx = torch.where(flat == edges[-1], torch.full_like(idx, bins), idx)
        counts = torch.zeros(bins + 2, dtype=v.dtype, device=v.device)
        counts = counts.index_add(0, idx, torch.ones_like(flat))
        return counts[1:-1]
    return forward_op("histc", impl, [ensure_tensor(x)],
                      differentiable=False)


for _n, _f in (("asarray", asarray), ("as_tensor", as_tensor),
               ("from_numpy", from_numpy), ("histc", histc)):
    register_op(_n, _f, (_f.__doc__ or "").strip().split("\n")[0],
                differentiable=False, public=_f)
__all__ += ["asarray", "as_tensor", "from_numpy", "histc"]

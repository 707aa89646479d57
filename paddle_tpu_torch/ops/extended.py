"""Extended tensor-op surface — counterpart of
``paddle_tpu/ops/extended.py``.

``as_strided`` keeps the reference's contract: strides index the flat
contiguous buffer of the input's values, so the input is made contiguous
first (``torch.as_strided`` on a non-contiguous or offset view would read
its real storage instead). ``binomial`` / ``standard_gamma`` draw from the
port's per-device generator. The Hermitian FFT family (``hfft2``,
``hfftn`` and their inverses) lives with ``fft.py``, which it shares its
dtype rule with.
"""

from __future__ import annotations

import torch

from ._helpers import (binary_factory, ensure_tensor, forward_op,
                       patch_methods, register_op, unary_factory)
from .manipulation import index_sample  # noqa: F401
from .math import (cummin, increment, isneginf, isposinf,  # noqa: F401
                   isreal, logcumsumexp)
from .random import generator
from .special import _gammainc_p, _gammaincc_q

__all__ = [
    "slice_scatter", "polygamma", "logaddexp2", "frexp", "sgn",
    "nanquantile", "as_strided", "unfold_axis", "atleast_1d", "atleast_2d",
    "atleast_3d", "fix", "fmod", "msort", "rank", "reverse", "binomial",
    "standard_gamma", "cummin", "logcumsumexp", "isposinf", "isneginf",
    "isreal", "iscomplex", "index_sample", "strided_slice", "increment",
    "gammainc", "gammaincc", "hfft2", "ihfft2", "hfftn", "ihfftn",
    "segment_sum", "segment_mean", "segment_max", "segment_min",
]


# -- elementwise additions (factory-registered: swept) ------------------------

fix = unary_factory("fix", torch.trunc, "Round toward zero (alias of trunc).")
sgn = unary_factory("sgn", lambda x: torch.sgn(x) if x.is_complex()
                    else torch.sign(x),
                    "Sign; for complex inputs x/|x| (ref: paddle.sgn).")
iscomplex = unary_factory(
    "iscomplex", lambda x: torch.full(x.shape, x.is_complex(),
                                      device=x.device),
    "True where the dtype is complex (ref: paddle.is_complex semantics).")
logaddexp2 = binary_factory("logaddexp2", torch.logaddexp2,
                            "log2(2**x + 2**y), overflow-safe.")
fmod = binary_factory("fmod", torch.fmod,
                      "C-style remainder (sign follows the dividend).")
gammainc = binary_factory("gammainc", _gammainc_p,
                          "Regularized lower incomplete gamma P(a, x).")
gammaincc = binary_factory("gammaincc", _gammaincc_q,
                           "Regularized upper incomplete gamma Q(a, x).")


def polygamma(x, n: int = 1, name=None):
    """n-th derivative of digamma (ref: paddle.polygamma)."""
    def impl(v):
        if not v.is_floating_point():
            v = v.to(torch.get_default_dtype())
        return torch.special.polygamma(int(n), v)
    return forward_op("polygamma", impl, [ensure_tensor(x)])


def frexp(x, name=None):
    """(mantissa, exponent) with x = m * 2**e, 0.5 <= |m| < 1."""
    return forward_op("frexp", lambda v: tuple(torch.frexp(v)),
                      [ensure_tensor(x)])


register_op("frexp", lambda v: tuple(torch.frexp(v)),
            "Decompose into mantissa and exponent.", n_outputs=2,
            differentiable=False)


# -- manipulation ------------------------------------------------------------

def slice_scatter(x, value, axes, starts, ends, strides=None, name=None):
    """Write ``value`` into the slice of ``x`` selected by axes/starts/ends
    (ref: paddle.slice_scatter)."""
    axes = [int(a) for a in axes]
    strides = [1] * len(axes) if strides is None else [int(s) for s in strides]

    def impl(xv, vv):
        idx = [slice(None)] * xv.dim()
        for a, s, e, st in zip(axes, starts, ends, strides):
            idx[a] = slice(int(s), int(e), st)
        out = xv.clone()
        out[tuple(idx)] = vv.to(xv.dtype)
        return out

    return forward_op("slice_scatter", impl,
                      [ensure_tensor(x), ensure_tensor(value)])


def as_strided(x, shape, stride, offset: int = 0, name=None):
    """Strided re-indexing of the flat contiguous buffer (ref:
    paddle.as_strided; a copy, as the reference's gather is)."""
    shape = [int(s) for s in shape]
    stride = [int(s) for s in stride]
    return forward_op(
        "as_strided",
        lambda v: torch.as_strided(v.contiguous(), shape, stride,
                                   offset).clone(),
        [ensure_tensor(x)])


def unfold_axis(x, axis: int, size: int, step: int, name=None):
    """Sliding windows over one axis: shape[axis] -> (n_windows, size) as
    the LAST dim — ``Tensor.unfold``'s semantics (the top-level
    ``nn.functional.unfold`` is the unrelated im2col op)."""
    return forward_op("unfold_axis",
                      lambda v: v.unfold(int(axis), int(size), int(step)),
                      [ensure_tensor(x)])


patch_methods([("unfold", unfold_axis)])


def _atleast(name, f):
    def op(*xs, name=None):
        outs = [forward_op(name, f, [ensure_tensor(x)]) for x in xs]
        return outs[0] if len(outs) == 1 else outs
    op.__name__ = name
    return op


atleast_1d = _atleast("atleast_1d", torch.atleast_1d)
atleast_2d = _atleast("atleast_2d", torch.atleast_2d)
atleast_3d = _atleast("atleast_3d", torch.atleast_3d)


def msort(x, name=None):
    """Sort along the FIRST axis (ref: paddle.msort)."""
    return forward_op("msort", lambda v: torch.sort(v, dim=0).values,
                      [ensure_tensor(x)])


def rank(x, name=None):
    """Number of dimensions, as a 0-D int32 tensor (ref: paddle.rank)."""
    return forward_op(
        "rank", lambda v: torch.tensor(v.dim(), dtype=torch.int32,
                                       device=v.device),
        [ensure_tensor(x)], differentiable=False)


def reverse(x, axis, name=None):
    """Alias of flip (legacy paddle.reverse)."""
    from ._helpers import axes_arg
    ax = axes_arg(axis)
    ax = (ax,) if isinstance(ax, int) else ax
    return forward_op("reverse", lambda v: torch.flip(v, ax),
                      [ensure_tensor(x)])


def strided_slice(x, axes, starts, ends, strides, name=None):
    """ref: paddle.strided_slice (a negative stride walks backwards)."""
    def impl(v):
        for a, s, e, st in zip(axes, starts, ends, strides):
            a, s, e, st = int(a) % v.dim(), int(s), int(e), int(st)
            if st > 0:
                v = v[(slice(None),) * a + (slice(s, e, st),)]
            else:
                lo, hi, step = slice(s, e, st).indices(v.shape[a])
                v = v.index_select(a, torch.arange(lo, hi, step,
                                                   device=v.device))
        return v
    return forward_op("strided_slice", impl, [ensure_tensor(x)])


# -- random ------------------------------------------------------------------

def binomial(count, prob, name=None):
    """Sample Binomial(count, prob) elementwise (ref: paddle.binomial)."""
    def impl(cv, pv):
        cv, pv = torch.broadcast_tensors(cv.to(torch.float32),
                                         pv.to(torch.float32))
        return torch.binomial(cv.contiguous(), pv.contiguous(),
                              generator=generator(cv.device)).to(torch.int64)
    return forward_op("binomial", impl,
                      [ensure_tensor(count), ensure_tensor(prob)],
                      differentiable=False)


def standard_gamma(alpha, name=None):
    """Sample Gamma(alpha, 1) (ref: paddle.standard_gamma)."""
    def impl(av):
        av = av.to(torch.float32)
        return torch._standard_gamma(av, generator=generator(av.device))
    return forward_op("standard_gamma", impl, [ensure_tensor(alpha)],
                      differentiable=False)


# -- Hermitian FFT family (fft.py holds the transforms) ----------------------

def _hfft_member(name, default_axes, inverse):
    def op(x, s=None, axes=None, norm=None, name=None):
        from ..fft import _hfft_nd
        ax = axes if axes is not None else default_axes
        return forward_op(
            name, lambda v: _hfft_nd(v, s, ax, norm, inverse),
            [ensure_tensor(x)])
    op.__name__ = name
    op.__doc__ = (f"{name}: Hermitian FFT family (torch.fft semantics); "
                  f"honors s/axes/norm.")
    return op


hfft2 = _hfft_member("hfft2", (-2, -1), inverse=False)
ihfft2 = _hfft_member("ihfft2", (-2, -1), inverse=True)
hfftn = _hfft_member("hfftn", None, inverse=False)
ihfftn = _hfft_member("ihfftn", None, inverse=True)


# -- segment reductions (ref: paddle.geometric.segment_*) -------------------

def _segment_pool(d, s, n, pool):
    """Per-segment ``pool`` of the rows of ``d`` (``n`` segments; an empty
    segment gives 0 for sum and mean, and the dtype's lowest / highest
    value for max / min, as ``jax.ops.segment_max`` / ``_min``)."""
    s = s.long()
    shape = (n,) + tuple(d.shape[1:])
    idx = s.reshape((-1,) + (1,) * (d.dim() - 1)).expand_as(d)
    if pool in ("sum", "mean"):
        out = torch.zeros(shape, dtype=d.dtype, device=d.device
                          ).scatter_add(0, idx, d)
        if pool == "sum":
            return out
        cnt = torch.zeros(n, dtype=torch.float32, device=d.device
                          ).index_add(0, s, torch.ones(s.shape,
                                                       device=d.device))
        return out / torch.clamp(cnt, min=1.0).reshape(
            (-1,) + (1,) * (d.dim() - 1))
    lim = (torch.finfo if d.is_floating_point() else torch.iinfo)(d.dtype)
    fill = float("-inf") if d.is_floating_point() and pool == "max" else \
        float("inf") if d.is_floating_point() else \
        (lim.min if pool == "max" else lim.max)
    base = torch.full(shape, fill, dtype=d.dtype, device=d.device)
    return base.scatter_reduce(0, idx, d, "amax" if pool == "max" else "amin",
                               include_self=True)


def _segment(name, pool):
    def op(data, segment_ids, name=None):
        s = ensure_tensor(segment_ids)
        # the segment count is an output shape: one host read, as the
        # reference's
        num = int(s._value.max()) + 1 if s._value.numel() else 0
        return forward_op(name, lambda dv, sv: _segment_pool(dv, sv, num,
                                                             pool),
                          [ensure_tensor(data), s])
    op.__name__ = name
    return op


segment_sum = _segment("segment_sum", "sum")
segment_mean = _segment("segment_mean", "mean")
segment_max = _segment("segment_max", "max")
segment_min = _segment("segment_min", "min")


def nanquantile(x, q, axis=None, keepdim: bool = False, name=None):
    """Quantile ignoring NaNs (linear interpolation, as ``jnp``'s)."""
    from ._helpers import axes_arg
    ax = axes_arg(axis)

    def impl(v):
        qv = torch.as_tensor(q, dtype=v.dtype, device=v.device)
        if isinstance(ax, tuple):
            moved = torch.movedim(v, ax, tuple(range(-len(ax), 0)))
            flat = moved.reshape(moved.shape[:v.dim() - len(ax)] + (-1,))
            out = torch.nanquantile(flat, qv, dim=-1)
            if keepdim:
                for a in sorted(d % v.dim() for d in ax):
                    out = out.unsqueeze(a + (qv.dim()))
            return out
        return torch.nanquantile(v, qv, dim=ax, keepdim=keepdim)
    return forward_op("nanquantile", impl, [ensure_tensor(x)])

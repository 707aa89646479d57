"""Elementwise and reduction math ops — counterpart of
``paddle_tpu/ops/math.py`` (``python/paddle/tensor/math.py`` + ``stat.py``
in Paddle): every op is one torch function entering the dispatcher."""

from __future__ import annotations

import torch

from ..core.dtype import canonical_dtype, get_default_dtype
from ..core.tensor import Tensor
from ._helpers import (axes_arg, binary_factory, dims_of, ensure_tensor,
                       forward_op, patch_methods, unary_factory)

_sp = torch.special

# -- elementwise binary -----------------------------------------------------
add = binary_factory("add", torch.add)
subtract = binary_factory("subtract", torch.subtract)
multiply = binary_factory("multiply", torch.multiply)
divide = binary_factory("divide", torch.true_divide)
def _floor_divide(x, y):
    """Integers: ``torch.floor_divide``. Floats: the reference's formula
    (``jnp.floor_divide``), whose ``round`` gives both inputs a zero
    gradient where torch's op has no derivative."""
    if not (x.is_floating_point() or y.is_floating_point()):
        return torch.floor_divide(x, y)
    mod = torch.fmod(x, y)
    div = (x - mod) / y
    off = (mod != 0) & (torch.sign(y) != torch.sign(mod))
    return torch.round(torch.where(off, div - 1, div))


floor_divide = binary_factory("floor_divide", _floor_divide)
remainder = binary_factory("remainder", torch.remainder)
mod = remainder
floor_mod = remainder
pow_ = binary_factory("elementwise_pow", torch.pow)
maximum = binary_factory("maximum", torch.maximum)
minimum = binary_factory("minimum", torch.minimum)
fmax = binary_factory("fmax", torch.fmax)
fmin = binary_factory("fmin", torch.fmin)
atan2 = binary_factory("atan2", torch.atan2)
hypot = binary_factory("hypot", torch.hypot)
logaddexp = binary_factory("logaddexp", torch.logaddexp)
nextafter = binary_factory("nextafter", torch.nextafter)
copysign = binary_factory("copysign", torch.copysign)
# the reference's formula (``jnp.heaviside``): differentiable in y at x == 0
heaviside = binary_factory("heaviside", lambda x, y: torch.where(
    x < 0, torch.zeros_like(x),
    torch.where(x > 0, torch.ones_like(x), y.to(x.dtype))))
gcd = binary_factory("gcd", torch.gcd)
lcm = binary_factory("lcm", torch.lcm)
# a float exponent: torch's backward takes 2 ** e, zero for an integer e < 0
ldexp = binary_factory("ldexp", lambda x, e: torch.ldexp(x, e.to(
    x.dtype if x.is_floating_point() else torch.get_default_dtype())))
inner = binary_factory("inner", torch.inner)
outer = binary_factory("outer", lambda x, y: torch.outer(x.reshape(-1),
                                                         y.reshape(-1)))


def pow(x, y, name=None):  # noqa: A001 — Paddle public name
    return pow_(x, y)


def _float_in(f):
    """``f`` on a float value: integer inputs are cast to the default
    float dtype first, as ``jnp``'s transcendental functions promote."""
    def g(v):
        if not (v.is_floating_point() or v.is_complex()):
            v = v.to(get_default_dtype())
        return f(v)
    return g


# -- elementwise unary ------------------------------------------------------
exp = unary_factory("exp", _float_in(torch.exp))
expm1 = unary_factory("expm1", _float_in(torch.expm1))
log = unary_factory("log", _float_in(torch.log))
log2 = unary_factory("log2", _float_in(torch.log2))
log10 = unary_factory("log10", _float_in(torch.log10))
log1p = unary_factory("log1p", _float_in(torch.log1p))
sqrt = unary_factory("sqrt", _float_in(torch.sqrt))
rsqrt = unary_factory("rsqrt", _float_in(torch.rsqrt))
square = unary_factory("square", torch.square)
abs = unary_factory("abs", torch.abs)  # noqa: A001
sign = unary_factory("sign", torch.sign)
neg = unary_factory("neg", torch.neg)
negative = neg
reciprocal = unary_factory("reciprocal", _float_in(torch.reciprocal))
sin = unary_factory("sin", _float_in(torch.sin))
cos = unary_factory("cos", _float_in(torch.cos))
tan = unary_factory("tan", _float_in(torch.tan))
asin = unary_factory("asin", _float_in(torch.asin))
acos = unary_factory("acos", _float_in(torch.acos))
atan = unary_factory("atan", _float_in(torch.atan))
sinh = unary_factory("sinh", _float_in(torch.sinh))
cosh = unary_factory("cosh", _float_in(torch.cosh))
tanh = unary_factory("tanh", _float_in(torch.tanh))
asinh = unary_factory("asinh", _float_in(torch.asinh))
acosh = unary_factory("acosh", _float_in(torch.acosh))
atanh = unary_factory("atanh", _float_in(torch.atanh))
erf = unary_factory("erf", _float_in(_sp.erf))
erfinv = unary_factory("erfinv", _float_in(_sp.erfinv))
floor = unary_factory("floor", torch.floor)
ceil = unary_factory("ceil", torch.ceil)
round = unary_factory("round", torch.round)  # noqa: A001
trunc = unary_factory("trunc", torch.trunc)
frac = unary_factory("frac", lambda x: x - torch.trunc(x))
sigmoid = unary_factory("sigmoid", _float_in(torch.sigmoid))
digamma = unary_factory("digamma", _float_in(_sp.digamma))
lgamma = unary_factory("lgamma", _float_in(torch.lgamma))
gammaln = lgamma
i0 = unary_factory("i0", _float_in(_sp.i0))
i0e = unary_factory("i0e", _float_in(_sp.i0e))
i1 = unary_factory("i1", _float_in(_sp.i1))
i1e = unary_factory("i1e", _float_in(_sp.i1e))
deg2rad = unary_factory("deg2rad", _float_in(torch.deg2rad))
rad2deg = unary_factory("rad2deg", _float_in(torch.rad2deg))
conj = unary_factory("conj", lambda x: torch.conj(x).resolve_conj())
real = unary_factory("real", lambda x: torch.real(x) if x.is_complex() else x)
imag = unary_factory("imag", lambda x: torch.imag(x) if x.is_complex()
                     else torch.zeros_like(x))
angle = unary_factory("angle", _float_in(torch.angle))
isfinite = unary_factory("isfinite", torch.isfinite)
isinf = unary_factory("isinf", torch.isinf)
isnan = unary_factory("isnan", torch.isnan)
isneginf = unary_factory("isneginf", torch.isneginf)
isposinf = unary_factory("isposinf", torch.isposinf)
isreal = unary_factory("isreal", torch.isreal)


def logit(x, eps=None, name=None):
    x = ensure_tensor(x)
    return forward_op("logit", _logit_impl, [x], {"eps": eps})


def _logit_impl(x, eps):
    if eps is not None:
        x = torch.clamp(x, eps, 1.0 - eps)
    return torch.log(x / (1.0 - x))


def nan_to_num(x, nan=0.0, posinf=None, neginf=None, name=None):
    x = ensure_tensor(x)
    return forward_op("nan_to_num", torch.nan_to_num, [x],
                      {"nan": nan, "posinf": posinf, "neginf": neginf})


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None, name=None):
    """paddle.scale: out = scale*x + bias (or scale*(x+bias))."""
    x = ensure_tensor(x)
    s = scale._value if isinstance(scale, Tensor) else scale

    def impl(x):
        out = x * s + bias if bias_after_scale else (x + bias) * s
        return out.to(x.dtype)

    out = forward_op("scale", impl, [x])
    if act is not None:
        from ..nn import functional as F
        out = getattr(F, act)(out)
    return out


def clip(x, min=None, max=None, name=None):  # noqa: A002
    x = ensure_tensor(x)
    lo = min._value if isinstance(min, Tensor) else min
    hi = max._value if isinstance(max, Tensor) else max
    if lo is None and hi is None:
        return forward_op("clip", lambda v: v.clone(), [x])
    return forward_op("clip", lambda v: torch.clamp(v, lo, hi), [x])


def lerp(x, y, weight, name=None):
    x, y = ensure_tensor(x), ensure_tensor(y)
    if isinstance(weight, Tensor):
        return forward_op("lerp", lambda a, b, w: a + w * (b - a), [x, y, weight])
    return forward_op("lerp", lambda a, b: a + weight * (b - a), [x, y])


def cast(x, dtype):
    """Differentiable dtype cast (ref: paddle.cast / phi cast kernel)."""
    x = ensure_tensor(x)
    dt = canonical_dtype(dtype)
    return forward_op("cast", lambda v: v.to(dt), [x])


def increment(x, value=1.0, name=None):
    x = ensure_tensor(x)
    new = forward_op("increment", lambda v: v + value, [x])
    x._rebind(new)
    return x


def add_n(inputs, name=None):
    """Sum a list of tensors (ref: paddle.add_n / sum_op)."""
    ts = [ensure_tensor(t) for t in inputs]

    def impl(*vs):
        out = vs[0]
        for v in vs[1:]:
            out = out + v
        return out

    return forward_op("add_n", impl, ts)


def addmm(input, x, y, beta=1.0, alpha=1.0, name=None):  # noqa: A002
    return forward_op("addmm", lambda i, a, b: beta * i + alpha * (a @ b),
                      [ensure_tensor(input), ensure_tensor(x), ensure_tensor(y)])


def cross(x, y, axis=None, name=None):
    ax = -1 if axis is None else int(axis)
    return forward_op("cross", lambda a, b: torch.linalg.cross(a, b, dim=ax),
                      [ensure_tensor(x), ensure_tensor(y)])


def dot(x, y, name=None):
    # paddle.dot: 1-D/2-D batched inner product over last dim
    return forward_op("dot", lambda a, b: torch.sum(a * b, dim=-1),
                      [ensure_tensor(x), ensure_tensor(y)])


def trace(x, offset=0, axis1=0, axis2=1, name=None):
    return forward_op("trace",
                      lambda v: torch.diagonal(v, offset, axis1, axis2).sum(-1),
                      [ensure_tensor(x)])


def diagonal(x, offset=0, axis1=0, axis2=1, name=None):
    return forward_op("diagonal",
                      lambda v: torch.diagonal(v, offset, axis1, axis2),
                      [ensure_tensor(x)])


def kron(x, y, name=None):
    return forward_op("kron", torch.kron, [ensure_tensor(x), ensure_tensor(y)])


def diff(x, n=1, axis=-1, prepend=None, append=None, name=None):
    pre = prepend._value if isinstance(prepend, Tensor) else prepend
    app = append._value if isinstance(append, Tensor) else append
    return forward_op("diff",
                      lambda v: torch.diff(v, n=n, dim=axis, prepend=pre,
                                           append=app),
                      [ensure_tensor(x)])


# -- reductions -------------------------------------------------------------
def _over(v, dims, keepdim, f):
    """``f(v, dim, keepdim)`` applied one dim at a time (torch reductions
    that take a single dim), highest dim first."""
    for d in sorted((d % (v.dim() or 1) for d in dims), reverse=True):
        v = f(v, d, keepdim)
    return v


def _sum(v, dims, keepdim, dtype):
    if v.dtype == torch.bool and dtype is None:
        dtype = torch.int64
    return torch.sum(v, dim=dims, keepdim=keepdim, dtype=dtype) if dims \
        else v.to(dtype or v.dtype).clone()


def _mean(v, dims, keepdim, dtype=None):
    if not (v.is_floating_point() or v.is_complex()):
        v = v.to(get_default_dtype())
    return torch.mean(v, dim=dims, keepdim=keepdim) if dims else v.clone()


def _prod(v, dims, keepdim, dtype):
    if dtype is not None:
        v = v.to(dtype)
    return _over(v, dims, keepdim, lambda a, d, k: torch.prod(a, d, keepdim=k))


def _amax(v, dims, keepdim, dtype=None):
    return torch.amax(v, dim=dims, keepdim=keepdim) if dims else v.clone()


def _amin(v, dims, keepdim, dtype=None):
    return torch.amin(v, dim=dims, keepdim=keepdim) if dims else v.clone()


def _nansum(v, dims, keepdim, dtype):
    return torch.nansum(v, dim=dims, keepdim=keepdim, dtype=dtype)


def _nanmean(v, dims, keepdim, dtype=None):
    return torch.nanmean(v, dim=dims, keepdim=keepdim)


def _reduction(name: str, tfn, allow_dtype=False):
    def op(x, axis=None, keepdim=False, dtype=None, name=None):
        x = ensure_tensor(x)
        dt = canonical_dtype(dtype) if allow_dtype else None
        return forward_op(op.__name__,
                          lambda v: tfn(v, dims_of(v, axis), keepdim, dt), [x])

    op.__name__ = name
    op.__qualname__ = name
    op.__doc__ = f"Reduction {name} over `axis` (Paddle API parity)."
    return op


sum = _reduction("sum", _sum, allow_dtype=True)  # noqa: A001
mean = _reduction("mean", _mean)
prod = _reduction("prod", _prod, allow_dtype=True)
max = _reduction("max", _amax)  # noqa: A001
min = _reduction("min", _amin)  # noqa: A001
amax = _reduction("amax", _amax)
amin = _reduction("amin", _amin)
nansum = _reduction("nansum", _nansum, allow_dtype=True)
nanmean = _reduction("nanmean", _nanmean)


def _bool_reduce(name, f):
    def op(x, axis=None, keepdim=False, name=None):
        return forward_op(
            name, lambda v: _over(v.bool(), dims_of(v, axis), keepdim,
                                  lambda a, d, k: f(a, d, keepdim=k))
            if v.dim() else v.bool().clone(), [ensure_tensor(x)])
    op.__name__ = name
    return op


all = _bool_reduce("all", torch.all)  # noqa: A001
any = _bool_reduce("any", torch.any)  # noqa: A001


def count_nonzero(x, axis=None, keepdim=False, name=None):
    return forward_op("count_nonzero",
                      lambda v: _sum(v != 0, dims_of(v, axis), keepdim, None),
                      [ensure_tensor(x)])


def logsumexp(x, axis=None, keepdim=False, name=None):
    return forward_op("logsumexp",
                      lambda v: torch.logsumexp(v, dim=dims_of(v, axis),
                                                keepdim=keepdim),
                      [ensure_tensor(x)])


def std(x, axis=None, unbiased=True, keepdim=False, name=None):
    return forward_op("std",
                      lambda v: torch.std(v, dim=dims_of(v, axis),
                                          correction=int(unbiased),
                                          keepdim=keepdim),
                      [ensure_tensor(x)])


def var(x, axis=None, unbiased=True, keepdim=False, name=None):
    return forward_op("var",
                      lambda v: torch.var(v, dim=dims_of(v, axis),
                                          correction=int(unbiased),
                                          keepdim=keepdim),
                      [ensure_tensor(x)])


def _quantile(v, q, axis, keepdim, method, nan=False):
    f = torch.nanquantile if nan else torch.quantile
    q = q if isinstance(q, torch.Tensor) else torch.as_tensor(
        q, dtype=v.dtype, device=v.device)
    ax = axes_arg(axis)
    if ax is None:
        out = f(v.reshape(-1), q, dim=0, interpolation=method)
        if keepdim:
            out = out.reshape(tuple(q.shape) + (1,) * v.dim())
        return out
    if isinstance(ax, tuple):
        if len(ax) != 1:
            keep = [d for d in range(v.dim()) if d not in
                    {a % v.dim() for a in ax}]
            moved = v.permute(keep + sorted(a % v.dim() for a in ax))
            flat = moved.reshape(moved.shape[:len(keep)] + (-1,))
            out = f(flat, q, dim=-1, interpolation=method)
            if keepdim:
                shape = list(out.shape[:out.dim() - len(keep)]) + [
                    1 if d in {a % v.dim() for a in ax} else v.shape[d]
                    for d in range(v.dim())]
                out = out.reshape(shape)
            return out
        ax = ax[0]
    return f(v, q, dim=ax, keepdim=keepdim, interpolation=method)


def median(x, axis=None, keepdim=False, mode="avg", name=None):
    return forward_op("median",
                      lambda v: _quantile(v, 0.5, axis, keepdim, "linear"),
                      [ensure_tensor(x)])


def nanmedian(x, axis=None, keepdim=False, name=None):
    return forward_op("nanmedian",
                      lambda v: _quantile(v, 0.5, axis, keepdim, "linear",
                                          nan=True),
                      [ensure_tensor(x)])


def quantile(x, q, axis=None, keepdim=False, interpolation="linear", name=None):
    qv = q._value if isinstance(q, Tensor) else q
    return forward_op("quantile",
                      lambda v: _quantile(v, qv, axis, keepdim, interpolation),
                      [ensure_tensor(x)])


def cumsum(x, axis=None, dtype=None, name=None):
    x = ensure_tensor(x)
    dt = canonical_dtype(dtype)

    def impl(v):
        if axis is None:
            return torch.cumsum(v.reshape(-1), 0, dtype=dt)
        return torch.cumsum(v, int(axis), dtype=dt)

    return forward_op("cumsum", impl, [x])


def cumprod(x, dim=None, dtype=None, name=None):
    x = ensure_tensor(x)
    dt = canonical_dtype(dtype)

    def impl(v):
        if dim is None:
            return torch.cumprod(v.reshape(-1), 0, dtype=dt)
        return torch.cumprod(v, int(dim), dtype=dt)

    return forward_op("cumprod", impl, [x])


def _cum_extreme(name, better):
    def op(x, axis=None, dtype="int64", name_=None):
        x = ensure_tensor(x)
        idx_dt = canonical_dtype(dtype)

        def impl(v):
            ax = 0 if axis is None else int(axis) % v.dim()
            if axis is None:
                v = v.reshape(-1)
            vals, idxs = [], []
            best = bi = None
            for j, cur in enumerate(v.unbind(ax)):
                if best is None:
                    best, bi = cur, torch.zeros_like(cur, dtype=idx_dt)
                else:
                    # strict: the earliest index wins ties (Paddle)
                    take = better(cur, best)
                    best = torch.where(take, cur, best)
                    bi = torch.where(take, torch.full_like(bi, j), bi)
                vals.append(best)
                idxs.append(bi)
            return torch.stack(vals, ax), torch.stack(idxs, ax)

        return forward_op(name, impl, [x])

    op.__name__ = name
    return op


cummax = _cum_extreme("cummax", lambda b, a: b > a)
cummin = _cum_extreme("cummin", lambda b, a: b < a)


def logcumsumexp(x, axis=None, name=None):
    x = ensure_tensor(x)

    def impl(v):
        if axis is None:
            return torch.logcumsumexp(v.reshape(-1), 0)
        return torch.logcumsumexp(v, int(axis))

    return forward_op("logcumsumexp", impl, [x])


def stanh(x, scale_a=0.67, scale_b=1.7159, name=None):
    return forward_op("stanh", lambda v: scale_b * torch.tanh(scale_a * v),
                      [ensure_tensor(x)])


def multiplex(inputs, index, name=None):
    ts = [ensure_tensor(t) for t in inputs]
    idx = ensure_tensor(index)

    def impl(i, *vs):
        stacked = torch.stack(vs)  # [n, batch, ...]
        rows = torch.arange(vs[0].shape[0], device=vs[0].device)
        return stacked[i.reshape(-1).long(), rows]

    return forward_op("multiplex", impl, [idx] + ts)


# -- in-place variants ------------------------------------------------------
def _inplace(x: Tensor, fn, *args, **kwargs):
    new = fn(x, *args, **kwargs)
    x._rebind(new)
    return x


def _make_inplace(fn):
    def op(x, *args, **kwargs):
        return _inplace(x, fn, *args, **kwargs)
    op.__name__ = fn.__name__ + "_"
    return op


add_ = _make_inplace(add)
subtract_ = _make_inplace(subtract)
multiply_ = _make_inplace(multiply)
divide_ = _make_inplace(divide)
clip_ = _make_inplace(clip)
scale_ = _make_inplace(scale)
exp_ = _make_inplace(exp)
sqrt_ = _make_inplace(sqrt)
rsqrt_ = _make_inplace(rsqrt)
reciprocal_ = _make_inplace(reciprocal)
round_ = _make_inplace(round)
floor_ = _make_inplace(floor)
ceil_ = _make_inplace(ceil)
tanh_ = _make_inplace(tanh)
abs_ = _make_inplace(abs)
sin_ = _make_inplace(sin)
cos_ = _make_inplace(cos)
neg_ = _make_inplace(neg)


# -- dunders + method patching ---------------------------------------------
def _rsub(x, y):
    return subtract(y, x)


def _rdiv(x, y):
    return divide(y, x)


def _rpow(x, y):
    return pow_(y, x)


def _rfloordiv(x, y):
    return floor_divide(y, x)


def _rmod(x, y):
    return remainder(y, x)


def _matmul_method(x, y):
    from . import linalg
    return linalg.matmul(x, y)


def _rmatmul_method(x, y):
    from . import linalg
    return linalg.matmul(y, x)


patch_methods([
    ("__add__", lambda s, o: add(s, o)), ("__radd__", lambda s, o: add(o, s)),
    ("__sub__", lambda s, o: subtract(s, o)), ("__rsub__", _rsub),
    ("__mul__", lambda s, o: multiply(s, o)), ("__rmul__", lambda s, o: multiply(o, s)),
    ("__truediv__", lambda s, o: divide(s, o)), ("__rtruediv__", _rdiv),
    ("__floordiv__", lambda s, o: floor_divide(s, o)), ("__rfloordiv__", _rfloordiv),
    ("__mod__", lambda s, o: remainder(s, o)), ("__rmod__", _rmod),
    ("__pow__", lambda s, o: pow_(s, o)), ("__rpow__", _rpow),
    ("__neg__", lambda s: neg(s)), ("__abs__", lambda s: abs(s)),
    ("__matmul__", _matmul_method), ("__rmatmul__", _rmatmul_method),
    ("__pos__", lambda s: s),
    ("add", add), ("subtract", subtract), ("multiply", multiply), ("divide", divide),
    ("floor_divide", floor_divide), ("remainder", remainder), ("mod", remainder),
    ("pow", pow), ("maximum", maximum), ("minimum", minimum), ("fmax", fmax),
    ("fmin", fmin), ("atan2", atan2),
    ("exp", exp), ("log", log), ("log2", log2), ("log10", log10), ("log1p", log1p),
    ("sqrt", sqrt), ("rsqrt", rsqrt), ("square", square), ("abs", abs), ("sign", sign),
    ("reciprocal", reciprocal), ("sin", sin), ("cos", cos), ("tan", tan),
    ("tanh", tanh), ("sigmoid", sigmoid), ("erf", erf), ("erfinv", erfinv),
    ("floor", floor), ("ceil", ceil), ("round", round), ("trunc", trunc),
    ("frac", frac), ("digamma", digamma), ("lgamma", lgamma),
    ("isfinite", isfinite), ("isinf", isinf), ("isnan", isnan),
    ("scale", scale), ("clip", clip), ("lerp", lerp), ("cast", cast),
    ("astype", cast), ("nan_to_num", nan_to_num), ("logit", logit),
    ("sum", sum), ("mean", mean), ("prod", prod), ("max", max), ("min", min),
    ("amax", amax), ("amin", amin), ("all", all), ("any", any),
    ("logsumexp", logsumexp), ("std", std), ("var", var), ("median", median),
    ("quantile", quantile), ("cumsum", cumsum), ("cumprod", cumprod),
    ("logcumsumexp", logcumsumexp), ("count_nonzero", count_nonzero),
    ("nansum", nansum), ("nanmean", nanmean),
    ("dot", dot), ("cross", cross), ("trace", trace), ("diagonal", diagonal),
    ("kron", kron), ("inner", inner), ("outer", outer), ("addmm", addmm),
    ("diff", diff), ("neg", neg),
    ("add_", add_), ("subtract_", subtract_), ("multiply_", multiply_),
    ("divide_", divide_), ("clip_", clip_), ("scale_", scale_), ("exp_", exp_),
    ("sqrt_", sqrt_), ("rsqrt_", rsqrt_), ("reciprocal_", reciprocal_),
    ("round_", round_), ("floor_", floor_), ("ceil_", ceil_), ("tanh_", tanh_),
    ("abs_", abs_), ("sin_", sin_), ("cos_", cos_), ("neg_", neg_),
])

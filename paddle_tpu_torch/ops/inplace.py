"""In-place op variants (``add_``, ``tanh_``, ...) — counterpart of
``paddle_tpu/ops/inplace.py``.

As in the reference, "in place" computes out of place and rebinds the
Tensor's value (``Tensor._rebind``): that bumps ``_version``, so the value
watch of a program capture (``core/tensor.py:_note_write``, which
``jit/trace.py`` installs) sees the write, and autograd keeps flowing
through the new value while every earlier op's saved tensors stay
untouched. Every variant is registered in OP_REGISTRY under the base op's
function; a Tensor method is added where the class has none yet (the
hand-written ones of ``math.py`` / ``manipulation.py`` stay).
"""

from __future__ import annotations

import torch

from ..core.dispatch import OP_REGISTRY, register_op
from ..core.tensor import Tensor as _T
from ._helpers import ensure_tensor, forward_op

__all__ = []  # populated below


def _make(base_name: str, base_fn):
    def op(x, *args, **kwargs):
        out = base_fn(x, *args, **kwargs)
        x._rebind(out)
        return x

    op.__name__ = base_name + "_"
    op.__qualname__ = op.__name__
    op.__doc__ = (f"In-place variant of ``{base_name}`` (rebinds the "
                  f"tensor's value; ref: paddle.Tensor.{base_name}_).")
    base = OP_REGISTRY.get(base_name)
    register_op(base_name + "_",
                base.fn if base else (lambda v: v),
                f"In-place variant of {base_name}.",
                differentiable=base.differentiable if base else True)
    return op


# base-op names whose Paddle API includes an in-place twin (the reference's
# list); each must exist on the assembled surface
_INPLACE_BASES = [
    "acos", "acosh", "asin", "asinh", "atan", "atanh", "atan2",
    "cos", "cosh", "sin", "sinh", "tan", "tanh",
    "erf", "erfinv", "exp", "expm1", "log", "log10", "log1p", "log2",
    "logit", "sigmoid", "square", "trunc", "frac", "digamma", "lgamma",
    "gammaln", "i0", "nan_to_num", "copysign", "hypot", "ldexp", "lerp",
    "bitwise_and", "bitwise_or", "bitwise_xor", "bitwise_not",
    "logical_and", "logical_or", "logical_xor", "logical_not",
    "greater_equal", "greater_than", "less_equal", "less_than", "not_equal",
    "remainder", "mod", "floor_divide",
    "tril", "triu", "masked_fill", "index_fill", "index_put", "index_add",
    "put_along_axis", "renorm",
    "add", "subtract", "multiply", "divide", "pow", "clip", "ceil", "floor",
    "round", "rsqrt", "sqrt", "reciprocal", "neg", "scale", "flatten",
    "reshape", "squeeze", "unsqueeze", "flip", "cumsum", "cumprod",
    "exp2", "expit", "erfc", "maximum", "minimum", "fmax", "fmin",
    "heaviside", "deg2rad", "rad2deg", "sinc", "xlogy",
    "sort", "sgn", "igamma", "igammac", "polygamma", "index_copy",
    "scatter_add", "scatter_reduce", "true_divide", "trunc_divide",
    "divide_no_nan", "bitwise_invert", "masked_scatter",
    "take_along_dim", "narrow", "clip_by_norm",
    "fill_diagonal_tensor",
]


def _populate():
    from .. import ops as _ops

    made, missing = {}, []
    for base in _INPLACE_BASES:
        fn = getattr(_ops, base, None)
        if fn is None:
            missing.append(base)
            continue
        made[base + "_"] = _make(base, fn)
    if missing:
        raise ImportError(
            f"inplace generation: base ops missing from the surface: "
            f"{missing} (add them or drop from _INPLACE_BASES)")
    return made


_generated = _populate()
globals().update(_generated)
__all__ = sorted(_generated)

for _mname, _mfn in _generated.items():
    if not hasattr(_T, _mname):
        setattr(_T, _mname, _mfn)


def _fill(x, value):
    t = ensure_tensor(x)
    t._rebind(forward_op("fill", lambda v: torch.full_like(v, value), [t]))
    return t


def fill_(x, value, name=None):
    """Set every element to ``value`` (ref: paddle.Tensor.fill_)."""
    return _fill(x, value)


def zero_(x, name=None):
    """Set every element to 0 (ref: paddle.Tensor.zero_)."""
    return _fill(x, 0)


def fill_diagonal_(x, value, offset: int = 0, wrap: bool = False, name=None):
    """Write ``value`` onto the (offset) diagonal; ``wrap`` repeats the
    diagonal down tall matrices, numpy-style (ref: Tensor.fill_diagonal_)."""
    t = ensure_tensor(x)

    def impl(v):
        H, W = v.shape[-2], v.shape[-1]
        r0, c0 = (0, offset) if offset >= 0 else (-offset, 0)
        n = max(0, min(H - r0, W - c0))
        rows = torch.arange(r0, r0 + n, device=v.device)
        cols = torch.arange(c0, c0 + n, device=v.device)
        if wrap and offset == 0 and H > W:
            # numpy's wrap: the diagonal restarts every W + 1 rows
            starts = range(0, H, W + 1)
            rows = torch.cat([torch.arange(s, s + min(W, H - s),
                                           device=v.device) for s in starts])
            cols = torch.cat([torch.arange(min(W, H - s), device=v.device)
                              for s in starts])
        out = v.clone()
        out[..., rows, cols] = value
        return out

    t._rebind(forward_op("fill_diagonal", impl, [t]))
    return t


register_op("fill", lambda v: v * 0, "Fill with a scalar (in place).")
register_op("zero_", lambda v: v * 0, "Zero the tensor (in place).")
register_op("fill_diagonal", lambda v: v, "Write the diagonal (in place).")
__all__ += ["fill_", "zero_", "fill_diagonal_"]

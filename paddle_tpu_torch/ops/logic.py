"""Comparison, logical and bitwise ops — counterpart of
``paddle_tpu/ops/logic.py``."""

from __future__ import annotations

import torch

from ..core.tensor import Tensor
from ._helpers import binary_factory, ensure_tensor, forward_op, patch_methods, unary_factory

equal = binary_factory("equal", torch.eq)
not_equal = binary_factory("not_equal", torch.ne)
less_than = binary_factory("less_than", torch.lt)
less_equal = binary_factory("less_equal", torch.le)
greater_than = binary_factory("greater_than", torch.gt)
greater_equal = binary_factory("greater_equal", torch.ge)
logical_and = binary_factory("logical_and", torch.logical_and)
logical_or = binary_factory("logical_or", torch.logical_or)
logical_xor = binary_factory("logical_xor", torch.logical_xor)
logical_not = unary_factory("logical_not", torch.logical_not)
bitwise_and = binary_factory("bitwise_and", torch.bitwise_and)
bitwise_or = binary_factory("bitwise_or", torch.bitwise_or)
bitwise_xor = binary_factory("bitwise_xor", torch.bitwise_xor)
bitwise_not = unary_factory("bitwise_not", torch.bitwise_not)
bitwise_left_shift = binary_factory("bitwise_left_shift", torch.bitwise_left_shift)
bitwise_right_shift = binary_factory("bitwise_right_shift",
                                     torch.bitwise_right_shift)


def equal_all(x, y, name=None) -> Tensor:
    return forward_op("equal_all",
                      lambda a, b: torch.tensor(a.shape == b.shape and
                                                bool(torch.equal(a, b)),
                                                device=a.device),
                      [ensure_tensor(x), ensure_tensor(y)], differentiable=False)


def allclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None) -> Tensor:
    return forward_op("allclose",
                      lambda a, b: torch.tensor(
                          torch.allclose(a, b.to(a.dtype), rtol=rtol, atol=atol,
                                         equal_nan=equal_nan), device=a.device),
                      [ensure_tensor(x), ensure_tensor(y)], differentiable=False)


def isclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None) -> Tensor:
    return forward_op("isclose",
                      lambda a, b: torch.isclose(a, b.to(a.dtype), rtol=rtol,
                                                 atol=atol, equal_nan=equal_nan),
                      [ensure_tensor(x), ensure_tensor(y)], differentiable=False)


def is_empty(x, name=None) -> Tensor:
    x = ensure_tensor(x)
    return Tensor(torch.tensor(x.size == 0, device=x._value.device))


def is_tensor(x) -> bool:
    return isinstance(x, Tensor)


patch_methods([
    ("__eq__", lambda s, o: equal(s, o)), ("__ne__", lambda s, o: not_equal(s, o)),
    ("__lt__", lambda s, o: less_than(s, o)), ("__le__", lambda s, o: less_equal(s, o)),
    ("__gt__", lambda s, o: greater_than(s, o)),
    ("__ge__", lambda s, o: greater_equal(s, o)),
    ("__and__", lambda s, o: bitwise_and(s, o)),
    ("__or__", lambda s, o: bitwise_or(s, o)),
    ("__xor__", lambda s, o: bitwise_xor(s, o)),
    ("__invert__", lambda s: bitwise_not(s)),
    ("equal", equal), ("not_equal", not_equal), ("less_than", less_than),
    ("less_equal", less_equal), ("greater_than", greater_than),
    ("greater_equal", greater_equal), ("logical_and", logical_and),
    ("logical_or", logical_or), ("logical_xor", logical_xor),
    ("logical_not", logical_not), ("bitwise_and", bitwise_and),
    ("bitwise_or", bitwise_or), ("bitwise_xor", bitwise_xor),
    ("bitwise_not", bitwise_not), ("equal_all", equal_all), ("allclose", allclose),
    ("isclose", isclose),
])

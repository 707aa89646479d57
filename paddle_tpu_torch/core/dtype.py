"""Dtype system — counterpart of ``paddle_tpu/core/dtype.py``.

The public dtype objects are ``torch.dtype`` instances (``paddle.float32 is
torch.float32``). Anything that crosses to the JAX package is compared by
name (:func:`dtype_name`): a string, a numpy dtype and a torch dtype of the
same type all canonicalize to the same ``torch.dtype``.
"""

from __future__ import annotations

import torch

__all__ = [
    "dtype", "float16", "bfloat16", "float32", "float64", "int8", "int16",
    "int32", "int64", "uint8", "bool_", "complex64", "complex128",
    "canonical_dtype", "dtype_name", "get_default_dtype", "set_default_dtype",
    "is_floating_point_dtype", "promote_types", "finfo", "iinfo",
]

float16 = torch.float16
bfloat16 = torch.bfloat16
float32 = torch.float32
float64 = torch.float64
int8 = torch.int8
int16 = torch.int16
int32 = torch.int32
int64 = torch.int64
uint8 = torch.uint8
bool_ = torch.bool
complex64 = torch.complex64
complex128 = torch.complex128

dtype = torch.dtype  # the "type of a dtype", for isinstance checks

_BY_NAME = {
    "float16": float16, "bfloat16": bfloat16, "float32": float32,
    "float64": float64, "int8": int8, "int16": int16, "int32": int32,
    "int64": int64, "uint8": uint8, "bool": bool_, "complex64": complex64,
    "complex128": complex128,
    # the reference's aliases
    "float": float32, "double": float64, "half": float16, "bf16": bfloat16,
    "fp16": float16, "fp32": float32, "fp64": float64, "int": int32,
    "long": int64, "bool_": bool_,
}

_FLOATING = {float16, bfloat16, float32, float64}


def canonical_dtype(d):
    """str / torch dtype / numpy dtype / python type -> ``torch.dtype``
    (``None`` stays ``None``)."""
    if d is None or isinstance(d, torch.dtype):
        return d
    if d is float:
        return get_default_dtype()
    if d is int:
        return int64
    if d is bool:
        return bool_
    name = d.lower() if isinstance(d, str) else getattr(d, "name", None)
    if name is None:
        import numpy as np
        name = np.dtype(d).name
    if name not in _BY_NAME:
        raise TypeError(f"unsupported dtype {d!r}")
    return _BY_NAME[name]


def dtype_name(d) -> str:
    """The dtype's name as the JAX package prints it (``"float32"``)."""
    return str(canonical_dtype(d)).replace("torch.", "")


_default_dtype = float32


def get_default_dtype():
    return _default_dtype


def set_default_dtype(d):
    global _default_dtype
    d = canonical_dtype(d)
    if d not in _FLOATING:
        raise TypeError(f"default dtype must be floating, got {d}")
    _default_dtype = d


def is_floating_point_dtype(d) -> bool:
    return canonical_dtype(d) in _FLOATING


def promote_types(a, b):
    return torch.promote_types(canonical_dtype(a), canonical_dtype(b))


def finfo(d):
    return torch.finfo(canonical_dtype(d))


def iinfo(d):
    return torch.iinfo(canonical_dtype(d))

"""TensorArray ops — counterpart of ``paddle_tpu/ops/array.py``
(``create_array`` / ``array_read`` / ``array_write`` / ``array_length``
and ``tensor_array_to_tensor``). The eager TensorArray is a Python list,
as in the reference's dygraph mode; ``tensor_array_to_tensor`` stacks or
concatenates it into one Tensor."""

from __future__ import annotations

import numpy as np

from ..core.tensor import to_tensor
from ._helpers import Tensor, ensure_tensor

__all__ = ["create_array", "array_write", "array_read", "array_length",
           "tensor_array_to_tensor"]


def _index(i) -> int:
    return int(i.item()) if isinstance(i, Tensor) else int(i)


def create_array(dtype="float32", initialized_list=None, name=None):
    """New TensorArray (a list; ref: paddle.tensor.create_array)."""
    return [ensure_tensor(t) for t in (initialized_list or [])]


def array_write(x, i, array=None, name=None):
    """Write ``x`` at position ``i`` (extends the array as a write past
    the end does)."""
    if array is None:
        array = []
    idx = _index(i)
    while len(array) <= idx:
        array.append(None)
    array[idx] = ensure_tensor(x)
    return array


def array_read(array, i, name=None):
    """Read position ``i``."""
    return array[_index(i)]


def array_length(array, name=None):
    """Length of the array as an int64 Tensor."""
    return to_tensor(np.int64(len(array)))


def tensor_array_to_tensor(array, axis: int = 0, use_stack: bool = False,
                           name=None):
    """Stack or concat the array into one Tensor + per-element sizes (ref:
    tensor_array_to_tensor_op); the sizes land on the output's device."""
    ts = [ensure_tensor(t) for t in array]
    if use_stack:
        from .manipulation import stack
        out = stack(ts, axis=axis)
        sizes = np.ones(len(ts), np.int64)
    else:
        from .manipulation import concat
        out = concat(ts, axis=axis)
        sizes = np.asarray([int(t.shape[axis]) for t in ts], np.int64)
    return out, to_tensor(sizes, place=out.place)

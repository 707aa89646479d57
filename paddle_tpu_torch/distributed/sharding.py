"""Splitting a tensor over a serving placement — counterpart of
``shard_dim_spec`` in ``paddle_tpu/distributed/sharding.py``.

Where the JAX package returns a ``PartitionSpec`` and lets ``device_put``
lay the shards out, the port cuts the tensor itself: one contiguous,
separately allocated copy per placement entry (a strided view would be
refused by the CUDA kernels, which take contiguous operands). The dim's
divisibility is part of the contract and is checked first, with the
reference's structured errors.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

__all__ = ["shard_dim_spec", "shard_tensor", "unshard"]


def shard_dim_spec(shape, n: int, axis: str, dim: int,
                   name: str = "tensor") -> int:
    """Check that ``dim`` of ``shape`` splits evenly over ``n`` shards of
    mesh axis ``axis`` and return it normalized (non-negative). An
    out-of-range ``dim`` and an indivisible size raise the reference's
    ``ValueError``\\ s, naming the tensor, the axis and the size."""
    n = int(n)
    if not -len(shape) <= dim < len(shape):
        raise ValueError(
            f"cannot shard {name}: dim {dim} is out of range for shape "
            f"{tuple(shape)} (rank {len(shape)})")
    d = dim % len(shape)
    if shape[d] % n or shape[d] == 0:
        raise ValueError(
            f"cannot shard {name}: dim {d} (size {shape[d]} of shape "
            f"{tuple(shape)}) is not divisible by mesh axis {axis!r} "
            f"(size {n})")
    return d


def shard_tensor(t: torch.Tensor, devices: Sequence[torch.device], dim: int,
                 name: str = "tensor", axis: str = "tp"
                 ) -> Tuple[torch.Tensor, ...]:
    """``t`` cut on ``dim`` into ``len(devices)`` equal parts, part ``s``
    a contiguous copy of its own on ``devices[s]`` (in shard order)."""
    d = shard_dim_spec(t.shape, len(devices), axis, dim, name)
    parts = torch.chunk(t, len(devices), dim=d)
    return tuple(torch.empty(p.shape, dtype=p.dtype, device=dev).copy_(p)
                 for p, dev in zip(parts, devices))


def unshard(parts: Sequence[torch.Tensor], dim: int,
            device=None) -> torch.Tensor:
    """The inverse of :func:`shard_tensor`: the parts concatenated on
    ``dim`` in shard order, on ``device`` (default: part 0's)."""
    dev = parts[0].device if device is None else device
    return torch.cat([p.to(dev) for p in parts], dim=dim)

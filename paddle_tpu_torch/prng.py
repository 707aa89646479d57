"""Counter-based PRNG — the threefry2x32 draws of ``jax.random``, in torch.

The serving sampler draws token ``t`` of a request with the key
``fold_in(seed_key(seed), t)`` through ``jax.random.categorical``. To give
the same token streams, the port computes the same random bits:

* :func:`threefry2x32` — the Threefry-2x32 hash (20 rounds, rotations
  (13, 15, 26, 6) and (17, 29, 16, 24), the key injected every 4 rounds
  with the schedule constant ``0x1BD11BDA``), as ``jax._src.prng``'s
  ``_threefry2x32_lowering``.
* :func:`fold_in` — ``jax.random.fold_in`` on a raw ``uint32[2]`` key and a
  uint32 datum: the hash of the counter pair ``(0, data)``.
* :func:`split` — ``jax.random.split`` with ``jax_threefry_partitionable``
  on (the default): key ``i`` of the split is the hash of the counter
  ``(0, i)``, i.e. ``fold_in(key, i)``.
* :func:`random_bits32` — ``jax.random.bits`` with
  ``jax_threefry_partitionable`` on (the default): the counters are the
  high and low 32 bits of the flat index over ``shape``; the bits are
  ``out0 ^ out1``.
* :func:`uniform`, :func:`gumbel`, :func:`categorical` — ``_uniform``,
  ``_gumbel`` (mode ``"low"``) and ``categorical`` (argmax of Gumbel
  noise plus logits, the first index on ties).

torch has no ``uint32`` arithmetic on the CPU, so keys, counters and bits
are ``int64`` tensors holding uint32 values, masked to 32 bits after every
add and rotate. Every function takes a key of shape ``[..., 2]``: its
leading dimensions are a batch, each key drawing over its own ``shape``
(``jax.vmap`` over keys), and the result has shape ``key.shape[:-1] +
shape``. Everything runs on the key's device.

The bits and uniforms equal JAX's bit for bit. The Gumbel noise goes
through ``log`` twice, and ``torch.log`` and XLA's ``log`` may differ by
one ulp, so the noise agrees to about 1e-6 and a sampled token can only
differ where the two largest values of ``noise + logits`` lie that close.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

__all__ = ["threefry2x32", "fold_in", "split", "random_bits32", "uniform",
           "gumbel", "categorical"]

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA
_FLOAT32_ONE_BITS = 0x3F800000
_TINY = float(np.finfo(np.float32).tiny)


def _rotl(x, d: int):
    return ((x << d) & _MASK) | (x >> (32 - d))


def threefry2x32(k0, k1, x0, x1):
    """The Threefry-2x32 hash of the counter pair ``(x0, x1)`` under the
    key ``(k0, k1)``: int64 tensors of uint32 values, broadcast together.
    Returns the pair ``(y0, y1)``."""
    ks = (k0, k1, k0 ^ k1 ^ _KS_PARITY)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def fold_in(key, data):
    """``jax.random.fold_in`` for raw keys ``[..., 2]`` and uint32 data
    (an int or a tensor broadcast against ``key.shape[:-1]``): the hash
    of ``(data >> 32 = 0, data)``. Returns keys ``[..., 2]``."""
    data = torch.as_tensor(data, dtype=torch.int64,
                           device=key.device) & _MASK
    y0, y1 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(data),
                          data)
    return torch.stack(torch.broadcast_tensors(y0, y1), dim=-1)


def split(key, num: int = 2):
    """``jax.random.split(key, num)`` for raw keys ``[..., 2]`` (the
    partitionable form): ``[..., num, 2]``, key ``i`` the hash of the
    counter ``(0, i)``."""
    idx = torch.arange(int(num), dtype=torch.int64, device=key.device)
    return fold_in(key[..., None, :], idx)


def random_bits32(key, shape: Sequence[int]):
    """``jax.random.bits(key, shape, uint32)`` for each key of ``[..., 2]``
    (the partitionable form) -> int64 ``key.shape[:-1] + shape``."""
    shape = tuple(int(s) for s in shape)
    idx = torch.arange(math.prod(shape), dtype=torch.int64,
                       device=key.device).reshape(shape)
    lead = key.shape[:-1] + (1,) * len(shape)
    y0, y1 = threefry2x32(key[..., 0].reshape(lead),
                          key[..., 1].reshape(lead), idx >> 32, idx & _MASK)
    return y0 ^ y1


def uniform(key, shape: Sequence[int], minval: float = _TINY,
            maxval: float = 1.0):
    """``jax.random.uniform`` at float32: 23 random mantissa bits under the
    exponent of 1.0, minus 1, scaled into ``[minval, maxval)`` and clipped
    below at ``minval``."""
    bits = random_bits32(key, shape)
    one = ((bits >> 9) | _FLOAT32_ONE_BITS).to(torch.int32)
    floats = one.view(torch.float32) - 1.0
    # float32 constants made on the key's device (a fill, not a blocking
    # host-to-device copy)
    lo = torch.full((), float(np.float32(minval)), device=key.device)
    span = torch.full((), float(np.float32(maxval) - np.float32(minval)),
                      device=key.device)
    return torch.maximum(lo, floats * span + lo)


def gumbel(key, shape: Sequence[int]):
    """``jax.random.gumbel`` (mode ``"low"``) at float32:
    ``-log(-log(u))`` with ``u`` uniform in ``[tiny, 1)``."""
    return -torch.log(-torch.log(uniform(key, shape)))


def categorical(key, logits):
    """``jax.random.categorical(key, logits)`` over the last axis: the
    argmax of Gumbel noise plus ``logits``. ``key`` is ``[..., 2]`` with
    ``key.shape[:-1]`` a prefix of ``logits.shape[:-1]``; each key draws
    the noise over the rest of ``logits``'s shape (one key for a whole
    ``[B, V]`` block, or one key per row). Returns int64 indices."""
    noise = gumbel(key, logits.shape[key.dim() - 1:])
    return torch.argmax(noise + logits, dim=-1)

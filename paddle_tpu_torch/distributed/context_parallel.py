"""Context parallelism: Ulysses (an all-to-all over ``sep``) and ring
attention — counterpart of ``paddle_tpu/distributed/context_parallel.py``.

One process drives every rank of the ``sep`` group (single-controller), as
the JAX package does over its mesh. The raw functions take the sequence
shards as a LIST of per-rank tensors, rank ``r``'s ``[B, S/n, H, D]`` on
its own device (the per-rank list form of :mod:`.collective`), and return
the outputs in the same form; :func:`sep_parallel_attention` takes FULL
``[B, S, H, D]`` tensors, cuts the sequence over a mesh's ``sep`` group
and joins the result on q's device.

* **Ulysses** swaps the sequence shard for a head shard with
  :func:`~.collective.alltoall_ranks` (``lax.all_to_all``), runs
  full-length attention on the local heads and swaps back.
* **Ring attention**: rank ``i`` attends its own block (the causal
  diagonal), then the K/V block of rank ``j`` that ``i - j`` rotations
  bring it (a ``ppermute`` becomes a ``.to()`` onto rank ``i``'s device),
  merging each block by its lse: ``lse' = logaddexp(lse, lse_b)``, ``out'
  = out e^{lse - lse'} + out_b e^{lse_b - lse'}`` (weight 0 where
  ``lse_b`` is ``-inf``). Under ``causal`` the JAX ring also computes the
  later blocks (``j > i``) and weights them 0; here they are skipped, so
  rank ``i`` runs ``i + 1`` attention calls and the group ``n (n + 1) /
  2`` (``n * n`` without ``causal``), each with its backward. The merge
  differentiates through every block's lse: the flash kernels' Function
  takes ``lse``'s cotangent (``kernels.flash_attention``), so the
  gradient through the kernels is exact.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import torch

from ..kernels.flash_attention import flash_attention_with_lse
from .collective import alltoall_ranks
from .topology import ParallelAxis, get_hybrid_communicate_group

__all__ = ["ulysses_alltoall", "ulysses_attention", "ring_flash_attention",
           "sep_parallel_attention", "cp_attention"]


def ulysses_alltoall(xs: Sequence[torch.Tensor], scatter_dim: int,
                     gather_dim: int) -> List[torch.Tensor]:
    """All-to-all over the per-rank list ``xs``: scatter ``scatter_dim``
    (divisible by the rank count), gather ``gather_dim``. The Ulysses
    head <-> sequence swap is two of these."""
    return alltoall_ranks(xs, scatter_dim, gather_dim)


def _sdpa(q, k, v, causal):
    """The attention oracle of the non-kernel path on ``[B, S, H, D]``:
    fp32 scores, masked at -1e30 (bottom-right causal), ``(out in q's
    dtype, lse [B, H, Sq] fp32)``."""
    Sq, D = q.shape[1], q.shape[3]
    Sk = k.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(D)
    if causal:
        mask = torch.ones((Sq, Sk), dtype=torch.bool,
                          device=q.device).tril(Sk - Sq)
        s = s.masked_fill(~mask, -1e30)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)
    return out.to(q.dtype), torch.logsumexp(s, dim=-1)


def _attn_with_lse(q, k, v, causal, use_kernels):
    if use_kernels:
        return flash_attention_with_lse(q, k, v, causal=causal)
    return _sdpa(q, k, v, causal)


def ulysses_attention(qs, ks, vs, causal: bool = False,
                      use_kernels: bool = True) -> List[torch.Tensor]:
    """Attention over sequence shards ``[B, S/n, H, D]`` (per-rank lists):
    all-to-all to ``[B, S, H/n, D]``, full-sequence attention on each
    rank's heads, all-to-all back. The heads must split over the ``n``
    ranks."""
    n = len(qs)
    H = qs[0].shape[2]
    if H % n:
        raise ValueError(f"ulysses_attention: heads {H} not divisible by "
                         f"sep degree {n}")
    qh, kh, vh = (ulysses_alltoall(t, 2, 1) for t in (qs, ks, vs))
    outs = [_attn_with_lse(q, k, v, causal, use_kernels)[0]
            for q, k, v in zip(qh, kh, vh)]
    return ulysses_alltoall(outs, 1, 2)


def _bcast(w, like):
    """lse-shaped ``[B, H, S]`` weights onto ``[B, S, H, D]``."""
    return w.transpose(1, 2)[..., None].to(like.dtype)


def ring_flash_attention(qs, ks, vs, causal: bool = False,
                         use_kernels: bool = True) -> List[torch.Tensor]:
    """Ring attention over sequence shards ``[B, S/n, H, D]`` (per-rank
    lists, rank ``i`` holding positions ``[i S/n, (i + 1) S/n)``). Rank
    ``i`` merges its own block, then blocks ``j = i - 1, i - 2, ...`` in
    the order the ring brings them (mod ``n``; under ``causal`` only ``j <
    i``, the later blocks skipped rather than weighted 0)."""
    n = len(qs)
    outs = []
    for i, q in enumerate(qs):
        out, lse = _attn_with_lse(q, ks[i], vs[i], causal, use_kernels)
        lse = lse.float()
        steps = range(1, i + 1) if causal else range(1, n)
        for s in steps:
            j = (i - s) % n
            out_b, lse_b = _attn_with_lse(q, ks[j].to(q.device),
                                          vs[j].to(q.device), False,
                                          use_kernels)
            lse_b = lse_b.float()
            new = torch.logaddexp(lse, lse_b)
            w_old = torch.exp(lse - new)
            w_new = torch.exp(lse_b - new).masked_fill(
                torch.isneginf(lse_b), 0.0)
            out = out * _bcast(w_old, out) + out_b * _bcast(w_new, out)
            lse = new
        outs.append(out)
    return outs


_IMPLS = {"ring": ring_flash_attention, "ulysses": ulysses_attention}


def cp_attention(impl: str):
    """The per-rank-list attention ``impl`` names (``"ring"`` or
    ``"ulysses"``); any other name raises ``ValueError``."""
    fn = _IMPLS.get(impl)
    if fn is None:
        raise ValueError(f"impl must be 'ring' or 'ulysses', got {impl!r}")
    return fn


def sep_parallel_attention(q, k, v, causal: bool = False,
                           impl: str = "ring", mesh=None,
                           axis_name: str = "sep",
                           use_kernels: Optional[bool] = None):
    """Context-parallel attention on FULL ``[B, S, H, D]`` tensors: the
    sequence cut over the ``axis_name`` group of ``mesh`` (default: the
    hybrid group's; rank ``r``'s shard on the device of the group's rank
    ``r``, every other axis at 0), ring (``impl="ring"``) or Ulysses
    (``"ulysses"``) attention, the shards joined on q's device. One rank:
    plain attention. ``use_kernels`` defaults to whether q is on a card
    (the flash kernels there, :func:`_sdpa` on the CPU)."""
    fn = cp_attention(impl)
    if use_kernels is None:
        use_kernels = q.device.type == "cuda"
    mesh = mesh or get_hybrid_communicate_group().mesh
    n = int(mesh.shape.get(axis_name, 1))
    if n == 1:
        return _attn_with_lse(q, k, v, causal, use_kernels)[0]
    if q.shape[1] % n:
        raise ValueError(f"sep_parallel_attention: sequence {q.shape[1]} "
                         f"not divisible by sep degree {n}")
    devs = ParallelAxis(mesh, axis_name).devices()
    qs, ks, vs = ([c.to(d) for c, d in zip(t.chunk(n, 1), devs)]
                  for t in (q, k, v))
    return torch.cat([o.to(q.device) for o in fn(qs, ks, vs, causal,
                                                 use_kernels)], dim=1)

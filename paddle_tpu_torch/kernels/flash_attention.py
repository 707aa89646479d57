"""Flash attention, forward and backward — counterpart of ``paddle_tpu/kernels/flash_attention.py``.

:func:`flash_attention_with_lse` computes what the Pallas kernels compute
(``flash_attention.py:67-392``) on the ``[B, S, H, D]`` layout: causal
(bottom-right aligned: query ``i`` sees key ``j`` iff ``j <= i + Sk - Sq``)
or not, GQA (query head ``h`` reads kv head ``h // (H // Hk)``), packed
``segment_ids``, masked scores at -1e30, ``p`` forced to 0 where the score
is <= -5e29, rows with no visible key output 0 with ``lse = -1e30``. It
returns ``out`` in q's dtype and ``lse [B, H, Sq]`` in fp32; the gradient
recomputes ``p`` from ``lse`` (``delta = rowsum(dO * out)`` from the saved
``out`` in its own dtype), ``dq`` in q's dtype, ``dk``/``dv`` accumulated
in fp32, folded over the GQA group and cast to k's / v's dtype.

On CUDA tensors the :class:`torch.autograd.Function` launches the three
hand-written kernels of ``csrc/flash_attention.cu`` (forward, backward dq,
backward dk/dv; fp32 or bf16, head_dim 64 or 128; anything else raises).
On CPU tensors it runs :func:`flash_attention_fwd_plain` and
:func:`flash_attention_bwd_plain`: the same formulas on whole ``[B, H, Sq,
Sk]`` score matrices, the backward an explicit formula from the saved
``lse`` (not autograd through the plain forward), so the CPU tests hold the
same Function, saved tensors, GQA fold and casts as the card runs.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from ..device import on_cuda
from . import build

__all__ = ["flash_attention", "flash_attention_with_lse",
           "flash_attention_fwd_plain", "flash_attention_bwd_plain",
           "flash_attention_bwd_dq_plain", "flash_attention_bwd_dkv_plain",
           "flash_attention_fwd_tiled", "flash_attention_bwd_dq_tiled",
           "flash_attention_bwd_dkv_tiled"]

_NEG_INF = -1e30
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)          # csrc/flash_attention.cu dispatch
# the bf16 kernels' tiles (csrc/flash_attention.cu kBlockRows, kFwdKeys,
# kFwdSub, kDkvKeys, kDkvRows): forward and dq blocks of 128 query rows
# walk 128-key tiles as 64-key sub-tiles; dk/dv blocks of 64 keys walk
# 64-row query tiles
_FWD_ROWS, _FWD_KEYS, _FWD_SUB, _DKV_KEYS, _DKV_ROWS = 128, 128, 64, 64, 64


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _visible(Sq, Sk, causal, seg_q, seg_k, device):
    """``[B or 1, 1, Sq, Sk]`` bool: query ``i`` may attend key ``j``."""
    i = torch.arange(Sq, device=device)[:, None]
    j = torch.arange(Sk, device=device)[None, :]
    if causal:
        mask = j <= i + (Sk - Sq)
    else:
        mask = torch.ones((Sq, Sk), dtype=torch.bool, device=device)
    mask = mask[None]
    if seg_q is not None:
        mask = mask & (seg_q[:, :, None] == seg_k[:, None, :])
    return mask[:, None]


def _expand(t, G):
    """``[B, S, Hk, D]`` -> fp32 ``[B, S, Hk * G, D]``: kv head ``h // G``
    for query head ``h``."""
    t = t.float()
    return t.repeat_interleave(G, dim=2) if G > 1 else t


def _probs(q, k, seg_q, seg_k, scale, causal, lse=None):
    """Masked fp32 scores ``s [B, H, Sq, Sk]`` and, when ``lse`` is given,
    ``p = exp(s - lse)`` with masked entries exactly 0."""
    Sq, Sk = q.shape[1], k.shape[1]
    mask = _visible(Sq, Sk, causal, seg_q, seg_k, q.device)
    kf = _expand(k, q.shape[2] // k.shape[2])
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * scale
    s = s.masked_fill(~mask, _NEG_INF)
    if lse is None:
        return s
    return torch.exp(s - lse[..., None]).masked_fill(s <= _NEG_INF / 2, 0.0)


def flash_attention_fwd_plain(q, k, v, seg_q, seg_k, scale, causal):
    """(out ``[B, Sq, H, D]`` in q's dtype, lse ``[B, H, Sq]`` fp32): one
    masked fp32 softmax over the whole score matrix."""
    s = _probs(q, k, seg_q, seg_k, scale, causal)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m).masked_fill(s <= _NEG_INF / 2, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    safe = torch.where(l == 0, torch.ones_like(l), l)
    vf = _expand(v, q.shape[2] // v.shape[2])
    o = torch.einsum("bhqk,bkhd->bhqd", p, vf) / safe
    return o.transpose(1, 2).to(q.dtype), (m + torch.log(safe))[..., 0]


def _ds(q, k, v, seg_q, seg_k, out, lse, dout, scale, causal):
    """(p, ds) of the backward, both fp32 ``[B, H, Sq, Sk]``."""
    p = _probs(q, k, seg_q, seg_k, scale, causal, lse)
    dof = dout.float()
    delta = (dof * out.float()).sum(dim=-1).transpose(1, 2)     # [B, H, Sq]
    vf = _expand(v, q.shape[2] // v.shape[2])
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    return p, p * (dp - delta[..., None]) * scale


def _dq_plain(q, k, ds):
    kf = _expand(k, q.shape[2] // k.shape[2])
    return torch.einsum("bhqk,bkhd->bqhd", ds, kf).to(q.dtype)


def _dkv_plain(q, k, v, p, ds, dout):
    B, Sk, Hk, D = k.shape
    G = q.shape[2] // Hk
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dout.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    if G > 1:       # GQA: fold the query heads of each kv head
        dk = dk.reshape(B, Sk, Hk, G, D).sum(dim=3)
        dv = dv.reshape(B, Sk, Hk, G, D).sum(dim=3)
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_plain(q, k, v, seg_q, seg_k, out, lse, dout, scale,
                              causal):
    """(dq, dk, dv) from the saved forward: ``p`` recomputed from ``lse``,
    ``delta = rowsum(dout * out)``, ``ds = p * (dp - delta) * scale``."""
    p, ds = _ds(q, k, v, seg_q, seg_k, out, lse, dout, scale, causal)
    return (_dq_plain(q, k, ds),) + _dkv_plain(q, k, v, p, ds, dout)


def flash_attention_bwd_dq_plain(q, k, v, seg_q, seg_k, out, lse, dout,
                                 scale, causal):
    """dq alone (what the dq kernel computes)."""
    _, ds = _ds(q, k, v, seg_q, seg_k, out, lse, dout, scale, causal)
    return _dq_plain(q, k, ds)


def flash_attention_bwd_dkv_plain(q, k, v, seg_q, seg_k, out, lse, dout,
                                  scale, causal):
    """(dk, dv) alone (what the dk/dv kernel computes)."""
    p, ds = _ds(q, k, v, seg_q, seg_k, out, lse, dout, scale, causal)
    return _dkv_plain(q, k, v, p, ds, dout)


# ---------------------------------------------------------------------------
# CPU emulations of the bf16 kernels' tilings
# ---------------------------------------------------------------------------

def _tiles_meeting(ids, starts, width, lo, hi):
    """The tile starts whose ids ``[t, t + width)`` can meet ``[lo, hi]``:
    the kernels' segment skip (``next_tile``), the TPU version's
    ``_seg_overlap``."""
    return [t for t in starts
            if ids[t:t + width].max() >= lo and ids[t:t + width].min() <= hi]


def _fwd_key_tiles(Sq, Sk, q0, causal, seg_q_row, seg_k_row):
    """The forward producer's key-tile starts for the block of query rows
    from ``q0``: up to the causal limit of its last row, tiles whose
    segments cannot meet the block's skipped."""
    last = min(q0 + _FWD_ROWS, Sq)
    k_end = min(Sk, last + Sk - Sq) if causal else Sk
    starts = range(0, k_end, _FWD_KEYS)
    if seg_q_row is None:
        return list(starts)
    ids = seg_q_row[q0:last]
    return _tiles_meeting(seg_k_row, starts, _FWD_KEYS, ids.min(), ids.max())


def _dkv_query_steps(Sq, Sk, k0, G, causal, seg_q_row, seg_k_row):
    """The dk/dv producer's steps ``(head in the group, first row)`` for the
    block of keys from ``k0``: for each of the G query heads, the 64-row
    tiles from the first row that sees any of its keys, segment-skipped."""
    first = (max(0, k0 - (Sk - Sq)) if causal else 0) // _DKV_ROWS * _DKV_ROWS
    starts = range(first, Sq, _DKV_ROWS)
    if seg_q_row is not None:
        ids = seg_k_row[k0:min(k0 + _DKV_KEYS, Sk)]
        starts = _tiles_meeting(seg_q_row, starts, _DKV_ROWS, ids.min(),
                                ids.max())
    return [(g, i0) for g in range(G) for i0 in starts]


def _tile_visible(i, j, off, causal, seg_q_row, seg_k_row):
    """[len(i), len(j)] bool for query rows ``i`` and keys ``j``."""
    vis = torch.ones((len(i), len(j)), dtype=torch.bool)
    if causal:
        vis &= j[None, :] <= i[:, None] + off
    if seg_q_row is not None:
        vis &= seg_q_row[i][:, None] == seg_k_row[j][None, :]
    return vis


def flash_attention_fwd_tiled(q, k, v, seg_q, seg_k, scale, causal):
    """What the bf16 forward kernel computes, tile by tile, on the CPU: blocks
    of 128 query rows (heaviest first), each over the producer's key tiles
    (:func:`_fwd_key_tiles`) taken as 64-key sub-tiles, with an fp32 online
    softmax per sub-tile; ``p`` is rounded to the inputs' dtype before
    ``p . v``. Returns (out in q's dtype, lse
    ``[B, H, Sq]`` fp32), as :func:`flash_attention_fwd_plain`."""
    B, Sq, H, D = q.shape
    Sk, Hk = k.shape[1], k.shape[2]
    G, off = H // Hk, Sk - Sq
    out = torch.zeros((B, Sq, H, D))
    lse = torch.zeros((B, H, Sq))
    for q0 in reversed(range(0, Sq, _FWD_ROWS)):
        i = torch.arange(q0, min(q0 + _FWD_ROWS, Sq))
        for b in range(B):
            sq_row = None if seg_q is None else seg_q[b]
            sk_row = None if seg_k is None else seg_k[b]
            qt = q[b, i].float().transpose(0, 1)                  # [H, r, D]
            m = torch.full((H, len(i)), _NEG_INF)
            l = torch.zeros((H, len(i)))
            acc = torch.zeros((H, len(i), D))
            subs = [k1 for k0 in _fwd_key_tiles(Sq, Sk, q0, causal, sq_row,
                                                sk_row)
                    for k1 in range(k0, min(k0 + _FWD_KEYS, Sk), _FWD_SUB)]
            for k1 in subs:
                j = torch.arange(k1, min(k1 + _FWD_SUB, Sk))
                kt, vt = (_expand(x[b:b + 1, j], G)[0].transpose(0, 1)
                          for x in (k, v))                        # [H, c, D]
                s = (qt @ kt.transpose(1, 2)) * scale
                s = s.masked_fill(~_tile_visible(i, j, off, causal, sq_row,
                                                 sk_row), _NEG_INF)
                mx = torch.maximum(m, s.amax(dim=-1))
                alpha = torch.exp(m - mx)
                p = torch.exp(s - mx[..., None]).masked_fill(
                    s <= _NEG_INF / 2, 0.0)
                l = l * alpha + p.sum(dim=-1)
                m = mx
                acc = acc * alpha[..., None] + p.to(q.dtype).float() @ vt
            safe = torch.where(l == 0, torch.ones_like(l), l)
            out[b, i] = (acc / safe[..., None]).transpose(0, 1)
            lse[b, :, i] = torch.where(l == 0, m, m + torch.log(safe))
    return out.to(q.dtype), lse


def flash_attention_bwd_dq_tiled(q, k, v, seg_q, seg_k, out, lse, dout,
                                 scale, causal):
    """What the bf16 dq kernel computes, tile by tile, on the CPU: the
    forward's blocks of 128 query rows over the forward producer's key
    tiles (:func:`_fwd_key_tiles`) taken as 64-key sub-tiles; ``p`` from
    ``lse``, ``ds = p (dp - delta)`` rounded to the inputs' dtype before
    ``ds . k``, summed in fp32 over the sub-tiles and multiplied by
    ``scale`` once at the end. Returns dq in q's dtype, as
    :func:`flash_attention_bwd_dq_plain`."""
    B, Sq, H, D = q.shape
    Sk, Hk = k.shape[1], k.shape[2]
    G, off = H // Hk, Sk - Sq
    delta = (dout.float() * out.float()).sum(dim=-1).transpose(1, 2)
    dq = torch.zeros((B, Sq, H, D))
    for q0 in range(0, Sq, _FWD_ROWS):
        i = torch.arange(q0, min(q0 + _FWD_ROWS, Sq))
        for b in range(B):
            sq_row = None if seg_q is None else seg_q[b]
            sk_row = None if seg_k is None else seg_k[b]
            qt, dot = (x[b, i].float().transpose(0, 1)
                       for x in (q, dout))                        # [H, r, D]
            lse_t, delta_t = lse[b][:, i, None], delta[b][:, i, None]
            acc = torch.zeros((H, len(i), D))
            subs = [k1 for k0 in _fwd_key_tiles(Sq, Sk, q0, causal, sq_row,
                                                sk_row)
                    for k1 in range(k0, min(k0 + _FWD_KEYS, Sk), _FWD_SUB)]
            for k1 in subs:
                j = torch.arange(k1, min(k1 + _FWD_SUB, Sk))
                kt, vt = (_expand(x[b:b + 1, j], G)[0].transpose(0, 1)
                          for x in (k, v))                        # [H, c, D]
                s = (qt @ kt.transpose(1, 2)) * scale
                s = s.masked_fill(~_tile_visible(i, j, off, causal, sq_row,
                                                 sk_row), _NEG_INF)
                p = torch.exp(s - lse_t).masked_fill(s <= _NEG_INF / 2, 0.0)
                ds = p * (dot @ vt.transpose(1, 2) - delta_t)
                acc += ds.to(q.dtype).float() @ kt
            dq[b, i] = (acc * scale).transpose(0, 1)
    return dq.to(q.dtype)


def flash_attention_bwd_dkv_tiled(q, k, v, seg_q, seg_k, out, lse, dout,
                                  scale, causal):
    """What the bf16 dk/dv kernel computes, tile by tile, on the CPU: blocks
    of 64 keys, each over the producer's steps (:func:`_dkv_query_steps`:
    G heads x 64-row query tiles), ``p^T`` from ``lse``, ``ds^T = p^T (dp^T
    - delta) scale``, both rounded to the inputs' dtype before their
    products, dk and dv summed in fp32 over the steps. Returns (dk, dv), as
    :func:`flash_attention_bwd_dkv_plain`."""
    B, Sq, H, D = q.shape
    Sk, Hk = k.shape[1], k.shape[2]
    G, off = H // Hk, Sk - Sq
    delta = (dout.float() * out.float()).sum(dim=-1).transpose(1, 2)
    dk = torch.zeros((B, Sk, Hk, D))
    dv = torch.zeros((B, Sk, Hk, D))
    for b in range(B):
        sq_row = None if seg_q is None else seg_q[b]
        sk_row = None if seg_k is None else seg_k[b]
        for k0 in range(0, Sk, _DKV_KEYS):
            j = torch.arange(k0, min(k0 + _DKV_KEYS, Sk))
            kt, vt = (x[b, j].float().transpose(0, 1) for x in (k, v))
            dk_acc = torch.zeros((Hk, len(j), D))
            dv_acc = torch.zeros((Hk, len(j), D))
            for g, i0 in _dkv_query_steps(Sq, Sk, k0, G, causal, sq_row,
                                          sk_row):
                i = torch.arange(i0, min(i0 + _DKV_ROWS, Sq))
                heads = torch.arange(Hk) * G + g
                qt, dot = (x[b, i][:, heads].float().transpose(0, 1)
                           for x in (q, dout))                    # [Hk, r, D]
                st = (kt @ qt.transpose(1, 2)) * scale            # [Hk, c, r]
                vis = _tile_visible(i, j, off, causal, sq_row, sk_row).T
                st = st.masked_fill(~vis, _NEG_INF)
                pt = torch.exp(st - lse[b][heads][:, i][:, None, :]) \
                    .masked_fill(st <= _NEG_INF / 2, 0.0)
                dpt = vt @ dot.transpose(1, 2)
                dst = pt * (dpt - delta[b][heads][:, i][:, None, :]) * scale
                dv_acc += pt.to(q.dtype).float() @ dot
                dk_acc += dst.to(q.dtype).float() @ qt
            dk[b, j] = dk_acc.transpose(0, 1)
            dv[b, j] = dv_acc.transpose(0, 1)
    return dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# the CUDA kernels
# ---------------------------------------------------------------------------

def _aligned(t):
    """``t`` contiguous with its data on a 16-byte boundary, as TMA reads
    it: a view that starts off the boundary (a storage offset) is copied."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _cuda_operands(q, k, v, seg_q, seg_k):
    """Check what the kernels take; returns (q, k, v, seg_q, seg_k)
    contiguous, q/k/v 16-byte aligned (:func:`_aligned`), segments as
    int32."""
    B, Sq, H, D = q.shape
    if k.dim() != 4 or v.shape != k.shape or k.shape[0] != B \
            or k.shape[3] != D or H % k.shape[2]:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} does not fit "
                         f"k {tuple(k.shape)} / v {tuple(v.shape)} (head_dim, "
                         f"batch, or query heads not divisible by kv heads)")
    if D not in _HEAD_DIMS:
        raise ValueError(f"flash_attention: the CUDA kernels take head_dim "
                         f"in {_HEAD_DIMS}, got {D}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: the CUDA kernels take q, k, v "
                         f"all float32 or all bfloat16, got {q.dtype}, "
                         f"{k.dtype}, {v.dtype}")
    for name, t in (("k", k), ("v", v), ("segment_ids", seg_q),
                    ("kv_segment_ids", seg_k)):
        if t is not None and t.device != q.device:
            raise ValueError(f"flash_attention: {name} on {t.device}, q on "
                             f"{q.device}")
    if seg_q is not None:
        seg_q = seg_q.to(torch.int32).contiguous()
        seg_k = seg_k.to(torch.int32).contiguous()
    return _aligned(q), _aligned(k), _aligned(v), seg_q, seg_k


def _ptr(t):
    return None if t is None else t.data_ptr()


def _entry(name, n_ptrs):
    lib = build.load("flash_attention")
    fn = getattr(lib, name)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 6 + \
        [ctypes.c_float] + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    return lib, fn


# csrc/flash_attention.cu's dq route by dtype: the FMA kernel for fp32, the
# wgmma + TMA kernel for bf16
_DQ_ROUTE = {torch.float32: "fma", torch.bfloat16: "wgmma"}


def _fwd_cuda(q, k, v, seg_q, seg_k, scale, causal):
    q, k, v, seg_q, seg_k = _cuda_operands(q, k, v, seg_q, seg_k)
    B, Sq, H, D = q.shape
    Sk, Hk = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    lib, fn = _entry("flash_fwd_launch", 7)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(seg_q),
             _ptr(seg_k), out.data_ptr(), lse.data_ptr(), B, H, Hk, Sq, Sk,
             D, scale, int(causal), _DTYPE_CODE[q.dtype], stream)
    build.check(lib, err, "flash_attention forward")
    flash_attention.launches += 1
    return out, lse


def _bwd_operands(q, k, v, seg_q, seg_k, out, lse, dout):
    """The backward kernels' operands: contiguous tensors and ``delta =
    rowsum(dO * O) [B, H, Sq]`` fp32, computed outside the kernels as in
    the TPU version (from the saved ``out`` in its own dtype)."""
    q, k, v, seg_q, seg_k = _cuda_operands(q, k, v, seg_q, seg_k)
    dout = _aligned(dout.to(q.dtype))
    delta = (dout.float() * out.float()).sum(dim=-1).transpose(1, 2) \
        .contiguous()
    return q, k, v, seg_q, seg_k, dout, lse.contiguous(), delta


def _bwd_args(ops, scale, causal):
    """(pointer arguments, trailing arguments) of the backward launches."""
    q, k, v, seg_q, seg_k, dout, lse, delta = ops
    B, Sq, H, D = q.shape
    Sk, Hk = k.shape[1], k.shape[2]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    return ((q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), _ptr(seg_q), _ptr(seg_k)),
            (B, H, Hk, Sq, Sk, D, scale, int(causal), _DTYPE_CODE[q.dtype],
             stream))


def _dq_cuda(ops, scale, causal):
    """Launch the dq kernel on :func:`_bwd_operands`' result."""
    dq = torch.empty_like(ops[0])
    ptrs, tail = _bwd_args(ops, scale, causal)
    lib, fn = _entry("flash_bwd_dq_launch", 9)
    build.check(lib, fn(*ptrs, dq.data_ptr(), *tail),
                "flash_attention backward dq")
    flash_attention.launches_bwd_dq += 1
    flash_attention.launches_bwd_dq_by_route[_DQ_ROUTE[dq.dtype]] += 1
    return dq


def _dkv_cuda(ops, scale, causal):
    """Launch the dk/dv kernel on :func:`_bwd_operands`' result."""
    dk = torch.empty_like(ops[1])
    dv = torch.empty_like(ops[2])
    ptrs, tail = _bwd_args(ops, scale, causal)
    lib, fn = _entry("flash_bwd_dkv_launch", 10)
    build.check(lib, fn(*ptrs, dk.data_ptr(), dv.data_ptr(), *tail),
                "flash_attention backward dk/dv")
    flash_attention.launches_bwd_dkv += 1
    return dk, dv


def _bwd_cuda(q, k, v, seg_q, seg_k, out, lse, dout, scale, causal):
    ops = _bwd_operands(q, k, v, seg_q, seg_k, out, lse, dout)
    return (_dq_cuda(ops, scale, causal),) + _dkv_cuda(ops, scale, causal)


class _FlashAttention(torch.autograd.Function):
    """``(q, k, v, seg_q, seg_k) -> (out, lse)``; the forward saves
    ``(q, k, v, seg_q, seg_k, out, lse)`` and nothing else (it holds no
    state between calls, so activation checkpointing may re-run it).

    With ``regen`` (a callable returning ``(q, k, v)``) the forward keeps
    only ``seg_q, seg_k, out, lse``, the residuals the JAX kernel's VJP
    names ``flash_out`` and ``flash_lse``, and the backward calls ``regen``
    for the inputs: what a remat policy that keeps the flash residuals but
    not (all of) q/k/v needs."""

    @staticmethod
    def forward(ctx, q, k, v, seg_q, seg_k, scale, causal, regen):
        fwd = (_fwd_cuda if on_cuda(q, "flash_attention")
               else flash_attention_fwd_plain)
        out, lse = fwd(q, k, v, seg_q, seg_k, scale, causal)
        if regen is None:
            ctx.save_for_backward(q, k, v, seg_q, seg_k, out, lse)
        else:
            ctx.save_for_backward(seg_q, seg_k, out, lse)
        ctx.scale, ctx.causal, ctx.regen = scale, causal, regen
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        if ctx.regen is None:
            q, k, v, seg_q, seg_k, out, lse = ctx.saved_tensors
        else:
            seg_q, seg_k, out, lse = ctx.saved_tensors
            q, k, v = ctx.regen()
        bwd = (_bwd_cuda if on_cuda(q, "flash_attention")
               else flash_attention_bwd_plain)
        dq, dk, dv = bwd(q, k, v, seg_q, seg_k, out, lse, dout, ctx.scale,
                         ctx.causal)
        return dq, dk, dv, None, None, None, None, None


def flash_attention_with_lse(q, k, v, causal: bool = False,
                             scale: Optional[float] = None,
                             block_q: Optional[int] = None,
                             block_k: Optional[int] = None,
                             segment_ids=None, kv_segment_ids=None,
                             regen_inputs=None):
    """``[B, S, H, D]`` flash attention returning ``(out, lse [B, H, Sq])``.

    The arguments and errors are the JAX function's: ``block_q``/``block_k``
    are only checked to divide the sequence lengths (the kernels' tiles are
    their own and take any length); causal with ``Sq > Sk`` raises;
    ``segment_ids [B, Sq]`` enables packed-sequence masking, with
    ``kv_segment_ids`` defaulting to it and required when ``Sq != Sk``.
    ``regen_inputs`` (a callable returning ``(q, k, v)``, run under no
    grad) keeps ``q``/``k``/``v`` out of the saved residuals: the backward
    rebuilds them with it (the remat policies that keep only the flash
    residuals and part of q/k/v).

    CUDA tensors launch the kernels: each forward adds one to
    ``flash_attention.launches``, each backward one to
    ``flash_attention.launches_bwd_dq`` (and to its route's count in
    ``.launches_bwd_dq_by_route``) and ``.launches_bwd_dkv``. CPU tensors
    run the plain versions.
    """
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    block_q = min(block_q or Sq, Sq)
    block_k = min(block_k or Sk, Sk)
    if Sq % block_q or Sk % block_k:
        raise ValueError(f"flash_attention: seq lens ({Sq},{Sk}) must divide "
                         f"block sizes ({block_q},{block_k})")
    if causal and Sq > Sk:
        raise ValueError(f"flash_attention: causal with Sq ({Sq}) > Sk ({Sk}) "
                         f"has fully-masked query rows; mask them explicitly "
                         f"or pad keys")
    if segment_ids is not None and kv_segment_ids is None:
        if Sq != Sk:
            raise ValueError("flash_attention: kv_segment_ids required when "
                             "Sq != Sk")
        kv_segment_ids = segment_ids
    seg_q = seg_k = None
    if segment_ids is not None:
        seg_q = torch.as_tensor(segment_ids, device=q.device)
        seg_k = torch.as_tensor(kv_segment_ids, device=q.device)
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(D)
    return _FlashAttention.apply(q, k, v, seg_q, seg_k, scale, bool(causal),
                                 regen_inputs)


def flash_attention(q, k, v, causal: bool = False,
                    scale: Optional[float] = None,
                    block_q: Optional[int] = None,
                    block_k: Optional[int] = None,
                    segment_ids=None, kv_segment_ids=None):
    """``[B, S, H, D]`` flash attention (``segment_ids`` = packed mode);
    :func:`flash_attention_with_lse` without the lse."""
    out, _ = flash_attention_with_lse(q, k, v, causal, scale, block_q,
                                      block_k, segment_ids, kv_segment_ids)
    return out


flash_attention.launches = 0
flash_attention.launches_bwd_dq = 0
flash_attention.launches_bwd_dq_by_route = {"fma": 0, "wgmma": 0}
flash_attention.launches_bwd_dkv = 0

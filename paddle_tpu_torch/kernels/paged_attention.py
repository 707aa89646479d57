"""Paged decode attention — counterpart of ``paddle_tpu/kernels/paged_attention.py``.

:func:`paged_attention` computes what the Pallas kernel computes
(``paged_attention.py:146-264``): attention for ``M`` serving slots
straight off one layer's KV block pool, reading each slot's block table,
with GQA grouping (query head ``h = kh * G + g`` shares kv head ``kh``),
int8 pools dequantized with per-token-per-head scales, masked scores at
-1e30, V zeroed past ``seq_len + draft_len`` (poison containment) and
``l == 0`` rows output 0.

On a CUDA tensor it launches the hand-written kernels of
``csrc/paged_attention.cu`` (its source note says what bounds them and
what the design does about that); :func:`_plan` picks the route: the
fp32 FMA kernel for fp32 q or pools, tensor-core tiles of 64 query rows
when ``Q * G >= 16``, else the window split over KV (flash-decoding)
with its splits merged in a fixed order. On a CPU tensor it runs
:func:`paged_attention_plain`: the block-table gather followed by one
masked softmax, the same computation as ``generation._kv_gather`` +
``llama._masked_sdpa``. :func:`paged_attention_split_plain` is the split
route's arithmetic in plain PyTorch (per-split m, l and weighted value
sums, merged in split order), for the CPU tests.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from ..device import on_cuda, sm_count
from . import build

__all__ = ["paged_attention", "paged_attention_plain",
           "paged_attention_split_plain"]

_NEG_INF = -1e30
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_MAX_HEAD_DIM = 128       # csrc/paged_attention.cu kMaxD
_MAX_BLOCK_SIZE = 32      # csrc/paged_attention.cu kMaxBlockSize

# routes of csrc/paged_attention.cu's C entry
FMA, MULTI_QUERY, SPLIT = 0, 1, 2
_TILE = 64          # keys per kernel tile: split spans are whole tiles
_MIN_TC_ROWS = 16   # Q * G from which a block of 64-row tiles pays
_MIN_SPAN = 256     # keys a split takes at least


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _span(C: int, splits: int, tile: int = _TILE) -> int:
    """Keys per split: ``splits`` spans of whole ``tile``-key tiles over
    a window capacity of ``C`` keys."""
    return _cdiv(_cdiv(C, tile), splits) * tile


@functools.lru_cache(maxsize=None)
def _plan(M: int, QG: int, Hk: int, C: int, tensor_core: bool, sms: int):
    """``(route, splits, span)`` for the kernel. The split route cuts the
    table's capacity ``C = W * bs`` (the host does not read seq_lens) so
    the grid reaches about 4 blocks per SM, each split at least 256
    keys."""
    if not tensor_core:
        return FMA, 1, C
    if QG >= _MIN_TC_ROWS:
        return MULTI_QUERY, 1, C
    splits = max(1, min(_cdiv(4 * sms, M * Hk), _cdiv(C, _MIN_SPAN)))
    span = _span(C, splits)
    return SPLIT, _cdiv(C, span), span


def _entry(q, draft_lens):
    """(multi-query?, q as [M, Q, H, D]) with the entry-point checks."""
    if q.dim() == 4:
        if draft_lens is None:
            raise ValueError("paged_attention: multi-query (verify) calls "
                             "need draft_lens")
        return True, q
    if q.dim() != 3:
        raise ValueError(f"paged_attention: q must be [M, H, D] or "
                         f"[M, Q, H, D], got {tuple(q.shape)}")
    if draft_lens is not None:
        raise ValueError("paged_attention: draft_lens given with a "
                         "single-token q [M, H, D]; the verify entry point "
                         "takes q [M, Q, H, D]")
    return False, q[:, None]


def paged_attention_plain(q, k_pool, v_pool, block_tables, seq_lens,
                          draft_lens=None, k_scale=None, v_scale=None,
                          scale: Optional[float] = None, out_dtype=None):
    """The plain PyTorch version: gather every slot's blocks into logical
    order, dequantize, zero V past ``seq_len + draft_len``, then one
    masked fp32 softmax. Same arguments and result as
    :func:`paged_attention`."""
    multi, qq, kk, vv, mask, scale, out_dtype = _gather_masked(
        q, k_pool, v_pool, block_tables, seq_lens, draft_lens, k_scale,
        v_scale, scale, out_dtype)
    s = torch.einsum("bthd,bjhd->bhtj", qq.float(), kk) * scale
    s = s.masked_fill(~mask[:, None], _NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhtj,bjhd->bthd", p, vv).to(out_dtype)
    return o if multi else o[:, 0]


def _gather_masked(q, k_pool, v_pool, block_tables, seq_lens, draft_lens,
                   k_scale, v_scale, scale, out_dtype):
    """Shared set-up of the plain versions: (multi, q [M, Q, H, D], fp32
    K and V [M, C, H, D] gathered in logical order, dequantized, GQA
    expanded, V zeroed past seq_len + draft_len; the visibility mask
    [M, Q, C]; scale; out_dtype)."""
    multi, qq = _entry(q, draft_lens)
    M, Q, H, D = qq.shape
    N, bs, Hk, _ = k_pool.shape
    W = block_tables.shape[1]
    C = W * bs
    quant = k_scale is not None
    if out_dtype is None:
        out_dtype = torch.float32 if quant else k_pool.dtype
    scale = float(scale) if scale is not None else 1.0 / (D ** 0.5)
    tbl = block_tables.long()
    kk = k_pool[tbl].reshape(M, C, Hk, D).float()
    vv = v_pool[tbl].reshape(M, C, Hk, D).float()
    if quant:
        kk = kk * k_scale[tbl].reshape(M, C, Hk)[..., None]
        vv = vv * v_scale[tbl].reshape(M, C, Hk)[..., None]
    sl = seq_lens.long()
    dl = draft_lens.long() if draft_lens is not None else torch.zeros_like(sl)
    j = torch.arange(C, device=q.device)
    qi = torch.arange(Q, device=q.device)
    hi = sl[:, None] + torch.minimum(qi[None, :], dl[:, None])    # [M, Q]
    mask = j[None, None, :] <= hi[:, :, None]                     # [M, Q, C]
    # containment: V nobody may attend is zeroed, not merely zero-weighted
    vv = vv.masked_fill(~(j[None, :] <= (sl + dl)[:, None])[:, :, None, None],
                        0.0)
    G = H // Hk
    if G != 1:
        kk = kk.repeat_interleave(G, dim=2)
        vv = vv.repeat_interleave(G, dim=2)
    return multi, qq, kk, vv, mask, scale, out_dtype


def paged_attention_split_plain(q, k_pool, v_pool, block_tables, seq_lens,
                                draft_lens=None, k_scale=None, v_scale=None,
                                scale: Optional[float] = None,
                                out_dtype=None, splits: int = 1,
                                tile: int = _TILE):
    """The split route's arithmetic in plain PyTorch, for the tests: the
    window capacity ``W * bs`` cut into ``splits`` spans of whole
    ``tile``-key tiles (as :func:`_plan` cuts it); per span and row the
    running max m, the sum l of exp(s - m) (exactly 0 for masked keys)
    and the weighted value sum; then the spans merged in span order,
    rows whose l is 0 giving 0. Same arguments and result as
    :func:`paged_attention`."""
    multi, qq, kk, vv, mask, scale, out_dtype = _gather_masked(
        q, k_pool, v_pool, block_tables, seq_lens, draft_lens, k_scale,
        v_scale, scale, out_dtype)
    C = kk.shape[1]
    s = torch.einsum("bthd,bjhd->bhtj", qq.float(), kk) * scale
    s = s.masked_fill(~mask[:, None], _NEG_INF)
    span = _span(C, splits, tile)
    m_tot = l_tot = o_tot = None
    for j0 in range(0, C, span):
        sj = s[..., j0:j0 + span]
        m = sj.max(dim=-1).values                                  # [M,H,Q]
        p = torch.where(sj <= -5e29, torch.zeros_like(sj),
                        torch.exp(sj - m[..., None]))
        l = p.sum(-1)
        o = torch.einsum("bhtj,bjhd->bhtd", p, vv[:, j0:j0 + span])
        if m_tot is None:
            m_tot, l_tot, o_tot = m, l, o
            continue
        m_new = torch.maximum(m_tot, m)
        f_old, f_new = torch.exp(m_tot - m_new), torch.exp(m - m_new)
        l_tot = l_tot * f_old + l * f_new
        o_tot = o_tot * f_old[..., None] + o * f_new[..., None]
        m_tot = m_new
    safe = torch.where(l_tot == 0, torch.ones_like(l_tot), l_tot)
    o = torch.where(l_tot[..., None] == 0, torch.zeros_like(o_tot),
                    o_tot / safe[..., None])
    o = o.permute(0, 2, 1, 3).to(out_dtype)                      # [M,Q,H,D]
    return o if multi else o[:, 0]


@functools.lru_cache(maxsize=None)
def _launcher():
    """(library, C entry) of the kernels, bound once: the decode step calls
    the wrapper once per layer, and its host time is the step's."""
    lib = build.load("paged_attention")
    fn = lib.paged_attention_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + \
        [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2 + \
        [ctypes.c_int] * 3 + [ctypes.c_void_p]
    return lib, fn


def paged_attention(q, k_pool, v_pool, block_tables, seq_lens,
                    draft_lens=None, k_scale=None, v_scale=None,
                    scale: Optional[float] = None, out_dtype=None):
    """Paged attention for ``M`` serving slots.

    ``q [M, H, D]`` is the decode entry point; ``q [M, Q, H, D]`` with
    ``draft_lens [M]`` the multi-query entry point (verify and mixed
    steps), where query offset ``i`` attends ``j <= seq_lens[m] +
    min(i, draft_lens[m])``. ``k_pool``/``v_pool [N, bs, Hk, D]`` are one
    layer's pool (fp32/bf16, or int8 with ``k_scale``/``v_scale [N, bs,
    Hk]`` fp32); ``block_tables [M, W]`` and ``seq_lens [M]`` int32.
    Returns ``[M, H, D]`` (or ``[M, Q, H, D]``) in ``out_dtype`` — by
    default the pool dtype for fp pools and fp32 for int8 pools.

    CUDA tensors launch the kernel; each launch adds one to
    ``paged_attention.launches`` (and to ``launches_multiquery`` /
    ``launches_int8`` for those variants). CPU tensors run the plain
    version.
    """
    if not on_cuda(q, "paged_attention"):
        return paged_attention_plain(q, k_pool, v_pool, block_tables,
                                     seq_lens, draft_lens, k_scale, v_scale,
                                     scale, out_dtype)
    multi, qq = _entry(q, draft_lens)
    M, Q, H, D = qq.shape
    if k_pool.dim() != 4 or v_pool.shape != k_pool.shape:
        raise ValueError(f"paged_attention: pools must be [N, bs, Hk, D] "
                         f"and alike, got {tuple(k_pool.shape)} / "
                         f"{tuple(v_pool.shape)}")
    N, bs, Hk, Dk = k_pool.shape
    if Dk != D or Hk < 1 or H % Hk:
        raise ValueError(f"paged_attention: q {tuple(q.shape)} does not fit "
                         f"pool {tuple(k_pool.shape)} (head_dim, or query "
                         f"heads not divisible by kv heads)")
    if D > _MAX_HEAD_DIM or D % 16 or bs > _MAX_BLOCK_SIZE:
        raise ValueError(f"paged_attention: the kernel takes a head_dim "
                         f"that is a multiple of 16 up to {_MAX_HEAD_DIM} "
                         f"and block_size <= {_MAX_BLOCK_SIZE}, got {D} "
                         f"and {bs}")
    quant = k_scale is not None
    if quant != (v_scale is not None):
        raise ValueError("paged_attention: k_scale and v_scale must be "
                         "given together")
    if quant != (k_pool.dtype == torch.int8):
        raise ValueError("paged_attention: int8 pools need k_scale/v_scale "
                         "and fp pools take none")
    if out_dtype is None:
        out_dtype = torch.float32 if quant else k_pool.dtype
    if q.dtype not in (torch.float32, torch.bfloat16) or \
            k_pool.dtype not in _DTYPE_CODE or v_pool.dtype != k_pool.dtype \
            or out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"paged_attention: unsupported dtypes q {q.dtype}, "
                         f"pool {k_pool.dtype}, out {out_dtype}")
    W = block_tables.shape[1] if block_tables.dim() == 2 else -1
    if tuple(block_tables.shape) != (M, W) or tuple(seq_lens.shape) != (M,) \
            or (multi and tuple(draft_lens.shape) != (M,)):
        raise ValueError("paged_attention: block_tables must be [M, W] and "
                         "seq_lens / draft_lens [M]")
    ints = [("block_tables", block_tables), ("seq_lens", seq_lens)]
    if multi:
        ints.append(("draft_lens", draft_lens))
    for name, t in ints:
        if t.dtype != torch.int32:
            raise ValueError(f"paged_attention: {name} must be int32, got "
                             f"{t.dtype}")
    ops = [("q", qq), ("k_pool", k_pool), ("v_pool", v_pool)] + ints
    if quant:
        if k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32 \
                or tuple(k_scale.shape) != (N, bs, Hk) \
                or tuple(v_scale.shape) != (N, bs, Hk):
            raise ValueError("paged_attention: scales must be fp32 "
                             "[N, bs, Hk]")
        ops += [("k_scale", k_scale), ("v_scale", v_scale)]
    for name, t in ops:
        if t.device != q.device:
            raise ValueError(f"paged_attention: {name} on {t.device}, q on "
                             f"{q.device}")
        if not t.is_contiguous():
            raise ValueError(f"paged_attention: {name} is not contiguous")
    if (k_pool.data_ptr() | v_pool.data_ptr()) % 16:
        raise ValueError("paged_attention: the pools must be 16-byte "
                         "aligned (the kernel reads 16-byte pieces)")
    if qq.data_ptr() % 16:
        qq = qq.clone()          # q is read as 16-byte pieces too
    out = torch.empty((M, Q, H, D), dtype=out_dtype, device=q.device)
    QG = Q * (H // Hk)
    route, splits, span = _plan(
        M, QG, Hk, W * bs,
        q.dtype == torch.bfloat16 and k_pool.dtype != torch.float32,
        sm_count(q.device))
    part_ml = part_acc = None
    if splits > 1:
        part_ml = torch.empty((M, Hk, splits, QG, 2), dtype=torch.float32,
                              device=q.device)
        part_acc = torch.empty((M, Hk, splits, QG, D), dtype=torch.float32,
                               device=q.device)
    lib, fn = _launcher()
    scale = float(scale) if scale is not None else 1.0 / (D ** 0.5)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(qq.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
             k_scale.data_ptr() if quant else None,
             v_scale.data_ptr() if quant else None,
             block_tables.data_ptr(), seq_lens.data_ptr(),
             draft_lens.data_ptr() if multi else None, out.data_ptr(),
             M, Q, H, Hk, D, bs, W, scale, _DTYPE_CODE[q.dtype],
             _DTYPE_CODE[k_pool.dtype], _DTYPE_CODE[out_dtype],
             None if part_ml is None else part_ml.data_ptr(),
             None if part_acc is None else part_acc.data_ptr(),
             route, splits, span, stream)
    build.check(lib, err, "paged_attention")
    paged_attention.launches += 1
    paged_attention.launches_multiquery += int(multi)
    paged_attention.launches_int8 += int(quant)
    return out if multi else out[:, 0]


paged_attention.launches = 0
paged_attention.launches_multiquery = 0
paged_attention.launches_int8 = 0

"""Sequence (LoD) op family — counterpart of ``paddle_tpu/ops/sequence.py``.

As in the reference, a variable-length batch is dense padded ``[B, T,
...]`` data plus explicit lengths ``[B]`` (``_lens``), and every op is a
mask-driven torch program with static shapes, so a captured graph can hold
it. Ops whose Paddle output is ragged return the dense buffer at static
capacity plus the new lengths. Two ops read lengths on the host, as the
reference's do: ``sequence_unpad`` (its output length is the data) and
``sequence_expand`` (its capacity, the longest repeat, is a shape).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ._helpers import ensure_tensor, forward_op

__all__ = [
    "sequence_pad", "sequence_unpad", "sequence_expand", "sequence_expand_as",
    "sequence_reverse", "sequence_softmax", "sequence_pool",
    "sequence_first_step", "sequence_last_step", "sequence_conv",
    "sequence_slice", "sequence_concat", "sequence_enumerate",
    "sequence_erase", "sequence_reshape", "sequence_scatter", "lod_reset",
    "im2sequence", "row_conv",
]


def _lens(seq_lens):
    return ensure_tensor(seq_lens)


def _valid(lens_v, T):
    """[B] lengths -> [B, T] bool validity mask."""
    return torch.arange(T, device=lens_v.device)[None, :] < lens_v[:, None]


def _trail(mask, ndim):
    """``mask [B, T]`` broadcast over ``ndim - 2`` trailing dims."""
    return mask.reshape(mask.shape + (1,) * (ndim - 2))


def _take_rows(xv, src):
    """``out[b, t] = xv[b, src[b, t]]`` over any trailing dims."""
    idx = _trail(src.long(), xv.dim()).expand(src.shape + xv.shape[2:])
    return torch.gather(xv, 1, idx)


# -- pad / unpad / reshape -----------------------------------------------------

def sequence_pad(x, pad_value, maxlen, seq_lens, name=None):
    """Pack a flat ``[N, ...]`` buffer of concatenated sequences into a dense
    ``[B, maxlen, ...]`` batch; rows beyond each length hold ``pad_value``.
    Returns ``(padded, seq_lens)``."""
    def impl(xv, lv):
        starts = torch.cumsum(lv, 0) - lv
        j = torch.arange(maxlen, device=xv.device)
        gather = starts[:, None] + j[None, :]
        safe = torch.clamp(gather, 0, xv.shape[0] - 1).long()
        out = xv[safe]
        mask = _trail(j[None, :] < lv[:, None], out.dim())
        return torch.where(mask, out, torch.as_tensor(
            pad_value, dtype=xv.dtype, device=xv.device)), lv
    return forward_op("sequence_pad", impl, [ensure_tensor(x),
                                             _lens(seq_lens)])


def sequence_unpad(x, length, name=None):
    """Dense padded ``[B, T, ...]`` -> flat ``[sum(L_i), ...]``. The output
    length is the data, so the lengths are read on the host (eager-only,
    and not differentiable, as the reference's); the rows stay on the
    device."""
    lv = [int(v) for v in _lens(length).numpy().reshape(-1)]
    return forward_op(
        "sequence_unpad",
        lambda xv: torch.cat([xv[b, :n] for b, n in enumerate(lv)], 0)
        if lv else xv.new_zeros((0,) + tuple(xv.shape[2:])),
        [ensure_tensor(x)], differentiable=False)


def sequence_reshape(x, new_dim: int, seq_lens, name=None):
    """Refold the trailing dim: each length-L row of width D becomes length
    ``L*D//new_dim`` of width ``new_dim``. Returns ``(out, new_lens)``."""
    def impl(xv, lv):
        B, T, D = xv.shape
        return xv.reshape(B, T * D // new_dim, new_dim), lv * D // new_dim
    return forward_op("sequence_reshape", impl,
                      [ensure_tensor(x), _lens(seq_lens)])


def lod_reset(x, seq_lens, name=None):
    """Reassign the length metadata of a dense batch; the data is
    unchanged. Returns ``(x, seq_lens)``."""
    return forward_op("lod_reset", lambda xv, lv: (xv, lv),
                      [ensure_tensor(x), _lens(seq_lens)])


# -- expand / reverse / erase / slice / concat / scatter ------------------------

def sequence_expand(x, y_lens, ref_level: int = 0, name=None):
    """Repeat each row ``i`` of ``x [B, ...]`` ``y_lens[i]`` times into a
    dense ``[B, max(y_lens), ...]`` batch (masked broadcast). Returns
    ``(out, y_lens)``."""
    lt = _lens(y_lens)
    cap = int(lt._value.max()) if lt._value.numel() else 0

    def impl(xv, lv):
        out = xv[:, None].expand((xv.shape[0], cap) + tuple(xv.shape[1:]))
        mask = _valid(lv, cap).reshape((xv.shape[0], cap)
                                       + (1,) * (xv.dim() - 1))
        if xv.is_floating_point():
            return out * mask.to(xv.dtype), lv
        return torch.where(mask, out, torch.zeros_like(out)), lv
    return forward_op("sequence_expand", impl, [ensure_tensor(x), lt])


def sequence_expand_as(x, y, name=None):
    """Expand each row of ``x [B, ...]`` across ``y``'s time axis:
    out[b, t] = x[b]."""
    return forward_op(
        "sequence_expand_as",
        lambda xv, yv: xv[:, None].expand((xv.shape[0], yv.shape[1])
                                          + tuple(xv.shape[1:])),
        [ensure_tensor(x), ensure_tensor(y)])


def sequence_reverse(x, seq_lens=None, name=None):
    """Reverse the valid prefix of each row, padding stays in place."""
    if seq_lens is None:
        return forward_op("sequence_reverse", lambda xv: torch.flip(xv, (1,)),
                          [ensure_tensor(x)])

    def impl(xv, lv):
        j = torch.arange(xv.shape[1], device=xv.device)[None, :]
        src = torch.where(j < lv[:, None], lv[:, None] - 1 - j, j)
        return _take_rows(xv, src)
    return forward_op("sequence_reverse", impl,
                      [ensure_tensor(x), _lens(seq_lens)])


def _compact(xv, keep, fill):
    """Left-align the kept entries of each row (a stable sort of (kept ?
    position : T)); the tail gets ``fill``. Returns (out, new_lens)."""
    T = xv.shape[1]
    j = torch.arange(T, device=xv.device)[None, :]
    order = torch.sort(torch.where(keep, j, torch.full_like(j, T)), dim=1,
                       stable=True).indices
    g = torch.gather(xv, 1, order)
    new_lens = keep.sum(1)
    return torch.where(j < new_lens[:, None], g, torch.full_like(g, fill)), \
        new_lens


def sequence_erase(x, tokens, seq_lens, name=None):
    """Remove every occurrence of ``tokens`` from each sequence, left-align
    the survivors, pad the tail with 0. Returns ``(out, new_lens)``."""
    toks = [int(t) for t in tokens]

    def impl(xv, lv):
        valid = _valid(lv, xv.shape[1])
        keep = valid & ~torch.isin(xv, torch.as_tensor(
            toks, dtype=xv.dtype, device=xv.device))
        return _compact(xv, keep, 0)
    return forward_op("sequence_erase", impl,
                      [ensure_tensor(x), _lens(seq_lens)],
                      differentiable=False)


def sequence_slice(x, offset, length, seq_lens=None, name=None):
    """Per-row slice ``x[b, offset[b] : offset[b]+length[b]]`` left-aligned
    into the same static capacity. Returns ``(out, length)``."""
    def impl(xv, ov, nv):
        T = xv.shape[1]
        j = torch.arange(T, device=xv.device)[None, :]
        out = _take_rows(xv, torch.clamp(ov[:, None] + j, 0, T - 1))
        mask = _trail(j < nv[:, None], xv.dim())
        return torch.where(mask, out, torch.zeros_like(out)), nv
    return forward_op("sequence_slice", impl,
                      [ensure_tensor(x), ensure_tensor(offset),
                       ensure_tensor(length)])


def sequence_concat(xs, lens_list, name=None):
    """Concatenate k dense batches along time per batch element, packing the
    valid prefixes back to back (static capacity = the sum of the inputs').
    Returns ``(out, new_lens)``."""
    ts = [ensure_tensor(x) for x in xs]
    ls = [_lens(v) for v in lens_list]
    caps = [int(t.shape[1]) for t in ts]
    total = sum(caps)

    def impl(*vals):
        k = len(ts)
        xvs, lvs = vals[:k], vals[k:]
        B = xvs[0].shape[0]
        trail = tuple(xvs[0].shape[2:])
        dev = xvs[0].device
        # one spare slot at ``total`` takes every padding row, then is cut
        out = torch.zeros((B, total + 1) + trail, dtype=xvs[0].dtype,
                          device=dev)
        start = torch.zeros(B, dtype=torch.long, device=dev)
        for xv, lv, cap in zip(xvs, lvs, caps):
            j = torch.arange(cap, device=dev)[None, :]
            dest = torch.where(j < lv[:, None], start[:, None] + j,
                               torch.full_like(j, total))
            idx = _trail(dest, xv.dim()).expand(xv.shape)
            out = out.scatter(1, idx, xv)
            start = start + lv.long()
        return out[:, :total], sum(lvs)
    return forward_op("sequence_concat", impl, ts + ls)


def sequence_scatter(x, index, updates, name=None):
    """Per-row scatter-add: ``out[b, index[b, k]] += updates[b, k]``."""
    return forward_op(
        "sequence_scatter",
        lambda xv, iv, uv: xv.scatter_add(1, iv.long(), uv.to(xv.dtype)),
        [ensure_tensor(x), ensure_tensor(index), ensure_tensor(updates)])


def sequence_enumerate(x, win_size: int, pad_value: int = 0, name=None):
    """Sliding id windows: out[b, t] = x[b, t : t+win] with tail padding."""
    def impl(xv):
        T = xv.shape[1]
        j = (torch.arange(T, device=xv.device)[:, None]
             + torch.arange(win_size, device=xv.device)[None, :])
        out = xv[:, torch.clamp(j, 0, T - 1)]
        return torch.where(j[None] < T, out, torch.full_like(out, pad_value))
    return forward_op("sequence_enumerate", impl, [ensure_tensor(x)],
                      differentiable=False)


# -- softmax / pool / conv — masked compute -------------------------------------

def sequence_softmax(x, seq_lens, name=None):
    """Masked softmax over the valid prefix of each row; padding gets 0."""
    def impl(xv, lv):
        valid = _valid(lv, xv.shape[1])
        p = torch.softmax(torch.where(valid, xv, torch.full_like(
            xv, float("-inf"))), dim=1)
        return torch.where(valid, p, torch.zeros_like(p))
    return forward_op("sequence_softmax", impl,
                      [ensure_tensor(x), _lens(seq_lens)])


_POOLS = ("average", "mean", "sum", "sqrt", "max", "min", "last", "first")


def sequence_pool(x, pool_type: str, seq_lens, pad_value: float = 0.0,
                  name=None):
    """Pool the valid prefix per row: average/sum/sqrt/max/min/last/first.
    Empty sequences yield ``pad_value``."""
    pt = pool_type.lower()
    if pt not in _POOLS:
        raise ValueError(f"unknown pool_type {pool_type!r}")

    def impl(xv, lv):
        B, T = xv.shape[:2]
        valid = _trail(_valid(lv, T), xv.dim())
        lf = torch.clamp(lv.to(xv.dtype), min=1).reshape(
            (B,) + (1,) * (xv.dim() - 2))
        zero = torch.zeros_like(xv)
        if pt in ("average", "mean"):
            out = torch.where(valid, xv, zero).sum(1) / lf
        elif pt == "sum":
            out = torch.where(valid, xv, zero).sum(1)
        elif pt == "sqrt":
            out = torch.where(valid, xv, zero).sum(1) / torch.sqrt(lf)
        elif pt == "max":
            out = torch.where(valid, xv, torch.full_like(
                xv, float("-inf"))).amax(1)
        elif pt == "min":
            out = torch.where(valid, xv, torch.full_like(
                xv, float("inf"))).amin(1)
        elif pt == "first":
            out = xv[:, 0]
        else:  # last
            idx = torch.clamp(lv - 1, min=0)[:, None]
            out = _take_rows(xv, idx)[:, 0]
        empty = (lv == 0).reshape((B,) + (1,) * (out.dim() - 1))
        return torch.where(empty, torch.full_like(out, pad_value), out)
    return forward_op("sequence_pool", impl,
                      [ensure_tensor(x), _lens(seq_lens)])


def sequence_first_step(x, seq_lens, name=None):
    """First valid timestep per row."""
    return sequence_pool(x, "first", seq_lens)


def sequence_last_step(x, seq_lens, name=None):
    """Last valid timestep per row."""
    return sequence_pool(x, "last", seq_lens)


def _window_tape(xv, offs, lv):
    """``win[b, t, c] = xv[b, t + offs[c]]``, zero outside the sequence
    (and past each row's length when ``lv`` is given)."""
    T = xv.shape[1]
    j = torch.arange(T, device=xv.device)[:, None] + offs[None, :]
    mask = ((j >= 0) & (j < T))[None, :, :, None]
    if lv is not None:
        mask = mask & (j[None] < lv[:, None, None])[..., None]
    win = xv[:, torch.clamp(j, 0, T - 1)]
    return torch.where(mask, win, torch.zeros_like(win))


def sequence_conv(x, weight, context_length: int, context_start=None,
                  seq_lens=None, bias=None, name=None):
    """Context-window projection: each timestep sees the concatenation of
    ``context_length`` neighbors starting at ``context_start``, projected
    by ``weight [context_length*D, M]`` in ONE matmul; out-of-sequence
    context rows are zero."""
    if context_start is None:
        context_start = -((context_length - 1) // 2)
    args = [ensure_tensor(x), ensure_tensor(weight)]
    if seq_lens is not None:
        args.append(_lens(seq_lens))
    if bias is not None:
        args.append(ensure_tensor(bias))

    def impl(xv, wv, *rest):
        lv = rest[0] if seq_lens is not None else None
        bv = rest[-1] if bias is not None else None
        B, T, D = xv.shape
        offs = torch.arange(context_length, device=xv.device) + context_start
        win = _window_tape(xv, offs, lv)
        out = win.reshape(B, T, context_length * D) @ wv
        if bv is not None:
            out = out + bv
        if lv is not None:
            out = torch.where(_valid(lv, T)[..., None], out,
                              torch.zeros_like(out))
        return out
    return forward_op("sequence_conv", impl, args)


def row_conv(x, weight, seq_lens=None, name=None):
    """Lookahead (row) convolution: out[b,t] = sum_k x[b,t+k] * w[k]
    elementwise over channels, k in [0, future_context]."""
    args = [ensure_tensor(x), ensure_tensor(weight)]
    if seq_lens is not None:
        args.append(_lens(seq_lens))

    def impl(xv, wv, *rest):
        lv = rest[0] if rest else None
        T = xv.shape[1]
        win = _window_tape(xv, torch.arange(wv.shape[0], device=xv.device),
                           lv)
        out = torch.einsum("btkd,kd->btd", win, wv)
        if lv is not None:
            out = torch.where(_valid(lv, T)[..., None], out,
                              torch.zeros_like(out))
        return out
    return forward_op("row_conv", impl, args)


def im2sequence(x, filter_size, stride=1, padding=0, name=None):
    """Image -> patch sequence: ``[B, C, H, W]`` to ``[B, OH*OW, C*kh*kw]``
    (one ``F.unfold`` call)."""
    k = (filter_size, filter_size) if isinstance(filter_size, int) \
        else tuple(filter_size)
    s = (stride, stride) if isinstance(stride, int) else tuple(stride)
    p = (padding, padding) if isinstance(padding, int) else tuple(padding)
    return forward_op(
        "im2sequence",
        lambda xv: F.unfold(xv, k, padding=p, stride=s).transpose(1, 2),
        [ensure_tensor(x)])

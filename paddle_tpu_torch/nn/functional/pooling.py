"""Pooling functionals — counterpart of
``paddle_tpu/nn/functional/pooling.py`` (python/paddle/nn/functional/
pooling.py in Paddle).

The reference reduces windows with ``lax.reduce_window``; here each pool
is one ``torch.nn.functional`` pool (cuDNN or ATen's kernels on the
card) under the reference's op name, with its window rules kept:

* ``ceil_mode`` extends the high pad so the last partial window counts,
  and drops a window that would start inside the right pad (Paddle's and
  torch's rule); the cells it adds are the reduction's identity;
* average pooling divides by the cells inside the input when
  ``exclusive`` (torch's ``count_include_pad=False``), else by the whole
  window (``divisor_override`` = the window's size), or by
  ``divisor_override``;
* symmetric pads no wider than half the window go to torch's own
  ``padding``; any other pad (asymmetric, wider, XLA's ``"SAME"``) is an
  explicit ``F.pad`` with the identity (``-inf`` for max), and the
  divisor of an exclusive average is counted on a mask padded alike;
* ``return_mask`` is computed on the device by the pool itself
  (``return_indices``): the flat index into the unpadded input plane,
  Paddle's convention — the reference builds it on the host in numpy and
  gets it wrong under ``ceil_mode`` (ROADMAP §C).

Channels-last inputs are permuted to channels-first as a view and back,
as in ``conv.py``. 1-D pools run as 2-D pools over a height of one.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as TF

from ...ops._helpers import ensure_tensor, forward_op
from .conv import (_CHANNELS_LAST, _padding, _tuple, pad_input, same_pads,
                   to_first, to_last)

_MAX = {2: TF.max_pool2d, 3: TF.max_pool3d}
_AVG = {2: TF.avg_pool2d, 3: TF.avg_pool3d}


def _window(rank, kernel, stride, padding, ceil_mode, in_sp):
    """(k, s, pads, string pad, torch pad): pads are (lo, hi) pairs with
    ``ceil_mode``'s extension already in the high pad (as the reference's
    ``_window``); the torch pad is the symmetric ``padding`` that torch's
    pools take with the same ``ceil_mode`` for the same windows, or None
    where they cannot."""
    k = _tuple(kernel, rank)
    s = _tuple(stride if stride is not None else kernel, rank)
    pad = _padding(padding, rank)
    if isinstance(pad, str):
        pads = same_pads(in_sp, k, s, (1,) * rank) if pad == "SAME" \
            else [(0, 0)] * rank
        return k, s, pads, True, None
    pads = list(pad)
    tp = _torch_pads(pads, k)
    if ceil_mode:
        for i in range(rank):
            lo, hi = pads[i]
            span = in_sp[i] + lo + hi - k[i]
            out_ceil = -(-span // s[i]) + 1
            if (out_ceil - 1) * s[i] >= in_sp[i] + lo:
                out_ceil -= 1
            extra = (out_ceil - 1) * s[i] + k[i] - (in_sp[i] + lo + hi)
            pads[i] = (lo, hi + max(0, extra))
    return k, s, pads, False, tp


def _torch_pads(pads, k):
    """torch's symmetric ``padding`` for ``pads`` if it can take them."""
    if all(lo == hi and 2 * lo <= kk for (lo, hi), kk in zip(pads, k)):
        return tuple(lo for lo, _ in pads)
    return None


def _as2d(v, rank):
    return v.unsqueeze(-2) if rank == 1 else v


def _from2d(v, rank):
    return v.squeeze(-2) if rank == 1 else v


def _flat_index(idx, pads, in_sp):
    """Indices into a padded plane (``in_sp`` padded by ``pads``) as flat
    indices into the unpadded one."""
    padded = [n + lo + hi for n, (lo, hi) in zip(in_sp, pads)]
    coords, rem = [], idx
    for n in reversed(padded):
        coords.append(rem % n)
        rem = torch.div(rem, n, rounding_mode="floor")
    coords = coords[::-1]
    flat = torch.zeros_like(idx)
    for c, n, (lo, _) in zip(coords, in_sp, pads):
        flat = flat * n + (c - lo)
    return flat


def _pool(rank, avg):
    op_name = f"{'avg' if avg else 'max'}_pool{rank}d"

    def pool(x, kernel_size, stride=None, padding=0, ceil_mode=False,
             exclusive=True, divisor_override=None, data_format=None,
             return_mask=False, name=None, count_include_pad=None):
        x = ensure_tensor(x)
        channels_last = data_format in _CHANNELS_LAST
        in_sp = tuple(x.shape[1:-1] if channels_last else x.shape[2:])
        k, s, pads, str_pad, tp = _window(rank, kernel_size, stride,
                                          padding, ceil_mode, in_sp)
        if count_include_pad is not None:
            exclusive = not count_include_pad
        mask = bool(return_mask) and not avg

        def impl(v):
            if channels_last:
                v = to_first(v, rank)
            v = _as2d(v, rank)
            r2 = max(rank, 2)
            k2 = ((1,) + k) if rank == 1 else k
            s2 = ((1,) + s) if rank == 1 else s
            p2 = ([(0, 0)] + pads) if rank == 1 else pads
            t2 = None if tp is None else ((0,) + tp if rank == 1 else tp)
            if avg:
                out = _avg_pool(v, r2, k2, s2, p2, t2, ceil_mode,
                                exclusive and not str_pad, divisor_override)
                outs = (out,)
            else:
                out = _max_pool(v, r2, k2, s2, p2, t2, ceil_mode, mask)
                outs = out if mask else (out,)
            outs = tuple(_from2d(o, rank) for o in outs)
            if channels_last:
                outs = tuple(to_last(o, rank) for o in outs)
            return outs if mask else outs[0]

        return forward_op(op_name, impl, [x])

    pool.__name__ = op_name
    pool.__qualname__ = op_name
    return pool


def _max_pool(v, r2, k2, s2, p2, tp, ceil_mode, mask):
    in_sp = v.shape[2:]
    if tp is not None:
        return _MAX[r2](v, k2, s2, tp, ceil_mode=ceil_mode,
                        return_indices=mask)
    vp = pad_input(v, p2, value=float("-inf"))
    out = _MAX[r2](vp, k2, s2, 0, return_indices=mask)
    if mask:
        out, idx = out
        return out, _flat_index(idx, p2, in_sp)
    return out


def _avg_pool(v, r2, k2, s2, p2, tp, ceil_mode, exclusive, divisor_override):
    size = math.prod(k2)
    if tp is not None:
        if divisor_override:
            return _AVG[r2](v, k2, s2, tp, ceil_mode,
                            divisor_override=divisor_override)
        if exclusive:
            return _AVG[r2](v, k2, s2, tp, ceil_mode,
                            count_include_pad=False)
        return _AVG[r2](v, k2, s2, tp, ceil_mode, divisor_override=size)
    summed = _AVG[r2](pad_input(v, p2), k2, s2, 0, divisor_override=1)
    if divisor_override:
        return summed / divisor_override
    if exclusive:
        ones = torch.ones((1, 1) + tuple(v.shape[2:]), dtype=v.dtype,
                          device=v.device)
        counts = _AVG[r2](pad_input(ones, p2), k2, s2, 0, divisor_override=1)
        return summed / counts
    return summed / size


max_pool1d = _pool(1, False)
max_pool2d = _pool(2, False)
max_pool3d = _pool(3, False)
avg_pool1d = _pool(1, True)
avg_pool2d = _pool(2, True)
avg_pool3d = _pool(3, True)


def _adaptive(rank, avg):
    op_name = f"adaptive_{'avg' if avg else 'max'}_pool{rank}d"

    def pool(x, output_size, data_format=None, return_mask=False, name=None):
        """Adaptive pooling: bin i spans floor(i·n/o) to ceil((i+1)·n/o),
        the reference's bins and torch's."""
        x = ensure_tensor(x)
        channels_last = data_format in _CHANNELS_LAST
        out_sp = tuple(output_size) if isinstance(output_size, (list, tuple)) \
            else (output_size,)
        if len(out_sp) == 1:
            out_sp = out_sp * rank
        in_sp = tuple(x.shape[1:-1] if channels_last else x.shape[2:])
        out_sp = tuple(in_sp[i] if out_sp[i] is None else int(out_sp[i])
                       for i in range(rank))
        mask = bool(return_mask) and not avg
        fn = getattr(TF, op_name)

        def impl(v):
            if channels_last:
                v = to_first(v, rank)
            out = fn(v, out_sp, return_indices=True) if mask else \
                fn(v, out_sp)
            if channels_last:
                out = tuple(to_last(o, rank) for o in out) if mask else \
                    to_last(out, rank)
            return out

        return forward_op(op_name, impl, [x])

    pool.__name__ = op_name
    pool.__qualname__ = op_name
    return pool


adaptive_avg_pool1d = _adaptive(1, True)
adaptive_avg_pool2d = _adaptive(2, True)
adaptive_avg_pool3d = _adaptive(3, True)
adaptive_max_pool1d = _adaptive(1, False)
adaptive_max_pool2d = _adaptive(2, False)
adaptive_max_pool3d = _adaptive(3, False)


def _lp_pool(rank):
    fmt = {1: "NLC", 2: "NHWC"}[rank]

    def lp_pool(x, norm_type, kernel_size, stride=None, padding=0,
                ceil_mode=False, data_format=None, name=None):
        """Power-average pooling: (sum over the window of |x|^p)^(1/p)."""
        x = ensure_tensor(x)
        p = float(norm_type)
        channels_last = data_format == fmt
        in_sp = tuple(x.shape[1:-1] if channels_last else x.shape[2:])
        k, s, pads, _, _ = _window(rank, kernel_size, stride, padding,
                                   ceil_mode, in_sp)

        def impl(v):
            if channels_last:
                v = to_first(v, rank)
            v = _as2d(v.abs() ** p, rank)
            k2 = ((1,) + k) if rank == 1 else k
            s2 = ((1,) + s) if rank == 1 else s
            p2 = ([(0, 0)] + pads) if rank == 1 else pads
            summed = TF.avg_pool2d(pad_input(v, p2), k2, s2, 0,
                                   divisor_override=1)
            out = _from2d(summed ** (1.0 / p), rank)
            return to_last(out, rank) if channels_last else out

        return forward_op(f"lp_pool{rank}d", impl, [x])

    lp_pool.__name__ = f"lp_pool{rank}d"
    lp_pool.__qualname__ = lp_pool.__name__
    return lp_pool


lp_pool1d = _lp_pool(1)
lp_pool2d = _lp_pool(2)


def _fractional_pool(nd):
    def op(x, output_size, kernel_size=None, random_u=None, return_mask=False,
           name=None):
        """Fractional max pooling (Graham 2014; ATen's interval formula —
        start_i = floor((i+u)·a) - floor(u·a), a = (in-k)/(out-1), a fixed
        k-window, the last window right-aligned; ref:
        nn.functional.fractional_max_pool2d/3d). Deterministic given
        ``random_u``; otherwise u is drawn from the framework RNG."""
        x = ensure_tensor(x)
        spatial = tuple(x.shape[2:])
        out_sz = (output_size,) * nd if isinstance(output_size, int) else \
            tuple(int(o) for o in output_size)
        if kernel_size is None:
            ks = tuple(spatial[d] // out_sz[d] for d in range(nd))
        elif isinstance(kernel_size, int):
            ks = (kernel_size,) * nd
        else:
            ks = tuple(int(k) for k in kernel_size)
        if random_u is None:
            from ...ops import random as _rnd
            u = float(_rnd.uniform([1], min=0.0, max=1.0).numpy()[0])
        else:
            u = float(random_u)

        def starts(n_in, n_out, k):
            if n_out == 1:
                return [0]
            a = (n_in - k) / (n_out - 1)
            return [(n_in - k) if i == n_out - 1 else
                    int((i + u) * a) - int(u * a) for i in range(n_out)]

        st = [starts(spatial[d], out_sz[d], ks[d]) for d in range(nd)]

        def impl(v):
            # each dim's window positions [out, k]; one gather of every
            # window, [N, C, *out, *k]
            dev = v.device
            idx = [torch.tensor(st[d], device=dev)[:, None] +
                   torch.arange(ks[d], device=dev)[None, :]
                   for d in range(nd)]
            grids = []
            for d in range(nd):
                shape = [1] * (2 * nd)
                shape[d], shape[nd + d] = out_sz[d], ks[d]
                pos = idx[d]
                grids.append(pos.reshape(
                    [out_sz[d] if i == d else 1 for i in range(nd)] +
                    [ks[d] if i == d else 1 for i in range(nd)]))
            win = v[(slice(None), slice(None)) + tuple(grids)]
            flat = win.reshape(v.shape[:2] + out_sz + (-1,))
            out = flat.amax(-1)
            if not return_mask:
                return out
            loc = flat.argmax(-1)
            pos, rem = torch.zeros_like(loc), loc
            strides = [math.prod(ks[d + 1:]) for d in range(nd)]
            for d in range(nd):
                kd = torch.div(rem, strides[d], rounding_mode="floor")
                rem = rem - kd * strides[d]
                start = torch.tensor(st[d], device=dev).reshape(
                    [out_sz[d] if i == d else 1 for i in range(nd)])
                pos = pos * spatial[d] + start + kd
            return out, pos

        return forward_op(f"fractional_max_pool{nd}d", impl, [x])

    op.__name__ = f"fractional_max_pool{nd}d"
    op.__qualname__ = op.__name__
    return op


fractional_max_pool2d = _fractional_pool(2)
fractional_max_pool3d = _fractional_pool(3)


def _unpool_nd(op_name, spatial):
    def op(x, indices, kernel_size, stride=None, padding=0,
           output_size=None, data_format=None, name=None):
        xt, it = ensure_tensor(x), ensure_tensor(indices)
        ks = _tuple(kernel_size, spatial)
        st = ks if stride is None else _tuple(stride, spatial)
        pd = _tuple(padding, spatial)
        in_sp = [int(s) for s in xt.shape[2:]]
        if output_size is None:
            out_sp = [(in_sp[d] - 1) * st[d] - 2 * pd[d] + ks[d]
                      for d in range(spatial)]
        else:
            out_sp = [int(s) for s in tuple(output_size)[-spatial:]]

        def impl(xv, iv):
            # one scatter of each value's position picks the value that
            # lands in each cell (the last at a duplicated index, as XLA's
            # scatter), and one gather reads it: only that value gets a
            # gradient, as in the reference. An index outside the plane is
            # dropped (XLA drops an out-of-bounds scatter): it lands in
            # one spare slot.
            n, c = xv.shape[:2]
            plane = math.prod(out_sp)
            src = xv.reshape(n, c, -1)
            idx = iv.reshape(n, c, -1).long()
            idx = torch.where((idx >= 0) & (idx < plane), idx, plane)
            pos = torch.arange(src.shape[-1], device=src.device).expand_as(idx)
            winner = torch.full((n, c, plane + 1), -1, dtype=torch.long,
                                device=src.device).scatter(2, idx, pos)
            winner = winner[..., :plane]
            out = torch.where(winner >= 0,
                              src.gather(2, winner.clamp(min=0)), 0.0)
            return out.reshape([n, c] + out_sp).to(xv.dtype)

        return forward_op(op_name, impl, [xt, it])

    op.__name__ = op_name
    op.__qualname__ = op_name
    op.__doc__ = (f"Inverse of max_pool{spatial}d with return_mask=True: "
                  f"scatters values back to their argmax positions (ref: "
                  f"paddle.nn.functional.{op_name} / fluid unpool op).")
    return op


max_unpool1d = _unpool_nd("max_unpool1d", 1)
max_unpool2d = _unpool_nd("max_unpool2d", 2)
max_unpool3d = _unpool_nd("max_unpool3d", 3)


def max_pool2d_with_index(x, kernel_size, stride=None, padding=0,
                          global_pooling=False, adaptive=False, name=None):
    """max_pool2d that always returns (out, argmax indices) — the
    upstream kernel behind return_mask."""
    if global_pooling:
        kernel_size = [int(s) for s in ensure_tensor(x).shape[2:]]
        stride, padding = kernel_size, 0
    return max_pool2d(x, kernel_size, stride=stride, padding=padding,
                      return_mask=True)


def max_pool3d_with_index(x, kernel_size, stride=None, padding=0,
                          global_pooling=False, adaptive=False, name=None):
    """3-D twin of max_pool2d_with_index: symmetric pads, no ceil; the
    indices are int32 flat positions in each [D*H*W] plane."""
    xt = ensure_tensor(x)
    ks = _tuple(kernel_size, 3)
    st = ks if stride is None else _tuple(stride, 3)
    pads = [(p, p) for p in _tuple(padding, 3)]

    def impl(v):
        out, idx = _max_pool(v, 3, ks, st, pads, _torch_pads(pads, ks),
                                 False, True)
        return out, idx.to(torch.int32)

    return forward_op("max_pool3d_with_index", impl, [xt])


def spp(x, pyramid_height: int = 3, pool_type: str = "max", name=None):
    """Spatial pyramid pooling (ref: spp_op): adaptive pools at 1x1, 2x2,
    ... 2^(h-1) grids, flattened and concatenated."""
    from ...ops.manipulation import concat, reshape
    xt = ensure_tensor(x)
    outs = []
    for lvl in range(pyramid_height):
        bins = 2 ** lvl
        p = adaptive_max_pool2d(xt, bins) if pool_type == "max" else \
            adaptive_avg_pool2d(xt, bins)
        outs.append(reshape(p, [int(p.shape[0]), -1]))
    return concat(outs, axis=1)


def unpool(x, indices, kernel_size, stride=None, padding=0,
           output_size=None, name=None):
    """Legacy name for max_unpool2d (ref: unpool_op)."""
    return max_unpool2d(x, indices, kernel_size, stride, padding, output_size)


def unpool3d(x, indices, kernel_size, stride=None, padding=0,
             output_size=None, name=None):
    """Legacy name for max_unpool3d (ref: unpool3d_op)."""
    return max_unpool3d(x, indices, kernel_size, stride, padding, output_size)


def _legacy_pool(max_fn, avg_fn):
    def pool(x, pool_size, pool_type: str = "max", pool_stride=1,
             pool_padding=0, global_pooling: bool = False,
             ceil_mode: bool = False, exclusive: bool = True, name=None):
        if global_pooling:
            pool_size = [int(s) for s in ensure_tensor(x).shape[2:]]
            pool_stride, pool_padding = pool_size, 0
        if pool_type == "max":
            return max_fn(x, pool_size, stride=pool_stride,
                          padding=pool_padding, ceil_mode=ceil_mode)
        return avg_fn(x, pool_size, stride=pool_stride, padding=pool_padding,
                      ceil_mode=ceil_mode, exclusive=exclusive)
    return pool


pool2d = _legacy_pool(max_pool2d, avg_pool2d)
pool2d.__name__ = pool2d.__qualname__ = "pool2d"
pool2d.__doc__ = ("Legacy merged pooling op (ref: pool2d_op): max or avg "
                  "selected by attribute.")
pool3d = _legacy_pool(max_pool3d, avg_pool3d)
pool3d.__name__ = pool3d.__qualname__ = "pool3d"
pool3d.__doc__ = "Legacy merged 3-D pooling op (ref: pool3d_op)."

__all__ = ["max_pool1d", "max_pool2d", "max_pool3d", "avg_pool1d",
           "avg_pool2d", "avg_pool3d", "adaptive_avg_pool1d",
           "adaptive_avg_pool2d", "adaptive_avg_pool3d",
           "adaptive_max_pool1d", "adaptive_max_pool2d",
           "adaptive_max_pool3d", "lp_pool1d", "lp_pool2d",
           "fractional_max_pool2d", "fractional_max_pool3d", "max_unpool1d",
           "max_unpool2d", "max_unpool3d", "max_pool2d_with_index",
           "max_pool3d_with_index", "spp", "unpool", "unpool3d", "pool2d",
           "pool3d"]

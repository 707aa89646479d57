"""Convolution functionals — counterpart of
``paddle_tpu/nn/functional/conv.py`` (python/paddle/nn/functional/conv.py
in Paddle).

Each call is one ``forward_op`` under the reference's op name
(``conv2d``, ``conv2d_transpose``, ...), so ``amp.auto_cast``'s white
list, the profiler and ``enforce``'s typed errors reach it, and its body
is one ``torch.nn.functional.conv*`` call (cuDNN on the card). What the
reference hands to XLA is resolved here before that call:

* ``"SAME"`` / ``"VALID"`` padding is XLA's: SAME pads
  ``max((ceil(n/s)-1)·s + (k-1)·d + 1 - n, 0)`` with the low half
  rounded down (torch's ``padding="same"`` refuses a stride above 1);
* asymmetric pads (``[[lo, hi], ...]`` or ``[b0, a0, b1, a1, ...]``) are
  an ``F.pad`` before a conv with no padding of its own;
* a transposed conv keeps the reference's output length
  ``(n-1)·s - lo - hi + d·(k-1) + 1 + output_padding`` for every pad,
  ``output_padding`` and dilation (torch's own ``padding`` takes
  symmetric pads and ``output_padding < max(stride, dilation)``; any
  other case runs unpadded and is cut to that window). ``output_size``
  is accepted and not applied, and string pads raise, as in the
  reference.

Channels-last (``NLC`` / ``NHWC`` / ``NDHWC``) is Paddle's logical
layout: the input is permuted to channels-first as a view (in memory it
is ``torch.channels_last`` when the caller's tensor is contiguous NHWC),
cuDNN picks its NHWC kernels for such a view, and the result is permuted
back — no copy inside the net. Weights keep Paddle's (and torch's)
``[out, in/groups, *k]`` (transposed: ``[in, out/groups, *k]``) in
either layout.
"""

from __future__ import annotations

import numpy as np
import torch.nn.functional as TF

from ...ops._helpers import ensure_tensor, forward_op

_CHANNELS_LAST = ("NLC", "NHWC", "NDHWC")
_CONV = {1: TF.conv1d, 2: TF.conv2d, 3: TF.conv3d}
_CONVT = {1: TF.conv_transpose1d, 2: TF.conv_transpose2d,
          3: TF.conv_transpose3d}


def _tuple(v, n):
    if isinstance(v, (int, np.integer)):
        return (int(v),) * n
    t = tuple(int(x) for x in v)
    if len(t) == 1:
        return t * n
    return t


def _padding(padding, n):
    """``"SAME"`` / ``"VALID"``, or ``n`` (lo, hi) pairs."""
    if isinstance(padding, str):
        return padding.upper()
    if isinstance(padding, (int, np.integer)):
        return [(int(padding), int(padding))] * n
    padding = list(padding)
    if all(isinstance(p, (list, tuple)) for p in padding):
        return [tuple(int(x) for x in p) for p in padding]
    if len(padding) == n:
        return [(int(p), int(p)) for p in padding]
    if len(padding) == 2 * n:  # [before0, after0, before1, after1, ...]
        return [(int(padding[2 * i]), int(padding[2 * i + 1]))
                for i in range(n)]
    raise ValueError(f"bad padding {padding}")


def same_pads(in_sp, k, s, d):
    """XLA's SAME padding: (lo, hi) per spatial dim."""
    pads = []
    for n, kk, ss, dd in zip(in_sp, k, s, d):
        out = -(-n // ss)
        total = max((out - 1) * ss + (kk - 1) * dd + 1 - n, 0)
        pads.append((total // 2, total - total // 2))
    return pads


def resolve_pads(pad, in_sp, k, s, d):
    if pad == "SAME":
        return same_pads(in_sp, k, s, d)
    if pad == "VALID":
        return [(0, 0)] * len(in_sp)
    return list(pad)


def to_first(v, rank):
    """Channels-last to channels-first, as a view."""
    return v.permute(0, rank + 1, *range(1, rank + 1))


def to_last(v, rank):
    """Channels-first to channels-last, as a view."""
    return v.permute(0, *range(2, rank + 2), 1)


def pad_input(v, pads, value=0.0):
    """``F.pad`` of the spatial dims by (lo, hi) pairs (last dim first)."""
    flat = []
    for lo, hi in reversed(pads):
        flat += [lo, hi]
    return TF.pad(v, flat, value=value) if any(flat) else v


def _symmetric(pads):
    return all(lo == hi for lo, hi in pads)


def _conv(rank: int):
    def conv(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
             data_format=None, name=None):
        x, weight = ensure_tensor(x), ensure_tensor(weight)
        channels_last = data_format in _CHANNELS_LAST
        s = _tuple(stride, rank)
        d = _tuple(dilation, rank)
        pad = _padding(padding, rank)
        args = [x, weight] + ([ensure_tensor(bias)] if bias is not None else [])

        def impl(v, w, *b):
            if channels_last:
                v = to_first(v, rank)
            pads = resolve_pads(pad, v.shape[2:], w.shape[2:], s, d)
            if _symmetric(pads):
                tp = tuple(lo for lo, _ in pads)
            else:
                v, tp = pad_input(v, pads), 0
            out = _CONV[rank](v, w, b[0] if b else None, s, tp, d, groups)
            return to_last(out, rank) if channels_last else out

        return forward_op(f"conv{rank}d", impl, args)

    conv.__name__ = f"conv{rank}d"
    conv.__qualname__ = conv.__name__
    return conv


conv1d = _conv(1)
conv2d = _conv(2)
conv3d = _conv(3)


def _conv_transpose(rank: int):
    convt_fn = _CONVT[rank]

    def convt(x, weight, bias=None, stride=1, padding=0, output_padding=0,
              groups=1, dilation=1, data_format=None, output_size=None,
              name=None):
        x, weight = ensure_tensor(x), ensure_tensor(weight)
        channels_last = data_format in _CHANNELS_LAST
        s = _tuple(stride, rank)
        d = _tuple(dilation, rank)
        op = _tuple(output_padding, rank)
        pads = _padding(padding, rank)
        if isinstance(pads, str):
            # as the reference (XLA's conv_general_dilated takes no string
            # padding with an input dilation)
            raise ValueError("string padding is not implemented for "
                             "transposed convolution; give the pads")
        args = [x, weight] + ([ensure_tensor(bias)] if bias is not None else [])

        def impl(v, w, *b):
            if channels_last:
                v = to_first(v, rank)
            opad, bv = op, (b[0] if b else None)
            if _symmetric(pads) and all(p >= 0 for p, _ in pads) and all(
                    o < max(ss, dd) for o, ss, dd in zip(opad, s, d)):
                out = convt_fn(v, w, bv, s, tuple(p for p, _ in pads),
                               opad, groups, d)
            else:
                full = convt_fn(v, w, None, s, 0, 0, groups, d)
                out = _window(full, pads, opad)
                if bv is not None:
                    out = out + bv.reshape((1, -1) + (1,) * rank)
            return to_last(out, rank) if channels_last else out

        return forward_op(f"conv{rank}d_transpose", impl, args)

    convt.__name__ = f"conv{rank}d_transpose"
    convt.__qualname__ = convt.__name__
    return convt


def _window(full, pads, opad):
    """``full`` (the transposed conv with no padding) cut to the
    reference's window: from ``lo`` to ``len - hi + output_padding`` on
    each spatial dim, zeros past its end, nothing before its start."""
    rank = len(pads)
    lead, trail = [], []
    for i, ((lo, hi), o) in enumerate(zip(pads, opad)):
        n = full.shape[2 + i]
        length = n - lo - hi + o
        lead.append(-lo)                      # F.pad crops at a negative
        trail.append(length - (n - lo))       # pad, extends at a positive
    flat = []
    for i in reversed(range(rank)):
        flat += [lead[i], trail[i]]
    return TF.pad(full, flat)


conv1d_transpose = _conv_transpose(1)
conv2d_transpose = _conv_transpose(2)
conv3d_transpose = _conv_transpose(3)

# torch-style aliases (the reference ecosystem accepts both spellings)
conv_transpose1d = conv1d_transpose
conv_transpose2d = conv2d_transpose
conv_transpose3d = conv3d_transpose


# the reference's legacy op names (depthwise_conv2d_op,
# depthwise_conv2d_transpose_op, conv2d_fusion_op): one conv each


def depthwise_conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1,
                     data_format="NCHW", name=None):
    """Depthwise conv2d (groups == in_channels)."""
    groups = int(ensure_tensor(x).shape[1 if data_format == "NCHW" else -1])
    return conv2d(x, weight, bias=bias, stride=stride, padding=padding,
                  dilation=dilation, groups=groups, data_format=data_format)


def depthwise_conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                               output_padding=0, dilation=1,
                               data_format="NCHW", name=None):
    """Depthwise transposed conv2d."""
    groups = int(ensure_tensor(x).shape[1 if data_format == "NCHW" else -1])
    return conv2d_transpose(x, weight, bias=bias, stride=stride,
                            padding=padding, output_padding=output_padding,
                            dilation=dilation, groups=groups,
                            data_format=data_format)


def conv2d_fusion(x, weight, bias=None, residual=None, stride=1, padding=0,
                  dilation=1, groups=1, activation="relu",
                  data_format="NCHW", name=None):
    """conv + bias (+ residual) + activation in one call (ref:
    conv2d_fusion_op, the inference epilogue fusion)."""
    out = conv2d(x, weight, bias=bias, stride=stride, padding=padding,
                 dilation=dilation, groups=groups, data_format=data_format)
    if residual is not None:
        out = out + ensure_tensor(residual)
    from . import activation as _act
    if activation in (None, "", "identity"):
        return out
    return getattr(_act, activation)(out)


__all__ = ["conv1d", "conv2d", "conv3d", "conv1d_transpose",
           "conv2d_transpose", "conv3d_transpose", "conv_transpose1d",
           "conv_transpose2d", "conv_transpose3d", "depthwise_conv2d",
           "depthwise_conv2d_transpose", "conv2d_fusion"]

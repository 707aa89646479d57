"""Common functionals — counterpart of ``paddle_tpu/nn/functional/common.py``
(``python/paddle/nn/functional/common.py`` + ``input.py`` in Paddle):
linear, the dropouts, padding, embedding, one-hot, similarity and
normalization helpers, label smoothing, resampling (``interpolate`` /
``upsample`` and the ``*_interp`` modes) and the pixel and channel
shuffles. Dropout masks draw from the global generator of the input's
device (``ops/random.py``). ``unfold`` is here; its adjoint ``fold`` is in
``vision.py``, as in the reference. ``sparse_attention`` is
``sparse.nn.functional.attention`` under Paddle's name and layout.

``interpolate`` computes Paddle's contract (``interp_v2`` kernels), which
the reference's ``jax.image.resize`` departs from in places (ROADMAP §C):
nearest takes ``floor(dst * in / out)``; the linear modes take half-pixel
centres clamped at 0 (``align_mode=0``) or ``dst * in / out``
(``align_mode=1``), with no antialiasing; bicubic uses a = -0.75; ``area``
is an adaptive average pool; a given ``scale_factor`` sets the ratio to
its inverse.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as TF

from ...core.tensor import Tensor
from ...ops._helpers import ensure_tensor, forward_op
from ...ops.random import generator


def _promoted(*vs):
    """The operands in their promoted dtype, as ``jnp``'s matmul promotes
    (an fp32 input times a bf16 weight computes in fp32)."""
    dt = vs[0].dtype
    for v in vs[1:]:
        dt = torch.promote_types(dt, v.dtype)
    return [v.to(dt) for v in vs]


def linear(x, weight, bias=None, name=None):
    """y = x @ W + b with paddle weight layout [in, out] (ref: nn.functional.linear)."""
    x, weight = ensure_tensor(x), ensure_tensor(weight)
    if bias is not None:
        def f(v, w, b):
            v, w, b = _promoted(v, w, b)
            return v @ w + b
        return forward_op("linear", f, [x, weight, ensure_tensor(bias)])

    def g(v, w):
        v, w = _promoted(v, w)
        return v @ w
    return forward_op("linear", g, [x, weight])


def _keep_mask(v, p, shape):
    u = torch.empty(shape, dtype=torch.float32, device=v.device).uniform_(
        generator=generator(v.device))
    return u < (1.0 - p)


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train", name=None):
    x = ensure_tensor(x)
    if isinstance(p, Tensor):
        p = float(p.item())
    if not training or p == 0.0:
        if mode == "downscale_in_infer" and not training:
            return forward_op("dropout_scale", lambda v: v * (1.0 - p), [x])
        return x
    ax = (axis,) if isinstance(axis, int) else axis
    v0 = x._value
    shape = tuple(v0.shape) if ax is None else tuple(
        v0.shape[i] if i in ax else 1 for i in range(v0.dim()))
    keep = _keep_mask(v0, p, shape)

    def impl(v):
        zero = torch.zeros((), dtype=v.dtype, device=v.device)
        if mode == "upscale_in_train":
            return torch.where(keep, v / (1.0 - p), zero).to(v.dtype)
        return torch.where(keep, v, zero)

    return forward_op("dropout", impl, [x])


def dropout2d(x, p=0.5, training=True, data_format="NCHW", name=None):
    ax = (0, 1) if data_format == "NCHW" else (0, 3)
    return dropout(x, p, axis=list(ax), training=training)


def dropout3d(x, p=0.5, training=True, data_format="NCDHW", name=None):
    ax = (0, 1) if data_format == "NCDHW" else (0, 4)
    return dropout(x, p, axis=list(ax), training=training)


def alpha_dropout(x, p=0.5, training=True, name=None):
    x = ensure_tensor(x)
    if not training or p == 0.0:
        return x
    alpha = 1.6732632423543772
    scale = 1.0507009873554805
    alpha_p = -alpha * scale
    keep = _keep_mask(x._value, p, tuple(x._value.shape))

    def impl(v):
        a = (1.0 / np.sqrt((1 - p) * (1 + p * alpha_p ** 2)))
        b = -a * alpha_p * p
        return (a * torch.where(keep, v, torch.full_like(v, alpha_p)) + b
                ).to(v.dtype)

    return forward_op("alpha_dropout", impl, [x])


def _pad_index(n, lo, hi, mode, device):
    """Source indices of one padded dim for the non-constant modes."""
    i = torch.arange(-lo, n + hi, device=device)
    if mode == "replicate":
        return i.clamp(0, n - 1)
    if mode == "circular":
        return torch.remainder(i, n)
    period = 2 * (n - 1)                     # reflect: the edge not repeated
    m = torch.remainder(i, period) if period else torch.zeros_like(i)
    return torch.where(m < n, m, period - m)


def pad(x, pad, mode="constant", value=0.0, data_format=None, name=None):  # noqa: A002
    """paddle.nn.functional.pad: `pad` is per-dim [lo, hi] pairs; for 4-D/5-D inputs
    with data_format, `pad` covers only the spatial dims (paddle semantics)."""
    x = ensure_tensor(x)
    if isinstance(pad, Tensor):
        pad = [int(v) for v in pad.numpy().reshape(-1)]
    pad = [int(p) for p in pad]
    nd = x.ndim

    if len(pad) == 2 * nd:
        pairs = [(pad[2 * i], pad[2 * i + 1]) for i in range(nd)]
    else:
        # spatial-only padding per data_format; paddle orders pad back-to-front
        if data_format is None:
            data_format = {3: "NCL", 4: "NCHW", 5: "NCDHW"}[nd]
        n_spatial = len(pad) // 2
        spatial_pairs = [(pad[2 * i], pad[2 * i + 1]) for i in range(n_spatial)]
        pairs = [(0, 0)] * nd
        if data_format.startswith("NC"):
            for i, pr in enumerate(spatial_pairs):
                pairs[2 + i] = pr
        else:  # channels-last
            for i, pr in enumerate(spatial_pairs):
                pairs[1 + i] = pr
    if mode not in ("constant", "reflect", "replicate", "circular"):
        raise ValueError(f"pad: unknown mode {mode!r}")

    def impl(v):
        if mode == "constant":
            flat = [p for pr in reversed(pairs) for p in pr]
            return TF.pad(v, flat, mode="constant", value=value)
        for d, (lo, hi) in enumerate(pairs):
            if lo or hi:
                v = torch.index_select(
                    v, d, _pad_index(v.shape[d], lo, hi, mode, v.device))
        return v

    return forward_op("pad", impl, [x])


def zeropad2d(x, padding, data_format="NCHW", name=None):
    return pad(x, padding, mode="constant", value=0.0, data_format=data_format)


def pad2d(x, padding, mode="constant", value=0.0, data_format="NCHW",
          name=None):
    """Legacy 4-D pad (ref: pad2d_op) — routes to the general pad."""
    return pad(x, padding, mode=mode, value=value, data_format=data_format)


def pad3d(x, padding, mode="constant", value=0.0, data_format="NCDHW",
          name=None):
    """Legacy 5-D pad (ref: pad3d_op)."""
    return pad(x, padding, mode=mode, value=value, data_format=data_format)


def sparse_attention(query, key, value, sparse_csr_offset, sparse_csr_columns,
                     key_padding_mask=None, attn_mask=None, name=None):
    """Attention over ``[B, H, S, D]`` restricted to a CSR pattern a head
    (``paddle.nn.functional.sparse_attention``): Paddle's offsets ``[B, H,
    S + 1]`` and columns ``[B, H, nnz]``, or one ``[S + 1]`` / ``[nnz]``
    pattern for every head (the reference's only form). Runs
    ``sparse.nn.functional.attention``; masks are nonzero where kept."""
    from ... import sparse as _sp
    from ...core.tensor import _wrap
    q = ensure_tensor(query)
    B, H, S = (int(d) for d in q.shape[:3])
    off, cols = ensure_tensor(sparse_csr_offset), \
        ensure_tensor(sparse_csr_columns)
    ones = _wrap(torch.ones(cols._value.numel(), dtype=torch.float32,
                            device=cols._value.device))
    shape = [S, S] if off.ndim == 1 else [B * H, S, S]
    csr = _sp.sparse_csr_tensor(off.reshape([-1]), cols.reshape([-1]), ones,
                                shape=shape)
    return _sp.nn.functional.attention(query, key, value, csr,
                                       key_padding_mask=key_padding_mask,
                                       attn_mask=attn_mask)


def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    """Gather rows of `weight` (ref: nn.functional.embedding); `sparse` is
    accepted for API parity."""
    x, weight = ensure_tensor(x), ensure_tensor(weight)

    def impl(i, w):
        out = w[i.long()]
        if padding_idx is not None:
            out = torch.where((i == padding_idx)[..., None],
                              torch.zeros((), dtype=out.dtype,
                                          device=out.device), out)
        return out

    return forward_op("embedding", impl, [x, weight])


def one_hot(x, num_classes, name=None):
    from ...ops.creation import one_hot as _oh
    return _oh(x, num_classes)


def cosine_similarity(x1, x2, axis=1, eps=1e-8, name=None):
    x1, x2 = ensure_tensor(x1), ensure_tensor(x2)

    def impl(a, b):
        num = torch.sum(a * b, dim=int(axis))
        den = torch.linalg.vector_norm(a, dim=int(axis)) * \
            torch.linalg.vector_norm(b, dim=int(axis))
        return num / torch.clamp(den, min=eps)

    return forward_op("cosine_similarity", impl, [x1, x2])


def normalize(x, p=2, axis=1, epsilon=1e-12, name=None):
    x = ensure_tensor(x)

    def impl(v):
        n = torch.sum(v.abs() ** p, dim=int(axis), keepdim=True) ** (1.0 / p)
        return v / torch.clamp(n, min=epsilon)

    return forward_op("normalize", impl, [x])


def label_smooth(label, prior_dist=None, epsilon=0.1, name=None):
    label = ensure_tensor(label)
    prior = None if prior_dist is None else ensure_tensor(prior_dist)._value

    def impl(v):
        k = v.shape[-1]
        if prior is None:
            return (1 - epsilon) * v + epsilon / k
        return (1 - epsilon) * v + epsilon * prior

    return forward_op("label_smooth", impl, [label])


def pairwise_distance(x, y, p: float = 2.0, epsilon: float = 1e-6,
                      keepdim: bool = False, name=None):
    """p-norm distance between corresponding rows (ref:
    nn.functional.pairwise_distance / nn.PairwiseDistance)."""
    x, y = ensure_tensor(x), ensure_tensor(y)
    return forward_op("pairwise_distance",
                      lambda a, b: torch.linalg.vector_norm(
                          a - b + epsilon, ord=p, dim=-1, keepdim=keepdim),
                      [x, y])


def softmax2d(x, name=None):
    """Channel-wise softmax over NCHW inputs (ref: nn.Softmax2D)."""
    x = ensure_tensor(x)
    if x.ndim not in (3, 4):
        raise ValueError(f"softmax2d expects CHW or NCHW input, got rank "
                         f"{x.ndim}")
    return forward_op("softmax2d", lambda v: torch.softmax(v, dim=-3), [x])


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    """im2col (ref: nn.functional.unfold): [N, C, H, W] -> [N, C*kh*kw,
    L], channel-major as the reference's patches."""
    def pair(v):
        return (int(v), int(v)) if isinstance(v, int) else \
            tuple(int(a) for a in v)

    return forward_op("unfold", lambda v: TF.unfold(
        v, pair(kernel_sizes), dilation=pair(dilations),
        padding=pair(paddings), stride=pair(strides)), [ensure_tensor(x)])


# -- resampling ----------------------------------------------------------------

_CHANNELS_LAST = ("NWC", "NLC", "NHWC", "NDHWC")
_LINEAR_MODES = ("linear", "bilinear", "trilinear")


def _int_list(v):
    if isinstance(v, Tensor):
        return [int(s) for s in v.numpy().reshape(-1)]
    if isinstance(v, (list, tuple)):
        return [int(s.item()) if isinstance(s, Tensor) else int(s) for s in v]
    return [int(v.item()) if isinstance(v, Tensor) else int(v)]


def _float_list(v, n):
    if isinstance(v, Tensor):
        v = [float(s) for s in v.numpy().reshape(-1)]
    elif isinstance(v, (list, tuple)):
        v = [float(s.item()) if isinstance(s, Tensor) else float(s)
             for s in v]
    else:
        v = [float(v)] * n
    return v if len(v) == n else v * n


def _asymmetric_linear(v, out_sizes, scales):
    """Separable linear resize of the trailing axes of ``v`` with source
    position ``dst * ratio`` (Paddle's ``align_mode=1``): ``ratio`` is
    ``1 / scale`` when a scale was given, else ``in / out``."""
    n = len(out_sizes)
    for i, osz in enumerate(out_sizes):
        ax = v.dim() - n + i
        isz = v.shape[ax]
        ratio = 1.0 / scales[i] if scales else isz / osz
        pos = torch.arange(osz, dtype=torch.float32, device=v.device) * ratio
        i0 = torch.clamp(pos.floor().long(), 0, isz - 1)
        i1 = torch.clamp(i0 + 1, max=isz - 1)
        shape = [1] * v.dim()
        shape[ax] = osz
        w = (pos - i0.to(pos.dtype)).to(v.dtype).reshape(shape)
        v = torch.index_select(v, ax, i0) * (1 - w) + \
            torch.index_select(v, ax, i1) * w
    return v


def interpolate(x, size=None, scale_factor=None, mode="nearest",
                align_corners=False, align_mode=0, data_format="NCHW", name=None):
    """Resize the spatial axes (ref: nn.functional.interpolate → Paddle's
    ``*_interp_v2`` kernels; see the module note for the contract)."""
    x = ensure_tensor(x)
    mode = mode.lower()
    if mode not in ("nearest", "linear", "bilinear", "trilinear", "bicubic",
                    "area"):
        raise ValueError(f"interpolate: unknown mode {mode!r}")
    if align_corners and mode in ("nearest", "area"):
        raise ValueError("align_corners option can only be set with the "
                         "interpolating modes: linear | bilinear | bicubic "
                         "| trilinear")
    if align_mode not in (0, 1):
        raise ValueError("align_mode can only be 0 or 1")
    if (size is None) == (scale_factor is None):
        raise ValueError("interpolate: give exactly one of size and "
                         "scale_factor")
    n = x.ndim - 2
    channels_last = data_format in _CHANNELS_LAST
    spatial = list(x.shape[1:-1]) if channels_last else list(x.shape[2:])
    scales = None
    if size is not None:
        out_sizes = _int_list(size)
    else:
        scales = _float_list(scale_factor, n)
        out_sizes = [int(s * f) for s, f in zip(spatial, scales)]
    if len(out_sizes) != n:
        raise ValueError(f"interpolate: {len(out_sizes)} sizes for {n} "
                         f"spatial axes")

    def impl(v):
        if channels_last:
            v = v.movedim(-1, 1)
        if mode in _LINEAR_MODES and not align_corners and align_mode == 1:
            out = _asymmetric_linear(v, out_sizes, scales)
        else:
            # with a scale, torch's output size is floor(in * scale), as
            # out_sizes, and its ratio 1 / scale, as Paddle's
            kw = {"scale_factor": scales} if scales else {"size": out_sizes}
            if mode in ("linear", "bilinear", "trilinear", "bicubic"):
                kw["align_corners"] = bool(align_corners)
            out = TF.interpolate(v, mode=mode, **kw)
        return out.movedim(1, -1) if channels_last else out

    return forward_op("interpolate", impl, [x])


def upsample(x, size=None, scale_factor=None, mode="nearest", align_corners=False,
             align_mode=0, data_format="NCHW", name=None):
    return interpolate(x, size, scale_factor, mode, align_corners, align_mode,
                       data_format)


def linear_interp(x, size=None, scale_factor=None, align_corners=False,
                  data_format="NCW", name=None):
    """1-D linear resize (ref: linear_interp_v2 kernel)."""
    return interpolate(x, size=size, scale_factor=scale_factor,
                       mode="linear", align_corners=align_corners,
                       data_format=data_format)


def bilinear_interp(x, size=None, scale_factor=None, align_corners=False,
                    data_format="NCHW", name=None):
    """2-D bilinear resize (ref: bilinear_interp_v2 kernel)."""
    return interpolate(x, size=size, scale_factor=scale_factor,
                       mode="bilinear", align_corners=align_corners,
                       data_format=data_format)


def nearest_interp(x, size=None, scale_factor=None, align_corners=False,
                   data_format="NCHW", name=None):
    """Nearest-neighbor resize (ref: nearest_interp_v2 kernel)."""
    return interpolate(x, size=size, scale_factor=scale_factor,
                       mode="nearest", align_corners=align_corners,
                       data_format=data_format)


def bicubic_interp(x, size=None, scale_factor=None, align_corners=False,
                   data_format="NCHW", name=None):
    """Bicubic resize (ref: bicubic_interp_v2 kernel)."""
    return interpolate(x, size=size, scale_factor=scale_factor,
                       mode="bicubic", align_corners=align_corners,
                       data_format=data_format)


def trilinear_interp(x, size=None, scale_factor=None, align_corners=False,
                     data_format="NCDHW", name=None):
    """3-D trilinear resize (ref: trilinear_interp_v2 kernel)."""
    return interpolate(x, size=size, scale_factor=scale_factor,
                       mode="trilinear", align_corners=align_corners,
                       data_format=data_format)


def pixel_shuffle(x, upscale_factor, data_format="NCHW", name=None):
    """[N, C r², H, W] -> [N, C, H r, W r]; NHWC as Paddle's kernel lays
    it out (the NCHW result transposed; the reference orders the NHWC
    channels otherwise, ROADMAP §C)."""
    r = int(upscale_factor)

    def impl(v):
        if data_format == "NCHW":
            n, c, h, w = v.shape
            v = v.reshape(n, c // (r * r), r, r, h, w)
            return v.permute(0, 1, 4, 2, 5, 3).reshape(n, c // (r * r),
                                                       h * r, w * r)
        n, h, w, c = v.shape
        v = v.reshape(n, h, w, c // (r * r), r, r)
        return v.permute(0, 1, 4, 2, 5, 3).reshape(n, h * r, w * r,
                                                   c // (r * r))

    return forward_op("pixel_shuffle", impl, [ensure_tensor(x)])


def pixel_unshuffle(x, downscale_factor, data_format="NCHW", name=None):
    """The inverse of :func:`pixel_shuffle`: [N, C, H r, W r] ->
    [N, C r², H, W] (NHWC likewise)."""
    r = int(downscale_factor)

    def impl(v):
        if data_format == "NCHW":
            n, c, h, w = v.shape
            v = v.reshape(n, c, h // r, r, w // r, r)
            return v.permute(0, 1, 3, 5, 2, 4).reshape(n, c * r * r,
                                                       h // r, w // r)
        n, h, w, c = v.shape
        v = v.reshape(n, h // r, r, w // r, r, c)
        return v.permute(0, 1, 3, 5, 2, 4).reshape(n, h // r, w // r,
                                                   c * r * r)

    return forward_op("pixel_unshuffle", impl, [ensure_tensor(x)])


def channel_shuffle(x, groups, data_format="NCHW", name=None):
    """Interleave the channels of ``groups`` groups (ShuffleNet)."""
    def impl(v):
        if data_format == "NCHW":
            n, c, h, w = v.shape
            return v.reshape(n, groups, c // groups, h, w).transpose(1, 2) \
                .reshape(n, c, h, w)
        n, h, w, c = v.shape
        return v.reshape(n, h, w, groups, c // groups).transpose(3, 4) \
            .reshape(n, h, w, c)

    return forward_op("channel_shuffle", impl, [ensure_tensor(x)])

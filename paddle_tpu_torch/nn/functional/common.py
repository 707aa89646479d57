"""Common functionals — counterpart of ``paddle_tpu/nn/functional/common.py``
(``python/paddle/nn/functional/common.py`` + ``input.py`` in Paddle):
linear, the dropouts, padding, embedding, one-hot, similarity and
normalization helpers, label smoothing. Dropout masks draw from the global
generator of the input's device (``ops/random.py``).

Still to be ported (ROADMAP §A item 11): ``interpolate`` / ``upsample`` and
the ``*_interp`` modes, ``pixel_shuffle`` / ``pixel_unshuffle``,
``channel_shuffle`` and ``sparse_attention``. ``unfold`` is here; its
adjoint ``fold`` is in ``vision.py``, as in the reference.
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

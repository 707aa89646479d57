"""Vision-geometry functionals — counterpart of
``paddle_tpu/nn/functional/vision.py`` (python/paddle/nn/functional/
vision.py and common.py's ``fold`` in Paddle): NCHW, differentiable.

``grid_sample`` is the reference's formula written out in torch (its
unnormalization, reflection and out-of-range rules, four gathered taps),
not ``torch.nn.functional.grid_sample``, so every mode, padding mode and
``align_corners`` setting gives the reference's numbers and gradients.
``fold`` is torch's col2im, the exact adjoint of ``unfold`` as the
reference's scatter-add is.
"""

from __future__ import annotations

import torch
import torch.nn.functional as TF

from ...ops._helpers import ensure_tensor, forward_op

__all__ = ["grid_sample", "affine_grid", "fold", "temporal_shift",
           "bilinear", "feature_alpha_dropout"]


def _pair(v):
    return (int(v), int(v)) if isinstance(v, int) else tuple(int(x) for x in v)


def grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                align_corners=True, name=None):
    """Sample ``x [N,C,H,W]`` at normalized ``grid [N,Ho,Wo,2]`` coordinates
    in [-1, 1] (ref: F.grid_sample; bilinear/nearest, zeros/border/reflection
    padding)."""
    t, g = ensure_tensor(x), ensure_tensor(grid)
    if mode not in ("bilinear", "nearest"):
        raise ValueError(f"grid_sample mode must be bilinear/nearest, "
                         f"got {mode!r}")
    if padding_mode not in ("zeros", "border", "reflection"):
        raise ValueError(f"grid_sample padding_mode {padding_mode!r}")

    def f(v, gv):
        N, C, H, W = v.shape

        def unnormalize(coord, size):
            if align_corners:
                return (coord + 1) / 2 * (size - 1)
            return ((coord + 1) * size - 1) / 2

        ix = unnormalize(gv[..., 0], W)          # [N, Ho, Wo]
        iy = unnormalize(gv[..., 1], H)

        def reflect(c, size):
            if align_corners:
                span = 2 * (size - 1)
                c = torch.remainder(c.abs(), max(span, 1))
                return torch.where(c > size - 1, span - c, c)
            span = 2 * size
            c = torch.remainder((c + 0.5).abs(), max(span, 1))
            c = torch.where(c > size - 0.5, span - c, c) - 0.5
            return torch.minimum(torch.maximum(c, c.new_zeros(())),
                                 c.new_full((), size - 1))

        if padding_mode == "reflection":
            ix = reflect(ix, W)
            iy = reflect(iy, H)

        n_idx = torch.arange(N, device=v.device)[:, None, None]

        def gather(yc, xc):
            # integer coords [N,Ho,Wo] -> values [N,C,Ho,Wo] with padding
            inb = (yc >= 0) & (yc < H) & (xc >= 0) & (xc < W)
            vals = v[n_idx, :, yc.clamp(0, H - 1), xc.clamp(0, W - 1)]
            vals = vals.movedim(-1, 1)            # [N, C, Ho, Wo]
            if padding_mode == "zeros":
                vals = vals * inb[:, None].to(vals.dtype)
            return vals

        if mode == "nearest":
            return gather(torch.round(iy).long(), torch.round(ix).long())
        x0 = torch.floor(ix)
        y0 = torch.floor(iy)
        wx = (ix - x0)[:, None]
        wy = (iy - y0)[:, None]
        x0i, y0i = x0.long(), y0.long()
        v00 = gather(y0i, x0i)
        v01 = gather(y0i, x0i + 1)
        v10 = gather(y0i + 1, x0i)
        v11 = gather(y0i + 1, x0i + 1)
        top = v00 * (1 - wx) + v01 * wx
        bot = v10 * (1 - wx) + v11 * wx
        return top * (1 - wy) + bot * wy

    return forward_op("grid_sample", f, [t, g])


def affine_grid(theta, out_shape, align_corners=True, name=None):
    """2D affine sampling grid [N,H,W,2] from theta [N,2,3]
    (ref: F.affine_grid)."""
    th = ensure_tensor(theta)
    H, W = int(out_shape[-2]), int(out_shape[-1])

    def f(tv):
        def axis(size):
            if align_corners:
                return torch.linspace(-1.0, 1.0, size, device=tv.device)
            return (torch.arange(size, device=tv.device) * 2 + 1) / size - 1
        gy, gx = torch.meshgrid(axis(H), axis(W), indexing="ij")   # [H, W]
        base = torch.stack([gx, gy, torch.ones_like(gx)], -1).to(tv.dtype)
        return torch.einsum("nij,hwj->nhwi", tv, base)            # [N,H,W,2]

    return forward_op("affine_grid", f, [th])


def fold(x, output_sizes, kernel_sizes, strides=1, paddings=0, dilations=1,
         name=None):
    """col2im (ref: F.fold): [N, C*kh*kw, L] -> [N, C, H, W], summing
    overlapping patches — the exact adjoint of unfold."""
    t = ensure_tensor(x)
    oh, ow = _pair(output_sizes)
    return forward_op("fold", lambda v: TF.fold(
        v, (oh, ow), _pair(kernel_sizes), dilation=_pair(dilations),
        padding=_pair(paddings), stride=_pair(strides)), [t])


def temporal_shift(x, seg_num, shift_ratio=0.25, name=None,
                   data_format="NCHW"):
    """TSM temporal shift (ref: F.temporal_shift): shift a channel fraction
    one step along the segment (time) dim in each direction."""
    t = ensure_tensor(x)
    if data_format != "NCHW":
        raise ValueError("temporal_shift supports NCHW")

    def f(v):
        NT, C, H, W = v.shape
        v5 = v.reshape(NT // seg_num, seg_num, C, H, W)
        c1 = int(C * shift_ratio)
        c2 = int(C * 2 * shift_ratio)
        fwd = torch.cat([torch.zeros_like(v5[:, :1, :c1]), v5[:, :-1, :c1]], 1)
        bwd = torch.cat([v5[:, 1:, c1:c2], torch.zeros_like(v5[:, :1, c1:c2])],
                        1)
        return torch.cat([fwd, bwd, v5[:, :, c2:]], 2).reshape(NT, C, H, W)

    return forward_op("temporal_shift", f, [t])


def bilinear(x1, x2, weight, bias=None, name=None):
    """ref: F.bilinear — out[n, o] = x1[n]^T W[o] x2[n] (+ bias)."""
    args = [ensure_tensor(x1), ensure_tensor(x2), ensure_tensor(weight)]
    if bias is not None:
        args.append(ensure_tensor(bias))

    def f(av, bv, wv, *biasv):
        out = torch.einsum("ni,oij,nj->no", av, wv, bv)
        return out + biasv[0] if biasv else out

    return forward_op("bilinear", f, args)


def feature_alpha_dropout(x, p=0.5, training=True, name=None):
    """Alpha dropout over whole channels (ref: feature_alpha_dropout —
    SELU-compatible noise on [N, C, ...] with per-channel masks). The mask
    comes from the port's generator, not ``jax.random``."""
    t = ensure_tensor(x)
    if not 0 <= p < 1:
        raise ValueError(f"feature_alpha_dropout p must be in [0,1), got {p}")
    if not training or p == 0.0:
        return t
    from .common import _keep_mask
    v0 = t._value
    keep = _keep_mask(v0, p, tuple(v0.shape[:2]) + (1,) * (v0.dim() - 2))
    alpha_p = -1.7580993408473766  # -scale*alpha of SELU

    def f(v):
        a = (1 / ((1 - p) * (1 + p * alpha_p ** 2)) ** 0.5)
        b = -a * alpha_p * p
        return (torch.where(keep, v, torch.full_like(v, alpha_p)) * a + b
                ).to(v.dtype)

    return forward_op("feature_alpha_dropout", f, [t])

"""Diffusion UNet (SDXL layout) — counterpart of
``paddle_tpu/models/unet.py`` (ppdiffusers ``unet_2d_condition.py``:
timestep-embedded ResBlocks, cross-attention blocks at the lower
resolutions, down and up paths with skip connections).

NCHW throughout. A ``CrossAttnBlock`` flattens the spatial grid to a
sequence and runs ``nn.functional.scaled_dot_product_attention`` twice,
self-attention and cross-attention over the context; on the card with
q, k, v in bf16 or fp32 at head_dim 64 or 128 that call takes the flash
kernels (``flash_route``), forward and backward. There is no second
attention path here.
"""

from __future__ import annotations

import math
from typing import List, Sequence

import torch

from ..core.dispatch import forward_op
from ..core.tensor import Tensor, to_tensor
from ..nn import (Conv2D, GroupNorm, Identity, LayerNorm, Linear, SiLU,
                  Sequential)
from ..nn.layer import Layer

__all__ = ["UNet2DConditionModel", "sdxl_unet_mini", "timestep_embedding"]


def timestep_embedding(t, dim: int, max_period: float = 10000.0):
    """Sinusoidal timestep embedding [B] -> [B, dim] (DDPM convention)."""
    def impl(tv):
        half = dim // 2
        freqs = torch.exp(-math.log(max_period) * torch.arange(
            half, dtype=torch.float32, device=tv.device) / half)
        args = tv.to(torch.float32)[:, None] * freqs[None]
        return torch.cat([torch.cos(args), torch.sin(args)], -1)
    # a Tensor passes as it is (a host round trip could not be captured)
    return forward_op("timestep_embedding", impl,
                      [t if isinstance(t, Tensor) else to_tensor(t)])


def _groups(c: int, cap: int = 8) -> int:
    """Largest divisor of ``c`` not exceeding ``cap`` (GroupNorm needs
    groups | channels)."""
    for g in range(min(cap, c), 0, -1):
        if c % g == 0:
            return g
    return 1


class ResBlock(Layer):
    """GroupNorm-SiLU-Conv x2 with the timestep embedding added between
    (ref: ppdiffusers ResnetBlock2D)."""

    def __init__(self, cin, cout, temb_dim, groups=8):
        super().__init__()
        self.norm1 = GroupNorm(_groups(cin, groups), cin)
        self.conv1 = Conv2D(cin, cout, 3, padding=1)
        self.temb_proj = Linear(temb_dim, cout)
        self.norm2 = GroupNorm(_groups(cout, groups), cout)
        self.conv2 = Conv2D(cout, cout, 3, padding=1)
        self.act = SiLU()
        self.skip = Conv2D(cin, cout, 1) if cin != cout else Identity()

    def forward(self, x, temb):
        from ..ops.manipulation import reshape
        h = self.conv1(self.act(self.norm1(x)))
        e = self.temb_proj(self.act(temb))
        B, C = e.shape
        h = h + reshape(e, [B, C, 1, 1])
        h = self.conv2(self.act(self.norm2(h)))
        return h + self.skip(x)


class CrossAttnBlock(Layer):
    """LayerNorm'd self-attention + cross-attention + SiLU MLP over the
    flattened spatial sequence (ref: ppdiffusers Transformer2DModel basic
    block, single layer)."""

    def __init__(self, channels, ctx_dim, heads=4):
        super().__init__()
        if channels % heads:
            raise ValueError(f"channels {channels} % heads {heads}")
        self.heads = heads
        self.norm_in = GroupNorm(_groups(channels), channels)
        self.ln1 = LayerNorm(channels)
        self.to_q1 = Linear(channels, channels)
        self.to_k1 = Linear(channels, channels)
        self.to_v1 = Linear(channels, channels)
        self.out1 = Linear(channels, channels)
        self.ln2 = LayerNorm(channels)
        self.to_q2 = Linear(channels, channels)
        self.to_k2 = Linear(ctx_dim, channels)
        self.to_v2 = Linear(ctx_dim, channels)
        self.out2 = Linear(channels, channels)
        self.ln3 = LayerNorm(channels)
        self.ff = Sequential(Linear(channels, 4 * channels), SiLU(),
                             Linear(4 * channels, channels))

    def _attn(self, q, k, v):
        """[B, S, C] x [B, T, C] -> [B, S, C] multi-head attention through
        ``scaled_dot_product_attention`` (the flash kernels on the card)."""
        from ..nn.functional import scaled_dot_product_attention
        from ..ops.manipulation import reshape
        B, S, C = q.shape
        T = k.shape[1]
        H = self.heads
        D = C // H
        o = scaled_dot_product_attention(reshape(q, [B, S, H, D]),
                                         reshape(k, [B, T, H, D]),
                                         reshape(v, [B, T, H, D]))
        return reshape(o, [B, S, C])

    def forward(self, x, context):
        from ..ops.manipulation import reshape, transpose
        B, C, H, W = x.shape
        h = self.norm_in(x)
        seq = transpose(reshape(h, [B, C, H * W]), [0, 2, 1])  # [B, S, C]
        a = self.ln1(seq)
        seq = seq + self.out1(self._attn(self.to_q1(a), self.to_k1(a),
                                         self.to_v1(a)))
        a = self.ln2(seq)
        seq = seq + self.out2(self._attn(self.to_q2(a),
                                         self.to_k2(context),
                                         self.to_v2(context)))
        seq = seq + self.ff(self.ln3(seq))
        out = reshape(transpose(seq, [0, 2, 1]), [B, C, H, W])
        return x + out


class Downsample(Layer):
    def __init__(self, c):
        super().__init__()
        self.conv = Conv2D(c, c, 3, stride=2, padding=1)

    def forward(self, x):
        return self.conv(x)


def upsample_nearest2x(v):
    """Nearest-neighbour resize of ``[B, C, H, W]`` to ``[B, C, 2H, 2W]``:
    each pixel repeated twice on H and on W (the reference's
    ``jax.image.resize(..., "nearest")`` at exactly 2x)."""
    return v.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


class Upsample(Layer):
    def __init__(self, c):
        super().__init__()
        self.conv = Conv2D(c, c, 3, padding=1)

    def forward(self, x):
        return self.conv(forward_op("unet_upsample", upsample_nearest2x, [x]))


class UNet2DConditionModel(Layer):
    """Conditional UNet: eps = f(x_t, t, context).

    ``block_out_channels`` sets the per-level widths; cross-attention runs
    at every level except the first (the SDXL layout: attention at the
    lower spatial resolutions).
    """

    def __init__(self, in_channels: int = 4,
                 block_out_channels: Sequence[int] = (32, 64, 96),
                 ctx_dim: int = 64, heads: int = 4,
                 layers_per_block: int = 1):
        super().__init__()
        chans = list(block_out_channels)
        temb = 4 * chans[0]
        self._temb_base = chans[0]
        self.time_mlp = Sequential(Linear(chans[0], temb), SiLU(),
                                   Linear(temb, temb))
        self.conv_in = Conv2D(in_channels, chans[0], 3, padding=1)

        self.down_res: List = []
        self.down_attn: List = []
        self.downs: List = []
        c = chans[0]
        for li, co in enumerate(chans):
            for bi in range(layers_per_block):
                r = ResBlock(c, co, temb)
                self.add_sublayer(f"dres{li}_{bi}", r)
                self.down_res.append(r)
                a = CrossAttnBlock(co, ctx_dim, heads) if li > 0 else None
                if a is not None:
                    self.add_sublayer(f"dattn{li}_{bi}", a)
                self.down_attn.append(a)
                c = co
            if li < len(chans) - 1:
                d = Downsample(co)
                self.add_sublayer(f"down{li}", d)
                self.downs.append(d)

        self.mid1 = ResBlock(c, c, temb)
        self.mid_attn = CrossAttnBlock(c, ctx_dim, heads)
        self.mid2 = ResBlock(c, c, temb)

        self.up_res: List = []
        self.up_attn: List = []
        self.ups: List = []
        for li, co in reversed(list(enumerate(chans))):
            for bi in range(layers_per_block):
                r = ResBlock(c + co, co, temb)   # skip concat
                self.add_sublayer(f"ures{li}_{bi}", r)
                self.up_res.append(r)
                a = CrossAttnBlock(co, ctx_dim, heads) if li > 0 else None
                if a is not None:
                    self.add_sublayer(f"uattn{li}_{bi}", a)
                self.up_attn.append(a)
                c = co
            if li > 0:
                u = Upsample(co)
                self.add_sublayer(f"up{li}", u)
                self.ups.append(u)

        self.norm_out = GroupNorm(_groups(c), c)
        self.act = SiLU()
        self.conv_out = Conv2D(c, in_channels, 3, padding=1)

    def forward(self, x, t, context):
        from ..ops.manipulation import concat
        temb = self.time_mlp(timestep_embedding(t, self._temb_base))
        h = self.conv_in(x)
        skips = []
        n_levels = len(self.downs) + 1
        per = len(self.down_res) // n_levels
        for i, (r, a) in enumerate(zip(self.down_res, self.down_attn)):
            h = r(h, temb)
            if a is not None:
                h = a(h, context)
            skips.append(h)
            if i % per == per - 1 and i // per < n_levels - 1:
                h = self.downs[i // per](h)

        h = self.mid2(self.mid_attn(self.mid1(h, temb), context), temb)

        for i, (r, a) in enumerate(zip(self.up_res, self.up_attn)):
            h = r(concat([h, skips.pop()], axis=1), temb)
            if a is not None:
                h = a(h, context)
            if i % per == per - 1 and i // per < n_levels - 1:
                h = self.ups[i // per](h)

        return self.conv_out(self.act(self.norm_out(h)))


def sdxl_unet_mini(**kw) -> UNet2DConditionModel:
    """Test/bench-scale instance of the SDXL layout."""
    return UNet2DConditionModel(**kw)

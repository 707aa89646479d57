"""Weight-only int8 quantization — counterpart of
``paddle_tpu/ops/quant.py:270-328``: ``weight_quantize`` /
``weight_dequantize`` (per-output-column symmetric int8 scales) and
``weight_only_linear``, the eager caller of the int8 matmul kernel. The
reference's fake-quant observers, ``quantize_linear`` /
``dequantize_linear`` and ``llm_int8_linear`` are still to be ported
(ROADMAP §A item 11).

On a CUDA tensor the product launches ``csrc/quant_matmul.cu`` through
``kernels.quant_matmul.weight_only_matmul``; on a CPU tensor it runs that
wrapper's plain version. Its backward is the plain product ``g @
dequant(w).T`` (the reference differentiates its dequant-then-matmul, a
product it computes outside any kernel); ``w`` gets no gradient, and
``scale``, when it asks for one, gets the reference's ``sum_k (x^T g)[k, n]
w[k, n]``.
"""

from __future__ import annotations

import torch

from ..device import on_cuda
from ._helpers import ensure_tensor, forward_op

__all__ = ["weight_quantize", "weight_dequantize", "weight_only_linear"]


class _WeightOnlyLinear(torch.autograd.Function):
    """``(x [M, K], w [K, N] int8, scale [N]) -> x @ dequant(w)`` in x's
    dtype; the forward is the kernel (or its plain version), the backward
    ``g @ dequant(w).T`` (and the scale's, only when it is asked for)."""

    @staticmethod
    def forward(ctx, x, w, scale):
        from ..kernels.quant_matmul import (weight_only_matmul,
                                            weight_only_matmul_plain)
        ctx.save_for_backward(w, scale,
                              x if ctx.needs_input_grad[2] else None)
        mm = weight_only_matmul if on_cuda(x, "weight_only_linear") \
            else weight_only_matmul_plain
        return mm(x, w, scale, x.dtype)

    @staticmethod
    def backward(ctx, g):
        w, scale, x = ctx.saved_tensors
        dx = dscale = None
        if ctx.needs_input_grad[0]:
            dx = g @ (w.to(g.dtype) * scale.to(g.dtype)[None, :]).T
        if x is not None:
            dscale = ((x.to(g.dtype).T @ g) * w.to(g.dtype)).sum(0)
        return dx, None, dscale


def weight_quantize(w, algo: str = "weight_only_int8", name=None):
    """Per-output-column symmetric int8 quantization of ``w [K, N]``:
    ``(int8 [K, N], scales [N] fp32)`` with ``w ~ q * scale`` (ref:
    paddle.incubate.nn.functional.weight_quantize; the kernel reads the
    natural [K, N] layout, so there is no repack)."""
    if algo not in ("weight_only_int8", "llm.int8"):
        raise ValueError(f"unsupported algo {algo!r} (int4 packing has no "
                         "kernel here)")

    def impl(wv):
        scale = torch.clamp(wv.abs().amax(dim=0), min=1e-8)          # [N]
        q = torch.clamp(torch.round(wv / scale[None, :] * 127.0), -127, 127)
        return q.to(torch.int8), (scale / 127.0).to(torch.float32)

    return forward_op("weight_quantize", impl, [ensure_tensor(w)],
                      differentiable=False)


def weight_dequantize(w, scale, name=None):
    """Inverse of :func:`weight_quantize`: ``w_int8 * scale`` as fp32."""
    return forward_op(
        "weight_dequantize",
        lambda wv, sv: wv.to(torch.float32) * sv[None, :],
        [ensure_tensor(w), ensure_tensor(scale)], differentiable=False)


def weight_only_linear(x, weight, scale, bias=None, weight_dtype="int8",
                       name=None):
    """``x @ dequant(weight) (+ bias)`` with int8 ``weight [K, N]`` and
    per-column ``scale [N]`` (ref: paddle.incubate.nn.functional.
    weight_only_linear); ``x [..., K]`` keeps its leading dims."""
    if weight_dtype != "int8":
        raise ValueError("only int8 weights are supported")
    args = [ensure_tensor(x), ensure_tensor(weight), ensure_tensor(scale)]
    if bias is not None:
        args.append(ensure_tensor(bias))

    def impl(xv, wv, sv, *b):
        lead = xv.shape[:-1]
        x2 = xv.reshape(-1, xv.shape[-1]).contiguous()
        out = _WeightOnlyLinear.apply(x2, wv.contiguous(),
                                      sv.to(torch.float32).contiguous())
        out = out.reshape(tuple(lead) + (wv.shape[1],))
        return out + b[0] if b else out

    return forward_op("weight_only_linear", impl, args)

"""Weight-only int8 linear — the eager caller of the int8 matmul kernel,
counterpart of ``paddle_tpu/ops/quant.py:299-328`` (``weight_only_linear``).
The reference's fake-quant observers, ``quantize_linear`` /
``dequantize_linear``, ``weight_quantize`` / ``weight_dequantize`` and
``llm_int8_linear`` are still to be ported (ROADMAP §A item 11).

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

__all__ = ["weight_only_linear"]


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

"""Quantization op family — counterpart of ``paddle_tpu/ops/quant.py``.

* The fake-quant observers (QAT) are pure functions, as the reference's:
  state (moving scales, accumulators) goes in and comes out explicitly.
  The quantize-dequantize forms pass the gradient straight through the
  rounding (the STE: ``x + (deq - x).detach()``).
* ``quantize_linear`` / ``dequantize_linear``: the affine pair.
* ``weight_quantize`` / ``weight_dequantize`` (per-output-column symmetric
  int8 scales) and ``weight_only_linear``, the eager caller of the int8
  matmul kernel. On a CUDA tensor the product launches
  ``csrc/quant_matmul.cu`` through
  ``kernels.quant_matmul.weight_only_matmul``; on a CPU tensor it runs
  that wrapper's plain version. Its backward is the plain product ``g @
  dequant(w).T`` (the reference differentiates its dequant-then-matmul, a
  product it computes outside any kernel); ``w`` gets no gradient, and
  ``scale``, when it asks for one, gets the reference's ``sum_k (x^T g)[k,
  n] w[k, n]``.
* ``llm_int8_linear``: outlier columns in floating point, the rest as an
  int8 x int8 -> int32 product (computed exactly in float64 on every
  device and shape), both dense, as the reference's two matmuls.
"""

from __future__ import annotations

import torch

from ..device import on_cuda
from ._helpers import ensure_tensor, forward_op

__all__ = [
    "fake_quantize_abs_max", "fake_quantize_dequantize_abs_max",
    "fake_channel_wise_quantize_abs_max",
    "fake_channel_wise_quantize_dequantize_abs_max",
    "fake_quantize_range_abs_max", "fake_quantize_moving_average_abs_max",
    "fake_quantize_dequantize_moving_average_abs_max",
    "moving_average_abs_max_scale", "quantize_linear", "dequantize_linear",
    "weight_quantize", "weight_dequantize", "weight_only_linear",
    "llm_int8_linear", "fake_dequantize_max_abs",
    "fake_channel_wise_dequantize_max_abs",
]


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


def _qmax(bit_length: int) -> float:
    return float((1 << (bit_length - 1)) - 1)


def _quant(xv, s, qmax):
    return torch.clamp(torch.round(xv / torch.clamp(s, min=1e-8) * qmax),
                       -qmax, qmax)


def _ste(xv, q, s, qmax):
    """The dequantized value, with the identity gradient through it."""
    return xv + (q * torch.clamp(s, min=1e-8) / qmax - xv).detach()


def _channel_shape(xv, axis):
    shape = [1] * xv.dim()
    shape[axis] = -1
    return shape


# -- fake-quant observers (QAT). Pure: (x, state...) -> (out, new_state...) --

def fake_quantize_abs_max(x, bit_length: int = 8, name=None):
    """Per-tensor abs-max quantization: ``(q, scale)`` with ``q =
    round(x / scale * qmax)`` kept in float storage."""
    qmax = _qmax(bit_length)

    def impl(xv):
        scale = xv.abs().amax()
        return _quant(xv, scale, qmax), scale
    return forward_op("fake_quantize_abs_max", impl, [ensure_tensor(x)],
                      differentiable=False)


def fake_quantize_dequantize_abs_max(x, bit_length: int = 8, name=None):
    """Quantize-then-dequantize with the straight-through gradient;
    returns ``(out, scale)``."""
    qmax = _qmax(bit_length)

    def impl(xv):
        scale = xv.abs().amax()
        q = _quant(xv, scale.detach(), qmax)
        return _ste(xv, q, scale.detach(), qmax), scale
    return forward_op("fake_quantize_dequantize_abs_max", impl,
                      [ensure_tensor(x)])


def fake_channel_wise_quantize_abs_max(x, bit_length: int = 8,
                                       quant_axis: int = 0, name=None):
    """Per-channel abs-max quantization along ``quant_axis``; returns
    ``(q, scales)``."""
    qmax = _qmax(bit_length)

    def impl(xv):
        dims = tuple(d for d in range(xv.dim()) if d != quant_axis)
        scale = xv.abs().amax(dim=dims)
        return _quant(xv, scale.reshape(_channel_shape(xv, quant_axis)),
                      qmax), scale
    return forward_op("fake_channel_wise_quantize_abs_max", impl,
                      [ensure_tensor(x)], differentiable=False)


def fake_channel_wise_quantize_dequantize_abs_max(x, bit_length: int = 8,
                                                  quant_axis: int = 0,
                                                  name=None):
    """Per-channel quantize-dequantize with the straight-through gradient;
    returns ``(out, scales)``."""
    qmax = _qmax(bit_length)

    def impl(xv):
        dims = tuple(d for d in range(xv.dim()) if d != quant_axis)
        scale = xv.abs().amax(dim=dims)
        s = scale.detach().reshape(_channel_shape(xv, quant_axis))
        return _ste(xv, _quant(xv, s, qmax), s, qmax), scale
    return forward_op("fake_channel_wise_quantize_dequantize_abs_max",
                      impl, [ensure_tensor(x)])


def fake_quantize_range_abs_max(x, in_scale, window_size: int = 10000,
                                bit_length: int = 8, is_test: bool = False,
                                name=None):
    """Range-tracked abs-max: scale = max(batch max, tracked scale), the
    tracked scale an explicit input / output; returns ``(q, out_scale)``."""
    qmax = _qmax(bit_length)

    def impl(xv, sv):
        scale = sv if is_test else torch.maximum(xv.abs().amax(), sv)
        return _quant(xv, scale, qmax), scale
    return forward_op("fake_quantize_range_abs_max", impl,
                      [ensure_tensor(x), ensure_tensor(in_scale)],
                      differentiable=False)


def moving_average_abs_max_scale(x, accum, state, rate: float = 0.9,
                                 name=None):
    """EMA abs-max observer: ``(scale, new_accum, new_state)`` with
    ``accum = rate*accum + |x|_max``, ``state = rate*state + 1``,
    ``scale = accum/state``."""
    def impl(xv, av, sv):
        na = rate * av + xv.abs().amax()
        ns = rate * sv + 1.0
        return na / ns, na, ns
    return forward_op("moving_average_abs_max_scale", impl,
                      [ensure_tensor(x), ensure_tensor(accum),
                       ensure_tensor(state)], differentiable=False)


def _ema_scale(xv, av, sv, rate, is_test):
    if is_test:
        return av / torch.clamp(sv, min=1e-8), av, sv
    na = rate * av + xv.detach().abs().amax()
    ns = rate * sv + 1.0
    return na / ns, na, ns


def fake_quantize_moving_average_abs_max(x, accum, state, rate: float = 0.9,
                                         bit_length: int = 8,
                                         is_test: bool = False, name=None):
    """EMA-scaled fake quantization; returns ``(q, scale, accum, state)``."""
    qmax = _qmax(bit_length)

    def impl(xv, av, sv):
        scale, na, ns = _ema_scale(xv, av, sv, rate, is_test)
        return _quant(xv, scale, qmax), scale, na, ns
    return forward_op("fake_quantize_moving_average_abs_max", impl,
                      [ensure_tensor(x), ensure_tensor(accum),
                       ensure_tensor(state)], differentiable=False)


def fake_quantize_dequantize_moving_average_abs_max(
        x, accum, state, rate: float = 0.9, bit_length: int = 8,
        is_test: bool = False, name=None):
    """EMA-scaled quantize-dequantize with the straight-through gradient;
    returns ``(out, scale, accum, state)``."""
    qmax = _qmax(bit_length)

    def impl(xv, av, sv):
        scale, na, ns = _ema_scale(xv, av, sv, rate, is_test)
        q = _quant(xv, scale.detach(), qmax)
        return _ste(xv, q, scale.detach(), qmax), scale, na, ns
    return forward_op("fake_quantize_dequantize_moving_average_abs_max",
                      impl, [ensure_tensor(x), ensure_tensor(accum),
                             ensure_tensor(state)])


# -- quantize/dequantize_linear (ONNX-style affine pair) ----------------------

def _affine_args(x, scale, zero_point):
    args = [ensure_tensor(x), ensure_tensor(scale)]
    if zero_point is not None:
        args.append(ensure_tensor(zero_point))
    return args


def _per_channel(xv, sv, zp, quant_axis):
    z = zp[0] if zp else 0
    if quant_axis >= 0 and sv.dim():
        shape = _channel_shape(xv, quant_axis)
        sv = sv.reshape(shape)
        z = z.reshape(shape) if zp else 0
    return sv, z


def quantize_linear(x, scale, zero_point=None, quant_axis: int = -1,
                    bit_length: int = 8, name=None):
    """Affine quantization ``q = clip(round(x/scale) + zp)``;
    ``quant_axis=-1`` is per-tensor. int8-ranged values in int32."""
    qmax = _qmax(bit_length)

    def impl(xv, sv, *zp):
        sv, z = _per_channel(xv, sv, zp, quant_axis)
        q = torch.round(xv / torch.clamp(sv, min=1e-8)) + z
        return torch.clamp(q, -qmax - 1, qmax).to(torch.int32)
    return forward_op("quantize_linear", impl,
                      _affine_args(x, scale, zero_point),
                      differentiable=False)


def dequantize_linear(x, scale, zero_point=None, quant_axis: int = -1,
                      name=None):
    """Affine dequantization ``(q - zp) * scale``."""
    def impl(xv, sv, *zp):
        sv, z = _per_channel(xv, sv, zp, quant_axis)
        return (xv.to(torch.float32) - z) * sv
    return forward_op("dequantize_linear", impl,
                      _affine_args(x, scale, zero_point),
                      differentiable=False)


def fake_dequantize_max_abs(x, scale, max_range: float = 127.0, name=None):
    """Dequantize by the recorded abs-max scale: ``x * scale / max_range``."""
    return forward_op(
        "fake_dequantize_max_abs",
        lambda v, s: v.to(torch.float32) * s / max_range,
        [ensure_tensor(x), ensure_tensor(scale)], differentiable=False)


def fake_channel_wise_dequantize_max_abs(x, scales, quant_bits=(8,),
                                         quant_axis: int = 0, name=None):
    """Per-channel dequantize, then each further (whole-tensor) scale."""
    st = [ensure_tensor(s) for s in
          (scales if isinstance(scales, (list, tuple)) else [scales])]
    qmax = float((1 << (quant_bits[0] - 1)) - 1)

    def impl(v, s, *more):
        out = v.to(torch.float32) * s.reshape(
            _channel_shape(v, quant_axis)) / qmax
        for extra in more:
            out = out * extra / qmax
        return out
    return forward_op("fake_channel_wise_dequantize_max_abs", impl,
                      [ensure_tensor(x)] + st, differentiable=False)


# -- LLM.int8 -------------------------------------------------------------------

def _int8_product(xq, w):
    """``xq [M, K] int8 @ w [K, N] int8`` exactly, as int32, on any device
    and shape: in float64 every partial sum is an integer below 2**53
    (|sum| <= K * 127**2), so the product is exact."""
    return (xq.to(torch.float64) @ w.to(torch.float64)).to(torch.int32)


def llm_int8_linear(x, weight, scale, threshold: float = 6.0, name=None):
    """LLM.int8: columns of ``x`` with amax above ``threshold`` stay in
    floating point, the rest go through a per-row int8 quantization and an
    int8 product (ref: paddle.incubate.nn.functional.llm_int8_linear); the
    split is a mask, so shapes stay static."""
    def impl(xv, wv, sv):
        lead = xv.shape[:-1]
        x2 = xv.reshape(-1, xv.shape[-1])
        outlier = x2.abs().amax(dim=0) > threshold               # [K]
        zero = torch.zeros_like(x2)
        x_in = torch.where(outlier[None, :], zero, x2)
        xs = torch.clamp(x_in.abs().amax(dim=1), min=1e-8)       # [M]
        xq = torch.clamp(torch.round(x_in / xs[:, None] * 127.0),
                         -127, 127).to(torch.int8)
        acc = _int8_product(xq, wv)
        inl = acc.to(torch.float32) * (xs[:, None] / 127.0) * sv[None, :]
        x_out = torch.where(outlier[None, :], x2, zero)
        wf = wv.to(x2.dtype) * sv[None, :].to(x2.dtype)
        out = inl.to(x2.dtype) + x_out @ wf
        return out.reshape(tuple(lead) + (wv.shape[1],))
    return forward_op("llm_int8_linear", impl,
                      [ensure_tensor(x), ensure_tensor(weight),
                       ensure_tensor(scale)])

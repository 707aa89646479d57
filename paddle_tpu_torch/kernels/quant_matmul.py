"""Weight-only int8 matmul — counterpart of ``paddle_tpu/kernels/quant_matmul.py``.

* :func:`quantize_weights` — symmetric per-column int8 quantization,
  bit-for-bit the JAX version (``torch.round`` rounds half to even like
  ``jnp.round``).
* :func:`weight_only_matmul` — ``x [M, K] @ dequant(w [K, N] int8,
  scale [N]) -> [M, N]``. On a CUDA tensor it launches the hand-written
  kernel ``csrc/quant_matmul.cu`` (replacing the Pallas kernel at
  ``quant_matmul.py:47``/``:91``; the source note there says what bounds
  it and what its design does about that); on a CPU tensor it runs
  :func:`weight_only_matmul_plain`.

The plain version is ``llama._mm``'s off-TPU formula ``x @ (w * s)``
in the output dtype; the kernel applies the scale after an fp32
accumulation, as the TPU kernel did. The two therefore differ by the
rounding of the dequantized weight in bf16: at bf16 they agree to a
relative error of 1e-2 of the output's max-abs, at fp32 to 1e-4.

:func:`_plan` picks the kernel's route from x's dtype and M (fp32 x:
the fp32 FMA kernel; bf16 x: tensor-core tiles of 16, 64 or 128 rows)
and, below 128 rows, a split of K into spans of whole 64-row steps that
fills the card. :func:`weight_only_matmul_split_plain` is that split's
arithmetic in plain PyTorch (fp32 partial sums per span, added in span
order, then the scale), for the CPU tests.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from ..device import on_cuda, sm_count
from . import build

__all__ = ["quantize_weights", "weight_only_matmul",
           "weight_only_matmul_plain", "weight_only_matmul_split_plain"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# routes of csrc/quant_matmul.cu's C entry, and the M rows of each route's
# tensor-core tile
FP32, TC16, TC64, TC128 = 0, 1, 2, 3
_TILE_M = {TC16: 16, TC64: 64, TC128: 128}
_TILE_N = 128
_STEP = 64            # K rows per kernel step: spans are whole steps


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=None)
def _plan(M: int, K: int, N: int, fp32_x: bool, sms: int):
    """``(route, splits, span)`` for the kernel: fp32 x takes the fp32
    FMA route; bf16 x takes tensor-core tiles of 16 rows at M <= 16
    (decode), of 64 rows to M = 64 and of 128 rows above. Below 128 rows
    the product is bound by the weight bytes and N / 128 tiles leave
    most SMs idle, so K is split into spans of whole 64-row steps until
    the grid reaches 2 blocks per SM (the last span may be shorter)."""
    if fp32_x:
        return FP32, 1, K
    route = TC16 if M <= 16 else TC64 if M <= 64 else TC128
    span = _cdiv(max(K, 1), _STEP) * _STEP
    if route == TC128:
        return route, 1, span
    tiles = _cdiv(N, _TILE_N) * _cdiv(M, _TILE_M[route])
    want = min(_cdiv(2 * sms, tiles), K // _STEP)
    if want > 1:
        span = K // want // _STEP * _STEP
    return route, max(1, _cdiv(K, span)), span


def quantize_weights(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel int8 quantization of ``w [K, N]``:
    returns ``(w_int8 [K, N], scale [N] fp32)`` with ``w ~= w_int8 *
    scale``."""
    wf = w.to(torch.float32)
    amax = wf.abs().amax(dim=0)
    scale = torch.maximum(amax, amax.new_tensor(1e-8)) / 127.0
    q = torch.clamp(torch.round(wf / scale[None, :]), -127, 127)
    return q.to(torch.int8), scale


def weight_only_matmul_plain(x: torch.Tensor, w_q: torch.Tensor,
                             scale: torch.Tensor,
                             out_dtype=torch.bfloat16) -> torch.Tensor:
    """The plain PyTorch version: dequantize in ``out_dtype``, then one
    matmul (``llama._mm``'s off-TPU formula)."""
    w = w_q.to(out_dtype) * scale.to(out_dtype)[None, :]
    return (x.to(out_dtype) @ w).to(out_dtype)


def weight_only_matmul_split_plain(x: torch.Tensor, w_q: torch.Tensor,
                                   scale: torch.Tensor, span: int,
                                   out_dtype=torch.bfloat16) -> torch.Tensor:
    """The split-K routes' arithmetic in plain PyTorch, for the tests: K
    cut into spans of ``span`` rows (the last may be shorter), each
    span's fp32 sum of x times the int8 values, the partials added in
    span order, then the per-column scale."""
    K = x.shape[1]
    xf, wf = x.float(), w_q.float()
    total = None
    for k0 in range(0, K, span):
        p = xf[:, k0:k0 + span] @ wf[k0:k0 + span]
        total = p if total is None else total + p
    return (total * scale[None, :]).to(out_dtype)


@functools.lru_cache(maxsize=None)
def _launcher():
    """(library, C entry) of the kernel, bound once: the decode step calls
    the wrapper 85 times, and its host time is the step's."""
    lib = build.load("quant_matmul")
    fn = lib.weight_only_matmul_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + \
        [ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    return lib, fn


def weight_only_matmul(x: torch.Tensor, w_q: torch.Tensor,
                       scale: torch.Tensor,
                       out_dtype=torch.bfloat16) -> torch.Tensor:
    """``x [M, K] @ dequant(w_q [K, N] int8, scale [N] fp32) -> [M, N]``
    in ``out_dtype``. CUDA tensors launch the kernel (one count on
    ``weight_only_matmul.launches`` per launch); CPU tensors run the plain
    version."""
    if not on_cuda(x, "weight_only_matmul"):
        return weight_only_matmul_plain(x, w_q, scale, out_dtype)
    if x.dim() != 2 or w_q.dim() != 2 or scale.dim() != 1:
        raise ValueError(f"weight_only_matmul: want x [M, K], w [K, N], "
                         f"scale [N]; got {tuple(x.shape)}, "
                         f"{tuple(w_q.shape)}, {tuple(scale.shape)}")
    M, K = x.shape
    N = w_q.shape[1]
    if w_q.shape[0] != K or scale.shape[0] != N:
        raise ValueError(f"weight_only_matmul: shape mismatch x "
                         f"{tuple(x.shape)}, w {tuple(w_q.shape)}, scale "
                         f"{tuple(scale.shape)}")
    if x.dtype not in _DTYPE_CODE or out_dtype not in _DTYPE_CODE:
        raise ValueError(f"weight_only_matmul: x and out must be float32 or "
                         f"bfloat16, got {x.dtype} -> {out_dtype}")
    if w_q.dtype != torch.int8 or scale.dtype != torch.float32:
        raise ValueError(f"weight_only_matmul: want int8 weights and fp32 "
                         f"scales, got {w_q.dtype}, {scale.dtype}")
    for name, t in (("x", x), ("w", w_q), ("scale", scale)):
        if t.device != x.device:
            raise ValueError(f"weight_only_matmul: {name} on {t.device}, "
                             f"x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"weight_only_matmul: {name} is not contiguous")
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    route, splits, span = _plan(M, K, N, x.dtype == torch.float32,
                                sm_count(x.device))
    part = (torch.empty((splits, M, N), dtype=torch.float32,
                        device=x.device) if splits > 1 else None)
    lib, fn = _launcher()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(x.data_ptr(), w_q.data_ptr(), scale.data_ptr(), out.data_ptr(),
             M, K, N, _DTYPE_CODE[x.dtype], _DTYPE_CODE[out_dtype],
             None if part is None else part.data_ptr(), route, splits, span,
             stream)
    build.check(lib, err, "weight_only_matmul")
    weight_only_matmul.launches += 1
    return out


weight_only_matmul.launches = 0

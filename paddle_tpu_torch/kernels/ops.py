"""The inference entry points of the kernels as ``torch.library`` ops.

``jit.save`` writes a ``torch.export`` program, and ``torch.export``
traces with fake tensors, which hold no memory: a kernel wrapper's
``ctypes`` launch (``tensor.data_ptr()``) cannot run there. While a
program is exported (:func:`exporting`), the wrappers an inference
forward reaches call these ops instead, so the saved program holds one
op node per kernel call:

* ``paddle_tpu_torch::flash_attention_fwd`` — the flash forward
  (``flash_attention.py``), no segments;
* ``paddle_tpu_torch::weight_only_matmul`` — the int8 matmul
  (``quant_matmul.py``);
* ``paddle_tpu_torch::rms_norm_fwd`` — the RMSNorm forward
  (``rms_norm.py``);
* ``paddle_tpu_torch::apply_rope`` — RoPE's forward rotation
  (``rope.py``).

Each op's implementation is the wrapper's own route: on a CUDA tensor
the kernel launch (counted on the wrapper's launch counter as a direct
call is), on a CPU tensor the plain version. Its fake implementation
gives the output's shape and dtype. The eager paths keep their direct
calls, so their launch overhead and counts do not change.
"""

from __future__ import annotations

import importlib
from typing import Tuple

import torch
from torch.library import custom_op

__all__ = ["exporting", "flash_attention_fwd", "weight_only_matmul",
           "rms_norm_fwd", "apply_rope"]


def _module(name):
    # the package exports functions under their modules' names
    return importlib.import_module(f"{__package__}.{name}")


def exporting() -> bool:
    """True while ``torch.export`` (or ``torch.compile``) traces."""
    is_exporting = getattr(torch.compiler, "is_exporting", None)
    return bool(is_exporting is not None and is_exporting()) or \
        torch.compiler.is_compiling()


@custom_op("paddle_tpu_torch::flash_attention_fwd", mutates_args=())
def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: float,
                        causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    fa = _module("flash_attention")
    if q.device.type == "cuda":
        return fa._fwd_cuda(q, k, v, None, None, scale, causal)
    return fa.flash_attention_fwd_plain(q, k, v, None, None, scale, causal)


@flash_attention_fwd.register_fake
def _(q, k, v, scale, causal):
    B, Sq, H, _ = q.shape
    return torch.empty_like(q), q.new_empty((B, H, Sq), dtype=torch.float32)


@custom_op("paddle_tpu_torch::weight_only_matmul", mutates_args=())
def weight_only_matmul(x: torch.Tensor, w_q: torch.Tensor,
                       scale: torch.Tensor,
                       out_dtype: torch.dtype) -> torch.Tensor:
    from .quant_matmul import weight_only_matmul as wom
    return wom(x, w_q, scale, out_dtype)


@weight_only_matmul.register_fake
def _(x, w_q, scale, out_dtype):
    return x.new_empty((x.shape[0], w_q.shape[1]), dtype=out_dtype)


@custom_op("paddle_tpu_torch::rms_norm_fwd", mutates_args=())
def rms_norm_fwd(x: torch.Tensor, w: torch.Tensor,
                 eps: float) -> torch.Tensor:
    rn = _module("rms_norm")
    if x.device.type == "cuda":
        out, _ = rn._fwd_cuda(x, w, eps)
    else:
        out, _ = rn.rms_norm_fwd_plain(x, w, eps)
    return out.reshape(x.shape)


@rms_norm_fwd.register_fake
def _(x, w, eps):
    return torch.empty_like(x)


@custom_op("paddle_tpu_torch::apply_rope", mutates_args=())
def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    rope = _module("rope")
    if x.device.type == "cuda":
        return rope._rope_cuda(x, cos, sin, 1.0)
    return rope.apply_rope_plain(x, cos, sin)


@apply_rope.register_fake
def _(x, cos, sin):
    return torch.empty_like(x)

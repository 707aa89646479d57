"""Rotary position embedding — counterpart of ``paddle_tpu/kernels/rope.py``.

* :func:`rope_cos_sin` — the cos/sin tables (``rope.py:73-81``).
* :func:`apply_rope` — rotate-half RoPE, ``x * cos + rotate_half(x) *
  sin``, on ``x [B, S, H, D]`` with ``[S, D]`` tables, as a
  :class:`torch.autograd.Function` whose backward is the JAX rule: the
  same rotation by ``-theta`` (``rope.py:60-67``), no gradient for the
  tables. On CUDA tensors it launches ``csrc/rope.cu`` (replacing the
  Pallas ``_rope_kernel`` at ``rope.py:25``/``:39``; the backward runs the
  same kernel with the sign of ``sin`` flipped), on CPU tensors
  :func:`apply_rope_plain`.

The arithmetic is fp32 with fp32 tables, cast to x's dtype at the end, as
in the Pallas kernel; ``models.llama._rope``'s plain route instead rounds
the tables to x's dtype (the JAX ``_rope`` does the same), so at bf16 the
two routes differ. The training forward takes this one when
``cfg.use_fused_norm`` is set and the tables are ``[S, D]``; the paged
serving entry points keep the plain route, as the JAX package does.
"""

from __future__ import annotations

import ctypes

import torch

from ..device import on_cuda
from . import build
from .ops import exporting

__all__ = ["rope_cos_sin", "apply_rope", "apply_rope_plain"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def rope_cos_sin(seq_len: int, head_dim: int, base: float = 10000.0,
                 dtype=torch.float32, position_ids=None, device=None):
    """cos/sin tables ``[S, D]`` (or ``[..., S, D]`` for batched
    ``position_ids``) for the rotate-half convention."""
    if position_ids is not None:
        pos = torch.as_tensor(position_ids).to(torch.float32)
        device = pos.device
    else:
        pos = torch.arange(seq_len, dtype=torch.float32, device=device)
    inv = 1.0 / (base ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                       device=device) / head_dim))
    freqs = pos[..., :, None] * inv                # [..., S, D/2]
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb).to(dtype), torch.sin(emb).to(dtype)


def apply_rope_plain(x, cos, sin):
    """The plain version (``_rope_kernel``'s formula): fp32 ``x * cos +
    rotate_half(x) * sin`` with ``[S, D]`` tables broadcast over batch and
    heads, cast to x's dtype."""
    d = x.shape[-1]
    xf = x.float()
    rot = torch.cat([-xf[..., d // 2:], xf[..., : d // 2]], dim=-1)
    c = cos.float()[None, :, None, :]
    s = sin.float()[None, :, None, :]
    return (xf * c + rot * s).to(x.dtype)


def _check(x, cos, sin):
    """The shapes the kernel (and the Pallas kernel's BlockSpecs) take."""
    if x.dim() != 4 or x.shape[-1] % 2:
        raise ValueError(f"apply_rope: want x [B, S, H, D] with D even, got "
                         f"{tuple(x.shape)}")
    want = (x.shape[1], x.shape[3])
    if tuple(cos.shape) != want or tuple(sin.shape) != want:
        raise ValueError(f"apply_rope: want cos and sin of shape [S, D] = "
                         f"{list(want)} for x {tuple(x.shape)}, got "
                         f"{tuple(cos.shape)} and {tuple(sin.shape)}")


def _rope_cuda(x, cos, sin, sign):
    """Launch the kernel: ``sign`` +1 rotates by theta (the forward, one
    count on ``apply_rope.launches``), -1 by -theta (the backward, one on
    ``apply_rope.launches_bwd``)."""
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"apply_rope: the CUDA kernel takes float32 or "
                         f"bfloat16 x, got {x.dtype}")
    for name, t in (("cos", cos), ("sin", sin)):
        if t.device != x.device:
            raise ValueError(f"apply_rope: {name} on {t.device}, x on "
                             f"{x.device}")
    B, S, H, D = x.shape
    x = x.contiguous()
    cos = cos.to(torch.float32).contiguous()
    sin = sin.to(torch.float32).contiguous()
    out = torch.empty_like(x)
    # 16-byte chunks of x fit when half a row is a whole number of chunks
    # and every pointer is aligned to a chunk of its own dtype
    v = 16 // x.element_size()
    vec = (D // 2) % v == 0 and all(t.data_ptr() % (v * t.element_size()) == 0
                                    for t in (x, out, cos, sin))
    lib = build.load("rope")
    fn = lib.rope_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64] + \
        [ctypes.c_int] * 3 + [ctypes.c_float] + [ctypes.c_int] * 2 + \
        [ctypes.c_void_p]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(x.data_ptr(), cos.data_ptr(), sin.data_ptr(), out.data_ptr(),
             B * S * H, S, H, D, float(sign), _DTYPE_CODE[x.dtype], int(vec),
             stream)
    build.check(lib, err, "apply_rope")
    if sign > 0:
        apply_rope.launches += 1
    else:
        apply_rope.launches_bwd += 1
    return out


class _ApplyRope(torch.autograd.Function):
    """``(x, cos, sin) -> out``; saves the tables only (the rotation's
    adjoint needs no x), holds no state between calls."""

    @staticmethod
    def forward(ctx, x, cos, sin):
        ctx.save_for_backward(cos, sin)
        if on_cuda(x, "apply_rope"):
            return _rope_cuda(x, cos, sin, 1.0)
        return apply_rope_plain(x, cos, sin)

    @staticmethod
    def backward(ctx, g):
        cos, sin = ctx.saved_tensors
        # adjoint of the rotation = rotation by -theta (exact when the two
        # halves of each table row are equal, as rope_cos_sin makes them)
        if on_cuda(g, "apply_rope"):
            return _rope_cuda(g, cos, sin, -1.0), None, None
        return apply_rope_plain(g, cos, -sin), None, None


def apply_rope(x, cos, sin):
    """Rotate-half RoPE ``x * cos + rotate_half(x) * sin`` on ``x [B, S,
    H, D]`` (D even) with ``cos``/``sin [S, D]``; anything else raises.
    CUDA tensors launch the kernel (float32 or bfloat16 x; tables taken in
    fp32), CPU tensors run :func:`apply_rope_plain`. While
    ``torch.export`` traces, the call is the ``paddle_tpu_torch::apply_rope``
    op (``ops.py``)."""
    _check(x, cos, sin)
    if exporting():
        return torch.ops.paddle_tpu_torch.apply_rope(x, cos, sin)
    return _ApplyRope.apply(x, cos, sin)


apply_rope.launches = 0
apply_rope.launches_bwd = 0

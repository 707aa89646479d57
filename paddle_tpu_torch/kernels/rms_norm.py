"""Fused RMSNorm, forward and backward — counterpart of ``paddle_tpu/kernels/rms_norm.py``.

:func:`rms_norm` computes what the Pallas kernels compute over the last
axis: ``out = x * rstd * w`` with ``rstd = rsqrt(mean(x^2) + eps)`` in fp32,
cast to x's dtype; its gradient ``dx = rstd * (g*w - xhat * mean(g*w *
xhat))`` (``xhat = x * rstd``) in x's dtype and ``dw = sum over rows of g *
xhat``, accumulated in fp32 and cast to w's dtype. It is a
:class:`torch.autograd.Function` that saves ``(x, w, rstd)``, as
``_rms_fwd_rule`` does (``rms_norm.py:97``), and nothing else, so
activation checkpointing may re-run it.

On CUDA tensors it launches the hand-written kernels of
``csrc/rms_norm.cu`` (replacing ``_fwd_kernel`` at ``rms_norm.py:27``,
call ``:77``, and ``_bwd_kernel`` at ``:35``, call ``:110``): x fp32 or
bf16, w fp32 or bf16, any row length and row count; anything else raises.
:func:`_fwd_plan` picks the forward's route from the shape and the
pointers' alignment before the launch: the register route (the row read
once into registers, w kept in registers by a persistent grid) where the
row is a whole number of 16-byte vectors per lane of one to eight warps
(more warps a row when the rows are too few to give every SM one), the
two-pass kernel for every other row length or alignment.
On CPU tensors it runs :func:`rms_norm_fwd_plain` and
:func:`rms_norm_bwd_plain`: the explicit formulas of the two Pallas
kernels (the backward is not autograd through the forward), so the CPU
tests hold the same Function, saved tensors and casts as the card runs.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ..device import on_cuda, sm_count
from . import build

__all__ = ["rms_norm", "rms_norm_fwd_plain", "rms_norm_bwd_plain"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def rms_norm_fwd_plain(x, w, eps):
    """(out in x's shape and dtype, rstd ``[n, 1]`` fp32), ``n`` the number
    of rows: ``_fwd_kernel``'s formula."""
    d = x.shape[-1]
    xf = x.reshape(-1, d).float()
    rstd = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    out = xf * rstd * w.float()
    return out.to(x.dtype).reshape(x.shape), rstd


def rms_norm_bwd_plain(x, w, rstd, g):
    """(dx in x's shape and dtype, dw in w's dtype) from the saved
    forward: ``_bwd_kernel``'s formula, dw summed over every row."""
    d = x.shape[-1]
    xhat = x.reshape(-1, d).float() * rstd
    g2 = g.reshape(-1, d).float()
    wg = g2 * w.float()
    m = (wg * xhat).mean(dim=-1, keepdim=True)
    dx = rstd * (wg - xhat * m)
    dw = (g2 * xhat).sum(dim=0)
    return dx.to(x.dtype).reshape(x.shape), dw.to(w.dtype)


def _operands(x, w):
    """Check what the kernels take; returns (x as contiguous [n, d], w
    contiguous)."""
    d = x.shape[-1]
    if x.dtype not in _DTYPE_CODE or w.dtype not in _DTYPE_CODE:
        raise ValueError(f"rms_norm: the CUDA kernels take float32 or "
                         f"bfloat16 x and weight, got {x.dtype} and "
                         f"{w.dtype}")
    if w.device != x.device:
        raise ValueError(f"rms_norm: weight on {w.device}, x on {x.device}")
    return x.reshape(-1, d).contiguous(), w.contiguous()


def _aligned(x2, *others):
    """Every pointer on a boundary of one 16-byte chunk of x's elements,
    counted in its own dtype (32 bytes for an fp32 weight beside bf16 x)."""
    v = 16 // x2.element_size()
    return all(t.data_ptr() % (v * t.element_size()) == 0
               for t in (x2, *others))


def _vec(x2, *others):
    """16-byte chunks of x fit when the row length is a whole number of
    chunks and every pointer is aligned to a chunk of its own dtype."""
    return x2.shape[1] % (16 // x2.element_size()) == 0 and \
        _aligned(x2, *others)


# csrc/rms_norm.cu: warps of a block, and the 16-byte vectors of x a lane of
# the register route holds (32 registers)
_WARPS, _VPL_MAX = 8, 8


class _FwdPlan(NamedTuple):
    """The forward's route: ``"registers"`` (``vpl`` vectors per lane,
    ``wpr`` warps per row) or ``"two_pass"`` (16-byte loads when ``vec``)."""
    route: str
    vec: bool = False
    vpl: int = 0
    wpr: int = 0


@functools.lru_cache(maxsize=None)
def _fwd_plan(n: int, d: int, x_dtype: torch.dtype, aligned: bool,
              sms: int) -> _FwdPlan:
    """The register route where the row splits into whole 16-byte vectors
    of x over the lanes of the fewest warps (1, 2, 4 or 8) that keep each
    lane at most 8 vectors (bf16 x: d a multiple of 256 up to 16384; fp32
    x: of 128 up to 8192) and every pointer is aligned (:func:`_aligned`);
    the two-pass kernel otherwise. While the rows' warps number fewer than
    the card's ``sms`` (decode: 8 rows), each row spreads over twice the
    warps, halving the vectors a lane waits for (PERF.md gives the decode
    shape's times on 1, 2, 4 and 8 warps a row)."""
    v = 16 // x_dtype.itemsize
    if aligned and d > 0 and d % (32 * v) == 0:
        steps = d // (32 * v)           # vectors per lane for one warp
        wpr = 1
        while wpr < _WARPS and (steps > wpr * _VPL_MAX or steps % wpr):
            wpr *= 2
        if steps % wpr == 0 and steps // wpr <= _VPL_MAX:
            while wpr < _WARPS and (steps // wpr) % 2 == 0 and n * wpr < sms:
                wpr *= 2
            return _FwdPlan("registers", vpl=steps // wpr, wpr=wpr)
    return _FwdPlan("two_pass", aligned and d % v == 0)


def _fwd_cuda(x, w, eps, plan=None):
    """The forward kernel on x's rows; ``plan`` (a :class:`_FwdPlan`)
    overrides :func:`_fwd_plan`'s route, for timing one against another."""
    x2, w = _operands(x, w)
    n, d = x2.shape
    out = torch.empty_like(x2)
    rstd = torch.empty((n, 1), dtype=torch.float32, device=x.device)
    sms = sm_count(x.device)
    if plan is None:
        plan = _fwd_plan(n, d, x2.dtype, _aligned(x2, w, out), sms)
    lib = build.load("rms_norm")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    args = (x2.data_ptr(), w.data_ptr(), out.data_ptr(), rstd.data_ptr(), n,
            d, eps, _DTYPE_CODE[x2.dtype], _DTYPE_CODE[w.dtype])
    if plan.route == "registers":
        fn = lib.rms_norm_fwd_reg_launch
        tail = (plan.vpl, plan.wpr, sms)
    else:
        fn = lib.rms_norm_fwd_launch
        tail = (int(plan.vec),)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + \
        [ctypes.c_float] + [ctypes.c_int] * (2 + len(tail)) + \
        [ctypes.c_void_p]
    build.check(lib, fn(*args, *tail, stream), "rms_norm forward")
    rms_norm.launches += 1
    rms_norm.launches_by_route[plan.route] += 1
    return out.reshape(x.shape), rstd


# the backward's grid: at least 16 rows per block, at most 4 blocks per SM
# of the H100's 132 (more blocks only add dw partials to sum)
_ROWS_MIN, _BLOCKS_MAX = 16, 4 * 132


def _bwd_cuda(x, w, rstd, g):
    x2, w = _operands(x, w)
    n, d = x2.shape
    # autograd may hand an expanded or strided gradient
    g2 = g.to(x2.dtype).reshape(-1, d).contiguous()
    rstd = rstd.contiguous()
    dx = torch.empty_like(x2)
    dw = torch.empty((d,), dtype=w.dtype, device=x.device)
    blocks = max(1, min(-(-n // _ROWS_MIN), _BLOCKS_MAX))
    rows_per_block = max(1, -(-n // blocks))
    part = torch.empty((-(-n // rows_per_block), d), dtype=torch.float32,
                       device=x.device)
    lib = build.load("rms_norm")
    fn = lib.rms_norm_bwd_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + \
        [ctypes.c_void_p]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(x2.data_ptr(), w.data_ptr(), rstd.data_ptr(), g2.data_ptr(),
             dx.data_ptr(), part.data_ptr(), dw.data_ptr(), n, d,
             rows_per_block, _DTYPE_CODE[x2.dtype], _DTYPE_CODE[w.dtype],
             int(_vec(x2, w, g2, dx, part)), stream)
    build.check(lib, err, "rms_norm backward")
    rms_norm.launches_bwd += 1
    return dx.reshape(x.shape), dw


class _RMSNorm(torch.autograd.Function):
    """``(x, w, eps) -> out``; the forward saves ``(x, w, rstd)``."""

    @staticmethod
    def forward(ctx, x, w, eps):
        fwd = _fwd_cuda if on_cuda(x, "rms_norm") else rms_norm_fwd_plain
        out, rstd = fwd(x, w, eps)
        ctx.save_for_backward(x, w, rstd)
        return out

    @staticmethod
    def backward(ctx, g):
        x, w, rstd = ctx.saved_tensors
        bwd = _bwd_cuda if on_cuda(x, "rms_norm") else rms_norm_bwd_plain
        dx, dw = bwd(x, w, rstd, g)
        return dx, dw, None


def rms_norm(x, weight, eps: float = 1e-6):
    """RMSNorm over the last axis: ``x * rsqrt(mean(x^2) + eps) * weight``
    (``weight [d]``). CUDA tensors launch the kernels: each forward adds one
    to ``rms_norm.launches`` and to its route's count in
    ``rms_norm.launches_by_route``, each backward (its row kernel and the dw
    reduction) one to ``rms_norm.launches_bwd``. CPU tensors run the plain
    versions."""
    if weight.shape != x.shape[-1:]:
        raise ValueError(f"rms_norm: weight {tuple(weight.shape)} does not "
                         f"match the last axis of x {tuple(x.shape)}")
    return _RMSNorm.apply(x, weight, float(eps))


rms_norm.launches = 0
rms_norm.launches_by_route = {"two_pass": 0, "registers": 0}
rms_norm.launches_bwd = 0

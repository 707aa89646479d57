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
:func:`_bwd_plan` picks the backward's route the same way: the register
route (x and g read once into registers, dx written from them, dw's
partial summed in registers across a persistent grid) or the two-pass
kernel; :func:`rms_norm_bwd_tiled` is the register route's order of
operations on the CPU.
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

__all__ = ["rms_norm", "rms_norm_fwd_plain", "rms_norm_bwd_plain",
           "rms_norm_bwd_tiled"]

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


# csrc/rms_norm.cu: warps of a block, the 16-byte vectors of x a lane of
# the forward's register route holds (32 registers), the registers a lane
# of the backward's may fill with x and g (4 a 16-byte vector each) and w
# and dw (V fp32 each): 64 where a row over at most 8 warps allows it, else
# 128 (kBwdRegs, the most the source instantiates), and the row slices of
# the dw reduction (kSlices)
_WARPS, _VPL_MAX, _BWD_REGS, _SLICES = 8, 8, (64, 128), 8


class _FwdPlan(NamedTuple):
    """The forward's route: ``"registers"`` (``vpl`` vectors per lane,
    ``wpr`` warps per row) or ``"two_pass"`` (16-byte loads when ``vec``)."""
    route: str
    vec: bool = False
    vpl: int = 0
    wpr: int = 0


def _reg_split(n, d, v, vpl_max, sms):
    """(vectors per lane, warps per row) of a register route, or None: the
    row splits into whole 16-byte vectors (``v`` elements) over the lanes
    of the fewest warps (1, 2, 4 or 8) that keep each lane at most
    ``vpl_max`` vectors. While the rows' warps number fewer than the card's
    ``sms`` (decode: 8 rows), each row spreads over twice the warps,
    halving the vectors a lane waits for (PERF.md gives the decode shape's
    times on 1, 2, 4 and 8 warps a row)."""
    if d <= 0 or d % (32 * v):
        return None
    steps = d // (32 * v)               # vectors per lane for one warp
    wpr = 1
    while wpr < _WARPS and (steps > wpr * vpl_max or steps % wpr):
        wpr *= 2
    if steps % wpr or steps // wpr > vpl_max:
        return None
    while wpr < _WARPS and (steps // wpr) % 2 == 0 and n * wpr < sms:
        wpr *= 2
    return steps // wpr, wpr


@functools.lru_cache(maxsize=None)
def _fwd_plan(n: int, d: int, x_dtype: torch.dtype, aligned: bool,
              sms: int) -> _FwdPlan:
    """The register route where :func:`_reg_split` splits the row with at
    most 8 vectors a lane (bf16 x: d a multiple of 256 up to 16384; fp32
    x: of 128 up to 8192) and every pointer is aligned (:func:`_aligned`);
    the two-pass kernel otherwise."""
    v = 16 // x_dtype.itemsize
    split = _reg_split(n, d, v, _VPL_MAX, sms) if aligned else None
    if split:
        return _FwdPlan("registers", vpl=split[0], wpr=split[1])
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


class _BwdPlan(NamedTuple):
    """The backward's route: ``"registers"`` (``vpl`` vectors per lane,
    ``wpr`` warps per row) or ``"two_pass"`` (16-byte loads when
    ``vec``)."""
    route: str
    vec: bool = False
    vpl: int = 0
    wpr: int = 0


@functools.lru_cache(maxsize=None)
def _bwd_plan(n: int, d: int, x_dtype: torch.dtype, aligned: bool,
              sms: int) -> _BwdPlan:
    """The register route where :func:`_reg_split` splits the row with a
    lane's x, g, w and dw within 64 registers (at most 2 vectors a lane for
    bf16 x, 4 for fp32: d = 2048 takes 4 warps a row, 4096 takes 8), else
    within 128 (5 and 8 vectors: d = 8192 on 8 warps), and every pointer
    (x, w, g, dx) is aligned; the two-pass kernel otherwise. Fewer
    registers leave room for more blocks an SM: at bf16 d = 2048, two warps
    a row take 168 registers a thread (one block an SM), four take 111 (two
    blocks; PERF.md gives the splits' times)."""
    v = 16 // x_dtype.itemsize
    for regs in _BWD_REGS if aligned else ():
        split = _reg_split(n, d, v, regs // (8 + 2 * v), sms)
        if split:
            return _BwdPlan("registers", vpl=split[0], wpr=split[1])
    return _BwdPlan("two_pass", aligned and d % v == 0)


def rms_norm_bwd_tiled(x, w, rstd, g, plan, grid):
    """What the backward's register route computes, in its order, on the
    CPU: ``grid`` blocks of ``8 / plan.wpr`` groups; group ``q`` of block
    ``b`` walks rows ``b * groups + q + t * grid * groups``; element ``i``
    of vector ``j`` of lane ``l`` of the group's warp ``k`` is column
    ``((j * wpr + k) * 32 + l) * V + i``. The row sum: each lane's vectors
    in order, its ``vpl`` partials pairwise, the warp's lanes by xor
    shuffles, the group's warps in order. dw: each lane's partial over its
    group's rows in walk order, the block's groups in order, then the dw
    reduction's ``_SLICES`` strided slices of blocks, each in order, added
    in order. Products round one at a time, as on the card. Returns (dx
    in x's shape and dtype, dw in w's dtype), as
    :func:`rms_norm_bwd_plain`."""
    d = x.shape[-1]
    v, vpl, wpr = 16 // x.element_size(), plan.vpl, plan.wpr
    if d != 32 * v * vpl * wpr:
        raise ValueError(f"rms_norm_bwd_tiled: {plan} does not split a row "
                         f"of {d}")
    groups = _WARPS // wpr
    xf, gf = (t.reshape(-1, d).float() for t in (x, g))
    n = xf.shape[0]
    r = rstd.reshape(-1, 1).float()
    xhat, wg = xf * r, gf * w.float()
    prod = (wg * xhat).view(n, vpl, wpr, 32, v)           # [row, j, k, l, i]
    acc = xf.new_zeros((n, vpl, wpr, 32))
    for i in range(v):
        acc = acc + prod[..., i]
    st = 1
    while st < vpl:
        for j in range(0, vpl - st, 2 * st):
            acc[:, j] = acc[:, j] + acc[:, j + st]
        st *= 2
    lanes = acc[:, 0]                                      # [row, k, l]
    for o in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[..., torch.arange(32, device=xf.device) ^ o]
    total = xf.new_zeros((n, 1))
    for k in range(wpr):
        total = total + lanes[:, k, :1]
    m = total / torch.full_like(total, d)
    dx = r * (wg - xhat * m)
    # rows t * span + b * groups + q: group q of block b at step t
    span = grid * groups
    gx = torch.cat([gf * xhat, xf.new_zeros((-n % span, d))])
    part = xf.new_zeros((grid, groups, d))
    for t0 in range(0, n, span):
        part = part + gx[t0:t0 + span].view(grid, groups, d)
    blk = part[:, 0]
    for q in range(1, groups):
        blk = blk + part[:, q]
    dw = xf.new_zeros(d)
    for sl in range(_SLICES):
        s = xf.new_zeros(d)
        for b in range(sl, grid, _SLICES):
            s = s + blk[b]
        dw = dw + s
    return dx.to(x.dtype).reshape(x.shape), dw.to(w.dtype)


# the two-pass backward's grid: at least 16 rows per block, at most 4
# blocks per SM (more blocks only add dw partials to sum)
_ROWS_MIN, _BLOCKS_PER_SM = 16, 4


@functools.lru_cache(maxsize=None)
def _bwd_reg_blocks(n, d, x_code, w_code, vpl, wpr, sms):
    """The register route's persistent grid: as many blocks as fit on the
    card at once (the C launcher asks the occupancy), none without a
    row."""
    lib = build.load("rms_norm")
    fn = lib.rms_norm_bwd_reg_blocks
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 7 + [ctypes.c_void_p]
    blocks = ctypes.c_int(0)
    build.check(lib, fn(n, d, x_code, w_code, vpl, wpr, sms,
                        ctypes.byref(blocks)), "rms_norm backward grid")
    return blocks.value


def _bwd_cuda(x, w, rstd, g, plan=None):
    """The backward kernels on x's rows; ``plan`` (a :class:`_BwdPlan`)
    overrides :func:`_bwd_plan`'s route, for timing one against
    another."""
    x2, w = _operands(x, w)
    n, d = x2.shape
    # autograd may hand an expanded or strided gradient
    g2 = g.to(x2.dtype).reshape(-1, d).contiguous()
    rstd = rstd.contiguous()
    dx = torch.empty_like(x2)
    dw = torch.empty((d,), dtype=w.dtype, device=x.device)
    sms = sm_count(x.device)
    if plan is None:
        plan = _bwd_plan(n, d, x2.dtype, _aligned(x2, w, g2, dx), sms)
    codes = (_DTYPE_CODE[x2.dtype], _DTYPE_CODE[w.dtype])
    if plan.route == "registers":
        blocks = _bwd_reg_blocks(n, d, *codes, plan.vpl, plan.wpr, sms)
        entry, ints = "rms_norm_bwd_reg_launch", (*codes, plan.vpl, plan.wpr,
                                                  blocks)
    else:
        blocks = max(1, min(-(-n // _ROWS_MIN), _BLOCKS_PER_SM * sms))
        rows_per_block = max(1, -(-n // blocks))
        blocks = -(-n // rows_per_block)
        entry, ints = "rms_norm_bwd_launch", (rows_per_block, *codes,
                                              int(plan.vec))
    part = torch.empty((blocks, d), dtype=torch.float32, device=x.device)
    lib = build.load("rms_norm")
    fn = getattr(lib, entry)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * (2 + len(ints)) \
        + [ctypes.c_void_p]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(x2.data_ptr(), w.data_ptr(), rstd.data_ptr(), g2.data_ptr(),
             dx.data_ptr(), part.data_ptr(), dw.data_ptr(), n, d, *ints,
             stream)
    build.check(lib, err, "rms_norm backward")
    rms_norm.launches_bwd += 1
    rms_norm.launches_bwd_by_route[plan.route] += 1
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
    reduction) one to ``rms_norm.launches_bwd`` and to its route's count in
    ``rms_norm.launches_bwd_by_route``. CPU tensors run the plain
    versions."""
    if weight.shape != x.shape[-1:]:
        raise ValueError(f"rms_norm: weight {tuple(weight.shape)} does not "
                         f"match the last axis of x {tuple(x.shape)}")
    return _RMSNorm.apply(x, weight, float(eps))


rms_norm.launches = 0
rms_norm.launches_by_route = {"two_pass": 0, "registers": 0}
rms_norm.launches_bwd = 0
rms_norm.launches_bwd_by_route = {"two_pass": 0, "registers": 0}

"""The port's fused RMSNorm and RoPE (``paddle_tpu_torch.kernels.rms_norm``,
``.rope``) against the JAX package's (``paddle_tpu.kernels.rms_norm``,
``.rope``, their Pallas kernels run in interpret mode on the CPU as
tests/test_kernels.py runs them). On CPU tensors the port's autograd
Functions run their plain versions: the RMSNorm backward is the explicit
formula of the Pallas backward kernel, the RoPE backward the rotation by
``-theta`` (the JAX custom vjp); the CUDA kernels are held to those plain
versions on the card (tests/test_torch_cuda_kernels.py).

Inputs, weights and cotangents come from numpy with a seed; the RoPE
tables from each side's ``rope_cos_sin``. Tolerances: at fp32, RMSNorm
out, rstd, dx and dw atol 1e-5 (the same fp32 formulas, the row sums
taken in other orders); RoPE out and its gradient atol 1e-6 (elementwise
arithmetic on tables that agree to 6e-8). At bf16 the forwards must agree
within one bf16 step, ``|got - ref| <= 2**-7 * |ref|`` elementwise: both
compute in fp32 and round once. Rounding the RoPE tables to bf16 first,
as ``models.llama._rope``'s plain route does, fails that rule.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu_torch.kernels.rms_norm import (rms_norm, rms_norm_bwd_plain,
                                               rms_norm_bwd_tiled,
                                               rms_norm_fwd_plain)
from paddle_tpu_torch.kernels.rope import (apply_rope, apply_rope_plain,
                                           rope_cos_sin)
from paddle_tpu_torch.models.llama import _rope

# the modules (the JAX package's kernels/__init__ exports the functions
# under the modules' names)
JR = importlib.import_module("paddle_tpu.kernels.rms_norm")
RN = importlib.import_module("paddle_tpu_torch.kernels.rms_norm")
JRope = importlib.import_module("paddle_tpu.kernels.rope")

torch.set_num_threads(2)

EPS = 1e-6


def _rms_inputs(seed, shape):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    w = (1.0 + 0.1 * rng.standard_normal(shape[-1])).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    return x, w, g


def _within_bf16_step(got, ref):
    return np.all(np.abs(got - ref) <= 2.0 ** -7 * np.abs(ref))


# row counts not divisible by 8 (21 and 15: the JAX wrapper falls back to
# 1-row blocks) and a multiple of 8
@pytest.mark.parametrize("shape", [(3, 7, 40), (15, 24), (2, 8, 64)])
def test_rms_norm_forward_and_rstd_match_jax(shape):
    x, w, _ = _rms_inputs(sum(shape), shape)
    want_out, want_rstd = JR._fwd(jnp.asarray(x), jnp.asarray(w), EPS)
    out = rms_norm(torch.from_numpy(x), torch.from_numpy(w), EPS)
    _, rstd = rms_norm_fwd_plain(torch.from_numpy(x), torch.from_numpy(w),
                                 EPS)
    assert out.shape == x.shape and rstd.shape == want_rstd.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(rstd.numpy(), np.asarray(want_rstd),
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("shape", [(3, 7, 40), (15, 24)])
def test_rms_norm_grads_match_jax(shape):
    x, w, g = _rms_inputs(sum(shape) + 1, shape)
    _, vjp = jax.vjp(lambda a, b: JR.rms_norm(a, b, EPS), jnp.asarray(x),
                     jnp.asarray(w))
    want_dx, want_dw = vjp(jnp.asarray(g))
    tx = torch.from_numpy(x).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    rms_norm(tx, tw, EPS).backward(torch.from_numpy(g))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want_dx),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(want_dw),
                               atol=1e-5, rtol=0)


# the backward's register route as its CPU emulation runs it (the rows each
# group walks, each lane's columns, the order of the dw sums) against the
# JAX backward, at fp32 with atol 1e-5 (the same formulas, the sums in
# other orders). Rows not divisible by the grid's groups: 21 rows over 2
# blocks of 8 groups (16 a step) and over 3 (24 groups, 3 without a row);
# 45 over 5 blocks of 4 groups, 3 of 2, 2 of 4 and 4 of 1; one to eight
# warps a row, one to eight vectors a lane. The rows stay few: fp32 dw
# summed over n rows in two orders differs by ~1e-7 n (at 333 rows the
# plain formula and the JAX kernel differ by 3e-5 in dw).
@pytest.mark.parametrize("n,d,vpl,wpr,grid", [
    (21, 256, 2, 1, 2), (21, 1024, 8, 1, 3), (45, 256, 1, 2, 5),
    (45, 512, 1, 4, 3), (45, 1024, 4, 2, 2), (45, 1024, 1, 8, 4)])
def test_rms_norm_bwd_tiled_matches_jax(n, d, vpl, wpr, grid):
    x, w, g = _rms_inputs(n + d + vpl, (n, d))
    _, vjp = jax.vjp(lambda a, b: JR.rms_norm(a, b, EPS), jnp.asarray(x),
                     jnp.asarray(w))
    want_dx, want_dw = vjp(jnp.asarray(g))
    tx, tw, tg = (torch.from_numpy(a) for a in (x, w, g))
    _, rstd = rms_norm_fwd_plain(tx, tw, EPS)
    dx, dw = rms_norm_bwd_tiled(tx, tw, rstd, tg,
                                RN._BwdPlan("registers", vpl=vpl, wpr=wpr),
                                grid)
    assert dx.shape == x.shape and dw.shape == w.shape
    np.testing.assert_allclose(dx.numpy(), np.asarray(want_dx), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(dw.numpy(), np.asarray(want_dw), atol=1e-5,
                               rtol=0)


def test_rms_norm_bf16_forward_within_one_bf16_step():
    x, w, _ = _rms_inputs(5, (4, 9, 64))
    want = np.asarray(JR.rms_norm(jnp.asarray(x, jnp.bfloat16),
                                  jnp.asarray(w), EPS).astype(jnp.float32))
    got = rms_norm(torch.from_numpy(x).to(torch.bfloat16),
                   torch.from_numpy(w), EPS)
    assert got.dtype == torch.bfloat16
    assert _within_bf16_step(got.float().numpy(), want)


def test_rms_norm_mixed_dtypes_keep_each_dtype():
    # training: bf16 activations, fp32 weight -> dx bf16, dw fp32
    x, w, g = _rms_inputs(6, (5, 32))
    tx = torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    out = rms_norm(tx, tw, EPS)
    out.backward(torch.from_numpy(g).to(torch.bfloat16))
    assert (out.dtype, tx.grad.dtype, tw.grad.dtype) == (
        torch.bfloat16, torch.bfloat16, torch.float32)


def test_rms_norm_plain_backward_is_the_functions_backward():
    x, w, g = (torch.from_numpy(a) for a in _rms_inputs(7, (6, 16)))
    out, rstd = rms_norm_fwd_plain(x, w, EPS)
    want_dx, want_dw = rms_norm_bwd_plain(x, w, rstd, g)
    tx, tw = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    got = rms_norm(tx, tw, EPS)
    got.backward(g)
    assert torch.equal(got, out)
    assert torch.equal(tx.grad, want_dx) and torch.equal(tw.grad, want_dw)


def _rope_case(seed, B, S, H, D):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, D)).astype(np.float32)
    g = rng.standard_normal((B, S, H, D)).astype(np.float32)
    return x, g


# q-like and GQA k-like head counts, head_dim 16 and 32
@pytest.mark.parametrize("B,S,H,D", [(2, 8, 4, 16), (2, 8, 2, 16),
                                     (1, 12, 3, 32)])
def test_apply_rope_forward_and_grad_match_jax(B, S, H, D):
    x, g = _rope_case(B * S + H + D, B, S, H, D)
    jc, js = JRope.rope_cos_sin(S, D)
    want, vjp = jax.vjp(lambda a: JRope.apply_rope(a, jc, js),
                        jnp.asarray(x))
    (want_dx,) = vjp(jnp.asarray(g))
    tc, ts = rope_cos_sin(S, D)
    tx = torch.from_numpy(x).requires_grad_(True)
    out = apply_rope(tx, tc, ts)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want_dx),
                               atol=1e-6, rtol=0)


def test_apply_rope_bf16_forward_within_one_bf16_step():
    x, _ = _rope_case(9, 2, 8, 4, 16)
    jc, js = JRope.rope_cos_sin(8, 16)
    want = np.asarray(JRope.apply_rope(jnp.asarray(x, jnp.bfloat16), jc,
                                       js).astype(jnp.float32))
    tc, ts = rope_cos_sin(8, 16)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = apply_rope(xb, tc, ts)
    assert got.dtype == torch.bfloat16
    assert _within_bf16_step(got.float().numpy(), want)
    # the rule's power: the plain route (tables rounded to bf16, bf16
    # arithmetic) breaks it on these inputs
    assert not _within_bf16_step(_rope(xb, tc, ts).float().numpy(), want)


def test_apply_rope_backward_is_rotation_by_minus_theta():
    x, g = (torch.from_numpy(a) for a in _rope_case(10, 1, 6, 2, 8))
    tc, ts = rope_cos_sin(6, 8)
    tx = x.clone().requires_grad_(True)
    apply_rope(tx, tc, ts).backward(g)
    assert torch.equal(tx.grad, apply_rope_plain(g, tc, -ts))
    # and it undoes the forward
    back = apply_rope_plain(apply_rope_plain(x, tc, ts), tc, -ts)
    torch.testing.assert_close(back, x, atol=1e-6, rtol=0)


def test_cpu_path_launches_no_kernel():
    counts = (rms_norm.launches, rms_norm.launches_bwd,
              dict(rms_norm.launches_bwd_by_route), apply_rope.launches,
              apply_rope.launches_bwd)
    x, w, g = (torch.from_numpy(a) for a in _rms_inputs(11, (4, 16)))
    tx = x.clone().requires_grad_(True)
    rms_norm(tx, w.clone().requires_grad_(True), EPS).backward(g)
    q = torch.from_numpy(_rope_case(12, 1, 4, 2, 8)[0]).requires_grad_(True)
    tc, ts = rope_cos_sin(4, 8)
    apply_rope(q, tc, ts).sum().backward()
    assert (rms_norm.launches, rms_norm.launches_bwd,
            rms_norm.launches_bwd_by_route, apply_rope.launches,
            apply_rope.launches_bwd) == counts


@pytest.mark.parametrize("what,call", [
    ("D even", lambda c, s: apply_rope(torch.zeros(1, 4, 2, 7), c[:, :7],
                                       s[:, :7])),
    ("shape \\[S, D\\]", lambda c, s: apply_rope(torch.zeros(1, 5, 2, 8), c,
                                                 s)),
    ("shape \\[S, D\\]", lambda c, s: apply_rope(torch.zeros(1, 4, 2, 8), c,
                                                 s[:, :4])),
    ("x \\[B, S, H, D\\]", lambda c, s: apply_rope(torch.zeros(4, 2, 8), c,
                                                   s)),
    ("does not match", lambda c, s: rms_norm(torch.zeros(3, 8),
                                             torch.ones(7))),
])
def test_wrappers_refuse_shapes_the_kernels_do_not_take(what, call):
    tc, ts = rope_cos_sin(4, 8)
    with pytest.raises(ValueError, match=what):
        call(tc, ts)


@pytest.mark.parametrize("d", [2048, 4096, 8192])
@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32])
def test_fwd_plan_takes_the_register_route(d, x_dtype):
    # aligned rows of the model's widths on a 132-SM H100: each lane holds
    # at most 8 16-byte vectors of x and the lanes of the row's warps (at
    # most a block's 8) cover it exactly once; the training step's 16384
    # rows take the fewest warps that allows, the decode shape's 8 rows
    # spread over more warps (and no fewer than at 16384 rows)
    v = 16 // x_dtype.itemsize
    plans = {n: RN._fwd_plan(n, d, x_dtype, True, 132) for n in (16384, 8)}
    for plan in plans.values():
        assert plan.route == "registers", plan
        assert 1 <= plan.vpl <= 8 and plan.wpr in (1, 2, 4, 8)
        assert 32 * v * plan.vpl * plan.wpr == d
    train, decode = plans[16384], plans[8]
    assert train.vpl == 8 or train.wpr == 1
    assert decode.wpr == 8 or decode.vpl % 2 == 1


@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32])
def test_fwd_plan_keeps_the_two_pass_route(x_dtype):
    # d = 1000 is no whole number of 16-byte vectors per lane: the two-pass
    # kernel, with 16-byte loads (1000 elements are whole vectors)
    assert RN._fwd_plan(16384, 1000, x_dtype, True, 132) == \
        RN._FwdPlan("two_pass", vec=True)
    # a view one element off the buffer's start: the two-pass kernel with
    # scalar loads
    buf = torch.zeros(8 * 2048 + 1, dtype=x_dtype)
    w = torch.ones(2048)
    view = buf[1:].view(8, 2048)
    assert RN._aligned(buf[:-1].view(8, 2048), w)
    assert not RN._aligned(view, w)
    assert RN._fwd_plan(8, 2048, x_dtype, RN._aligned(view, w), 132) == \
        RN._FwdPlan("two_pass", vec=False)


@pytest.mark.parametrize("d", [2048, 4096, 8192])
@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32])
def test_bwd_plan_takes_the_register_route(d, x_dtype):
    # aligned rows of the model's widths on a 132-SM H100, at the training
    # step's 16384 rows and at 8: the lanes of the row's warps cover it
    # exactly once, and a lane's x and g (4 registers a 16-byte vector
    # each) and w and dw (V fp32 registers each) stay within 64 registers,
    # or within 128 where 8 warps a row cannot keep them to 64; the
    # training rows take the fewest warps that allows
    v = 16 // x_dtype.itemsize
    cost = 8 + 2 * v                    # registers of one vector a lane
    for n in (16384, 8):
        plan = RN._bwd_plan(n, d, x_dtype, True, 132)
        assert plan.route == "registers", plan
        assert plan.vpl >= 1 and plan.wpr in (1, 2, 4, 8)
        assert 32 * v * plan.vpl * plan.wpr == d
        assert plan.vpl * cost <= 64 or (plan.wpr == 8
                                         and plan.vpl * cost <= 128)
    train = RN._bwd_plan(16384, d, x_dtype, True, 132)
    budget = 64 if train.vpl * cost <= 64 else 128
    assert train.wpr == 1 or 2 * train.vpl * cost > budget


@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32])
def test_bwd_plan_keeps_the_two_pass_route(x_dtype):
    # d = 1000 is no whole number of 16-byte vectors per lane, and a lane
    # of d = 16384 would hold more than 128 registers of data on 8 warps:
    # the two-pass kernel, with 16-byte loads
    for d in (1000, 16384):
        assert RN._bwd_plan(16384, d, x_dtype, True, 132) == \
            RN._BwdPlan("two_pass", vec=True)
    # x, g or dx one element off the buffer's start: the two-pass kernel
    # with scalar loads
    buf = torch.zeros(8 * 2048 + 1, dtype=x_dtype)
    w = torch.ones(2048)
    view, good = buf[1:].view(8, 2048), buf[:-1].view(8, 2048)
    assert RN._aligned(good, w, good, good)
    for x2, g2 in ((view, good), (good, view)):
        assert not RN._aligned(x2, w, g2, good)
    assert RN._bwd_plan(8, 2048, x_dtype, False, 132) == \
        RN._BwdPlan("two_pass", vec=False)

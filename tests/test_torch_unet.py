"""The port's SDXL-layout UNet (``models/unet.py``) against the JAX
package's. Ports ``tests/test_unet.py``.

* ``timestep_embedding`` against the DDPM formula and JAX.
* ``Upsample``'s nearest 2x resize (``repeat_interleave`` on H and W)
  against ``jax.image.resize(..., "nearest")``.
* A mini UNet (the JAX net's weights carried across with
  ``state_dict_from_jax``): ε and every gradient of the DDPM loss within
  ``1e-5`` of the reference's max (a gradient's scale floored at 1e-2 of
  the largest gradient of the net: a conv bias feeding a one-channel
  GroupNorm group has an analytically zero gradient, and both packages
  give rounding noise there); three Adam steps' losses within
  ``1e-5``; the conditioning changes the output.

The UNet's attention is ``scaled_dot_product_attention``; on the CPU it
is the plain formula, on the card the flash kernels (chip_smoke.py
phases 56-57, ``tests/test_torch_cuda_kernels.py``).
"""

import numpy as np
import pytest

import paddle_tpu as J
import paddle_tpu_torch as T
from paddle_tpu.models import unet as JU
from paddle_tpu_torch.models import unet as TU
from paddle_tpu_torch.models.convert import state_dict_from_jax


@pytest.fixture(autouse=True)
def _port_on_cpu():
    prev = T.get_device()
    T.set_device("cpu")
    yield
    T.set_device(prev)


def close(got, want, rtol=1e-5, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max(initial=0.0)), 1e-30)
    err = float(np.abs(got - want).max(initial=0.0))
    assert err <= rtol * scale, f"{what}: max err {err} > {rtol} * {scale}"


def test_timestep_embedding():
    t = np.asarray([0.0, 100.0, 999.0], np.float32)
    got = TU.timestep_embedding(T.to_tensor(t), 8).numpy()
    half = 4
    freqs = np.exp(-np.log(10000.0) * np.arange(half) / half)
    want = np.concatenate([np.cos(t[:, None] * freqs),
                           np.sin(t[:, None] * freqs)], -1)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    # cos / sin of arguments up to 999 rad: the two libraries' results
    # part by a few ulps of the argument
    close(got, JU.timestep_embedding(J.to_tensor(t), 8).numpy(), 1e-5)
    close(TU.timestep_embedding(t, 6).numpy(),
          JU.timestep_embedding(t, 6).numpy(), 1e-5)


def test_upsample_is_repeat_interleave():
    import jax
    x = np.random.default_rng(0).standard_normal((2, 3, 5, 4)).astype(
        np.float32)
    want = np.asarray(jax.image.resize(x, (2, 3, 10, 8), method="nearest"))
    import torch
    np.testing.assert_array_equal(
        TU.upsample_nearest2x(torch.from_numpy(x)).numpy(), want)


def test_groups():
    for c in (1, 6, 7, 12, 320, 640, 1280):
        assert TU._groups(c) == JU._groups(c)


def _inputs(b=2, hw=16, ctx_dim=16, ctx_len=6):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((b, 4, hw, hw)).astype(np.float32)
    t = np.asarray([10, 500][:b], np.float32)
    ctx = rng.standard_normal((b, ctx_len, ctx_dim)).astype(np.float32)
    eps = rng.standard_normal((b, 4, hw, hw)).astype(np.float32)
    return x, t, ctx, eps


@pytest.fixture(scope="module")
def twins():
    J.seed(0)
    kw = dict(block_out_channels=(8, 16), ctx_dim=8, heads=2,
              layers_per_block=1)
    prev = T.get_device()
    T.set_device("cpu")
    ju = JU.sdxl_unet_mini(**kw)
    tu = TU.sdxl_unet_mini(**kw)
    sd = state_dict_from_jax(ju)
    tu.set_state_dict(sd)
    T.set_device(prev)
    assert set(sd) == set(tu.state_dict())
    return ju, tu


def test_eps_and_grads(twins):
    """ε of the DDPM objective's x_t and every gradient of the loss."""
    ju, tu = twins
    x0, t, ctx, eps = _inputs(hw=8, ctx_dim=8, ctx_len=5)
    xt = x0 * 0.7 ** 0.5 + eps * 0.3 ** 0.5
    res = []
    for P, m in ((J, ju), (T, tu)):
        xs = P.to_tensor(xt, stop_gradient=False)
        cs = P.to_tensor(ctx, stop_gradient=False)
        pred = m(xs, P.to_tensor(t), cs)
        loss = ((pred - P.to_tensor(eps)) ** 2).mean()
        loss.backward()
        grads = {k: p.grad.numpy() for k, p in m.named_parameters()}
        res.append((pred.numpy(), float(loss), xs.grad.numpy(),
                    cs.grad.numpy(), grads))
        m.clear_gradients()
    (jp, jl, jx, jc, jg), (tp, tl, tx, tc, tg) = res
    close(tp, jp, what="eps")
    close(tl, jl, what="loss")
    close(tx, jx, what="x grad")
    close(tc, jc, what="context grad")
    floor = 1e-2 * max(float(np.abs(g).max()) for g in jg.values())
    for k in jg:
        err = float(np.abs(tg[k] - jg[k]).max())
        assert err <= 1e-5 * max(float(np.abs(jg[k]).max()), floor), \
            (k, err)


def test_three_adam_steps(twins):
    """``tests/test_unet.py``'s DDPM training loop, three steps from the
    same weights: the losses within 1e-5."""
    x0, t, ctx, eps = _inputs(hw=8, ctx_dim=8, ctx_len=4)
    xt = x0 * 0.7 ** 0.5 + eps * 0.3 ** 0.5
    J.seed(0)
    kw = dict(block_out_channels=(8, 16), ctx_dim=8, heads=2)
    ju = JU.sdxl_unet_mini(**kw)
    tu = TU.sdxl_unet_mini(**kw)
    tu.set_state_dict(state_dict_from_jax(ju))
    runs = []
    for P, m in ((J, ju), (T, tu)):
        opt = P.optimizer.Adam(learning_rate=2e-3, parameters=m.parameters())
        ins = [P.to_tensor(a) for a in (xt, t, ctx, eps)]
        losses = []
        for _ in range(3):
            loss = ((m(*ins[:3]) - ins[3]) ** 2).mean()
            loss.backward()
            opt.step()
            opt.clear_grad()
            losses.append(float(loss))
        runs.append(losses)
    close(runs[1], runs[0], what="losses")
    assert runs[1][-1] < runs[1][0]


def test_shape_and_conditioning(twins):
    """``tests/test_unet.py``'s shape and conditioning cases on the port:
    ε keeps x's shape, and both the context and the timestep move it."""
    _, tu = twins
    x, t, ctx, _ = _inputs(hw=8, ctx_dim=8)
    base = tu(T.to_tensor(x), T.to_tensor(t), T.to_tensor(ctx)).numpy()
    assert base.shape == x.shape and np.isfinite(base).all()
    ctx2 = np.random.default_rng(9).standard_normal(ctx.shape).astype(
        np.float32)
    assert np.abs(base - tu(T.to_tensor(x), T.to_tensor(t),
                            T.to_tensor(ctx2)).numpy()).max() > 1e-4
    t2 = np.asarray([900.0, 3.0], np.float32)
    assert np.abs(base - tu(T.to_tensor(x), T.to_tensor(t2),
                            T.to_tensor(ctx)).numpy()).max() > 1e-4


def test_layers_per_block_two_and_three_levels():
    """The SDXL layout's two ResBlocks a level over three levels (phase
    56's structure at toy widths): ε equal to the reference's and the
    same parameter names; 9 attention blocks."""
    J.seed(1)
    kw = dict(block_out_channels=(8, 8, 16), ctx_dim=8, heads=2,
              layers_per_block=2)
    ju = JU.UNet2DConditionModel(**kw)
    tu = TU.UNet2DConditionModel(**kw)
    tu.set_state_dict(state_dict_from_jax(ju))
    n_attn = sum(isinstance(l, TU.CrossAttnBlock) for l in tu.sublayers())
    assert n_attn == 9
    x, t, ctx, _ = _inputs(b=1, hw=8, ctx_dim=8, ctx_len=3)
    close(tu(T.to_tensor(x), T.to_tensor(t[:1]), T.to_tensor(ctx)).numpy(),
          ju(J.to_tensor(x), J.to_tensor(t[:1]), J.to_tensor(ctx)).numpy())

"""The port's vision functionals (``nn/functional/vision.py``) and
``unfold`` / ``nn.Unfold`` against the JAX package's: ``grid_sample`` in
every mode, padding mode and ``align_corners`` setting, ``affine_grid``,
``fold``, ``temporal_shift``, ``bilinear`` (and ``nn.Bilinear`` through
it), ``feature_alpha_dropout``, each with its gradients. Ports
``tests/test_nn.py::TestFunctionalVisionOps``.

Same seeded numpy inputs through both packages; outputs within ``1e-6 *
max|ref|`` (``1e-5`` for the sums of ``fold`` / ``bilinear``), gradients
of ``sum(out * w)`` (``w`` a fixed random weight, so the gradient is not
flat) within ``1e-5 * max|g|``. ``feature_alpha_dropout`` draws its mask
from the port's generator: its test holds the per-channel structure and
the SELU affine map, and eval mode against the reference.
"""

import numpy as np
import pytest

import paddle_tpu as J
import paddle_tpu_torch as T
from paddle_tpu_torch.models.convert import state_dict_from_jax


@pytest.fixture(autouse=True)
def _port_on_cpu():
    prev = T.get_device()
    T.set_device("cpu")
    yield
    T.set_device(prev)


def close(got, want, rtol=1e-6, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max(initial=0.0)), 1e-30)
    err = float(np.abs(got - want).max(initial=0.0))
    assert err <= rtol * scale, f"{what}: max err {err} > {rtol} * {scale}"


RNG = np.random.default_rng(0)


def randn(*shape):
    return RNG.standard_normal(shape).astype(np.float32)


def both(name, arrays, rtol=1e-6, grad=True, **kw):
    w = None
    res = []
    for P in (J, T):
        ins = [P.to_tensor(a, stop_gradient=not (grad and a.dtype.kind == "f"))
               if isinstance(a, np.ndarray) else a for a in arrays]
        out = getattr(P.nn.functional, name)(*ins, **kw)
        if w is None:
            w = randn(*out.shape)
        grads = []
        if grad:
            (out * P.to_tensor(w)).sum().backward()
            grads = [np.zeros(t.shape, np.float32) if t.grad is None
                     else t.grad.numpy() for t in ins
                     if hasattr(t, "grad") and not t.stop_gradient]
        res.append((out.numpy(), grads))
    (jo, jg), (to, tg) = res
    close(to, jo, rtol, what=f"{name} out")
    assert len(jg) == len(tg)
    for i, (a, b) in enumerate(zip(jg, tg)):
        close(b, a, 1e-5, what=f"{name} grad {i}")
    return to


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
@pytest.mark.parametrize("padding_mode", ["zeros", "border", "reflection"])
@pytest.mark.parametrize("align_corners", [True, False])
def test_grid_sample(mode, padding_mode, align_corners):
    x = randn(2, 3, 5, 6)
    # coordinates well outside [-1, 1] too (padding and reflection), kept
    # off the half-pixel points where nearest rounding could tie
    g = (RNG.random((2, 4, 7, 2)).astype(np.float32) * 5.0 - 2.5)
    both("grid_sample", [x, g], mode=mode, padding_mode=padding_mode,
         align_corners=align_corners)


@pytest.mark.parametrize("align_corners", [True, False])
def test_affine_grid_and_sample(align_corners):
    theta = np.asarray([[[0.8, 0.1, 0.05], [-0.2, 0.9, 0.1]],
                        [[1.1, 0.0, -0.1], [0.3, 0.7, 0.0]]], np.float32)
    grid = both("affine_grid", [theta, [2, 3, 5, 4]],
                align_corners=align_corners)
    both("grid_sample", [randn(2, 3, 6, 6), grid],
         align_corners=align_corners)


def test_affine_grid_identity_and_sample():
    theta = np.asarray([[[1, 0, 0], [0, 1, 0]]], np.float32)
    grid = T.nn.functional.affine_grid(T.to_tensor(theta), [1, 1, 4, 4])
    assert list(grid.shape) == [1, 4, 4, 2]
    x = T.to_tensor(np.arange(16, dtype=np.float32).reshape(1, 1, 4, 4))
    np.testing.assert_allclose(T.nn.functional.grid_sample(x, grid).numpy(),
                               x.numpy(), atol=1e-5)


def test_grid_sample_nearest_and_zeros_padding():
    x = T.to_tensor(np.ones((1, 1, 2, 2), np.float32))
    grid = T.to_tensor(np.asarray([[[[-3.0, -3.0], [0.0, 0.0]]]], np.float32))
    out = T.nn.functional.grid_sample(x, grid, mode="nearest").numpy()
    assert out[0, 0, 0, 0] == 0.0 and out[0, 0, 0, 1] == 1.0


def test_grid_sample_rejects_bad_modes():
    x, g = T.to_tensor(randn(1, 1, 2, 2)), T.to_tensor(randn(1, 1, 1, 2))
    with pytest.raises(ValueError):
        T.nn.functional.grid_sample(x, g, mode="bicubic")
    with pytest.raises(ValueError):
        T.nn.functional.grid_sample(x, g, padding_mode="circular")


@pytest.mark.parametrize("k,s,p,d", [(2, 2, 0, 1), (3, 1, 1, 1),
                                     ((2, 3), (1, 2), (1, 0), (2, 1))])
def test_unfold_and_fold(k, s, p, d):
    x = randn(2, 3, 7, 8)
    cols = both("unfold", [x, k], strides=s, paddings=p, dilations=d)
    both("fold", [cols, [7, 8], k], strides=s, paddings=p, dilations=d,
         rtol=1e-5)


def test_fold_unfold_adjoint():
    x = randn(2, 3, 6, 6)
    F = T.nn.functional
    back = F.fold(F.unfold(T.to_tensor(x), 2, strides=2), (6, 6), 2,
                  strides=2)
    np.testing.assert_allclose(back.numpy(), x, atol=1e-5)
    cols = F.unfold(T.to_tensor(np.ones((1, 1, 3, 3), np.float32)), 2,
                    strides=1)
    assert F.fold(cols, (3, 3), 2, strides=1).numpy()[0, 0, 1, 1] == 4.0


def test_unfold_layer():
    x = randn(1, 2, 5, 5)
    a = J.nn.Unfold(3, 2, 1)(J.to_tensor(x)).numpy()
    b = T.nn.Unfold(3, 2, 1)(T.to_tensor(x)).numpy()
    close(b, a)


@pytest.mark.parametrize("ratio", [0.25, 0.125])
def test_temporal_shift(ratio):
    both("temporal_shift", [randn(6, 8, 2, 3), 3, ratio])


def test_temporal_shift_moves_channels():
    x = np.arange(2 * 4 * 4, dtype=np.float32).reshape(2, 4, 2, 2)
    out = T.nn.functional.temporal_shift(T.to_tensor(x), seg_num=2,
                                         shift_ratio=0.25).numpy()
    np.testing.assert_array_equal(out[0, 0], 0.0)
    np.testing.assert_array_equal(out[1, 0], x[0, 0])


def test_bilinear():
    both("bilinear", [randn(4, 3), randn(4, 5), randn(2, 3, 5)], rtol=1e-5)
    both("bilinear", [randn(4, 3), randn(4, 5), randn(2, 3, 5), randn(1, 2)],
         rtol=1e-5)


def test_bilinear_layer_goes_through_the_functional():
    J.seed(0)
    jm = J.nn.Bilinear(3, 5, 2)
    tm = T.nn.Bilinear(3, 5, 2)
    tm.set_state_dict(state_dict_from_jax(jm))
    a, b = randn(4, 3), randn(4, 5)
    close(tm(T.to_tensor(a), T.to_tensor(b)).numpy(),
          jm(J.to_tensor(a), J.to_tensor(b)).numpy(), 1e-5)
    calls = []
    orig = T.nn.functional.bilinear

    def spy(*args, **kw):
        calls.append(1)
        return orig(*args, **kw)
    import paddle_tpu_torch.nn.layers.common as common
    prev = common.F.bilinear
    common.F.bilinear = spy
    try:
        tm(T.to_tensor(a), T.to_tensor(b))
    finally:
        common.F.bilinear = prev
    assert calls == [1]


def test_feature_alpha_dropout():
    """Whole channels share one mask value, the kept channels are ``a * x +
    b`` and the dropped ones ``a * alpha' + b`` (the reference's SELU
    constants), about half are dropped at p 0.5, and eval mode and p 0 are
    the identity, as in the reference."""
    x = np.ones((16, 8, 3, 3), np.float32)
    T.seed(0)
    out = T.nn.functional.feature_alpha_dropout(T.to_tensor(x), p=0.5,
                                                training=True).numpy()
    np.testing.assert_allclose(out.std(axis=(2, 3)), 0.0, atol=1e-6)
    p, alpha_p = 0.5, -1.7580993408473766
    a = (1 / ((1 - p) * (1 + p * alpha_p ** 2)) ** 0.5)
    b = -a * alpha_p * p
    vals = out[:, :, 0, 0]
    kept = np.isclose(vals, a + b, atol=1e-6)
    dropped = np.isclose(vals, a * alpha_p + b, atol=1e-6)
    assert (kept | dropped).all() and 0.3 < dropped.mean() < 0.7
    for training, pp in ((False, 0.5), (True, 0.0)):
        jo = J.nn.functional.feature_alpha_dropout(
            J.to_tensor(x), pp, training=training).numpy()
        to = T.nn.functional.feature_alpha_dropout(
            T.to_tensor(x), pp, training=training).numpy()
        np.testing.assert_array_equal(to, jo)
    with pytest.raises(ValueError):
        T.nn.functional.feature_alpha_dropout(T.to_tensor(x), p=1.0)

"""The port's pooling (``nn/functional/pooling.py``, ``nn/layers/
pooling.py``) against the JAX package's, mirroring
``tests/test_nn.py::TestPooling``.

Same seeded numpy inputs through both packages; outputs and the
gradients of ``sum(out * r)`` within ``1e-6 * max|ref|`` (pooling sums
in the same order in both, bar the average's divide), indices exactly.
The cases cover ``ceil_mode`` (the reference's extended high pad and the
dropped window that would start in the pad), ``exclusive`` /
``count_include_pad`` / ``divisor_override``, pads torch's own pools
cannot take (asymmetric, wider than half the window, XLA's SAME), NHWC,
the adaptive bins, ``lp_pool``, the fractional pools, the unpools,
``spp`` and the legacy ``pool2d`` / ``pool3d`` names.

``return_mask`` is held to the reference except under ``ceil_mode``,
where the reference is wrong (ROADMAP §C):
``test_reference_ceil_mode_mask_fault`` records the fault.
"""

import numpy as np
import pytest

import paddle_tpu as J
import paddle_tpu_torch as T

RTOL = 1e-6


@pytest.fixture(autouse=True)
def _port_on_cpu():
    prev = T.get_device()
    T.set_device("cpu")
    yield
    T.set_device(prev)


RNG = np.random.default_rng(1)


def _x(*shape):
    return RNG.standard_normal(shape).astype(np.float32)


def close(got, want, rtol=RTOL, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if want.dtype.kind in "iu":
        np.testing.assert_array_equal(got, want, err_msg=what)
        return
    got, want = got.astype(np.float64), want.astype(np.float64)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want),
                                  err_msg=what)
    fin = np.isfinite(want)
    np.testing.assert_array_equal(got[~fin], want[~fin], err_msg=what)
    scale = max(float(np.abs(want[fin]).max(initial=0.0)), 1e-30)
    err = float(np.abs(got[fin] - want[fin]).max(initial=0.0))
    assert err <= rtol * scale, f"{what}: max err {err} > {rtol} * {scale}"


def both(fn_name, x, *args, grad=True, **kw):
    outs, grads = [], []
    for P in (J, T):
        xt = P.to_tensor(x, stop_gradient=not grad)
        out = getattr(P.nn.functional, fn_name)(xt, *args, **kw)
        res = out if isinstance(out, tuple) else (out,)
        outs.append([o.numpy() for o in res])
        if grad:
            r = np.random.default_rng(5).standard_normal(
                res[0].shape).astype(np.float32)
            fin = np.isfinite(res[0].numpy())
            (res[0] * P.to_tensor(np.where(fin, r, 0).astype(np.float32))
             ).sum().backward()
            grads.append(xt.grad.numpy())
    for i, (a, b) in enumerate(zip(*outs)):
        close(b, a, what=f"{fn_name} out {i}")
    if grad:
        close(grads[1], grads[0], what=f"{fn_name} grad")
    return outs[1]


WINDOWS = [
    # the reference's TestPooling legs
    dict(kernel_size=2, stride=2, padding=0),
    dict(kernel_size=3, stride=2, padding=1),
    dict(kernel_size=2, stride=2, padding=0, ceil_mode=True),
    dict(kernel_size=3, stride=3, padding=0, ceil_mode=True),
    # ceil with a pad; a pad torch's pools refuse; asymmetric; SAME
    dict(kernel_size=3, stride=2, padding=1, ceil_mode=True),
    dict(kernel_size=2, stride=2, padding=[1, 1], ceil_mode=True),
    dict(kernel_size=3, stride=2, padding=[1, 2, 0, 1]),
    dict(kernel_size=3, stride=2, padding=[[0, 2], [1, 1]], ceil_mode=True),
    dict(kernel_size=(3, 2), stride=(2, 1), padding="SAME"),
    dict(kernel_size=3, stride=2, padding="VALID"),
]
IDS = [f"w{i}" for i in range(len(WINDOWS))]


@pytest.mark.parametrize("kw", WINDOWS, ids=IDS)
def test_max_pool2d(kw):
    both("max_pool2d", _x(2, 3, 7, 9), **kw)


@pytest.mark.parametrize("kw", WINDOWS, ids=IDS)
@pytest.mark.parametrize("exclusive", [True, False])
def test_avg_pool2d(kw, exclusive):
    both("avg_pool2d", _x(2, 3, 7, 9), exclusive=exclusive, **kw)


def test_avg_pool2d_divisor_and_count_include_pad():
    x = _x(2, 3, 8, 8)
    both("avg_pool2d", x, 3, 2, 1, divisor_override=4)
    both("avg_pool2d", x, 3, 2, [1, 0, 1, 2], divisor_override=5)
    both("avg_pool2d", x, 3, 2, 1, count_include_pad=True)
    both("avg_pool2d", x, 3, 2, 1, ceil_mode=True, count_include_pad=False)


def test_window_entirely_in_padding():
    """A pad as wide as the window: the max of an all-pad window is -inf,
    the exclusive average 0/0, in both."""
    x = _x(1, 2, 5, 6)
    both("max_pool2d", x, 2, 2, 2, grad=False)
    both("avg_pool2d", x, 2, 2, 2, grad=False)


def test_pools_1d_3d_and_nhwc():
    x1, x3 = _x(2, 4, 11), _x(1, 2, 5, 6, 7)
    both("max_pool1d", x1, 3, 2, 1, ceil_mode=True)
    both("avg_pool1d", x1, 3, 2, 1, ceil_mode=True, exclusive=False)
    both("max_pool3d", x3, 2, 2, 0, ceil_mode=True)
    both("avg_pool3d", x3, 3, 2, 1, exclusive=False)
    xh = np.ascontiguousarray(_x(2, 7, 9, 3))
    both("max_pool2d", xh, 3, 2, 1, data_format="NHWC")
    both("avg_pool2d", xh, 2, 2, 0, ceil_mode=True, data_format="NHWC")
    both("max_pool1d", np.ascontiguousarray(x1.transpose(0, 2, 1)), 2,
         data_format="NLC")


def test_return_mask_matches_reference():
    """Without ceil_mode the port's device indices equal the reference's
    host ones (flat into the unpadded plane)."""
    x = _x(2, 3, 8, 9)
    both("max_pool2d", x, 3, 2, 1, return_mask=True)
    both("max_pool2d", x, 2, 2, 0, return_mask=True)
    both("max_pool2d", x, 3, 1, [1, 0, 1, 1], return_mask=True)
    got = both("max_pool2d_with_index", x, 3, 2, 1)
    assert got[1].dtype == np.int64


def _fault_input():
    z = np.zeros((1, 1, 5, 5), np.float32)
    z[0, 0, 3, 4], z[0, 0, 4, 3], z[0, 0, 4, 4] = 0.5, 1.0, 2.0
    return z


def test_reference_ceil_mode_mask_fault():
    """ROADMAP §C: the reference's ``_pool_mask`` pads by the symmetric pad,
    not the ceil-extended one, and decodes a truncated last window's argmax
    with the full kernel width. Paddle's (and torch's) index of output
    (1, 2) is 19 (row 3, col 4); the reference gives 15. The pooled values
    agree."""
    z = _fault_input()
    jo, jm = J.nn.functional.max_pool2d(J.to_tensor(z), 2, 2, 0,
                                        ceil_mode=True, return_mask=True)
    to, tm = T.nn.functional.max_pool2d(T.to_tensor(z), 2, 2, 0,
                                        ceil_mode=True, return_mask=True)
    np.testing.assert_array_equal(to.numpy(), jo.numpy())
    assert int(jm.numpy()[0, 0, 1, 2]) == 15          # the fault
    assert int(tm.numpy()[0, 0, 1, 2]) == 19          # Paddle's index
    # every index names a cell holding its window's max
    flat = z.reshape(-1)
    np.testing.assert_array_equal(flat[tm.numpy().reshape(-1)],
                                  to.numpy().reshape(-1))


def test_return_mask_ceil_mode_and_3d_nhwc_hold_the_max():
    """Where the reference has no mask (ceil_mode: wrong; 3-D, NHWC:
    NotImplementedError), each port index names a cell holding the max."""
    x = _x(2, 3, 7, 9)
    out, idx = T.nn.functional.max_pool2d(T.to_tensor(x), 3, 2, 1,
                                          ceil_mode=True, return_mask=True)
    plane = x.reshape(2, 3, -1)
    got = np.take_along_axis(plane, idx.numpy().reshape(2, 3, -1), -1)
    np.testing.assert_array_equal(got, out.numpy().reshape(2, 3, -1))
    x3 = _x(1, 2, 5, 6, 7)
    out, idx = T.nn.functional.max_pool3d(T.to_tensor(x3), 2, 2, 0,
                                          ceil_mode=True, return_mask=True)
    got = np.take_along_axis(x3.reshape(1, 2, -1),
                             idx.numpy().reshape(1, 2, -1), -1)
    np.testing.assert_array_equal(got, out.numpy().reshape(1, 2, -1))
    xh = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    oh, ih = T.nn.functional.max_pool2d(T.to_tensor(xh), 3, 2, 1,
                                        return_mask=True, data_format="NHWC")
    o, i = T.nn.functional.max_pool2d(T.to_tensor(x), 3, 2, 1,
                                      return_mask=True)
    np.testing.assert_array_equal(oh.numpy(), o.numpy().transpose(0, 2, 3, 1))
    np.testing.assert_array_equal(ih.numpy(), i.numpy().transpose(0, 2, 3, 1))


def test_max_pool_ties_send_gradient_to_the_first():
    """All-zero windows (a ReLU's output before ResNet's stem pool): both
    packages send each window's gradient to its first element."""
    x = np.maximum(_x(2, 3, 8, 8), 0).astype(np.float32)
    x[:, :, :4, :4] = 0.0
    both("max_pool2d", x, 3, 2, 1)
    both("max_pool2d", np.zeros((1, 2, 6, 6), np.float32), 2, 2)


def test_adaptive_pools():
    x = _x(2, 3, 7, 5)
    both("adaptive_avg_pool2d", x, 3)
    both("adaptive_max_pool2d", x, (4, 2))
    both("adaptive_avg_pool2d", x, (1, 1))
    both("adaptive_avg_pool1d", _x(2, 4, 10), 4)
    both("adaptive_max_pool1d", _x(2, 4, 10), 3)
    both("adaptive_avg_pool3d", _x(1, 2, 5, 6, 7), (2, 3, 4))
    both("adaptive_max_pool3d", _x(1, 2, 5, 6, 7), 2)
    xh = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    both("adaptive_avg_pool2d", xh, 3, data_format="NHWC")
    both("adaptive_max_pool2d", xh, (4, 2), data_format="NHWC")


def test_lp_fractional_unpool_spp_legacy():
    x, x1, x3 = _x(2, 3, 9, 9), _x(2, 3, 8), _x(1, 2, 9, 9, 9)
    both("lp_pool2d", x, 2.0, 3, 2, 1)
    both("lp_pool1d", x1, 3.0, 4, 4)
    both("fractional_max_pool2d", x, 4, kernel_size=2, random_u=0.3,
         return_mask=True)
    both("fractional_max_pool3d", x3, 3, kernel_size=2, random_u=0.5,
         return_mask=True)
    both("max_pool3d_with_index", x3, 2, 2, 1)
    both("spp", x, 3)
    both("spp", x, 2, "avg")
    both("pool2d", x, 3, "avg", 2, 1, ceil_mode=True, exclusive=False)
    both("pool2d", x, 2, global_pooling=True)
    both("pool3d", x3, 3, "max", 2, 1)
    o, m = T.nn.functional.max_pool2d(T.to_tensor(x), 2, 2, return_mask=True)
    for name in ("max_unpool2d", "unpool"):
        outs = [getattr(P.nn.functional, name)(
            P.to_tensor(o.numpy()), P.to_tensor(m.numpy()), 2).numpy()
            for P in (J, T)]
        close(outs[1], outs[0], what=name)
    o3, m3 = T.nn.functional.max_pool3d_with_index(T.to_tensor(x3), 2, 2)
    outs = [P.nn.functional.max_unpool3d(P.to_tensor(o3.numpy()),
                                         P.to_tensor(m3.numpy()), 2).numpy()
            for P in (J, T)]
    close(outs[1], outs[0], what="max_unpool3d")


LAYERS = [("MaxPool2D", (3, 2, 1), dict(ceil_mode=True)),
          ("AvgPool2D", (3, 2, 1), dict(exclusive=False)),
          ("MaxPool1D", (2,), {}), ("AvgPool1D", (3, 1, 1), {}),
          ("MaxPool3D", (2,), {}), ("AvgPool3D", (2, 2), {}),
          ("AdaptiveAvgPool2D", ((1, 1),), {}),
          ("AdaptiveMaxPool2D", (2,), {}),
          ("AdaptiveAvgPool1D", (3,), {}), ("AdaptiveMaxPool3D", (2,), {})]


@pytest.mark.parametrize("cls,args,kw", LAYERS, ids=[c[0] for c in LAYERS])
def test_pool_layers(cls, args, kw):
    rank = 1 if "1D" in cls else 3 if "3D" in cls else 2
    x = _x(*((2, 3) + (8,) * rank))
    outs = [getattr(P.nn, cls)(*args, **kw)(P.to_tensor(x)).numpy()
            for P in (J, T)]
    close(outs[1], outs[0], what=cls)
    layer = T.nn.MaxPool2D(2, return_mask=True)
    out, idx = layer(T.to_tensor(_x(1, 2, 4, 4)))
    assert list(idx.shape) == [1, 2, 2, 2]

"""The port's resampling (``interpolate`` / ``upsample`` and the
``*_interp`` modes) and pixel / channel shuffles
(``paddle_tpu_torch/nn/functional/common.py``) and their layers.

The port computes Paddle's ``interp_v2`` contract, held here to numpy
versions of its formulas within 1e-5 x max|ref| (nearest
``floor(dst * ratio)``; linear half-pixel clamped at 0 for ``align_mode
0``, ``dst * ratio`` for ``align_mode 1``, ``(in - 1) / (out - 1)`` with
``align_corners``; bicubic a = -0.75; area an adaptive average), and to
the JAX package where that follows the contract (integer-scale nearest,
linear upsampling, ``align_corners``), outputs within 1e-5 x max|ref| and
gradients within 1e-4 x max|g|. Where the reference's ``jax.image.resize``
departs (ROADMAP §C), ``TestReferenceDivergence`` records by how much.
"""

import math

import numpy as np
import pytest

import paddle_tpu as J
import paddle_tpu_torch as T
from _torch_sweep import check_sweep, close, shared_ops


@pytest.fixture(autouse=True)
def _port_on_cpu():
    prev = T.get_device()
    T.set_device("cpu")
    yield
    T.set_device(prev)


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def interp(p, x, **kw):
    return p.nn.functional.interpolate(p.to_tensor(x), **kw).numpy()


# -- numpy versions of Paddle's formulas, one axis at a time ---------------------

def _ratio(isz, osz, scale, align_corners):
    if align_corners:
        return (isz - 1) / (osz - 1) if osz > 1 else 0.0
    return 1.0 / scale if scale else isz / osz


def _along(x, ax, idx, w):
    """sum_k w[k] * x[idx[k]] along ``ax`` (idx, w: [taps, osz])."""
    out = 0.0
    for i, wi in zip(idx, w):
        shape = [1] * x.ndim
        shape[ax] = len(wi)
        out = out + np.take(x, i, axis=ax) * wi.reshape(shape)
    return out


def np_nearest(x, out, scale=None):
    for k, osz in enumerate(out):
        ax = 2 + k
        isz = x.shape[ax]
        r = _ratio(isz, osz, scale, False)
        idx = np.minimum(np.floor(np.arange(osz) * r).astype(int), isz - 1)
        x = np.take(x, idx, axis=ax)
    return x


def np_linear(x, out, scale=None, align_corners=False, align_mode=0):
    x = x.astype(np.float64)
    for k, osz in enumerate(out):
        ax = 2 + k
        isz = x.shape[ax]
        r = _ratio(isz, osz, scale, align_corners)
        d = np.arange(osz, dtype=np.float64)
        if align_corners or align_mode == 1:
            src = d * r
        else:
            src = np.maximum((d + 0.5) * r - 0.5, 0.0)
        i0 = np.minimum(np.floor(src).astype(int), isz - 1)
        i1 = np.minimum(i0 + 1, isz - 1)
        lam = src - i0
        x = _along(x, ax, [i0, i1], [1 - lam, lam])
    return x


def _cubic(t, a=-0.75):
    t = np.abs(t)
    return np.where(t <= 1, ((a + 2) * t - (a + 3)) * t * t + 1,
                    np.where(t < 2, ((a * t - 5 * a) * t + 8 * a) * t - 4 * a,
                             0.0))


def np_bicubic(x, out, scale=None, align_corners=False):
    x = x.astype(np.float64)
    for k, osz in enumerate(out):
        ax = 2 + k
        isz = x.shape[ax]
        r = _ratio(isz, osz, scale, align_corners)
        d = np.arange(osz, dtype=np.float64)
        src = d * r if align_corners else (d + 0.5) * r - 0.5
        f = np.floor(src).astype(int)
        t = src - f
        idx = [np.clip(f + o, 0, isz - 1) for o in (-1, 0, 1, 2)]
        w = [_cubic(t - o) for o in (-1, 0, 1, 2)]
        x = _along(x, ax, idx, w)
    return x


def np_area(x, out):
    for k, osz in enumerate(out):
        ax = 2 + k
        isz = x.shape[ax]
        cols = []
        for i in range(osz):
            lo, hi = (i * isz) // osz, math.ceil((i + 1) * isz / osz)
            cols.append(np.take(x, np.arange(lo, hi), axis=ax).mean(
                axis=ax, keepdims=True))
        x = np.concatenate(cols, axis=ax)
    return x


# -- Paddle's contract ------------------------------------------------------------

CONTRACT = [
    ("nearest 8->12", (1, 2, 8, 8), dict(size=[12, 12], mode="nearest"),
     lambda x: np_nearest(x, [12, 12])),
    ("nearest 8->5", (1, 2, 8, 8), dict(size=[5, 5], mode="nearest"),
     lambda x: np_nearest(x, [5, 5])),
    ("nearest scale 1.5", (1, 2, 8, 6), dict(scale_factor=1.5,
                                              mode="nearest"),
     lambda x: np_nearest(x, [12, 9], scale=1.5)),
    ("bilinear 8->5", (2, 3, 8, 8), dict(size=[5, 5], mode="bilinear"),
     lambda x: np_linear(x, [5, 5])),
    ("bilinear 8->13 align_mode 1", (1, 2, 8, 8),
     dict(size=[13, 13], mode="bilinear", align_mode=1),
     lambda x: np_linear(x, [13, 13], align_mode=1)),
    ("bilinear 8->5 align_mode 1", (1, 2, 8, 8),
     dict(size=[5, 5], mode="bilinear", align_mode=1),
     lambda x: np_linear(x, [5, 5], align_mode=1)),
    ("linear scale 0.6", (2, 3, 10), dict(scale_factor=0.6, mode="linear",
                                          data_format="NCW"),
     lambda x: np_linear(x, [6], scale=0.6)),
    ("trilinear 4->7 align_corners", (1, 2, 4, 4, 4),
     dict(size=[7, 6, 5], mode="trilinear", align_corners=True,
          data_format="NCDHW"),
     lambda x: np_linear(x, [7, 6, 5], align_corners=True)),
    ("bicubic 8->16", (1, 2, 8, 8), dict(size=[16, 16], mode="bicubic"),
     lambda x: np_bicubic(x, [16, 16])),
    ("bicubic 8->5 align_corners", (1, 2, 8, 8),
     dict(size=[5, 5], mode="bicubic", align_corners=True),
     lambda x: np_bicubic(x, [5, 5], align_corners=True)),
    ("area 9->4", (1, 2, 9, 9), dict(size=[4, 4], mode="area"),
     lambda x: np_area(x, [4, 4])),
]


@pytest.mark.parametrize("name,shape,kw,oracle", CONTRACT,
                         ids=[c[0] for c in CONTRACT])
def test_paddle_contract(name, shape, kw, oracle):
    x = _x(shape, seed=len(name))
    close(interp(T, x, **kw), oracle(x))


@pytest.mark.parametrize("fmt,shape,kw", [
    ("NHWC", (2, 8, 8, 3), dict(size=[5, 11], mode="bilinear")),
    ("NWC", (2, 8, 3), dict(size=[13], mode="linear")),
    ("NDHWC", (1, 4, 4, 4, 2), dict(scale_factor=2, mode="nearest")),
    ("NHWC", (1, 6, 6, 2), dict(size=[9, 9], mode="bicubic",
                                align_corners=True)),
])
def test_channels_last_equals_channels_first(fmt, shape, kw):
    x = _x(shape, seed=3)
    first = np.moveaxis(x, -1, 1)
    got = interp(T, x, data_format=fmt, **kw)
    want = interp(T, first, **kw)
    close(got, np.moveaxis(want, 1, -1))


def test_nearest_with_align_corners_raises():
    with pytest.raises(ValueError, match="align_corners"):
        interp(T, _x((1, 1, 4, 4)), size=[8, 8], mode="nearest",
               align_corners=True)


# -- where the reference follows the contract --------------------------------------

AGREE = [
    ("nearest x2", (1, 3, 4, 5), dict(scale_factor=2, mode="nearest")),
    ("nearest x3 NHWC", (2, 4, 4, 3), dict(scale_factor=3, mode="nearest",
                                           data_format="NHWC")),
    ("nearest x2 3-D", (1, 2, 3, 3, 3), dict(scale_factor=2, mode="nearest",
                                             data_format="NCDHW")),
    ("bilinear up 8->13", (2, 3, 8, 8), dict(size=[13, 13],
                                             mode="bilinear")),
    ("linear up 6->15", (2, 3, 6), dict(size=[15], mode="linear",
                                        data_format="NCW")),
    ("trilinear up", (1, 2, 3, 4, 5), dict(size=[6, 7, 9], mode="trilinear",
                                           data_format="NCDHW")),
    ("bilinear align_corners 8->5", (1, 2, 8, 8),
     dict(size=[5, 5], mode="bilinear", align_corners=True)),
    ("bilinear align_corners 5->12", (1, 2, 5, 5),
     dict(size=[12, 12], mode="bilinear", align_corners=True)),
]


@pytest.mark.parametrize("name,shape,kw", AGREE, ids=[a[0] for a in AGREE])
def test_matches_jax_where_it_follows_paddle(name, shape, kw):
    x = _x(shape, seed=len(name))
    close(interp(T, x, **kw), interp(J, x, **kw))
    grads = []
    for p in (J, T):
        t = p.to_tensor(x, stop_gradient=False)
        out = p.nn.functional.interpolate(t, **kw)
        (g,) = p.grad([(out * out).sum()], [t])
        grads.append(g.numpy())
    close(grads[1], grads[0], rtol=1e-4)


def test_interp_names_and_layers_match_jax():
    x = _x((1, 2, 4, 4), seed=5)
    for name, kw in (("nearest_interp", {"scale_factor": 2}),
                     ("bilinear_interp", {"size": [7, 7],
                                          "align_corners": True}),
                     ("upsample", {"scale_factor": 2})):
        close(getattr(T.nn.functional, name)(T.to_tensor(x), **kw).numpy(),
              getattr(J.nn.functional, name)(J.to_tensor(x), **kw).numpy())
    x3 = _x((1, 2, 5), seed=6)
    close(T.nn.functional.linear_interp(T.to_tensor(x3), size=[9],
                                        align_corners=True).numpy(),
          J.nn.functional.linear_interp(J.to_tensor(x3), size=[9],
                                        align_corners=True).numpy())
    for cls, kw in (("Upsample", {"scale_factor": 2}),
                    ("UpsamplingNearest2D", {"scale_factor": 3}),
                    ("UpsamplingBilinear2D", {"size": [9, 6]})):
        close(getattr(T.nn, cls)(**kw)(T.to_tensor(x)).numpy(),
              getattr(J.nn, cls)(**kw)(J.to_tensor(x)).numpy())


# -- the shuffles ------------------------------------------------------------------

def test_shuffles_match_jax_and_invert():
    x = _x((2, 8, 3, 5), seed=7)
    for fn, arg in (("pixel_shuffle", 2), ("pixel_unshuffle", 1),
                    ("channel_shuffle", 4)):
        close(getattr(T.nn.functional, fn)(T.to_tensor(x), arg).numpy(),
              getattr(J.nn.functional, fn)(J.to_tensor(x), arg).numpy())
    up = T.nn.PixelShuffle(2)(T.to_tensor(x))
    close(T.nn.PixelUnshuffle(2)(up).numpy(), x)
    close(T.nn.ChannelShuffle(2)(T.to_tensor(x)).numpy(),
          J.nn.ChannelShuffle(2)(J.to_tensor(x)).numpy())
    y = _x((1, 4, 6, 2), seed=8)
    close(T.nn.functional.pixel_unshuffle(T.to_tensor(y), 2).numpy(),
          J.nn.functional.pixel_unshuffle(J.to_tensor(y), 2).numpy())


def test_shuffles_channels_last():
    x = _x((2, 3, 5, 8), seed=9)
    first = np.moveaxis(x, -1, 1)
    for fn, arg in (("pixel_shuffle", 2), ("pixel_unshuffle", 1),
                    ("channel_shuffle", 4)):
        got = getattr(T.nn.functional, fn)(T.to_tensor(x), arg,
                                           data_format="NHWC").numpy()
        want = getattr(T.nn.functional, fn)(T.to_tensor(first), arg).numpy()
        close(got, np.moveaxis(want, 1, -1))
    y = _x((1, 4, 6, 3), seed=10)
    down = T.nn.functional.pixel_unshuffle(T.to_tensor(y), 2,
                                           data_format="NHWC")
    close(T.nn.functional.pixel_shuffle(down, 2, data_format="NHWC").numpy(),
          y)


# -- the reference's departures (ROADMAP §C) ---------------------------------------

class TestReferenceDivergence:
    """``jax.image.resize`` against Paddle's formulas on an 8 x 8 randn
    map: each divergence measured, and the port on the formula."""

    x = _x((1, 1, 8, 8), seed=0)

    def _gap(self, kw, oracle):
        ref = interp(J, self.x, **kw)
        close(interp(T, self.x, **kw), oracle)
        return float(np.abs(ref - oracle).max())

    def test_nearest_takes_half_pixel_centres(self):
        gap = self._gap(dict(size=[12, 12], mode="nearest"),
                        np_nearest(self.x, [12, 12]))
        assert gap > 1.0, gap                 # 4.09 on this map

    def test_linear_downsampling_antialiases(self):
        gap = self._gap(dict(size=[5, 5], mode="bilinear"),
                        np_linear(self.x, [5, 5]))
        assert gap > 0.5, gap                 # 0.97

    def test_bicubic_takes_a_minus_half(self):
        gap = self._gap(dict(size=[16, 16], mode="bicubic"),
                        np_bicubic(self.x, [16, 16]))
        assert gap > 0.1, gap                 # 0.227

    def test_align_mode_is_ignored(self):
        kw = dict(size=[13, 13], mode="bilinear")
        np.testing.assert_array_equal(
            interp(J, self.x, align_mode=1, **kw), interp(J, self.x, **kw))
        gap = self._gap(dict(align_mode=1, **kw),
                        np_linear(self.x, [13, 13], align_mode=1))
        assert gap > 0.1, gap

    def test_area_is_linear(self):
        gap = self._gap(dict(size=[4, 4], mode="area"),
                        np_area(self.x, [4, 4]))
        np.testing.assert_array_equal(
            interp(J, self.x, size=[4, 4], mode="area"),
            interp(J, self.x, size=[4, 4], mode="bilinear"))
        assert gap > 0.05, gap


def test_reference_nhwc_pixel_shuffle_orders_channels_otherwise():
    """Paddle's NHWC ``pixel_shuffle`` is its NCHW result transposed (the
    port, ``test_shuffles_channels_last``); the reference reads the NHWC
    channels as ``(r, r, C)`` where Paddle reads ``(C, r, r)``."""
    x = _x((1, 2, 3, 8), seed=11)
    ref = J.nn.functional.pixel_shuffle(J.to_tensor(x), 2,
                                        data_format="NHWC").numpy()
    port = T.nn.functional.pixel_shuffle(T.to_tensor(x), 2,
                                         data_format="NHWC").numpy()
    assert float(np.abs(ref - port).max()) > 0.5


# -- the registry sweep of these ops -----------------------------------------------

@pytest.mark.parametrize("name", shared_ops("resample"))
def test_registry_sweep(name):
    check_sweep(name)

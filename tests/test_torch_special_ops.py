"""The port's special functions, windows, ``paddle.fft`` and
``paddle.signal`` (``paddle_tpu_torch/ops/special.py``, ``windows.py``,
``fft.py``, ``signal.py``) against the JAX package's on the same numpy
inputs, and against scipy / torch oracles.

Float outputs agree within 1e-5 of the reference's max-abs, gradients
within 1e-4 of the largest; integer outputs exactly. The dtype of every
FFT output equals the reference's for integer, bfloat16, float16 and
float32 inputs.
"""

import numpy as np
import pytest

import paddle_tpu as J
import paddle_tpu.fft  # noqa: F401
import paddle_tpu.signal  # noqa: F401
import paddle_tpu_torch as T
from _torch_sweep import check_sweep, shared_ops
import paddle_tpu_torch.fft  # noqa: F401
import paddle_tpu_torch.signal  # noqa: F401

FWD_RTOL = 1e-5
GRAD_RTOL = 1e-4


@pytest.fixture(autouse=True)
def _port_on_cpu():
    prev = T.get_device()
    T.set_device("cpu")
    yield
    T.set_device(prev)


def _np(x):
    return np.asarray(x.numpy()) if hasattr(x, "numpy") else np.asarray(x)


def close(got, want, rtol=FWD_RTOL, what=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if want.dtype.kind in "biu" or got.dtype.kind in "biu":
        np.testing.assert_array_equal(got, want, err_msg=what)
        return
    np.testing.assert_array_equal(np.isinf(got) & (got.real > 0),
                                  np.isinf(want) & (want.real > 0), what)
    np.testing.assert_array_equal(np.isinf(got) & (got.real < 0),
                                  np.isinf(want) & (want.real < 0), what)
    fin = np.isfinite(want)
    got, want = got[fin], want[fin]
    scale = max(float(np.abs(want).max()) if want.size else 0.0, 1e-30)
    err = float(np.abs(got.astype(np.complex128) - want).max(initial=0.0))
    assert err <= rtol * scale, f"{what}: max err {err} > {rtol} * {scale}"


def both(body, rtol=FWD_RTOL):
    rj, rt = body(J), body(T)
    rj = rj if isinstance(rj, (tuple, list)) else [rj]
    rt = rt if isinstance(rt, (tuple, list)) else [rt]
    assert len(rj) == len(rt)
    for i, (a, b) in enumerate(zip(rj, rt)):
        close(b, a, rtol=rtol, what=f"leaf {i}")
    return rt


def grads(p, body, arrays, wrt):
    """Gradients of ``sum(body(paddle, *tensors))`` in the ``wrt`` arrays
    (the others stop gradients)."""
    ts = [p.to_tensor(a, stop_gradient=i not in wrt)
          for i, a in enumerate(arrays)]
    out = body(p, *ts)
    out = out[0] if isinstance(out, (tuple, list)) else out
    if np.iscomplexobj(out.numpy()):
        out = p.abs(out)
    return [g.numpy() for g in p.grad([out.sum()], [ts[i] for i in wrt])]


def grads_agree(body, arrays, wrt=None):
    wrt = list(range(len(arrays))) if wrt is None else wrt
    for gj, gt in zip(grads(J, body, arrays, wrt), grads(T, body, arrays,
                                                         wrt)):
        close(gt, gj, rtol=GRAD_RTOL, what="grad")


# -- betainc ---------------------------------------------------------------------

class TestBetainc:
    def _grid(self):
        rng = np.random.default_rng(0)
        a = rng.uniform(0.2, 30.0, (6, 8)).astype(np.float32)
        b = rng.uniform(0.2, 30.0, (6, 8)).astype(np.float32)
        x = rng.uniform(0.0, 1.0, (6, 8)).astype(np.float32)
        x[0, :3] = [0.0, 1.0, 0.999]
        return a, b, x

    def test_matches_scipy_and_jax(self):
        import scipy.special as sp
        a, b, x = self._grid()
        out = T.betainc(a, b, x).numpy()
        close(out, sp.betainc(*(v.astype(np.float64) for v in (a, b, x))),
              rtol=1e-6)
        # JAX's float32 continued fraction is itself up to 1.1e-5 off
        # scipy on this grid (ROADMAP §C)
        close(out, J.betainc(a, b, x).numpy(), rtol=2e-5)

    def test_both_sides_of_the_symmetry_switch(self):
        a = np.full(9, 3.0, np.float32)
        b = np.full(9, 5.0, np.float32)
        x = np.linspace(0.05, 0.95, 9).astype(np.float32)  # switch at 0.4
        both(lambda p: p.betainc(a, b, x))

    def test_x_gradient_as_jax(self):
        a, b, x = self._grid()
        x = np.clip(x, 0.05, 0.95)
        grads_agree(lambda p, *v: p.betainc(*v), [a, b, x], wrt=[2])

    def test_a_b_gradients_raise_as_in_jax(self):
        a, b, x = self._grid()
        for wrt in ([0], [1]):
            with pytest.raises(Exception, match="a and b"):
                grads(T, lambda p, *v: p.betainc(*v), [a, b, x], wrt)


# -- the derivatives torch lacks ------------------------------------------------

@pytest.mark.parametrize("name", ["igamma", "igammac", "gammainc",
                                  "gammaincc"])
def test_incomplete_gamma_gradient_in_a(name):
    rng = np.random.default_rng(1)
    a = rng.uniform(0.5, 6.0, (4, 5)).astype(np.float32)
    x = rng.uniform(0.1, 8.0, (4, 5)).astype(np.float32)
    both(lambda p: getattr(p, name)(a, x))
    grads_agree(lambda p, u, v: getattr(p, name)(u, v), [a, x])


def test_zeta_gradients():
    rng = np.random.default_rng(2)
    s = rng.uniform(1.5, 4.0, (3, 4)).astype(np.float32)
    q = rng.uniform(0.5, 3.0, (3, 4)).astype(np.float32)
    both(lambda p: p.zeta(s, q))
    grads_agree(lambda p, u, v: p.zeta(u, v), [s, q])


@pytest.mark.parametrize("name", ["erfcx", "ndtr", "log_ndtr", "ndtri",
                                  "entr", "spherical_bessel_j0", "cbrt",
                                  "sinc_pi", "expit", "exp2", "erfc"])
def test_unary_special_vs_jax(name):
    x = np.linspace(0.05, 0.95, 24).astype(np.float32).reshape(4, 6)
    both(lambda p: getattr(p, name)(x))
    grads_agree(lambda p, v: getattr(p, name)(v), [x])


# -- statistics and edges --------------------------------------------------------

class TestEdgeRules:
    def test_histc_values_on_the_edges(self):
        x = np.array([0.0, 0.25, 0.5, 0.75, 1.0, 1.0, -0.1, 1.1, 0.5],
                     np.float32)
        out = both(lambda p: p.histc(x, bins=4, min=0, max=1))[0]
        np.testing.assert_array_equal(out.numpy(), [1, 1, 2, 3])
        both(lambda p: p.histc(x, bins=5))
        both(lambda p: p.histogram_bin_edges(x, bins=5))

    def test_histc_constant_input(self):
        x = np.full(6, 2.0, np.float32)
        both(lambda p: p.histc(x, bins=3))

    @pytest.mark.parametrize("kw", [{}, {"spacing": 0.5},
                                    {"spacing": 2.0, "axis": 1},
                                    {"axis": [0, 1]}])
    def test_gradient_as_numpy(self, kw):
        x = np.random.RandomState(3).randn(5, 6).astype(np.float32)
        out = both(lambda p: p.gradient(x, **kw))
        axes = kw.get("axis", None)
        ref = np.gradient(x, kw.get("spacing", 1.0),
                          axis=tuple(axes) if isinstance(axes, list) else axes)
        ref = ref if isinstance(ref, (list, tuple)) else [ref]
        for o, r in zip(out, ref):
            np.testing.assert_allclose(o.numpy(), r, rtol=1e-5, atol=1e-6)

    def test_nan_reductions(self):
        x = np.random.RandomState(4).randn(4, 5).astype(np.float32)
        x[0, 1] = x[2, :] = np.nan
        both(lambda p: p.nanargmax(x, axis=1))
        both(lambda p: p.nanargmin(x, axis=0))
        both(lambda p: p.nanstd(x[:, :3].T, axis=1))
        both(lambda p: p.nanvar(x[[0, 1, 3]], axis=0, keepdim=True))


# -- windows ------------------------------------------------------------------------

WINDOWS = ["blackman", "hamming", "hann", "bartlett", "kaiser", "nuttall",
           "blackmanharris", "bohman", "cosine", "tukey", "gaussian",
           "exponential", "triang", "taylor", ("kaiser", 8.0),
           ("gaussian", 3.0), ("tukey", 0.3), ("general_hamming", 0.6),
           ("general_cosine", [0.5, 0.3, 0.2])]


@pytest.mark.parametrize("window", WINDOWS, ids=str)
@pytest.mark.parametrize("fftbins", [True, False])
def test_get_window_matches_scipy_and_jax(window, fftbins):
    import scipy.signal
    out = both(lambda p: p.get_window(window, 33, fftbins=fftbins))[0]
    # scipy's names for the reference's defaults of the bare names
    spec = {"exponential": ("exponential", None, 1.0),
            "kaiser": ("kaiser", 12.0), "gaussian": ("gaussian", 7.0)}
    ref = scipy.signal.get_window(
        spec.get(window, window) if isinstance(window, str) else window, 33,
        fftbins=fftbins)
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-6)


@pytest.mark.parametrize("name", [
    "blackman_window", "hamming_window", "hann_window", "bartlett_window",
    "kaiser_window", "nuttall_window", "blackman_harris_window",
    "bohman_window", "cosine_window", "tukey_window", "gaussian_window",
    "exponential_window", "triang_window", "taylor_window"])
@pytest.mark.parametrize("sym", [True, False])
def test_window_creation_ops(name, sym):
    out = both(lambda p: getattr(p, name)(16, sym=sym))[0]
    assert out.numpy().dtype == np.float32


def test_parametrized_window_creation_ops():
    both(lambda p: p.general_cosine_window(12, [0.4, 0.5, 0.1]))
    both(lambda p: p.general_hamming_window(12, 0.6, sym=False))


# -- paddle.fft ------------------------------------------------------------------------

ONE_D = ["fft", "ifft", "rfft", "irfft", "hfft", "ihfft"]
N_D = ["fft2", "ifft2", "rfft2", "irfft2", "fftn", "ifftn", "rfftn",
       "irfftn", "hfft2", "ihfft2", "hfftn", "ihfftn"]
REAL_IN = {"rfft", "ihfft", "rfft2", "rfftn", "ihfft2", "ihfftn"}


def _fft_input(name, dtype=np.float32):
    rng = np.random.RandomState(sum(map(ord, name)))
    x = rng.randn(4, 6).astype(np.float32)
    if name in REAL_IN:
        return x.astype(dtype)
    return (x + 1j * rng.randn(4, 6)).astype(np.complex64)


def _ns(p, name):
    return getattr(p.fft, name) if hasattr(p.fft, name) else getattr(p, name)


@pytest.mark.parametrize("name", ONE_D + N_D)
@pytest.mark.parametrize("norm", ["backward", "ortho", "forward"])
def test_fft_family_vs_jax(name, norm):
    x = _fft_input(name)
    out = both(lambda p: _ns(p, name)(p.to_tensor(x), norm=norm))[0]
    ref = _ns(J, name)(J.to_tensor(x), norm=norm)
    assert out.numpy().dtype == ref.numpy().dtype


@pytest.mark.parametrize("name", ["fft", "rfft", "irfft", "fft2", "rfftn",
                                  "hfft", "ihfft2"])
def test_fft_sizes_and_axes(name):
    x = _fft_input(name)
    if name in ONE_D:
        both(lambda p: _ns(p, name)(p.to_tensor(x), n=5, axis=0))
    else:
        both(lambda p: _ns(p, name)(p.to_tensor(x), s=(3, 4), axes=(0, 1)))


@pytest.mark.parametrize("name", ["fft", "rfft", "fft2", "rfftn", "ihfft"])
def test_fft_gradients_vs_jax(name):
    x = _fft_input(name).real.astype(np.float32)
    grads_agree(lambda p, v: _ns(p, name)(v), [x])


@pytest.mark.parametrize("dtype", ["int32", "bfloat16", "float16",
                                   "float32"])
@pytest.mark.parametrize("name", ["fft", "rfft", "fft2", "rfftn", "ihfft"])
def test_fft_dtype_rule(name, dtype):
    x = np.arange(24).reshape(4, 6) % 5 - 2
    tj = J.to_tensor(x.astype(np.float32)).astype(dtype)
    tt = T.to_tensor(x.astype(np.float32)).astype(dtype)
    try:
        rj = _ns(J, name)(tj)
    except Exception as e:          # a real-input transform of a half
        with pytest.raises(Exception, match="RFFT input must be"):
            _ns(T, name)(tt)
        assert "RFFT input must be" in str(e)
        return
    rt = _ns(T, name)(tt)
    assert rt.numpy().dtype == rj.numpy().dtype, (rt.dtype, rj.dtype)
    close(rt, rj, rtol=1e-6)


def test_freqs_and_shifts():
    both(lambda p: p.fft.fftfreq(9, d=0.5))
    both(lambda p: p.fft.rfftfreq(10))
    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    both(lambda p: p.fft.fftshift(p.to_tensor(x)))
    both(lambda p: p.fft.ifftshift(p.to_tensor(x), axes=[1]))


# -- paddle.signal (tests/test_extended_ops.py's TestSignal) -----------------------------

class TestSignal:
    def test_stft_matches_torch(self):
        import torch
        rng = np.random.RandomState(6)
        x = rng.randn(2, 512).astype(np.float32)
        win = np.hanning(128).astype(np.float32)
        out = both(lambda p: p.signal.stft(p.to_tensor(x), n_fft=128,
                                           hop_length=64,
                                           window=p.to_tensor(win)))[0]
        ref = torch.stft(torch.tensor(x), n_fft=128, hop_length=64,
                         window=torch.tensor(win), center=True,
                         pad_mode="reflect", return_complex=True).numpy()
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-3, atol=1e-4)

    def test_istft_roundtrip(self):
        rng = np.random.RandomState(7)
        x = rng.randn(1024).astype(np.float32)
        win = np.hanning(256).astype(np.float32)

        def body(p):
            sp = p.signal.stft(p.to_tensor(x), n_fft=256, hop_length=64,
                               window=p.to_tensor(win))
            return p.signal.istft(sp, n_fft=256, hop_length=64,
                                  window=p.to_tensor(win), length=1024)
        back = both(body)[0]
        np.testing.assert_allclose(back.numpy(), x, atol=1e-4)

    @pytest.mark.parametrize("kw", [
        {"center": False}, {"normalized": True}, {"onesided": False},
        {"win_length": 48}, {"pad_mode": "constant"}])
    def test_stft_options_vs_jax(self, kw):
        x = np.random.RandomState(8).randn(3, 200).astype(np.float32)
        both(lambda p: p.signal.stft(p.to_tensor(x), n_fft=64, **kw))

    def test_stft_istft_gradients_vs_jax(self):
        x = np.random.RandomState(9).randn(2, 160).astype(np.float32)
        win = np.hanning(32).astype(np.float32)
        grads_agree(lambda p, v: p.signal.stft(v, n_fft=32, hop_length=8,
                                               window=p.to_tensor(win)), [x])
        grads_agree(lambda p, v: p.signal.istft(
            p.signal.stft(v, n_fft=32, hop_length=8,
                          window=p.to_tensor(win)),
            n_fft=32, hop_length=8, window=p.to_tensor(win)), [x])


# -- the registry sweep of this family's ops (_torch_sweep.py) -----------------

@pytest.mark.parametrize("name", shared_ops("special"))
def test_registry_sweep(name):
    check_sweep(name)

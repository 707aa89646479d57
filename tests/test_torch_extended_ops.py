"""The port's extended, extras, sets, array and in-place op families
(``paddle_tpu_torch/ops/extended.py``, ``extras.py``, ``sets.py``,
``array.py``, ``inplace.py``) against the JAX package's on the same numpy
inputs, with ``tests/test_extended_ops.py``'s ``TestExtended`` and
``TestInplace`` oracles (numpy, torch) and ``tests/test_op_sweep.py``'s
in-place aliasing sweep.

Float outputs agree within 1e-5 of the reference's max-abs, gradients
within 1e-4 of the largest; integer, index and set outputs exactly. Random
ops are held by their moments and by reproducibility under ``seed``.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as J
import paddle_tpu_torch as T
from _torch_sweep import check_sweep, shared_ops
from paddle_tpu.core.dispatch import OP_REGISTRY as JR
from paddle_tpu.ops.sweep_specs import attach_specs
from paddle_tpu_torch.core.dispatch import OP_REGISTRY as TR

attach_specs()

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


def both(body):
    rj, rt = body(J), body(T)
    rj = rj if isinstance(rj, (tuple, list)) else [rj]
    rt = rt if isinstance(rt, (tuple, list)) else [rt]
    assert len(rj) == len(rt)
    for i, (a, b) in enumerate(zip(rj, rt)):
        if isinstance(a, (list, tuple)):
            for k, (u, v) in enumerate(zip(a, b)):
                close(v, u, what=f"leaf {i}.{k}")
        else:
            close(b, a, what=f"leaf {i}")
    return rt


def grads_agree(body, *arrays):
    def run(p):
        ts = [p.to_tensor(a, stop_gradient=False) for a in arrays]
        out = body(p, *ts)
        out = out[0] if isinstance(out, (tuple, list)) else out
        return [g.numpy() for g in p.grad([out.sum()], ts)]
    for gj, gt in zip(run(J), run(T)):
        close(gt, gj, rtol=GRAD_RTOL, what="grad")


def t(a, sg=True):
    return T.to_tensor(a, stop_gradient=sg)


# -- tests/test_extended_ops.py: TestExtended ---------------------------------------

class TestExtended:
    def test_slice_scatter(self):
        x = np.zeros((4, 6), np.float32)
        v = np.ones((4, 2), np.float32) * 7
        out = both(lambda p: p.slice_scatter(p.to_tensor(x), p.to_tensor(v),
                                             axes=[1], starts=[2],
                                             ends=[4]))[0]
        ref = x.copy()
        ref[:, 2:4] = 7
        np.testing.assert_array_equal(out.numpy(), ref)
        grads_agree(lambda p, a, b: p.slice_scatter(
            a, b, axes=[1], starts=[1], ends=[5], strides=[2]),
            np.ones((4, 6), np.float32), v)

    def test_as_strided(self):
        x = np.arange(12, dtype=np.float32)
        out = both(lambda p: p.as_strided(p.to_tensor(x), shape=[3, 4],
                                          stride=[4, 1]))[0]
        np.testing.assert_array_equal(out.numpy(), x.reshape(3, 4))
        out2 = both(lambda p: p.as_strided(p.to_tensor(x), shape=[5, 4],
                                           stride=[2, 1]))[0]
        ref2 = np.lib.stride_tricks.as_strided(x, (5, 4), (2 * 4, 4)).copy()
        np.testing.assert_array_equal(out2.numpy(), ref2)

    def test_as_strided_reads_the_values_not_the_storage(self):
        # a transposed (non-contiguous) input and an offset view: the
        # strides index the flat values, as the reference's gather does
        x = np.arange(24, dtype=np.float32).reshape(4, 6)
        both(lambda p: p.as_strided(p.to_tensor(x).T, [3, 3], [4, 1],
                                    offset=2))
        both(lambda p: p.as_strided(p.to_tensor(x)[1:, 2:], [2, 2], [3, 1],
                                    offset=1))

    def test_unfold(self):
        x = np.arange(10, dtype=np.float32)
        out = both(lambda p: p.to_tensor(x).unfold(axis=0, size=4,
                                                   step=2))[0]
        ref = torch.tensor(x).unfold(0, 4, 2).numpy()
        np.testing.assert_array_equal(out.numpy(), ref)

    def test_cummin_matches_torch(self):
        a = np.random.RandomState(0).randn(4, 6).astype(np.float32)
        vals, idx = both(lambda p: p.cummin(p.to_tensor(a), axis=1))
        tv, ti = torch.tensor(a).cummin(dim=1)
        np.testing.assert_allclose(vals.numpy(), tv.numpy(), atol=1e-6)
        np.testing.assert_array_equal(idx.numpy(), ti.numpy())

    def test_logcumsumexp(self):
        a = np.random.RandomState(1).randn(3, 5).astype(np.float32)
        out = both(lambda p: p.logcumsumexp(p.to_tensor(a), axis=1))[0]
        ref = torch.logcumsumexp(torch.tensor(a), dim=1).numpy()
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5)

    def test_index_sample(self):
        x = np.arange(12, dtype=np.float32).reshape(3, 4)
        idx = np.array([[0, 2], [1, 3], [3, 0]], np.int64)
        out = both(lambda p: p.index_sample(p.to_tensor(x),
                                            p.to_tensor(idx)))[0]
        np.testing.assert_array_equal(out.numpy(),
                                      np.take_along_axis(x, idx, 1))

    def test_frexp(self):
        a = np.array([0.5, 3.0, -6.0, 0.25], np.float32)
        m, e = both(lambda p: p.frexp(p.to_tensor(a)))
        rm, re = np.frexp(a)
        np.testing.assert_allclose(m.numpy(), rm, atol=1e-6)
        np.testing.assert_array_equal(e.numpy(), re)

    def test_hermitian_fft_against_torch(self):
        rng = np.random.RandomState(2)
        x = (rng.randn(4, 5) + 1j * rng.randn(4, 5)).astype(np.complex64)
        out = both(lambda p: p.hfft2(p.to_tensor(x)))[0]
        ref = torch.fft.hfft2(torch.tensor(x)).numpy()
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=1e-4)
        y = rng.randn(4, 8).astype(np.float32)
        out_i = both(lambda p: p.ihfft2(p.to_tensor(y)))[0]
        ref_i = torch.fft.ihfft2(torch.tensor(y)).numpy()
        np.testing.assert_allclose(out_i.numpy(), ref_i, rtol=1e-4,
                                   atol=1e-5)
        both(lambda p: p.hfftn(p.to_tensor(x), s=[4, 6], norm="ortho"))
        both(lambda p: p.ihfftn(p.to_tensor(y), axes=[1]))

    def test_binomial_standard_gamma_stats(self):
        T.seed(0)
        n = 1_000_000
        s = T.binomial(t(np.full((n,), 10, np.int64)),
                       t(np.full((n,), 0.3, np.float32))).numpy()
        assert abs(s.mean() - 3.0) < 0.01 and abs(s.var() - 2.1) < 0.02
        g = T.standard_gamma(t(np.full((n,), 4.0, np.float32))).numpy()
        assert abs(g.mean() - 4.0) < 0.01 and abs(g.var() - 4.0) < 0.04
        T.seed(0)
        s2 = T.binomial(t(np.full((n,), 10, np.int64)),
                        t(np.full((n,), 0.3, np.float32))).numpy()
        np.testing.assert_array_equal(s, s2)

    def test_segment_reductions(self):
        data = np.random.RandomState(3).randn(7, 3).astype(np.float32)
        seg = np.array([0, 0, 2, 2, 2, 3, 3], np.int32)   # segment 1 empty
        for name in ("segment_sum", "segment_mean", "segment_max",
                     "segment_min"):
            out = both(lambda p: getattr(p, name)(p.to_tensor(data),
                                                  p.to_tensor(seg)))[0]
            assert out.shape == [4, 3]
            grads_agree(lambda p, d: getattr(p, name)(d, p.to_tensor(seg)),
                        data)

    def test_strided_slice_negative_stride(self):
        x = np.arange(30, dtype=np.float32).reshape(5, 6)
        both(lambda p: p.strided_slice(p.to_tensor(x), [0, 1], [4, -1],
                                       [0, 0], [-2, -2]))
        both(lambda p: p.strided_slice(p.to_tensor(x), [1], [1], [6], [2]))


# -- extras --------------------------------------------------------------------------

class TestExtras:
    def test_splits_and_stacks(self):
        x = np.arange(24, dtype=np.float32).reshape(4, 6)
        both(lambda p: p.tensor_split(p.to_tensor(x), 4, axis=1))
        both(lambda p: p.tensor_split(p.to_tensor(x), [1, 3], axis=0))
        both(lambda p: p.hsplit(p.to_tensor(x), 3))
        both(lambda p: p.dsplit(p.to_tensor(x.reshape(2, 2, 6)), [2]))
        both(lambda p: p.column_stack([p.to_tensor(x[0]),
                                       p.to_tensor(x[1])]))
        both(lambda p: p.dstack([p.to_tensor(x), p.to_tensor(x)]))
        both(lambda p: p.unflatten(p.to_tensor(x), 1, [2, -1]))

    @pytest.mark.parametrize("pnorm", [1.0, 2.0, 3.0])
    def test_cdist_pdist(self, pnorm):
        rng = np.random.RandomState(4)
        a, b = rng.randn(5, 3).astype(np.float32), \
            rng.randn(4, 3).astype(np.float32)
        both(lambda p: p.cdist(p.to_tensor(a), p.to_tensor(b), p=pnorm))
        grads_agree(lambda p, u, v: p.cdist(u, v, p=pnorm), a, b)
        both(lambda p: p.pdist(p.to_tensor(a), p=pnorm))
        if pnorm != 3.0:
            grads_agree(lambda p, u: p.pdist(u, p=pnorm), a)
            return
        # the reference differentiates its full [N, N] matrix, whose zero
        # diagonal gives 0 ** (1/p) a NaN gradient at p = 3 (ROADMAP §C);
        # the port's gradient is torch.pdist's
        x = T.to_tensor(a, stop_gradient=False)
        g = T.grad([T.pdist(x, p=pnorm).sum()], [x])[0].numpy()
        ta = torch.tensor(a, requires_grad=True)
        torch.nn.functional.pdist(ta, p=pnorm).sum().backward()
        close(g, ta.grad.numpy(), rtol=GRAD_RTOL)
        xj = J.to_tensor(a, stop_gradient=False)
        assert np.isnan(J.grad([J.pdist(xj, p=pnorm).sum()],
                               [xj])[0].numpy()).all()

    def test_histogramdd(self):
        x = np.random.RandomState(5).rand(40, 2).astype(np.float32)
        w = np.random.RandomState(6).rand(40).astype(np.float32)
        hist, edges = both(lambda p: p.histogramdd(
            p.to_tensor(x), bins=[3, 4], weights=p.to_tensor(w),
            density=True))
        ref, _ = np.histogramdd(x, bins=[3, 4], weights=w, density=True)
        np.testing.assert_allclose(hist.numpy(), ref, rtol=1e-5)

    def test_combinatorics(self):
        x = np.array([1.0, 2.0, 4.0, 8.0], np.float32)
        both(lambda p: p.combinations(p.to_tensor(x), r=3))
        both(lambda p: p.combinations(p.to_tensor(x), with_replacement=True))
        both(lambda p: p.cartesian_prod([p.to_tensor(x[:2]),
                                         p.to_tensor(x[1:])]))
        both(lambda p: p.vander(p.to_tensor(x), 3))
        both(lambda p: p.vander(p.to_tensor(x), increasing=True))
        both(lambda p: p.block_diag([p.to_tensor(np.ones((2, 2), np.float32)),
                                     p.to_tensor(x[:3])]))

    def test_integrals_and_norms(self):
        rng = np.random.RandomState(7)
        y = rng.randn(3, 6).astype(np.float32)
        # the reference reads x with y's rank: a full-shape x
        xs = np.cumsum(rng.rand(3, 6), axis=1).astype(np.float32)
        both(lambda p: p.trapezoid(p.to_tensor(y), x=p.to_tensor(xs)))
        both(lambda p: p.cumulative_trapezoid(p.to_tensor(y), dx=0.5))
        both(lambda p: p.cumulative_trapezoid(p.to_tensor(y),
                                              x=p.to_tensor(xs)))
        both(lambda p: p.renorm(p.to_tensor(y), 2.0, 0, 1.5))
        grads_agree(lambda p, v: p.renorm(v, 1.0, 1, 0.5), y)
        both(lambda p: p.aminmax(p.to_tensor(y), axis=1))
        both(lambda p: p.baddbmm(p.to_tensor(np.ones((1, 3, 3), np.float32)),
                                 p.to_tensor(y[None]),
                                 p.to_tensor(y.T[None]), beta=0.5,
                                 alpha=2.0))

    def test_scatters_and_complex(self):
        x = np.zeros((3, 4), np.float32)
        both(lambda p: p.diagonal_scatter(p.to_tensor(x),
                                          p.to_tensor(np.ones(3, np.float32)),
                                          offset=1))
        both(lambda p: p.select_scatter(p.to_tensor(x),
                                        p.to_tensor(np.ones(3, np.float32)),
                                        1, 2))
        r = np.array([1.0, 2.0], np.float32)
        a = np.array([0.5, -1.0], np.float32)
        both(lambda p: p.polar(p.to_tensor(r), p.to_tensor(a)))
        both(lambda p: p.view_as_real(p.view_as_complex(
            p.to_tensor(np.ones((2, 2), np.float32)))))
        assert T.is_complex(T.polar(t(r), t(a))) and \
            T.is_floating_point(t(r))
        both(lambda p: p.isin(p.to_tensor(np.arange(6)),
                              p.to_tensor(np.array([1, 4, 9])),
                              invert=True))


# -- sets ----------------------------------------------------------------------------

SETS = [("intersect1d", np.intersect1d), ("setdiff1d", np.setdiff1d),
        ("union1d", np.union1d), ("setxor1d", np.setxor1d)]


@pytest.mark.parametrize("name,oracle", SETS, ids=[s[0] for s in SETS])
@pytest.mark.parametrize("dtype", [np.int64, np.float32])
def test_set_ops_equal_numpy(name, oracle, dtype):
    rng = np.random.default_rng(8)
    a = rng.integers(0, 12, (3, 5)).astype(dtype)
    b = rng.integers(5, 20, 9).astype(dtype)
    out = both(lambda p: getattr(p, name)(p.to_tensor(a), p.to_tensor(b)))[0]
    np.testing.assert_array_equal(out.numpy(), oracle(a, b))
    assert out.place.is_cpu_place()


@pytest.mark.parametrize("name", ["intersect1d", "setdiff1d", "setxor1d"])
def test_set_ops_assume_unique(name):
    a = np.array([7, 3, 9, 1], np.int64)
    b = np.array([9, 4, 3], np.int64)
    out = getattr(T, name)(t(a), t(b), assume_unique=True).numpy()
    np.testing.assert_array_equal(out, getattr(np, name)(a, b,
                                                         assume_unique=True))


def test_in1d():
    a = np.arange(10).reshape(2, 5)
    for invert in (False, True):
        out = both(lambda p: p.in1d(p.to_tensor(a),
                                    p.to_tensor(np.array([2, 3, 8])),
                                    invert=invert))[0]
        np.testing.assert_array_equal(out.numpy(), np.isin(
            a.reshape(-1), [2, 3, 8], invert=invert))
    assert T.isin_1d is T.in1d


# -- array -----------------------------------------------------------------------------

def test_tensor_array():
    def body(p):
        arr = p.create_array("float32")
        for i in range(3):
            p.array_write(p.to_tensor(np.full((2, 3), i, np.float32)),
                          p.to_tensor(np.int64(i)), arr)
        assert int(p.array_length(arr).numpy()) == 3
        assert float(p.array_read(arr, 1).numpy()[0, 0]) == 1.0
        stacked, sizes = p.tensor_array_to_tensor(arr, axis=1,
                                                  use_stack=True)
        cat, csizes = p.tensor_array_to_tensor(arr, axis=1)
        return stacked, sizes, cat, csizes, p.lod_array_length(arr)
    both(body)


# -- tests/test_extended_ops.py: TestInplace ------------------------------------------

class TestInplace:
    def test_inplace_updates_and_grads_flow(self):
        a = np.array([0.2, 0.4, 0.6], np.float32)
        x = t(a.copy(), sg=False)
        x.multiply(t(np.float32(1.0)))
        before = id(x)
        out = T.tanh_(x)
        assert out is x and id(x) == before
        np.testing.assert_allclose(x.numpy(), np.tanh(a), atol=1e-6)

    def test_inplace_version_bumps(self):
        x = t(np.ones(3, np.float32))
        v0 = x.inplace_version
        T.log1p_(x)
        assert x.inplace_version > v0

    def test_fill_zero_diagonal(self):
        x = t(np.ones((3, 3), np.float32))
        T.zero_(x)
        np.testing.assert_array_equal(x.numpy(), np.zeros((3, 3)))
        T.fill_(x, 2.5)
        np.testing.assert_array_equal(x.numpy(), np.full((3, 3), 2.5))
        T.fill_diagonal_(x, -1.0)
        assert np.all(np.diag(x.numpy()) == -1.0)
        y = t(np.zeros((7, 3), np.float32))
        T.fill_diagonal_(y, 1.0, wrap=True)
        ref = np.zeros((7, 3), np.float32)
        np.fill_diagonal(ref, 1.0, wrap=True)
        np.testing.assert_array_equal(y.numpy(), ref)

    def test_surface_breadth(self):
        import paddle_tpu_torch.ops.inplace as ip
        assert len(ip.__all__) >= 55
        assert sorted(ip.__all__) == sorted(
            __import__("paddle_tpu.ops.inplace", fromlist=["x"]).__all__)

    def test_random_fills_moments_and_seed(self):
        n = 1_000_000
        T.seed(5)
        c = T.cauchy_(t(np.zeros(n, np.float32))).numpy()
        g = T.geometric_(t(np.zeros(n, np.float32)), 0.25).numpy()
        ln = T.log_normal_(t(np.zeros(n, np.float32)), 0.0, 0.5).numpy()
        assert abs(np.median(c)) < 0.01
        assert abs(np.mean(np.abs(c) < 1.0) - 0.5) < 0.003
        assert abs(g.mean() - 4.0) < 0.03 and g.min() >= 1
        assert abs(np.log(ln).mean()) < 0.002 and \
            abs(np.log(ln).std() - 0.5) < 0.002
        T.seed(5)
        np.testing.assert_array_equal(
            T.cauchy_(t(np.zeros(n, np.float32))).numpy(), c)


# -- tests/test_op_sweep.py: the in-place aliasing sweep -----------------------------

_RANDOM_BASES = {"bernoulli", "uniform", "normal", "exponential",
                 "log_normal", "cauchy", "geometric"}
_INT_OPS = {"bitwise_and", "bitwise_or", "bitwise_xor", "bitwise_not",
            "gcd", "lcm"}
_DOMAINS = {"log": (0.3, 3.0), "log2": (0.3, 3.0), "log10": (0.3, 3.0),
            "log1p": (-0.6, 3.0), "sqrt": (0.1, 4.0), "rsqrt": (0.1, 4.0),
            "asin": (-0.9, 0.9), "acos": (-0.9, 0.9), "atanh": (-0.9, 0.9),
            "acosh": (1.1, 3.0), "erfinv": (-0.9, 0.9), "logit": (0.1, 0.9),
            "lgamma": (0.2, 3.0), "gammaln": (0.2, 3.0),
            "digamma": (0.2, 3.0), "polygamma": (0.2, 3.0),
            "reciprocal": (0.3, 3.0), "divide": (0.3, 3.0),
            "floor_divide": (0.5, 4.0), "remainder": (0.5, 4.0),
            "mod": (0.5, 4.0), "pow": (0.3, 2.0), "igamma": (0.3, 3.0),
            "igammac": (0.3, 3.0), "xlogy": (0.3, 3.0),
            "true_divide": (0.3, 3.0), "trunc_divide": (0.3, 3.0),
            "cumprod": (0.3, 1.5)}


def _inplace_ops():
    return sorted(n for n, d in JR.items()
                  if isinstance(d.sweep, tuple) and d.sweep[0] == "inplace")


def _base_args(base, rng):
    bd = JR[base]
    if base == "ldexp":
        return [(rng.random((3, 4)) * 2 - 1).astype(np.float32),
                rng.integers(-2, 3, (3, 4)).astype(np.int32)], {}
    lo, hi = _DOMAINS.get(base, (-2.0, 2.0))
    if bd.category in ("unary", "binary"):
        n = 1 if bd.category == "unary" else 2
        if base in _INT_OPS:
            return [rng.integers(1, 8, (3, 4)).astype(np.int32)
                    for _ in range(n)], {}
        return [(rng.random((3, 4)) * (hi - lo) + lo).astype(np.float32)
                for _ in range(n)], {}
    args, kwargs, _ = bd.sweep(rng)[0]
    return list(args), dict(kwargs)


def _call_args(p, args):
    return [p.to_tensor(a) if isinstance(a, np.ndarray) else
            [p.to_tensor(x) for x in a] if isinstance(a, list) and a and
            isinstance(a[0], np.ndarray) else a for a in args]


@pytest.mark.parametrize("name", _inplace_ops())
def test_inplace_aliasing_sweep(name):
    if name == "where_":   # rebinds its second argument
        x = T.to_tensor(np.array([1.0, 2.0], np.float32))
        ret = T.where_(T.to_tensor(np.array([True, False])), x,
                       T.to_tensor(np.array([9.0, 9.0], np.float32)))
        assert ret is x
        np.testing.assert_allclose(x.numpy(), [1.0, 9.0])
        return
    base = JR[name].sweep[1]
    rng = np.random.default_rng(sum(map(ord, name)) % 2 ** 31)
    args, kwargs = _base_args(base, rng)
    if not isinstance(args[0], np.ndarray):
        pytest.skip(f"{name}: base spec's first arg is not an array")
    assert name in TR, name
    xt = _call_args(T, args)
    x_t = xt[0]
    before = x_t.numpy().copy()
    v0 = x_t.inplace_version
    ret = TR[name].public(x_t, *xt[1:], **kwargs) if TR[name].public \
        else getattr(T, name)(x_t, *xt[1:], **kwargs)
    assert ret is x_t, f"{name}: did not return the caller's tensor"
    assert x_t.inplace_version > v0
    if base in _RANDOM_BASES:
        assert not np.array_equal(x_t.numpy(), before) or name == \
            "bernoulli_"
        return
    # the value equals the port's base op and the reference's in-place op
    base_fn = getattr(T, base, None) or getattr(T.nn.functional, base)
    want = base_fn(*_call_args(T, args), **kwargs)
    want = want[0] if isinstance(want, (tuple, list)) else want
    close(x_t, want, what=name)
    xj = _call_args(J, args)
    getattr(J, name)(xj[0], *xj[1:], **kwargs)
    close(x_t, xj[0], what=f"{name} against JAX")


def test_inplace_family_is_swept():
    assert len(_inplace_ops()) >= 100, len(_inplace_ops())


# -- the registry sweep of this family's ops (_torch_sweep.py) -----------------

@pytest.mark.parametrize("name", shared_ops("extended"))
def test_registry_sweep(name):
    check_sweep(name)

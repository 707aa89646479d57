"""The rest of the port's linalg and quant op families and the
``paddle.linalg`` namespace (``paddle_tpu_torch/ops/linalg.py``,
``ops/quant.py``, ``linalg.py``) against the JAX package's on the same
numpy inputs, with ``tests/test_legacy_ops.py``'s ``TestQuantOps``
oracles.

Outputs agree within 1e-5 of the reference's max-abs (1e-4 for the
iterative routines: eigen- and singular-value solvers), gradients within
1e-4 of the largest. ``eig`` / ``eigvals`` are held by their invariants
(``A V = V diag(w)``, eigenvalues as a sorted multiset), ``lstsq`` on a
rank-deficient input, ``svd_lowrank`` by its reconstruction error.
"""

import numpy as np
import pytest

import paddle_tpu as J
import paddle_tpu.linalg  # noqa: F401
import paddle_tpu_torch as T
from _torch_sweep import check_sweep, shared_ops
import paddle_tpu_torch.linalg  # noqa: F401

FWD_RTOL = 1e-5
ITER_RTOL = 1e-4
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


def grads_agree(body, *arrays):
    def run(p):
        ts = [p.to_tensor(a, stop_gradient=False) for a in arrays]
        out = body(p, *ts)
        out = out[0] if isinstance(out, (tuple, list)) else out
        return [g.numpy() for g in p.grad([out.sum()], ts)]
    for gj, gt in zip(run(J), run(T)):
        close(gt, gj, rtol=GRAD_RTOL, what="grad")


def _mat(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _spd(n, seed):
    m = _mat((n, n), seed)
    return (m @ m.T + n * np.eye(n)).astype(np.float32)


# -- eig / eigvals by their invariants ---------------------------------------------

class TestEig:
    @pytest.mark.parametrize("shape", [(5, 5), (3, 4, 4)])
    def test_eigenpairs(self, shape):
        a = _mat(shape, 1)
        w, v = T.linalg.eig(T.to_tensor(a))
        w, v = w.numpy(), v.numpy()
        assert w.dtype == np.complex64 and v.dtype == np.complex64
        lhs, rhs = a.astype(np.complex128) @ v, v * w[..., None, :]
        close(lhs, rhs, rtol=ITER_RTOL, what="A V = V diag(w)")
        ref = np.linalg.eigvals(a.astype(np.float64))
        key = lambda z: np.sort_complex(np.round(z, 4))  # noqa: E731
        close(key(w), key(ref), rtol=ITER_RTOL, what="eigenvalues")
        wj = J.linalg.eig(J.to_tensor(a))[0].numpy()
        close(key(w), key(wj.astype(np.complex128)), rtol=ITER_RTOL)

    def test_eigvals(self):
        a = _mat((6, 6), 2)
        w = T.linalg.eigvals(T.to_tensor(a)).numpy()
        wj = J.linalg.eigvals(J.to_tensor(a)).numpy()
        close(np.sort_complex(w), np.sort_complex(wj.astype(np.complex64)),
              rtol=ITER_RTOL)

    def test_symmetric_family(self):
        s = _spd(4, 3)
        both(lambda p: p.linalg.eigvalsh(p.to_tensor(s)), rtol=ITER_RTOL)
        w, v = T.linalg.eigh(T.to_tensor(s))
        close(s @ v.numpy(), v.numpy() * w.numpy()[None], rtol=ITER_RTOL)
        grads_agree(lambda p, m: p.linalg.eigvalsh(m), s)


# -- lstsq: the reference's SVD contract, on any rank --------------------------------

class TestLstsq:
    def test_full_rank(self):
        a, b = _mat((6, 3), 4), _mat((6, 2), 5)
        sol, res, rank, sv = both(lambda p: p.linalg.lstsq(
            p.to_tensor(a), p.to_tensor(b)), rtol=ITER_RTOL)
        assert int(rank.numpy()) == 3
        np.testing.assert_allclose(sol.numpy(), np.linalg.lstsq(
            a, b, rcond=None)[0], rtol=1e-4, atol=1e-5)

    def test_rank_deficient(self):
        u, v = _mat((6, 2), 6), _mat((2, 4), 7)
        a = u @ v                                      # rank 2, 6 x 4
        b = _mat((6,), 8)
        sol, res, rank, sv = both(lambda p: p.linalg.lstsq(
            p.to_tensor(a), p.to_tensor(b)), rtol=ITER_RTOL)
        assert int(rank.numpy()) == 2
        # the minimum-norm solution: pinv(a) @ b
        np.testing.assert_allclose(sol.numpy(), np.linalg.pinv(
            a.astype(np.float64), rcond=1e-5) @ b, rtol=1e-3, atol=1e-4)
        close(res.numpy(), np.array([np.sum((a @ sol.numpy() - b) ** 2)]),
              rtol=1e-3)

    def test_rcond(self):
        a = np.diag([4.0, 1.0, 1e-3]).astype(np.float32)
        b = np.ones((3, 1), np.float32)
        for rcond in (None, 1e-2, -1.0):
            sol, _, rank, _ = both(lambda p: p.linalg.lstsq(
                p.to_tensor(a), p.to_tensor(b), rcond=rcond))
            assert int(rank.numpy()) == (2 if rcond == 1e-2 else 3)


# -- the randomized SVD -------------------------------------------------------------------

class TestSvdLowrank:
    def test_reconstruction(self):
        a = (_mat((20, 3), 9) @ _mat((3, 12), 10)).astype(np.float32)
        T.seed(1)
        u, s, v = T.linalg.svd_lowrank(T.to_tensor(a), q=3)
        rec = u.numpy() @ np.diag(s.numpy()) @ v.numpy().T
        assert np.abs(rec - a).max() <= 1e-4 * np.abs(a).max()
        np.testing.assert_allclose(
            s.numpy(), np.linalg.svd(a, compute_uv=False)[:3], rtol=1e-4)

    def test_seed_and_center(self):
        a = _mat((10, 6), 11)
        m = np.broadcast_to(a.mean(0), a.shape).astype(np.float32)
        T.seed(2)
        s1 = T.linalg.svd_lowrank(T.to_tensor(a), q=6,
                                  M=T.to_tensor(m))[1].numpy()
        T.seed(2)
        s2 = T.linalg.svd_lowrank(T.to_tensor(a), q=6,
                                  M=T.to_tensor(m))[1].numpy()
        np.testing.assert_array_equal(s1, s2)
        np.testing.assert_allclose(s1, np.linalg.svd(
            a - m, compute_uv=False), rtol=1e-4)


# -- decompositions and solvers against JAX -------------------------------------------

class TestDecompositions:
    def test_lu_family(self):
        a = _mat((4, 4), 12)
        lu, piv = both(lambda p: p.linalg.lu(p.to_tensor(a)))
        pm, lm, um = both(lambda p: p.linalg.lu_unpack(*p.linalg.lu(
            p.to_tensor(a))))
        close(pm.numpy() @ lm.numpy() @ um.numpy(), a, rtol=1e-5)
        b = _mat((4, 2), 13)
        for trans in (0, 1):
            both(lambda p: p.lu_solve(p.to_tensor(b), *p.linalg.lu(
                p.to_tensor(a)), trans=trans), rtol=ITER_RTOL)
        out = T.linalg.lu(T.to_tensor(a), get_infos=True)
        assert len(out) == 3 and out[2].numpy().tolist() == [0]

    @pytest.mark.parametrize("upper", [False, True])
    def test_cholesky_family(self, upper):
        s = _spd(4, 14)
        c = both(lambda p: p.linalg.cholesky(p.to_tensor(s), upper=upper))[0]
        b = _mat((4, 3), 15)
        both(lambda p: p.linalg.cholesky_solve(
            p.to_tensor(b), p.to_tensor(c.numpy()), upper=upper),
            rtol=ITER_RTOL)
        both(lambda p: p.cholesky_inverse(p.to_tensor(c.numpy()),
                                          upper=upper), rtol=ITER_RTOL)
        grads_agree(lambda p, m: p.linalg.cholesky(m, upper=upper), s)

    @pytest.mark.parametrize("upper,transpose,unit",
                             [(True, False, False), (False, True, False),
                              (True, True, True)])
    def test_triangular_solve(self, upper, transpose, unit):
        a = np.triu(_mat((4, 4), 16)) + 4 * np.eye(4, dtype=np.float32)
        a = a if upper else a.T.copy()
        b = _mat((4, 2), 17)
        both(lambda p: p.linalg.triangular_solve(
            p.to_tensor(a), p.to_tensor(b), upper=upper, transpose=transpose,
            unitriangular=unit), rtol=ITER_RTOL)
        grads_agree(lambda p, m, r: p.linalg.triangular_solve(
            m, r, upper=upper, transpose=transpose), a, b)

    @pytest.mark.parametrize("left,transpose", [(True, False), (True, True),
                                                (False, False),
                                                (False, True)])
    def test_householder_family(self, left, transpose):
        a = _mat((5, 3), 18)
        qa, tau = both(lambda p: p.geqrf(p.to_tensor(a)), rtol=ITER_RTOL)
        both(lambda p: p.linalg.householder_product(
            p.to_tensor(qa.numpy()), p.to_tensor(tau.numpy())))
        both(lambda p: p.orgqr(p.to_tensor(qa.numpy()),
                               p.to_tensor(tau.numpy())))
        c = _mat((5, 2) if left else (2, 5), 19)
        both(lambda p: p.linalg.ormqr(p.to_tensor(qa.numpy()),
                                      p.to_tensor(tau.numpy()),
                                      p.to_tensor(c), left=left,
                                      transpose=transpose))
        grads_agree(lambda p, h, tv, cv: p.linalg.ormqr(
            h, tv, cv, left=left, transpose=transpose), qa.numpy(),
            tau.numpy(), c)

    def test_qr_svd_modes(self):
        a = _mat((5, 3), 20)
        both(lambda p: p.linalg.qr(p.to_tensor(a), mode="complete"),
             rtol=ITER_RTOL)
        both(lambda p: p.linalg.svd(p.to_tensor(a), full_matrices=True),
             rtol=ITER_RTOL)
        both(lambda p: p.linalg.svdvals(p.to_tensor(a)), rtol=ITER_RTOL)
        grads_agree(lambda p, m: p.linalg.svdvals(m), a)
        # the reduced QR of a tall matrix: both packages' Householder
        # factors carry the same signs, so Q and R are compared as they are
        grads_agree(lambda p, m: p.linalg.qr(m)[0], a)
        grads_agree(lambda p, m: p.linalg.qr(m)[1], a)

    def test_matrix_functions(self):
        a = 0.3 * _mat((4, 4), 21)
        both(lambda p: p.linalg.matrix_exp(p.to_tensor(a)))
        grads_agree(lambda p, m: p.linalg.matrix_exp(m), a)
        for pn in (None, "fro", "nuc", 1, -1, 2, -2, np.inf):
            both(lambda p: p.linalg.cond(p.to_tensor(a + 2 * np.eye(
                4, dtype=np.float32)), p=pn), rtol=ITER_RTOL)
        both(lambda p: p.linalg.matrix_rank(p.to_tensor(a), tol=0.5))
        both(lambda p: p.linalg.matrix_power(p.to_tensor(a), -2),
             rtol=ITER_RTOL)
        both(lambda p: p.linalg.multi_dot([p.to_tensor(a)] * 3))
        both(lambda p: p.logdet(p.to_tensor(_spd(4, 22))))

    def test_tensor_maps_and_statistics(self):
        x = _mat((6, 2, 3), 23)
        both(lambda p: p.tensorinv(p.to_tensor(x), ind=1), rtol=ITER_RTOL)
        both(lambda p: p.tensorsolve(p.to_tensor(_mat((2, 3, 6), 24)),
                                     p.to_tensor(_mat((2, 3), 25))),
             rtol=ITER_RTOL)
        d = _mat((3, 8), 26)
        both(lambda p: p.linalg.cov(p.to_tensor(d), ddof=False))
        both(lambda p: p.linalg.cov(p.to_tensor(d.T), rowvar=False))
        both(lambda p: p.linalg.corrcoef(p.to_tensor(d)))
        grads_agree(lambda p, m: p.linalg.corrcoef(m), d)
        for pn in (0.5, 1, 2, np.inf):
            both(lambda p: p.linalg.vector_norm(p.to_tensor(d), p=pn,
                                                axis=1))
            both(lambda p: p.linalg.dist(p.to_tensor(d), p.to_tensor(
                d[::-1].copy()), p=pn))


# -- quant: tests/test_legacy_ops.py's TestQuantOps, and parity ----------------------

class TestQuantOps:
    def test_abs_max_roundtrip(self):
        w = _mat((8, 4), 27)
        q, s = both(lambda p: p.fake_quantize_abs_max(w))
        assert float(s.numpy()) == pytest.approx(np.abs(w).max(), rel=1e-6)
        assert np.abs(q.numpy()).max() <= 127
        dq, _ = both(lambda p: p.fake_quantize_dequantize_abs_max(w))
        assert np.abs(dq.numpy() - w).max() < np.abs(w).max() / 100

    def test_channel_wise(self):
        w = _mat((6, 3), 28)
        q, s = both(lambda p: p.fake_channel_wise_quantize_abs_max(
            w, quant_axis=1))
        np.testing.assert_allclose(s.numpy(), np.abs(w).max(0), rtol=1e-6)
        dq, _ = both(lambda p: p.fake_channel_wise_quantize_dequantize_abs_max(
            w, quant_axis=1))
        assert np.abs(dq.numpy() - w).max() < 0.02
        both(lambda p: p.fake_channel_wise_dequantize_max_abs(
            q.numpy(), [s.numpy(), np.float32(2.0)], quant_axis=1))

    def test_moving_average_state_is_pure(self):
        w = _mat((4, 4), 29)
        zero = np.zeros((), np.float32)
        q, scale, a1, s1 = both(
            lambda p: p.fake_quantize_moving_average_abs_max(w, zero, zero))
        assert float(s1.numpy()) == pytest.approx(1.0)
        assert float(a1.numpy()) == pytest.approx(np.abs(w).max(), rel=1e-6)
        out = both(lambda p: p.fake_quantize_moving_average_abs_max(
            w, a1.numpy(), s1.numpy()))
        assert float(out[3].numpy()) == pytest.approx(1.9)
        both(lambda p: p.fake_quantize_dequantize_moving_average_abs_max(
            w, a1.numpy(), s1.numpy(), is_test=True))
        both(lambda p: p.moving_average_abs_max_scale(w, a1.numpy(),
                                                      s1.numpy()))
        both(lambda p: p.fake_quantize_range_abs_max(
            w, np.float32(5.0), bit_length=4))

    def test_ste_gradient(self):
        x = T.to_tensor(_mat((4, 4), 30), stop_gradient=False)
        out, _ = T.fake_quantize_dequantize_abs_max(x)
        out.sum().backward()
        np.testing.assert_allclose(x.grad.numpy(), 1.0)
        grads_agree(lambda p, v: p.fake_quantize_dequantize_moving_average_abs_max(
            v, p.to_tensor(np.float32(1.0)), p.to_tensor(np.float32(1.0))),
            _mat((3, 5), 31))

    def test_quantize_dequantize_linear(self):
        w = _mat((8, 4), 32)
        q = both(lambda p: p.quantize_linear(w, np.float32(0.05)))[0]
        assert q.numpy().dtype == np.int32
        dq = both(lambda p: p.dequantize_linear(q.numpy(),
                                                np.float32(0.05)))[0]
        assert np.abs(dq.numpy() - w).max() <= 0.05 / 2 + 1e-6
        sc = np.array([0.02, 0.05, 0.1, 0.2], np.float32)
        zp = np.array([1, 0, -2, 3], np.float32)
        qc = both(lambda p: p.quantize_linear(w, sc, zp, quant_axis=1))[0]
        both(lambda p: p.dequantize_linear(qc.numpy(), sc, zp, quant_axis=1))
        both(lambda p: p.fake_dequantize_max_abs(qc.numpy(), np.float32(3.0)))

    def test_weight_only_and_llm_int8(self):
        w = _mat((16, 8), 33)
        x = _mat((3, 16), 34)
        x[:, 5] *= 20.0                          # an outlier column
        q, s = T.weight_quantize(T.to_tensor(w))
        ref = x @ w
        y = T.weight_only_linear(x, q, s).numpy()
        assert np.abs(y - ref).max() < 0.05 * np.abs(ref).max() + 0.05
        y2 = both(lambda p: p.llm_int8_linear(x, q.numpy(), s.numpy()))[0]
        assert np.abs(y2.numpy() - ref).max() < 0.1 * np.abs(ref).max() + 0.1
        grads_agree(lambda p, xv, sv: p.llm_int8_linear(
            xv, p.to_tensor(q.numpy()), sv), x, s.numpy())


# -- the namespaces ------------------------------------------------------------------------

@pytest.mark.parametrize("ns", ["linalg", "fft", "signal"])
def test_namespace_exports_the_reference_all(ns):
    import importlib
    ref = importlib.import_module(f"paddle_tpu.{ns}")
    port = getattr(T, ns)
    assert list(port.__all__) == list(ref.__all__)
    for n in port.__all__:
        assert callable(getattr(port, n)), n


# -- the registry sweep of this family's ops (_torch_sweep.py) -----------------

@pytest.mark.parametrize("name", shared_ops("linalg"))
def test_registry_sweep(name):
    check_sweep(name)

"""The port's legacy, sequence and decode op families
(``paddle_tpu_torch/ops/legacy.py``, ``sequence.py``, ``decode.py``)
against the JAX package's on the same numpy inputs, with the oracles of
``tests/test_legacy_ops.py`` (numpy, scipy, brute-force enumeration).

Float outputs agree within 1e-5 of the reference's max-abs, gradients
within 1e-4 of the largest; integer, index and path outputs exactly.
"""

import itertools

import numpy as np
import pytest

import paddle_tpu as J
import paddle_tpu_torch as T
from _torch_sweep import check_sweep, shared_ops

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
    """``body(paddle)`` on both packages; every returned leaf compared."""
    rj, rt = body(J), body(T)
    rj = rj if isinstance(rj, (tuple, list)) else [rj]
    rt = rt if isinstance(rt, (tuple, list)) else [rt]
    assert len(rj) == len(rt)
    for i, (a, b) in enumerate(zip(rj, rt)):
        close(b, a, what=f"leaf {i}")
    return rt


def grads_agree(body, *arrays):
    """The gradient of ``sum(body(paddle, *tensors))`` in every array,
    port against JAX."""
    def run(p):
        ts = [p.to_tensor(a, stop_gradient=False) for a in arrays]
        out = body(p, *ts)
        out = out[0] if isinstance(out, (tuple, list)) else out
        out.sum().backward()
        return [t.grad.numpy() for t in ts]
    for gj, gt in zip(run(J), run(T)):
        close(gt, gj, rtol=GRAD_RTOL, what="grad")


# -- tests/test_legacy_ops.py: TestSequenceOps ---------------------------------

class TestSequenceOps:
    def test_pad_unpad_roundtrip(self):
        flat = np.arange(12, dtype=np.float32).reshape(6, 2)
        lens = np.array([2, 4])
        padded, out_lens = both(lambda p: p.sequence_pad(flat, 0.0, 4, lens))
        assert padded.shape == [2, 4, 2]
        np.testing.assert_array_equal(padded.numpy()[1], flat[2:])
        back = both(lambda p: p.sequence_unpad(
            p.sequence_pad(flat, 0.0, 4, lens)[0], lens))[0]
        np.testing.assert_array_equal(back.numpy(), flat)

    def test_reverse(self):
        x = np.arange(8, dtype=np.float32).reshape(2, 4)
        out = both(lambda p: p.sequence_reverse(x, np.array([3, 4])))[0]
        np.testing.assert_array_equal(out.numpy(), [[2, 1, 0, 3],
                                                    [7, 6, 5, 4]])

    def test_softmax_masks_padding(self):
        x = np.random.RandomState(0).randn(2, 4).astype(np.float32)
        out = both(lambda p: p.sequence_softmax(x, np.array([2, 4])))[0]
        np.testing.assert_array_equal(out.numpy()[0, 2:], 0)
        grads_agree(lambda p, v: p.sequence_softmax(v, np.array([2, 4]))
                    * p.to_tensor(np.arange(8, dtype=np.float32)
                                  .reshape(2, 4)), x)

    @pytest.mark.parametrize("mode", ["sum", "mean", "sqrt", "max", "min",
                                      "first", "last"])
    def test_pool_modes(self, mode):
        x = np.random.RandomState(1).randn(3, 4, 2).astype(np.float32)
        lens = np.array([2, 4, 0])
        out = both(lambda p: p.sequence_pool(x, mode, lens, pad_value=-7.0))
        np.testing.assert_array_equal(out[0].numpy()[2], -7.0)
        grads_agree(lambda p, v: p.sequence_pool(v, mode, lens), x)

    def test_erase(self):
        x = np.array([[1, 2, 3, 2], [2, 2, 2, 4]])
        out, lens = both(lambda p: p.sequence_erase(x, [2],
                                                    np.array([4, 4])))
        np.testing.assert_array_equal(out.numpy(), [[1, 3, 0, 0],
                                                    [4, 0, 0, 0]])
        assert lens.numpy().tolist() == [2, 1]

    def test_expand_and_expand_as(self):
        x = np.array([[1.0], [2.0]], np.float32)
        out, _ = both(lambda p: p.sequence_expand(x, np.array([2, 3])))
        np.testing.assert_array_equal(out.numpy()[0, :, 0], [1, 1, 0])
        out2 = both(lambda p: p.sequence_expand_as(
            x, np.zeros((2, 5, 1), np.float32)))[0]
        assert out2.shape == [2, 5, 1]

    def test_slice_concat_scatter(self):
        x = np.arange(12, dtype=np.float32).reshape(2, 6)
        out, _ = both(lambda p: p.sequence_slice(x, np.array([1, 2]),
                                                 np.array([2, 3])))
        np.testing.assert_array_equal(out.numpy()[1], [8, 9, 10, 0, 0, 0])
        a = np.ones((2, 2), np.float32)
        b = 2 * np.ones((2, 3), np.float32)
        cat, cl = both(lambda p: p.sequence_concat(
            [a, b], [np.array([1, 2]), np.array([3, 1])]))
        np.testing.assert_array_equal(cat.numpy(), [[1, 2, 2, 2, 0],
                                                    [1, 1, 2, 0, 0]])
        assert cl.numpy().tolist() == [4, 3]
        s = both(lambda p: p.sequence_scatter(
            np.zeros((2, 4), np.float32), np.array([[1], [2]]),
            np.array([[5.0], [7.0]], np.float32)))[0]
        assert s.numpy()[0, 1] == 5 and s.numpy()[1, 2] == 7

    def test_enumerate_reshape_lod_reset(self):
        x = np.array([[1, 2, 3, 4]])
        win = both(lambda p: p.sequence_enumerate(x, 2, pad_value=0))[0]
        np.testing.assert_array_equal(win.numpy()[0, 3], [4, 0])
        r, rl = both(lambda p: p.sequence_reshape(
            np.arange(8, dtype=np.float32).reshape(1, 2, 4), 2,
            np.array([2])))
        assert r.shape == [1, 4, 2] and rl.numpy().tolist() == [4]
        both(lambda p: p.lod_reset(x, np.array([2])))

    def test_sequence_conv_matches_manual(self):
        rng = np.random.RandomState(2)
        x = rng.randn(1, 5, 3).astype(np.float32)
        w = rng.randn(9, 4).astype(np.float32)
        out = both(lambda p: p.sequence_conv(x, w, 3, context_start=-1,
                                             seq_lens=np.array([5])))[0]
        padded = np.concatenate([np.zeros((1, 1, 3)), x,
                                 np.zeros((1, 1, 3))], 1)
        win = np.stack([padded[:, i:i + 5] for i in range(3)], 2)
        np.testing.assert_allclose(out.numpy(), win.reshape(1, 5, 9) @ w,
                                   rtol=1e-5, atol=1e-5)
        grads_agree(lambda p, v, wv: p.sequence_conv(
            v, wv, 3, seq_lens=np.array([4])), x, w)

    def test_row_conv(self):
        rng = np.random.RandomState(3)
        x = rng.randn(2, 4, 2).astype(np.float32)
        w = rng.randn(2, 2).astype(np.float32)
        out = both(lambda p: p.row_conv(x, w))[0]
        ref = np.zeros_like(x)
        for t in range(4):
            for k in range(2):
                if t + k < 4:
                    ref[:, t] += x[:, t + k] * w[k]
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)
        grads_agree(lambda p, v, wv: p.row_conv(v, wv, np.array([3, 4])),
                    x, w)

    def test_im2sequence(self):
        x = np.random.RandomState(4).randn(1, 2, 4, 4).astype(np.float32)
        out = both(lambda p: p.im2sequence(x, 2, stride=2))[0]
        assert out.shape == [1, 4, 8]


# -- TestDecodeOps ------------------------------------------------------------------

class TestDecodeOps:
    def test_edit_distance_oracle(self):
        d, n = both(lambda p: p.edit_distance(
            np.array([[1, 2, 3]]), np.array([[1, 3, 3]]), normalized=False))
        assert d.numpy().tolist() == [1.0]
        d2, _ = both(lambda p: p.edit_distance(
            np.array([[1, 2, 3, 4]]), np.array([[2, 3]]), normalized=False))
        assert d2.numpy().tolist() == [2.0]

    def test_edit_distance_lengths_against_dp(self):
        rng = np.random.default_rng(5)
        a = rng.integers(0, 4, (6, 7))
        b = rng.integers(0, 4, (6, 5))
        la, lb = rng.integers(0, 8, 6), rng.integers(1, 6, 6)
        d, _ = both(lambda p: p.edit_distance(a, b, la, lb,
                                              normalized=True))

        def lev(s, t):
            dp = np.arange(len(t) + 1, dtype=float)
            for i, c in enumerate(s, 1):
                prev, dp[0] = dp.copy(), i
                for j, e in enumerate(t, 1):
                    dp[j] = min(prev[j] + 1, dp[j - 1] + 1,
                                prev[j - 1] + (c != e))
            return dp[-1]
        want = [lev(a[r, :la[r]], b[r, :lb[r]]) / lb[r] for r in range(6)]
        np.testing.assert_allclose(d.numpy(), want, rtol=1e-6)

    def test_ctc_align_and_greedy(self):
        out, lens = both(lambda p: p.ctc_align(
            np.array([[0, 1, 1, 0, 2, 2, 0]]), blank=0, padding_value=-1))
        np.testing.assert_array_equal(out.numpy()[0], [1, 2, -1, -1, -1,
                                                       -1, -1])
        assert lens.numpy().tolist() == [2]
        logits = np.zeros((1, 4, 3), np.float32)
        logits[0, :, 0] = -10
        logits[0, 0, 1] = logits[0, 1, 1] = 5
        logits[0, 2, 2] = logits[0, 3, 2] = 5
        o, _ = both(lambda p: p.ctc_greedy_decoder(logits, blank=0))
        np.testing.assert_array_equal(o.numpy()[0][:2], [1, 2])

    def test_crf_vs_brute_force(self):
        rng = np.random.default_rng(0)
        K, S = 3, 4
        em = rng.standard_normal((1, S, K)).astype(np.float32)
        tr = rng.standard_normal((K + 2, K)).astype(np.float32)
        path = both(lambda p: p.crf_decoding(em, tr))[0].numpy()[0]
        scores = {}
        for q in itertools.product(range(K), repeat=S):
            scores[q] = (tr[0, q[0]] + tr[1, q[-1]]
                         + sum(em[0, t, q[t]] for t in range(S))
                         + sum(tr[2 + q[t], q[t + 1]] for t in range(S - 1)))
        best = max(scores, key=scores.get)
        assert path.tolist() == list(best)
        nll = both(lambda p: p.linear_chain_crf(
            em, tr, np.array([list(best)])))[0]
        alls = np.array(list(scores.values()), np.float64)
        log_z = np.log(np.exp(alls - alls.max()).sum()) + alls.max()
        assert float(nll.numpy()[0]) == pytest.approx(
            log_z - scores[best], abs=1e-4)

    def test_crf_with_lengths_and_gradients(self):
        rng = np.random.default_rng(6)
        B, S, K = 4, 6, 5
        em = rng.standard_normal((B, S, K)).astype(np.float32)
        tr = rng.standard_normal((K + 2, K)).astype(np.float32)
        lab = rng.integers(0, K, (B, S))
        lens = np.array([6, 3, 1, 5])
        both(lambda p: p.linear_chain_crf(em, tr, lab, lens))
        paths = both(lambda p: p.crf_decoding(em, tr, lens))[0].numpy()
        assert (paths[1, 3:] == 0).all()
        grads_agree(lambda p, e, t: p.linear_chain_crf(e, t, lab, lens),
                    em, tr)

    def test_beam_search_and_gather_tree(self):
        pre_ids = np.array([[1, 2]])
        pre_sc = np.array([[0.0, -1.0]], np.float32)
        sc = np.log(np.array([[[0.05, 0.9, 0.05],
                               [0.3, 0.3, 0.4]]], np.float32))
        tok, top, par = both(lambda p: p.beam_search(
            pre_ids, pre_sc, None, sc, 2, end_id=2))
        assert tok.numpy()[0].tolist() == [1, 2]
        assert par.numpy()[0].tolist() == [0, 1]
        ids = np.array([[[1, 2]], [[3, 4]]])
        parents = np.array([[[0, 0]], [[1, 0]]])
        full = both(lambda p: p.gather_tree(ids, parents))[0]
        assert full.numpy()[:, 0, :].tolist() == [[2, 1], [3, 4]]
        seqs, lens = both(lambda p: p.beam_search_decode(ids, parents,
                                                         end_id=2))
        assert lens.numpy().tolist() == [[1, 2]]

    def test_warpctc(self):
        rng = np.random.default_rng(7)
        logits = rng.standard_normal((6, 2, 4)).astype(np.float32)
        lab = np.array([[1, 2, 0], [3, 3, 1]])
        args = (lab, np.array([6, 5]), np.array([2, 3]))
        both(lambda p: p.warpctc(logits, *args, norm_by_times=True))
        grads_agree(lambda p, lg: p.warpctc(lg, *args), logits)


# -- TestLegacySingles -----------------------------------------------------------------

class TestLegacySingles:
    def test_space_depth_roundtrip(self):
        x = np.arange(32, dtype=np.float32).reshape(1, 2, 4, 4)
        rt = both(lambda p: p.depth_to_space(p.space_to_depth(x, 2), 2))[0]
        np.testing.assert_array_equal(rt.numpy(), x)

    def test_nonzero_static(self):
        out = both(lambda p: p.nonzero_static(
            np.array([[0, 5], [3, 0]], np.float32), size=3))[0]
        assert out.numpy().tolist() == [[0, 1], [1, 0], [-1, -1]]

    def test_exprel_vs_scipy(self):
        import scipy.special as sp
        x = np.array([0.0, 0.5, -1.0, 3.0], np.float32)
        out = both(lambda p: p.exprel(x))[0]
        np.testing.assert_allclose(out.numpy(), sp.exprel(x), rtol=1e-5)

    def test_multigammaln_vs_scipy(self):
        import scipy.special as sp
        out = both(lambda p: p.multigammaln(np.array([3.0], np.float32),
                                            2))[0]
        np.testing.assert_allclose(out.numpy(), sp.multigammaln(3.0, 2),
                                   rtol=1e-4)

    def test_bilinear_tensor_product(self):
        rng = np.random.RandomState(8)
        x, y = rng.randn(2, 3).astype(np.float32), \
            rng.randn(2, 4).astype(np.float32)
        w = rng.randn(5, 3, 4).astype(np.float32)
        out = both(lambda p: p.bilinear_tensor_product(x, y, w))[0]
        np.testing.assert_allclose(out.numpy(),
                                   np.einsum("bi,kij,bj->bk", x, w, y),
                                   rtol=1e-4, atol=1e-5)
        grads_agree(lambda p, a, b, c: p.bilinear_tensor_product(a, b, c),
                    x, y, w)

    def test_fill_diagonal_tensor_and_inplace(self):
        fd = both(lambda p: p.fill_diagonal_tensor(
            np.zeros((3, 4), np.float32), np.array([1., 2., 3.], np.float32),
            offset=1))[0]
        np.testing.assert_array_equal(np.diagonal(fd.numpy(), 1), [1, 2, 3])
        t = T.to_tensor(np.zeros((3, 3), np.float32))
        out = t.fill_diagonal_tensor_(
            T.to_tensor(np.array([1., 2., 3.], np.float32)))
        assert out is t
        np.testing.assert_array_equal(t.numpy().diagonal(), [1, 2, 3])

    def test_sequence_topk_and_batch_fc(self):
        tk = both(lambda p: p.sequence_topk_avg_pooling(
            np.array([[4., 1., 3., 2.]], np.float32), [1, 3]))[0]
        np.testing.assert_allclose(tk.numpy()[0], [4.0, 3.0], rtol=1e-6)
        bf = both(lambda p: p.batch_fc(np.ones((2, 3, 4), np.float32),
                                       np.ones((2, 4, 5), np.float32)))[0]
        assert float(bf.numpy()[0, 0, 0]) == 4.0

    def test_chunk_eval_perfect_and_partial(self):
        out = both(lambda p: p.chunk_eval(np.array([0, 1, 1, 2]),
                                          np.array([0, 1, 1, 2]),
                                          num_chunk_types=2))
        assert float(out[2].numpy()) == 1.0
        out2 = both(lambda p: p.chunk_eval(np.array([0, 1, 0, 1]),
                                           np.array([0, 1, 1, 1]),
                                           num_chunk_types=1))
        assert float(out2[0].numpy()) < 1.0

    def test_chunk_eval_batch_with_lengths(self):
        rng = np.random.default_rng(9)
        pred = rng.integers(0, 7, (5, 12))
        lab = rng.integers(0, 7, (5, 12))
        both(lambda p: p.chunk_eval(pred, lab, num_chunk_types=3,
                                    seq_lens=np.array([12, 7, 3, 9, 1])))

    def test_random_ops_draw_from_the_port_generator(self):
        x = np.random.RandomState(10).rand(64, 6).astype(np.float32) + 0.1
        T.seed(3)
        a = [T.shuffle_batch(x)[1].numpy(), T.sampling_id(x).numpy(),
             T.pca_lowrank(x, q=3)[1].numpy()]
        T.seed(3)
        b = [T.shuffle_batch(x)[1].numpy(), T.sampling_id(x).numpy(),
             T.pca_lowrank(x, q=3)[1].numpy()]
        for u, v in zip(a, b):
            np.testing.assert_array_equal(u, v)
        assert sorted(a[0].tolist()) == list(range(64))
        # pca_lowrank at full rank recovers the centred matrix's spectrum
        s = np.linalg.svd(x - x.mean(0), compute_uv=False)
        u, sv, v = T.pca_lowrank(x, q=6, niter=4)
        np.testing.assert_allclose(sv.numpy(), s, rtol=1e-4)

    def test_sampling_id_moments(self):
        probs = np.tile(np.array([[0.1, 0.2, 0.3, 0.4]], np.float32),
                        (200000, 1))
        T.seed(4)
        ids = T.sampling_id(probs).numpy()
        freq = np.bincount(ids, minlength=4) / ids.size
        np.testing.assert_allclose(freq, [0.1, 0.2, 0.3, 0.4], atol=4e-3)


# -- the registry sweep of this family's ops (_torch_sweep.py) -----------------

@pytest.mark.parametrize("name", shared_ops("legacy"))
def test_registry_sweep(name):
    check_sweep(name)

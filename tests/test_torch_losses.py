"""The port's losses (``paddle_tpu_torch/nn/functional/loss.py``) and loss
layers (``nn/layers/loss.py``) against the JAX package's on the same
numpy inputs.

Forward fp32 within 1e-5 x max|ref|, gradients within 1e-4 x max|g|
(``_torch_sweep.close``); integer outputs exactly. ``nll_loss`` over
``[N, C, d]``, which the reference cannot take, is held to
``torch.nn.functional.nll_loss``; ``class_center_sample``, which draws
from the port's generator where the reference draws from numpy's, is
held by its properties.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as J
import paddle_tpu.nn.functional as JF
import paddle_tpu_torch as T
import paddle_tpu_torch.nn.functional as TF
from _torch_sweep import _leaves, check_sweep, close, shared_ops

GRAD_RTOL = 1e-4


@pytest.fixture(autouse=True)
def _port_on_cpu():
    prev = T.get_device()
    T.set_device("cpu")
    yield
    T.set_device(prev)


def _arrays(seed, *specs):
    """Seeded inputs: ("f", shape) normal floats, ("p", shape) in (0, 1),
    ("s", shape) signs, ("b", shape) 0/1 floats, ("i", shape, n) ints."""
    rng = np.random.default_rng(seed)
    out = []
    for s in specs:
        kind, shape = s[0], s[1]
        if kind == "f":
            out.append(rng.standard_normal(shape).astype(np.float32))
        elif kind == "p":
            out.append(rng.uniform(0.05, 0.95, shape).astype(np.float32))
        elif kind == "s":
            out.append((rng.integers(0, 2, shape) * 2 - 1).astype(np.float32))
        elif kind == "b":
            out.append(rng.integers(0, 2, shape).astype(np.float32))
        else:
            out.append(rng.integers(0, s[2], shape).astype(np.int64))
    return out


def _run(p, fn, arrays, kw, grad):
    ts = [p.to_tensor(a, stop_gradient=not (grad and a.dtype.kind == "f"))
          for a in arrays]
    out = fn(p)(*ts, **kw)
    outs = _leaves(out)
    gs = []
    if grad:
        first = out[0] if isinstance(out, (tuple, list)) else out
        wrt = [t for t in ts if not t.stop_gradient]
        gs = [np.zeros(t.shape, np.float32) if g is None else g.numpy()
              for g, t in zip(p.grad([first.sum()], wrt, allow_unused=True),
                              wrt)]
    return outs, gs


def agree(fn, arrays, kw=None, grad=True, rtol=1e-5):
    """``fn(paddle)(*tensors, **kw)`` through both packages: every output
    leaf, and the gradient of the first output's sum in every float
    input."""
    kw = kw or {}
    (oj, gj), (ot, gt) = (_run(p, fn, arrays, kw, grad) for p in (J, T))
    assert len(oj) == len(ot)
    for a, b in zip(ot, oj):
        close(a, b, rtol=rtol)
    for a, b in zip(gt, gj):
        close(a, b, rtol=GRAD_RTOL, floor=1e-2)
    return ot


# -- every loss with each reduction and option -----------------------------------

F = lambda name: (lambda p: getattr(p.nn.functional, name))  # noqa: E731

CASES = [
    ("nll_loss", [("f", (6, 5)), ("i", (6,), 5)], {}),
    ("nll_loss", [("f", (6, 5)), ("i", (6,), 5), ("p", (5,))],
     {"reduction": "sum"}),
    ("nll_loss", [("f", (6, 5)), ("i", (6,), 5)],
     {"reduction": "none", "ignore_index": 2}),
    ("l1_loss", [("f", (3, 4)), ("f", (3, 4))], {"reduction": "none"}),
    ("smooth_l1_loss", [("f", (3, 4)), ("f", (3, 4))], {"delta": 0.5}),
    ("binary_cross_entropy", [("p", (3, 4)), ("b", (3, 4)), ("p", (3, 4))],
     {}),
    ("binary_cross_entropy", [("p", (3, 4)), ("b", (3, 4))],
     {"reduction": "none"}),
    ("binary_cross_entropy_with_logits", [("f", (3, 4)), ("b", (3, 4))],
     {"reduction": "sum"}),
    ("kl_div", [("f", (3, 4)), ("p", (3, 4))], {"reduction": "batchmean"}),
    ("kl_div", [("f", (3, 4)), ("f", (3, 4))], {"log_target": True}),
    ("margin_ranking_loss", [("f", (6,)), ("f", (6,)), ("s", (6,))],
     {"margin": 0.3}),
    ("hinge_embedding_loss", [("f", (6,)), ("s", (6,))],
     {"margin": 0.5, "reduction": "none"}),
    ("cosine_embedding_loss", [("f", (4, 5)), ("f", (4, 5)), ("s", (4,))],
     {"margin": 0.2}),
    ("triplet_margin_loss", [("f", (4, 5)), ("f", (4, 5)), ("f", (4, 5))],
     {"p": 1.0, "swap": True}),
    ("log_loss", [("p", (5, 1)), ("b", (5, 1))], {}),
    ("sigmoid_focal_loss", [("f", (4, 3)), ("b", (4, 3)), ("p", (1,))],
     {"gamma": 1.5, "reduction": "mean"}),
    ("huber_loss", [("f", (3, 4)), ("f", (3, 4))], {"delta": 0.7}),
    ("soft_margin_loss", [("f", (3, 4)), ("s", (3, 4))], {"reduction": "sum"}),
    ("multi_label_soft_margin_loss", [("f", (3, 4)), ("b", (3, 4)),
                                      ("p", (4,))], {}),
    ("poisson_nll_loss", [("p", (3, 4)), ("p", (3, 4))],
     {"log_input": False, "full": True}),
    ("gaussian_nll_loss", [("f", (3, 4)), ("f", (3, 4)), ("p", (3, 4))],
     {"full": True, "reduction": "sum"}),
    ("multi_margin_loss", [("f", (4, 5)), ("i", (4,), 5)],
     {"p": 2, "margin": 0.5}),
    ("margin_cross_entropy", [("p", (4, 6)), ("i", (4,), 6)],
     {"margin2": 0.3, "scale": 8.0, "return_softmax": True}),
    ("npair_loss", [("f", (4, 8)), ("f", (4, 8)), ("i", (4,), 2)], {}),
    ("center_loss", [("f", (5, 3)), ("i", (5,), 4), ("f", (4, 3))],
     {"alpha": 0.3}),
    ("center_loss", [("f", (5, 3)), ("i", (5,), 4), ("f", (4, 3))],
     {"update_center": False}),
    ("rank_loss", [("b", (5,)), ("f", (5,)), ("f", (5,))], {}),
    ("teacher_student_sigmoid_loss", [("f", (6,)), ("p", (6,))], {}),
    ("bpr_loss", [("f", (3, 5)), ("i", (3,), 5)], {}),
    ("cos_sim", [("f", (3, 4)), ("f", (1, 4))], {}),
    ("modified_huber_loss", [("f", (6,)), ("b", (6,))], {}),
    ("identity_loss", [("f", (3, 4))], {"reduction": 1}),
    ("square_error_cost", [("f", (3, 4)), ("f", (3, 4))], {}),
    ("dice_loss", [("p", (2, 4, 3)), ("i", (2, 4, 1), 3)], {}),
    ("softmax_with_cross_entropy", [("f", (4, 5)), ("i", (4, 1), 5)],
     {"return_softmax": True}),
    ("triplet_margin_with_distance_loss",
     [("f", (4, 5)), ("f", (4, 5)), ("f", (4, 5))], {"swap": True}),
]


@pytest.mark.parametrize("name,specs,kw", CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CASES)])
def test_loss_matches_jax(name, specs, kw):
    agree(F(name), _arrays(sum(map(ord, name)), *specs), kw)


def test_weighted_losses_match_jax():
    """The weight arguments that follow an option in the signature."""
    x, y, w, pw = _arrays(14, ("f", (3, 4)), ("b", (3, 4)), ("p", (3, 4)),
                          ("p", (4,)))
    agree(lambda p: lambda a, b, c, d: p.nn.functional.
          binary_cross_entropy_with_logits(a, b, weight=c, pos_weight=d),
          [x, y, w, pw])
    x, y, w = _arrays(15, ("f", (4, 5)), ("i", (4,), 5), ("p", (5,)))
    agree(lambda p: lambda a, b, c: p.nn.functional.multi_margin_loss(
        a, b, p=1, margin=0.7, weight=c, reduction="sum"), [x, y, w])


def test_distance_function_is_called_on_tensors():
    arrays = _arrays(3, ("f", (4, 5)), ("f", (4, 5)), ("f", (4, 5)))

    def fn(p):
        def dist(a, b):
            return p.sum(p.abs(a - b), axis=-1)
        return lambda *t: p.nn.functional.triplet_margin_with_distance_loss(
            *t, distance_function=dist, swap=True, margin=2.0)
    agree(fn, arrays)


# -- the returned structures -------------------------------------------------------

def test_center_loss_and_margin_ce_return_the_reference_tuples():
    x, y, c = _arrays(4, ("f", (5, 3)), ("i", (5,), 4), ("f", (4, 3)))
    out = T.nn.functional.center_loss(T.to_tensor(x), T.to_tensor(y),
                                      T.to_tensor(c))
    assert isinstance(out, tuple) and len(out) == 2
    assert tuple(out[0].shape) == (5,) and tuple(out[1].shape) == (4, 3)
    lg, lab = _arrays(5, ("p", (4, 6)), ("i", (4,), 6))
    single = T.nn.functional.margin_cross_entropy(T.to_tensor(lg),
                                                  T.to_tensor(lab))
    assert isinstance(single, T.Tensor) and single.shape == []
    pair = T.nn.functional.margin_cross_entropy(
        T.to_tensor(lg), T.to_tensor(lab), return_softmax=True,
        reduction="none")
    assert len(pair) == 2 and tuple(pair[1].shape) == (4, 6)
    o, loss = T.nn.functional.adaptive_log_softmax_with_loss(
        *[T.to_tensor(a) for a in _arrays(6, ("f", (4, 8)), ("i", (4,), 5),
                                          ("f", (8, 3)))],
        [(T.to_tensor(np.ones((8, 4), np.float32)),
          T.to_tensor(np.ones((4, 3), np.float32)))], [2, 5])
    assert tuple(o.shape) == (4,) and loss.shape == []


# -- rnnt_loss: the lattice ---------------------------------------------------------

@pytest.mark.parametrize("fastemit", [0.0, 0.01])
def test_rnnt_loss_matches_jax(fastemit):
    rng = np.random.default_rng(7)
    B, Tn, U, K = 3, 6, 4, 5
    logits = rng.standard_normal((B, Tn, U + 1, K)).astype(np.float32)
    labels = rng.integers(1, K, (B, U)).astype(np.int64)
    t_len = np.array([6, 4, 5], np.int64)
    u_len = np.array([4, 2, 0], np.int64)
    for red in ("none", "mean", "sum"):
        agree(F("rnnt_loss"), [logits, labels, t_len, u_len],
              {"reduction": red, "fastemit_lambda": fastemit})


def test_rnnt_loss_equals_a_direct_lattice_walk():
    """The in-row logcumsumexp against the per-cell recursion in float64
    (warp-rnnt's definition)."""
    rng = np.random.default_rng(8)
    B, Tn, U, K = 2, 5, 3, 4
    logits = rng.standard_normal((B, Tn, U + 1, K))
    labels = rng.integers(1, K, (B, U))
    t_len, u_len = np.array([5, 3]), np.array([3, 2])
    lp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    want = []
    for b in range(B):
        a = np.full((Tn, U + 1), -np.inf)
        a[0, 0] = 0.0
        for t in range(t_len[b]):
            for u in range(u_len[b] + 1):
                if t == 0 and u == 0:
                    continue
                terms = []
                if t > 0:
                    terms.append(a[t - 1, u] + lp[b, t - 1, u, 0])
                if u > 0:
                    terms.append(a[t, u - 1] + lp[b, t, u - 1, labels[b, u - 1]])
                a[t, u] = np.logaddexp.reduce(terms)
        tl, ul = t_len[b] - 1, u_len[b]
        want.append(-(a[tl, ul] + lp[b, tl, ul, 0]))
    got = T.nn.functional.rnnt_loss(
        T.to_tensor(logits.astype(np.float32)), T.to_tensor(labels),
        T.to_tensor(t_len), T.to_tensor(u_len), reduction="none").numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)


# -- hsigmoid_loss ------------------------------------------------------------------

def test_hsigmoid_custom_tree_matches_jax():
    rng = np.random.default_rng(9)
    x = rng.standard_normal((4, 6)).astype(np.float32)
    lab = rng.integers(0, 5, 4).astype(np.int64)
    w = rng.standard_normal((4, 6)).astype(np.float32)
    b = rng.standard_normal((4,)).astype(np.float32)
    table = np.array([[0, 1, -1], [0, 2, 3], [0, 1, 2], [0, 3, -1]], np.int64)
    code = rng.integers(0, 2, (4, 3)).astype(np.int64)

    def fn(p):
        return lambda xx, ll, ww, bb, tt, cc: p.nn.functional.hsigmoid_loss(
            xx, ll, 5, ww, bb, path_table=tt, path_code=cc)
    agree(fn, [x, lab, w, b, table, code])

    def default_tree(p):
        return lambda xx, ll, ww, bb: p.nn.functional.hsigmoid_loss(
            xx, ll, 5, ww, bb)
    agree(default_tree, [x, lab, w, b])


# -- Paddle's contract beyond the reference ---------------------------------------

def test_nll_loss_over_spatial_axes_as_torch():
    rng = np.random.default_rng(10)
    x = torch.from_numpy(rng.standard_normal((2, 4, 3, 3)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 4, (2, 3, 3)))
    w = torch.rand(4)
    for red in ("none", "mean", "sum"):
        got = TF.nll_loss(T.to_tensor(x), T.to_tensor(y), T.to_tensor(w),
                          reduction=red, ignore_index=1).numpy()
        want = torch.nn.functional.nll_loss(x, y, w, ignore_index=1,
                                            reduction=red).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_class_center_sample_properties():
    T.seed(11)
    lab = np.array([3, 7, 3, 0, 9, 7], np.int64)
    remapped, centers = TF.class_center_sample(T.to_tensor(lab), 20, 8)
    centers, remapped = centers.numpy(), remapped.numpy()
    assert centers.shape == (8,) and len(set(centers.tolist())) == 8
    assert centers[:4].tolist() == [0, 3, 7, 9]          # positives first
    assert set(centers.tolist()) <= set(range(20))
    np.testing.assert_array_equal(centers[remapped], lab)
    T.seed(11)
    again = TF.class_center_sample(T.to_tensor(lab), 20, 8)[1].numpy()
    np.testing.assert_array_equal(again, centers)         # same seed, same draw
    # more positives than samples: every positive, nothing else
    _, all_pos = TF.class_center_sample(T.to_tensor(lab), 20, 2)
    assert all_pos.numpy().tolist() == [0, 3, 7, 9]
    # the reference's contract, on the same labels
    jr, jc = JF.class_center_sample(J.to_tensor(lab), 20, 8)
    np.testing.assert_array_equal(jc.numpy()[jr.numpy()], lab)
    assert sorted(jc.numpy()[:4].tolist()) == [0, 3, 7, 9]


# -- the loss layers -------------------------------------------------------------

LAYERS = [
    ("L1Loss", {}, [("f", (3, 4)), ("f", (3, 4))]),
    ("NLLLoss", {"ignore_index": 1}, [("f", (6, 5)), ("i", (6,), 5)]),
    ("BCELoss", {"reduction": "sum"}, [("p", (3, 4)), ("b", (3, 4))]),
    ("BCEWithLogitsLoss", {}, [("f", (3, 4)), ("b", (3, 4))]),
    ("SmoothL1Loss", {"delta": 0.5}, [("f", (3, 4)), ("f", (3, 4))]),
    ("KLDivLoss", {"reduction": "batchmean"}, [("f", (3, 4)), ("p", (3, 4))]),
    ("MarginRankingLoss", {"margin": 0.1},
     [("f", (6,)), ("f", (6,)), ("s", (6,))]),
    ("HingeEmbeddingLoss", {}, [("f", (6,)), ("s", (6,))]),
    ("CosineEmbeddingLoss", {"margin": 0.1},
     [("f", (4, 5)), ("f", (4, 5)), ("s", (4,))]),
    ("TripletMarginLoss", {"swap": True},
     [("f", (4, 5)), ("f", (4, 5)), ("f", (4, 5))]),
]


@pytest.mark.parametrize("cls,kw,specs", LAYERS, ids=[c[0] for c in LAYERS])
def test_loss_layer_matches_jax(cls, kw, specs):
    agree(lambda p: getattr(p.nn, cls)(**kw),
          _arrays(sum(map(ord, cls)), *specs))


def test_bce_with_logits_layer_weights():
    x, y, w, pw = _arrays(12, ("f", (3, 4)), ("b", (3, 4)), ("p", (3, 4)),
                          ("p", (4,)))
    agree(lambda p: p.nn.BCEWithLogitsLoss(weight=p.to_tensor(w),
                                           pos_weight=p.to_tensor(pw)),
          [x, y])


def test_losses_run_under_auto_cast():
    """Through ``forward_op``: under ``auto_cast`` the op runs, and its
    value stays within bf16 rounding of fp32's."""
    x, y = _arrays(13, ("f", (8, 16)), ("b", (8, 16)))
    xt, yt = T.to_tensor(x), T.to_tensor(y)
    ref = float(TF.binary_cross_entropy_with_logits(xt, yt))
    with T.amp.auto_cast(level="O1", dtype="bfloat16"):
        got = float(TF.binary_cross_entropy_with_logits(xt, yt))
    assert abs(got - ref) <= 1e-2 * abs(ref)


# -- the registry sweep of this module ------------------------------------------

@pytest.mark.parametrize("name", shared_ops("losses"))
def test_registry_sweep(name):
    check_sweep(name)

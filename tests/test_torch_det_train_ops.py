"""The port's detection-training half of ``vision/det_ops.py`` against the
JAX package's, starting from ``tests/test_legacy_ops.py::
TestDetectionOps``'s cases: ``deform_conv2d``, ``psroi_pool``,
``yolo_loss``, the FPN routing, the SSD matching, mining and loss,
``detection_output``, ``prroi_pool``, ``bilateral_slice``,
``correlation``, ``retinanet_detection_output``, the R-CNN and RetinaNet
assigners and ``roi_perspective_transform``.

Same seeded numpy inputs through both packages. Indices, matches, labels,
masks and counts must be EQUAL (compared by value: the JAX package gives
int32 where the port gives int64); floats within ``1e-6 * max|ref|``
(``roi_perspective_transform``: ``1e-5``, its 8x8 solve goes through two
LAPACKs); gradients of ``sum(out)`` within ``1e-5 * max|g|``.
"""

import numpy as np
import pytest

import paddle_tpu as J
import paddle_tpu_torch as T


@pytest.fixture(autouse=True)
def _port_on_cpu():
    prev = T.get_device()
    T.set_device("cpu")
    yield
    T.set_device(prev)


def close(got, want, rtol=1e-6, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if want.dtype.kind in "biu":
        np.testing.assert_array_equal(got, want, err_msg=what)
        return
    got, want = got.astype(np.float64), want.astype(np.float64)
    scale = max(float(np.abs(want).max(initial=0.0)), 1e-30)
    err = float(np.abs(got - want).max(initial=0.0))
    assert err <= rtol * scale, f"{what}: max err {err} > {rtol} * {scale}"


def _flat(out):
    if isinstance(out, (tuple, list)):
        res = []
        for o in out:
            res += _flat(o)
        return res
    return [out]


def both(fn, *arrays, grad=False, rtol=1e-6, **kw):
    """``fn`` of both packages on the same inputs (numpy arrays become
    tensors, lists of arrays lists of tensors); outputs compared, and with
    ``grad`` the gradient of the sum of the first output."""
    outs, grads = [], []
    for P in (J, T):
        ts = []
        for a in arrays:
            if isinstance(a, np.ndarray):
                ts.append(P.to_tensor(a, stop_gradient=not (
                    grad and a.dtype.kind == "f")))
            elif isinstance(a, list) and a and isinstance(a[0], np.ndarray):
                ts.append([P.to_tensor(x) for x in a])
            else:
                ts.append(a)
        res = _flat(getattr(P.vision.ops, fn)(*ts, **kw))
        outs.append([o.numpy() for o in res])
        if grad:
            res[0].sum().backward()
            # an input that gets no gradient counts as a zero one
            grads.append([np.zeros(t.shape, np.float32) if t.grad is None
                          else t.grad.numpy() for t in ts
                          if hasattr(t, "grad") and not t.stop_gradient])
    assert len(outs[0]) == len(outs[1]), fn
    for i, (a, b) in enumerate(zip(*outs)):
        close(b, a, rtol=rtol, what=f"{fn} out {i}")
    if grad:
        assert len(grads[0]) == len(grads[1]) > 0, fn
        for i, (a, b) in enumerate(zip(*grads)):
            close(b, a, rtol=1e-5, what=f"{fn} grad {i}")
    return outs[1]


RNG = np.random.default_rng(0)


def boxes4(n=6, scale=10.0):
    lo = RNG.random((n, 2)).astype(np.float32) * scale
    wh = RNG.random((n, 2)).astype(np.float32) * scale + 1
    return np.concatenate([lo, lo + wh], -1)


def randn(*shape):
    return RNG.standard_normal(shape).astype(np.float32)


# -- deformable convolution -------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(padding=1),
    dict(stride=2, padding=1, dilation=1),
    dict(padding=2, dilation=2, deformable_groups=2, groups=2),
])
def test_deform_conv2d(kw):
    dg = kw.get("deformable_groups", 1)
    x = randn(2, 4, 6, 6)
    w = randn(6, 4 // kw.get("groups", 1), 3, 3)
    oh = (6 + 2 * kw["padding"] - kw.get("dilation", 1) * 2 - 1) // \
        kw.get("stride", 1) + 1
    off = randn(2, 2 * dg * 9, oh, oh) * 1.5
    both("deform_conv2d", x, off, w, randn(6), grad=True, **kw)


def test_deform_conv2d_modulated():
    x, w = randn(1, 2, 5, 5), randn(3, 2, 3, 3)
    off = randn(1, 18, 5, 5)
    mask = RNG.random((1, 9, 5, 5)).astype(np.float32)
    both("deform_conv2d", x, off, w, None, 1, 1, 1, 1, 1, mask, grad=True)


def test_deform_conv_zero_offsets_is_conv():
    import torch
    x, w = randn(1, 4, 6, 6), randn(8, 4, 3, 3)
    out = both("deform_conv2d", x, np.zeros((1, 18, 6, 6), np.float32), w,
               padding=1)[0]
    ref = torch.nn.functional.conv2d(torch.from_numpy(x), torch.from_numpy(w),
                                     padding=1).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)


# -- RoI pools ----------------------------------------------------------------

def test_psroi_pool():
    x = randn(1, 2 * 3 * 3, 9, 9)
    rois = np.array([[0, 0, 8, 8], [1.5, 2.0, 7.0, 6.5], [3, 3, 3.2, 3.1]],
                    np.float32)
    both("psroi_pool", x, rois, None, 3, 1.0, grad=True)
    both("psroi_pool", x, rois * 2, output_size=3, spatial_scale=0.5,
         grad=True)


def test_psroi_pool_group_selectivity():
    x = np.zeros((1, 4, 4, 4), np.float32)
    for g in range(4):
        x[0, g] = g + 1
    out = both("psroi_pool", x, np.array([[0, 0, 4, 4]], np.float32),
               output_size=2)[0]
    np.testing.assert_allclose(out[0, 0], [[1, 2], [3, 4]], atol=1e-5)


def test_prroi_pool():
    x = randn(1, 3, 8, 8)
    rois = np.array([[0.3, 0.2, 7.1, 6.6], [2.0, 2.0, 2.5, 5.0]], np.float32)
    both("prroi_pool", x, rois, 2, grad=True)
    both("prroi_pool", x, rois * 2, output_size=(3, 2), spatial_scale=0.5,
         grad=True)


def test_roi_perspective_transform():
    x = randn(1, 2, 10, 12)
    quads = np.array([[1, 1, 8, 2, 9, 7, 2, 8],
                      [0.5, 0.5, 5.5, 0.5, 5.5, 4.5, 0.5, 4.5]], np.float32)
    both("roi_perspective_transform", x, quads, 4, 6, grad=True, rtol=1e-5)


# -- YOLOv3 loss -------------------------------------------------------------

ANCHORS = [10, 13, 16, 30, 33, 23, 30, 61, 62, 45, 59, 119]


@pytest.mark.parametrize("smooth", [False, True])
def test_yolo_loss(smooth):
    B, H, W, C = 2, 4, 4, 3
    x = randn(B, 3 * (5 + C), H, W) * 0.5
    gt = np.zeros((B, 4, 4), np.float32)
    gt[0, 0] = [0.5, 0.5, 0.3, 0.3]
    gt[0, 1] = [0.2, 0.7, 0.1, 0.2]
    gt[0, 2] = [0.8, 0.3, 0.05, 0.08]
    gt[1, 0] = [0.4, 0.4, 0.6, 0.5]
    gt[1, 1] = [0.9, 0.9, 0.2, 0.1]
    lab = RNG.integers(0, C, (B, 4)).astype(np.int64)
    both("yolo_loss", x, gt, lab, ANCHORS, [0, 1, 2], C,
         use_label_smooth=smooth, downsample_ratio=16, grad=True)
    both("yolo_loss", x, gt, lab, ANCHORS, [3, 4, 5], C, ignore_thresh=0.3,
         downsample_ratio=16, grad=True)


def test_yolo_loss_shared_cell_keeps_the_last_write():
    """Two gts in one cell and anchor: XLA's in-order scatter keeps the
    later gt's targets, and the padding gts (zero boxes, written with the
    fill at cell (0, 0)) come after them."""
    x = randn(1, 3 * 6, 4, 4) * 0.5
    gt = np.zeros((1, 5, 4), np.float32)
    gt[0, 0] = [0.30, 0.30, 0.20, 0.20]
    gt[0, 1] = [0.32, 0.28, 0.22, 0.18]
    gt[0, 2] = [0.05, 0.05, 0.2, 0.2]
    lab = np.array([[0, 0, 0, 0, 0]], np.int64)
    both("yolo_loss", x, gt, lab, ANCHORS[:6], [0, 1, 2], 1, grad=True)


def test_yolo_loss_responds_to_gt():
    x = (randn(1, 3 * 7, 4, 4) * 0.1)
    gt = np.zeros((1, 2, 4), np.float32)
    gt[0, 0] = [0.5, 0.5, 0.3, 0.3]
    gtl = np.zeros((1, 2), np.int64)
    l1 = both("yolo_loss", x, gt, gtl, ANCHORS[:6], [0, 1, 2], 2)[0]
    l0 = both("yolo_loss", x, np.zeros((1, 2, 4), np.float32), gtl,
              ANCHORS[:6], [0, 1, 2], 2)[0]
    assert abs(float(l1[0]) - float(l0[0])) > 1e-4


# -- FPN routing -------------------------------------------------------------

def test_distribute_and_collect_fpn():
    rois = np.array([[0, 0, 10, 10], [0, 0, 200, 200], [0, 0, 60, 60],
                     [5, 5, 120, 90], [0, 0, 30, 500]], np.float32)
    outs = both("distribute_fpn_proposals", rois, 2, 5, 4, 224)
    *levels, restore = outs
    order = np.concatenate([o for o in levels if o.shape[0]])
    np.testing.assert_array_equal(order[restore], rois)
    scores = [np.array([0.5, 0.9, 0.5], np.float32),
              np.array([0.7, 0.5, 0.1], np.float32)]
    both("collect_fpn_proposals", [boxes4(3), boxes4(3)], scores, 4)


# -- SSD matching, mining, loss, inference ---------------------------------

def test_bipartite_match_and_target_assign():
    gt = np.array([[0, 0, 10, 10], [20, 20, 30, 30]], np.float32)
    pr = np.array([[0, 0, 9, 9], [19, 19, 31, 31], [5, 5, 6, 6],
                   [1, 1, 11, 11]], np.float32)
    iou = both("iou_similarity", gt, pr)[0]
    m, _ = both("bipartite_match", iou)
    assert m.tolist() == [0, 1, -1, -1]
    m2, _ = both("bipartite_match", iou, "per_prediction", 0.3)
    assert m2.tolist() == [0, 1, -1, 0]
    t, wgt = both("target_assign", np.array([[1.0, 2.0], [3.0, 4.0]],
                                            np.float32), m2)
    assert wgt[:, 0].tolist() == [1, 1, 0, 1]
    both("target_assign", randn(3, 2, 2), np.array([2, -1, 0, 1]),
         mismatch_value=-1.0)


def test_mine_hard_examples():
    loss = (RNG.integers(0, 4, 12) / 4).astype(np.float32)   # ties
    match = np.array([0, -1, -1, -1, 1, -1, -1, -1, -1, -1, -1, -1])
    mask = both("mine_hard_examples", loss, match)[0]
    assert int(mask.sum()) == 6   # 3x ratio * 2 positives
    both("mine_hard_examples", loss, match, sample_size=4)
    both("mine_hard_examples", loss, match, neg_pos_ratio=1.5)


def test_ssd_loss():
    P, C = 12, 4
    pri = RNG.random((P, 2)).astype(np.float32) * 0.6
    priors = np.concatenate([pri, pri + 0.2 + RNG.random((P, 2)).astype(
        np.float32) * 0.2], -1)
    gt = np.array([[0, 0, 0.4, 0.4], [0.5, 0.5, 0.9, 0.9],
                   [0.2, 0.5, 0.5, 0.9]], np.float32)
    both("ssd_loss", randn(P, 4) * 0.1, randn(P, C), gt,
         np.array([1, 2, 3], np.int64), priors, grad=True)
    both("ssd_loss", randn(P, 4) * 0.1, randn(P, C), gt,
         np.array([1, 2, 3], np.int64), priors, neg_pos_ratio=1.0,
         loc_loss_weight=0.5, conf_loss_weight=2.0, grad=True)


def test_detection_output():
    P, C = 10, 3
    priors = np.sort(RNG.random((P, 4)).astype(np.float32).reshape(
        P, 2, 2), axis=1).transpose(0, 2, 1).reshape(P, 4)
    loc = randn(2, P, 4) * 0.1
    scores = (RNG.integers(1, 5, (2, P, C)) / 5).astype(np.float32)
    out, idx, cnt = both("detection_output", loc, scores, priors,
                         nms_threshold=0.3, keep_top_k=6,
                         score_threshold=0.2)
    assert out.shape == (2, 6, 6) and (cnt <= 6).all()
    var = np.tile(np.array([[0.1, 0.1, 0.2, 0.2]], np.float32), (P, 1))
    both("detection_output", loc, scores, priors, var * 2)


# -- contrib singles ----------------------------------------------------------

@pytest.mark.parametrize("offset", [False, True])
def test_bilateral_slice(offset):
    C = 3
    x = randn(2, C, 6, 5)
    guide = RNG.random((2, 6, 5)).astype(np.float32)
    grid = randn(2, C * (C + 1) if offset else 4, 3, 3, 2)
    both("bilateral_slice", x, guide, grid, has_offset=offset, grad=True)


@pytest.mark.parametrize("d,s2", [(1, 1), (2, 2), (3, 1)])
def test_correlation(d, s2):
    both("correlation", randn(2, 3, 6, 7), randn(2, 3, 6, 7),
         max_displacement=d, stride2=s2, grad=True)


def test_retinanet_detection_output():
    deltas = [randn(2, 6, 4) * 0.1, randn(2, 4, 4) * 0.1]
    scores = [(RNG.integers(1, 5, (2, 6, 3)) / 5).astype(np.float32),
              (RNG.integers(1, 5, (2, 4, 3)) / 5).astype(np.float32)]
    anchors = [boxes4(6, 20.0), boxes4(4, 40.0)]
    out, idx, cnt = both("retinanet_detection_output", deltas, scores,
                         anchors, None, score_threshold=0.3, keep_top_k=5)
    assert out.shape == (2, 5, 6)


# -- R-CNN / RetinaNet target assignment -------------------------------------

def _anchor_grid(n=8, step=4.0, size=8.0):
    c = (np.arange(n, dtype=np.float32) + 0.5) * step
    cy, cx = np.meshgrid(c, c, indexing="ij")
    return np.stack([cx - size / 2, cy - size / 2, cx + size / 2,
                     cy + size / 2], -1).reshape(-1, 4).astype(np.float32)


GTS = np.array([[2, 2, 10, 10], [12, 4, 22, 14], [3, 3, 9, 9],
                [5, 5, 5, 9]], np.float32)   # the last one has no area


@pytest.mark.parametrize("kw", [dict(), dict(rpn_batch_size_per_im=8,
                                             rpn_fg_fraction=0.25),
                                dict(rpn_positive_overlap=0.4,
                                     rpn_negative_overlap=0.2)])
def test_rpn_target_assign(kw):
    labels, best_gt, fg, bg = both("rpn_target_assign", _anchor_grid(),
                                   GTS, **kw)
    assert fg.any() and (labels[fg] == 1).all()


def test_rpn_target_assign_shared_best_anchor():
    """Two gts whose best anchor is the same: the later gt's write
    stands, as in XLA's in-order scatter."""
    gts = np.array([[2, 2, 10, 10], [2.5, 2.5, 9.5, 9.5]], np.float32)
    both("rpn_target_assign", _anchor_grid(), gts,
         rpn_positive_overlap=0.95)


@pytest.mark.parametrize("kw", [dict(), dict(positive_overlap=0.3,
                                             negative_overlap=0.1)])
def test_retinanet_target_assign(kw):
    both("retinanet_target_assign", _anchor_grid(), GTS,
         np.array([1, 3, 2, 0], np.int64), **kw)


@pytest.mark.parametrize("kw", [dict(), dict(batch_size_per_im=8,
                                             fg_fraction=0.5, fg_thresh=0.3,
                                             bg_thresh_lo=0.05)])
def test_generate_proposal_labels(kw):
    rois = np.concatenate([_anchor_grid(6, 4.0, 7.0), GTS[:3] + 0.5])
    both("generate_proposal_labels", rois, GTS[:3],
         np.array([1, 2, 3], np.int64), **kw)


@pytest.mark.parametrize("fn,extra", [
    ("psroi_pool", dict(output_size=2)),
    ("prroi_pool", dict(output_size=2)),
    ("roi_perspective_transform", dict(transformed_height=3,
                                       transformed_width=3)),
])
def test_reference_rois_read_image_zero(fn, extra):
    """ROADMAP §C: the reference's ``psroi_pool``, ``prroi_pool`` and
    ``roi_perspective_transform`` pool every RoI from image 0
    (``paddle_tpu/vision/det_ops.py:185``, ``:1057``, ``:1403``) and read
    no ``boxes_num``; Paddle maps each RoI to its own image. The port
    keeps the reference's contract (held equal above), so a batch of two
    images gives what image 0 alone gives, in both packages."""
    x = randn(2, 8, 6, 6)
    rois = np.array([[0.5, 0.5, 5, 5]], np.float32)
    if fn == "roi_perspective_transform":
        rois = np.array([[1, 1, 4, 1, 4, 4, 1, 4]], np.float32)
    two = both(fn, x, rois, **extra)[0]
    one = both(fn, x[:1], rois, **extra)[0]
    np.testing.assert_array_equal(two, one)

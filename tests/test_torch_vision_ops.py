"""The port's box and NMS ops (``vision/ops.py``, ``vision/det_ops.py``)
against the JAX package's, mirroring ``tests/test_detection.py``,
``tests/test_legacy_ops.py``'s detection cases and
``tests/test_extended_ops.py``'s ``nms`` / ``box_coder`` cases.

Same seeded numpy inputs through both packages. The selections — ``nms``,
``multiclass_nms``, ``matrix_nms``, ``generate_proposals``' indices and
counts — must be EQUAL, on inputs with duplicated scores: the port's
stable descending sort keeps ``lax.top_k``'s and ``jnp.argsort``'s order
at ties (the lower index first). Floats within ``1e-6 * max|ref|`` (the
same formulas in the same order; most come out bitwise). Integer outputs
compare by value: the JAX package gives int32 where Paddle and the port
give int64.

``yolo_box``'s boxes differ from the reference's, which are wrong: the
reference transposes the stacked [B, A, H, W, 4] boxes with the score
tensor's permutation, mixing coordinates across anchors and cells
(ROADMAP §C); ``test_reference_yolo_box_layout_fault`` records it and
holds the port to a numpy decode.
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


def both(fn, *arrays, exact=False, grad=False, module="ops", **kw):
    outs, grads = [], []
    for P in (J, T):
        ts = [P.to_tensor(a, stop_gradient=not grad)
              if isinstance(a, np.ndarray) else a for a in arrays]
        mod = getattr(P.vision, module)
        out = getattr(mod, fn)(*ts, **kw)
        res = list(out) if isinstance(out, (tuple, list)) else [out]
        outs.append([o.numpy() for o in res])
        if grad:
            res[0].sum().backward()
            grads.append([t.grad.numpy() for t in ts
                          if hasattr(t, "grad") and t.grad is not None])
    for i, (a, b) in enumerate(zip(*outs)):
        if exact:
            np.testing.assert_array_equal(b, a, err_msg=f"{fn} out {i}")
        else:
            close(b, a, what=f"{fn} out {i}")
    for i, (a, b) in enumerate(zip(*grads) if grad else ()):
        close(b, a, rtol=1e-5, what=f"{fn} grad {i}")
    return outs[1]


RNG = np.random.default_rng(0)


def boxes4(n=6, scale=10.0):
    lo = RNG.random((n, 2)).astype(np.float32) * scale
    wh = RNG.random((n, 2)).astype(np.float32) * scale + 1
    return np.concatenate([lo, lo + wh], -1)


def dup_scores(shape, levels=5):
    """Scores on a coarse grid: many exact ties."""
    return (RNG.integers(1, levels, shape) / levels).astype(np.float32)


def test_box_iou():
    both("box_iou", boxes4(8), boxes4(5), grad=True)


@pytest.mark.parametrize("kw", [dict(iou_threshold=0.3),
                                dict(iou_threshold=0.5, top_k=3),
                                dict(iou_threshold=0.2, with_cats=True),
                                dict(iou_threshold=0.4, no_scores=True)],
                         ids=["plain", "top_k", "categories", "no-scores"])
def test_nms_equal_with_ties(kw):
    kw = dict(kw)
    b = boxes4(16, 6.0)
    s = None if kw.pop("no_scores", False) else dup_scores(16)
    if kw.pop("with_cats", False):
        kw.update(category_idxs=RNG.integers(0, 3, 16), categories=[0, 1, 2])
    got = both("nms", b, kw.pop("iou_threshold"), s, exact=True, **kw)
    assert got[0].dtype == np.int64


def test_nms_kept_boxes_overlap_less_than_threshold():
    b, s = boxes4(30, 5.0), dup_scores(30)
    keep = T.vision.ops.nms(T.to_tensor(b), 0.3, T.to_tensor(s)).numpy()
    iou = T.vision.ops.box_iou(T.to_tensor(b[keep]),
                               T.to_tensor(b[keep])).numpy()
    assert (iou[~np.eye(len(keep), dtype=bool)] <= 0.3).all()
    assert (np.diff(s[keep]) <= 0).all()


@pytest.mark.parametrize("kw", [
    dict(nms_top_k=8, keep_top_k=10, nms_threshold=0.3),
    dict(nms_top_k=12, keep_top_k=6, nms_threshold=0.5, normalized=False),
    dict(nms_top_k=8, keep_top_k=20, background_label=0, score_threshold=0.3),
], ids=["topk8", "unnormalized", "background"])
def test_multiclass_nms_equal_with_ties(kw):
    bb = boxes4(12)[None].repeat(2, 0)
    sc = dup_scores((2, 3, 12))
    out, idx, cnt = both("multiclass_nms", bb, sc, exact=True, **kw)
    assert idx.dtype == np.int64 and cnt.shape == (2,)
    assert (out[:, :, 0][idx < 0] == -1).all()


@pytest.mark.parametrize("kw", [
    dict(nms_top_k=8, keep_top_k=10),
    dict(nms_top_k=12, keep_top_k=12, use_gaussian=True, post_threshold=0.1),
    dict(nms_top_k=6, keep_top_k=8, normalized=False, score_threshold=0.3),
], ids=["linear", "gaussian", "unnormalized"])
def test_matrix_nms_equal_with_ties(kw):
    bb = boxes4(12)[None].repeat(2, 0)
    sc = dup_scores((2, 3, 12))
    both("matrix_nms", bb, sc, exact=True, **kw)


def test_priors_and_anchors():
    f = np.zeros((1, 2, 3, 4), np.float32)
    im = np.zeros((1, 3, 24, 32), np.float32)
    both("prior_box", f, im, [4.0, 8.0], max_sizes=[6.0, 12.0],
         aspect_ratios=(2.0,), flip=True, clip=True, exact=True)
    both("prior_box", f, im, [4.0], max_sizes=[6.0],
         aspect_ratios=(2.0, 3.0), min_max_aspect_ratios_order=True,
         steps=(8.0, 6.0), exact=True)
    both("density_prior_box", f, im, [2, 1], [4.0, 8.0], [1.0, 2.0],
         clip=True, exact=True)
    both("anchor_generator", f, [8.0, 16.0], [0.5, 1.0], stride=(8.0, 6.0),
         exact=True)


def test_generate_proposals():
    sc = dup_scores((2, 2, 3, 3))
    deltas = (RNG.standard_normal((2, 8, 3, 3)) * 0.2).astype(np.float32)
    im = np.array([[16.0, 16.0], [20.0, 24.0]], np.float32)
    anchors = (RNG.random((3, 3, 2, 4)) * 8).astype(np.float32)
    anchors[..., 2:] += anchors[..., :2]
    var = np.full((3, 3, 2, 4), 0.5, np.float32)
    both("generate_proposals", sc, deltas, im, anchors, pre_nms_top_n=10,
         post_nms_top_n=5)
    both("generate_proposals", sc, deltas, im, anchors, var,
         pre_nms_top_n=18, post_nms_top_n=6, nms_thresh=0.3, min_size=2.0)


def test_box_ops():
    both("box_clip", boxes4(5) * 2, np.array([[16.0, 12.0, 1.0]], np.float32),
         grad=True)
    both("box_clip", (boxes4(10) * 2).reshape(2, 5, 4),
         np.array([[16.0, 12.0, 1.0], [10, 30, 2.0]], np.float32))
    both("iou_similarity", boxes4(3), boxes4(4), box_normalized=False)
    both("iou_similarity", boxes4(3) / 20, boxes4(4) / 20)
    poly = np.where(RNG.random((1, 8, 3, 3)) > 0.3,
                    RNG.random((1, 8, 3, 3)), 0).astype(np.float32)
    both("polygon_box_transform", poly, exact=True)
    var = np.tile(np.array([[0.1, 0.1, 0.2, 0.2]], np.float32), (4, 1))
    both("box_decoder_and_assign", boxes4(4), var,
         (RNG.standard_normal((4, 8)) * 0.1).astype(np.float32),
         RNG.random((4, 2)).astype(np.float32))


def test_box_coder():
    pri = boxes4(4)
    var = np.tile(np.array([[0.1, 0.1, 0.2, 0.2]], np.float32), (4, 1))
    both("box_coder", pri, var, boxes4(3), grad=True)
    both("box_coder", pri, None, boxes4(3), box_normalized=False)
    deltas = (RNG.standard_normal((3, 4, 4)) * 0.1).astype(np.float32)
    both("box_coder", pri, var, deltas, code_type="decode_center_size",
         box_normalized=False, grad=True)
    both("box_coder", pri, None, deltas.transpose(1, 0, 2).copy(),
         code_type="decode_center_size", axis=1)


def test_roi_align_and_roi_pool():
    x = RNG.standard_normal((2, 3, 16, 16)).astype(np.float32)
    rois = np.array([[1, 1, 8, 9], [0, 2, 15, 14], [3.5, 4, 6, 12]],
                    np.float32)
    num = np.array([2, 1])
    both("roi_align", x, rois, num, 4, grad=True)
    both("roi_align", x, rois, num, (3, 2), spatial_scale=0.5,
         sampling_ratio=2, aligned=False)
    both("roi_pool", x, rois, num, 3, grad=True)
    both("roi_pool", x, rois * 2, num, (2, 3), spatial_scale=0.5)


def _yolo_decode(x, img_size, anchors, C, conf, ratio):
    """A numpy decode of one YOLOv3 head, rows in (h, w, anchor) order."""
    B, _, H, W = x.shape
    A = len(anchors) // 2
    v = x.reshape(B, A, 5 + C, H, W).astype(np.float64)
    sig = lambda z: 1 / (1 + np.exp(-z))  # noqa: E731
    gx = np.arange(W)[None, None, None, :]
    gy = np.arange(H)[None, None, :, None]
    bx = (sig(v[:, :, 0]) + gx) / W
    by = (sig(v[:, :, 1]) + gy) / H
    an = np.asarray(anchors, np.float64).reshape(A, 2)
    bw = np.exp(v[:, :, 2]) * an[None, :, 0, None, None] / (W * ratio)
    bh = np.exp(v[:, :, 3]) * an[None, :, 1, None, None] / (H * ratio)
    imh = img_size[:, 0].astype(np.float64)[:, None, None, None]
    imw = img_size[:, 1].astype(np.float64)[:, None, None, None]
    out = np.stack([np.clip((bx - bw / 2) * imw, 0, imw - 1),
                    np.clip((by - bh / 2) * imh, 0, imh - 1),
                    np.clip((bx + bw / 2) * imw, 0, imw - 1),
                    np.clip((by + bh / 2) * imh, 0, imh - 1)], -1)
    out = out * (sig(v[:, :, 4]) > conf)[..., None]
    return out.transpose(0, 2, 3, 1, 4).reshape(B, -1, 4)


def test_reference_yolo_box_layout_fault():
    """ROADMAP §C: the reference's yolo_box boxes are scrambled (its
    ``boxes.transpose(0, 3, 4, 1, 2)`` on [B, A, H, W, 4] puts the
    coordinate axis between W and A); the scores are right. The port's
    boxes equal a numpy decode in (h, w, anchor) order, its scores the
    reference's."""
    x = RNG.standard_normal((2, 21, 3, 4)).astype(np.float32)
    size = np.array([[64, 80], [32, 32]], np.int64)
    anchors = [4, 4, 8, 8, 16, 16]
    jb, js = J.vision.ops.yolo_box(J.to_tensor(x), J.to_tensor(size),
                                   anchors, 2)
    tb, ts = T.vision.ops.yolo_box(T.to_tensor(x), T.to_tensor(size),
                                   anchors, 2)
    want = _yolo_decode(x, size, anchors, 2, 0.01, 32)
    close(tb.numpy(), want, rtol=1e-5, what="port boxes")
    assert np.abs(jb.numpy() - want).max() > 1.0     # the fault
    close(ts.numpy(), js.numpy(), what="scores")


def test_multiclass_nms_static_shapes_and_no_host_read():
    """The greedy pass reads nothing back to the host: it runs inside a
    captured program (the CPU recording replays it) with the same
    result."""
    bb = boxes4(12)[None].repeat(2, 0)
    sc = dup_scores((2, 3, 12))
    want = [o.numpy() for o in T.vision.ops.multiclass_nms(
        T.to_tensor(bb), T.to_tensor(sc), nms_top_k=8, keep_top_k=10)]

    @T.jit.to_static
    def post(b, s):
        return T.vision.ops.multiclass_nms(b, s, nms_top_k=8, keep_top_k=10)

    for _ in range(3):        # eager, capture, replay
        got = [o.numpy() for o in post(T.to_tensor(bb), T.to_tensor(sc))]
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    assert T.jit.api.fallbacks.get("host_read", 0) == 0


def test_read_file_and_decode_jpeg(tmp_path):
    p = tmp_path / "blob.bin"
    p.write_bytes(bytes(range(10)))
    np.testing.assert_array_equal(T.vision.ops.read_file(str(p)).numpy(),
                                  np.arange(10, dtype=np.uint8))
    try:
        import PIL  # noqa: F401
    except ImportError:
        with pytest.raises(RuntimeError, match="Pillow"):
            T.vision.ops.decode_jpeg(T.vision.ops.read_file(str(p)))


def test_registry_names():
    from paddle_tpu_torch.core.dispatch import OP_REGISTRY
    for n in T.vision.ops.__all__:
        assert n in OP_REGISTRY, n
    for n in ("static_nms", "detection_loss"):
        import paddle_tpu_torch.vision.detection  # noqa: F401
        assert n in OP_REGISTRY

"""The port's detector (``vision/detection.py``) against the JAX package's,
mirroring ``tests/test_detection.py``.

* ``detection_loss`` and its gradients from the same logits, boxes and
  ground truth within ``1e-5 * max|ref|``, on boxes that touch the ground
  truth exactly: there ``jnp.clip`` / ``jnp.maximum`` split the gradient
  half and half, and so do the port's ``torch.maximum`` /
  ``torch.minimum`` (``torch.clamp`` would send all of it one way — the
  test checks that it would have failed);
* ``static_nms`` EQUAL to the reference's on scores with many ties;
* the FPN neck and the decoupled head from the same weights, forward and
  backward within ``1e-5``;
* the whole detector at 64 px through the port's ``make_train_step``
  (eager, capture, replay) against the port's eager steps, and
  ``examples/train_detector.py``'s inference (``multiclass_nms`` over the
  sigmoid scores);
* the slice as a whole, ``ppyoloe_mbv3`` at 64 px over three
  ``make_train_step`` Momentum steps from the JAX net's weights against
  the JAX package's steps (first loss within ``1e-5 * |loss|``, each
  loss within ``1e-4 * |loss|``), is marked slow: the JAX package builds
  and steps the detector eagerly, op by op, for about 130 s on a CPU.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as J
import paddle_tpu_torch as T
from paddle_tpu_torch.models.convert import state_dict_from_jax
from paddle_tpu_torch.vision.detection import _level_points


@pytest.fixture(autouse=True)
def _port_on_cpu():
    prev = T.get_device()
    T.set_device("cpu")
    yield
    T.set_device(prev)


def close(got, want, rtol=1e-5, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, f"{what}: max err {err} > {rtol} * {scale}"


RNG = np.random.default_rng(0)
IMG = 64
POINTS, STRIDES = _level_points([(IMG // s, IMG // s) for s in (8, 16, 32)],
                                (8, 16, 32))
A = len(POINTS)


def _gt(b, g=4, classes=3, rng=RNG):
    lo = rng.uniform(0, IMG - 24, (b, g, 2)).astype(np.float32)
    wh = rng.uniform(8, 24, (b, g, 2)).astype(np.float32)
    gb = np.concatenate([lo, lo + wh], -1)
    gl = rng.integers(0, classes, (b, g)).astype(np.int32)
    return gb, gl


def _loss_inputs(b=2, classes=3):
    cls = RNG.standard_normal((b, A, classes)).astype(np.float32)
    gb, gl = _gt(b, classes=classes)
    gl[1, -1] = -1                       # a padded ground truth
    gb[1, -1] = 0.0
    # predicted boxes around each point; the point nearest each ground
    # truth's center gets a box whose right edge touches the ground truth's
    # left edge (an intersection width of exactly 0: a tie in the clip)
    # and whose bottom equals the ground truth's (a tie in max / min)
    d = RNG.uniform(2, 12, (b, A, 4)).astype(np.float32)
    px, py = POINTS[:, 0], POINTS[:, 1]
    boxes = np.stack([px - d[..., 0], py - d[..., 1], px + d[..., 2],
                      py + d[..., 3]], -1).astype(np.float32)
    for i in range(b):
        for g in range(gb.shape[1]):
            near = np.argmin((px - (gb[i, g, 0] + gb[i, g, 2]) / 2) ** 2 +
                             (py - (gb[i, g, 1] + gb[i, g, 3]) / 2) ** 2)
            boxes[i, near, 0] = gb[i, g, 0] - 5.0
            boxes[i, near, 2] = gb[i, g, 0]
            boxes[i, near, 3] = gb[i, g, 3]
    return cls, boxes, gb, gl


def _loss_and_grads(P, cls, boxes, gb, gl):
    c = P.to_tensor(cls, stop_gradient=False)
    b = P.to_tensor(boxes, stop_gradient=False)
    mod = P.vision.detection if P is T else __import__(
        "paddle_tpu.vision.detection", fromlist=["x"])
    if P is T:
        pts, sts = P.to_tensor(POINTS), P.to_tensor(STRIDES)
    else:                       # the reference takes its arrays raw
        import jax.numpy as jnp
        pts, sts = jnp.asarray(POINTS), jnp.asarray(STRIDES)
    loss = mod.detection_loss(c, b, P.to_tensor(gb), P.to_tensor(gl), pts,
                              sts, 3)
    loss.backward()
    return float(loss), c.grad.numpy(), b.grad.numpy()


def test_detection_loss_and_tie_gradients_match_jax():
    import paddle_tpu.vision.detection  # noqa: F401
    import paddle_tpu_torch.vision.detection  # noqa: F401
    args = _loss_inputs()
    lj, cj, bj = _loss_and_grads(J, *args)
    lt, ct, bt = _loss_and_grads(T, *args)
    assert abs(lt - lj) <= 1e-6 * abs(lj)
    close(ct, cj, what="d cls")
    close(bt, bj, what="d boxes")


def test_clamp_would_not_split_the_tie():
    """The same loss with torch.clamp in the clips: its box gradient
    leaves JAX's at the touching coordinates — why the port clips with
    torch.maximum / torch.minimum."""
    import paddle_tpu.vision.detection  # noqa: F401
    from paddle_tpu_torch.vision import det_ops
    args = _loss_inputs()
    _, _, bj = _loss_and_grads(J, *args)
    real = det_ops.clip
    import paddle_tpu_torch.vision.detection as D

    def clamp_clip(x, lo=None, hi=None):
        return torch.clamp(x, lo, hi)

    D.clip = clamp_clip
    try:
        _, _, bt = _loss_and_grads(T, *args)
    finally:
        D.clip = real
    assert np.abs(bt - bj).max() > 1e-4 * np.abs(bj).max()


def test_detection_loss_ignores_padded_gt():
    cls, boxes, gb, gl = _loss_inputs()
    base = T.vision.detection.detection_loss(
        T.to_tensor(cls), T.to_tensor(boxes), T.to_tensor(gb[:, :3]),
        T.to_tensor(gl[:, :3]), T.to_tensor(POINTS), T.to_tensor(STRIDES), 3)
    gl2 = gl.copy()
    gl2[:, 3] = -1
    padded = T.vision.detection.detection_loss(
        T.to_tensor(cls), T.to_tensor(boxes), T.to_tensor(gb),
        T.to_tensor(gl2), T.to_tensor(POINTS), T.to_tensor(STRIDES), 3)
    assert float(base) == float(padded)


@pytest.mark.parametrize("top_k", [8, 20, 60])
def test_static_nms_equal_with_ties(top_k):
    import paddle_tpu.vision.detection as JD
    lo = RNG.random((60, 2)).astype(np.float32) * 40
    b = np.concatenate([lo, lo + RNG.random((60, 2)).astype(np.float32) * 20
                        + 2], -1)
    s = (RNG.integers(0, 6, 60) / 5).astype(np.float32)
    want = JD.static_nms(J.to_tensor(b), J.to_tensor(s), top_k=top_k,
                         iou_threshold=0.4)
    got = T.vision.detection.static_nms(T.to_tensor(b), T.to_tensor(s),
                                        top_k=top_k, iou_threshold=0.4)
    for a, c in zip(want, got):
        np.testing.assert_array_equal(c.numpy(), a.numpy())


def test_fpn_and_head_match_jax():
    import paddle_tpu.vision.detection as JD
    import paddle_tpu_torch.vision.detection as TD
    feats = [RNG.standard_normal((2, c, s, s)).astype(np.float32)
             for c, s in ((8, 8), (12, 4), (16, 2))]
    J.seed(4)
    jf, jh = JD.FPN([8, 12, 16], 8), JD.PPYOLOEHead(8, 3, stacked=1)
    tf, th = TD.FPN([8, 12, 16], 8), TD.PPYOLOEHead(8, 3, stacked=1)
    tf.set_state_dict(state_dict_from_jax(jf))
    th.set_state_dict(state_dict_from_jax(jh))
    res = []
    for P, f, h in ((J, jf, jh), (T, tf, th)):
        ins = [P.to_tensor(x, stop_gradient=False) for x in feats]
        c, r = h(f(ins))
        (c.sum() + (r * r).sum()).backward()
        res.append([c.numpy(), r.numpy()] + [x.grad.numpy() for x in ins])
    for i, (a, b) in enumerate(zip(*res)):
        close(b, a, what=f"neck/head {i}")


def _train(det, steps, captured, classes=3, b=2):
    pts, strides = det.anchor_points()
    opt = T.optimizer.Momentum(0.01, momentum=0.9,
                               parameters=det.parameters())

    def loss_fn(cls, boxes, gt_b, gt_l):
        return T.vision.detection.detection_loss(cls, boxes, gt_b, gt_l, pts,
                                                 strides, classes)

    step = T.jit.make_train_step(det, opt, loss_fn)
    rng = np.random.default_rng(1)
    losses = []
    for _ in range(steps):
        x = rng.standard_normal((b, 3, IMG, IMG)).astype(np.float32)
        gb, gl = _gt(b, rng=rng)
        if captured:
            losses.append(float(step([T.to_tensor(x)],
                                     [T.to_tensor(gb), T.to_tensor(gl)])))
        else:
            det.train()
            cls, boxes = det(T.to_tensor(x))
            loss = loss_fn(cls, boxes, T.to_tensor(gb), T.to_tensor(gl))
            loss.backward()
            opt.step()
            opt.clear_grad()
            losses.append(float(loss))
    return losses


def test_detector_captured_step_matches_eager_and_decreases():
    """The bench_detect composition at 64 px: step([x], [gt_b, gt_l])
    through the port's captured step equals the port's eager steps, and
    the loss falls."""
    T.seed(0)
    d1 = T.vision.detection.ppyoloe_mbv3(num_classes=3, image_size=IMG)
    d2 = T.vision.detection.ppyoloe_mbv3(num_classes=3, image_size=IMG)
    d2.set_state_dict(d1.state_dict())
    eager = _train(d1, 4, captured=False)
    cap = _train(d2, 4, captured=True)
    np.testing.assert_allclose(cap, eager, rtol=1e-5)
    cls, boxes = d2(T.to_tensor(np.zeros((1, 3, IMG, IMG), np.float32)))
    assert list(cls.shape) == [1, A, 3] and list(boxes.shape) == [1, A, 4]


def test_train_detector_inference_multiclass_nms():
    """examples/train_detector.py's inference: multiclass_nms over the
    sigmoid class scores of the decoded boxes, static shapes."""
    T.seed(1)
    det = T.vision.detection.ppyoloe_mbv3(num_classes=3, image_size=IMG)
    det.eval()
    cls, boxes = det(T.to_tensor(RNG.standard_normal(
        (2, 3, IMG, IMG)).astype(np.float32)))
    scores = T.to_tensor(torch.sigmoid(cls._value).permute(0, 2, 1)
                         .contiguous())
    out, idx, count = T.vision.ops.multiclass_nms(
        boxes, scores, score_threshold=0.05, nms_top_k=32, keep_top_k=8,
        nms_threshold=0.6)
    assert list(out.shape) == [2, 8, 6] and list(count.shape) == [2]
    n = int(count.numpy()[0])
    rows = out.numpy()[0]
    assert (rows[:n, 0] >= 0).all() and (rows[n:, 0] == -1).all()
    assert (np.diff(rows[:n, 1]) <= 0).all()


@pytest.mark.slow
def test_ppyoloe_three_captured_steps_match_jax():
    """The slice as a whole (slow: the JAX package's eager detector)."""
    import paddle_tpu.vision.detection as JD
    J.seed(0)
    jd = JD.ppyoloe_mbv3(num_classes=3, image_size=IMG)
    td = T.vision.detection.ppyoloe_mbv3(num_classes=3, image_size=IMG)
    td.set_state_dict(state_dict_from_jax(jd))
    pj, sj = jd.anchor_points()
    pt, st = td.anchor_points()
    js = J.jit.make_train_step(
        jd, J.optimizer.Momentum(0.01, momentum=0.9,
                                 parameters=jd.parameters()),
        lambda c, b, g1, g2: JD.detection_loss(c, b, g1, g2, pj, sj, 3))
    ts = T.jit.make_train_step(
        td, T.optimizer.Momentum(0.01, momentum=0.9,
                                 parameters=td.parameters()),
        lambda c, b, g1, g2: T.vision.detection.detection_loss(
            c, b, g1, g2, pt, st, 3))
    rng = np.random.default_rng(2)
    for i in range(3):
        x = rng.standard_normal((4, 3, IMG, IMG)).astype(np.float32)
        gb, gl = _gt(4, rng=rng)
        lj = float(js([J.to_tensor(x)], [J.to_tensor(gb), J.to_tensor(gl)]))
        lt = float(ts([T.to_tensor(x)], [T.to_tensor(gb), T.to_tensor(gl)]))
        assert abs(lt - lj) <= (1e-5 if i == 0 else 1e-4) * abs(lj), (i, lt,
                                                                       lj)

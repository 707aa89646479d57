"""The detection family — counterpart of ``paddle_tpu/vision/detection.py``:
an FPN neck, a PP-YOLOE-style decoupled head over a MobileNetV3 backbone,
its center-sampled training loss and a static-shape NMS.

Capability target, as the reference's: PaddleDetection's PP-YOLOE
(``ppdet/modeling``: backbone, top-down FPN, the ET-head's decoupled
class and box branches, assignment and multiclass NMS), with

* an anchor-free point head: each FPN level predicts per-pixel class
  logits and (l, t, r, b) distances; the levels concatenate to a fixed
  anchor count set by the input size;
* ``detection_loss``: FCOS-style center sampling (a point is positive
  for the first ground truth whose center region and box contain it),
  BCE on the classes and GIoU on the boxes, every shape static, so the
  loss runs inside the captured train step. Its clips are
  ``torch.maximum`` / ``torch.minimum`` (``det_ops.clip``), which split
  the gradient at a tie as ``jnp.clip`` / ``jnp.maximum`` do;
* ``static_nms``: top-K pre-selection and greedy IoU suppression with
  fixed shapes and a validity mask, no host read (``det_ops``).
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch
import torch.nn.functional as TF

from ..core.dispatch import forward_op
from ..core.place import torch_device
from ..core.tensor import Tensor, to_tensor
from ..nn import Conv2D, Sequential
from ..nn.layer import Layer
from .det_ops import clip, greedy_keep, pairwise_iou
from .det_ops import top_k as _top_k
from .models import (ConvBNLayer, _make_divisible, mobilenet_v3_large,
                     mobilenet_v3_small)

__all__ = ["FPN", "PPYOLOEHead", "PPYOLOEDetector", "ppyoloe_mbv3",
           "static_nms", "detection_loss"]


class FPN(Layer):
    """Top-down feature pyramid (ref: ppdet necks — lateral 1x1, output
    3x3, nearest-neighbour upsampling with half-pixel centers, as
    ``jax.image.resize``'s ``nearest``)."""

    def __init__(self, in_channels: Sequence[int], out_channel: int = 96):
        super().__init__()
        self.out_channel = out_channel
        self.laterals = Sequential(*[Conv2D(c, out_channel, 1)
                                     for c in in_channels])
        self.outputs = Sequential(*[
            ConvBNLayer(out_channel, out_channel, 3, act="relu")
            for _ in in_channels])

    def forward(self, feats: List):
        lats = [l(f) for l, f in zip(self.laterals, feats)]
        out = [lats[-1]]
        for i in range(len(lats) - 2, -1, -1):
            size = tuple(lats[i].shape[2:])
            upd = forward_op("fpn_upsample", lambda v, size=size:
                             TF.interpolate(v, size=size,
                                            mode="nearest-exact"), [out[0]])
            out.insert(0, lats[i] + upd)
        return [o_layer(o) for o_layer, o in zip(self.outputs, out)]


class PPYOLOEHead(Layer):
    """Decoupled per-level head: a small class branch and a box branch
    (ref: ppdet PPYOLOEHead ET-head, simplified to direct ltrb)."""

    def __init__(self, in_channel: int, num_classes: int,
                 num_levels: int = 3, stacked: int = 2):
        super().__init__()
        self.num_classes = num_classes
        self.num_levels = num_levels

        def branch():
            return Sequential(*[ConvBNLayer(in_channel, in_channel, 3,
                                            act="relu")
                                for _ in range(stacked)])

        self.cls_branches = Sequential(*[branch() for _ in range(num_levels)])
        self.reg_branches = Sequential(*[branch() for _ in range(num_levels)])
        self.cls_preds = Sequential(*[Conv2D(in_channel, num_classes, 3,
                                             padding=1)
                                      for _ in range(num_levels)])
        self.reg_preds = Sequential(*[Conv2D(in_channel, 4, 3, padding=1)
                                      for _ in range(num_levels)])

    def forward(self, feats: List):
        """-> (cls_logits [B, A, C], ltrb [B, A, 4]), A the sum of the
        levels' H*W."""
        from ..ops.manipulation import concat, reshape, transpose
        cls_all, reg_all = [], []
        for i, f in enumerate(feats):
            c = self.cls_preds[i](self.cls_branches[i](f))
            r = self.reg_preds[i](self.reg_branches[i](f))
            B, C, H, W = c.shape
            cls_all.append(reshape(transpose(c, [0, 2, 3, 1]),
                                   [B, H * W, C]))
            reg_all.append(reshape(transpose(r, [0, 2, 3, 1]),
                                   [B, H * W, 4]))
        return concat(cls_all, axis=1), concat(reg_all, axis=1)


def _level_points(hw_list, strides):
    """Anchor-point centers (x, y) of every level, concatenated [A, 2],
    and each point's stride [A] (host numpy; the caller places them)."""
    pts, sts = [], []
    for (h, w), s in zip(hw_list, strides):
        ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        pts.append(np.stack([(xs + 0.5) * s, (ys + 0.5) * s],
                            -1).reshape(-1, 2))
        sts.append(np.full((h * w,), s, np.float32))
    return (np.concatenate(pts).astype(np.float32),
            np.concatenate(sts).astype(np.float32))


class PPYOLOEDetector(Layer):
    """backbone (MobileNetV3 features) -> FPN -> decoupled head.

    ``forward(images)`` -> (cls_logits [B, A, C], boxes_xyxy [B, A, 4]);
    training uses :func:`detection_loss`, inference decodes and runs
    static NMS.
    """

    STRIDES = (8, 16, 32)

    def __init__(self, num_classes: int = 80, backbone: str = "small",
                 neck_channel: int = 96, image_size: int = 320):
        super().__init__()
        self.num_classes = num_classes
        self.image_size = image_size
        mk = mobilenet_v3_small if backbone == "small" else mobilenet_v3_large
        self.backbone = mk(feature_only=True)
        cfg = self.backbone._config
        chans = [_make_divisible(cfg[i][2] * self.backbone._scale)
                 for i in self.backbone._feature_cuts()]
        self.neck = FPN(chans, neck_channel)
        self.head = PPYOLOEHead(neck_channel, num_classes)
        self._hw = [(image_size // s, image_size // s) for s in self.STRIDES]
        self._points = {}

    def anchor_points(self):
        """(points [A, 2], strides [A]) as Tensors on the current place."""
        pts, sts = _level_points(self._hw, self.STRIDES)
        return to_tensor(pts), to_tensor(sts)

    def _device_points(self, device):
        """The anchor points and strides on ``device``, made once (the
        first, eager call) so a captured step reads them in place."""
        if device not in self._points:
            pts, sts = _level_points(self._hw, self.STRIDES)
            self._points[device] = (torch.from_numpy(pts).to(device),
                                    torch.from_numpy(sts).to(device))
        return self._points[device]

    def forward(self, images):
        feats = self.neck(self.backbone(images))
        cls_logits, ltrb = self.head(feats)

        def decode(lv):
            pv, sv = self._device_points(lv.device)
            d = TF.softplus(lv) * sv[None, :, None]       # positive dists
            x, y = pv[None, :, 0:1], pv[None, :, 1:2]
            return torch.cat([x - d[..., 0:1], y - d[..., 1:2],
                              x + d[..., 2:3], y + d[..., 3:4]], -1)

        return cls_logits, forward_op("detect_decode", decode, [ltrb])


def ppyoloe_mbv3(num_classes: int = 80, image_size: int = 320,
                 backbone: str = "small"):
    return PPYOLOEDetector(num_classes=num_classes, image_size=image_size,
                           backbone=backbone)


def _value(x):
    return x._value if isinstance(x, Tensor) else torch.as_tensor(
        np.asarray(x), device=torch_device())


def detection_loss(cls_logits, boxes, gt_boxes, gt_labels, points, strides,
                   num_classes: int, center_radius: float = 1.5):
    """Center-sampled assignment + BCE on the classes + GIoU on the boxes.

    ``gt_boxes [B, G, 4]`` xyxy (zero-padded), ``gt_labels [B, G]`` (-1
    pads). A point is positive for the first ground truth whose center
    region (radius ``center_radius * stride``) contains it AND whose box
    contains it. ``points [A, 2]`` / ``strides [A]`` are
    ``PPYOLOEDetector.anchor_points()``. All shapes static.
    """
    args = [a if isinstance(a, Tensor) else to_tensor(a)
            for a in (cls_logits, boxes, gt_boxes, gt_labels)]
    pts_v, sts_v = _value(points), _value(strides)

    def impl(cl, bx, gb, gl):
        B, A, C = cl.shape
        G = gb.shape[1]
        points = pts_v.to(cl.device, torch.float32)
        strides = sts_v.to(cl.device, torch.float32)
        px, py = points[:, 0], points[:, 1]                      # [A]
        cx = (gb[..., 0] + gb[..., 2]) / 2                       # [B, G]
        cy = (gb[..., 1] + gb[..., 3]) / 2
        rad = center_radius * strides[None, :, None]             # [1, A, 1]
        in_center = (((px[None, :, None] - cx[:, None, :]).abs() < rad) &
                     ((py[None, :, None] - cy[:, None, :]).abs() < rad))
        in_box = ((px[None, :, None] >= gb[:, None, :, 0]) &
                  (px[None, :, None] <= gb[:, None, :, 2]) &
                  (py[None, :, None] >= gb[:, None, :, 1]) &
                  (py[None, :, None] <= gb[:, None, :, 3]))
        valid_gt = (gl >= 0)[:, None, :]                         # [B, 1, G]
        pos_mat = in_center & in_box & valid_gt                  # [B, A, G]
        # the first gt: argmax over an integer cast (a bool argmax is not
        # there on CUDA), the lower index first at a tie
        assigned = pos_mat.to(torch.int32).argmax(-1)            # [B, A]
        is_pos = pos_mat.any(-1)                                 # [B, A]
        tgt_box = torch.gather(gb, 1, assigned[..., None].expand(B, A, 4))
        tgt_lab = torch.gather(gl, 1, assigned)

        # jax.nn.one_hot (F.one_hot reads its input's range on the host)
        classes = torch.arange(C, device=cl.device)
        onehot = (clip(tgt_lab, 0)[..., None] == classes).float() * \
            is_pos[..., None]
        clf = cl.float()
        bce = clip(clf, 0) - clf * onehot + torch.log1p(torch.exp(-clf.abs()))
        n_pos = clip(is_pos.sum(), 1)
        cls_loss = bce.sum() / n_pos

        bxf = bx.float()
        ix1 = torch.maximum(bxf[..., 0], tgt_box[..., 0])
        iy1 = torch.maximum(bxf[..., 1], tgt_box[..., 1])
        ix2 = torch.minimum(bxf[..., 2], tgt_box[..., 2])
        iy2 = torch.minimum(bxf[..., 3], tgt_box[..., 3])
        inter = clip(ix2 - ix1, 0) * clip(iy2 - iy1, 0)
        area_p = clip(bxf[..., 2] - bxf[..., 0], 0) * \
            clip(bxf[..., 3] - bxf[..., 1], 0)
        area_g = clip(tgt_box[..., 2] - tgt_box[..., 0], 0) * \
            clip(tgt_box[..., 3] - tgt_box[..., 1], 0)
        union = area_p + area_g - inter
        iou = inter / clip(union, 1e-9)
        ex1 = torch.minimum(bxf[..., 0], tgt_box[..., 0])
        ey1 = torch.minimum(bxf[..., 1], tgt_box[..., 1])
        ex2 = torch.maximum(bxf[..., 2], tgt_box[..., 2])
        ey2 = torch.maximum(bxf[..., 3], tgt_box[..., 3])
        enclose = clip((ex2 - ex1) * (ey2 - ey1), 1e-9)
        giou = iou - (enclose - union) / enclose
        box_loss = torch.where(is_pos, 1.0 - giou, 0.0).sum() / n_pos
        return cls_loss + 2.0 * box_loss

    return forward_op("detection_loss", impl, args)


def static_nms(boxes, scores, *, top_k: int = 100,
               score_threshold: float = 0.05, iou_threshold: float = 0.6):
    """Single-class static-shape NMS: top-K pre-selection + greedy IoU
    suppression with fixed shapes (the dynamic result count becomes a
    validity mask).

    ``boxes [A, 4]``, ``scores [A]`` ->
    ``(boxes [K, 4], scores [K], keep [K] bool)``; suppressed and
    sub-threshold slots have ``keep=False``.
    """
    def impl(b, s):
        K = min(top_k, s.shape[0])
        top_s, idx = _top_k(s, K)
        top_b = b[idx]
        keep = greedy_keep(pairwise_iou(top_b, 0.0), top_s > score_threshold,
                           iou_threshold)
        return top_b, top_s, keep

    return forward_op("static_nms", impl, [_value(boxes), _value(scores)],
                      differentiable=False)



def _register():
    from ..core.dispatch import register_op
    for n, f in (("static_nms", static_nms),
                 ("detection_loss", detection_loss)):
        register_op(n, f, (f.__doc__ or "").strip().split("\n")[0],
                    public=f)


_register()

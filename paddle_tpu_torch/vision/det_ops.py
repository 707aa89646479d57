"""The legacy detection op family — counterpart of
``paddle_tpu/vision/det_ops.py`` (paddle/fluid/operators/detection/ and
python/paddle/vision/ops.py in Paddle): prior and anchor generation, the
YOLO decode and loss, proposal generation, box clipping and decoding,
IoU, the NMS variants (multiclass greedy, matrix soft-suppression), and
the training-target and sampling half: deformable convolution, the
position-sensitive and precise RoI pools, the SSD matching, mining and
loss, the FPN proposal routing, the R-CNN and RetinaNet target
assigners, and the contrib singles (bilateral slicing, correlation, the
perspective RoI warp).

Every op is static-shape, as the reference's: suppression and selection
give fixed-capacity outputs with validity masks or counts, so the chain
runs inside a captured program and launches the same kernels every
call. The greedy suppression is a loop of K steps over device tensors
(one step a candidate, all images and classes at once) that reads
nothing back to the host. Orders at equal scores are the reference's:
``lax.top_k`` puts the lower index first, and so does a stable
descending ``torch.sort`` (``torch.topk`` promises no order at ties).
Clips are ``torch.maximum`` / ``torch.minimum``, which split the gradient
at a tie as ``jnp.clip`` does (``torch.clamp`` sends all of it).

Two ops run eagerly on the host, as in the reference, because their
upstream outputs are ragged host structures: ``distribute_fpn_proposals``
(per-level lists) and ``bipartite_match`` (a serial argmax chain, and with
it the matching step of ``ssd_loss``). The assigners' sampling quotas are
rank masks over a stable sort, and a scatter that writes one target
twice keeps the last write, as XLA's in-order scatter does
(:func:`_scatter_last`), on the card as on the CPU.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core.dispatch import register_op
from ..core.place import torch_device
from ..ops._helpers import ensure_tensor, forward_op

__all__ = [
    "deform_conv2d", "psroi_pool", "prior_box", "density_prior_box",
    "anchor_generator", "yolo_box", "yolo_loss", "matrix_nms",
    "multiclass_nms", "generate_proposals", "distribute_fpn_proposals",
    "collect_fpn_proposals", "box_clip", "bipartite_match",
    "polygon_box_transform", "iou_similarity", "target_assign",
    "mine_hard_examples", "ssd_loss", "detection_output",
]


def clip(x, lo=None, hi=None):
    """``jnp.clip``: ``minimum(maximum(x, lo), hi)`` with JAX's gradient at
    a tie (half to each side). ``lo`` / ``hi`` are numbers or tensors."""
    if lo is not None:
        x = torch.maximum(x, _full(lo, x))
    if hi is not None:
        x = torch.minimum(x, _full(hi, x))
    return x


def _full(v, like):
    """``v`` as a tensor of ``like``'s dtype and device: a 0-d fill on the
    device (a host-to-device copy could not be captured)."""
    if isinstance(v, torch.Tensor):
        return v.to(like.dtype)
    return torch.full((), v, dtype=like.dtype, device=like.device)


def top_k(s, k):
    """``lax.top_k`` over the last dim: the ``k`` largest, the lower index
    first at equal values."""
    vals, idx = torch.sort(s, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def pairwise_iou(b, off):
    """IoU of every pair of ``b [..., K, 4]`` (xyxy; ``off`` 1 for the
    reference's +1 pixel convention) -> [..., K, K]."""
    x1, y1, x2, y2 = b.unbind(-1)
    area = clip(x2 - x1 + off, 0) * clip(y2 - y1 + off, 0)
    ix1 = torch.maximum(x1[..., :, None], x1[..., None, :])
    iy1 = torch.maximum(y1[..., :, None], y1[..., None, :])
    ix2 = torch.minimum(x2[..., :, None], x2[..., None, :])
    iy2 = torch.minimum(y2[..., :, None], y2[..., None, :])
    inter = clip(ix2 - ix1 + off, 0) * clip(iy2 - iy1 + off, 0)
    return inter / clip(area[..., :, None] + area[..., None, :] - inter, 1e-9)


def greedy_keep(iou, keep, threshold):
    """The reference's ``fori_loop`` greedy suppression over the K
    candidates of ``iou [..., K, K]`` (sorted by score), starting from
    ``keep [..., K]``: a live candidate i kills every later one above
    ``threshold``. K steps on the device, no host read."""
    K = keep.shape[-1]
    later = torch.ones(K, K, dtype=torch.bool, device=iou.device).triu(1)
    sup = (iou > threshold) & later
    for i in range(K):
        keep = keep & ~(sup[..., i, :] & keep[..., i:i + 1])
    return keep


def _priors_out(planes, H, W, P, clip_boxes, variance, dev):
    bx = torch.stack([pl.expand(H, W, P) for pl in planes], -1)
    if clip_boxes:
        bx = clip(bx, 0.0, 1.0)
    var = torch.tensor(variance, dtype=torch.float32,
                       device=dev).expand(H, W, P, 4)
    return bx, var


def prior_box(input, image, min_sizes, max_sizes=None, aspect_ratios=(1.0,),
              variance=(0.1, 0.1, 0.2, 0.2), flip: bool = False,
              clip: bool = False, steps=(0.0, 0.0), offset: float = 0.5,
              min_max_aspect_ratios_order: bool = False, name=None):
    """SSD prior boxes for one feature map (ref: prior_box_op). Returns
    ``(boxes [H, W, P, 4] normalized xyxy, variances [H, W, P, 4])``."""
    ft, it = ensure_tensor(input), ensure_tensor(image)
    H, W = int(ft.shape[2]), int(ft.shape[3])
    IH, IW = int(it.shape[2]), int(it.shape[3])
    sh = steps[1] or IH / H
    sw = steps[0] or IW / W
    ars = [1.0]
    for ar in aspect_ratios:
        if not any(abs(ar - a) < 1e-6 for a in ars):
            ars.append(float(ar))
            if flip:
                ars.append(1.0 / float(ar))
    whs = []
    for ms in min_sizes:
        if min_max_aspect_ratios_order:
            whs.append((ms, ms))
            if max_sizes:
                mx = max_sizes[min_sizes.index(ms)]
                whs.append((math.sqrt(ms * mx), math.sqrt(ms * mx)))
            for ar in ars:
                if abs(ar - 1.0) < 1e-6:
                    continue
                whs.append((ms * math.sqrt(ar), ms / math.sqrt(ar)))
        else:
            for ar in ars:
                whs.append((ms * math.sqrt(ar), ms / math.sqrt(ar)))
            if max_sizes:
                mx = max_sizes[min_sizes.index(ms)]
                whs.append((math.sqrt(ms * mx), math.sqrt(ms * mx)))
    P = len(whs)
    clip_boxes = clip

    def impl():
        dev = torch_device()
        cy = (torch.arange(H, device=dev) + offset) * sh
        cx = (torch.arange(W, device=dev) + offset) * sw
        wh = torch.tensor(whs, dtype=torch.float32, device=dev)
        planes = [(cx[None, :, None] - wh[None, None, :, 0] / 2) / IW,
                  (cy[:, None, None] - wh[None, None, :, 1] / 2) / IH,
                  (cx[None, :, None] + wh[None, None, :, 0] / 2) / IW,
                  (cy[:, None, None] + wh[None, None, :, 1] / 2) / IH]
        return _priors_out(planes, H, W, P, clip_boxes, variance, dev)

    return forward_op("prior_box", impl, [], differentiable=False)


def density_prior_box(input, image, densities, fixed_sizes, fixed_ratios,
                      variance=(0.1, 0.1, 0.2, 0.2), clip: bool = False,
                      steps=(0.0, 0.0), offset: float = 0.5, name=None):
    """Density prior boxes (ref: density_prior_box_op): each fixed size is
    laid out on a density x density sub-grid inside the step cell."""
    ft, it = ensure_tensor(input), ensure_tensor(image)
    H, W = int(ft.shape[2]), int(ft.shape[3])
    IH, IW = int(it.shape[2]), int(it.shape[3])
    sh = steps[1] or IH / H
    sw = steps[0] or IW / W
    priors = []
    for size, dens in zip(fixed_sizes, densities):
        for ratio in fixed_ratios:
            bw = size * math.sqrt(ratio)
            bh = size / math.sqrt(ratio)
            step = 1.0 / dens
            for di in range(dens):
                for dj in range(dens):
                    priors.append(((dj + 0.5) * step - 0.5,
                                   (di + 0.5) * step - 0.5, bw, bh))
    P = len(priors)
    pr_np = np.asarray(priors, np.float32)
    clip_boxes = clip

    def impl():
        dev = torch_device()
        pr = torch.from_numpy(pr_np).to(dev)
        cy = (torch.arange(H, device=dev) + offset) * sh
        cx = (torch.arange(W, device=dev) + offset) * sw
        pcx = cx[None, :, None] + pr[None, None, :, 0] * sw
        pcy = cy[:, None, None] + pr[None, None, :, 1] * sh
        bw = pr[None, None, :, 2]
        bh = pr[None, None, :, 3]
        planes = [(pcx - bw / 2) / IW, (pcy - bh / 2) / IH,
                  (pcx + bw / 2) / IW, (pcy + bh / 2) / IH]
        return _priors_out(planes, H, W, P, clip_boxes, variance, dev)

    return forward_op("density_prior_box", impl, [], differentiable=False)


def anchor_generator(input, anchor_sizes=(64.0,), aspect_ratios=(1.0,),
                     variance=(0.1, 0.1, 0.2, 0.2), stride=(16.0, 16.0),
                     offset: float = 0.5, name=None):
    """Faster-RCNN anchors for one level (ref: anchor_generator_op).
    Returns ``(anchors [H, W, A, 4] xyxy in input pixels, variances)``."""
    ft = ensure_tensor(input)
    H, W = int(ft.shape[2]), int(ft.shape[3])
    sw, sh = float(stride[0]), float(stride[1])
    whs = [(s * math.sqrt(ar), s / math.sqrt(ar))
           for s in anchor_sizes for ar in aspect_ratios]
    A = len(whs)

    def impl():
        dev = torch_device()
        cy = (torch.arange(H, device=dev) + offset) * sh
        cx = (torch.arange(W, device=dev) + offset) * sw
        wh = torch.tensor(whs, dtype=torch.float32, device=dev)
        planes = [cx[None, :, None] - wh[None, None, :, 0] / 2,
                  cy[:, None, None] - wh[None, None, :, 1] / 2,
                  cx[None, :, None] + wh[None, None, :, 0] / 2,
                  cy[:, None, None] + wh[None, None, :, 1] / 2]
        return _priors_out(planes, H, W, A, False, variance, dev)

    return forward_op("anchor_generator", impl, [], differentiable=False)


def yolo_box(x, img_size, anchors, class_num: int, conf_thresh: float = 0.01,
             downsample_ratio: int = 32, clip_bbox: bool = True,
             scale_x_y: float = 1.0, name=None):
    """Decode one YOLOv3 head (ref: yolo_box_op). x [B, A*(5+C), H, W] ->
    ``(boxes [B, H*W*A, 4] xyxy image pixels, scores [B, H*W*A, C])``.
    Sub-threshold predictions get zero boxes and scores (the reference
    zeroes them rather than dropping)."""
    xt, st = ensure_tensor(x), ensure_tensor(img_size)
    A = len(anchors) // 2
    an_np = np.asarray(anchors, np.float32).reshape(A, 2)

    def impl(xv, sz):
        B, _, H, W = xv.shape
        an = torch.from_numpy(an_np).to(xv.device)
        v = xv.reshape(B, A, 5 + class_num, H, W)
        tx, ty, tw, th = v[:, :, 0], v[:, :, 1], v[:, :, 2], v[:, :, 3]
        obj = torch.sigmoid(v[:, :, 4])
        cls = torch.sigmoid(v[:, :, 5:])
        gx = torch.arange(W, device=xv.device)[None, None, None, :]
        gy = torch.arange(H, device=xv.device)[None, None, :, None]
        alpha = scale_x_y
        bxc = (torch.sigmoid(tx) * alpha - 0.5 * (alpha - 1) + gx) / W
        byc = (torch.sigmoid(ty) * alpha - 0.5 * (alpha - 1) + gy) / H
        bw = torch.exp(tw) * an[None, :, 0, None, None] / (W * downsample_ratio)
        bh = torch.exp(th) * an[None, :, 1, None, None] / (H * downsample_ratio)
        imh = sz[:, 0].float()[:, None, None, None]
        imw = sz[:, 1].float()[:, None, None, None]
        x1 = (bxc - bw / 2) * imw
        y1 = (byc - bh / 2) * imh
        x2 = (bxc + bw / 2) * imw
        y2 = (byc + bh / 2) * imh
        if clip_bbox:
            x1, x2 = clip(x1, 0, imw - 1), clip(x2, 0, imw - 1)
            y1, y2 = clip(y1, 0, imh - 1), clip(y2, 0, imh - 1)
        keep = obj > conf_thresh
        boxes = torch.stack([x1, y1, x2, y2], -1) * keep[..., None]
        scores = cls * (obj * keep)[:, :, None]
        boxes = boxes.permute(0, 2, 3, 1, 4).reshape(B, -1, 4)
        scores = scores.permute(0, 3, 4, 1, 2).reshape(B, -1, class_num)
        return boxes, scores

    return forward_op("yolo_box", impl, [xt, st], differentiable=False)


def _select(ds, idx, boxes, keep_top_k):
    """The reference's global merge: ``ds [B, C, K]`` decayed or kept
    scores and ``idx [B, C, K]`` box indices -> ``(out [B, kk, 6],
    index [B, kk], count [B])``, label -1 in the empty slots."""
    B, C, K = ds.shape
    flat = ds.reshape(B, C * K)
    kk = min(keep_top_k, C * K)
    top, fi = top_k(flat, kk)
    cls = torch.div(fi, K, rounding_mode="floor").to(ds.dtype)
    mi = torch.gather(idx.reshape(B, C * K), 1, fi)
    bsel = torch.gather(boxes, 1, mi[..., None].expand(B, kk, 4))
    valid = top > 0
    out = torch.cat([torch.where(valid, cls, -1.0)[..., None],
                     top[..., None], bsel], -1)
    return out, torch.where(valid, mi, -1), valid.sum(-1)


def _class_candidates(bv, sv, nms_top_k):
    """Each class's ``K = min(nms_top_k, M)`` best candidates: scores
    ``[B, C, K]``, box indices ``[B, C, K]`` and boxes ``[B, C, K, 4]``."""
    B, C, M = sv.shape
    K = min(nms_top_k, M)
    top_s, idx = top_k(sv, K)
    tb = torch.gather(bv[:, None].expand(B, C, M, 4), 2,
                      idx[..., None].expand(B, C, K, 4))
    return top_s, idx, tb


def matrix_nms(bboxes, scores, score_threshold: float = 0.05,
               post_threshold: float = 0.0, nms_top_k: int = 100,
               keep_top_k: int = 100, use_gaussian: bool = False,
               gaussian_sigma: float = 2.0, normalized: bool = True,
               name=None):
    """Matrix NMS (ref: matrix_nms_op, SOLOv2): each score decays by its
    worst overlap with a higher-scored box of its class — a dense
    [K, K] min-reduction with no sequential dependency.

    ``bboxes [B, M, 4]``, ``scores [B, C, M]`` ->
    ``(out [B, keep_top_k, 6] (label, score, x1, y1, x2, y2),
    index [B, keep_top_k], count [B])``, label -1 in the empty slots."""
    off = 0.0 if normalized else 1.0

    def impl(bv, sv):
        top_s, idx, tb = _class_candidates(bv, sv, nms_top_k)
        K = top_s.shape[-1]
        iou = pairwise_iou(tb, off)
        upper = torch.tril(iou, -1)               # iou[i, j] for j < i
        comp = upper.amax(-1)                     # each one's worst overlap
        if use_gaussian:
            dec = torch.exp(-(upper ** 2 - comp[..., None, :] ** 2)
                            * gaussian_sigma)
        else:
            dec = (1 - upper) / clip(1 - comp[..., None, :], 1e-9)
        lower = torch.ones(K, K, dtype=torch.bool, device=iou.device).tril(-1)
        decay = torch.where(lower, dec, float("inf")).amin(-1)
        first = torch.arange(K, device=iou.device) == 0
        decay = torch.where(first, 1.0, decay)
        ds = top_s * decay * (top_s > score_threshold)
        if post_threshold > 0:
            ds = ds * (ds > post_threshold)
        return _select(ds, idx, bv, keep_top_k)

    return forward_op("matrix_nms", impl,
                      [ensure_tensor(bboxes), ensure_tensor(scores)],
                      differentiable=False)


def multiclass_nms(bboxes, scores, score_threshold: float = 0.05,
                   nms_top_k: int = 100, keep_top_k: int = 100,
                   nms_threshold: float = 0.3, normalized: bool = True,
                   background_label: int = -1, name=None):
    """Multiclass greedy NMS (ref: multiclass_nms_op): per-class greedy
    suppression, then a global keep_top_k merge; all shapes fixed
    ([B, keep_top_k, 6] + counts, label -1 in the empty slots), the
    greedy pass one loop over the K candidates for every image and class
    at once.

    ``bboxes [B, M, 4]``, ``scores [B, C, M]`` ->
    ``(out [B, keep_top_k, 6], index [B, keep_top_k], count [B])``."""
    off = 0.0 if normalized else 1.0

    def impl(bv, sv):
        top_s, idx, tb = _class_candidates(bv, sv, nms_top_k)
        keep = greedy_keep(pairwise_iou(tb, off), top_s > score_threshold,
                           nms_threshold)
        ds = torch.where(keep, top_s, 0.0)
        if background_label >= 0:
            bg = torch.arange(ds.shape[1], device=ds.device) == \
                background_label
            ds = torch.where(bg[None, :, None], 0.0, ds)
        return _select(ds, idx, bv, keep_top_k)

    return forward_op("multiclass_nms", impl,
                      [ensure_tensor(bboxes), ensure_tensor(scores)],
                      differentiable=False)


def _decode_rcnn(anchors, deltas, variances=None):
    aw = anchors[..., 2] - anchors[..., 0] + 1.0
    ah = anchors[..., 3] - anchors[..., 1] + 1.0
    acx = anchors[..., 0] + aw / 2
    acy = anchors[..., 1] + ah / 2
    if variances is not None:
        deltas = deltas * variances
    dcx = acx + deltas[..., 0] * aw
    dcy = acy + deltas[..., 1] * ah
    dw = aw * torch.exp(clip(deltas[..., 2], -10, 4.135))
    dh = ah * torch.exp(clip(deltas[..., 3], -10, 4.135))
    return torch.stack([dcx - dw / 2, dcy - dh / 2,
                        dcx + dw / 2 - 1, dcy + dh / 2 - 1], -1)


def generate_proposals(scores, bbox_deltas, im_shape, anchors, variances=None,
                       pre_nms_top_n: int = 6000, post_nms_top_n: int = 1000,
                       nms_thresh: float = 0.5, min_size: float = 0.1,
                       eta: float = 1.0, name=None):
    """RPN proposal generation (ref: generate_proposals_v2_op): decode the
    anchors with the deltas, clip to the image, drop tiny boxes, pre-NMS
    top-k, greedy NMS, post-NMS top-k. Static shapes (a drop zeroes the
    score); returns ``(rois [B, post_nms_top_n, 4], roi_scores [B,
    post_nms_top_n], count [B])``."""
    args = [ensure_tensor(scores), ensure_tensor(bbox_deltas),
            ensure_tensor(im_shape), ensure_tensor(anchors)]
    if variances is not None:
        args.append(ensure_tensor(variances))

    def impl(sv, dv, iv, av, *var):
        B, A, H, W = sv.shape
        N = A * H * W
        anc = av.reshape(N, 4)
        vv = var[0].reshape(N, 4) if var else None
        s = sv.permute(0, 2, 3, 1).reshape(B, N)             # HWA order
        d = dv.reshape(B, A, 4, H, W).permute(0, 3, 4, 1, 2).reshape(B, N, 4)
        K = min(pre_nms_top_n, N)
        top_s, idx = top_k(s, K)
        take = idx[..., None].expand(B, K, 4)
        boxes = _decode_rcnn(anc[idx], torch.gather(d, 1, take),
                             None if vv is None else vv[idx])
        h, w = iv[:, 0, None], iv[:, 1, None]
        boxes = torch.stack([clip(boxes[..., 0], 0, w - 1),
                             clip(boxes[..., 1], 0, h - 1),
                             clip(boxes[..., 2], 0, w - 1),
                             clip(boxes[..., 3], 0, h - 1)], -1)
        bw = boxes[..., 2] - boxes[..., 0] + 1
        bh = boxes[..., 3] - boxes[..., 1] + 1
        ok = (bw >= min_size) & (bh >= min_size)
        top_s = torch.where(ok, top_s, 0.0)
        keep = greedy_keep(pairwise_iou(boxes, 1.0), top_s > 0, nms_thresh)
        kept_s = torch.where(keep, top_s, 0.0)
        P = min(post_nms_top_n, K)
        fs, fi = top_k(kept_s, P)
        rois = torch.gather(boxes, 1, fi[..., None].expand(B, P, 4))
        return rois, fs, (fs > 0).sum(-1)

    return forward_op("generate_proposals", impl, args, differentiable=False)


def box_clip(input, im_info, name=None):
    """Clip boxes to the image (ref: box_clip_op). ``im_info`` rows are
    (h, w, scale); boxes clip to [0, dim/scale - 1]."""
    def impl(bv, iv):
        h = iv[..., 0] / iv[..., 2] - 1
        w = iv[..., 1] / iv[..., 2] - 1
        if bv.ndim == 2:
            hh = h[0] if h.ndim else h
            ww = w[0] if w.ndim else w
        else:
            hh, ww = h[:, None], w[:, None]
        return torch.stack([clip(bv[..., 0], 0, ww), clip(bv[..., 1], 0, hh),
                            clip(bv[..., 2], 0, ww), clip(bv[..., 3], 0, hh)],
                           -1)

    return forward_op("box_clip", impl,
                      [ensure_tensor(input), ensure_tensor(im_info)])


def iou_similarity(x, y, box_normalized: bool = True, name=None):
    """Pairwise IoU matrix [N, M] (ref: iou_similarity_op, the SSD
    matching metric), with the reference's +1 convention for unnormalized
    boxes."""
    off = 0.0 if box_normalized else 1.0

    def impl(a, b):
        area1 = clip(a[:, 2] - a[:, 0] + off, 0) * \
            clip(a[:, 3] - a[:, 1] + off, 0)
        area2 = clip(b[:, 2] - b[:, 0] + off, 0) * \
            clip(b[:, 3] - b[:, 1] + off, 0)
        lt = torch.maximum(a[:, None, :2], b[None, :, :2])
        rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
        wh = clip(rb - lt + off, 0)
        inter = wh[..., 0] * wh[..., 1]
        return inter / clip(area1[:, None] + area2[None] - inter, 1e-10)

    return forward_op("iou_similarity", impl,
                      [ensure_tensor(x), ensure_tensor(y)])


def polygon_box_transform(input, name=None):
    """Quad-offset -> corner-coordinate transform for EAST-style OCR heads
    (ref: polygon_box_transform_op): channel 2k holds x offsets, 2k+1 y
    offsets; the lattice coordinates (x4) minus each non-zero entry."""
    def impl(iv):
        B, C, H, W = iv.shape
        dev = iv.device
        gx = torch.arange(W, device=dev)[None, None, None, :] * 4.0
        gy = torch.arange(H, device=dev)[None, None, :, None] * 4.0
        is_x = (torch.arange(C, device=dev) % 2 == 0)[None, :, None, None]
        base = torch.where(is_x, gx, gy).to(iv.dtype)
        return torch.where(iv != 0, base - iv, iv)

    return forward_op("polygon_box_transform", impl, [ensure_tensor(input)],
                      differentiable=False)


def box_decoder_and_assign(prior_box_t, prior_box_var, target_box,
                           box_score, box_clip_v: float = 4.135, name=None):
    """Decode per-class box deltas, then take each RoI's best-class box
    (ref: box_decoder_and_assign_op). ``target_box [R, C*4]``,
    ``box_score [R, C]``; returns (decoded [R, C*4], assigned [R, 4])."""
    def impl(pv, vv, tv, sv):
        R, C = pv.shape[0], sv.shape[1]
        pw = pv[:, 2] - pv[:, 0] + 1
        ph_ = pv[:, 3] - pv[:, 1] + 1
        pcx = pv[:, 0] + pw / 2
        pcy = pv[:, 1] + ph_ / 2
        d = tv.reshape(R, C, 4) * vv.reshape(R, 1, 4)
        dcx = pcx[:, None] + d[..., 0] * pw[:, None]
        dcy = pcy[:, None] + d[..., 1] * ph_[:, None]
        dw = pw[:, None] * torch.exp(clip(d[..., 2], -box_clip_v, box_clip_v))
        dh = ph_[:, None] * torch.exp(clip(d[..., 3], -box_clip_v,
                                           box_clip_v))
        dec = torch.stack([dcx - dw / 2, dcy - dh / 2,
                           dcx + dw / 2 - 1, dcy + dh / 2 - 1], -1)
        best = sv.argmax(1)
        assigned = dec[torch.arange(R, device=dec.device), best]
        return dec.reshape(R, C * 4), assigned

    return forward_op("box_decoder_and_assign", impl,
                      [ensure_tensor(a) for a in (prior_box_t, prior_box_var,
                                                  target_box, box_score)],
                      differentiable=False)




# ---------------------------------------------------------------------------
# the training-target and sampling half
# ---------------------------------------------------------------------------

def _scatter_last(shape, idx, vals, fill):
    """A tensor of ``shape`` filled with ``fill``, with ``vals`` written at
    the flat indices ``idx``; where an index repeats, the LAST write wins,
    as XLA's in-order scatter does. Every write but the last to a target
    goes to one spare slot past the end, dropped after the write, so the
    result does not depend on the order a device applies the writes in."""
    n = int(np.prod(shape))
    idx, vals = idx.reshape(-1), vals.reshape(-1)
    E = idx.shape[0]
    later = torch.ones(E, E, dtype=torch.bool, device=idx.device).triu(1)
    shadowed = ((idx[:, None] == idx[None, :]) & later).any(1)
    tgt = torch.where(shadowed, torch.full_like(idx, n), idx)
    out = torch.full((n + 1,), fill, dtype=vals.dtype, device=vals.device)
    return out.index_put((tgt,), vals)[:n].reshape(shape)


def _pair(v):
    return (int(v), int(v)) if isinstance(v, (int, np.integer)) else \
        tuple(int(a) for a in v)


def deform_conv2d(x, offset, weight, bias=None, stride=1, padding=0,
                  dilation=1, deformable_groups: int = 1, groups: int = 1,
                  mask=None, name=None):
    """Deformable convolution v1/v2 (ref: paddle.vision.ops.deform_conv2d,
    deformable_conv_op): the offsets shift a bilinear sampling grid, the
    taps are one gather over [B, C, H*W], and the convolution is one
    einsum over the sampled taps. ``mask`` (v2 modulation) scales them.

    Shapes: x [B, Cin, H, W]; offset [B, 2*dg*kh*kw, OH, OW];
    mask [B, dg*kh*kw, OH, OW]; weight [Cout, Cin//groups, kh, kw].
    """
    sh, sw = _pair(stride)
    ph, pw = _pair(padding)
    dh, dw = _pair(dilation)
    args = [ensure_tensor(x), ensure_tensor(offset), ensure_tensor(weight)]
    if mask is not None:
        args.append(ensure_tensor(mask))
    if bias is not None:
        args.append(ensure_tensor(bias))

    def impl(xv, ov, wv, *rest):
        mv = rest[0] if mask is not None else None
        bv = rest[-1] if bias is not None else None
        B, C, H, W = xv.shape
        Cout, Cg, kh, kw = wv.shape
        OH, OW = ov.shape[2], ov.shape[3]
        dg = deformable_groups
        K = kh * kw
        dev = xv.device
        oy = torch.arange(OH, device=dev) * sh - ph
        ox = torch.arange(OW, device=dev) * sw - pw
        ky = torch.arange(kh, device=dev) * dh
        kx = torch.arange(kw, device=dev) * dw
        base_y = (oy[:, None, None, None] + ky[None, None, :, None]).expand(
            OH, OW, kh, kw).to(torch.float32)
        base_x = (ox[None, :, None, None] + kx[None, None, None, :]).expand(
            OH, OW, kh, kw).to(torch.float32)
        # offsets: [B, dg, K, 2, OH, OW], (dy, dx) interleaved
        off = ov.reshape(B, dg, K, 2, OH, OW)
        dy = off[:, :, :, 0].permute(0, 3, 4, 1, 2)      # [B, OH, OW, dg, K]
        dx = off[:, :, :, 1].permute(0, 3, 4, 1, 2)
        sy = base_y.reshape(1, OH, OW, 1, K) + dy
        sx = base_x.reshape(1, OH, OW, 1, K) + dx
        y0, x0 = torch.floor(sy), torch.floor(sx)
        wy, wx = sy - y0, sx - x0
        inside = (sy > -1) & (sy < H) & (sx > -1) & (sx < W)
        flat = xv.reshape(B, C, H * W)

        def tap(yi, xi):
            ok = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
            yc = clip(yi, 0, H - 1).long()
            xc = clip(xi, 0, W - 1).long()
            lin = (yc * W + xc).reshape(B, 1, -1).expand(B, C, -1)
            g = torch.gather(flat, 2, lin).reshape(B, C, OH, OW, dg, K)
            return torch.where(ok.reshape(B, 1, OH, OW, dg, K), g,
                               g.new_zeros(()))

        v = (tap(y0, x0) * ((1 - wy) * (1 - wx))[:, None]
             + tap(y0, x0 + 1) * ((1 - wy) * wx)[:, None]
             + tap(y0 + 1, x0) * (wy * (1 - wx))[:, None]
             + tap(y0 + 1, x0 + 1) * (wy * wx)[:, None])
        v = torch.where(inside[:, None], v, v.new_zeros(()))  # [B,C,OH,OW,dg,K]
        if mv is not None:
            mm = mv.reshape(B, dg, K, OH, OW).permute(0, 3, 4, 1, 2)
            v = v * mm[:, None]
        # each channel samples with its own deformable group's offsets
        v = v.reshape(B, dg, C // dg, OH, OW, dg, K)
        v = torch.stack([v[:, g_, :, :, :, g_] for g_ in range(dg)], 1)
        v = v.reshape(B, groups, C // groups, OH, OW, K)
        wg = wv.reshape(groups, Cout // groups, Cg, K)
        out = torch.einsum("bgchwk,gock->bgohw", v, wg).reshape(
            B, Cout, OH, OW)
        return out + bv.reshape(1, -1, 1, 1) if bv is not None else out

    return forward_op("deform_conv2d", impl, args)


def psroi_pool(x, boxes, boxes_num=None, output_size=7,
               spatial_scale: float = 1.0, name=None):
    """Position-sensitive RoI average pooling (ref:
    paddle.vision.ops.psroi_pool / psroi_pool_op, R-FCN). Input channels
    ``C = out_c * ph * pw``; output bin (i, j) pools its own channel group.
    Bin membership is a mask over the whole feature map, one masked mean a
    bin by einsum. As in the reference, every RoI pools image 0 and
    ``boxes_num`` is not read."""
    ph_, pw_ = _pair(output_size)

    def impl(xv, bv):
        _, C, H, W = xv.shape
        dev = xv.device
        oc = C // (ph_ * pw_)
        x1, y1, x2, y2 = (bv[:, i] * spatial_scale for i in range(4))
        bw = torch.maximum(x2 - x1, _full(0.1, x2))
        bh = torch.maximum(y2 - y1, _full(0.1, y2))
        ys = y1[:, None] + bh[:, None] * torch.arange(
            ph_ + 1, device=dev) / ph_
        xs = x1[:, None] + bw[:, None] * torch.arange(
            pw_ + 1, device=dev) / pw_
        gy = torch.arange(H, device=dev)[None, None, :] + 0.0
        gx = torch.arange(W, device=dev)[None, None, :] + 0.0
        my = ((gy >= torch.floor(ys[:, :-1, None])) &
              (gy < torch.ceil(ys[:, 1:, None])))           # [n, ph, H]
        mx = ((gx >= torch.floor(xs[:, :-1, None])) &
              (gx < torch.ceil(xs[:, 1:, None])))           # [n, pw, W]
        cnt = my.sum(-1)[:, :, None] * mx.sum(-1)[:, None, :]
        feat = xv[0].reshape(oc, ph_, pw_, H, W)
        pooled = torch.einsum("cijhw,nih,njw->ncij", feat, my.to(xv.dtype),
                              mx.to(xv.dtype))
        return pooled / cnt[:, None].clamp(min=1)

    return forward_op("psroi_pool", impl,
                      [ensure_tensor(x), ensure_tensor(boxes)])


def yolo_loss(x, gt_box, gt_label, anchors, anchor_mask, class_num: int,
              ignore_thresh: float = 0.7, downsample_ratio: int = 32,
              use_label_smooth: bool = False, name=None):
    """YOLOv3 loss for one head (ref: yolov3_loss_op). The responsible
    anchor of each gt (best IoU over the full anchor set) and the
    objectness ignore mask are computed on the device with a static
    [B, G] gt capacity (zero-area gts are padding); the targets are
    scattered onto the [B, A, H, W] lattice. Returns the summed loss per
    batch element [B]."""
    A_all = np.asarray(anchors, np.float32).reshape(-1, 2)
    amask = list(anchor_mask)
    A = len(amask)
    an_np = A_all[amask]

    def impl(xv, gbv, glv):
        B, _, H, W = xv.shape
        dev = xv.device
        in_w, in_h = W * downsample_ratio, H * downsample_ratio
        v = xv.reshape(B, A, 5 + class_num, H, W)
        tx, ty, tw, th = v[:, :, 0], v[:, :, 1], v[:, :, 2], v[:, :, 3]
        tobj = v[:, :, 4]
        tcls = v[:, :, 5:].permute(0, 1, 3, 4, 2)          # [B, A, H, W, C]
        G = gbv.shape[1]
        gt_valid = (gbv[..., 2] > 0) & (gbv[..., 3] > 0)   # [B, G]
        a_all = torch.from_numpy(A_all).to(dev)
        an = torch.from_numpy(an_np).to(dev)
        # which anchor (over the full anchor set) best matches each gt
        gw = gbv[..., 2] * in_w
        gh = gbv[..., 3] * in_h
        aw, ah = a_all[None, None, :, 0], a_all[None, None, :, 1]
        inter = (torch.minimum(gw[..., None], aw) *
                 torch.minimum(gh[..., None], ah))
        iou_wh = inter / (gw[..., None] * gh[..., None] + aw * ah - inter
                          + 1e-9)
        best = torch.argmax(iou_wh, -1)                     # [B, G]
        hit = best[..., None] == torch.tensor(amask, device=dev)
        local = torch.argmax(hit.to(torch.int32), -1)
        resp = gt_valid & hit.any(-1)                       # [B, G]
        gi = clip((gbv[..., 0] * W).to(torch.int32), 0, W - 1).long()
        gj = clip((gbv[..., 1] * H).to(torch.int32), 0, H - 1).long()
        b_idx = torch.arange(B, device=dev)[:, None].expand(B, G)
        cell = ((b_idx * A + local) * H + gj) * W + gi      # [B, G]

        def scat(val, fill=0.0):
            val = val.to(torch.float32)
            return _scatter_last((B, A, H, W), cell, torch.where(
                resp, val, torch.full_like(val, fill)), fill)

        obj_tgt = scat(torch.ones((B, G), device=dev))
        txt = scat(gbv[..., 0] * W - gi)
        tyt = scat(gbv[..., 1] * H - gj)
        awm, ahm = an[local][..., 0], an[local][..., 1]
        tiny = _full(1e-9, gw)
        twt = scat(torch.log(torch.maximum(gw, tiny) /
                             torch.maximum(awm, tiny)))
        tht = scat(torch.log(torch.maximum(gh, tiny) /
                             torch.maximum(ahm, tiny)))
        box_scale = scat(2.0 - gbv[..., 2] * gbv[..., 3])
        cls_idx = cell * class_num + clip(glv, 0, class_num - 1).long()
        cls_t = _scatter_last((B, A, H, W, class_num), cls_idx,
                              resp.to(torch.float32), 0.0)
        if use_label_smooth:
            delta = 1.0 / class_num
            cls_t = cls_t * (1 - delta) + delta / class_num
        # ignore mask: predictions whose best IoU with any gt > thresh
        gx_ = torch.arange(W, device=dev)[None, None, None, :]
        gy_ = torch.arange(H, device=dev)[None, None, :, None]
        pxc = (torch.sigmoid(tx) + gx_) / W
        pyc = (torch.sigmoid(ty) + gy_) / H
        pw = torch.exp(clip(tw, -10, 10)) * an[None, :, 0, None, None] / in_w
        ph_ = torch.exp(clip(th, -10, 10)) * an[None, :, 1, None, None] / in_h
        px1, py1 = pxc - pw / 2, pyc - ph_ / 2
        px2, py2 = pxc + pw / 2, pyc + ph_ / 2
        g5 = lambda t: t[:, None, None, None, :]            # noqa: E731
        gx1 = g5(gbv[..., 0] - gbv[..., 2] / 2)
        gy1 = g5(gbv[..., 1] - gbv[..., 3] / 2)
        gx2 = g5(gbv[..., 0] + gbv[..., 2] / 2)
        gy2 = g5(gbv[..., 1] + gbv[..., 3] / 2)
        ix1 = torch.maximum(px1[..., None], gx1)
        iy1 = torch.maximum(py1[..., None], gy1)
        ix2 = torch.minimum(px2[..., None], gx2)
        iy2 = torch.minimum(py2[..., None], gy2)
        inter2 = clip(ix2 - ix1, 0) * clip(iy2 - iy1, 0)
        pa = pw * ph_
        ga = g5(gbv[..., 2] * gbv[..., 3])
        iou = inter2 / clip(pa[..., None] + ga - inter2, 1e-9)
        iou = torch.where(g5(gt_valid), iou, iou.new_zeros(()))
        ignore = (iou.max(-1)[0] > ignore_thresh) & (obj_tgt < 0.5)

        def bce(logit, tgt):
            return (torch.maximum(logit, logit.new_zeros(())) - logit * tgt
                    + torch.log1p(torch.exp(-logit.abs())))

        pos = (obj_tgt > 0.5).to(xv.dtype)
        loss_xy = (bce(tx, txt) + bce(ty, tyt)) * box_scale * pos
        loss_wh = ((tw - twt).abs() + (th - tht).abs()) * box_scale * pos
        loss_obj = bce(tobj, obj_tgt) * (~ignore).to(xv.dtype)
        loss_cls = (bce(tcls, cls_t) * pos[..., None]).sum(-1)
        return (loss_xy + loss_wh + loss_obj + loss_cls).sum((1, 2, 3))

    return forward_op("yolo_loss", impl, [ensure_tensor(x),
                                          ensure_tensor(gt_box),
                                          ensure_tensor(gt_label)])


def distribute_fpn_proposals(fpn_rois, min_level: int, max_level: int,
                             refer_level: int, refer_scale: int,
                             rois_num=None, name=None):
    """Assign RoIs to FPN levels by scale (ref:
    distribute_fpn_proposals_op): level = refer + floor(log2(sqrt(area) /
    refer_scale)). The upstream output is a ragged per-level list, so this
    op runs EAGERLY on the host, as in the reference; returns (list of
    per-level RoI Tensors, restore_index)."""
    from ..core.tensor import to_tensor
    rt = ensure_tensor(fpn_rois)
    rv = rt.numpy()
    w = rv[:, 2] - rv[:, 0]
    h = rv[:, 3] - rv[:, 1]
    scale = np.sqrt(np.clip(w * h, 0, None))
    lvl = np.floor(np.log2(scale / refer_scale + 1e-8)) + refer_level
    lvl = np.clip(lvl, min_level, max_level).astype(np.int64)
    dev = rt._value.device
    outs, order = [], []
    for L in range(min_level, max_level + 1):
        idx = np.nonzero(lvl == L)[0]
        outs.append(to_tensor(rv[idx], place=dev))
        order.append(idx)
    order = np.concatenate(order) if order else np.zeros((0,), np.int64)
    restore = np.empty_like(order)
    restore[order] = np.arange(order.shape[0])
    return outs, to_tensor(restore.astype(np.int64), place=dev)


def collect_fpn_proposals(multi_rois, multi_scores, post_nms_top_n: int,
                          name=None):
    """Merge per-level RPN outputs and keep the global top-n by score (ref:
    collect_fpn_proposals_op): inputs are fixed-capacity per level; one
    concat and a stable top-k."""
    rts = [ensure_tensor(r) for r in multi_rois]
    sts = [ensure_tensor(s) for s in multi_scores]
    k = len(rts)

    def impl(*vals):
        rois = torch.cat(vals[:k], 0)
        scores = torch.cat(vals[k:], 0)
        top, idx = top_k(scores, min(post_nms_top_n, scores.shape[0]))
        return rois[idx], top

    return forward_op("collect_fpn_proposals", impl, rts + sts,
                      differentiable=False)


def bipartite_match(dist_matrix, match_type: str = "bipartite",
                    dist_threshold: float = 0.5, name=None):
    """Greedy bipartite matching (ref: bipartite_match_op, the SSD
    matcher): repeatedly take the globally largest entry and retire its
    row and column. The argmax chain is serial and the outputs are index
    tables, so this runs EAGERLY on the host, as in the reference;
    ``per_prediction`` also matches every column whose best row reaches
    ``dist_threshold``. Returns ``(match_indices [C] column -> row,
    match_dist [C])`` for one [R, C] matrix."""
    from ..core.tensor import to_tensor
    dt = ensure_tensor(dist_matrix)
    d = dt.numpy().astype(np.float64)
    R, C = d.shape
    match = -np.ones(C, np.int64)
    dist = np.zeros(C, np.float64)
    work = d.copy()
    for _ in range(min(R, C)):
        i, j = np.unravel_index(np.argmax(work), work.shape)
        if work[i, j] <= 0:
            break
        match[j] = i
        dist[j] = work[i, j]
        work[i, :] = -1
        work[:, j] = -1
    if match_type == "per_prediction":
        for j in range(C):
            if match[j] < 0:
                i = int(np.argmax(d[:, j]))
                if d[i, j] >= dist_threshold:
                    match[j] = i
                    dist[j] = d[i, j]
    dev = dt._value.device
    return (to_tensor(match, place=dev),
            to_tensor(dist.astype(np.float32), place=dev))


def target_assign(input, matched_indices, negative_indices=None,
                  mismatch_value: float = 0.0, name=None):
    """Gather per-prior targets by match index (ref: target_assign_op):
    out[j] = input[matched_indices[j]]; a mismatched slot gets
    ``mismatch_value`` and weight 0. Returns (out, out_weight)."""
    def impl(iv, mv):
        out = iv[mv.clamp(0, iv.shape[0] - 1).long()]
        ok = (mv >= 0).reshape((-1,) + (1,) * (out.dim() - 1))
        out = torch.where(ok, out, torch.full_like(out, mismatch_value))
        return out, ok.to(torch.float32)

    return forward_op("target_assign", impl,
                      [ensure_tensor(input), ensure_tensor(matched_indices)],
                      differentiable=False)


def _rank(v):
    """Each entry's position in a stable ascending sort of ``v``."""
    order = torch.sort(v, stable=True)[1]
    return torch.sort(order, stable=True)[1]


def mine_hard_examples(cls_loss, match_indices, neg_pos_ratio: float = 3.0,
                       neg_dist_threshold: float = 0.5,
                       sample_size=None, mining_type: str = "max_negative",
                       name=None):
    """SSD hard-negative mining (ref: mine_hard_examples_op): keep the
    highest-loss unmatched priors, up to ``neg_pos_ratio`` times the
    positive count. A stable sort and a rank threshold give a [N] bool
    mask (fixed shape) in place of the reference's ragged index list."""
    def impl(lv, mv):
        pos = mv >= 0
        n_pos = pos.sum()
        cap = (neg_pos_ratio * n_pos).to(torch.int32) if sample_size is None \
            else torch.full((), int(sample_size), dtype=torch.int32,
                            device=lv.device)
        neg_loss = torch.where(pos, torch.full_like(lv, -float("inf")), lv)
        return (~pos) & (_rank(-neg_loss) < cap) & torch.isfinite(neg_loss)

    return forward_op("mine_hard_examples", impl,
                      [ensure_tensor(cls_loss), ensure_tensor(match_indices)],
                      differentiable=False)


def ssd_loss(location, confidence, gt_box, gt_label, prior_box_t,
             prior_box_var=None, neg_pos_ratio: float = 3.0,
             background_label: int = 0, loc_loss_weight: float = 1.0,
             conf_loss_weight: float = 1.0, name=None):
    """SSD multibox loss (ref: ssd_loss_op), composed from the family's own
    pieces: IoU match (the host's bipartite match) -> target assign ->
    smooth-L1 location loss + softmax confidence loss over the positives
    and the mined hard negatives. One scalar out."""
    loc, conf = ensure_tensor(location), ensure_tensor(confidence)
    gb, gl = ensure_tensor(gt_box), ensure_tensor(gt_label)
    pb = ensure_tensor(prior_box_t)
    match, _ = bipartite_match(iou_similarity(gb, pb), "per_prediction", 0.5)

    def impl(locv, confv, gbv, glv, pbv, mv):
        pos = mv >= 0
        safe = mv.clamp(0, gbv.shape[0] - 1).long()
        tgt = gbv[safe]
        pw = pbv[:, 2] - pbv[:, 0]
        ph_ = pbv[:, 3] - pbv[:, 1]
        pcx = (pbv[:, 0] + pbv[:, 2]) / 2
        pcy = (pbv[:, 1] + pbv[:, 3]) / 2
        tiny = _full(1e-6, pw)
        gw = torch.maximum(tgt[:, 2] - tgt[:, 0], tiny)
        gh = torch.maximum(tgt[:, 3] - tgt[:, 1], tiny)
        gcx = (tgt[:, 0] + tgt[:, 2]) / 2
        gcy = (tgt[:, 1] + tgt[:, 3]) / 2
        enc = torch.stack([(gcx - pcx) / pw / 0.1, (gcy - pcy) / ph_ / 0.1,
                           torch.log(gw / pw) / 0.2,
                           torch.log(gh / ph_) / 0.2], -1)
        diff = locv - enc
        l1 = torch.where(diff.abs() < 1, 0.5 * diff ** 2,
                         diff.abs() - 0.5).sum(-1)
        n_pos = pos.sum().clamp(min=1)
        # a select, not a product: a prior with no area encodes to NaN,
        # and only the matched priors count (the reference's XLA program
        # drops those rows as well)
        loc_loss = torch.where(pos, l1, l1.new_zeros(())).sum() / n_pos
        labels = torch.where(pos, glv[safe].long(),
                             torch.full_like(safe, background_label))
        ce = -torch.gather(torch.log_softmax(confv, -1), 1,
                           labels[:, None])[:, 0]
        neg_loss = torch.where(pos, torch.full_like(ce, -float("inf")), ce)
        hard_neg = (~pos) & (_rank(-neg_loss) <
                             (neg_pos_ratio * pos.sum()).to(torch.int32))
        conf_loss = (ce * (pos | hard_neg)).sum() / n_pos
        return loc_loss_weight * loc_loss + conf_loss_weight * conf_loss

    return forward_op("ssd_loss", impl, [loc, conf, gb, gl, pb, match])


def detection_output(loc, scores, prior_box_t, prior_box_var=None,
                     background_label: int = 0, nms_threshold: float = 0.3,
                     nms_top_k: int = 400, keep_top_k: int = 200,
                     score_threshold: float = 0.01, name=None):
    """SSD inference head (ref: detection_output_op): decode the priors
    with the predicted deltas, then multiclass NMS. ``loc [B, P, 4]``,
    ``scores [B, P, C]``, priors [P, 4] (+var [P, 4]); returns the
    multiclass_nms triple."""
    args = [ensure_tensor(loc), ensure_tensor(scores),
            ensure_tensor(prior_box_t)]
    if prior_box_var is not None:
        args.append(ensure_tensor(prior_box_var))

    def impl(lv, sv, pv, *vv):
        pw = pv[:, 2] - pv[:, 0]
        ph_ = pv[:, 3] - pv[:, 1]
        pcx = (pv[:, 0] + pv[:, 2]) / 2
        pcy = (pv[:, 1] + pv[:, 3]) / 2
        v = vv[0] if vv else torch.tensor([0.1, 0.1, 0.2, 0.2],
                                          dtype=lv.dtype, device=lv.device)
        dcx = pcx + lv[..., 0] * v[..., 0] * pw
        dcy = pcy + lv[..., 1] * v[..., 1] * ph_
        dw = pw * torch.exp(clip(lv[..., 2] * v[..., 2], -10, 10))
        dh = ph_ * torch.exp(clip(lv[..., 3] * v[..., 3], -10, 10))
        boxes = torch.stack([dcx - dw / 2, dcy - dh / 2,
                             dcx + dw / 2, dcy + dh / 2], -1)
        return boxes, sv.permute(0, 2, 1)

    boxes, sc = forward_op("detection_output", impl, args,
                           differentiable=False)
    return multiclass_nms(boxes, sc, score_threshold=score_threshold,
                          nms_top_k=nms_top_k, keep_top_k=keep_top_k,
                          nms_threshold=nms_threshold,
                          background_label=background_label)


for _n in __all__:
    _f = globals()[_n]
    register_op(_n, _f, (_f.__doc__ or "").strip().split("\n")[0].rstrip(","),
                public=_f)


def prroi_pool(x, boxes, output_size=7, spatial_scale: float = 1.0,
               name=None):
    """Precise RoI pooling (ref: prroi_pool_op): each bin's integral of the
    piecewise-constant surface, from each pixel cell's fractional overlap
    with the bin, one einsum. As in the reference, every RoI pools image
    0."""
    ph_, pw_ = _pair(output_size)

    def impl(xv, bv):
        _, _, H, W = xv.shape
        dev = xv.device
        x1, y1, x2, y2 = (bv[:, i] * spatial_scale for i in range(4))
        bw = torch.maximum(x2 - x1, _full(1e-4, x2))
        bh = torch.maximum(y2 - y1, _full(1e-4, y2))
        ys = y1[:, None] + bh[:, None] * torch.arange(
            ph_ + 1, device=dev) / ph_
        xs = x1[:, None] + bw[:, None] * torch.arange(
            pw_ + 1, device=dev) / pw_
        gy = torch.arange(H, device=dev)[None, None, :]
        gx = torch.arange(W, device=dev)[None, None, :]
        oy = clip(torch.minimum(ys[:, 1:, None], gy + 1) -
                  torch.maximum(ys[:, :-1, None], gy.to(ys.dtype)), 0)
        ox = clip(torch.minimum(xs[:, 1:, None], gx + 1) -
                  torch.maximum(xs[:, :-1, None], gx.to(xs.dtype)), 0)
        pooled = torch.einsum("chw,nih,njw->ncij", xv[0], oy, ox)
        den = (oy.sum(-1)[:, :, None] * ox.sum(-1)[:, None, :])[:, None]
        return pooled / clip(den, 1e-6)

    return forward_op("prroi_pool", impl,
                      [ensure_tensor(x), ensure_tensor(boxes)])


def bilateral_slice(x, guide, grid, has_offset: bool = False, name=None):
    """HDRNet bilateral-grid slicing (ref: bilateral_slice_op): trilinear
    lookup of per-pixel affine coefficients from a low-res grid indexed by
    (x, y, guide)."""
    def impl(xv, gv, rv):
        B, C, H, W = xv.shape
        _, GC, GD, GH, GW = rv.shape
        dev = xv.device
        yy = (torch.arange(H, device=dev) + 0.5) / H * GH - 0.5
        xx = (torch.arange(W, device=dev) + 0.5) / W * GW - 0.5
        zz = gv * GD - 0.5                                   # [B, H, W]
        y0 = clip(torch.floor(yy), 0, GH - 1).long()
        x0 = clip(torch.floor(xx), 0, GW - 1).long()
        z0 = clip(torch.floor(zz), 0, GD - 1).long()
        y1, x1, z1 = ((y0 + 1).clamp(0, GH - 1), (x0 + 1).clamp(0, GW - 1),
                      (z0 + 1).clamp(0, GD - 1))
        wy = (yy - torch.floor(yy))[None, :, None]
        wx = (xx - torch.floor(xx))[None, None, :]
        wz = zz - torch.floor(zz)
        b_idx = torch.arange(B, device=dev)[:, None, None]
        out = 0
        for zi, wzf in ((z0, 1 - wz), (z1, wz)):
            for yi, wyf in ((y0, 1 - wy), (y1, wy)):
                for xi, wxf in ((x0, 1 - wx), (x1, wx)):
                    g = rv[b_idx, :, zi, yi[None, :, None], xi[None, None, :]]
                    out = out + g * (wzf * wyf * wxf)[..., None]
        coeff = out.movedim(-1, 1)                           # [B, GC, H, W]
        if not has_offset:
            return coeff
        mat = coeff.reshape(B, GC // (C + 1), C + 1, H, W)
        return (mat[:, :, :C] * xv[:, None]).sum(2) + mat[:, :, C]

    return forward_op("bilateral_slice", impl, [ensure_tensor(x),
                                                ensure_tensor(guide),
                                                ensure_tensor(grid)])


def correlation(x, y, pad_size: int = 4, kernel_size: int = 1,
                max_displacement: int = 4, stride1: int = 1,
                stride2: int = 1, corr_type_multiply: int = 1, name=None):
    """FlowNet correlation layer (ref: correlation_op): mean over channels
    of x times y shifted by each displacement -> [B, D*D, H, W]."""
    d = max_displacement

    def impl(xv, yv):
        H, W = xv.shape[2], xv.shape[3]
        yp = torch.nn.functional.pad(yv, (d, d, d, d))
        outs = [(xv * yp[:, :, dy:dy + H, dx:dx + W]).mean(1)
                for dy in range(0, 2 * d + 1, stride2)
                for dx in range(0, 2 * d + 1, stride2)]
        return torch.stack(outs, 1)

    return forward_op("correlation", impl, [ensure_tensor(x),
                                            ensure_tensor(y)])


def retinanet_detection_output(bboxes_list, scores_list, anchors_list,
                               im_info, score_threshold: float = 0.05,
                               nms_top_k: int = 1000, keep_top_k: int = 100,
                               nms_threshold: float = 0.3, name=None):
    """RetinaNet head decode + multiclass NMS over FPN levels (ref:
    retinanet_detection_output_op): per-level decode against the anchors,
    concat, then the static multiclass_nms."""
    from ..ops.manipulation import concat, transpose
    decoded = [forward_op("retinanet_decode",
                          lambda dv, av: _decode_rcnn(av, dv),
                          [ensure_tensor(d), ensure_tensor(a)],
                          differentiable=False)
               for d, a in zip(bboxes_list, anchors_list)]
    boxes = concat(decoded, axis=1)
    scores = transpose(concat([ensure_tensor(s) for s in scores_list],
                              axis=1), [0, 2, 1])
    return multiclass_nms(boxes, scores, score_threshold=score_threshold,
                          nms_top_k=nms_top_k, keep_top_k=keep_top_k,
                          nms_threshold=nms_threshold)


_CONTRIB = ["prroi_pool", "bilateral_slice", "correlation",
            "retinanet_detection_output"]
__all__ += _CONTRIB
for _n in _CONTRIB:
    _f = globals()[_n]
    register_op(_n, _f, (_f.__doc__ or "").strip().split("\n")[0],
                public=_f)


def _iou_plain(av, gv):
    """IoU of every (anchor, gt) pair without the +1 convention."""
    lt = torch.maximum(av[:, None, :2], gv[None, :, :2])
    rb = torch.minimum(av[:, None, 2:], gv[None, :, 2:])
    wh = clip(rb - lt, 0)
    inter = wh[..., 0] * wh[..., 1]
    a1 = (av[:, 2] - av[:, 0]) * (av[:, 3] - av[:, 1])
    a2 = (gv[:, 2] - gv[:, 0]) * (gv[:, 3] - gv[:, 1])
    return inter / clip(a1[:, None] + a2[None] - inter, 1e-9)


def _first_max(iou, dim):
    """(max, the first index reaching it) along ``dim``, as ``jnp.max`` /
    ``jnp.argmax``."""
    return iou.max(dim)[0], torch.argmax(iou, dim)


def _untouched(v, idx):
    """``v`` where no write of ``idx`` lands, False where one does."""
    hit = torch.zeros_like(v).index_fill(0, idx, True)
    return v & ~hit


def rpn_target_assign(anchors, gt_boxes, is_crowd=None, im_info=None,
                      rpn_batch_size_per_im: int = 256,
                      rpn_straddle_thresh: float = 0.0,
                      rpn_fg_fraction: float = 0.5,
                      rpn_positive_overlap: float = 0.7,
                      rpn_negative_overlap: float = 0.3, name=None):
    """RPN anchor labeling (ref: rpn_target_assign_op): 1 for anchors with
    IoU >= positive_overlap (and each gt's best anchor), 0 below
    negative_overlap, -1 ignore. Static [A] outputs: (labels [A],
    matched_gt [A], fg_mask [A], bg_mask [A]); the sampling quotas are
    rank masks by IoU."""
    def impl(av, gv):
        area_ok = (gv[:, 2] > gv[:, 0]) & (gv[:, 3] > gv[:, 1])
        iou = torch.where(area_ok[None, :], _iou_plain(av, gv),
                          av.new_zeros(()))
        best_iou, best_gt = _first_max(iou, 1)
        pos = best_iou >= rpn_positive_overlap
        # each gt's best anchor is positive too (the last write wins where
        # two gts share one)
        gba = torch.argmax(iou, 0)
        pos = _scatter_last(pos.shape, gba, area_ok | pos[gba],
                            False) | _untouched(pos, gba)
        neg = (best_iou < rpn_negative_overlap) & ~pos
        n_fg = int(rpn_batch_size_per_im * rpn_fg_fraction)
        inf = torch.full_like(best_iou, float("inf"))
        fg = pos & (_rank(torch.where(pos, -best_iou, inf)) < n_fg)
        bg = neg & (_rank(torch.where(neg, best_iou, inf)) <
                    rpn_batch_size_per_im - n_fg)
        labels = torch.where(fg, 1, torch.where(bg, 0, -1))
        return labels, best_gt, fg, bg

    return forward_op("rpn_target_assign", impl,
                      [ensure_tensor(anchors), ensure_tensor(gt_boxes)],
                      differentiable=False)


def retinanet_target_assign(anchors, gt_boxes, gt_labels, im_info=None,
                            positive_overlap: float = 0.5,
                            negative_overlap: float = 0.4, name=None):
    """RetinaNet anchor labeling (ref: retinanet_target_assign_op): as the
    RPN's, with class labels and no subsampling. Returns (cls_targets [A]
    (-1 ignore, 0 bg, c+1 fg), matched_gt [A], fg_mask [A])."""
    def impl(av, gv, lv):
        area_ok = (gv[:, 2] > gv[:, 0]) & (gv[:, 3] > gv[:, 1])
        iou = torch.where(area_ok[None, :], _iou_plain(av, gv),
                          av.new_zeros(()))
        best_iou, best_gt = _first_max(iou, 1)
        fg = best_iou >= positive_overlap
        bg = best_iou < negative_overlap
        cls = torch.where(fg, lv[best_gt] + 1,
                          torch.where(bg, 0, -1).to(lv.dtype))
        return cls, best_gt, fg

    return forward_op("retinanet_target_assign", impl,
                      [ensure_tensor(anchors), ensure_tensor(gt_boxes),
                       ensure_tensor(gt_labels)], differentiable=False)


def generate_proposal_labels(rois, gt_boxes, gt_classes,
                             batch_size_per_im: int = 512,
                             fg_fraction: float = 0.25,
                             fg_thresh: float = 0.5,
                             bg_thresh_hi: float = 0.5,
                             bg_thresh_lo: float = 0.0,
                             bbox_reg_weights=(0.1, 0.1, 0.2, 0.2),
                             name=None):
    """Fast R-CNN head training targets (ref: generate_proposal_labels_op):
    label each RoI fg / bg by IoU and emit class targets, encoded box
    deltas and inside weights. Static [R] outputs with rank-quota sampling
    masks."""
    w = [float(a) for a in bbox_reg_weights]

    def impl(rv, gv, cv):
        best, bidx = _first_max(_iou_plain(rv, gv), 1)
        fg = best >= fg_thresh
        bg = (best < bg_thresh_hi) & (best >= bg_thresh_lo)
        n_fg = int(batch_size_per_im * fg_fraction)
        inf = torch.full_like(best, float("inf"))
        fg_keep = fg & (_rank(torch.where(fg, -best, inf)) < n_fg)
        bg_keep = bg & (_rank(torch.where(bg, best, inf)) <
                        batch_size_per_im - n_fg)
        labels = torch.where(fg_keep, cv[bidx], 0) * fg_keep
        tgt = gv[bidx]
        rw = rv[:, 2] - rv[:, 0] + 1e-6
        rh = rv[:, 3] - rv[:, 1] + 1e-6
        rcx = (rv[:, 0] + rv[:, 2]) / 2
        rcy = (rv[:, 1] + rv[:, 3]) / 2
        tiny = _full(1e-6, rw)
        gw = torch.maximum(tgt[:, 2] - tgt[:, 0], tiny)
        gh = torch.maximum(tgt[:, 3] - tgt[:, 1], tiny)
        gcx = (tgt[:, 0] + tgt[:, 2]) / 2
        gcy = (tgt[:, 1] + tgt[:, 3]) / 2
        deltas = torch.stack([(gcx - rcx) / rw / w[0],
                              (gcy - rcy) / rh / w[1],
                              torch.log(gw / rw) / w[2],
                              torch.log(gh / rh) / w[3]], -1)
        inside_w = fg_keep[:, None].to(rv.dtype).expand(-1, 4)
        return (labels.to(torch.int32), deltas * inside_w, inside_w,
                fg_keep, bg_keep)

    return forward_op("generate_proposal_labels", impl,
                      [ensure_tensor(rois), ensure_tensor(gt_boxes),
                       ensure_tensor(gt_classes)], differentiable=False)


def roi_perspective_transform(x, rois, transformed_height: int,
                              transformed_width: int,
                              spatial_scale: float = 1.0, name=None):
    """Perspective-warp quadrilateral RoIs to a fixed rectangle (ref:
    roi_perspective_transform_op, the OCR rectification kernel). rois
    [N, 8] are quad corners (x1..y4, clockwise from top-left); each RoI's
    homography is one batched 8x8 solve, then bilinear sampling. As in
    the reference, every RoI samples image 0."""
    TH, TW = transformed_height, transformed_width

    def impl(xv, rv):
        _, C, H, W = xv.shape
        N = rv.shape[0]
        dev, dt = xv.device, torch.float32
        q = rv.reshape(N, 4, 2).to(dt) * spatial_scale
        dst = torch.tensor([[0, 0], [TW - 1, 0], [TW - 1, TH - 1],
                            [0, TH - 1]], dtype=dt, device=dev)
        one, zero = torch.ones(N, dtype=dt, device=dev), \
            torch.zeros(N, dtype=dt, device=dev)
        rows, rhs = [], []
        for i in range(4):
            xd, yd = dst[i, 0].expand(N), dst[i, 1].expand(N)
            xs, ys = q[:, i, 0], q[:, i, 1]
            rows.append(torch.stack([xd, yd, one, zero, zero, zero,
                                     -xs * xd, -xs * yd], -1))
            rhs.append(xs)
            rows.append(torch.stack([zero, zero, zero, xd, yd, one,
                                     -ys * xd, -ys * yd], -1))
            rhs.append(ys)
        h8 = torch.linalg.solve(torch.stack(rows, 1), torch.stack(rhs, 1))
        Hs = torch.cat([h8, one[:, None]], 1).reshape(N, 3, 3)
        yy, xx = torch.meshgrid(torch.arange(TH, device=dev),
                                torch.arange(TW, device=dev), indexing="ij")
        pts = torch.stack([xx, yy, torch.ones_like(xx)], 0).reshape(
            3, -1).to(dt)                                    # [3, TH*TW]
        src = torch.einsum("nij,jp->nip", Hs, pts)
        den = torch.maximum(src[:, 2], _full(1e-8, src))
        sx, sy = src[:, 0] / den, src[:, 1] / den
        x0, y0 = torch.floor(sx), torch.floor(sy)
        wx, wy = sx - x0, sy - y0
        img = xv[0]

        def tap(yi, xi):
            ok = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
            g = img[:, clip(yi, 0, H - 1).long(), clip(xi, 0, W - 1).long()]
            return torch.where(ok[None], g, g.new_zeros(()))  # [C, N, P]

        out = (tap(y0, x0) * ((1 - wy) * (1 - wx))[None]
               + tap(y0, x0 + 1) * ((1 - wy) * wx)[None]
               + tap(y0 + 1, x0) * (wy * (1 - wx))[None]
               + tap(y0 + 1, x0 + 1) * (wy * wx)[None])
        return out.permute(1, 0, 2).reshape(N, C, TH, TW)

    return forward_op("roi_perspective_transform", impl,
                      [ensure_tensor(x), ensure_tensor(rois)])


_TARGETS = ["rpn_target_assign", "retinanet_target_assign",
            "generate_proposal_labels", "box_decoder_and_assign",
            "roi_perspective_transform"]
__all__ += _TARGETS
for _n in _TARGETS:
    _f = globals()[_n]
    register_op(_n, _f, (_f.__doc__ or "").strip().split("\n")[0],
                public=_f)

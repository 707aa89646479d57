"""The legacy detection ops' inference and anchor half — counterpart of
``paddle_tpu/vision/det_ops.py`` (paddle/fluid/operators/detection/ and
python/paddle/vision/ops.py in Paddle): prior and anchor generation, the
YOLO decode, proposal generation, box clipping and decoding, IoU, and
the NMS variants (multiclass greedy, matrix soft-suppression).

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

The training-target and sampling half (``deform_conv2d``, the RoI pools
of the position-sensitive family, ``yolo_loss``, the SSD matching and
losses, the FPN proposal routing, the R-CNN target assigners, ...) waits
for ROADMAP §A item 5b.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core.dispatch import register_op
from ..core.place import torch_device
from ..ops._helpers import ensure_tensor, forward_op

__all__ = [
    "prior_box", "density_prior_box", "anchor_generator", "yolo_box",
    "matrix_nms", "multiclass_nms", "generate_proposals", "box_clip",
    "polygon_box_transform", "iou_similarity", "box_decoder_and_assign",
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


# each public op in the schema registry (the reference's ops.yaml names)
for _n in __all__:
    _f = globals()[_n]
    register_op(_n, _f, (_f.__doc__ or "").strip().split("\n")[0].rstrip(","),
                public=_f)

"""``paddle.vision.ops`` — counterpart of ``paddle_tpu/vision/ops.py``
(python/paddle/vision/ops.py in Paddle): ``box_iou``, ``nms``,
``roi_align``, ``roi_pool``, ``box_coder``, ``read_file`` and
``decode_jpeg``, with the legacy detection family of ``det_ops``
re-exported.

``roi_align`` / ``roi_pool`` gather every RoI's sample grid in one
advanced index over ``[B, C, H, W]`` (static shapes given
``output_size``). ``nms`` is eager and host-side by design, as the
reference's: its result's length depends on the data. Its order is a
stable sort on descending score (``jnp.argsort``'s order: the lower index
first at equal scores); the static-shape NMS for a captured step is
``det_ops.multiclass_nms`` / ``detection.static_nms``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.dispatch import register_op
from ..ops._helpers import Tensor, ensure_tensor, forward_op
from .det_ops import clip

__all__ = ["nms", "box_iou", "roi_align", "roi_pool", "box_coder"]


def _pairwise_iou(x, y):
    area1 = (x[:, 2] - x[:, 0]) * (x[:, 3] - x[:, 1])
    area2 = (y[:, 2] - y[:, 0]) * (y[:, 3] - y[:, 1])
    lt = torch.maximum(x[:, None, :2], y[None, :, :2])
    rb = torch.minimum(x[:, None, 2:], y[None, :, 2:])
    wh = clip(rb - lt, 0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / clip(area1[:, None] + area2[None, :] - inter, 1e-10)


def box_iou(boxes1, boxes2, name=None):
    """Pairwise IoU of two [N,4]/[M,4] xyxy box sets -> [N, M]."""
    return forward_op("box_iou", _pairwise_iou,
                      [ensure_tensor(boxes1), ensure_tensor(boxes2)])


def nms(boxes, iou_threshold: float = 0.3, scores=None,
        category_idxs=None, categories=None, top_k: Optional[int] = None,
        name=None):
    """Greedy non-maximum suppression; returns kept indices into ``boxes``
    ordered by descending score (ref: paddle.vision.ops.nms). With
    ``category_idxs``/``categories``, suppression is per-category (the
    batched-nms offset trick). Eager: the output's length is data
    dependent."""
    from ..core.tensor import to_tensor
    bv = ensure_tensor(boxes)._value.detach().float()
    n = int(bv.shape[0])
    if scores is None:
        sv = torch.arange(n, 0, -1, dtype=torch.float32, device=bv.device)
    else:
        sv = ensure_tensor(scores)._value.detach().float()
    if category_idxs is not None:
        # each category in a disjoint coordinate range, so boxes of two
        # categories never overlap
        cv = ensure_tensor(category_idxs)._value.detach().float()
        span = bv.max() - bv.min() + 1.0
        bv = bv + (cv * span)[:, None]
    order = torch.sort(-sv, stable=True).indices
    iou = _pairwise_iou(bv[order], bv[order]).cpu().numpy()
    keep_sorted = np.ones(n, bool)
    for i in range(n):          # greedy suppression on the host
        if not keep_sorted[i]:
            continue
        keep_sorted[i + 1:] &= ~(iou[i, i + 1:] > iou_threshold)
    kept = order.cpu().numpy()[keep_sorted]
    if top_k is not None:
        kept = kept[:top_k]
    return to_tensor(kept.astype(np.int64))


def _adaptive_ratio(bt, spatial_scale, ph, pw):
    """The reference's adaptive sampling count (-1): ceil(roi/output) of
    the LARGEST RoI, one count a call (static shapes), read on the host."""
    bnp = bt.numpy().astype(np.float32)
    if not len(bnp):
        return 1
    max_h = float(np.max(bnp[:, 3] - bnp[:, 1])) * spatial_scale
    max_w = float(np.max(bnp[:, 2] - bnp[:, 0])) * spatial_scale
    return int(max(1, min(8, np.ceil(max(max_h / ph, max_w / pw)))))


def _gather(xv, bidx, yi, xi):
    """``xv[bidx[r], :, yi[r, i], xi[r, j]]`` for every RoI r -> [R, C, Py,
    Px]."""
    g = xv[bidx[:, None, None], :, yi[:, :, None], xi[:, None, :]]
    return g.permute(0, 3, 1, 2)


def roi_align(x, boxes, boxes_num, output_size, spatial_scale: float = 1.0,
              sampling_ratio: int = -1, aligned: bool = True, name=None):
    """RoIAlign: the average of bilinear samples per output bin (ref:
    paddle.vision.ops.roi_align; boxes [R, 4] xyxy in input coords,
    ``boxes_num`` [B] RoIs per image)."""
    xt, bt = ensure_tensor(x), ensure_tensor(boxes)
    bn = ensure_tensor(boxes_num).numpy().astype(np.int64)
    ph, pw = (output_size, output_size) if isinstance(output_size, int) \
        else output_size
    sr = sampling_ratio if sampling_ratio > 0 else \
        _adaptive_ratio(bt, spatial_scale, ph, pw)
    batch_idx = np.repeat(np.arange(len(bn)), bn)

    def impl(xv, bv):
        dev = xv.device
        bidx = torch.as_tensor(batch_idx, device=dev)
        off = 0.5 if aligned else 0.0
        x1 = bv[:, 0] * spatial_scale - off
        y1 = bv[:, 1] * spatial_scale - off
        x2 = bv[:, 2] * spatial_scale - off
        y2 = bv[:, 3] * spatial_scale - off
        floor = 1e-3 if aligned else 1.0
        rw = clip(x2 - x1, floor)
        rh = clip(y2 - y1, floor)
        bin_w, bin_h = rw / pw, rh / ph
        gy = y1[:, None] + (torch.arange(ph * sr, device=dev) + 0.5)[None] * \
            (bin_h / sr)[:, None]
        gx = x1[:, None] + (torch.arange(pw * sr, device=dev) + 0.5)[None] * \
            (bin_w / sr)[:, None]
        H, W = xv.shape[2], xv.shape[3]
        y0 = torch.clamp(torch.floor(gy), 0, H - 1)
        x0 = torch.clamp(torch.floor(gx), 0, W - 1)
        y1i = torch.clamp(y0 + 1, 0, H - 1)
        x1i = torch.clamp(x0 + 1, 0, W - 1)
        wy = (clip(gy, 0, H - 1) - y0)[:, None, :, None]
        wx = (clip(gx, 0, W - 1) - x0)[:, None, None, :]
        y0, x0, y1i, x1i = (a.long() for a in (y0, x0, y1i, x1i))
        samp = (_gather(xv, bidx, y0, x0) * (1 - wy) * (1 - wx)
                + _gather(xv, bidx, y0, x1i) * (1 - wy) * wx
                + _gather(xv, bidx, y1i, x0) * wy * (1 - wx)
                + _gather(xv, bidx, y1i, x1i) * wy * wx)
        R, C = samp.shape[:2]
        return samp.reshape(R, C, ph, sr, pw, sr).mean(dim=(3, 5))

    return forward_op("roi_align", impl, [xt, bt])


def roi_pool(x, boxes, boxes_num, output_size, spatial_scale: float = 1.0,
             name=None):
    """RoIPool: the max over quantized bins (ref:
    paddle.vision.ops.roi_pool): each bin's max over a 4 x 4 grid of
    integer cells (static shapes)."""
    xt, bt = ensure_tensor(x), ensure_tensor(boxes)
    bn = ensure_tensor(boxes_num).numpy().astype(np.int64)
    ph, pw = (output_size, output_size) if isinstance(output_size, int) \
        else output_size
    batch_idx = np.repeat(np.arange(len(bn)), bn)

    def impl(xv, bv):
        dev = xv.device
        bidx = torch.as_tensor(batch_idx, device=dev)
        H, W = xv.shape[2], xv.shape[3]
        x1 = torch.round(bv[:, 0] * spatial_scale)
        y1 = torch.round(bv[:, 1] * spatial_scale)
        x2 = torch.round(bv[:, 2] * spatial_scale)
        y2 = torch.round(bv[:, 3] * spatial_scale)
        rw = clip(x2 - x1 + 1, 1.0)
        rh = clip(y2 - y1 + 1, 1.0)
        gy = torch.clamp(y1[:, None] + torch.arange(ph * 4, device=dev)[None]
                         * rh[:, None] / (ph * 4), 0, H - 1).long()
        gx = torch.clamp(x1[:, None] + torch.arange(pw * 4, device=dev)[None]
                         * rw[:, None] / (pw * 4), 0, W - 1).long()
        patch = _gather(xv, bidx, gy, gx)
        R, C = patch.shape[:2]
        return patch.reshape(R, C, ph, 4, pw, 4).amax(dim=(3, 5))

    return forward_op("roi_pool", impl, [xt, bt])


def _centers(b, norm):
    w = b[..., 2] - b[..., 0] + norm
    h = b[..., 3] - b[..., 1] + norm
    return b[..., 0] + 0.5 * w, b[..., 1] + 0.5 * h, w, h


def box_coder(prior_box, prior_box_var, target_box,
              code_type: str = "encode_center_size", box_normalized: bool = True,
              axis: int = 0, name=None):
    """Encode/decode boxes against priors (ref: paddle.vision.ops.box_coder,
    the SSD/R-CNN box regression transform)."""
    p = ensure_tensor(prior_box)
    t = ensure_tensor(target_box)
    args = [p, t] + ([] if prior_box_var is None
                     else [ensure_tensor(prior_box_var)])
    norm = 0.0 if box_normalized else 1.0

    if code_type == "encode_center_size":
        def impl(pv, tv, *var):
            pcx, pcy, pw, ph_ = _centers(pv, norm)
            tcx, tcy, tw, th = _centers(tv[:, None, :] if tv.ndim == 2
                                        else tv, norm)
            out = torch.stack([(tcx - pcx) / pw, (tcy - pcy) / ph_,
                               torch.log(tw / pw), torch.log(th / ph_)], -1)
            return out / var[0] if var else out
        return forward_op("box_coder", impl, args)

    def impl(pv, tv, *var):   # decode_center_size
        pcx, pcy, pw, ph_ = _centers(pv, norm)
        if tv.ndim == 3:
            # priors broadcast along `axis` of the [N, M, 4] deltas
            expand = (lambda a: a[None, :]) if axis == 0 \
                else (lambda a: a[:, None])
            pcx, pcy, pw, ph_ = (expand(a) for a in (pcx, pcy, pw, ph_))
        d = tv * var[0] if var else tv
        ocx = d[..., 0] * pw + pcx
        ocy = d[..., 1] * ph_ + pcy
        ow = torch.exp(d[..., 2]) * pw
        oh = torch.exp(d[..., 3]) * ph_
        return torch.stack([ocx - 0.5 * ow, ocy - 0.5 * oh,
                            ocx + 0.5 * ow - norm, ocy + 0.5 * oh - norm], -1)

    return forward_op("box_coder", impl, args)


for _n, _d in [("box_iou", "pairwise IoU matrix"),
               ("nms", "greedy non-maximum suppression"),
               ("roi_align", "RoIAlign bilinear pooling"),
               ("roi_pool", "RoIPool max pooling"),
               ("box_coder", "SSD/R-CNN box regression transform")]:
    register_op(_n, globals()[_n], f"vision.ops.{_n}: {_d}",
                public=globals()[_n])


# the legacy detection family (prior / anchor generation, the NMS
# variants, SSD matching, the training-target assigners)
from .det_ops import *  # noqa: F401,E402,F403
from .det_ops import __all__ as _det_all  # noqa: E402
__all__ = list(__all__) + list(_det_all)


def read_file(filename, name=None):
    """Raw bytes of a file as a uint8 Tensor (ref:
    paddle.vision.ops.read_file)."""
    from ..core.tensor import to_tensor
    with open(filename, "rb") as f:
        data = f.read()
    return to_tensor(np.frombuffer(data, dtype=np.uint8).copy())


def decode_jpeg(x, mode: str = "unchanged", name=None):
    """Decode a JPEG byte Tensor to [C, H, W] uint8 (ref:
    paddle.vision.ops.decode_jpeg). Host-side (the data pipeline), with
    Pillow where it is installed."""
    import io

    from ..core.tensor import to_tensor
    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError(
            "decode_jpeg needs Pillow, which is not installed; feed decoded "
            "arrays to the DataLoader instead") from e
    raw = x.numpy() if isinstance(x, Tensor) else np.asarray(x)
    img = Image.open(io.BytesIO(raw.tobytes()))
    if mode == "gray":
        img = img.convert("L")
    elif mode == "rgb":
        img = img.convert("RGB")
    arr = np.asarray(img)
    arr = arr[None] if arr.ndim == 2 else arr.transpose(2, 0, 1)
    return to_tensor(arr)


for _n in ("read_file", "decode_jpeg"):
    register_op(_n, globals()[_n],
                (globals()[_n].__doc__ or "").strip().split("\n")[0],
                differentiable=False, public=globals()[_n])
__all__ = list(__all__) + ["read_file", "decode_jpeg"]

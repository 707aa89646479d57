"""OCR text recognition — counterpart of ``paddle_tpu/vision/ocr.py``:
the CRNN recognizer (conv backbone, BiLSTM neck, CTC head; PaddleOCR's
``ppocr/modeling`` rec stack) and greedy CTC decoding.

The conv stack pools the height to 1, so the sequence axis is the image
width (T = W / 4). The neck is ``nn.LSTM`` (both directions in one loop a
step, ``nn/layers/rnn.py``); the loss is ``nn.functional.ctc_loss``.
``ctc_greedy_decode`` has static shapes and reads nothing back to the
host, so it replays inside a captured graph.
"""

from __future__ import annotations

import torch

from ..core.dispatch import forward_op
from ..nn import LSTM, BatchNorm2D, Conv2D, Linear, MaxPool2D, ReLU, Sequential
from ..nn.layer import Layer
from ..ops._helpers import ensure_tensor

__all__ = ["CRNN", "crnn_mobilenet", "ctc_greedy_decode"]


class _ConvBlock(Layer):
    def __init__(self, cin, cout, pool):
        super().__init__()
        self.conv = Conv2D(cin, cout, 3, padding=1, bias_attr=False)
        self.bn = BatchNorm2D(cout)
        self.act = ReLU()
        self.pool = MaxPool2D(pool, pool) if pool else None

    def forward(self, x):
        x = self.act(self.bn(self.conv(x)))
        return self.pool(x) if self.pool else x


class CRNN(Layer):
    """Conv stack (H -> 1) + BiLSTM neck + CTC projection head.

    ``forward(images [B, C, H, W])`` -> logits ``[T, B, num_classes]``
    (paddle CTC layout, T = W / 4); class 0 is the CTC blank.
    """

    def __init__(self, num_classes: int, in_channels: int = 3,
                 image_height: int = 32, hidden_size: int = 96):
        super().__init__()
        if image_height % 16:
            raise ValueError(f"image_height {image_height} must be a "
                             "multiple of 16 (four height-halvings)")
        self.num_classes = num_classes
        # pools: (2,2) (2,2) -> T = W/4; then height-only (2,1) pools
        self.features = Sequential(
            _ConvBlock(in_channels, 32, (2, 2)),
            _ConvBlock(32, 64, (2, 2)),
            _ConvBlock(64, 96, (2, 1)),
            _ConvBlock(96, 96, (2, 1)),
        )
        self._feat_h = image_height // 16
        self.neck = LSTM(96 * self._feat_h, hidden_size,
                         direction="bidirectional")
        self.head = Linear(2 * hidden_size, num_classes)

    def forward(self, x):
        from ..ops.manipulation import reshape, transpose
        f = self.features(x)                       # [B, C, H/16, W/4]
        B, C, H, W = f.shape
        seq = reshape(transpose(f, [0, 3, 1, 2]), [B, W, C * H])
        out, _ = self.neck(seq)                    # [B, T, 2*hidden]
        logits = self.head(out)                    # [B, T, num_classes]
        return transpose(logits, [1, 0, 2])        # [T, B, C] (CTC layout)


def crnn_mobilenet(num_classes: int, **kw) -> CRNN:
    """PP-OCR-rec-shaped factory (conv backbone scaled for mobile)."""
    return CRNN(num_classes, **kw)


def ctc_greedy_decode(logits, blank: int = 0, merge_repeats: bool = True):
    """Greedy CTC decoding with STATIC shapes: argmax per step, collapse
    repeats, drop blanks — a ``[B, T]`` token buffer (left-aligned, padded
    with ``blank``) plus per-row valid counts.

    ``logits [T, B, C]`` -> ``(tokens [B, T], lengths [B])``: the kept
    tokens are pulled to the front by a stable sort on "not kept", so the
    call reads nothing back to the host."""
    def impl(lp):
        T, B, _ = lp.shape
        ids = torch.argmax(lp, dim=-1).t()            # [B, T]
        if merge_repeats:
            prev = torch.cat([torch.full((B, 1), -1, dtype=ids.dtype,
                                         device=ids.device), ids[:, :-1]], 1)
            keep = (ids != blank) & (ids != prev)
        else:
            keep = ids != blank
        order = torch.sort((~keep).to(torch.int32), dim=1, stable=True)[1]
        toks = torch.gather(ids, 1, order)
        lengths = keep.sum(1)
        mask = torch.arange(T, device=ids.device)[None, :] < lengths[:, None]
        return torch.where(mask, toks, torch.full_like(toks, blank)), lengths

    return forward_op("ctc_greedy_decode", impl, [ensure_tensor(logits)],
                      differentiable=False)

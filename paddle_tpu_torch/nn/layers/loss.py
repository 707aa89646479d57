"""Loss layers — the part of ``paddle_tpu/nn/layers/loss.py`` the port has
so far (``CrossEntropyLoss``, ``MSELoss``, ``CTCLoss``); the rest wait
with their functionals (ROADMAP §A item 7)."""

from __future__ import annotations

from .. import functional as F
from ..layer import Layer


class CrossEntropyLoss(Layer):
    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 soft_label=False, axis=-1, use_softmax=True, label_smoothing=0.0,
                 name=None):
        super().__init__()
        self.weight = weight
        self.ignore_index = ignore_index
        self.reduction = reduction
        self.soft_label = soft_label
        self.axis = axis
        self.use_softmax = use_softmax
        self.label_smoothing = label_smoothing

    def forward(self, input, label):  # noqa: A002
        return F.cross_entropy(input, label, self.weight, self.ignore_index,
                               self.reduction, self.soft_label, self.axis,
                               self.use_softmax, self.label_smoothing)


class MSELoss(Layer):
    def __init__(self, reduction="mean"):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):  # noqa: A002
        return F.mse_loss(input, label, self.reduction)


class CTCLoss(Layer):
    def __init__(self, blank=0, reduction="mean"):
        super().__init__()
        self.blank = blank
        self.reduction = reduction

    def forward(self, log_probs, labels, input_lengths, label_lengths,
                norm_by_times=False):
        return F.ctc_loss(log_probs, labels, input_lengths, label_lengths,
                          self.blank, self.reduction, norm_by_times)

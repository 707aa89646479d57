"""``paddle.incubate`` — counterpart of ``paddle_tpu/incubate``. This slice
ports ``incubate.nn.functional``'s two kernel callers; ``softmax_mask_fuse``,
``incubate.distributed`` (MoE) and ``incubate.optimizer`` (LookAhead,
ModelAverage) are ROADMAP §A item 11."""

from . import nn  # noqa: F401

__all__ = ["nn"]

"""``paddle.incubate`` — counterpart of ``paddle_tpu/incubate``: the fused
names (``incubate.nn``), ``LookAhead`` and ``ModelAverage``
(``incubate.optimizer``), MoE at its reference location
(``incubate.distributed.models.moe``, implemented in
``distributed/moe.py``) and ``softmax_mask_fuse``."""

from . import distributed  # noqa: F401
from . import nn  # noqa: F401
from . import optimizer  # noqa: F401
from .optimizer import LookAhead, ModelAverage  # noqa: F401

__all__ = ["nn", "distributed", "optimizer", "LookAhead", "ModelAverage",
           "softmax_mask_fuse"]


def softmax_mask_fuse(x, mask, name=None):
    """ref: incubate.softmax_mask_fuse — softmax(x + mask) over the last
    axis."""
    from ..nn import functional as F
    return F.softmax(x + mask, axis=-1)

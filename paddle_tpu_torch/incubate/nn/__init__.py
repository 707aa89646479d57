"""paddle.incubate.nn — counterpart of ``paddle_tpu/incubate/nn``; the
functional fused names ported so far."""

from . import functional  # noqa: F401

"""incubate.distributed — counterpart of ``paddle_tpu/incubate/distributed``."""

from . import models  # noqa: F401

__all__ = ["models"]

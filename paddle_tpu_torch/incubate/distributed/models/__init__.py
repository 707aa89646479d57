"""incubate.distributed.models (MoE lives here in Paddle)."""

from . import moe  # noqa: F401

__all__ = ["moe"]

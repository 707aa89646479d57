"""Checkpoint tier 1 and the integrity primitives — counterpart of
``paddle_tpu/framework``."""

from .integrity import CheckpointCorruptionError  # noqa: F401
from .io import async_save, is_saving, load, save, wait_save  # noqa: F401

__all__ = ["CheckpointCorruptionError", "save", "load", "async_save",
           "wait_save", "is_saving"]

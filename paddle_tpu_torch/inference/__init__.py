"""Inference tier of the port (counterpart of ``paddle_tpu/inference``):
the :class:`GenerationPredictor` over the dense and paged decode tiers."""

from .generation import GenerationConfig, GenerationPredictor

__all__ = ["GenerationConfig", "GenerationPredictor"]

"""Continuous-batching serving over a paged KV cache (counterpart of
``paddle_tpu/inference/serving``): ``ServingEngine`` + ``ServingConfig``
over the host-side ``PagedKVCache`` / ``Scheduler`` / admission policies."""

from .engine import ServingConfig, ServingEngine
from .scheduler import ServingQueueFull

__all__ = ["ServingConfig", "ServingEngine", "ServingQueueFull"]

"""Continuous-batching serving over a paged KV cache (counterpart of
``paddle_tpu/inference/serving``): ``ServingEngine`` + ``ServingConfig``
over the host-side ``PagedKVCache`` / ``Scheduler`` / admission policies,
the host KV offload tier, the request journal, and the
``EngineSupervisor`` crash barrier around the engine."""

from .engine import ServingConfig, ServingEngine
from .journal import RequestJournal
from .offload import HostOffloadTier
from .scheduler import ServingQueueFull
from .supervisor import EngineSupervisor, ServingUnavailable, \
    autoscale_signal

__all__ = ["ServingConfig", "ServingEngine", "ServingQueueFull",
           "HostOffloadTier", "RequestJournal", "EngineSupervisor",
           "ServingUnavailable", "autoscale_signal"]

"""Continuous-batching serving over a paged KV cache (counterpart of
``paddle_tpu/inference/serving``): ``ServingEngine`` + ``ServingConfig``
over the host-side ``PagedKVCache`` / ``Scheduler`` / admission policies,
the host KV offload tier, the request journal, the ``EngineSupervisor``
crash barrier around the engine, and the fleet tier above it: the
``ServingRouter`` over N in-process replicas (``Replica``,
``CircuitBreaker``), the fleet cache directory (``CacheDirectory``) and
the ``InvariantAuditor``."""

from .audit import AUDIT_CHECKS, InvariantAuditor, InvariantViolation
from .directory import CacheDirectory
from .engine import AdoptError, ServingConfig, ServingEngine
from .journal import RequestJournal
from .offload import HostOffloadTier
from .replica import CircuitBreaker, Replica
from .router import (ROUTER_HEALTH_FIELDS, RouterConfig, RouterRequest,
                     ServingRouter)
from .scheduler import ServingQueueFull
from .supervisor import EngineSupervisor, ServingUnavailable, \
    autoscale_signal

__all__ = ["ServingConfig", "ServingEngine", "ServingQueueFull",
           "HostOffloadTier", "RequestJournal", "EngineSupervisor",
           "ServingUnavailable", "autoscale_signal", "AdoptError",
           "ServingRouter", "RouterConfig", "RouterRequest",
           "ROUTER_HEALTH_FIELDS", "Replica", "CircuitBreaker",
           "CacheDirectory", "InvariantAuditor", "InvariantViolation",
           "AUDIT_CHECKS"]

"""Continuous-batching serving over a paged KV cache (counterpart of
``paddle_tpu/inference/serving``): ``ServingEngine`` + ``ServingConfig``
over the host-side ``PagedKVCache`` / ``Scheduler`` / admission policies,
the host KV offload tier, the request journal, the ``EngineSupervisor``
crash barrier around the engine, and the fleet tier above it: the
``ServingRouter`` over N in-process replicas (``Replica``,
``CircuitBreaker``), the fleet cache directory (``CacheDirectory``) and
the ``InvariantAuditor``; the asyncio front end (``ServingServer``: SSE
token streams, per-client backpressure, ``/healthz`` / ``/readyz`` /
``/metrics``) over a supervisor or a fleet, and the deterministic
workload replay (``WorkloadSpec`` / ``generate_trace`` /
``ReplayManifest`` / ``run_replay`` / ``capacity_report``) that drives
the fleet under a seeded chaos timeline."""

from .audit import AUDIT_CHECKS, InvariantAuditor, InvariantViolation
from .directory import CacheDirectory
from .engine import AdoptError, ServingConfig, ServingEngine
from .journal import RequestJournal
from .offload import HostOffloadTier
from .replica import CircuitBreaker, Replica
from .router import (ROUTER_HEALTH_FIELDS, RouterConfig, RouterRequest,
                     ServingRouter)
from .scheduler import ServingQueueFull
from .server import ClientStream, ServingServer, serve_requests, sse_encode
from .supervisor import EngineSupervisor, ServingUnavailable, \
    autoscale_signal
from .workload import (ReplayManifest, TraceRequest, WorkloadSpec,
                       capacity_report, generate_trace, run_replay)

__all__ = ["ServingConfig", "ServingEngine", "ServingQueueFull",
           "HostOffloadTier", "RequestJournal", "EngineSupervisor",
           "ServingUnavailable", "autoscale_signal", "AdoptError",
           "ServingRouter", "RouterConfig", "RouterRequest",
           "ROUTER_HEALTH_FIELDS", "Replica", "CircuitBreaker",
           "CacheDirectory", "InvariantAuditor", "InvariantViolation",
           "AUDIT_CHECKS", "ServingServer", "ClientStream",
           "serve_requests", "sse_encode", "WorkloadSpec", "TraceRequest",
           "generate_trace", "ReplayManifest", "run_replay",
           "capacity_report"]

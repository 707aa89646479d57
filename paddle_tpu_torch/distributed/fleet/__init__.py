"""``fleet``: the hybrid topology's entry point — counterpart of the
topology part of ``paddle_tpu/distributed/fleet/__init__.py``
(``DistributedStrategy``, ``init``, ``worker_num``, ``worker_index``,
``is_first_worker``, ``barrier_worker``).

``init`` builds the :class:`~..topology.HybridCommunicateGroup` from the
strategy's degrees over ``devices`` (default: every device the process
drives) and installs it. ``distributed_model`` wraps an ``nn.Layer`` for
the active axes (``PipelineParallel`` under pp, ``DataParallel`` under dp
or sharding; mp layers carry their own layouts) and
``distributed_optimizer`` shards the optimizer states over the sharding
axis (ZeRO stage 1). The sub-namespaces ``layers``, ``utils``,
``meta_parallel`` and ``recompute`` load on first use.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

from .. import collective as _collective
from ..topology import (HybridCommunicateGroup, get_hybrid_communicate_group,
                        local_devices, set_hybrid_communicate_group)

__all__ = ["DistributedStrategy", "init", "distributed_model",
           "distributed_optimizer", "get_hybrid_communicate_group",
           "worker_num", "worker_index", "is_first_worker",
           "barrier_worker", "layers", "utils", "meta_parallel", "recompute"]


def __getattr__(name):
    if name in ("layers", "utils", "meta_parallel", "recompute"):
        import importlib
        mod = importlib.import_module(f".{name}", __name__)
        globals()[name] = mod
        return mod
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


class DistributedStrategy:
    """The reference's typed stand-in for Paddle's protobuf strategy."""

    def __init__(self):
        self.hybrid_configs = {"dp_degree": 1, "mp_degree": 1,
                               "pp_degree": 1, "sharding_degree": 1,
                               "sep_degree": 1, "ep_degree": 1}
        self.amp = False
        self.amp_configs = {}
        self.recompute = False
        self.recompute_configs = {}
        self.sharding = False
        self.sharding_configs = {}
        self.pipeline = False
        self.pipeline_configs = {"accumulate_steps": 1,
                                 "micro_batch_size": 1}
        self.gradient_merge = False
        self.gradient_merge_configs = {}
        self.find_unused_parameters = False

    def __repr__(self):
        return f"DistributedStrategy(hybrid={self.hybrid_configs})"


_fleet_state = {"initialized": False, "strategy": None}


def init(role_maker=None, is_collective: bool = True,
         strategy: Optional[DistributedStrategy] = None, log_level="INFO",
         devices: Optional[Sequence[Any]] = None):
    """Build and install the hybrid topology. A degree <= 0 (usually -1)
    means 1, except dp: with every degree 1, dp is the device count (plain
    data parallel); with dp not requested (<= 1) and other axes set, dp
    fills the remaining devices when they divide evenly, as the reference
    does. A product that does not match the devices raises."""
    strategy = strategy or DistributedStrategy()
    cfg = strategy.hybrid_configs
    _collective.init_parallel_env()
    degrees = {k: max(int(cfg.get(f"{k}_degree", 1)), 1)
               for k in ("dp", "mp", "pp", "sharding", "sep", "ep")}
    dp_requested = int(cfg.get("dp_degree", 1))
    product = 1
    for v in degrees.values():
        product *= v
    devs = list(devices) if devices is not None else local_devices()
    n = len(devs)
    if product == 1:
        degrees["dp"] = n
    elif dp_requested <= 1:
        non_dp = product // degrees["dp"]
        if n % non_dp == 0 and non_dp <= n:
            degrees["dp"] = n // non_dp
    hcg = HybridCommunicateGroup(devices=devs, **degrees)
    set_hybrid_communicate_group(hcg)
    _fleet_state["initialized"] = True
    _fleet_state["strategy"] = strategy


def distributed_model(model):
    """Wrap ``model`` for the active parallel axes: ``PipelineParallel``
    when pp > 1, ``DataParallel`` when dp or sharding > 1, else the model
    itself."""
    hcg = get_hybrid_communicate_group()
    if hcg.get_pipe_parallel_world_size() > 1:
        from ..pipeline import PipelineParallel
        return PipelineParallel(model, hcg, _fleet_state.get("strategy"))
    if hcg.get_data_parallel_world_size() > 1 or \
            hcg.get_sharding_parallel_world_size() > 1:
        from ..parallel import DataParallel
        return DataParallel(model)
    return model


def distributed_optimizer(optimizer, strategy=None):
    """The optimizer, its states sharded over the sharding axis when it is
    larger than 1 (ZeRO stage 1); the dp gradient sums are the
    distributed parameters' own."""
    hcg = get_hybrid_communicate_group()
    if hcg.get_sharding_parallel_world_size() > 1:
        from ..sharding import shard_optimizer_states
        shard_optimizer_states(optimizer, hcg)
    return optimizer


def worker_num() -> int:
    """Processes in the job: 1 (one process drives every device)."""
    return 1


def worker_index() -> int:
    return 0


def is_first_worker() -> bool:
    return worker_index() == 0


def barrier_worker():
    _collective.barrier()

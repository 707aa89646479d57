"""Distributed pieces of the port — counterpart of ``paddle_tpu/distributed``:
the hybrid topology (``build_mesh``, ``HybridCommunicateGroup``, ``fleet``),
the collective API over a placement (``all_reduce`` and the rest), tensor
layouts over a mesh (``shard_to_mesh``, ``ShardedTensor``), context
parallelism (``sep_parallel_attention``: ring and Ulysses attention), the
pipeline schedule (``pipeline_scan``, ``ring_schedule``), the MoE routing
math and the expert-parallel ops (``moe_utils``), the serving
tensor-parallel placement and shard helpers, the checkpoint stack
(``checkpoint``: sharded save, reshard-on-load, ``AsyncCheckpointer``),
the multi-process side: the launcher (``python -m
paddle_tpu_torch.distributed.launch``), the rendezvous store and elastic
heartbeats (``elastic``), ``rpc`` over the store; and the eager
hybrid-parallel API: distributed eager tensors and the per-coordinate
region (``dist_tensor``: ``DistParameter``, ``shard_map``), the
auto-parallel API (``ProcessMesh``, ``shard_tensor``, ``reshard``, ...),
``DataParallel``, the ZeRO stages (``group_sharded_parallel``) and
``fleet``'s mpu layers, recompute, sequence parallelism and
``distributed_model`` / ``distributed_optimizer``; and the
parameter-server tables (``ps``: ``SparseEmbedding``, the sparse
optimizers, ``DistributedSparseEmbedding``, ``AsyncLookup``)."""

from . import checkpoint
from . import elastic
from . import fleet
from . import ps
from . import rpc
from . import sharding
from .auto_parallel import (Partial, Placement, ProcessMesh, Replicate, Shard,
                            dtensor_from_fn, get_mesh, reshard, set_mesh,
                            shard_layer, shard_tensor)
from .dist_tensor import (DistParameter, DistTensor, PartitionSpec,
                          shard_map)
from .parallel import DataParallel, ParallelEnv
from .sharding import group_sharded_parallel
from .checkpoint import AsyncCheckpointer, load_state_dict, save_state_dict
from .collective import (ReduceOp, all_gather, all_reduce, alltoall, barrier,
                         broadcast, get_rank, get_world_size,
                         init_parallel_env, is_initialized, reduce,
                         reduce_scatter, scatter)
from .moe_utils import (assign_pos, expert_count, global_gather,
                        global_scatter, limit_by_capacity, number_count,
                        prune_gate_by_capacity, random_routing)
from .context_parallel import (ring_flash_attention, sep_parallel_attention,
                               ulysses_attention)
from .moe import GShardGate, MoELayer, NaiveGate, SwitchGate
from .ps import (AsyncLookup, DistributedSparseEmbedding, SelectedRows,
                 SparseAdagrad, SparseAdam, SparseEmbedding, SparseSGD)
from .pipeline import (LayerDesc, PipelineLayer, PipelineParallel,
                       SharedLayerDesc, pipeline_scan, pipeline_ticks,
                       ring_schedule)
from .sharding import ShardedTensor, assemble, shard_to_mesh, shard_tree
from .topology import (HybridCommunicateGroup, Mesh, ParallelAxis,
                       build_mesh, get_hybrid_communicate_group,
                       set_hybrid_communicate_group)

__all__ = ["Partial", "Placement", "ProcessMesh", "Replicate", "Shard",
           "dtensor_from_fn", "get_mesh", "reshard", "set_mesh",
           "shard_layer", "shard_tensor", "DistParameter", "DistTensor",
           "PartitionSpec", "shard_map", "DataParallel", "ParallelEnv",
           "group_sharded_parallel", "rpc", "sharding", "MoELayer", "ps",
           "SelectedRows", "SparseEmbedding", "DistributedSparseEmbedding",
           "SparseSGD", "SparseAdagrad", "SparseAdam", "AsyncLookup",
           "NaiveGate", "SwitchGate", "GShardGate", "LayerDesc",
           "SharedLayerDesc", "PipelineLayer", "PipelineParallel",
           "checkpoint", "elastic", "fleet", "save_state_dict", "load_state_dict",
           "AsyncCheckpointer", "ReduceOp", "all_reduce", "all_gather",
           "reduce_scatter", "alltoall", "broadcast", "reduce", "scatter",
           "barrier", "get_rank", "get_world_size", "is_initialized",
           "init_parallel_env", "HybridCommunicateGroup", "Mesh",
           "ParallelAxis", "build_mesh", "get_hybrid_communicate_group",
           "set_hybrid_communicate_group", "ShardedTensor", "shard_to_mesh",
           "assemble", "shard_tree", "sep_parallel_attention",
           "ring_flash_attention", "ulysses_attention", "pipeline_scan",
           "pipeline_ticks", "ring_schedule", "number_count",
           "expert_count", "assign_pos", "limit_by_capacity",
           "prune_gate_by_capacity", "random_routing", "global_scatter",
           "global_gather"]

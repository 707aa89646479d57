"""Megatron-style sequence parallelism — counterpart of
``paddle_tpu/distributed/fleet/utils/sequence_parallel_utils.py``
(``ScatterOp`` / ``GatherOp`` / ``AllGatherOp`` / ``ReduceScatterOp``,
``ColumnSequenceParallelLinear`` / ``RowSequenceParallelLinear``, the
parameter marks).

* **Outside a region** a value is the full logical tensor (the JAX
  package's GSPMD path), so scatter / gather / all-gather /
  reduce-scatter leave it as it is: where its sequence blocks live is a
  layout, and the mp layers compute per shard themselves.
* **Inside a per-coordinate region** they are the collectives over the mp
  groups with the reference's pairings: scatter / all-gather,
  gather / split, all-gather / reduce-scatter, reduce-scatter /
  all-gather.

The utilities default to ``axis=0`` (the reference's ``[s, b, h]``) and
take ``axis=`` for batch-first ``[b, s, h]``.
"""

from __future__ import annotations

from ...dist_tensor import region_axis_bound
from ....ops._helpers import ensure_tensor
from ..layers.mpu import mp_ops
from ..layers.mpu.mp_layers import (ColumnParallelLinear, RowParallelLinear,
                                    _column, _local_shard, _row)
from ..layers.mpu.mp_ops import (_allgather_rs, _rs_ag, mp_axis_name)
from ....nn import functional as F

__all__ = ["ScatterOp", "GatherOp", "AllGatherOp", "ReduceScatterOp",
           "scatter", "all_gather", "mark_as_sequence_parallel_parameter",
           "is_sequence_parallel_parameter",
           "register_sequence_parallel_allreduce_hooks",
           "ColumnSequenceParallelLinear", "RowSequenceParallelLinear"]


class _SeqOp:
    _raw = None         # the region collective (x, axis, dim)

    @classmethod
    def apply(cls, x, axis: int = 0, group=None):
        mp = mp_axis_name(group)
        t = ensure_tensor(x)
        if region_axis_bound(mp):
            return cls._raw(t, mp, axis % t.ndim)
        return t


class ScatterOp(_SeqOp):
    """forward: split seq over mp; backward: all-gather."""
    _raw = staticmethod(mp_ops._split_dim)


class GatherOp(_SeqOp):
    """forward: all-gather seq; backward: split (this rank's chunk)."""
    _raw = staticmethod(mp_ops._concat_dim)


class AllGatherOp(_SeqOp):
    """forward: all-gather seq; backward: reduce-scatter."""
    _raw = staticmethod(_allgather_rs)


class ReduceScatterOp(_SeqOp):
    """forward: reduce-scatter seq; backward: all-gather."""
    _raw = staticmethod(_rs_ag)


def scatter(x, axis: int = 0, group=None):
    return ScatterOp.apply(x, axis, group)


def all_gather(x, axis: int = 0, group=None):
    return AllGatherOp.apply(x, axis, group)


def mark_as_sequence_parallel_parameter(parameter):
    """Mark a parameter outside the tensor-parallel matmuls (norms,
    biases) whose gradient the reference all-reduces over mp. The port's
    gradients of such replicated parameters are already the sums, so the
    mark is metadata."""
    parameter.sequence_parallel = True
    return parameter


def is_sequence_parallel_parameter(parameter) -> bool:
    return bool(getattr(parameter, "sequence_parallel", False))


def register_sequence_parallel_allreduce_hooks(model, accumulation_steps=1,
                                               fuse_sequence_parallel_allreduce=False):
    """The reference installs gradient all-reduce hooks for marked
    parameters; the port's gradients are already reduced: nothing to
    install."""
    return None


class ColumnSequenceParallelLinear(ColumnParallelLinear):
    """ColumnParallel entered from a seq-sharded activation: all-gather
    the sequence, then the local matmul. ``seq_axis`` selects the
    sequence dim."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, gather_output=False, fuse_matmul_bias=False,
                 mp_group=None, seq_axis: int = 0, name=None):
        super().__init__(in_features, out_features, weight_attr=weight_attr,
                         has_bias=has_bias, gather_output=gather_output,
                         fuse_matmul_bias=fuse_matmul_bias, mp_group=mp_group,
                         name=name)
        self.seq_axis = seq_axis

    def forward(self, x):
        x = AllGatherOp.apply(x, self.seq_axis, self.axis)
        # no c_identity: AllGatherOp's reduce-scatter backward IS the mp
        # gradient reduction (a psum on top would scale it by mp)
        if region_axis_bound(self.axis):
            w = _local_shard(self.weight, self.axis, self.out_features, 1)
            b = _local_shard(self.bias, self.axis, self.out_features, 0)
            y = F.linear(x, w, b)
            return mp_ops.c_concat(y, self.axis) if self.gather_output else y
        return _column(x, self.weight, self.bias, self.axis)


class RowSequenceParallelLinear(RowParallelLinear):
    """RowParallel leaving into a seq-sharded activation: the local
    matmul, then a reduce-scatter over the sequence in place of the mp
    all-reduce."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, input_is_parallel=True, fuse_matmul_bias=False,
                 mp_group=None, seq_axis: int = 0, name=None):
        super().__init__(in_features, out_features, weight_attr=weight_attr,
                         has_bias=has_bias, input_is_parallel=input_is_parallel,
                         fuse_matmul_bias=fuse_matmul_bias, mp_group=mp_group,
                         name=name)
        self.seq_axis = seq_axis

    def forward(self, x):
        if region_axis_bound(self.axis):
            w = _local_shard(self.weight, self.axis, self.in_features, 0)
            if not self.input_is_parallel:
                x = mp_ops.c_split(x, self.axis)
            y = F.linear(x, w)
        else:
            y = _row(x, self.weight, self.axis)
        y = ReduceScatterOp.apply(y, self.seq_axis, self.axis)
        if self.bias is not None:
            y = y + self.bias
        return y

"""Tensor-parallel primitive ops — counterpart of
``paddle_tpu/distributed/fleet/layers/mpu/mp_ops.py`` (``c_identity``,
``mp_allreduce``, ``c_split``, ``c_concat``, ``c_constrain``).

Each primitive has the reference's two lowerings:

* **Outside a region** a value is the full logical tensor (the JAX
  package's GSPMD path), so the primitives are identities: the layers of
  :mod:`.mp_layers` do each shard's work themselves and their results are
  already the logical values.
* **Inside a per-coordinate region** (``distributed.dist_tensor.shard_map``)
  values are per-coordinate locals, and each primitive is a collective
  over the mp groups with the reference's forward/backward pairing:
  identity/psum, psum/identity, split/all-gather, all-gather/split. Every
  reduction runs in rank order on the group's first device.
"""

from __future__ import annotations

from typing import List

import torch

from ....dist_tensor import group_op, region_axis_bound, in_region
from ....topology import get_hybrid_communicate_group
from .....ops._helpers import ensure_tensor

__all__ = ["c_identity", "mp_allreduce", "c_split", "c_concat", "c_constrain",
           "in_mp_region", "mp_axis_size", "mp_axis_name", "axis_index"]

_MP_AXIS = "mp"


def mp_axis_name(group=None) -> str:
    if group is None:
        return _MP_AXIS
    if isinstance(group, str):
        return group
    name = getattr(group, "name", None)
    if isinstance(name, str):
        return name
    raise TypeError(f"unsupported mp group: {group!r}")


def in_mp_region(axis: str = _MP_AXIS) -> bool:
    """True inside a region whose mesh has the mp axis."""
    return region_axis_bound(axis)


def mp_axis_size(axis: str = _MP_AXIS) -> int:
    hcg = get_hybrid_communicate_group()
    return int(hcg.mesh.shape.get(axis, 1))


def axis_index(axis: str):
    """Inside a region: each coordinate's rank along ``axis`` (an int64
    scalar per coordinate), ``lax.axis_index``'s counterpart."""
    region = in_region()
    names = axis if isinstance(axis, tuple) else (axis,)
    return region.wrap({c: torch.tensor(region.mesh.rank_in(c, names),
                                        device=region.mesh.devices[c])
                        for c in region.coords})


# -- one group's collectives (values in rank order) -------------------------

def _ident(xs: List[torch.Tensor]) -> List[torch.Tensor]:
    return list(xs)


def _sum(xs: List[torch.Tensor]) -> List[torch.Tensor]:
    acc = xs[0]
    for x in xs[1:]:
        acc = acc + x.to(acc.device)
    return [acc if j == 0 else acc.to(x.device, copy=True)
            for j, x in enumerate(xs)]


def _max(xs: List[torch.Tensor]) -> List[torch.Tensor]:
    acc = xs[0]
    for x in xs[1:]:
        acc = torch.maximum(acc, x.to(acc.device))
    return [acc.to(x.device) for x in xs]


def _cat(dim: int):
    def f(xs):
        full = torch.cat([x.to(xs[0].device) for x in xs], dim=dim)
        return [full if j == 0 else full.to(x.device, copy=True)
                for j, x in enumerate(xs)]
    return f


def _slice(dim: int):
    def f(xs):
        n = len(xs)
        return [x.chunk(n, dim)[j].contiguous() for j, x in enumerate(xs)]
    return f


def _reduce_scatter(dim: int):
    def f(xs):
        return _slice(dim)(_sum(xs))
    return f


# -- the region collectives, paired as the reference's custom VJPs ----------

def _identity_psum_bwd(x, axis):
    """Identity forward / psum backward (enters a column-parallel region)."""
    return group_op(x, axis, _ident, _sum)


def _psum_identity_bwd(x, axis):
    """psum forward / identity backward (leaves a row-parallel region)."""
    return group_op(x, axis, _sum, _ident)


def _psum(x, axis):
    """``lax.psum``: its transpose is psum."""
    return group_op(x, axis, _sum, _sum)


def _pmax(x, axis):
    """``lax.pmax`` (not differentiable)."""
    return group_op(x, axis, _max)


def _split_dim(x, axis, dim):
    """This rank's chunk along ``dim`` / backward all-gather."""
    return group_op(x, axis, _slice(dim), _cat(dim))


def _concat_dim(x, axis, dim):
    """All-gather along ``dim`` / backward this rank's chunk."""
    return group_op(x, axis, _cat(dim), _slice(dim))


def _allgather_rs(x, axis, dim):
    """All-gather forward / reduce-scatter backward (AllGatherOp)."""
    return group_op(x, axis, _cat(dim), _reduce_scatter(dim))


def _rs_ag(x, axis, dim):
    """Reduce-scatter forward / all-gather backward (ReduceScatterOp)."""
    return group_op(x, axis, _reduce_scatter(dim), _cat(dim))


def _split_last(x, axis):
    return _split_dim(x, axis, x.ndim - 1)


def _concat_last(x, axis):
    return _concat_dim(x, axis, x.ndim - 1)


# -- public primitives -------------------------------------------------------

def c_identity(t, group=None):
    """Identity forward / mp-allreduce backward (enters a ColumnParallel
    region); outside a region the identity."""
    axis = mp_axis_name(group)
    t = ensure_tensor(t)
    return _identity_psum_bwd(t, axis) if in_mp_region(axis) else t


def mp_allreduce(t, group=None):
    """mp-allreduce forward / identity backward (leaves a RowParallel
    region); outside a region the value is already the reduced one."""
    axis = mp_axis_name(group)
    t = ensure_tensor(t)
    return _psum_identity_bwd(t, axis) if in_mp_region(axis) else t


def c_split(t, group=None):
    """Split the last dim over the mp axis (rank r takes chunk r); outside
    a region the logical value is unchanged."""
    axis = mp_axis_name(group)
    t = ensure_tensor(t)
    return _split_last(t, axis) if in_mp_region(axis) else t


def c_concat(t, group=None):
    """Concatenate the last dim over the mp axis (all-gather); outside a
    region the logical value is unchanged."""
    axis = mp_axis_name(group)
    t = ensure_tensor(t)
    return _concat_last(t, axis) if in_mp_region(axis) else t


def c_constrain(t, spec):
    """The reference's GSPMD layout hint: the port places values itself,
    so the value passes unchanged."""
    return ensure_tensor(t)

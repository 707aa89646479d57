"""The auto-parallel API — counterpart of
``paddle_tpu/distributed/auto_parallel.py`` (``ProcessMesh``, ``Shard``,
``Replicate``, ``Partial``, ``shard_tensor``, ``reshard``,
``dtensor_from_fn``, ``shard_layer``, ``set_mesh``, ``get_mesh``).

A ``ProcessMesh`` names a grid of process ids; the port maps id ``i`` to
entry ``i`` of a placement (``devices=``, default every device the
process drives, the CPU standing for each id on a host without a card,
as the test suite's virtual host devices do). ``shard_tensor`` turns
placements into a spec and returns a :class:`~.dist_tensor.DistTensor`
(a ``DistParameter`` for a ``Parameter``) with one local per mesh
coordinate. The port has no sharding propagation: an op on distributed
tensors reads their logical values and gives an ordinary tensor on the
lead device.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from ..core.tensor import Parameter
from ..device import resolve_device
from ..ops._helpers import ensure_tensor
from .dist_tensor import DistParameter, DistTensor
from .sharding import shard_to_mesh
from .topology import Mesh, local_devices

__all__ = ["ProcessMesh", "Shard", "Replicate", "Partial", "Placement",
           "shard_tensor", "reshard", "dtensor_from_fn", "shard_layer",
           "get_mesh", "set_mesh", "placements_to_spec"]



class Placement:
    pass


class Shard(Placement):
    """Shard the tensor's dim ``d`` across this mesh dimension."""

    def __init__(self, dim: int):
        self.dim = int(dim)

    def is_shard(self, dim=None):
        return dim is None or dim == self.dim

    def is_replicated(self):
        return False

    def is_partial(self):
        return False

    def __repr__(self):
        return f"Shard(dim={self.dim})"

    def __eq__(self, o):
        return isinstance(o, Shard) and o.dim == self.dim

    def __hash__(self):
        return hash(("shard", self.dim))


class Replicate(Placement):
    def is_shard(self, dim=None):
        return False

    def is_replicated(self):
        return True

    def is_partial(self):
        return False

    def __repr__(self):
        return "Replicate()"

    def __eq__(self, o):
        return isinstance(o, Replicate)

    def __hash__(self):
        return hash("replicate")


class Partial(Placement):
    """Pending-reduction placement. NamedSharding cannot express partial values
    on an eager array; eagerly resharding a Partial runs the reduction (matching
    the reference's p_to_r reshard). Inside compiled programs XLA tracks partials
    natively."""

    def __init__(self, reduce_type: str = "sum"):
        self.reduce_type = reduce_type

    def is_shard(self, dim=None):
        return False

    def is_replicated(self):
        return False

    def is_partial(self):
        return True

    def __repr__(self):
        return f"Partial({self.reduce_type})"

    def __eq__(self, o):
        return isinstance(o, Partial) and o.reduce_type == self.reduce_type

    def __hash__(self):
        return hash(("partial", self.reduce_type))


def _placement(n: int) -> List[torch.device]:
    devs = local_devices()
    if len(devs) >= n:
        return devs[:n]
    if devs == [torch.device("cpu")]:
        return devs * n
    raise ValueError(f"ProcessMesh needs {n} devices, have {len(devs)}")


class ProcessMesh:
    """``paddle.distributed.ProcessMesh``: process ids in a grid, named
    dims, over a device placement (``mesh`` is the port's :class:`Mesh`)."""

    def __init__(self, mesh, dim_names: Optional[List[str]] = None,
                 devices: Optional[Sequence] = None):
        if isinstance(mesh, Mesh):
            self.mesh = mesh
            self.shape = list(mesh.devices.shape)
            self.dim_names = list(mesh.axis_names)
            return
        arr = np.asarray(mesh)
        if dim_names is None:
            dim_names = [f"d{i}" for i in range(arr.ndim)]
        devs = [resolve_device(d) for d in devices] if devices is not None \
            else _placement(int(arr.max()) + 1)
        picked = np.empty(arr.size, dtype=object)
        for i, pid in enumerate(arr.reshape(-1)):
            picked[i] = devs[int(pid)]
        self.mesh = Mesh(picked.reshape(arr.shape), dim_names)
        self.shape = list(arr.shape)
        self.dim_names = list(dim_names)

    @property
    def process_ids(self):
        return list(range(int(np.prod(self.shape))))

    def get_dim_size(self, name: str) -> int:
        return self.shape[self.dim_names.index(name)]

    def __repr__(self):
        return f"ProcessMesh(shape={self.shape}, dim_names={self.dim_names})"


_global_mesh: Optional[ProcessMesh] = None


def set_mesh(mesh: Union[ProcessMesh, Mesh]):
    global _global_mesh
    _global_mesh = mesh if isinstance(mesh, ProcessMesh) else ProcessMesh(mesh)


def get_mesh() -> Optional[ProcessMesh]:
    return _global_mesh


def _mesh_of(mesh) -> Mesh:
    return mesh.mesh if isinstance(mesh, ProcessMesh) else mesh


def placements_to_spec(placements: Sequence[Placement], mesh: Mesh,
                       ndim: int) -> tuple:
    """[per-mesh-dim placements] -> a spec over the tensor's dims."""
    entries: List[Optional[object]] = [None] * ndim
    for mesh_dim, pl in enumerate(placements):
        if isinstance(pl, Shard):
            axis_name = mesh.axis_names[mesh_dim]
            d = pl.dim if pl.dim >= 0 else pl.dim + ndim
            if entries[d] is None:
                entries[d] = axis_name
            elif isinstance(entries[d], tuple):
                entries[d] = entries[d] + (axis_name,)
            else:
                entries[d] = (entries[d], axis_name)
    return tuple(entries)


def shard_tensor(x, mesh: Union[ProcessMesh, Mesh],
                 placements: Sequence[Placement], dtype=None,
                 stop_gradient=None):
    """``paddle.distributed.shard_tensor``: ``x``'s logical value cut by
    ``placements`` over ``mesh`` into a new DistTensor (DistParameter for
    a Parameter, its name kept)."""
    t = ensure_tensor(x)
    if any(isinstance(p, Partial) for p in placements):
        raise ValueError("shard_tensor cannot create Partial placements eagerly; "
                         "Partial arises from computation inside compiled programs")
    m = _mesh_of(mesh)
    value = t._value.detach()
    if dtype is not None:
        from ..core.dtype import canonical_dtype
        value = value.to(canonical_dtype(dtype))
    st = shard_to_mesh(value, m, placements_to_spec(placements, m, t.ndim),
                       name=t.name)
    sg = t.stop_gradient if stop_gradient is None else stop_gradient
    cls = DistParameter if isinstance(x, Parameter) else DistTensor
    out = cls._of(st, name=t.name, stop_gradient=sg)
    if isinstance(x, Parameter):
        out.persistable = True
    out.placements = list(placements)
    out.process_mesh = mesh if isinstance(mesh, ProcessMesh) \
        else ProcessMesh(m)
    for attr in ("optimize_attr", "regularizer", "need_clip"):
        if hasattr(t, attr):
            setattr(out, attr, getattr(t, attr))
    return out


def reshard(x, mesh, placements):
    """An explicit relayout: the logical value cut anew."""
    return shard_tensor(x, mesh, placements)


def dtensor_from_fn(fn, mesh, placements, *args, **kwargs):
    return shard_tensor(fn(*args, **kwargs), mesh, placements)


def shard_layer(layer, process_mesh, shard_fn=None, input_fn=None,
                output_fn=None):
    """``paddle.distributed.shard_layer``: ``shard_fn(name, sublayer,
    mesh)`` on every sublayer (default: each parameter replicated over the
    mesh)."""

    def default_shard(name, sublayer, mesh):
        for pname, p in list(sublayer._parameters.items()):
            if p is None or getattr(p, "process_mesh", None) is not None:
                continue
            sublayer._parameters[pname] = shard_tensor(
                p, mesh, [Replicate()] * len(_mesh_of(mesh).axis_names))

    fn = shard_fn or default_shard
    for name, sub in layer.named_sublayers(include_self=True):
        fn(name, sub, process_mesh)
    if input_fn is not None:
        layer.register_forward_pre_hook(
            lambda l, inp: input_fn(inp, process_mesh))
    if output_fn is not None:
        layer.register_forward_post_hook(
            lambda l, inp, out: output_fn(out, process_mesh))
    return layer

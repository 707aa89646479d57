"""Splitting tensors over a placement — counterpart of ``shard_dim_spec``
in ``paddle_tpu/distributed/sharding.py`` and of ``jax.device_put`` with a
``NamedSharding``.

Where the JAX package returns a ``PartitionSpec`` and lets ``device_put``
lay the shards out, the port cuts the tensor itself: one contiguous,
separately allocated copy per placement entry (a strided view would be
refused by the CUDA kernels, which take contiguous operands). The dim's
divisibility is part of the contract and is checked first, with the
reference's structured errors.

* :func:`shard_tensor` / :func:`unshard`: one dim over a serving
  placement (tensor-parallel serving).
* :class:`ShardedTensor` / :func:`shard_to_mesh` (:func:`shard_tree`
  for a tree of them) / :func:`assemble`: a
  tensor over a :class:`~.topology.Mesh` by a spec, the reference's
  ``PartitionSpec`` written as a plain tuple with one entry per leading
  dim (an axis name, a tuple of names, or None). Every mesh coordinate
  holds its own local tensor, as JAX lays an array out over its devices:
  a dim whose entry names axes is cut into their product of parts (part
  index row-major over those axes), every other axis holds copies.
* The eager ZeRO stages (``group_sharded_parallel`` at ``os``, ``os_g``
  and ``p_g_os``; :func:`shard_optimizer_states`, :func:`shard_params`):
  stage 1 lays each optimizer state out over the ``sharding`` axis on
  the first dim that splits evenly (so each coordinate holds 1/n of it,
  and updates only that slice: ``dist_tensor.laid_out_step``); stage 3
  also makes each parameter a ``DistParameter`` cut the same way, joined
  where it is used. Stage 2 is stage 1 here: a gradient follows its
  parameter's layout.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["shard_dim_spec", "shard_tensor", "unshard", "ShardedTensor",
           "shard_to_mesh", "shard_tree", "assemble", "spec_axes",
           "group_sharded_parallel", "shard_optimizer_states", "shard_params"]


def shard_dim_spec(shape, n: int, axis: str, dim: int,
                   name: str = "tensor") -> int:
    """Check that ``dim`` of ``shape`` splits evenly over ``n`` shards of
    mesh axis ``axis`` and return it normalized (non-negative). An
    out-of-range ``dim`` and an indivisible size raise the reference's
    ``ValueError``\\ s, naming the tensor, the axis and the size."""
    n = int(n)
    if not -len(shape) <= dim < len(shape):
        raise ValueError(
            f"cannot shard {name}: dim {dim} is out of range for shape "
            f"{tuple(shape)} (rank {len(shape)})")
    d = dim % len(shape)
    if shape[d] % n or shape[d] == 0:
        raise ValueError(
            f"cannot shard {name}: dim {d} (size {shape[d]} of shape "
            f"{tuple(shape)}) is not divisible by mesh axis {axis!r} "
            f"(size {n})")
    return d


def shard_tensor(t: torch.Tensor, devices: Sequence[torch.device], dim: int,
                 name: str = "tensor", axis: str = "tp"
                 ) -> Tuple[torch.Tensor, ...]:
    """``t`` cut on ``dim`` into ``len(devices)`` equal parts, part ``s``
    a contiguous copy of its own on ``devices[s]`` (in shard order)."""
    d = shard_dim_spec(t.shape, len(devices), axis, dim, name)
    parts = torch.chunk(t, len(devices), dim=d)
    return tuple(torch.empty(p.shape, dtype=p.dtype, device=dev).copy_(p)
                 for p, dev in zip(parts, devices))


def unshard(parts: Sequence[torch.Tensor], dim: int,
            device=None) -> torch.Tensor:
    """The inverse of :func:`shard_tensor`: the parts concatenated on
    ``dim`` in shard order, on ``device`` (default: part 0's)."""
    dev = parts[0].device if device is None else device
    return torch.cat([p.to(dev) for p in parts], dim=dim)


def spec_axes(entry) -> Tuple[str, ...]:
    """The mesh axes one spec entry names: ``None`` -> ``()``, a name ->
    ``(name,)``, a tuple of names as it is."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


class ShardedTensor:
    """A tensor of ``shape`` laid out over ``mesh`` by ``spec``: the local
    tensor of every mesh coordinate (``locals``, coordinate -> tensor on
    that coordinate's device). Replicas along axes the spec does not name
    are separate copies."""

    def __init__(self, mesh, spec: tuple, shape: tuple,
                 locals_: Dict[tuple, torch.Tensor]):
        self.mesh = mesh
        self.spec = tuple(spec)
        self.shape = tuple(shape)
        self.locals = locals_

    @property
    def dtype(self) -> torch.dtype:
        return self.local(self.mesh.coords()[0]).dtype

    @property
    def lead(self) -> torch.device:
        """The device of the mesh's first coordinate."""
        return self.mesh.devices.flat[0]

    def local(self, coord) -> torch.Tensor:
        return self.locals[tuple(coord)]

    def index(self, coord) -> tuple:
        """The slice ``coord`` holds, as ``(start, stop, step)`` per dim:
        ``(0, None, 1)`` for a whole dim, as JAX's shard indices read."""
        out = []
        for d, n in enumerate(self.shape):
            axes = spec_axes(self.spec[d]) if d < len(self.spec) else ()
            if not axes:
                out.append((0, None, 1))
                continue
            parts = int(np.prod([self.mesh.shape[a] for a in axes]))
            i, size = self.mesh.rank_in(coord, axes), n // parts
            out.append((i * size, (i + 1) * size, 1))
        return tuple(out)

    def unique(self) -> List[Tuple[tuple, tuple]]:
        """``(index, coordinate)`` of each distinct slice, at the first
        coordinate (mesh order) that holds it."""
        seen: Dict[tuple, tuple] = {}
        for c in self.mesh.coords():
            seen.setdefault(self.index(c), c)
        return [(idx, c) for idx, c in seen.items()]

    def nbytes_at(self, coord) -> int:
        t = self.local(coord)
        return t.numel() * t.element_size()

    def map_locals(self, fn) -> "ShardedTensor":
        """The same layout with ``fn(local)`` at every coordinate."""
        return ShardedTensor(self.mesh, self.spec, self.shape,
                             {c: fn(t) for c, t in self.locals.items()})

    def __repr__(self):
        return (f"ShardedTensor(shape={self.shape}, spec={self.spec}, "
                f"mesh={self.mesh.shape})")


def shard_to_mesh(t: torch.Tensor, mesh, spec: tuple,
                  name: str = "tensor") -> ShardedTensor:
    """``t`` cut by ``spec`` over ``mesh``: every coordinate gets a
    contiguous copy of its slice on its device. A spec longer than ``t``'s
    rank, an axis the mesh lacks or names twice, and an indivisible dim
    raise ``ValueError`` naming the tensor (the last through
    :func:`shard_dim_spec`: the axis and the size too)."""
    spec = tuple(spec)
    if len(spec) > t.dim():
        raise ValueError(f"cannot shard {name}: spec {spec} has more "
                         f"entries than its rank {t.dim()}")
    used = [a for e in spec for a in spec_axes(e)]
    for a in used:
        if a not in mesh.shape:
            raise ValueError(f"cannot shard {name}: mesh has no axis {a!r} "
                             f"(axes {mesh.axis_names})")
    if len(set(used)) != len(used):
        raise ValueError(f"cannot shard {name}: spec {spec} names an axis "
                         f"twice")
    for d, e in enumerate(spec):
        axes = spec_axes(e)
        if axes:
            parts = int(np.prod([mesh.shape[a] for a in axes]))
            shard_dim_spec(t.shape, parts, e, d, name)
    st = ShardedTensor(mesh, spec, tuple(t.shape), {})
    for c in mesh.coords():
        part = t[tuple(slice(a, b) for a, b, _ in st.index(c))]
        st.locals[c] = torch.empty(part.shape, dtype=t.dtype,
                                   device=mesh.devices[c]).copy_(part)
    return st


def shard_tree(tree, mesh, specs, name: str = "params"):
    """:func:`shard_to_mesh` of each leaf of the nested dict ``tree`` by the
    same-shaped tree of specs ``specs`` (an error names the leaf's path
    from ``name``)."""
    if isinstance(tree, dict):
        return {k: shard_tree(v, mesh, specs[k], f"{name}.{k}")
                for k, v in tree.items()}
    return shard_to_mesh(tree, mesh, specs, name=name)


def assemble(st: ShardedTensor, device=None) -> torch.Tensor:
    """The inverse of :func:`shard_to_mesh`: the whole tensor on
    ``device`` (default: the mesh's first coordinate's), each slice taken
    from the first coordinate that holds it."""
    dev = st.lead if device is None else torch.device(device)
    out = torch.empty(st.shape, dtype=st.dtype, device=dev)
    for idx, c in st.unique():
        out[tuple(slice(a, b) for a, b, _ in idx)] = st.local(c).detach()
    return out


# ---------------------------------------------------------------------------
# the eager ZeRO stages
# ---------------------------------------------------------------------------

def _first_split(shape, n: int) -> tuple:
    """The spec cutting the first dim of ``shape`` that splits evenly into
    ``n`` over ``sharding`` (replicated when none does)."""
    for d, size in enumerate(shape):
        if size > 0 and size % n == 0:
            return (None,) * d + ("sharding",)
    return ()


def shard_optimizer_states(optimizer, hcg=None):
    """Stage 1: lay the optimizer's states (and master weights) out over
    the ``sharding`` axis; states made later follow at creation."""
    from .dist_tensor import DistTensor, dist_tensor, state_layout
    from .topology import get_hybrid_communicate_group
    hcg = hcg or get_hybrid_communicate_group()
    optimizer._sharding_axis = "sharding"
    optimizer._sharding_mesh = hcg.mesh
    params = {p.name: p for p in optimizer._params()}

    def relay(t, p):
        layout = state_layout(optimizer, p)
        if layout is None or isinstance(t, DistTensor):
            return t
        mesh, spec = layout
        return dist_tensor(t._value, mesh, spec if t.ndim else ())

    for store in optimizer._accumulators.values():
        for pname in list(store):
            if pname in params:
                store[pname] = relay(store[pname], params[pname])
    for pname in list(optimizer._master_weights):
        if pname in params:
            optimizer._master_weights[pname] = relay(
                optimizer._master_weights[pname], params[pname])
    return optimizer


def shard_params(model, hcg=None):
    """Stage 3: each parameter becomes a ``DistParameter`` cut over the
    ``sharding`` axis on its first evenly splitting dim (replicated when
    none does)."""
    from .dist_tensor import DistTensor, distribute
    from .topology import get_hybrid_communicate_group
    hcg = hcg or get_hybrid_communicate_group()
    n = hcg.get_sharding_parallel_world_size()
    for p in model.parameters():
        if not isinstance(p, DistTensor):
            distribute(p, hcg.mesh, _first_split(p.shape, n))
    return model


def group_sharded_parallel(model, optimizer, level: str = "os", scaler=None,
                           group=None, offload=False, sync_buffers=False,
                           buffer_max_size=2 ** 23, segment_size=2 ** 20,
                           sync_comm=False, dp_group=None,
                           exclude_layer=None):
    """``paddle.distributed.sharding.group_sharded_parallel``: ``level``
    "os" (stage 1), "os_g" (stage 2) or "p_g_os" (stage 3)."""
    if level not in ("os", "os_g", "p_g_os"):
        raise ValueError(f"unknown group_sharded level {level!r}")
    from .topology import get_hybrid_communicate_group
    hcg = get_hybrid_communicate_group()
    shard_optimizer_states(optimizer, hcg)
    if level == "p_g_os":
        shard_params(model, hcg)
    return model, optimizer, scaler

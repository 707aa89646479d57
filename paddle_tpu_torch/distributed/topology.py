"""Hybrid-parallel topology — counterpart of
``paddle_tpu/distributed/topology.py``.

The JAX package grids its devices into a named ``jax.sharding.Mesh`` over
the axes ``dp, pp, sharding, ep, sep, mp`` (mp innermost) and runs one
host program over it. The port does the same over a PLACEMENT: a
:class:`Mesh` is a numpy object array of ``torch.device`` in that axis
order, one entry per mesh coordinate. Entries may repeat, so every
coordinate can sit on one card (``["cuda:0"] * 8``) or on the CPU
(``["cpu"] * 8``, the counterpart of the test suite's virtual host
devices). :class:`HybridCommunicateGroup` and the
``get_``/``set_hybrid_communicate_group`` singleton keep the reference's
names; one process owns every coordinate, so every rank it reports is 0,
as in the reference's single-controller branch.

The serving tensor-parallel placement (:func:`tp_devices`, counterpart of
``tp_mesh``) is an ordered list of ``tp`` devices: shard ``s`` of the QKV
projections and of the paged KV pool lives on entry ``s`` and everything
replicated on entry 0 (the lead device); an in-process fleet stacks its
TP replicas on the same slice, as the reference's does.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["HybridCommunicateGroup", "Mesh", "ParallelAxis",
           "build_mesh", "get_hybrid_communicate_group", "local_devices",
           "set_hybrid_communicate_group", "tp_devices"]

# outermost -> innermost, the reference's order (mp innermost)
_AXIS_ORDER = ("dp", "pp", "sharding", "ep", "sep", "mp")


class Mesh:
    """A named grid of devices: ``devices`` is a numpy object array of
    ``torch.device`` whose dims follow ``axis_names``; ``shape`` maps each
    axis name to its size (the fields of ``jax.sharding.Mesh`` the port
    reads)."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def coords(self):
        """Every coordinate (an index tuple into ``devices``), in row-major
        order: the mesh's fixed rank order."""
        return list(np.ndindex(*self.devices.shape))

    def group(self, coord, axes: Sequence[str]):
        """The coordinates that differ from ``coord`` only along ``axes``,
        in row-major order over ``axes``: one communication group."""
        dims = [self.axis_names.index(a) for a in axes]
        out = []
        for sub in np.ndindex(*(self.devices.shape[d] for d in dims)):
            c = list(coord)
            for d, i in zip(dims, sub):
                c[d] = i
            out.append(tuple(c))
        return out

    def rank_in(self, coord, axes: Sequence[str]) -> int:
        """``coord``'s rank in its group over ``axes`` (row-major)."""
        r = 0
        for a in axes:
            d = self.axis_names.index(a)
            r = r * self.devices.shape[d] + coord[d]
        return r

    def __repr__(self):
        return f"Mesh({self.shape}, devices={list(self.devices.flat)})"


def local_devices() -> List[torch.device]:
    """The devices this process drives: every CUDA device, or the CPU when
    there is no card."""
    if torch.cuda.is_available():
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def build_mesh(degrees: Dict[str, int],
               devices: Optional[Sequence[Any]] = None) -> Mesh:
    """The hybrid mesh for axis ``degrees`` (missing axes get size 1) over
    ``devices`` (default :func:`local_devices`; repeats allowed). The
    product of the degrees must equal the device count: the reference's
    error otherwise."""
    devices = list(devices if devices is not None else local_devices())
    shape = [int(degrees.get(a, 1)) for a in _AXIS_ORDER]
    n = int(np.prod(shape))
    if n != len(devices):
        raise ValueError(
            f"hybrid degrees {dict(zip(_AXIS_ORDER, shape))} require {n} "
            f"devices, got {len(devices)}")
    arr = np.empty(n, dtype=object)
    for i, d in enumerate(devices):
        arr[i] = _indexed(resolve_device(d))
    return Mesh(arr.reshape(shape), _AXIS_ORDER)


class ParallelAxis:
    """One parallel dimension (the reference's per-axis communication
    group): ``name`` is a mesh axis name or a tuple of them, a group over
    the product of those axes."""

    def __init__(self, mesh: Mesh, name):
        self.mesh = mesh
        self.name = tuple(name) if isinstance(name, (tuple, list)) else name

    @property
    def names(self) -> tuple:
        return self.name if isinstance(self.name, tuple) else (self.name,)

    @property
    def nranks(self) -> int:
        n = 1
        for a in self.names:
            n *= int(self.mesh.shape[a])
        return n

    @property
    def world_size(self) -> int:
        return self.nranks

    def coords(self):
        """The group's coordinates, rank order, every other axis at 0."""
        return self.mesh.group((0,) * len(self.mesh.axis_names), self.names)

    def devices(self) -> List[torch.device]:
        """The device of each rank, in rank order."""
        return [self.mesh.devices[c] for c in self.coords()]

    def __repr__(self):
        return f"ParallelAxis({self.name}, size={self.nranks})"


class HybridCommunicateGroup:
    """The fleet topology (the reference's ``HybridCommunicateGroup``):
    degrees per axis, the mesh over ``devices``, one
    :class:`ParallelAxis` per axis, and the reference's query names."""

    def __init__(self, dp: int = 1, mp: int = 1, pp: int = 1,
                 sharding: int = 1, sep: int = 1, ep: int = 1,
                 devices: Optional[Sequence[Any]] = None):
        self.degrees = {"dp": dp, "mp": mp, "pp": pp, "sharding": sharding,
                        "sep": sep, "ep": ep}
        self.mesh = build_mesh(self.degrees, devices)
        self._axes = {a: ParallelAxis(self.mesh, a) for a in _AXIS_ORDER}

    def get_data_parallel_world_size(self) -> int:
        return self.degrees["dp"]

    def get_model_parallel_world_size(self) -> int:
        return self.degrees["mp"]

    def get_pipe_parallel_world_size(self) -> int:
        return self.degrees["pp"]

    def get_sharding_parallel_world_size(self) -> int:
        return self.degrees["sharding"]

    def get_sep_parallel_world_size(self) -> int:
        return self.degrees["sep"]

    def get_expert_parallel_world_size(self) -> int:
        return self.degrees["ep"]

    def get_data_parallel_group(self) -> ParallelAxis:
        return self._axes["dp"]

    def get_model_parallel_group(self) -> ParallelAxis:
        return self._axes["mp"]

    def get_pipe_parallel_group(self) -> ParallelAxis:
        return self._axes["pp"]

    def get_sharding_parallel_group(self) -> ParallelAxis:
        return self._axes["sharding"]

    def get_sep_parallel_group(self) -> ParallelAxis:
        return self._axes["sep"]

    def get_expert_parallel_group(self) -> ParallelAxis:
        return self._axes["ep"]

    # One process owns every coordinate of every axis (single-controller),
    # so its rank along any axis is the canonical 0, as the reference
    # returns outside a traced region.
    def _axis_rank(self, name: str) -> int:
        return 0

    def get_data_parallel_rank(self) -> int:
        return self._axis_rank("dp")

    def get_model_parallel_rank(self) -> int:
        return self._axis_rank("mp")

    def get_sharding_parallel_rank(self) -> int:
        return self._axis_rank("sharding")

    def get_sep_parallel_rank(self) -> int:
        return self._axis_rank("sep")

    def get_expert_parallel_rank(self) -> int:
        return self._axis_rank("ep")

    def get_stage_id(self) -> int:
        return self._axis_rank("pp")

    def topology(self):
        return self.degrees

    def __repr__(self):
        return f"HybridCommunicateGroup({self.degrees})"


_hcg: Optional[HybridCommunicateGroup] = None


def set_hybrid_communicate_group(hcg: Optional[HybridCommunicateGroup]):
    global _hcg
    _hcg = hcg


def get_hybrid_communicate_group() -> HybridCommunicateGroup:
    """The process's group; by default pure data parallel over every
    device the process drives (:func:`local_devices`: the CUDA devices, or
    the one CPU). The default places no tensor."""
    global _hcg
    if _hcg is None:
        devs = local_devices()
        _hcg = HybridCommunicateGroup(dp=len(devs), devices=devs)
    return _hcg


def tp_devices(tp: int, device: Union[None, Any, Sequence[Any]] = None
               ) -> List[torch.device]:
    """The placement of a serving engine at tensor-parallel degree ``tp``.

    * ``"cpu"``: ``[cpu] * tp``;
    * ``None`` / ``"cuda"``: ``cuda:0 .. cuda:tp-1`` (``"cuda:i"``: from
      ``cuda:i`` on; at ``tp == 1`` the device as given), or a structured
      error when the platform has fewer CUDA devices than that — a
      placement never shrinks and never falls back to the CPU;
    * a list or tuple of ``tp`` devices: used as given, repeats allowed
      (two shards on one card: ``["cuda:0", "cuda:0"]``).

    ``tp < 1`` raises the reference's ">= 1" error."""
    tp = int(tp)
    if tp < 1:
        raise ValueError(f"tensor-parallel degree must be >= 1, got {tp}")
    if isinstance(device, (list, tuple)):
        if len(device) != tp:
            raise ValueError(
                f"tensor-parallel degree tp={tp} needs {tp} devices but "
                f"the placement lists {len(device)} ({list(device)}); "
                f"give one device a shard")
        return [_indexed(resolve_device(d)) for d in device]
    dev = resolve_device(device)
    if dev.type == "cpu" or tp == 1:
        return [dev] * tp
    first = dev.index or 0
    n = torch.cuda.device_count()
    if first + tp > n:
        raise ValueError(
            f"tensor-parallel degree tp={tp} needs {tp} devices but the "
            f"platform has {n - first} (from cuda:{first}); lower "
            f"ServingConfig.tp / FLAGS_serving_tp, or place several shards "
            f"on one card with device=['cuda:0', 'cuda:0', ...]")
    return [torch.device("cuda", first + s) for s in range(tp)]


def _indexed(dev: torch.device) -> torch.device:
    """A CUDA device with its index (an index-less ``cuda`` is the current
    device), so placements compare equal to tensors' devices."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev

"""The collective API (``all_reduce`` and the rest) — counterpart of
``paddle_tpu/distributed/collective.py``.

One process drives every rank of a group (single-controller), as the JAX
package does over its mesh. "Each rank holds its own tensor" is encoded
in either of two forms, and every call returns the form it was given:

* a tensor whose leading dim is the group's rank count (row ``r`` is rank
  ``r``'s tensor): the reference's encoding;
* a list of per-rank tensors, rank ``r``'s on its own device (the form
  the sharded train step uses): rank ``r``'s result lands on the device
  of its input.

``all_reduce``, ``broadcast`` and ``scatter`` update the given tensor (or
the list's tensors) in place, where the reference rebinds its ``Tensor``.
Every reduction runs in rank order on one device (rank 0's), so a run
repeats bit for bit; the other ranks get copies of that result.

Under autograd, ``all_reduce`` (sum, and avg through it), ``all_gather``
and ``reduce_scatter`` are ``torch.autograd.Function``\\ s with the
adjoints a tensor-parallel layer pairs them with: the adjoint of
``all_gather`` is ``reduce_scatter``, that of ``reduce_scatter`` is
``all_gather``, and that of ``all_reduce(sum)`` is the identity per rank
(each rank holds the whole gradient of the replicated sum, as Megatron's
row-parallel reduction assumes). :func:`copy_to_group` is the conjugate
of the last: the identity forward, a sum of the ranks' gradients
backward. Max, min and prod differentiate as the elementwise reductions
they are.

Group argument: a :class:`~.topology.ParallelAxis`, an axis name, a tuple
of names, or None (every non-trivial axis of the hybrid group, the
reference's default world).

A launched world (``python -m paddle_tpu_torch.distributed.launch
--nproc_per_node N``) is the other encoding: :func:`init_parallel_env`
joins ``torch.distributed``'s gloo process group from the launcher's
environment, and then a collective given this process's own tensor (not a
per-rank list) with no group runs the matching ``torch.distributed`` op
across the processes. Gloo, not NCCL, because several ranks may share one
card. Gloo runs every op the port calls on CUDA tensors too (its CUDA
work copies through host memory itself). ``ReduceOp.AVG`` is a sum
divided by the world size.
"""

from __future__ import annotations

import datetime
import os
from typing import List, Optional, Sequence

import torch

from .topology import ParallelAxis, get_hybrid_communicate_group

__all__ = ["all_reduce", "all_gather", "reduce_scatter", "alltoall",
           "broadcast", "reduce", "scatter", "barrier", "ReduceOp",
           "get_rank", "get_world_size", "is_initialized",
           "init_parallel_env", "copy_to_group", "all_reduce_sum",
           "gather_to", "reduce_ranks", "alltoall_ranks"]


class ReduceOp:
    SUM = "sum"
    MAX = "max"
    MIN = "min"
    PROD = "prod"
    AVG = "avg"


_initialized = False

_DIST_OPS = {"sum": "SUM", "max": "MAX", "min": "MIN", "prod": "PRODUCT"}


def init_parallel_env(timeout: Optional[float] = None):
    """Initialise the collective API. In a launched world
    (``PADDLE_TRAINERS_NUM`` above 1) this joins ``torch.distributed``'s
    gloo process group at ``tcp://`` + ``PADDLE_MASTER`` as rank
    ``PADDLE_TRAINER_ID``, with ``timeout`` seconds for every collective
    (None: torch's default). With the launcher's
    ``PADDLE_ELASTIC_STORE`` set it starts the liveness heartbeat first
    (:func:`~.elastic.start_heartbeat`). One process (no launcher) drives
    every rank of a placement, and only the flag is set."""
    global _initialized
    if os.environ.get("PADDLE_ELASTIC_STORE"):
        from .elastic import start_heartbeat
        start_heartbeat()
    world = int(os.environ.get("PADDLE_TRAINERS_NUM") or 1)
    import torch.distributed as dist
    if world > 1 and not dist.is_initialized():
        dist.init_process_group(
            "gloo", init_method="tcp://" + os.environ["PADDLE_MASTER"],
            rank=int(os.environ["PADDLE_TRAINER_ID"]), world_size=world,
            timeout=None if timeout is None
            else datetime.timedelta(seconds=timeout))
    _initialized = True


def is_initialized() -> bool:
    return _initialized


def _launched() -> bool:
    """Whether this process is one rank of an initialised multi-process
    world."""
    import torch.distributed as dist
    return dist.is_available() and dist.is_initialized() and \
        dist.get_world_size() > 1


def _own(t, group) -> bool:
    """Whether a call gets this process's own tensor in a launched world
    (no group, a plain tensor)."""
    return group is None and isinstance(t, torch.Tensor) and _launched()


def get_rank(group=None) -> int:
    """The process's rank: its rank in a launched world, else 0 (one
    process drives every rank)."""
    if group is None and _launched():
        import torch.distributed as dist
        return dist.get_rank()
    return 0


def get_world_size(group=None) -> int:
    """The process count of a launched world (``group`` None), else the
    group's rank count on the placement."""
    if group is None and _launched():
        import torch.distributed as dist
        return dist.get_world_size()
    return _resolve_axis(group).nranks


def _dist_all_reduce(t: torch.Tensor, op: str) -> torch.Tensor:
    import torch.distributed as dist
    if op not in _DIST_OPS and op != ReduceOp.AVG:
        raise ValueError(f"unknown reduce op {op!r}; options: sum, max, "
                         f"min, prod, avg")
    dist.all_reduce(t, op=getattr(dist.ReduceOp, _DIST_OPS.get(op, "SUM")))
    if op == ReduceOp.AVG:
        t.div_(dist.get_world_size())
    return t


def _dist_all_gather(t: torch.Tensor) -> List[torch.Tensor]:
    import torch.distributed as dist
    outs = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(outs, t.contiguous())
    return outs


def _dist_broadcast(t: torch.Tensor, src: int) -> torch.Tensor:
    import torch.distributed as dist
    dist.broadcast(t, src=src)
    return t


def _resolve_axis(group) -> ParallelAxis:
    if isinstance(group, ParallelAxis):
        return group
    hcg = get_hybrid_communicate_group()
    if group is None:
        live = tuple(a for a in hcg.mesh.axis_names
                     if hcg.degrees.get(a, 1) > 1)
        if not live:
            return ParallelAxis(hcg.mesh, "dp")
        return ParallelAxis(hcg.mesh, live[0] if len(live) == 1 else live)
    if isinstance(group, str):
        return ParallelAxis(hcg.mesh, group)
    if isinstance(group, (tuple, list)):
        return ParallelAxis(hcg.mesh, tuple(group))
    raise TypeError(f"unsupported group: {group!r}")


# ---------------------------------------------------------------------------
# the differentiable collectives over per-rank lists
# ---------------------------------------------------------------------------

def _sum_on(ts: Sequence[Optional[torch.Tensor]], dev, like=None):
    """The sum of the non-None ``ts`` in list order on ``dev`` (zeros like
    ``like`` when all are None)."""
    acc = None
    for t in ts:
        if t is not None:
            t = t.to(dev)
            acc = t if acc is None else acc + t
    if acc is None:
        return None if like is None else torch.zeros_like(like, device=dev)
    return acc


def _spread(acc: torch.Tensor, devs) -> List[torch.Tensor]:
    """``acc`` for rank 0 and a copy of it on each other rank's device."""
    return [acc if r == 0 else acc.to(d, copy=True)
            for r, d in enumerate(devs)]


class _AllReduceSum(torch.autograd.Function):
    """Every rank gets the sum of all ranks' tensors; backward: each rank's
    gradient passes through unchanged."""

    @staticmethod
    def forward(ctx, *xs):
        devs = [x.device for x in xs]
        acc = xs[0].to(devs[0], copy=True)
        for x in xs[1:]:
            acc = acc + x.to(devs[0])
        return tuple(_spread(acc, devs))

    @staticmethod
    def backward(ctx, *gs):
        return gs


class _CopyToGroup(torch.autograd.Function):
    """The identity forward; backward, each rank gets the sum of every
    rank's gradient (rank order, on its device)."""

    @staticmethod
    def forward(ctx, *xs):
        ctx.devs = [x.device for x in xs]
        return xs

    @staticmethod
    def backward(ctx, *gs):
        acc = _sum_on(gs, ctx.devs[0])
        if acc is None:
            return (None,) * len(gs)
        return tuple(_spread(acc, ctx.devs))


class _AllGather(torch.autograd.Function):
    """The ranks' tensors concatenated on ``dim``, delivered to the ranks
    in ``dst`` (their devices); backward: each rank's slice of the
    delivered gradients, summed in ``dst`` order (a reduce-scatter)."""

    @staticmethod
    def forward(ctx, dim, dst, *xs):
        ctx.dim, ctx.dst = dim, dst
        ctx.devs = [x.device for x in xs]
        ctx.sizes = [x.shape[dim] for x in xs]
        return tuple(torch.cat([x.to(ctx.devs[r]) for x in xs], dim=dim)
                     for r in dst)

    @staticmethod
    def backward(ctx, *gs):
        out, off = [], 0
        for k, n in enumerate(ctx.sizes):
            out.append(_sum_on([None if g is None else g.narrow(ctx.dim, off,
                                                                 n)
                                for g in gs], ctx.devs[k]))
            off += n
        return (None, None, *out)


class _ReduceScatter(torch.autograd.Function):
    """Rank ``r`` gets slice ``r`` (of ``n`` on ``dim``) of the sum of all
    ranks' tensors; backward: every rank's gradient slices concatenated
    (an all-gather)."""

    @staticmethod
    def forward(ctx, dim, *xs):
        ctx.dim = dim
        ctx.devs = [x.device for x in xs]
        n = len(xs)
        return tuple(_sum_on([x.chunk(n, dim)[r] for x in xs], d)
                     for r, d in enumerate(ctx.devs))

    @staticmethod
    def backward(ctx, *gs):
        like = next(g for g in gs if g is not None)
        full = [g if g is not None else torch.zeros_like(like) for g in gs]
        return (None, *(torch.cat([g.to(d) for g in full], dim=ctx.dim)
                        for d in ctx.devs))


def all_reduce_sum(xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Per-rank list form of ``all_reduce`` (sum), not in place."""
    return list(xs) if len(xs) == 1 else list(_AllReduceSum.apply(*xs))


def copy_to_group(xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The identity on a per-rank list whose backward sums the ranks'
    gradients: placed before a column-parallel layer whose input every
    rank holds in full (Megatron's copy to the model-parallel region)."""
    return list(xs) if len(xs) == 1 else list(_CopyToGroup.apply(*xs))


def gather_to(xs: Sequence[torch.Tensor], dim: int,
              dst: Sequence[int]) -> List[torch.Tensor]:
    """The ranks' tensors concatenated on ``dim`` for the ranks in ``dst``
    only (all of them: ``all_gather``), each on its rank's device."""
    return list(_AllGather.apply(dim, tuple(dst), *xs))


# ---------------------------------------------------------------------------
# the public API
# ---------------------------------------------------------------------------

def _rows(t, group, what: str):
    """(per-rank list, given as a tensor?) for ``t`` in either encoding."""
    n = _resolve_axis(group).nranks
    if isinstance(t, (list, tuple)):
        if len(t) != n:
            raise ValueError(f"{what}: {len(t)} per-rank tensors for a "
                             f"group of {n} ranks")
        return list(t), False
    t = torch.as_tensor(t)
    if t.dim() == 0 or t.shape[0] != n:
        raise ValueError(
            f"collective input must have leading rank dim {n} (the "
            f"single-controller per-rank encoding), got shape "
            f"{tuple(t.shape)}")
    return list(t.unbind(0)), True


def _pack(outs, as_tensor: bool):
    return torch.stack(outs) if as_tensor else list(outs)


def _update(target, outs, as_tensor: bool):
    """Write ``outs`` into ``target`` in place; returns ``target``."""
    if as_tensor:
        target.copy_(torch.stack(outs))
    else:
        for t, o in zip(target, outs):
            t.copy_(o)
    return target


def reduce_ranks(xs: Sequence[torch.Tensor], op: str) -> List[torch.Tensor]:
    """Per-rank list form of ``all_reduce`` with ``op``, not in place:
    every rank gets the reduction over the ranks in rank order."""
    if op in (ReduceOp.SUM, ReduceOp.AVG):
        outs = all_reduce_sum(xs)
        return outs if op == ReduceOp.SUM else [o / len(xs) for o in outs]
    fn = {ReduceOp.MAX: torch.maximum, ReduceOp.MIN: torch.minimum,
          ReduceOp.PROD: torch.mul}.get(op)
    if fn is None:
        raise ValueError(f"unknown reduce op {op!r}; options: sum, max, "
                         f"min, prod, avg")
    dev = xs[0].device
    acc = xs[0]
    for x in xs[1:]:
        acc = fn(acc, x.to(dev))
    return [acc.to(x.device, copy=True) for x in xs]


def all_reduce(tensor, op: str = ReduceOp.SUM, group=None,
               sync_op: bool = True):
    """Every rank's tensor becomes the reduction over the ranks (in rank
    order), in place; returns ``tensor``. ``prod`` multiplies, exact for
    any sign and zero. In a launched world, this process's tensor is
    reduced across the processes."""
    if _own(tensor, group):
        return _dist_all_reduce(tensor, op)
    xs, as_tensor = _rows(tensor, group, "all_reduce")
    return _update(tensor, reduce_ranks(xs, op), as_tensor)


def all_gather(tensor_or_list, tensor=None, group=None, sync_op: bool = True):
    """Both call conventions: ``all_gather(out_list, t)`` appends each
    rank's tensor to ``out_list`` and returns it; ``all_gather(t)``
    returns every rank's concatenation of all ranks' tensors on dim 0 (in
    a launched world: this process's, across the processes)."""
    if isinstance(tensor_or_list, list) and tensor is not None and \
            _own(tensor, group):
        tensor_or_list.extend(_dist_all_gather(tensor))
        return tensor_or_list
    if _own(tensor_or_list, group):
        return torch.cat(_dist_all_gather(tensor_or_list), dim=0)
    if isinstance(tensor_or_list, list) and tensor is not None:
        xs, _ = _rows(tensor, group, "all_gather")
        tensor_or_list.extend(xs)
        return tensor_or_list
    xs, as_tensor = _rows(tensor_or_list, group, "all_gather")
    return _pack(gather_to(xs, 0, range(len(xs))), as_tensor)


def reduce_scatter(tensor, tensor_list=None, op=ReduceOp.SUM, group=None,
                   sync_op: bool = True):
    """Rank ``r`` gets slice ``r`` on dim 0 of the sum of every rank's
    tensor (the reference sums whatever ``op`` says). In a launched world:
    process ``r`` gets slice ``r`` of the sum over the processes."""
    if _own(tensor, group):
        import torch.distributed as dist
        n = dist.get_world_size()
        if tensor.shape[0] % n:
            raise ValueError(f"reduce_scatter: dim 0 of size "
                             f"{tensor.shape[0]} does not split over {n} "
                             f"ranks")
        out = tensor.new_empty((tensor.shape[0] // n,) + tensor.shape[1:])
        dist.reduce_scatter_tensor(out, tensor.contiguous())
        return out
    xs, as_tensor = _rows(tensor, group, "reduce_scatter")
    n = len(xs)
    if xs[0].shape[0] % n:
        raise ValueError(f"reduce_scatter: dim 0 of size {xs[0].shape[0]} "
                         f"does not split over {n} ranks")
    outs = xs if n == 1 else _ReduceScatter.apply(0, *xs)
    return _pack(outs, as_tensor)


def alltoall_ranks(xs: Sequence[torch.Tensor], split_dim: int = 0,
                   concat_dim: int = 0) -> List[torch.Tensor]:
    """Per-rank list form of ``alltoall`` over any dims (``lax.all_to_all``
    with ``tiled=True``): rank ``r`` cuts its tensor into ``n`` chunks on
    ``split_dim`` and sends chunk ``c`` to rank ``c``, which concatenates
    what it receives on ``concat_dim`` in rank order, on its device. Plain
    tensor ops, so autograd gives the adjoint: the same exchange with the
    two dims swapped."""
    n = len(xs)
    chunks = [x.chunk(n, split_dim) for x in xs]
    return [torch.cat([chunks[r][c].to(xs[c].device) for r in range(n)],
                      dim=concat_dim) for c in range(n)]


def alltoall(in_tensor_or_list, out_tensor_list=None, group=None,
             sync_op: bool = True):
    """Rank ``r`` sends chunk ``c`` of its tensor (dim 0, ``n`` chunks) to
    rank ``c``; rank ``c`` concatenates what it receives in rank order
    (in a launched world: across the processes)."""
    if _own(in_tensor_or_list, group):
        import torch.distributed as dist
        x = in_tensor_or_list.contiguous()
        if x.shape[0] % dist.get_world_size():
            raise ValueError(f"alltoall: dim 0 of size {x.shape[0]} does "
                             f"not split over {dist.get_world_size()} "
                             f"ranks")
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x)
        return out
    xs, as_tensor = _rows(in_tensor_or_list, group, "alltoall")
    return _pack(alltoall_ranks(xs), as_tensor)


def broadcast(tensor, src: int = 0, group=None, sync_op: bool = True):
    """Every rank's tensor becomes rank ``src``'s, in place (in a launched
    world: process ``src``'s)."""
    if _own(tensor, group):
        return _dist_broadcast(tensor, src)
    xs, as_tensor = _rows(tensor, group, "broadcast")
    if not 0 <= src < len(xs):
        raise ValueError(f"broadcast: src {src} out of range for "
                         f"{len(xs)} ranks")
    return _update(tensor, [xs[src].to(x.device, copy=True) for x in xs],
                   as_tensor)


def reduce(tensor, dst: int = 0, op=ReduceOp.SUM, group=None, sync_op=True):
    """Single-controller: ``reduce`` is ``all_reduce`` (every rank sees the
    result), as in the reference."""
    return all_reduce(tensor, op, group)


def scatter(tensor, tensor_list=None, src: int = 0, group=None,
            sync_op=True):
    """Rank ``r`` receives ``tensor_list[r]``; the result is the per-rank
    encoding (row ``r`` or list entry ``r``). ``tensor`` given as a
    per-rank list, or as a tensor of the result's shape, is filled in
    place and returned. With no ``tensor_list``, ``tensor`` is the full
    value ``src`` holds, split evenly on dim 0 into the ranks' rows (the
    ``[n, m, ...]`` view of it is returned). In a launched world,
    ``tensor`` is this process's output buffer, filled with
    ``tensor_list[rank]`` of process ``src``; with no ``tensor_list``,
    process ``src``'s ``tensor`` split on dim 0, this process's part
    returned."""
    if _own(tensor, group):
        import torch.distributed as dist
        n, r = dist.get_world_size(), dist.get_rank()
        if tensor_list is None:
            if tensor.shape[0] % n:
                raise ValueError(f"scatter: leading dim {tensor.shape[0]} "
                                 f"not divisible by group size {n}")
            parts = [c.contiguous() for c in tensor.chunk(n)] \
                if r == src else None
            out = tensor.new_empty((tensor.shape[0] // n,)
                                   + tensor.shape[1:])
            dist.scatter(out, parts, src=src)
            return out
        parts = None
        if r == src:
            parts = [torch.as_tensor(p).to(tensor.device, tensor.dtype)
                     .contiguous() for p in tensor_list]
        dist.scatter(tensor, parts, src=src)
        return tensor
    n = _resolve_axis(group).nranks
    if tensor_list is None:
        t = torch.as_tensor(tensor)
        if t.shape[0] % n:
            raise ValueError(f"scatter: leading dim {t.shape[0]} not "
                             f"divisible by group size {n}")
        return t.view(n, t.shape[0] // n, *t.shape[1:])
    if len(tensor_list) != n:
        raise ValueError(f"scatter: tensor_list has {len(tensor_list)} "
                         f"entries but the group has {n} ranks")
    if isinstance(tensor, (list, tuple)):
        return _update(tensor, [torch.as_tensor(p).to(t.device)
                                for p, t in zip(tensor_list, tensor)], False)
    out = torch.stack([torch.as_tensor(p) for p in tensor_list])
    if isinstance(tensor, torch.Tensor) and tensor.shape == out.shape:
        return tensor.copy_(out)
    return out


def barrier(group=None):
    """Wait until every device of the group finished its queued work (in
    a launched world with no group: until every process reaches it)."""
    if group is None and _launched():
        import torch.distributed as dist
        dist.barrier()
        return
    for d in set(_resolve_axis(group).devices()):
        if d.type == "cuda":
            torch.cuda.synchronize(d)

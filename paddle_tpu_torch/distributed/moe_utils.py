"""The expert-parallel plumbing ops — counterpart of
``paddle_tpu/distributed/moe_utils.py`` (``number_count``,
``expert_count``, ``assign_pos``, ``limit_by_capacity``,
``prune_gate_by_capacity``, ``random_routing``, ``global_scatter``,
``global_gather``: the FastMoE-style building blocks of the reference's
``MoELayer``). Each takes and returns Tensors and is registered under the
reference's name; the torch functions underneath (``_number_count`` ...)
do the work.

As in JAX, the counting and position ops are one-hot sums and a stable
sort (no atomics), and ``global_scatter`` / ``global_gather`` are one
all-to-all over the group at a static per-(rank, expert) capacity: the
tokens come grouped by destination rank, and ``local_count`` /
``global_count`` are accepted for the reference's signature.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.dispatch import register_op
from ..core.tensor import Tensor, _wrap
from ..ops._helpers import ensure_tensor, forward_op
from . import collective as C

__all__ = [
    "number_count", "expert_count", "assign_pos", "limit_by_capacity",
    "prune_gate_by_capacity", "random_routing", "global_scatter",
    "global_gather",
]


def _number_count(v, upper_range):
    return F.one_hot(v.reshape(-1).long(), upper_range).sum(0)


def _expert_count(v, n_expert):
    v = v.reshape(-1).long()
    oh = F.one_hot(v.clamp(0, n_expert - 1), n_expert)
    return (oh * (v >= 0)[:, None]).sum(0)


def _assign_pos(v, cum_count):
    return torch.sort(v.reshape(-1), stable=True).indices.long()


def _limit_by_capacity(e, c, n_worker):
    return torch.minimum(e.reshape(n_worker, -1), c[None, :]).reshape(-1)


def _prune_gate_by_capacity(g, e, n_expert, n_worker):
    flat = g.reshape(-1).long()
    total = n_worker * n_expert
    live = flat >= 0
    idx = flat.clamp(0, total - 1)
    oh = F.one_hot(idx, total) * live[:, None]
    my_rank = (torch.cumsum(oh, dim=0) * oh).sum(-1)   # 1-based
    keep = live & (my_rank <= e.long()[idx])
    return torch.where(keep, flat, -1).reshape(g.shape).to(g.dtype)


def _random_routing(iv, vv, pv):
    second = torch.where(pv < 2.0 * vv[:, 1], iv[:, 1],
                         torch.full_like(iv[:, 1], -1))
    return torch.stack([iv[:, 0], second], -1)


def _global_scatter(x, group=None):
    """Expert-grouped all-to-all dispatch: rank ``r`` sends its tokens for
    expert ``e`` to the rank that owns ``e``. The tokens come grouped at a
    static capacity per (rank, expert) slot.

    ``x`` a per-rank list (rank ``r``'s ``[n * cap, D]`` on its device):
    one :func:`~.collective.alltoall_ranks` over the list, each rank's
    result on its device. ``x`` a tensor ``[n * parts, D]``: the JAX
    encoding, block ``i`` rank ``i``'s tensor, the results concatenated;
    in a launched world it is this process's tensor, exchanged across the
    processes. A group of one rank returns ``x``."""
    if isinstance(x, (list, tuple)):
        return x if len(x) == 1 else C.alltoall_ranks(list(x))
    if group is None and C._launched():
        return C.alltoall(x)
    world = C.get_world_size(group)
    if world <= 1:
        return x
    parts = int(x.shape[0]) // world
    return torch.cat(C.alltoall_ranks(
        [x[i * parts:(i + 1) * parts] for i in range(world)]), dim=0)


def _op(name, fn, args, **kw):
    return forward_op(name, lambda *vs: fn(*vs, **kw),
                      [ensure_tensor(a) for a in args], differentiable=False)


def number_count(numbers, upper_range: int, name=None):
    """The histogram of integer ids in ``[0, upper_range)`` (int64): one
    one-hot sum."""
    return _op("number_count", _number_count, [numbers],
               upper_range=upper_range)


def expert_count(gate_idx, n_expert: int, name=None):
    """Tokens routed to each expert; ``-1`` (dropped) ids are ignored."""
    return _op("expert_count", _expert_count, [gate_idx], n_expert=n_expert)


def assign_pos(x, cum_count, name=None):
    """The token indices in the expert-grouped layout, ordered by (expert,
    original position): one stable sort (int64)."""
    return _op("assign_pos", _assign_pos, [x, cum_count])


def limit_by_capacity(expert_count_t, capacity, n_worker: int = 1,
                      name=None):
    """Per-expert counts ``[n_worker * n_expert]`` clipped to
    ``capacity [n_expert]``."""
    return _op("limit_by_capacity", _limit_by_capacity,
               [expert_count_t, capacity], n_worker=n_worker)


def prune_gate_by_capacity(gate_idx, expert_count_t, n_expert: int,
                           n_worker: int = 1, name=None):
    """``gate_idx`` with every token past its expert's clipped count set
    to ``-1`` (a cumulative within-expert rank test)."""
    return _op("prune_gate_by_capacity", _prune_gate_by_capacity,
               [gate_idx, expert_count_t], n_expert=n_expert,
               n_worker=n_worker)


def random_routing(topk_idx, topk_value, prob, topk: int = 2, name=None):
    """FastMoE's stochastic second-expert drop: keep the second expert iff
    ``prob < 2 * its gate value``; a dropped slot gets ``-1``."""
    if topk != 2:
        raise ValueError("random_routing is defined for topk=2 "
                         "(the reference's contract)")
    return _op("random_routing", _random_routing, [topk_idx, topk_value, prob])


def global_scatter(x, local_count, global_count, group=None, name=None):
    """Expert-grouped all-to-all dispatch (:func:`_global_scatter`;
    ``local_count`` / ``global_count`` are the reference's signature). A
    per-rank list comes back as a list of the same kind (torch tensors or
    Tensors); a tensor comes back as a Tensor."""
    if isinstance(x, (list, tuple)):
        vals = [v._value if isinstance(v, Tensor) else v for v in x]
        out = _global_scatter(vals, group)
        return [_wrap(v) if isinstance(a, Tensor) else v
                for a, v in zip(x, out)]
    return _wrap(_global_scatter(ensure_tensor(x)._value, group))


def global_gather(x, local_count, global_count, group=None, name=None):
    """The inverse of :func:`global_scatter`: expert outputs back to the
    ranks that own the tokens (the same all-to-all, the counts
    swapped)."""
    return global_scatter(x, global_count, local_count, group=group)


for _n in __all__:
    _f = globals()[_n]
    register_op(_n, _f, (_f.__doc__ or "").strip().split("\n")[0],
                public=_f)

"""The expert-parallel plumbing ops — counterpart of
``paddle_tpu/distributed/moe_utils.py`` (``number_count``,
``expert_count``, ``assign_pos``, ``limit_by_capacity``,
``prune_gate_by_capacity``, ``random_routing``, ``global_scatter``,
``global_gather``: the FastMoE-style building blocks of the reference's
``MoELayer``), as plain functions on torch tensors.

As in JAX, the counting and position ops are one-hot sums and a stable
sort (no atomics), and ``global_scatter`` / ``global_gather`` are one
all-to-all over the group at a static per-(rank, expert) capacity: the
tokens come grouped by destination rank, and ``local_count`` /
``global_count`` are accepted for the reference's signature.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import collective as C

__all__ = [
    "number_count", "expert_count", "assign_pos", "limit_by_capacity",
    "prune_gate_by_capacity", "random_routing", "global_scatter",
    "global_gather",
]


def number_count(numbers, upper_range: int, name=None):
    """The histogram of integer ids in ``[0, upper_range)`` (int64)."""
    v = torch.as_tensor(numbers).reshape(-1).long()
    return F.one_hot(v, upper_range).sum(0)


def expert_count(gate_idx, n_expert: int, name=None):
    """Tokens routed to each expert; ``-1`` (dropped) ids are ignored."""
    v = torch.as_tensor(gate_idx).reshape(-1).long()
    oh = F.one_hot(v.clamp(0, n_expert - 1), n_expert)
    return (oh * (v >= 0)[:, None]).sum(0)


def assign_pos(x, cum_count, name=None):
    """The token indices in the expert-grouped layout: ordered by (expert,
    original position), one stable sort (int64)."""
    v = torch.as_tensor(x).reshape(-1)
    return torch.sort(v, stable=True).indices.long()


def limit_by_capacity(expert_count_t, capacity, n_worker: int = 1,
                      name=None):
    """Per-expert counts ``[n_worker * n_expert]`` clipped to
    ``capacity [n_expert]``."""
    e = torch.as_tensor(expert_count_t)
    c = torch.as_tensor(capacity)
    return torch.minimum(e.reshape(n_worker, -1), c[None, :]).reshape(-1)


def prune_gate_by_capacity(gate_idx, expert_count_t, n_expert: int,
                           n_worker: int = 1, name=None):
    """``gate_idx`` with every token past its expert's clipped count set
    to ``-1`` (a cumulative within-expert rank test)."""
    g = torch.as_tensor(gate_idx)
    e = torch.as_tensor(expert_count_t)
    flat = g.reshape(-1).long()
    total = n_worker * n_expert
    live = flat >= 0
    idx = flat.clamp(0, total - 1)
    oh = F.one_hot(idx, total) * live[:, None]
    my_rank = (torch.cumsum(oh, dim=0) * oh).sum(-1)   # 1-based
    keep = live & (my_rank <= e.long()[idx])
    return torch.where(keep, flat, -1).reshape(g.shape).to(g.dtype)


def random_routing(topk_idx, topk_value, prob, topk: int = 2, name=None):
    """FastMoE's stochastic second-expert drop: keep the second expert iff
    ``prob < 2 * its gate value``; a dropped slot gets ``-1``."""
    if topk != 2:
        raise ValueError("random_routing is defined for topk=2 "
                         "(the reference's contract)")
    iv = torch.as_tensor(topk_idx)
    vv = torch.as_tensor(topk_value)
    pv = torch.as_tensor(prob)
    second = torch.where(pv < 2.0 * vv[:, 1], iv[:, 1],
                         torch.full_like(iv[:, 1], -1))
    return torch.stack([iv[:, 0], second], -1)


def global_scatter(x, local_count, global_count, group=None, name=None):
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
    xs = torch.as_tensor(x)
    if group is None and C._launched():
        return C.alltoall(xs)
    world = C.get_world_size(group)
    if world <= 1:
        return xs
    parts = int(xs.shape[0]) // world
    return torch.cat(C.alltoall_ranks(
        [xs[i * parts:(i + 1) * parts] for i in range(world)]), dim=0)


def global_gather(x, local_count, global_count, group=None, name=None):
    """The inverse of :func:`global_scatter`: expert outputs back to the
    ranks that own the tokens (the same all-to-all, the counts
    swapped)."""
    return global_scatter(x, global_count, local_count, group=group)

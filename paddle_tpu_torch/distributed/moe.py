"""GShard top-k routing — counterpart of ``paddle_tpu/distributed/moe.py``
(its ``gshard_routing``).

The dense dispatch/combine formulation: ``dispatch [T, E, C]`` and
``combine [T, E, C]`` one-hot tensors that the MoE FFN contracts with
einsums, so token dropping is a capacity mask and every shape is static.
The eager ``MoELayer``, its gate classes and expert parallelism
(``moe_utils``, the all-to-all dispatch) wait for the expert-parallel
slice.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["gshard_routing"]


def gshard_routing(logits, top_k: int, capacity: int):
    """GShard dense routing: ``logits [T, E]`` -> ``(combine [T, E, C],
    dispatch [T, E, C], aux)``.

    Each token's ``top_k`` experts by softmax probability join their
    experts' queues in order of choice first (every token's first choice
    before any token's second), then token index; a choice past
    ``capacity`` in its queue is dropped. Kept gates are renormalised to
    sum to 1 per token; ``dispatch`` is ``combine > 0``; ``aux = E *
    sum_e mean_t(probs) * mean_t(top-1 one-hot)`` (the load-balancing
    loss)."""
    T, E = logits.shape
    cap = int(capacity)
    probs = torch.softmax(logits, dim=-1)
    # lax.top_k: ties toward the lower index (a stable descending sort;
    # torch.topk promises no order among ties)
    topv, topi = (t[:, :top_k] for t in torch.sort(
        probs, dim=-1, descending=True, stable=True))
    combine = torch.zeros((T, E, cap), dtype=probs.dtype,
                          device=probs.device)
    prev = torch.zeros((E,), dtype=torch.int64, device=probs.device)
    for k in range(top_k):
        e_k = topi[:, k]
        onehot = F.one_hot(e_k, E)                              # [T, E]
        pos_in_e = torch.cumsum(onehot, dim=0) - 1 + prev[None]
        prev = prev + onehot.sum(0)
        my_pos = pos_in_e.gather(1, e_k[:, None])[:, 0]
        keep = my_pos < cap
        gate_k = torch.where(keep, topv[:, k], 0.0)
        oh_cap = F.one_hot(torch.where(keep, my_pos, cap),
                           cap + 1)[:, :cap].to(probs.dtype)    # [T, C]
        combine = combine + gate_k[:, None, None] * \
            onehot.to(probs.dtype)[:, :, None] * oh_cap[:, None, :]
    denom = torch.clamp(combine.sum(dim=(1, 2)), min=1e-9)
    combine = combine / denom[:, None, None]
    dispatch = (combine > 0).to(probs.dtype)
    me = probs.mean(dim=0)
    ce = F.one_hot(topi[:, 0], E).to(probs.dtype).mean(dim=0)
    aux = (me * ce).sum() * E
    return combine, dispatch, aux

"""Mixture-of-Experts — counterpart of ``paddle_tpu/distributed/moe.py``
(``gshard_routing``, the gates ``NaiveGate`` / ``SwitchGate`` /
``GShardGate`` and the eager ``MoELayer``).

Routing is the dense dispatch/combine formulation: ``dispatch [T, E, C]``
and ``combine [T, E, C]`` one-hot tensors contracted with einsums, so
token dropping is a capacity mask and every shape is static.

``MoELayer``: structurally identical experts are consolidated into
stacked ``[E, ...]`` Parameters (``expert_stack_<j>``); with a
``moe_group`` axis of size ep > 1 in the hybrid mesh each is a
``DistParameter`` cut ``(ep_axis, None, ...)``, so a coordinate holds its
``E/ep`` experts and runs them on its device, the dispatched tokens
handed to it and its outputs back (the all-to-all of the reference's
``global_scatter`` / ``global_gather``). A layer built before
``fleet.init`` lays its experts out at its first forward once the axis
exists. Structurally different experts run unrolled and replicated.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["gshard_routing", "NaiveGate", "SwitchGate", "GShardGate",
           "MoELayer"]


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


# ---------------------------------------------------------------------------
# gates
# ---------------------------------------------------------------------------

def _layer_cls():
    from ..nn.layer import Layer
    return Layer


class _GateBase(_layer_cls()):
    """Router: tokens [T, M] -> (combine [T,E,C], dispatch [T,E,C], aux)."""

    def __init__(self, d_model: int, num_experts: int, top_k: int,
                 capacity_factor: float = 1.25):
        super().__init__()
        from ..nn import initializer as I
        self.d_model = d_model
        self.num_experts = num_experts
        self.top_k = top_k
        self.capacity_factor = float(capacity_factor)
        self.weight = self.create_parameter(
            [d_model, num_experts], default_initializer=I.XavierUniform())

    def capacity(self, num_tokens: int) -> int:
        return max(1, int(math.ceil(
            num_tokens * self.capacity_factor * self.top_k
            / self.num_experts)))

    def _routing(self, logits, cap: int):
        return gshard_routing(logits, self.top_k, cap)


class NaiveGate(_GateBase):
    """top-k softmax routing, no jitter (ref: moe.gate.NaiveGate)."""

    def __init__(self, d_model, num_experts, top_k=2, capacity_factor=1.25):
        super().__init__(d_model, num_experts, top_k, capacity_factor)


class SwitchGate(_GateBase):
    """top-1 routing (ref: SwitchGate)."""

    def __init__(self, d_model, num_experts, top_k=1, capacity_factor=1.25,
                 jitter_eps: float = 0.0):
        super().__init__(d_model, num_experts, 1, capacity_factor)
        self.jitter_eps = jitter_eps


class GShardGate(_GateBase):
    """top-2 routing (ref: GShardGate)."""

    def __init__(self, d_model, num_experts, top_k=2, capacity_factor=2.0):
        super().__init__(d_model, num_experts, 2, capacity_factor)


class MoELayer(_layer_cls()):
    """ref: incubate.distributed.models.moe.MoELayer. ``experts`` is a list
    of Layers; ``gate`` a gate or a dict ({"type": "gshard" | "switch" |
    "naive", ...}); ``moe_group`` the expert-parallel mesh axis (None:
    replicated). ``aux_loss`` holds the last forward's load-balancing
    loss."""

    def __init__(self, d_model: int, experts: Sequence, gate=None,
                 moe_group: Optional[str] = None, recompute_interval: int = 0,
                 name=None):
        super().__init__()
        from ..core.tensor import Parameter
        self.d_model = d_model
        self.num_experts = len(experts)
        if gate is None or isinstance(gate, dict):
            cfg = dict(gate or {})
            typ = cfg.pop("type", "gshard")
            cls = {"gshard": GShardGate, "switch": SwitchGate,
                   "naive": NaiveGate}[typ]
            self.gate = cls(d_model, self.num_experts, **cfg)
        else:
            self.gate = gate
        self.moe_group = moe_group
        self.aux_loss = None
        from .pipeline import _param_sig
        sigs = [_param_sig(e) for e in experts]
        if len(experts) > 0 and len(set(sigs)) == 1 and sigs[0][1]:
            object.__setattr__(self, "experts", list(experts))
            object.__setattr__(self, "_template", experts[0])
            per = [e.parameters() for e in experts]
            stacked = []
            for j in range(len(per[0])):
                p = Parameter(torch.stack([ps[j]._value.detach()
                                           for ps in per]))
                self.add_parameter(f"expert_stack_{j}", p)
                stacked.append(p)
            object.__setattr__(self, "_stacked", stacked)
            object.__setattr__(self, "_ep_sharded", False)
            self.shard_expert_weights()
        else:
            from ..nn.layers.container import LayerList
            self.experts = LayerList(list(experts))
            object.__setattr__(self, "_stacked", None)
            object.__setattr__(self, "_template", None)

    def _ep_size(self) -> int:
        # no default topology is installed here: a layer built before
        # fleet.init sees ep 1 and lays its experts out later
        from . import topology as _topo
        if self.moe_group is None or _topo._hcg is None:
            return 1
        return int(_topo._hcg.mesh.shape.get(self.moe_group, 1))

    def shard_expert_weights(self, mesh=None):
        """Lay the stacked expert weights out ``(ep_axis, None, ...)`` over
        the hybrid mesh: each coordinate holds its ``E/ep`` experts."""
        from .dist_tensor import distribute
        from .topology import get_hybrid_communicate_group
        ep = self._ep_size()
        if self._stacked is None or self.moe_group is None or ep <= 1:
            return
        if self.num_experts % ep:
            raise ValueError(
                f"num_experts {self.num_experts} not divisible by "
                f"ep degree {ep} (axis {self.moe_group!r})")
        mesh = mesh or get_hybrid_communicate_group().mesh
        for p in self._stacked:
            distribute(p, mesh, (self.moe_group,) + (None,) * (p.ndim - 1))
        object.__setattr__(self, "_ep_sharded", True)

    # the mode switches reach the unregistered expert list
    def train(self):
        super().train()
        if self._stacked is not None:
            for e in self.experts:
                e.train()
        return self

    def eval(self):
        super().eval()
        if self._stacked is not None:
            for e in self.experts:
                e.eval()
        return self

    def _run_stacked(self, einp: torch.Tensor) -> torch.Tensor:
        """``[E, C, M]`` expert inputs -> outputs, each expert run with its
        slice of the stacked weights (at its ep coordinate when laid
        out)."""
        from .dist_tensor import DistTensor, anchor
        from .pipeline import _functional_apply
        stacks, E = self._stacked, self.num_experts
        outs = []
        if isinstance(stacks[0], DistTensor) and self.moe_group is not None \
                and self.moe_group in stacks[0].mesh.axis_names:
            mesh = stacks[0].mesh
            coords = mesh.group(anchor(mesh), (self.moe_group,))
            per = E // len(coords)
            for j, c in enumerate(coords):
                locs = [s.local(c) for s in stacks]
                dev = locs[0].device
                for e in range(per):
                    y = _functional_apply([self._template],
                                          [l[e] for l in locs],
                                          einp[j * per + e].to(dev))
                    outs.append(y.to(einp.device))
        else:
            vals = [s._value for s in stacks]
            for e in range(E):
                outs.append(_functional_apply([self._template],
                                              [v[e] for v in vals], einp[e]))
        return torch.stack(outs)

    def forward(self, x):
        """x [B, S, M] (or [T, M]) -> same shape; sets ``aux_loss``."""
        from ..core.tensor import _wrap
        from ..ops._helpers import ensure_tensor, forward_op
        t = ensure_tensor(x)
        shape = list(t.shape)
        M = shape[-1]
        T = int(np.prod(shape[:-1]))
        cap = self.gate.capacity(T)
        if self._stacked is not None and not self._ep_sharded and \
                self._ep_size() > 1:
            self.shard_expert_weights()        # the topology came later
        gate = self.gate

        def run(xv, gwv):
            tokens = xv.reshape(T, M)
            logits = tokens @ gwv.to(tokens.dtype)
            combine, dispatch, aux = gate._routing(logits.float(), cap)
            combine = combine.to(tokens.dtype)
            einp = torch.einsum("tec,tm->ecm", dispatch.to(tokens.dtype),
                                tokens)
            if self._stacked is not None:
                eout = self._run_stacked(einp)
            else:
                eout = torch.stack([
                    e(_wrap(einp[i]))._value
                    for i, e in enumerate(self.experts)])
            y = torch.einsum("tec,ecm->tm", combine, eout)
            return y.reshape(shape), aux

        out, aux = forward_op("moe_layer", run, [t, gate.weight])
        self.aux_loss = aux
        return out

"""Tensor-(model-)parallel layers — counterpart of
``paddle_tpu/distributed/fleet/layers/mpu/mp_layers.py``
(``VocabParallelEmbedding``, ``ColumnParallelLinear``,
``RowParallelLinear``, ``ParallelCrossEntropy``, ``c_embedding``,
``c_softmax_with_cross_entropy``).

Each layer creates the full logical weight (the reference's construction,
so a seed gives the serial layer's weights) and lays it out over the
hybrid mesh as a :class:`~....dist_tensor.DistParameter` with the
reference's spec: each mp coordinate then holds only its shard, and
``state_dict`` / ``numpy()`` / ``.grad`` give the full logical tensor.

* **Outside a region** (the JAX package's GSPMD path) activations are full
  logical tensors and each layer runs Megatron's algorithm over the mp
  group of the coordinate eager code runs at (the lead): every shard's
  matmul / lookup / softmax partials on its coordinate's device with its
  local weight, the partial sums reduced in rank order. Autograd through those per-shard ops gives
  the exact serial gradient.
* **Inside a per-coordinate region** values are locals and the layers emit
  the collectives of :mod:`.mp_ops`, as the reference's ``shard_map`` path
  does; a weight that is a ``DistParameter`` reads as the coordinate's
  shard, a plain full tensor is sliced to it (``_local_shard``).
"""

from __future__ import annotations

import torch

from ....dist_tensor import DistTensor, anchor, distribute
from ....sharding import spec_axes
from ....topology import get_hybrid_communicate_group
from .....nn import functional as F
from .....nn import initializer as I
from .....nn.layer import Layer
from .....ops._helpers import ensure_tensor, forward_op, register_op
from . import mp_ops
from .mp_ops import (axis_index, c_concat, c_identity, in_mp_region,
                     mp_allreduce, mp_axis_name)

__all__ = ["VocabParallelEmbedding", "ColumnParallelLinear", "RowParallelLinear",
           "ParallelCrossEntropy", "c_embedding", "c_softmax_with_cross_entropy"]


def _axis_size(axis: str) -> int:
    mesh = get_hybrid_communicate_group().mesh
    return int(mesh.shape.get(axis, 1))


def _shard_param(p, spec):
    """Lay the full logical parameter out over the hybrid mesh."""
    return distribute(p, get_hybrid_communicate_group().mesh, spec)


def _local_shard(t, axis: str, full: int, dim: int):
    """Inside a region: this coordinate's chunk of ``t`` along ``dim``. A
    DistTensor cut there over ``axis`` already reads as the chunk; a full
    plain tensor is sliced; a tensor of the local size passes through."""
    if t is None or (isinstance(t, DistTensor) and
                     dim < len(t.spec) and axis in spec_axes(t.spec[dim])):
        return t
    if t.shape[dim] != full:
        return t
    t = ensure_tensor(t)

    def f(v, r):
        per = full // mp_ops.mp_axis_size(axis)
        return v.narrow(dim, int(r) * per, per)

    return forward_op("mp_local_shard", f, [t, axis_index(axis)])


def _group(w: DistTensor, axis: str):
    """The coordinates of the mp group eager code runs at, rank order."""
    return w.mesh.group(anchor(w.mesh), (axis,))


def _column(x, w: DistTensor, b, axis: str):
    """The logical ``x @ W + b`` with each output column block computed at
    its mp coordinate, concatenated in rank order."""
    coords = _group(w, axis)

    def f(xv):
        outs = []
        for c in coords:
            wl = w.local(c)
            y = xv.to(wl.device) @ wl
            if b is not None:
                y = y + b.local(c)
            outs.append(y.to(xv.device))
        return torch.cat(outs, dim=-1)

    return forward_op("column_parallel_linear", f, [ensure_tensor(x)])


def _row(x, w: DistTensor, axis: str):
    """The logical ``x @ W``: each mp coordinate contracts its block of
    ``x``'s last dim with its rows, the partial sums added in rank
    order."""
    coords = _group(w, axis)

    def f(xv):
        parts = xv.chunk(len(coords), dim=-1)
        acc = None
        for part, c in zip(parts, coords):
            wl = w.local(c)
            y = (part.to(wl.device) @ wl).to(xv.device)
            acc = y if acc is None else acc + y
        return acc

    return forward_op("row_parallel_linear", f, [ensure_tensor(x)])


class VocabParallelEmbedding(Layer):
    """Embedding with the vocab dim sharded over mp: each shard looks up
    the ids in its range (zeros elsewhere), the shards summed."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 weight_attr=None, mp_group=None, name=None):
        super().__init__()
        self.axis = mp_axis_name(mp_group)
        n = _axis_size(self.axis)
        if num_embeddings % n:
            raise ValueError(
                f"VocabParallelEmbedding: vocab {num_embeddings} not divisible "
                f"by mp degree {n}")
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.world_size = n
        self.weight = self.create_parameter(
            [num_embeddings, embedding_dim], attr=weight_attr,
            default_initializer=I.XavierNormal())
        _shard_param(self.weight, (self.axis, None))

    def forward(self, x):
        if in_mp_region(self.axis):
            w = _local_shard(self.weight, self.axis, self.num_embeddings, 0)

            def local_lookup(ids, wv, r):
                per = wv.shape[0]
                local = ids.long() - int(r) * per
                ok = (local >= 0) & (local < per)
                emb = wv[torch.where(ok, local, 0)]
                return torch.where(ok[..., None], emb,
                                   torch.zeros((), dtype=emb.dtype,
                                               device=emb.device))
            emb = forward_op("vocab_parallel_embedding", local_lookup,
                             [ensure_tensor(x), w, axis_index(self.axis)])
            return mp_ops._psum(emb, self.axis)
        w = self.weight
        if not isinstance(w, DistTensor):
            return F.embedding(x, w)
        coords = _group(w, self.axis)

        def lookup(ids):
            acc = None
            for j, c in enumerate(coords):
                wl = w.local(c)
                per = wl.shape[0]
                local = ids.to(wl.device).long() - j * per
                ok = (local >= 0) & (local < per)
                e = torch.where(ok[..., None], wl[torch.where(ok, local, 0)],
                                torch.zeros((), dtype=wl.dtype,
                                            device=wl.device)).to(ids.device)
                acc = e if acc is None else acc + e
            return acc

        return forward_op("vocab_parallel_embedding", lookup,
                          [ensure_tensor(x)])

    def extra_repr(self):
        return f"{self.num_embeddings}, {self.embedding_dim}, mp={self.world_size}"


class ColumnParallelLinear(Layer):
    """Linear with the output dim sharded over mp. ``gather_output=True``
    returns the full [.., out]; ``False`` leaves it sharded on its last
    dim (in a region: each coordinate's block; outside: the logical
    value, whose blocks the mp coordinates computed)."""

    def __init__(self, in_features: int, out_features: int, weight_attr=None,
                 has_bias: bool = True, gather_output: bool = True,
                 fuse_matmul_bias: bool = False, mp_group=None, name=None):
        super().__init__()
        self.axis = mp_axis_name(mp_group)
        n = _axis_size(self.axis)
        if out_features % n:
            raise ValueError(
                f"ColumnParallelLinear: out_features {out_features} not "
                f"divisible by mp degree {n}")
        self.in_features = in_features
        self.out_features = out_features
        self.world_size = n
        self.gather_output = gather_output
        self.weight = self.create_parameter(
            [in_features, out_features], attr=weight_attr,
            default_initializer=I.XavierNormal())
        _shard_param(self.weight, (None, self.axis))
        self.bias = self.create_parameter([out_features], is_bias=True) \
            if has_bias else None
        if self.bias is not None:
            _shard_param(self.bias, (self.axis,))

    def forward(self, x):
        if in_mp_region(self.axis):
            x = c_identity(x, self.axis)
            w = _local_shard(self.weight, self.axis, self.out_features, 1)
            b = _local_shard(self.bias, self.axis, self.out_features, 0)
            y = F.linear(x, w, b)
            return c_concat(y, self.axis) if self.gather_output else y
        return _column(x, self.weight, self.bias, self.axis)

    def extra_repr(self):
        return (f"in={self.in_features}, out={self.out_features}, "
                f"mp={self.world_size}, gather_output={self.gather_output}")


class RowParallelLinear(Layer):
    """Linear with the input dim sharded over mp; the bias is added after
    the reduction. ``input_is_parallel=True`` takes an activation already
    sharded on its last dim (a ColumnParallelLinear's with
    ``gather_output=False``)."""

    def __init__(self, in_features: int, out_features: int, weight_attr=None,
                 has_bias: bool = True, input_is_parallel: bool = False,
                 fuse_matmul_bias: bool = False, mp_group=None, name=None):
        super().__init__()
        self.axis = mp_axis_name(mp_group)
        n = _axis_size(self.axis)
        if in_features % n:
            raise ValueError(
                f"RowParallelLinear: in_features {in_features} not divisible "
                f"by mp degree {n}")
        self.in_features = in_features
        self.out_features = out_features
        self.world_size = n
        self.input_is_parallel = input_is_parallel
        self.weight = self.create_parameter(
            [in_features, out_features], attr=weight_attr,
            default_initializer=I.XavierNormal())
        _shard_param(self.weight, (self.axis, None))
        self.bias = self.create_parameter([out_features], is_bias=True) \
            if has_bias else None

    def forward(self, x):
        if in_mp_region(self.axis):
            w = _local_shard(self.weight, self.axis, self.in_features, 0)
            if not self.input_is_parallel:
                x = mp_ops.c_split(x, self.axis)
            y = mp_allreduce(F.linear(x, w), self.axis)
        else:
            y = _row(x, self.weight, self.axis)
        if self.bias is not None:
            y = y + self.bias
        return y

    def extra_repr(self):
        return (f"in={self.in_features}, out={self.out_features}, "
                f"mp={self.world_size}, input_is_parallel={self.input_is_parallel}")


def _ce_parts(parts, lb, starts, ignore_index: int, dev):
    """Megatron's softmax cross-entropy over vocab blocks ``parts`` (block
    ``j`` starts at ``starts[j]``; each on its own device): the max and the
    exp-sums reduced in block order on ``dev``, the target logit taken
    from the block that holds it. Returns the per-token loss [..., 1]."""
    m = None
    for p in parts:
        pm = p.detach().max(dim=-1).values.to(dev)
        m = pm if m is None else torch.maximum(m, pm)
    sumexp, tgt = None, None
    for p, s in zip(parts, starts):
        z = p - m.to(p.device)[..., None]
        e = torch.exp(z).sum(dim=-1).to(dev)
        local = lb.to(p.device) - s
        ok = (local >= 0) & (local < p.shape[-1])
        t = torch.gather(z, -1, torch.where(ok, local, 0)[..., None])[..., 0]
        t = torch.where(ok, t, torch.zeros((), dtype=t.dtype,
                                           device=t.device)).to(dev)
        sumexp = e if sumexp is None else sumexp + e
        tgt = t if tgt is None else tgt + t
    loss = torch.log(sumexp) - tgt
    loss = torch.where(lb.to(dev) == ignore_index,
                       torch.zeros((), dtype=loss.dtype, device=dev), loss)
    return loss[..., None]


class ParallelCrossEntropy(Layer):
    """Softmax cross-entropy over vocab-sharded logits, Megatron's
    algorithm: the max, the exp-sums and the target logit reduced over
    the mp shards. Returns the per-token loss [..., 1]; ``ignore_index``
    tokens give 0."""

    def __init__(self, mp_group=None, name=None, ignore_index: int = -100):
        super().__init__()
        self.axis = mp_axis_name(mp_group)
        self.ignore_index = ignore_index

    def forward(self, logits, label):
        axis, ign = self.axis, self.ignore_index
        logits, label = ensure_tensor(logits), ensure_tensor(label)

        def squeeze(lg, lb):
            return lb[..., 0] if lb.dim() == lg.dim() else lb

        if in_mp_region(axis):
            m = mp_ops._pmax(forward_op(
                "pce_local_max", lambda lg: lg.detach().max(dim=-1).values,
                [logits], differentiable=False), axis)
            z = forward_op("pce_shift", lambda lg, mv: lg - mv[..., None],
                           [logits, m])
            sumexp = mp_ops._psum(forward_op(
                "pce_sumexp", lambda zv: torch.exp(zv).sum(dim=-1), [z]), axis)

            def target(zv, lb, r):
                lb = squeeze(zv, lb).long()
                local = lb - int(r) * zv.shape[-1]
                ok = (local >= 0) & (local < zv.shape[-1])
                t = torch.gather(zv, -1, torch.where(ok, local, 0)[..., None])
                return torch.where(ok, t[..., 0],
                                   torch.zeros((), dtype=zv.dtype,
                                               device=zv.device))
            tgt = mp_ops._psum(forward_op(
                "pce_target", target, [z, label, axis_index(axis)]), axis)

            def finish(se, tg, lb):
                loss = torch.log(se) - tg
                lb = squeeze(se[..., None], lb)
                return torch.where(lb == ign, torch.zeros(
                    (), dtype=loss.dtype, device=loss.device), loss)[..., None]
            return forward_op("parallel_cross_entropy", finish,
                              [sumexp, tgt, label])

        hcg = get_hybrid_communicate_group()
        mesh = hcg.mesh
        coords = mesh.group(anchor(mesh), (axis,))

        def f(lg, lb):
            lb = squeeze(lg, lb).long()
            parts = lg.chunk(len(coords), dim=-1)
            per = parts[0].shape[-1]
            parts = [p.to(mesh.devices[c]) for p, c in zip(parts, coords)]
            return _ce_parts(parts, lb, [j * per for j in range(len(parts))],
                             ign, lg.device)

        return forward_op("parallel_cross_entropy", f, [logits, label])


# ---------------------------------------------------------------------------
# the legacy c_* compute ops behind the layers (ref: c_embedding_op /
# c_softmax_with_cross_entropy_op): each does the local shard's work plus
# the collective the reference's kernel fuses.
# ---------------------------------------------------------------------------

def c_embedding(table, ids, start_index: int = 0, vocab_size: int = -1,
                group=None, name=None):
    """Vocab-shard embedding lookup: rows outside this shard's
    [start_index, start_index + rows) contribute zero; an all_reduce over
    the group (in a launched multi-process world) merges the shards."""
    tt, it = ensure_tensor(table), ensure_tensor(ids)

    def impl(tv, iv):
        local = iv.long() - start_index
        ok = (local >= 0) & (local < tv.shape[0])
        return tv[local.clamp(0, tv.shape[0] - 1)] * ok[..., None]

    out = forward_op("c_embedding", impl, [tt, it])
    from .... import collective as C
    if C._launched() and C.get_world_size(group) > 1:
        C.all_reduce(out, group=group)
    return out


def c_softmax_with_cross_entropy(logits, label, group=None,
                                 ignore_index: int = -100, name=None):
    """Vocab-sharded softmax CE: ParallelCrossEntropy's formulation over a
    hybrid mesh with mp > 1, the plain per-token CE otherwise."""
    hcg = get_hybrid_communicate_group()
    if hcg.get_model_parallel_world_size() > 1 or in_mp_region("mp"):
        return ParallelCrossEntropy(ignore_index=ignore_index)(logits, label)
    return F.cross_entropy(logits, label, reduction="none",
                           ignore_index=ignore_index)


for _n, _f in (("c_embedding", c_embedding),
               ("c_softmax_with_cross_entropy", c_softmax_with_cross_entropy)):
    register_op(_n, _f, (_f.__doc__ or "").strip().split("\n")[0],
                category="distributed", public=_f)

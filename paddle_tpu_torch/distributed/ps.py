"""Parameter-server equivalent: large-scale sparse-embedding training —
counterpart of ``paddle_tpu/distributed/ps.py`` (ref: Paddle's
parameter-server stack: MemorySparseTable, the ``lookup_table`` /
``distributed_lookup_table`` ops, SelectedRows gradients, the async
update path).

What the architecture provides, re-derived here:

1. **The table lives where memory is cheap; compute touches only the
   batch's rows.** ``SparseEmbedding(host=True)`` keeps the table in host
   RAM (numpy, ``device_bytes() == 0``): each call gathers the batch's
   rows and copies only them to the card; the update is applied on the
   host. ``host=False`` keeps the table on the card, and the gather, the
   gradient and the update stay there.
2. **Gradients are SelectedRows, never dense.** The forward adds a zero
   ``delta`` leaf of the gathered rows' shape, so backward fills a
   ``[n_ids, dim]`` rows gradient: with the ids it is the reference's
   SelectedRows pair. No ``[vocab, dim]`` gradient exists.
3. **Optimizer state moves only at the touched rows** (lazy / sparse
   semantics): ``SparseSGD`` / ``SparseAdagrad`` / ``SparseAdam`` update
   their per-row state at the merged unique ids, in numpy for a host
   table and in torch on the table's device otherwise, with the same
   arithmetic (Adam's bias correction in float64, as the reference's).

Scale-out is vocab sharding: ``DistributedSparseEmbedding`` gives each
process of a launched job a contiguous row range (a masked local lookup,
summed across the processes by ``torch.distributed.all_reduce`` over the
gloo group ``collective.init_parallel_env`` joins), and each process
applies the updates of its own rows. ``AsyncLookup`` gathers the next
batch's rows on a worker thread and copies them on a side stream while
the current step runs. Tables are drawn from
``numpy.random.default_rng(seed)``, so they equal the reference's.
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np
import torch

from ..core.dispatch import register_op
from ..core.place import torch_device
from ..core.tensor import Tensor, to_tensor
from ..ops._helpers import ensure_tensor, forward_op

__all__ = [
    "SelectedRows", "SparseEmbedding", "DistributedSparseEmbedding",
    "SparseSGD", "SparseAdagrad", "SparseAdam", "AsyncLookup",
    "lookup_table", "lookup_table_v2", "merge_selected_rows",
    "get_tensor_from_selected_rows", "distributed_lookup_table",
    "distributed_push_sparse",
]


# ---------------------------------------------------------------------------
# SelectedRows (ref: paddle/fluid/framework/selected_rows.h)
# ---------------------------------------------------------------------------

class SelectedRows:
    """(row ids, value rows, logical height). Duplicate ids are allowed
    until :meth:`merge` (the reference's merge_selected_rows pass). Rows
    given as a torch tensor keep ids and rows on its device; otherwise
    both are numpy."""

    def __init__(self, ids, rows, height: int):
        if isinstance(rows, torch.Tensor):
            self.ids = torch.as_tensor(ids, device=rows.device).reshape(
                -1).long()
            self.rows = rows.reshape(self.ids.shape[0], -1)
        else:
            self.ids = np.asarray(ids).reshape(-1).astype(np.int64)
            self.rows = np.asarray(rows).reshape(self.ids.shape[0], -1)
        self.height = int(height)

    def merge(self) -> "SelectedRows":
        """Accumulate duplicate ids (ref: merge_selected_rows op); the ids
        come out sorted."""
        if isinstance(self.rows, torch.Tensor):
            uniq, inv = torch.unique(self.ids, return_inverse=True)
            out = torch.zeros((uniq.shape[0], self.rows.shape[1]),
                              dtype=self.rows.dtype, device=self.rows.device)
            out.index_add_(0, inv, self.rows)
            return SelectedRows(uniq, out, self.height)
        uniq, inv = np.unique(self.ids, return_inverse=True)
        out = np.zeros((uniq.shape[0], self.rows.shape[1]), self.rows.dtype)
        np.add.at(out, inv.reshape(-1), self.rows)
        return SelectedRows(uniq, out, self.height)

    def to_dense(self) -> np.ndarray:
        """The dense gradient as numpy (ref: get_tensor_from_selected_rows)
        — for oracles and tests; training never calls this."""
        ids, rows = self.ids, self.rows
        if isinstance(rows, torch.Tensor):
            ids, rows = ids.cpu().numpy(), rows.detach().cpu().numpy()
        out = np.zeros((self.height, rows.shape[1]), rows.dtype)
        np.add.at(out, ids, rows)
        return out


# ---------------------------------------------------------------------------
# lookup ops
# ---------------------------------------------------------------------------

def lookup_table(w, ids, padding_idx=None, name=None):
    """Embedding row gather (ref: lookup_table_v2_op — the dense-gradient
    lookup; the sparse-gradient path is :class:`SparseEmbedding`)."""

    def impl(wv, iv):
        out = wv[iv.clamp(0, wv.shape[0] - 1)]
        if padding_idx is not None:
            out = out * (iv != padding_idx)[..., None].to(out.dtype)
        return out

    return forward_op("lookup_table", impl, [ensure_tensor(w),
                                             ensure_tensor(ids)])


lookup_table_v2 = lookup_table


def merge_selected_rows(sel: SelectedRows, name=None) -> SelectedRows:
    """ref: merge_selected_rows_op."""
    return sel.merge()


def get_tensor_from_selected_rows(sel: SelectedRows, name=None):
    """ref: get_tensor_from_selected_rows_op."""
    return to_tensor(sel.to_dense())


def _host_ids(ids) -> np.ndarray:
    if isinstance(ids, Tensor):
        return ids.numpy().astype(np.int64)
    if isinstance(ids, torch.Tensor):
        return ids.detach().cpu().numpy().astype(np.int64)
    return np.asarray(ids).astype(np.int64)


# ---------------------------------------------------------------------------
# SparseEmbedding
# ---------------------------------------------------------------------------

class SparseEmbedding:
    """Embedding whose gradient is SelectedRows (ref:
    paddle.static.nn.sparse_embedding / lookup_table with is_sparse=True).

    Not an ``nn.Layer``: its table is in no ``parameters()`` (a dense
    optimizer would densify the gradient); the sparse optimizers below own
    its update, as the parameter server owns the reference's tables.

    ``host=True`` keeps the table in host RAM and copies only the gathered
    rows to ``device`` (the current place when None); ``host=False`` keeps
    it on ``device``.
    """

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 host: bool = False, dtype=np.float32, scale: float = 0.01,
                 seed: int = 0, device=None):
        self.num_embeddings = int(num_embeddings)
        self.embedding_dim = int(embedding_dim)
        self.host = bool(host)
        self.device = torch_device(device)
        rng = np.random.default_rng(seed)
        table = (rng.standard_normal(
            (num_embeddings, embedding_dim)) * scale).astype(dtype)
        self._table = table if host else torch.from_numpy(table).to(
            self.device)
        self._last: Optional[tuple] = None    # (ids, delta Tensor)

    # -- weight access -----------------------------------------------------
    @property
    def weight(self) -> np.ndarray:
        return (self._table if self.host
                else self._table.detach().cpu().numpy())

    def set_weight(self, w) -> None:
        w = np.asarray(w, self.weight.dtype)
        self._table = w if self.host else torch.from_numpy(w).to(self.device)

    def device_bytes(self) -> int:
        """Bytes of table data on the card: 0 for a host table (only the
        gathered rows ever reach it)."""
        return 0 if self.host else \
            self._table.numel() * self._table.element_size()

    def _gather(self, flat):
        """The rows of ids ``flat`` (host numpy for a host table, a long
        tensor on the table's device otherwise) on ``self.device``."""
        if self.host:
            rows = self._table[np.clip(flat, 0, self.num_embeddings - 1)]
            return torch.from_numpy(rows).to(self.device)
        return self._table[flat.clamp(0, self.num_embeddings - 1)]

    # -- forward -----------------------------------------------------------
    def __call__(self, ids):
        if self.host:
            ids_np = _host_ids(ids)
            shape, flat = ids_np.shape, ids_np.reshape(-1)
        else:
            iv = ensure_tensor(ids)._value
            shape, flat = tuple(iv.shape), iv.reshape(-1).to(
                self.device).long()
        rows = self._gather(flat)
        # the zero delta leaf: backward's gradient for it IS the rows
        # gradient
        delta = Tensor(torch.zeros_like(rows), stop_gradient=False)
        self._last = (flat, delta)
        out = Tensor(rows) + delta
        from ..ops.manipulation import reshape
        return reshape(out, list(shape) + [self.embedding_dim])

    # -- sparse gradient ---------------------------------------------------
    def sparse_grad(self) -> SelectedRows:
        """SelectedRows gradient of the LAST forward (after backward()):
        numpy for a host table, on the table's device otherwise."""
        if self._last is None:
            raise RuntimeError("sparse_grad: run forward + backward first")
        ids, delta = self._last
        if delta.grad is None:
            raise RuntimeError("sparse_grad: no gradient recorded — did "
                               "backward() run?")
        g = delta.grad._value
        return SelectedRows(ids, g.cpu().numpy() if self.host else g,
                            self.num_embeddings)

    def apply_rows(self, ids, updates) -> None:
        """In-place row update (the push): ``table[ids] += updates``."""
        if self.host:
            np.add.at(self._table, ids, updates)
        else:
            self._table.index_add_(0, ids, updates.to(self._table.dtype))


# ---------------------------------------------------------------------------
# sparse optimizers (lazy semantics: state exists for every row but is
# read and written only at the touched ids — MemorySparseTable's per-row
# optimizer storage)
# ---------------------------------------------------------------------------

def _zeros(emb, shape, dtype):
    """Optimizer state beside ``emb``'s table: numpy for a host table, a
    tensor on its device otherwise."""
    if emb.host:
        return np.zeros(shape, dtype)
    return torch.zeros(shape, dtype=getattr(torch, np.dtype(dtype).name),
                       device=emb.device)


class _SparseOptimizerBase:
    def __init__(self, embedding: SparseEmbedding, learning_rate: float):
        self.emb = embedding
        self.lr = float(learning_rate)

    def step(self, grad: Optional[SelectedRows] = None) -> None:
        sel = (grad if grad is not None
               else self.emb.sparse_grad()).merge()
        upd = self._rows_update(sel.ids, sel.rows)
        self.emb.apply_rows(sel.ids, upd)

    def _rows_update(self, ids, g):
        raise NotImplementedError


class SparseSGD(_SparseOptimizerBase):
    """Stateless sparse SGD (ref: the PS naive table)."""

    def _rows_update(self, ids, g):
        return -self.lr * g


class SparseAdagrad(_SparseOptimizerBase):
    """Sparse Adagrad (ref: MemorySparseTable's adagrad rule): the G
    accumulator is a per-row vector touched only at ``ids``."""

    def __init__(self, embedding, learning_rate=0.01, epsilon=1e-6):
        super().__init__(embedding, learning_rate)
        self.eps = epsilon
        self._accum = _zeros(embedding, (embedding.num_embeddings,
                                         embedding.embedding_dim), np.float32)

    def _rows_update(self, ids, g):
        self._accum[ids] += g * g
        root = np.sqrt(self._accum[ids]) if isinstance(g, np.ndarray) \
            else torch.sqrt(self._accum[ids])
        return -self.lr * g / (root + self.eps)


class SparseAdam(_SparseOptimizerBase):
    """Lazy sparse Adam (ref: adam op with lazy_mode=True): moments and
    the per-row step count advance only when a row is touched."""

    def __init__(self, embedding, learning_rate=0.001, beta1=0.9,
                 beta2=0.999, epsilon=1e-8):
        super().__init__(embedding, learning_rate)
        self.b1, self.b2, self.eps = beta1, beta2, epsilon
        n, d = embedding.num_embeddings, embedding.embedding_dim
        self._m = _zeros(embedding, (n, d), np.float32)
        self._v = _zeros(embedding, (n, d), np.float32)
        self._t = _zeros(embedding, (n,), np.int64)

    def _rows_update(self, ids, g):
        self._t[ids] += 1
        m = self._m[ids] = self.b1 * self._m[ids] + (1 - self.b1) * g
        v = self._v[ids] = self.b2 * self._v[ids] + (1 - self.b2) * g * g
        if isinstance(g, np.ndarray):
            t = self._t[ids][:, None].astype(np.float64)
            mh = m / (1 - self.b1 ** t)
            vh = v / (1 - self.b2 ** t)
            return (-self.lr * mh / (np.sqrt(vh) + self.eps)).astype(g.dtype)
        t = self._t[ids][:, None].to(torch.float64)
        mh = m.to(torch.float64) / (1 - self.b1 ** t)
        vh = v.to(torch.float64) / (1 - self.b2 ** t)
        return (-self.lr * mh / (torch.sqrt(vh) + self.eps)).to(g.dtype)


# ---------------------------------------------------------------------------
# vocab-sharded distributed table
# ---------------------------------------------------------------------------

def _world():
    """(world size, rank) of the launched job, (1, 0) outside one."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


class DistributedSparseEmbedding:
    """Vocab-sharded SparseEmbedding over the processes of a launched job
    (ref: distributed_lookup_table_op + the PsClient pull/push pair).

    Rank r owns the contiguous rows [r*shard, (r+1)*shard). Lookup = the
    local masked gather, summed over the processes by an all_reduce (the
    c_embedding formulation: the collective IS the pull); update = each
    rank applies only its own rows (the push never leaves the owner)."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 host: bool = False, seed: int = 0, group=None, device=None):
        self.group = group
        self.world, self.rank = _world()
        self.num_embeddings = int(num_embeddings)
        self.shard = (num_embeddings + self.world - 1) // self.world
        self.start = self.rank * self.shard
        # every shard is padded to the same row count (uniform shapes for
        # the all_gather; pad rows are zero and never addressed)
        rng = np.random.default_rng(seed)
        full = (rng.standard_normal(
            (num_embeddings, embedding_dim)) * 0.01).astype(np.float32)
        padded = np.zeros((self.shard, embedding_dim), np.float32)
        real = full[self.start:self.start + self.shard]
        padded[:real.shape[0]] = real
        self.local = SparseEmbedding(self.shard, embedding_dim,
                                     host=host, seed=seed, device=device)
        self.local.set_weight(padded)

    def __call__(self, ids):
        ids_np = _host_ids(ids)
        local_ids = np.clip(ids_np - self.start, 0,
                            self.local.num_embeddings - 1)
        mine = ((ids_np >= self.start) &
                (ids_np < min(self.start + self.shard, self.num_embeddings)))
        out = self.local(local_ids if self.local.host else
                         torch.from_numpy(local_ids).to(self.local.device))
        mask = to_tensor(mine.astype(np.float32), place=self.local.device)
        out = forward_op(
            "c_embedding_mask",
            lambda o, m: o * m.reshape(m.shape + (1,) * (o.dim() - m.dim())),
            [out, mask])
        if self.world > 1:
            # the cross-process sum of the masked shards (the pull); the
            # gradient needs no cross-process path, since each rank's
            # update touches only its own shard
            from .collective import _dist_all_reduce
            local = out._value.detach()
            summed = _dist_all_reduce(local.clone(), "sum")
            out = out + Tensor(summed - local)
        return out

    def sparse_grad(self) -> SelectedRows:
        """The LOCAL shard's SelectedRows (global ids)."""
        sel = self.local.sparse_grad()
        return SelectedRows(sel.ids + self.start, sel.rows,
                            self.num_embeddings)

    def weight_full(self) -> np.ndarray:
        """The all-gathered table (tests only)."""
        if self.world <= 1:
            return self.local.weight
        from .collective import _dist_all_gather
        w = torch.from_numpy(np.ascontiguousarray(self.local.weight)).to(
            self.local.device)
        parts = _dist_all_gather(w)
        return torch.cat(parts).cpu().numpy()[:self.num_embeddings]


def distributed_lookup_table(table: DistributedSparseEmbedding, ids,
                             name=None):
    """Functional entry (ref: distributed_lookup_table_op — the pull)."""
    return table(ids)


def distributed_push_sparse(table: DistributedSparseEmbedding,
                            optimizer: _SparseOptimizerBase, name=None):
    """Apply the LOCAL shard's sparse update (ref: distributed_push_sparse
    — the push; only the owner's rows move)."""
    sel = table.local.sparse_grad().merge()
    upd = optimizer._rows_update(sel.ids, sel.rows)
    table.local.apply_rows(sel.ids, upd)


# ---------------------------------------------------------------------------
# async prefetch (the PS client's latency hiding)
# ---------------------------------------------------------------------------

class AsyncLookup:
    """Double-buffered host-to-device row prefetch for a host table: while
    the card computes step t, a worker thread gathers step t+1's rows and
    copies them to the card on a side stream (ref: the async PsClient pull
    pipeline).

    One prefetch may be in flight at a time (a second before ``take()``
    raises: dropping an un-taken batch would feed stale rows); a worker
    failure re-raises from ``take()``."""

    def __init__(self, embedding: SparseEmbedding):
        self.emb = embedding
        self._thread: Optional[threading.Thread] = None
        self._next = None
        self._error: Optional[BaseException] = None

    def prefetch(self, ids) -> None:
        if self._thread is not None:
            raise RuntimeError(
                "prefetch() while a prefetch is already in flight — "
                "take() the previous batch first")
        ids_np = _host_ids(ids)
        self._error = None
        dev = self.emb.device

        def work():
            try:
                flat = ids_np.reshape(-1)
                rows = torch.from_numpy(self.emb.weight[np.clip(
                    flat, 0, self.emb.num_embeddings - 1)])
                if dev.type == "cuda":
                    # the copy runs on a side stream; take() orders the
                    # consumer after it
                    stream = torch.cuda.Stream(device=dev)
                    with torch.cuda.stream(stream):
                        rows = rows.pin_memory().to(dev, non_blocking=True)
                        ready = torch.cuda.Event()
                        ready.record(stream)
                else:
                    ready = None
                self._next = (ids_np, rows, ready)
            except BaseException as e:   # surfaced by take()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def take(self):
        """``(ids, rows Tensor)`` prefetched by the last :meth:`prefetch`
        (blocks while the gather is in flight; re-raises the worker's
        exception)."""
        if self._thread is None:
            raise RuntimeError("take() before prefetch()")
        self._thread.join()
        self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
        ids_np, rows, ready = self._next
        self._next = None
        if ready is not None:
            consumer = torch.cuda.current_stream(rows.device)
            consumer.wait_event(ready)
            rows.record_stream(consumer)
        return ids_np, Tensor(rows)


for _n in ["lookup_table", "lookup_table_v2", "merge_selected_rows",
           "get_tensor_from_selected_rows", "distributed_lookup_table",
           "distributed_push_sparse"]:
    _f = globals()[_n]
    register_op(_n, _f, (_f.__doc__ or "").strip().split("\n")[0],
                category="ps", public=_f)

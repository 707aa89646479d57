"""Paged KV cache — host-side block accounting over the device block pool.

Counterpart of ``paddle_tpu/inference/serving/paged_cache.py``
(``prefix_block_chain``, ``BlockManager``, ``PagedKVCache``). The device
holds ONE physical block pool ``{"k","v": [L, num_blocks, block_size, Hk,
D]}`` (:func:`paddle_tpu_torch.models.generation.init_paged_pool`); a
sequence owns an ordered list of physical blocks recorded in its slot's row
of the ``[max_slots, W]`` block-table matrix. This module is the HOST
half: a ref-counted block manager with a content-hash prefix cache plus the
table matrix every dispatch ships. Physical block 0 is the NULL block and
is never allocated.

Allocation is on demand: a sequence holds only the blocks covering KV it
has filled; when the pool runs dry the engine preempts. Every FULL block's
token ids are content-hashed into a CHAINED key (the key covers the whole
block-aligned prefix), so admissions sharing a prefix map the cached blocks
by refcount instead of re-running prefill over them; refcount-0 blocks stay
cached on an LRU list until allocation evicts them. With the host offload
tier attached (:mod:`.offload`), an evicted registered block swaps to host
RAM instead of dying, and ``admit`` restores it on the next hit.

The device pool's storage never moves: every write (the paged entry
points' K/V stores, the tier's restores) lands in place, so block I/O
here copies ``pool[leaf][:, b]`` slices directly.

Not ported yet: the tensor-parallel pool layout (``PagedKVCache`` raises
when asked for it).
"""

from __future__ import annotations

import math
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ...models.generation import init_paged_pool
from .offload import HostOffloadTier, _Capture

__all__ = ["BlockManager", "PagedKVCache", "prefix_block_chain"]


def prefix_block_chain(ids: Sequence[int], block_size: int, upto: int,
                       start: int = 0, prev_key: Optional[int] = None,
                       base: int = 0, namespace: Optional[str] = None):
    """Yield ``(key, tokens)`` for the FULL blocks ``start .. upto //
    block_size`` of a sequence — the one definition of the chained content
    key. Key ``i`` hashes (key ``i-1``, block ``i``'s token ids), so equal
    keys imply equal whole block-aligned prefixes; hits are still verified
    against the stored tokens (:meth:`BlockManager.lookup`). ``ids`` is
    indexed relative to ``base``. ``namespace`` seeds the chain root so
    KV written under another namespace never cross-hits; ``None`` leaves
    the seed untouched."""
    h = prev_key
    if h is None and namespace is not None:
        h = hash(("adapter-ns", namespace))
    for i in range(start, int(upto) // block_size):
        lo = i * block_size - base
        toks = tuple(int(t) for t in ids[lo:lo + block_size])
        h = hash((h, toks))
        yield h, toks


class BlockManager:
    """Ref-counted allocator over the physical block ids ``1..num_blocks-1``
    (block 0 = null) with a content-hash prefix cache.

    Lifecycle of a block: free list -> ``alloc`` (refcount 1) -> optionally
    ``register``\\ ed under its chained content key once full -> shared by
    later sequences via ``lookup`` + ``share`` -> ``free`` (refcount--) ->
    at refcount 0 a registered block parks on the EVICTABLE LRU list (still
    a cache hit) while an unregistered one returns to the free list.
    ``alloc`` takes from the free list first and evicts LRU refcount-0
    cached blocks only when that runs dry. Double-free and foreign-id frees
    raise.
    """

    def __init__(self, num_blocks: int, block_size: int,
                 tenant_quota: Optional[int] = None):
        if num_blocks < 2:
            raise ValueError(f"need >= 2 blocks (1 null + 1 usable), "
                             f"got {num_blocks}")
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        # per-tenant prefix-cache quota: a tenant at its quota recycles its
        # OWN entries instead of evicting other tenants'. None = unlimited.
        self.tenant_quota = int(tenant_quota) if tenant_quota else None
        # LIFO free list: hot blocks are reused first
        self._free: List[int] = list(range(num_blocks - 1, 0, -1))
        self._ref: Dict[int, int] = {}           # block -> live refcount
        self._hash2block: Dict[int, int] = {}    # chained key -> block
        self._block2hash: Dict[int, int] = {}
        # block -> its token ids: lookup() verifies hits against these, so
        # a 64-bit key collision degrades to a MISS
        self._block_tokens: Dict[int, Tuple[int, ...]] = {}
        # refcount-0 registered blocks, insertion order = LRU release order
        self._evictable: "OrderedDict[int, None]" = OrderedDict()
        self._block_tenant: Dict[int, str] = {}
        self._tenant_cached: Dict[str, int] = {}
        self.evictions = 0
        # host offload tier, installed by PagedKVCache when the engine asks
        # for it: `offload_capture(b)` enqueues the copy of block b's
        # leaves to host buffers (the cache owns device I/O); `offload.put`
        # accepts the capture
        self.offload = None
        self.offload_capture = None
        # fleet cache directory: the router subscribes these so its
        # CacheDirectory learns which replica holds which chain key.
        # `notify_register(key)` fires when a key becomes device-resident;
        # `notify_unregister(key)` when it leaves the device WITHOUT
        # surviving in the host tier (the tier's own on_drop covers the
        # host side), so an entry can be stale-missing but never
        # stale-authoritative. None = no listener.
        self.notify_register = None
        self.notify_unregister = None

    @property
    def free_blocks(self) -> int:
        """Blocks allocatable RIGHT NOW: the free list plus the refcount-0
        cached blocks eviction can reclaim."""
        return len(self._free) + len(self._evictable)

    @property
    def cached_blocks(self) -> int:
        return len(self._hash2block)

    @property
    def blocks_in_use(self) -> int:
        return len(self._ref)

    def blocks_for(self, kv_tokens: int) -> int:
        """Physical blocks needed to hold ``kv_tokens`` KV entries."""
        return max(1, math.ceil(kv_tokens / self.block_size))

    def can_alloc(self, n: int) -> bool:
        return n <= self.free_blocks

    def alloc(self, n: int) -> List[int]:
        if n > self.free_blocks:
            raise RuntimeError(f"out of KV blocks: want {n}, "
                               f"free {self.free_blocks}")
        blocks = []
        for _ in range(n):
            if self._free:
                b = self._free.pop()
            else:                                # LRU-evict a cached block
                b, _ = self._evictable.popitem(last=False)
                self._offload(b)
                self._unregister(b)
                self.evictions += 1
            self._ref[b] = 1
            blocks.append(b)
        return blocks

    def _offload(self, b: int) -> None:
        """Swap a dying registered block into the host tier (when one is
        attached) — called at both eviction sites, BEFORE the block's
        registration (key + verified tokens) is dropped. Blocks without
        stored tokens are skipped: the tier's verified-hit contract needs
        them."""
        if self.offload is None or self.offload_capture is None:
            return
        key = self._block2hash.get(b)
        toks = self._block_tokens.get(b)
        if key is not None and toks is not None:
            self.offload.put(key, toks, self.offload_capture(b))

    def _unregister(self, b: int) -> None:
        """Drop block ``b``'s prefix-cache registration (hash maps, stored
        tokens, tenant accounting)."""
        key = self._block2hash.pop(b)
        del self._hash2block[key]
        if self.notify_unregister is not None and \
                not (self.offload is not None and self.offload.holds(key)):
            # both eviction sites _offload() BEFORE _unregister(), so a
            # key the tier accepted is still replica-resident — the
            # directory entry survives the swap-out
            self.notify_unregister(key)
        self._block_tokens.pop(b, None)
        t = self._block_tenant.pop(b, None)
        if t is not None:
            self._tenant_cached[t] -= 1
            if not self._tenant_cached[t]:
                del self._tenant_cached[t]

    def tenant_cached(self, tenant: str) -> int:
        """Registered prefix-cache blocks currently charged to a tenant."""
        return self._tenant_cached.get(tenant, 0)

    def free(self, blocks: List[int]) -> None:
        for b in blocks:
            if self._ref.get(b, 0) <= 0:
                raise RuntimeError(f"double/foreign free of block {b}")
            self._ref[b] -= 1
            if self._ref[b] == 0:
                del self._ref[b]
                if b in self._block2hash:        # stays cached, evictable
                    self._evictable[b] = None
                else:
                    self._free.append(b)

    # ---- prefix cache ------------------------------------------------------

    def lookup(self, key: int,
               tokens: Optional[Tuple[int, ...]] = None) -> Optional[int]:
        """The cached block for a chained content key, or None. With
        ``tokens`` the hit is VERIFIED against the stored block tokens."""
        b = self._hash2block.get(key)
        if b is not None and tokens is not None \
                and self._block_tokens.get(b) != tokens:
            return None                          # unverifiable == miss
        return b

    def share(self, block: int) -> int:
        """Take a reference on a cached block (a prefix-cache hit)."""
        if block in self._evictable:             # revive from the LRU list
            del self._evictable[block]
            self._ref[block] = 1
        elif self._ref.get(block, 0) > 0:
            self._ref[block] += 1
        else:
            raise RuntimeError(f"share of unknown block {block}")
        return block

    def register(self, key: int, block: int,
                 tokens: Optional[Tuple[int, ...]] = None,
                 tenant: Optional[str] = None) -> None:
        """Content-hash a LIVE full block for prefix sharing. First writer
        wins. With a ``tenant_quota`` and a ``tenant`` at its quota, the
        tenant recycles its own least-recently-released refcount-0 entry —
        or, when all of its entries are still referenced, the registration
        is skipped."""
        if key in self._hash2block or block in self._block2hash:
            return
        if self._ref.get(block, 0) <= 0:
            raise RuntimeError(f"register of non-live block {block}")
        if self.tenant_quota is not None and tenant is not None and \
                self._tenant_cached.get(tenant, 0) >= self.tenant_quota:
            mine = next((b for b in self._evictable
                         if self._block_tenant.get(b) == tenant), None)
            if mine is None:
                return                   # quota full of pinned entries
            del self._evictable[mine]
            self._offload(mine)
            self._unregister(mine)
            self._free.append(mine)
            self.evictions += 1
        if self.offload is not None:
            # the device copy becomes the resident tier for this key — a
            # stale host copy must not survive (device XOR host residency)
            self.offload.discard(key)
        self._hash2block[key] = block
        self._block2hash[block] = key
        if tokens is not None:
            self._block_tokens[block] = tokens
        if self.notify_register is not None:
            self.notify_register(key)
        if tenant is not None:
            self._block_tenant[block] = tenant
            self._tenant_cached[tenant] = \
                self._tenant_cached.get(tenant, 0) + 1


class PagedKVCache:
    """The device block pool + its host bookkeeping, per serving engine.

    ``tables`` is the ``[max_slots, W]`` int32 block-table matrix shipped
    with every dispatch (W = ceil(max_model_len / block_size)); unassigned
    entries point at the null block 0.
    """

    def __init__(self, model_config, max_slots: int, max_model_len: int,
                 block_size: int, num_blocks: int = 0, dtype=None,
                 prefix_cache: bool = True,
                 tenant_quota: Optional[int] = None, kv_quant=None,
                 device=None, mesh=None, offload: bool = False,
                 offload_blocks: int = 0):
        if mesh is not None:
            raise NotImplementedError(
                "tensor-parallel KV pools come with TP serving over NCCL "
                "(ROADMAP.md section A)")
        self.block_size = int(block_size)
        self.max_model_len = int(max_model_len)
        self.prefix_cache = bool(prefix_cache)
        self.kv_quant = kv_quant
        self.blocks_per_seq = max(1, math.ceil(max_model_len / block_size))
        if num_blocks <= 0:
            # auto-size: every slot can hold a full-length sequence, +1 null
            num_blocks = max_slots * self.blocks_per_seq + 1
        self.pool: Dict = init_paged_pool(model_config, num_blocks,
                                          block_size, dtype,
                                          kv_quant=kv_quant, device=device)
        self.manager = BlockManager(num_blocks, block_size,
                                    tenant_quota=tenant_quota)
        self.tables = np.zeros((max_slots, self.blocks_per_seq), np.int32)
        # host sources of H2D restores still in flight: (tensors, event)
        # pairs kept alive until their event completes
        self._inflight: List[Tuple[Dict, torch.cuda.Event]] = []
        # host offload tier: evicted registered blocks swap to a bounded
        # host pool instead of dying; admit() restores them
        self.offload = None
        if offload and prefix_cache and offload_blocks > 0:
            self.offload = HostOffloadTier(offload_blocks, block_size)
            self.manager.offload = self.offload
            self.manager.offload_capture = self.read_block

    @property
    def free_blocks(self) -> int:
        return self.manager.free_blocks

    # ---- device block I/O --------------------------------------------------

    def read_block(self, block: int) -> _Capture:
        """Enqueue the copy of one physical block (``pool[leaf][:, b]``,
        strided across layers) into contiguous host buffers, pinned on a
        card, and return the capture: the buffers plus the CUDA event that
        completes after the copies (the host does not wait here). Later
        kernels that reuse the block are ordered after the copy on the
        stream."""
        data = {}
        event = None
        for name, arr in self.pool.items():
            src = arr[:, block]
            cuda = src.is_cuda
            buf = torch.empty(src.shape, dtype=src.dtype, pin_memory=cuda)
            buf.copy_(src, non_blocking=cuda)
            data[name] = buf
        if any(a.is_cuda for a in self.pool.values()):
            event = torch.cuda.Event()
            event.record()
        return _Capture(data, event)

    def write_block(self, block: int, data: Dict) -> None:
        """Copy one block's per-leaf host tensors back into the pool IN
        PLACE — the offload tier's swap-in restore. On a card the copy is
        asynchronous from pinned memory; its sources stay referenced until
        the copy's event completes."""
        self.write_blocks([block], {n: t.unsqueeze(1)
                                    for n, t in data.items()})

    def write_blocks(self, blocks: List[int], data: Dict) -> None:
        """Copy a run of blocks into the pool in place (``data[leaf]``
        carries the block axis at position 1: ``[L, len(blocks), ...]``)."""
        self._reap()
        idx = torch.as_tensor(np.asarray(blocks, np.int64))
        cuda = False
        for name, arr in self.pool.items():
            src = torch.as_tensor(data[name])
            if src.dtype != arr.dtype:
                src = src.to(arr.dtype)
            cuda = arr.is_cuda
            if len(blocks) == 1:
                arr[:, blocks[0]].copy_(src[:, 0], non_blocking=cuda)
            else:
                arr.index_copy_(1, idx.to(arr.device),
                                src.to(arr.device, non_blocking=cuda))
        if cuda:
            ev = torch.cuda.Event()
            ev.record()
            self._inflight.append((data, ev))

    def _reap(self) -> None:
        """Release the host sources of restores whose copy completed."""
        self._inflight = [(d, e) for d, e in self._inflight
                          if not e.query()]

    # ---- admission ---------------------------------------------------------

    def admit(self, ids: np.ndarray, reserve_kv: Optional[int] = None,
              namespace: Optional[str] = None
              ) -> Optional[Tuple[List[int], int, Tuple[int, Optional[int]]]]:
        """Map + allocate blocks for a sequence entering prefill.

        With the prefix cache on, the longest chain of cached full blocks
        over ``ids[:-1]`` is SHARED into the sequence (at least one token
        always runs through prefill); only the remainder is allocated.
        ``reserve_kv`` switches to the worst-case reservation (the
        ``preempt=False`` mode). Returns ``(blocks, hit_tokens,
        reg_state)`` — ``reg_state`` seeds :meth:`register_prefix` at the
        hit boundary — or None when the pool cannot cover it right now.
        """
        n_tokens = int(reserve_kv) if reserve_kv is not None else len(ids)
        n_total = self.manager.blocks_for(n_tokens)
        if n_total > self.blocks_per_seq:
            raise ValueError(
                f"sequence needs {n_total} blocks ({n_tokens} KV entries) "
                f"but max_model_len {self.max_model_len} caps block tables "
                f"at {self.blocks_per_seq}")
        hits: List[int] = []
        last_key: Optional[int] = None
        if self.prefix_cache:
            # pin-as-we-go: each verified hit is share()d at once, so a
            # host-tier restore's alloc (which may itself LRU-evict) never
            # evicts a block about to be mapped
            for key, toks in prefix_block_chain(ids, self.block_size,
                                                len(ids) - 1,
                                                namespace=namespace):
                b = self.manager.lookup(key, toks)
                if b is not None:
                    self.manager.share(b)
                    hits.append(b)
                    last_key = key
                    continue
                if self.offload is not None and self.manager.can_alloc(1):
                    # device miss — consult the host tier. A verified take
                    # restores the block and re-registers the key: the
                    # chain continues with zero recompute. A miss (absent,
                    # evicted, or checksum-failed) breaks to the recompute
                    # path exactly as without the tier.
                    data = self.offload.take(key, toks)
                    if data is not None:
                        [b] = self.manager.alloc(1)
                        self.write_block(b, data)
                        self.manager.register(key, b, toks)
                        self.offload.swap_ins += 1
                        hits.append(b)
                        last_key = key
                        continue
                break
        n_new = n_total - len(hits)
        if not self.manager.can_alloc(n_new):
            if hits:
                self.manager.free(hits)
            return None
        return (hits + self.manager.alloc(n_new),
                len(hits) * self.block_size, (len(hits), last_key))

    def extend(self, slot: int, blocks: List[int],
               kv_tokens: int) -> Optional[List[int]]:
        """Grow a slot's block list (in place) to cover ``kv_tokens`` KV
        entries. Returns the new blocks ([] when already covered), or None
        when the pool is dry (the engine then preempts)."""
        n = self.manager.blocks_for(kv_tokens) - len(blocks)
        if n <= 0:
            return []
        if not self.manager.can_alloc(n):
            return None
        new = self.manager.alloc(n)
        self.tables[slot, len(blocks):len(blocks) + n] = new
        blocks.extend(new)
        return new

    def register_prefix(self, ids, blocks: List[int], upto: int,
                        state: Tuple[int, Optional[int]] = (0, None),
                        base: int = 0, tenant: Optional[str] = None,
                        namespace: Optional[str] = None
                        ) -> Tuple[int, Optional[int]]:
        """Register the full blocks covering KV entries ``[..upto)`` in the
        prefix cache INCREMENTALLY: ``state`` is ``(blocks already
        registered, chained key of the last one)``, so each block's tokens
        are hashed once over a sequence's lifetime. ``ids`` may be just
        the not-yet-registered tail with ``base`` naming its first KV
        position. Returns the advanced state."""
        if not self.prefix_cache:
            return state
        n, h = state
        for key, toks in prefix_block_chain(ids, self.block_size, upto,
                                            start=n, prev_key=h, base=base,
                                            namespace=namespace):
            self.manager.register(key, blocks[n], toks, tenant=tenant)
            n, h = n + 1, key
        return (n, h)

    def assign(self, slot: int, blocks: List[int]) -> None:
        self.tables[slot] = 0
        self.tables[slot, :len(blocks)] = blocks

    def release(self, slot: int, blocks: List[int]) -> None:
        self.manager.free(blocks)
        self.tables[slot] = 0

    def kv_bytes(self) -> int:
        """Device bytes the pool holds (K + V, plus the scale planes on
        quantized layouts)."""
        return sum(a.numel() * a.element_size() for a in self.pool.values())

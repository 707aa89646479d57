"""Host-RAM KV offload tier: survivable cached blocks.

Counterpart of ``paddle_tpu/inference/serving/offload.py``
(``HostOffloadTier``, ``block_crc``), with the same contract. The paged
engine's prefix cache keeps refcount-0 blocks device-resident until
allocation pressure LRU-evicts them, and an evicted block is recomputed on
the next prefix hit. With the tier attached, the
:class:`~.paged_cache.BlockManager` swaps a dying registered block into a
bounded host pool instead (at both eviction sites: the ``alloc()`` LRU
branch and the tenant-quota recycle in ``register()``). A later prefix hit
or victim readmission restores the chain through ``PagedKVCache.admit()``
with zero recompute; when the tier itself dropped the entry, admission
falls through to the recompute path.

The torch version of each step:

* **Capture.** ``PagedKVCache.read_block`` copies ``pool[leaf][:, b]``
  (strided across layers) into a contiguous host buffer, pinned on a card,
  with ``non_blocking=True``, and records a CUDA event after the copies.
  The copy is ordered on the stream before any later kernel that reuses
  the block, so the host does not wait. On the CPU the copy is done when
  ``copy_`` returns.
* **Materialization.** Where the reference calls ``np.asarray`` (a newer
  put pushing the entry out of the pending window, a lookup, ``flush()``)
  the tier waits on the entry's event and stamps the CRC32 of each leaf's
  raw bytes. A pinned buffer is never dropped before its event completes:
  a pending entry evicted by the bound waits on its event first.
* **Checksums.** :func:`block_crc` is CRC32 over the tensor's bytes (a
  ``torch.uint8`` view, since numpy has no bf16), so the same bytes give
  the reference's value.
* **Move semantics.** A verified ``take()`` removes the entry: a block key
  is device-resident XOR host-resident, and ``BlockManager.register()``
  discards any stale host copy when the key registers on device again.
* **Bounded.** At ``capacity`` blocks the least-recently-written entry is
  dropped (``tier_evictions``); ``resize()`` changes the bound live.
"""

from __future__ import annotations

import zlib
from collections import OrderedDict
from typing import Dict, Optional, Tuple

import numpy as np
import torch

__all__ = ["HostOffloadTier", "block_crc"]


def _bytes(arr) -> np.ndarray:
    """The raw bytes of a host tensor or array, as a flat uint8 array."""
    if isinstance(arr, torch.Tensor):
        return arr.detach().cpu().contiguous().reshape(-1) \
            .view(torch.uint8).numpy()
    return np.ascontiguousarray(arr).reshape(-1).view(np.uint8)


def block_crc(arr) -> int:
    """CRC32 of one block leaf's raw bytes — the checksum the tier stamps
    at materialization and re-verifies at ``take`` / ``peek``. Equal bytes
    give the reference's ``block_crc`` value."""
    return zlib.crc32(_bytes(arr))


class _Capture:
    """One swap-out in flight: per-leaf host buffers and the CUDA event
    recorded after their copies were enqueued (None on the CPU)."""

    __slots__ = ("data", "event")

    def __init__(self, data: Dict[str, torch.Tensor], event=None):
        self.data = data
        self.event = event

    def wait(self) -> Dict[str, torch.Tensor]:
        if self.event is not None:
            self.event.synchronize()
            self.event = None
        return self.data


class HostOffloadTier:
    """Bounded host-RAM pool of swapped-out KV blocks, keyed by the same
    chained content hash the device prefix cache uses."""

    def __init__(self, capacity_blocks: int, block_size: int,
                 pending_depth: int = 2):
        self.capacity = max(0, int(capacity_blocks))
        self.block_size = int(block_size)
        self.pending_depth = max(0, int(pending_depth))
        # key -> {"tokens": tuple, "data": {leaf: host tensor}, "crc": {..}}
        self._entries: "OrderedDict[int, Dict]" = OrderedDict()
        # key -> (tokens, _Capture): swap-outs whose D2H is enqueued but
        # not yet waited on (the double buffer)
        self._pending: "OrderedDict[int, Tuple[tuple, _Capture]]" = \
            OrderedDict()
        self.swap_outs = 0        # blocks accepted into the tier
        self.swap_ins = 0         # blocks restored to device by admit()
        self.tier_hits = 0        # verified take() hits
        self.tier_misses = 0      # take() for an absent key
        self.corrupt_drops = 0    # entries dropped on checksum/token mismatch
        self.tier_evictions = 0   # entries dropped by the capacity bound
        # fleet cache directory invalidation: called with the key of EVERY
        # entry that leaves the tier without re-registering on device in
        # the same operation (capacity eviction, discard, corrupt drop,
        # verified take — the take's device re-registration re-adds the
        # key right after). None = no listener.
        self.on_drop = None

    def _dropped(self, key: int) -> None:
        if self.on_drop is not None:
            self.on_drop(key)

    # -- capacity -----------------------------------------------------------

    @property
    def blocks(self) -> int:
        """Blocks currently host-resident (materialized + pending)."""
        return len(self._entries) + len(self._pending)

    def keys(self):
        """Every key the tier currently holds (materialized + pending)."""
        yield from self._entries
        yield from self._pending

    def _evict_to(self, bound: int) -> None:
        while self.blocks > bound:
            if self._pending:   # oldest swap-out first (it is the LRU-est)
                k, (_, cap) = self._pending.popitem(last=False)
                cap.wait()      # its pinned buffers may still be written
            else:
                k, _ = self._entries.popitem(last=False)
            self.tier_evictions += 1
            self._dropped(k)

    def resize(self, capacity_blocks: int) -> None:
        """Shrink/grow the bound live; excess entries fall back to the
        recompute path."""
        self.capacity = max(0, int(capacity_blocks))
        self._evict_to(self.capacity)

    # -- swap-out -----------------------------------------------------------

    def put(self, key: int, tokens: tuple, capture) -> None:
        """Accept a dying block: ``capture`` holds the per-leaf host
        buffers its copy is enqueued into (``PagedKVCache.read_block``),
        or is a plain ``{leaf: host tensor}`` dict. Materialization is
        deferred (see the module docstring)."""
        if not isinstance(capture, _Capture):
            capture = _Capture({n: torch.as_tensor(a)
                                for n, a in capture.items()})
        if self.capacity <= 0:
            capture.wait()
            return
        self._entries.pop(key, None)      # re-offload supersedes
        old = self._pending.pop(key, None)
        if old is not None:
            old[1].wait()
        self._pending[key] = (tuple(tokens), capture)
        self.swap_outs += 1
        while len(self._pending) > self.pending_depth:
            k, (toks, cap) = self._pending.popitem(last=False)
            self._materialize(k, toks, cap)
        self._evict_to(self.capacity)

    def _materialize(self, key: int, tokens: tuple, cap: _Capture) -> None:
        data = cap.wait()
        self._entries[key] = {"tokens": tokens, "data": data,
                              "crc": {n: block_crc(a)
                                      for n, a in data.items()}}

    def _settle(self, key: int) -> None:
        """Materialize ``key`` when it is still pending (lookup path)."""
        if key in self._pending:
            toks, cap = self._pending.pop(key)
            self._materialize(key, toks, cap)

    def flush(self) -> None:
        """Materialize every pending swap-out (quiesce / audit barrier)."""
        while self._pending:
            k, (toks, cap) = self._pending.popitem(last=False)
            self._materialize(k, toks, cap)

    def holds(self, key: int) -> bool:
        """Whether the tier currently holds ``key`` (materialized or
        pending)."""
        return key in self._entries or key in self._pending

    def discard(self, key: int) -> None:
        """Drop any host copy of ``key`` — called when the key registers
        on device again (the device copy becomes the authoritative one)."""
        had = self._entries.pop(key, None) is not None
        old = self._pending.pop(key, None)
        if old is not None:
            old[1].wait()
        if had or old is not None:
            self._dropped(key)

    # -- swap-in ------------------------------------------------------------

    def _verified(self, e: Dict, tokens) -> bool:
        if e["tokens"] != tuple(int(t) for t in tokens):
            return False
        return all(block_crc(a) == e["crc"][n] for n, a in e["data"].items())

    def take(self, key: int, tokens) -> Optional[Dict[str, torch.Tensor]]:
        """Verified move-out: the block's host tensors iff the key is
        present, the stored token ids match ``tokens`` exactly, and every
        leaf's write-time checksum still verifies; the entry is removed on
        success (device becomes the resident tier). Any mismatch drops the
        entry and returns None — a MISS, so the caller recomputes."""
        self._settle(key)
        e = self._entries.get(key)
        if e is None:
            self.tier_misses += 1
            return None
        del self._entries[key]
        if not self._verified(e, tokens):
            self.corrupt_drops += 1
            self.tier_misses += 1
            self._dropped(key)
            return None
        self.tier_hits += 1
        self._dropped(key)   # the caller registers it on device right away
        return e["data"]

    def peek(self, key: int, tokens) -> Optional[Dict[str, torch.Tensor]]:
        """Verified NON-destructive read: the block's host tensors iff the
        key is present and tokens + every checksum verify, else None; the
        entry stays put either way and no counter moves. The tensors are
        the tier's own buffers: a caller that keeps them past the tier's
        next operation (a cross-replica chain export) copies them."""
        self._settle(key)
        e = self._entries.get(key)
        if e is None or not self._verified(e, tokens):
            return None
        return e["data"]

    # -- introspection ------------------------------------------------------

    def stats(self) -> Dict[str, int]:
        return {"capacity": self.capacity, "blocks": self.blocks,
                "swap_outs": self.swap_outs, "swap_ins": self.swap_ins,
                "tier_hits": self.tier_hits, "tier_misses": self.tier_misses,
                "corrupt_drops": self.corrupt_drops,
                "tier_evictions": self.tier_evictions}

    def corrupt_one(self, seed: int = 0) -> Optional[int]:
        """Fault-injection hook: flip one byte in one stored leaf of a
        deterministic entry WITHOUT updating its checksum, so the next
        ``take()`` must detect it and degrade to a miss. Returns the
        corrupted key, or None when the tier is empty. Picks the same
        entry, leaf and byte as the reference for the same seed."""
        self.flush()
        if not self._entries:
            return None
        keys = list(self._entries)
        key = keys[seed % len(keys)]
        e = self._entries[key]
        name = sorted(e["data"])[seed % len(e["data"])]
        t = e["data"][name].clone()
        flat = t.reshape(-1).view(torch.uint8)
        flat[seed % flat.numel()] ^= 0xFF
        e["data"][name] = t
        return key

"""Fleet-wide KV cache directory: one cache over N replica pools.

Counterpart of ``paddle_tpu/inference/serving/directory.py``
(``CacheDirectory``), pure host logic with the same contract. Each
replica's prefix cache — device pool + host offload tier — is an island:
a chain cached on replica A is a full recompute on replica B.
:class:`CacheDirectory` is the router-side index that breaks the islands:
it tracks, per chained prefix key (the
:func:`~.paged_cache.prefix_block_chain` content hash — equal keys imply
equal whole block-aligned prefixes), WHICH replicas currently hold the
key, fed by the :class:`~.paged_cache.BlockManager` registration
callbacks (``notify_register`` / ``notify_unregister``) and the
:class:`~.offload.HostOffloadTier` drop callback (``on_drop``) the router
wires into every replica it spawns.

Correctness stance — the directory is ADVISORY, never authoritative:

* An entry can be **stale-missing** (the holder evicted between the
  lookup and the pull) — the pull exports zero blocks and the submit
  degrades to plain recompute.
* An entry can never be **stale-authoritative**: every path that removes
  a key from a replica (LRU eviction, tenant-quota recycle, tier
  eviction/corrupt-drop/discard, supervisor crash rebuild, rolling
  restart, scale-in removal) drops the directory entry through the wired
  callbacks or :meth:`drop_replica` — and even if one slipped through,
  the pull re-verifies tokens + per-leaf checksums on the holder AND the
  graft re-verifies the checksums on the target, so the worst stale
  outcome is a recompute, never wrong KV.

Bounded (hostile traffic minting fresh prefixes must not grow host memory
without bound): oldest-inserted keys evict first once ``max_entries`` is
reached.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

__all__ = ["CacheDirectory"]


class CacheDirectory:
    """Chain-key -> holder-replica index with longest-prefix lookup.

    Thread-safe on its own lock: the registration callbacks fire from
    inside engine steps (under engine/supervisor locks) while lookups
    come from the router's submit path — the directory must not require
    the router lock for either."""

    def __init__(self, max_entries: int = 65536):
        self.max_entries = int(max_entries)
        self._lock = threading.Lock()
        # key -> holder rids; OrderedDict so the bound evicts the
        # oldest-inserted key first (same philosophy as MAX_AFFINITY)
        self._holders: "OrderedDict[int, Set[int]]" = OrderedDict()
        self._by_rid: Dict[int, Set[int]] = {}       # rid -> its keys
        self.adds = 0            # (key, rid) registrations observed
        self.drops = 0           # (key, rid) invalidations observed
        self.evicted = 0         # keys squeezed out by the entry bound

    # ---- mutation (wired callbacks + fleet membership) --------------------

    def add(self, rid: int, key: int) -> None:
        with self._lock:
            holders = self._holders.get(key)
            if holders is None:
                holders = self._holders[key] = set()
            if rid in holders:
                return
            holders.add(rid)
            self._by_rid.setdefault(rid, set()).add(key)
            self.adds += 1
            while len(self._holders) > self.max_entries:
                k, hs = self._holders.popitem(last=False)
                for r in hs:
                    self._by_rid[r].discard(k)
                self.evicted += 1

    def drop(self, rid: int, key: int) -> None:
        with self._lock:
            holders = self._holders.get(key)
            if holders is None or rid not in holders:
                return
            holders.discard(rid)
            self._by_rid.get(rid, set()).discard(key)
            if not holders:
                del self._holders[key]
            self.drops += 1

    def drop_replica(self, rid: int) -> int:
        """Invalidate every entry naming ``rid`` — scale-in removal,
        rolling-restart rebuild, supervisor crash recovery (the rebuilt
        engine starts with an empty pool; its keys died with it).
        Returns how many entries were dropped."""
        with self._lock:
            keys = self._by_rid.pop(rid, set())
            for k in keys:
                holders = self._holders.get(k)
                if holders is None:
                    continue
                holders.discard(rid)
                if not holders:
                    del self._holders[k]
            self.drops += len(keys)
            return len(keys)

    # ---- lookup -----------------------------------------------------------

    def longest(self, keys: Sequence[int]) -> Tuple[Optional[int], int]:
        """The replica holding the LONGEST contiguous prefix of the
        chain ``keys`` (in chain order) and how many leading keys it
        holds: ``(rid, depth)``, or ``(None, 0)`` when no replica holds
        even the first key. Contiguity matters — a replica holding only
        a middle block can't seed admit()'s pin-as-we-go walk. Ties
        break to the smallest rid (deterministic routing under a seeded
        replay)."""
        with self._lock:
            alive: Optional[Set[int]] = None
            best_rid: Optional[int] = None
            best_depth = 0
            for depth, key in enumerate(keys, start=1):
                holders = self._holders.get(key)
                if alive is None:
                    alive = set(holders) if holders else set()
                else:
                    alive &= holders if holders else set()
                if not alive:
                    break
                best_rid, best_depth = min(alive), depth
            return best_rid, best_depth

    def holders(self, key: int) -> List[int]:
        with self._lock:
            return sorted(self._holders.get(key, ()))

    # ---- introspection ----------------------------------------------------

    @property
    def entries(self) -> int:
        with self._lock:
            return len(self._holders)

    def replica_keys(self, rid: int) -> int:
        with self._lock:
            return len(self._by_rid.get(rid, ()))

    def items(self) -> List[Tuple[int, List[int]]]:
        """A consistent copy of every (key, holder rids) pair — the
        auditor's ``directory_coherence`` walk."""
        with self._lock:
            return [(k, sorted(v)) for k, v in self._holders.items()]

    def check_consistency(self) -> List[str]:
        """Internal structural invariants (the cheap half of the
        ``directory_coherence`` audit): forward and reverse maps agree,
        no empty holder sets, size within the bound. Returns violation
        strings (empty = coherent)."""
        with self._lock:
            out = []
            if len(self._holders) > self.max_entries:
                out.append(f"directory holds {len(self._holders)} keys, "
                           f"bound {self.max_entries}")
            for k, hs in self._holders.items():
                if not hs:
                    out.append(f"key {k} has an empty holder set")
                for r in hs:
                    if k not in self._by_rid.get(r, ()):
                        out.append(f"key {k} names rid {r} but the "
                                   f"reverse map disagrees")
            for r, ks in self._by_rid.items():
                for k in ks:
                    if r not in self._holders.get(k, ()):
                        out.append(f"reverse map has (rid {r}, key {k}) "
                                   f"missing from the forward map")
            return out

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return {"entries": len(self._holders),
                    "adds": self.adds, "drops": self.drops,
                    "evicted": self.evicted}

"""Multi-adapter LoRA serving: registry + device-resident adapter pool.

Counterpart of ``paddle_tpu/models/lora.py``. Many per-customer LoRA
fine-tunes share one base model on one card (the S-LoRA / Punica shape):
a fine-tune costs its adapter weights (two rank-r factors per attention
projection per layer), not a replica.

* **One stacked pool.** Every registered adapter's A/B factors live at a
  fixed rank ``r`` in a stacked fp32 pool ``[L, slots + 1, ...]`` on the
  engine's device (:class:`AdapterPool`). Each serving dispatch carries a
  per-row adapter slot id, and the layer body adds the gathered batched
  adapter matmul ``(x @ A[ids]) @ B[ids]`` to the q/k/v/o projections
  (:func:`lora_delta`; the paged entry points gather the factors once
  per dispatch, :func:`gather_adapters`). The pool's tensors are
  allocated once and a load writes a slot IN PLACE, so adapter churn
  never moves the pool's storage
  (the JAX package's "churn never recompiles"; storage that never moves
  is also what a captured CUDA graph over a decode iteration needs).
* **Slot 0 is the zeroed BASE adapter.** Requests without an adapter
  gather all-zero factors and add an exact ``+0.0``, so base traffic
  through a LoRA engine gives the LoRA-less engine's token streams bit
  for bit.
* **Host LRU tier.** Cold adapters live in a host registry (numpy copies
  with a crc32 per leaf, checked at registration and again at every
  load, so a corrupted host copy is a structured error, never wrong
  weights). The pool LRU-evicts the coldest UNPINNED resident adapter to
  make room; running requests pin theirs.

The merged-dense oracle (:func:`merge_lora`) folds ``W + A @ B`` into a
plain parameter dict so the LoRA-less engine reproduces an adapter's
greedy stream.
* **Tensor parallelism** (``AdapterPool(devices=)``, the reference's
  ``lora_pool_specs``): ``qB``/``kB``/``vB`` are cut on their output axis
  like the projections they add into, one tuple entry per shard device;
  the other factors stay on the lead device.
"""

from __future__ import annotations

import zlib
from collections import OrderedDict
from typing import Dict, List, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..distributed.sharding import shard_dim_spec
from .llama import LlamaConfig

__all__ = ["AdapterPool", "lora_param_shapes", "lora_init_params",
           "lora_delta", "gather_adapters", "gathered_delta", "merge_lora"]


# the four attention projections LoRA targets: (weight leaf, A leaf, B leaf)
_TARGETS = (("wq", "qA", "qB"), ("wk", "kA", "kB"),
            ("wv", "vA", "vB"), ("wo", "oA", "oB"))
# the pool leaves tensor parallelism cuts on their output axis
_SHARDED = ("qB", "kB", "vB")


def _crc(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).tobytes())


def lora_param_shapes(cfg: LlamaConfig, rank: int) -> Dict[str, tuple]:
    """Per-adapter factor shapes (leading L = stacked layers): ``A`` maps
    the projection input to rank ``r``, ``B`` maps rank ``r`` to the
    projection output, matching ``wq [L, E, H*D]``, ``wk``/``wv [L, E,
    Hk*D]`` and ``wo [L, H*D, E]``."""
    L, E = cfg.num_hidden_layers, cfg.hidden_size
    H, Hk, D = cfg.num_attention_heads, cfg.kv_heads, cfg.head_dim
    r = int(rank)
    return {"qA": (L, E, r), "qB": (L, r, H * D),
            "kA": (L, E, r), "kB": (L, r, Hk * D),
            "vA": (L, E, r), "vB": (L, r, Hk * D),
            "oA": (L, H * D, r), "oB": (L, r, E)}


def lora_init_params(cfg: LlamaConfig, rank: int, seed: int = 0,
                     scale: float = 0.05) -> Dict[str, np.ndarray]:
    """A random host-side adapter, both factors nonzero (a zero ``B``
    would equal the base adapter). fp32 numpy from ``default_rng(seed)``:
    the JAX package's arrays for the same seed."""
    rng = np.random.default_rng(seed)
    return {n: (rng.standard_normal(s) * scale).astype(np.float32)
            for n, s in lora_param_shapes(cfg, rank).items()}


def gather_adapters(layers: Dict[str, torch.Tensor], ids,
                    dt) -> Dict[str, torch.Tensor]:
    """Every pool leaf ``[L, slots + 1, ...]`` gathered at the rows' slots
    ``ids [B]`` and cast to the compute dtype: ``[L, B, ...]``. The ids
    are the same for every layer of a dispatch, so one gather (and cast)
    per leaf serves all layers; a cast commutes with a gather, so layer
    ``l`` of the result equals the JAX package's per-layer
    ``take(la, ids).astype(dt)``."""
    idx = ids.long()
    return {name: (tuple(t[:, idx.to(t.device)].to(dt) for t in leaf)
                   if isinstance(leaf, tuple) else leaf[:, idx].to(dt))
            for name, leaf in layers.items()}


def gathered_delta(x, a, b):
    """The batched adapter matmul of one projection on factors already
    gathered (:func:`gather_adapters`): ``(x @ a) @ b`` with ``x [B, T,
    in]``, ``a [B, in, r]`` and ``b [B, r, out]``, both products in the
    factors' dtype. Returns the ``[B, T, out]`` delta; slot 0's zeroed
    factors make it an exact ``+0.0`` for base rows."""
    t = torch.bmm(x.to(a.dtype), a)
    return torch.bmm(t, b)


def lora_delta(x, la, lb, ids, dt):
    """The JAX package's ``lora_delta``: ``(x @ A[ids]) @ B[ids]`` with
    one layer's pool slices ``la [slots, in, r]`` / ``lb [slots, r,
    out]`` and ``ids [B]``, the factors gathered and cast to ``dt``
    first. The paged entry points gather once per dispatch instead and
    call :func:`gathered_delta` per layer."""
    idx = ids.long()
    return gathered_delta(x, la[idx].to(dt), lb[idx].to(dt))


def merge_lora(params: Dict, lora_params: Dict[str, np.ndarray]) -> Dict:
    """The dense oracle: a copy of the stacked params with one adapter
    folded in (``W += A @ B`` per projection per layer, in fp32, cast back
    to the weight's dtype). fp params only: the int8 engine quantizes the
    BASE weights and adds the fp delta outside the quantized matmul."""
    layers = dict(params["layers"])
    for wname, aname, bname in _TARGETS:
        w = layers[wname]
        a = torch.as_tensor(np.asarray(lora_params[aname], np.float32),
                            device=w.device)
        b = torch.as_tensor(np.asarray(lora_params[bname], np.float32),
                            device=w.device)
        layers[wname] = (w.to(torch.float32)
                         + torch.einsum("lir,lro->lio", a, b)).to(w.dtype)
    out = dict(params)
    out["layers"] = layers
    return out


class AdapterPool:
    """Device-resident adapter pool + host LRU registry.

    ``slots`` device rows hold loaded adapters (slot 0, the zeroed base
    adapter, comes on top); up to ``capacity`` adapters may be registered
    host-side in total. ``acquire`` pins an adapter resident (loading it
    over the LRU unpinned victim if cold) and ``release`` unpins it; a
    fully pinned pool makes ``acquire`` return None, and the scheduler's
    admission gate skips that request for this step.
    """

    def __init__(self, cfg: LlamaConfig, rank: int, slots: int,
                 capacity: int, device=None, devices=None):
        rank, slots, capacity = int(rank), int(slots), int(capacity)
        if rank < 1:
            raise ValueError(
                f"FLAGS_serving_lora_rank must be >= 1, got {rank}")
        if slots < 1:
            raise ValueError(
                f"AdapterPool needs FLAGS_serving_lora_slots >= 1 device "
                f"slots, got {slots} (0 disables multi-adapter serving "
                f"at the engine, not here)")
        if capacity < slots:
            raise ValueError(
                f"FLAGS_serving_lora_pool ({capacity}) must be >= "
                f"FLAGS_serving_lora_slots ({slots}): the host registry "
                f"backs every resident adapter")
        self.cfg, self.rank = cfg, rank
        self.num_slots = slots          # loadable slots (1..slots)
        self.capacity = capacity
        self.device = resolve_device(device if devices is None
                                     else devices[0])
        self._shapes = lora_param_shapes(cfg, rank)
        # stacked [L, slots+1, ...] pool; row 0 = the zeroed base adapter.
        # Allocated once: loads write a slot in place. Under tensor
        # parallelism the B factors of q/k/v are a tuple of column shards
        self.layers = {}
        for n, s in self._shapes.items():
            shape = (s[0], slots + 1) + s[1:]
            if devices is not None and len(devices) > 1 and \
                    n in _SHARDED:
                tp = len(devices)
                shard_dim_spec(shape, tp, "tp", dim=-1,
                               name=f"lora_pool.{n}")
                self.layers[n] = tuple(
                    torch.zeros(shape[:-1] + (shape[-1] // tp,),
                                dtype=torch.float32, device=d)
                    for d in devices)
            else:
                self.layers[n] = torch.zeros(shape, dtype=torch.float32,
                                             device=self.device)
        # host registry: name -> {"data": {leaf: np}, "crc": {leaf: int}}
        self._host: "OrderedDict[str, Dict]" = OrderedDict()
        self._resident: Dict[str, int] = {}       # name -> slot (1-based)
        self._slot_name: List[Optional[str]] = [None] * (slots + 1)
        self._pins: Dict[str, int] = {}           # name -> pin count
        self._lru: "OrderedDict[str, None]" = OrderedDict()  # resident LRU
        self.loads = 0                 # host-to-device uploads
        self.evictions = 0

    # ---- registry ---------------------------------------------------------

    def register(self, name: str, params: Dict[str, np.ndarray]) -> None:
        """Accept one adapter into the host registry (checksummed copy).
        Shape/rank mismatches and a full registry are structured errors."""
        if not isinstance(name, str) or not name:
            raise ValueError(f"adapter name must be a non-empty string, "
                             f"got {name!r}")
        if name not in self._host and len(self._host) >= self.capacity:
            raise ValueError(
                f"adapter registry full ({self.capacity} adapters): "
                f"cannot register {name!r}; raise FLAGS_serving_lora_pool "
                f"or deregister a cold adapter")
        missing = set(self._shapes) - set(params)
        if missing:
            raise ValueError(f"adapter {name!r} is missing factor leaves "
                             f"{sorted(missing)}; expected "
                             f"{sorted(self._shapes)}")
        data = {}
        for leaf, shape in self._shapes.items():
            arr = np.asarray(params[leaf], np.float32)
            if arr.shape != shape:
                raise ValueError(
                    f"adapter {name!r} leaf {leaf!r} has shape "
                    f"{arr.shape}, expected {shape} (rank "
                    f"FLAGS_serving_lora_rank={self.rank} over "
                    f"{self._shapes['qA'][0]} layers)")
            # a real copy: the registry owns its bytes
            data[leaf] = np.array(arr, np.float32, order="C", copy=True)
        if name in self._resident:
            # re-registration of a resident adapter replaces its bytes:
            # drop residency so the next acquire uploads the new factors
            if self._pins.get(name, 0):
                raise ValueError(
                    f"adapter {name!r} is pinned by running requests; "
                    f"cannot replace its weights mid-stream")
            self._evict(name)
        self._host[name] = {"data": data,
                            "crc": {n: _crc(a) for n, a in data.items()}}

    def is_registered(self, name: str) -> bool:
        return name in self._host

    def registered(self) -> List[str]:
        return list(self._host)

    # ---- residency --------------------------------------------------------

    def acquire(self, name: str) -> Optional[int]:
        """Pin ``name`` resident and return its slot; None when every
        slot is pinned by other adapters. A cold acquire verifies the host
        copy's checksums and writes it into the freed slot in place (one
        ``adapter_loads`` tick)."""
        if name not in self._host:
            raise KeyError(f"adapter {name!r} is not registered")
        slot = self._resident.get(name)
        if slot is None:
            slot = self._free_slot()
            if slot is None:
                return None
            entry = self._host[name]
            for leaf, arr in entry["data"].items():
                if _crc(arr) != entry["crc"][leaf]:
                    raise RuntimeError(
                        f"adapter {name!r} leaf {leaf!r} failed its "
                        f"load-time checksum: host copy corrupted; "
                        f"refusing to serve wrong weights")
            for leaf, arr in entry["data"].items():
                dst = self.layers[leaf]
                if isinstance(dst, tuple):
                    for t, part in zip(dst, np.split(arr, len(dst), -1)):
                        t[:, slot].copy_(torch.from_numpy(part))
                else:
                    dst[:, slot].copy_(torch.from_numpy(arr))
            self._resident[name] = slot
            self._slot_name[slot] = name
            self.loads += 1
        self._pins[name] = self._pins.get(name, 0) + 1
        self._lru.pop(name, None)
        self._lru[name] = None                      # most recently used
        return slot

    def release(self, name: str) -> None:
        """Drop one pin; the adapter stays resident until the LRU needs
        its slot."""
        n = self._pins.get(name, 0)
        if n <= 1:
            self._pins.pop(name, None)
        else:
            self._pins[name] = n - 1

    def _free_slot(self) -> Optional[int]:
        for s in range(1, self.num_slots + 1):
            if self._slot_name[s] is None:
                return s
        for victim in self._lru:                    # oldest first
            if not self._pins.get(victim, 0):
                slot = self._resident[victim]
                self._evict(victim)
                self.evictions += 1
                return slot
        return None

    def _evict(self, name: str) -> None:
        slot = self._resident.pop(name)
        self._slot_name[slot] = None
        self._lru.pop(name, None)
        self._pins.pop(name, None)

    def resident(self) -> Dict[str, int]:
        return dict(self._resident)

    def evicted(self) -> List[str]:
        return [n for n in self._host if n not in self._resident]

    def pinned(self) -> Dict[str, int]:
        return dict(self._pins)

    def slot_of(self, name: str) -> Optional[int]:
        return self._resident.get(name)

    # ---- observability + chaos --------------------------------------------

    def stats(self) -> Dict[str, int]:
        return {"adapters_registered": len(self._host),
                "adapters_resident": len(self._resident),
                "adapter_loads": self.loads,
                "adapter_evictions": self.evictions,
                "adapter_pins": sum(self._pins.values())}

    def snapshot(self) -> Dict:
        out = self.stats()
        out["rank"] = self.rank
        out["slots"] = self.num_slots
        out["resident"] = sorted(self._resident)
        return out

    def corrupt_one(self) -> Optional[str]:
        """Chaos hook: flip one byte of one COLD adapter's host copy; the
        next acquire of it fails its load-time checksum. Returns the
        adapter corrupted, or None when every registered adapter is
        resident."""
        for name in self._host:
            if name in self._resident:
                continue
            leaf = next(iter(self._shapes))
            buf = self._host[name]["data"][leaf]
            buf.view(np.uint8).reshape(-1)[0] ^= 0xFF
            return name
        return None

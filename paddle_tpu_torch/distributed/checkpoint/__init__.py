"""Distributed checkpoint: sharded save + reshard-on-load — counterpart
of ``paddle_tpu/distributed/checkpoint/__init__.py``.

The same directory layout, so either package loads the other's saves:
``metadata.pkl`` (name -> ``{"kind": "array", "shape", "dtype",
"shards": [{"file", "index"}]}`` or ``{"kind": "object", "value"}``),
``data_<rank>.pkl`` (name -> ``[(index, numpy array)]``),
``meta_<rank>.pkl`` (the rank's shard records), ``manifest_<rank>.json``
and the ``COMMITTED`` marker, an index being a tuple of ``(start, stop,
step)`` per dimension.

* Rank and world come from ``torch.distributed`` when it is initialised,
  else 0 and 1. A tensor lives on one device, so it is ONE shard covering
  it (recorded as the JAX package records a single-device array:
  ``(0, None, 1)`` per dimension).
* ``load_state_dict`` builds each tensor from whatever shard layout the
  files hold — a JAX save over an 8-device mesh loads too — and fills the
  destination IN PLACE (``dst.copy_``), keeping the destination's device
  and dtype: the port's reshard-on-load.
* bf16, without ``ml_dtypes``: the port writes a bf16 tensor's payload as
  its float32 values (exact) under entry dtype ``"bfloat16"``; the JAX
  package's ``_assemble`` casts them into its bf16 output exactly, and
  both packages read the port's files bit-exactly. A JAX payload holds
  ``ml_dtypes.bfloat16`` arrays; the port reads their bits
  (``framework.io.unpickle``).

Fault tolerance (docs/FAULT_TOLERANCE.md), as in the reference: every
file is written to a temp file, fsynced and renamed; each rank records
per-file SHA-256 in ``manifest_<rank>.json`` (taken while the file
streams to disk, not by reading it back) and the coordinator drops
``COMMITTED`` LAST; ``load_state_dict`` verifies committed checkpoints
(``FLAGS_checkpoint_verify``) and raises
:class:`CheckpointCorruptionError` instead of unpickling garbage;
``save_state_dict(..., async_save=True)`` copies the tensors to host
memory NOW and runs all pickling, hashing and file I/O on the shared
background writer; :class:`AsyncCheckpointer` (``async_save.py``)
manages a ``step_<n>`` series with keep-last-K retention and last-good
``restore()``.
"""

from __future__ import annotations

import os
import pickle
import sys
from typing import Any, Dict, Optional

import numpy as np
import torch

from ...framework.async_writer import default_writer
from ...framework.integrity import (CheckpointCorruptionError, atomic_stream,
                                    verify_enabled)
from ...framework.io import from_host, to_host, unpickle
from . import manifest
from .manifest import (latest_committed, list_checkpoints, prune_uncommitted,
                       retain_last_k)

__all__ = ["save_state_dict", "load_state_dict", "load_latest", "wait",
           "is_saving", "state_dict_set", "AsyncCheckpointer",
           "CheckpointCorruptionError", "manifest", "latest_committed",
           "list_checkpoints", "prune_uncommitted", "retain_last_k"]

_META = "metadata.pkl"


def _flatten(d: Dict, prefix: str = "") -> Dict[str, Any]:
    flat = {}
    for k, v in d.items():
        key = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, dict):
            flat.update(_flatten(v, key))
        else:
            flat[key] = v
    return flat


def rank_and_world():
    """``(rank, world)`` from ``torch.distributed`` when it is initialised,
    else ``(0, 1)``."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _collect(state_dict: Dict, rank: int):
    """Copy every tensor to HOST memory (the synchronous part of a save:
    after this returns the train step may overwrite the tensors in place)
    and build the metadata records."""
    meta: Dict[str, Dict] = {}
    payload: Dict[str, list] = {}
    for name, v in _flatten(state_dict).items():
        if isinstance(v, torch.Tensor):
            host = to_host(v)                      # device -> host copy
            dtype = ("bfloat16" if v.dtype == torch.bfloat16
                     else str(host.dtype))
        elif isinstance(v, np.ndarray):
            host = np.array(v, copy=True)
            dtype = str(host.dtype)
        else:                                      # python scalar / misc
            meta[name] = {"kind": "object", "value": v}
            continue
        idx = tuple((0, None, 1) for _ in host.shape)
        meta[name] = {"kind": "array", "shape": tuple(host.shape),
                      "dtype": dtype,
                      "shards": [{"file": f"data_{rank}.pkl", "index": idx}]}
        payload[name] = [(idx, host)]
    return meta, payload


def _write_files(path: str, rank: int, meta: Dict, payload: Dict,
                 coordinator: bool, world: int = 1) -> None:
    """The file-I/O half of a save (runs on the background writer when
    async). Protocol: invalidate the marker, write data -> per-rank
    manifest -> (coordinator) global metadata -> COMMITTED; every file
    tmp+fsync+rename and hashed while it streams to disk."""
    os.makedirs(path, exist_ok=True)
    if coordinator:
        try:  # a re-save into the same dir is uncommitted until it finishes
            os.remove(os.path.join(path, manifest.COMMITTED_MARKER))
        except OSError:
            pass
    digests: Dict[str, str] = {}

    def _atomic_dump(obj, fname):
        with atomic_stream(os.path.join(path, fname)) as w:
            pickle.dump(obj, w, protocol=pickle.HIGHEST_PROTOCOL)
        digests[fname] = w.sha.hexdigest()

    _atomic_dump(payload, f"data_{rank}.pkl")
    rank_records = {name: e["shards"] for name, e in meta.items()
                    if e.get("kind") == "array"}
    _atomic_dump(rank_records, f"meta_{rank}.pkl")
    rank_files = [f"data_{rank}.pkl", f"meta_{rank}.pkl"]
    if coordinator:
        _atomic_dump(meta, _META)
        rank_files.append(_META)
    manifest.write_manifest(path, rank_files, rank=rank, digests=digests)
    if coordinator:
        # "world" scopes the commit: a same-dir re-save from fewer ranks
        # leaves stale higher-rank files that readers must not union in
        manifest.mark_committed(path, extra={"rank_files": rank_files,
                                             "world": int(world)})


def save_state_dict(state_dict: Dict, path: str, process_group=None,
                    coordinator_rank: int = 0, unique_id=None,
                    async_save: bool = False):
    """Write ``state_dict`` (nested dicts of tensors / numpy arrays /
    scalars) as a checkpoint directory with per-file SHA-256 manifests and
    a commit marker.

    With ``async_save=True`` the device->host copy happens NOW and all
    file I/O runs on the shared background writer thread; returns the
    pending job — call :func:`wait` (or ``job.wait()``) before relying on
    the checkpoint."""
    rank, world = rank_and_world()
    meta, payload = _collect(state_dict, rank)
    coordinator = rank == coordinator_rank
    if async_save:
        return default_writer().submit(
            lambda: _write_files(path, rank, meta, payload, coordinator,
                                 world),
            label=path)
    _write_files(path, rank, meta, payload, coordinator, world)
    return None


def wait(timeout: Optional[float] = None) -> None:
    """Drain every pending async checkpoint write; re-raises the first
    background-writer error (a failed async save must never be silent)."""
    default_writer().wait_all(timeout)


def is_saving() -> bool:
    """True while an async checkpoint write is still in flight."""
    return default_writer().busy


def _values(data: np.ndarray, bf16: bool) -> np.ndarray:
    """A payload array as the values to assemble: a JAX bf16 payload
    (2-byte void, raw bits) as its exact float32 values."""
    if bf16 and data.dtype.kind == "V":
        return (data.view(np.uint16).astype(np.uint32) << 16).view(
            np.float32)
    return data


def _covers(idx: tuple, shape: tuple) -> bool:
    return all(a == 0 and b in (None, n) and c == 1
               for (a, b, c), n in zip(idx, shape))


def _assemble(entry: Dict, files: Dict[str, Dict], name: str) -> np.ndarray:
    """The logical array of ``name`` from its shard records (bf16 as its
    float32 values)."""
    shape = tuple(entry["shape"])
    bf16 = entry["dtype"] == "bfloat16"
    recs = [(rec["index"], data) for rec in entry["shards"]
            for idx, data in files[rec["file"]].get(name, ())
            if idx == rec["index"]]
    for idx, data in recs:
        if _covers(idx, shape):                  # one shard holds it all
            return _values(np.asarray(data), bf16).reshape(shape)
    out = np.empty(shape, np.float32 if bf16 else np.dtype(entry["dtype"]))
    filled = np.zeros(shape, bool) if shape else None
    for idx, data in recs:
        sl = tuple(slice(a, b, c) for a, b, c in idx)
        out[sl] = _values(np.asarray(data), bf16)
        if filled is not None:
            filled[sl] = True
    if (filled is not None and not filled.all()) or (
            filled is None and not recs):
        missing = int((~filled).sum()) if filled is not None else 1
        raise CheckpointCorruptionError(
            f"checkpoint shard coverage incomplete for {name!r} — missing "
            f"{missing} elements (corrupt or partial save)")
    return out


def _load_pickle(path: str):
    with open(path, "rb") as f:
        return unpickle(f)


def load_state_dict(state_dict: Dict, path: str, process_group=None,
                    coordinator_rank: int = 0, unique_id=None,
                    offload: bool = False,
                    verify: Optional[bool] = None) -> None:
    """Fill ``state_dict``'s tensors IN PLACE from the checkpoint at
    ``path``: each tensor is assembled from the shards the files hold and
    copied into the destination (``dst.copy_``), which keeps its device
    and dtype — the saving topology may differ from this one.

    Integrity: committed checkpoints (COMMITTED marker present) are
    checksum-verified before any unpickling (``verify=None`` follows
    ``FLAGS_checkpoint_verify``); corruption raises
    :class:`CheckpointCorruptionError` — use :func:`load_latest` /
    :meth:`AsyncCheckpointer.restore` to fall back to last-good instead.
    Marker-less directories load tolerantly, as in the reference."""
    if verify is None:
        verify = verify_enabled()
    if verify and manifest.is_committed(path):
        manifest.verify(path)
    # scope reads to the committed world (stale higher-rank files of an
    # earlier larger-world save into the same dir must not be unioned in)
    world = manifest.committed_world(path)
    meta = _load_pickle(os.path.join(path, _META))
    names = sorted(os.listdir(path))
    files: Dict[str, Dict] = {
        fname: _load_pickle(os.path.join(path, fname)) for fname in names
        if fname.startswith("data_") and fname.endswith(".pkl")
        and manifest.in_committed_world(fname, world)}
    # union per-rank shard records (the coordinator's metadata may list
    # only its own shards)
    for fname in names:
        if fname.startswith("meta_") and fname.endswith(".pkl") \
                and manifest.in_committed_world(fname, world):
            records = _load_pickle(os.path.join(path, fname))
            for name, recs in records.items():
                entry = meta.get(name)
                if entry is None or entry.get("kind") != "array":
                    continue
                seen_idx = {r["index"] for r in entry["shards"]}
                for r in recs:
                    if r["index"] not in seen_idx:
                        entry["shards"].append(r)
                        seen_idx.add(r["index"])

    flat = _flatten(state_dict)
    missing = [k for k in flat if k not in meta]
    if missing:
        raise KeyError(f"checkpoint at {path} lacks keys: {missing[:5]}"
                       f"{'...' if len(missing) > 5 else ''}")
    for name, dst in flat.items():
        entry = meta[name]
        if entry["kind"] == "object":
            continue  # scalars restored only via explicit assignment
        full = _assemble(entry, files, name)
        if tuple(full.shape) != tuple(dst.shape):
            raise ValueError(
                f"shape mismatch for {name!r}: checkpoint {full.shape} vs "
                f"destination {tuple(dst.shape)}")
        if isinstance(dst, torch.Tensor):
            with torch.no_grad():                  # reshard-on-load
                dst.copy_(from_host(full))
        else:
            # a raw array leaf cannot be filled in place; the caller gets
            # the loaded value through the dict
            state_dict_set(state_dict, name, full.astype(dst.dtype))


def load_latest(state_dict: Dict, root: str) -> Optional[int]:
    """Restore from the NEWEST committed checkpoint under ``root`` that
    passes verification, walking back to older committed checkpoints when
    the newest is corrupt (last-good auto-recovery). Returns the restored
    step, or None when no loadable checkpoint exists."""
    do_verify = verify_enabled()
    for step, path in reversed(list_checkpoints(root)):
        if not manifest.is_committed(path):
            continue
        try:
            if do_verify:
                manifest.verify(path)
            load_state_dict(state_dict, path, verify=False)
            return step
        except (CheckpointCorruptionError, pickle.UnpicklingError,
                EOFError) as e:
            # ONLY corruption-shaped failures walk back; environmental
            # errors propagate (restarting from scratch on those would
            # eventually GC the good checkpoints via retention)
            print(f"checkpoint: {path} unusable ({type(e).__name__}: "
                  f"{e}); falling back to an older committed checkpoint",
                  file=sys.stderr)
    return None


def state_dict_set(d: Dict, dotted: str, value) -> None:
    keys = dotted.split(".")
    for k in keys[:-1]:
        d = d[k]
    d[keys[-1]] = value


from .async_save import AsyncCheckpointer  # noqa: E402  (uses the above)

"""Checkpoint manifests, commit markers, and last-good selection —
counterpart of ``paddle_tpu/distributed/checkpoint/manifest.py``, the
same files and the same rules, so either package verifies, lists and
prunes the other's checkpoints.

The tier-3 sharded checkpoint directory has Orbax-style commit semantics
(docs/FAULT_TOLERANCE.md):

* every rank records the SHA-256 of each file it wrote in
  ``manifest_<rank>.json`` (written AFTER the data files, atomically);
* the coordinator drops a ``COMMITTED`` marker LAST — a directory without
  the marker is, by construction, a torn/in-flight save;
* :func:`verify` re-hashes every manifested file so a truncated or
  bit-flipped shard is detected before a single byte is unpickled;
* a checkpoint SERIES (one ``step_<n>`` subdir per save under a root)
  supports :func:`latest_committed` last-good selection,
  :func:`retain_last_k` retention (never GC'ing the last committed), and
  :func:`prune_uncommitted` cleanup that the elastic launcher runs between
  restart rounds.

The module imports no torch: the chaos harness uses it without a
backend.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import time
from typing import Dict, List, Optional

from ...framework.integrity import (CheckpointCorruptionError,
                                    atomic_write_bytes, fsync_dir,
                                    sha256_file)

__all__ = ["CheckpointCorruptionError", "COMMITTED_MARKER", "write_manifest",
           "mark_committed", "is_committed", "committed_world",
           "in_committed_world", "verify", "step_dir_name",
           "list_checkpoints", "latest_committed", "retain_last_k",
           "prune_uncommitted"]

COMMITTED_MARKER = "COMMITTED"
_MANIFEST_FMT = "manifest_{rank}.json"
_MANIFEST_RE = re.compile(r"^manifest_(\d+)\.json$")
_STEP_RE = re.compile(r"^step_(\d+)$")


def write_manifest(path: str, files: List[str], rank: int = 0,
                   digests: Optional[Dict[str, str]] = None) -> str:
    """Hash ``files`` (names relative to ``path``) and atomically write
    ``manifest_<rank>.json``. Call AFTER the data files are in place.
    ``digests`` maps a file name to the SHA-256 its writer took while
    streaming it to disk; such a file is not read again."""
    digests = digests or {}
    entries: Dict[str, Dict] = {}
    for fname in files:
        fp = os.path.join(path, fname)
        entries[fname] = {"sha256": digests.get(fname) or sha256_file(fp),
                          "bytes": os.path.getsize(fp)}
    blob = json.dumps({"format": 1, "rank": rank, "files": entries},
                      indent=0, sort_keys=True).encode()
    out = os.path.join(path, _MANIFEST_FMT.format(rank=rank))
    atomic_write_bytes(out, blob)
    return out


def mark_committed(path: str, extra: Optional[Dict] = None) -> None:
    """Drop the ``COMMITTED`` marker — the LAST write of a save. Readers
    treat marker-less directories as in-flight/torn."""
    info = {"format": 1, "time": time.time()}
    if extra:
        info.update(extra)
    atomic_write_bytes(os.path.join(path, COMMITTED_MARKER),
                       json.dumps(info).encode())
    fsync_dir(path)


def is_committed(path: str) -> bool:
    return os.path.exists(os.path.join(path, COMMITTED_MARKER))


def committed_world(path: str) -> Optional[int]:
    """Rank count recorded in the COMMITTED marker, or None for legacy /
    hand-built markers. When present it SCOPES the commit: files from ranks
    >= world are stale leftovers of an earlier larger-world save into the
    same directory and must be ignored by verify/load."""
    try:
        with open(os.path.join(path, COMMITTED_MARKER)) as f:
            info = json.load(f)
        w = info.get("world")
        return int(w) if w is not None else None
    except (OSError, ValueError, TypeError):
        return None


def _rank_of(fname: str) -> Optional[int]:
    m = re.match(r"^(?:data|meta)_(\d+)\.pkl$|^manifest_(\d+)\.json$", fname)
    if not m:
        return None
    return int(m.group(1) or m.group(2))


def in_committed_world(fname: str, world: Optional[int]) -> bool:
    """True when ``fname`` belongs to the committed save (rank < world, or
    not a per-rank file, or no world recorded)."""
    if world is None:
        return True
    r = _rank_of(fname)
    return r is None or r < world


def _manifests(path: str) -> List[str]:
    try:
        names = os.listdir(path)
    except OSError:
        return []
    return sorted(n for n in names if _MANIFEST_RE.match(n))


def verify(path: str, require_committed: bool = True) -> bool:
    """Re-hash every file recorded in every per-rank manifest.

    Returns True when fully verified; False when the directory carries no
    manifests at all (a legacy / foreign checkpoint — callers load it
    tolerantly). Raises :class:`CheckpointCorruptionError` on a missing
    commit marker (when required), a missing file, a size mismatch, or a
    digest mismatch."""
    manifests = _manifests(path)
    if not manifests:
        return False
    if require_committed and not is_committed(path):
        raise CheckpointCorruptionError(
            f"checkpoint {path!r} has no {COMMITTED_MARKER} marker — the "
            f"save never completed (torn write)")
    world = committed_world(path)
    manifests = [m for m in manifests if in_committed_world(m, world)]
    if world is not None and len(manifests) < world:
        raise CheckpointCorruptionError(
            f"checkpoint {path!r}: commit covers {world} rank(s) but only "
            f"{len(manifests)} manifest(s) present")
    for mname in manifests:
        try:
            with open(os.path.join(path, mname)) as f:
                man = json.load(f)
        except (OSError, ValueError) as e:
            raise CheckpointCorruptionError(
                f"checkpoint {path!r}: unreadable manifest {mname}: {e}")
        for fname, rec in man.get("files", {}).items():
            fp = os.path.join(path, fname)
            if not os.path.exists(fp):
                raise CheckpointCorruptionError(
                    f"checkpoint {path!r}: manifested file {fname} missing")
            size = os.path.getsize(fp)
            if size != rec["bytes"]:
                raise CheckpointCorruptionError(
                    f"checkpoint {path!r}: {fname} is {size} bytes, "
                    f"manifest says {rec['bytes']} (truncated?)")
            digest = sha256_file(fp)
            if digest != rec["sha256"]:
                raise CheckpointCorruptionError(
                    f"checkpoint {path!r}: {fname} SHA-256 mismatch "
                    f"(bit-flip or torn write): {digest[:16]}... != "
                    f"{rec['sha256'][:16]}...")
    return True


# --------------------------------------------------------------------------
# checkpoint series (one step_<n> subdir per save under a root)
# --------------------------------------------------------------------------

def step_dir_name(step: int) -> str:
    return f"step_{int(step):08d}"


def list_checkpoints(root: str) -> List[tuple]:
    """[(step, dirpath)] for every step_<n> subdir, oldest first."""
    try:
        names = os.listdir(root)
    except OSError:
        return []
    out = []
    for n in names:
        m = _STEP_RE.match(n)
        if m:
            out.append((int(m.group(1)), os.path.join(root, n)))
    return sorted(out)


def latest_committed(root: str) -> Optional[tuple]:
    """Newest (step, dirpath) carrying a COMMITTED marker, or None."""
    for step, path in reversed(list_checkpoints(root)):
        if is_committed(path):
            return step, path
    return None


def retain_last_k(root: str, keep: int) -> List[str]:
    """Delete the oldest COMMITTED checkpoints beyond ``keep``. The newest
    committed checkpoint is never deleted (keep is clamped to >= 1);
    uncommitted dirs are left for prune_uncommitted. Returns removed
    paths."""
    keep = max(1, int(keep))
    committed = [(s, p) for s, p in list_checkpoints(root) if is_committed(p)]
    removed = []
    for _, path in committed[:-keep] if len(committed) > keep else []:
        shutil.rmtree(path, ignore_errors=True)
        removed.append(path)
    return removed


def prune_uncommitted(root: str, keep_newest_in_flight: bool = False) -> List[str]:
    """Remove torn step dirs (no COMMITTED marker) so every resume path —
    even a naive pick-the-newest — lands on last-good. The elastic launcher
    calls this between restart rounds. ``keep_newest_in_flight`` spares the
    single newest uncommitted dir (an async save that may still land)."""
    uncommitted = [(s, p) for s, p in list_checkpoints(root)
                   if not is_committed(p)]
    if keep_newest_in_flight and uncommitted:
        uncommitted = uncommitted[:-1]
    removed = []
    for _, path in uncommitted:
        shutil.rmtree(path, ignore_errors=True)
        removed.append(path)
    return removed

"""Checkpoint integrity primitives shared by every checkpoint tier —
counterpart of ``paddle_tpu/framework/integrity.py``, the same contract.

The tier-1 pickle file (``framework/io.py``) and the tier-3 sharded
directory (``distributed/checkpoint/``) both record SHA-256 digests at
save time and verify them at load time, so a torn write, a truncated
shard or a bit flip is DETECTED instead of unpickled into garbage. The
module imports no torch.
"""

from __future__ import annotations

import hashlib
import os

__all__ = ["CheckpointCorruptionError", "sha256_bytes", "sha256_file",
           "atomic_write_bytes", "fsync_dir", "verify_enabled",
           "HashingWriter", "atomic_stream"]


def verify_enabled() -> bool:
    """The single ``FLAGS_checkpoint_verify`` lookup every tier shares."""
    from ..flags import flag
    return bool(flag("FLAGS_checkpoint_verify"))


class CheckpointCorruptionError(RuntimeError):
    """A checkpoint failed integrity verification (checksum mismatch,
    truncated shard, or missing commit marker where one is required)."""


def sha256_bytes(payload: bytes) -> str:
    return hashlib.sha256(payload).hexdigest()


def sha256_file(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                break
            h.update(b)
    return h.hexdigest()


def fsync_dir(path: str) -> None:
    """fsync a DIRECTORY so a rename inside it is durable (POSIX requires
    syncing the parent dir for the new name to survive a crash)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return  # platform without directory fds — rename is still atomic
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


class HashingWriter:
    """File-object tee: a pickle streams through it while the SHA-256 of
    what it wrote accumulates, so a multi-GB payload is hashed as it is
    written — no second full-size buffer and no second read. ``hashlib``
    and the file write both release the GIL on large buffers."""

    def __init__(self, f):
        self.raw = f
        self.sha = hashlib.sha256()
        self.nbytes = 0

    def write(self, b):
        self.sha.update(b)
        self.nbytes += memoryview(b).nbytes
        return self.raw.write(b)


class atomic_stream:
    """``with atomic_stream(path) as w: w.write(...)``: the bytes go to a
    temp file in the SAME directory through a :class:`HashingWriter`;
    on a clean exit the file is flushed, fsynced, ``os.replace``-d onto
    ``path`` and the directory fsynced. Any exception removes the temp
    file and leaves ``path`` as it was. ``w.sha`` / ``w.nbytes`` hold the
    digest and size of what was written."""

    def __init__(self, path: str):
        self.path = path
        d = os.path.dirname(path) or "."
        self._dir = d
        self._tmp = os.path.join(
            d, f".{os.path.basename(path)}.tmp.{os.getpid()}")
        self._f = None

    def __enter__(self) -> HashingWriter:
        self._f = open(self._tmp, "wb")
        return HashingWriter(self._f)

    def __exit__(self, exc_type, exc, tb):
        try:
            if exc_type is None:
                self._f.flush()
                os.fsync(self._f.fileno())
            self._f.close()
            if exc_type is None:
                os.replace(self._tmp, self.path)
        except BaseException:
            self._remove_tmp()
            raise
        if exc_type is not None:
            self._remove_tmp()
            return False
        fsync_dir(self._dir)
        return False

    def _remove_tmp(self):
        try:
            os.remove(self._tmp)
        except OSError:
            pass


def atomic_write_bytes(path: str, blob: bytes) -> None:
    """Write ``blob`` to ``path`` atomically: temp file in the SAME
    directory, flush + fsync, ``os.replace``, fsync the directory. A crash
    at any point leaves either the old file or the new one — never a torn
    mix."""
    with atomic_stream(path) as w:
        w.write(blob)

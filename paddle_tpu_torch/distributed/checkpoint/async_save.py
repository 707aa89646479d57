"""Async checkpoint series manager (Orbax-style CheckpointManager analog)
— counterpart of ``paddle_tpu/distributed/checkpoint/async_save.py``.

:class:`AsyncCheckpointer` owns a ROOT directory and writes each save into
its own ``step_<n>`` subdir with manifests + a COMMITTED marker, so the
series always contains a last-known-good snapshot:

* ``save(state_dict, step)`` copies every tensor to host memory before it
  returns (the port's train step updates parameters and moments IN PLACE,
  so a snapshot still being read when the next step writes would save a
  torn state), then pickles, hashes, writes, commits and applies
  retention on the shared background writer thread — the train loop
  overlaps that with compute and polls ``is_saving`` / calls ``wait()``;
* retention keeps the newest ``keep_last_k`` COMMITTED checkpoints and
  never GCs the last committed one;
* ``restore(state_dict)`` walks back from the newest committed checkpoint,
  checksum-verifying each, until one loads — a corrupted newest falls back
  to last-good instead of crashing;
* ``save_sync(..., deadline)`` is the bounded EMERGENCY flavor a
  preemption handler uses.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional

import torch

from ...framework.async_writer import WriteJob, default_writer
from . import manifest

__all__ = ["AsyncCheckpointer"]


class AsyncCheckpointer:
    def __init__(self, root: Optional[str] = None, keep_last_k: int = 3):
        if root is None:
            root = os.environ.get("PADDLE_CHECKPOINT_DIR")
        if not root:
            raise ValueError(
                "AsyncCheckpointer needs a root dir (arg or the launcher's "
                "PADDLE_CHECKPOINT_DIR env)")
        self.root = str(root)
        self.keep_last_k = int(keep_last_k)
        self._job: Optional[WriteJob] = None
        os.makedirs(self.root, exist_ok=True)

    # -- save ---------------------------------------------------------------
    def save(self, state_dict: Dict, step: int) -> WriteJob:
        """Queue an async save of ``state_dict`` as ``step_<n>``. Waits for
        the PREVIOUS save first (one in flight: two queued saves would
        serialize anyway and the backlog would just grow), re-raising its
        error if it failed."""
        self.wait()
        from . import _collect, _write_files, rank_and_world
        rank, world = rank_and_world()
        with torch.profiler.record_function("ckpt"):  # the blocking copy
            meta, payload = _collect(state_dict, rank)
        path = os.path.join(self.root, manifest.step_dir_name(step))
        coordinator = rank == 0

        def _write():
            _write_files(path, rank, meta, payload, coordinator, world)
            if coordinator:
                manifest.retain_last_k(self.root, self.keep_last_k)

        self._job = default_writer().submit(_write, label=path)
        return self._job

    def save_sync(self, state_dict: Dict, step: int,
                  deadline: Optional[float] = None) -> bool:
        """Blocking save with an optional DEADLINE (seconds) — the
        emergency-checkpoint flavor for preemption: returns False when the
        write did not commit inside the deadline (the round is about to
        die; an older committed checkpoint remains the resume point).

        The deadline covers the WHOLE call, including waiting out (or
        abandoning) a previous in-flight save: a writer stuck on a hung
        filesystem must not block the emergency path past its budget."""
        t0 = time.time()

        def _left():
            return None if deadline is None else max(
                0.05, deadline - (time.time() - t0))

        if self._job is not None and not self._job.done:
            job, self._job = self._job, None
            try:
                if not job.wait(_left()):
                    return False   # writer is stuck — nothing can commit
            except BaseException:
                pass  # the PREVIOUS save failed; ours may still succeed
        try:
            job = self.save(state_dict, step)
        except BaseException:
            # submit() flushes a prior finished-failed job by raising it;
            # the emergency save must still go out — retry once
            job = self.save(state_dict, step)
        return job.wait(_left())

    @property
    def is_saving(self) -> bool:
        return self._job is not None and not self._job.done

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until the in-flight save (if any) lands; re-raise its
        error so a failed async save is never silent. Returns False when
        ``timeout`` expired first (the job stays tracked)."""
        if self._job is None:
            return True
        job = self._job
        try:
            done = job.wait(timeout)
        except BaseException:
            self._job = None   # error consumed by the caller
            raise
        if done:
            self._job = None
        return done

    # -- restore ------------------------------------------------------------
    def latest_step(self) -> Optional[int]:
        got = manifest.latest_committed(self.root)
        return got[0] if got else None

    def restore(self, state_dict: Dict) -> Optional[int]:
        """Fill ``state_dict`` from the newest committed checkpoint that
        passes verification, walking back on corruption (last-good
        auto-recovery). Returns the restored step or None."""
        from . import load_latest
        return load_latest(state_dict, self.root)

    def all_steps(self):
        return [s for s, p in manifest.list_checkpoints(self.root)
                if manifest.is_committed(p)]

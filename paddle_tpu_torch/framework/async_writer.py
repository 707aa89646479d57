"""Shared background checkpoint writer — counterpart of
``paddle_tpu/framework/async_writer.py``, ported as is.

One daemon worker thread drains a job queue; ``framework.io``'s async
flavor (tier 1) and the distributed checkpointer (tier 3) both submit
their FILE I/O here after copying the device tensors to host memory
synchronously — so the train loop overlaps the (slow) pickling, hashing
and disk write with compute while the next step overwrites its tensors
in place.

Error contract: a writer exception never kills the training process from a
background thread. It is stored on the job and re-raised on ``job.wait()`` /
``wait_all()``, and — so fire-and-forget loops still see it — on the NEXT
``submit()``. The chaos harness injects faults through :func:`set_fault`.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, List, Optional

__all__ = ["WriteJob", "Writer", "default_writer"]

# chaos injection point: an exception instance raised inside the worker
# thread at the start of the next job (see testing.chaos.async_writer_fault)
_FAULT: dict = {"exc": None}


def set_fault(exc: Optional[BaseException]) -> None:
    _FAULT["exc"] = exc


class WriteJob:
    def __init__(self, fn: Callable[[], None], label: str = "ckpt"):
        self.fn = fn
        self.label = label
        self.error: Optional[BaseException] = None
        self._done = threading.Event()

    @property
    def done(self) -> bool:
        return self._done.is_set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until the write lands; re-raise its exception, if any.
        Returns False on timeout."""
        if not self._done.wait(timeout):
            return False
        if self.error is not None:
            err, self.error = self.error, None
            raise err
        return True


class Writer:
    """Single-thread job queue. Jobs run in submission order, so a
    retention pass submitted after a shard write sees the shard on disk."""

    def __init__(self, name: str = "ckpt-async-writer"):
        self._name = name
        self._q: "queue.Queue[WriteJob]" = queue.Queue()
        self._jobs: List[WriteJob] = []
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None

    def _ensure_thread(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        t = threading.Thread(target=self._run, daemon=True, name=self._name)
        t.start()
        self._thread = t

    def _run(self) -> None:
        while True:
            job = self._q.get()
            try:
                fault = _FAULT["exc"]
                if fault is not None:
                    raise fault
                job.fn()
            except BaseException as e:  # noqa: BLE001 — stored, not lost
                job.error = e
            finally:
                job._done.set()
                self._q.task_done()

    def submit(self, fn: Callable[[], None], label: str = "ckpt") -> WriteJob:
        """Queue a write. Raises the error of any FINISHED-failed job first
        (fire-and-forget callers must not silently lose corruption)."""
        self._raise_finished_errors()
        job = WriteJob(fn, label)
        with self._lock:
            self._jobs.append(job)
        self._ensure_thread()
        self._q.put(job)
        return job

    def _raise_finished_errors(self) -> None:
        with self._lock:
            jobs, self._jobs = self._jobs, []
            for j in jobs:
                if not j.done or j.error is not None:
                    self._jobs.append(j)
            failed = [j for j in self._jobs if j.done and j.error is not None]
            if failed:
                self._jobs = [j for j in self._jobs if j not in failed]
        if failed:
            raise failed[0].error

    @property
    def busy(self) -> bool:
        with self._lock:
            return any(not j.done for j in self._jobs)

    def wait_all(self, timeout: Optional[float] = None) -> None:
        """Drain every outstanding job; re-raise the first stored error.
        ``timeout`` is an OVERALL deadline — expiry raises TimeoutError
        (a caller about to trust the checkpoint must never see a silent
        partial drain)."""
        import time
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._lock:
            jobs = list(self._jobs)
        first_err = None
        pending = []
        for j in jobs:
            left = None if deadline is None else deadline - time.monotonic()
            try:
                if not j.wait(None if left is None else max(0.0, left)):
                    pending.append(j.label)
            except BaseException as e:  # noqa: BLE001
                if first_err is None:
                    first_err = e
        with self._lock:
            self._jobs = [j for j in self._jobs if not j.done]
        if first_err is not None:
            raise first_err
        if pending:
            raise TimeoutError(
                f"checkpoint writer: {len(pending)} write(s) still pending "
                f"after {timeout}s: {pending[:3]}")


_default: Optional[Writer] = None
_default_lock = threading.Lock()


def default_writer() -> Writer:
    global _default
    with _default_lock:
        if _default is None:
            _default = Writer()
        return _default

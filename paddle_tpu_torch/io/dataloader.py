"""DataLoader: forked workers with self-healing, and the host-to-card
prefetch — counterpart of ``paddle_tpu/io/dataloader.py``.

* Workers are ``fork`` subprocesses that touch only host memory: they
  fetch samples, collate them into CPU torch tensors and send them back.
  They never touch CUDA (the parent may already hold a CUDA context; a
  forked child must not use it), and run torch on one thread (the
  parent's OpenMP pool does not survive a fork). Pinning and the copy to
  the card happen in the parent (:func:`prefetch_to_device`).
* Transport: one pipe per worker, written whole by the worker's own
  thread. ``use_shared_memory=True`` pickles batches with the
  ``torch.multiprocessing`` reductions, which carry tensors in shared
  memory; ``False`` sends pickled numpy arrays. Neither falls back to the
  other.
  (The reference's shared-memory ring is native code, ``paddle_tpu/native``,
  which the port does not have.)
* Self-healing, as in the reference: ``sample_retries`` (bounded
  exponential backoff), ``quarantine_bad_samples`` (the index is dropped
  for good, and the workers of later epochs inherit the quarantine set
  through the fork), a fully quarantined batch skipped, and
  ``worker_restarts`` (a dead worker is replaced and its in-flight
  batches re-queued; map-style datasets only). A batch in shared memory
  whose sender died before the parent took it cannot be received; it is
  still in flight, so the replacement worker recomputes it.
* Batches come out as CPU tensors; :func:`prefetch_to_device` puts them
  on the card.
"""

from __future__ import annotations

import collections
import itertools
import multiprocessing.connection as mp_connection
import queue as pyqueue
import signal as _signal
import time
import traceback
import warnings
from typing import Any, Callable, List, Optional

import numpy as np
import torch
import torch.multiprocessing  # noqa: F401  (registers tensor pickling)
from multiprocessing.reduction import ForkingPickler

from ..device import resolve_device
from .dataset import Dataset, IterableDataset
from .sampler import BatchSampler

__all__ = ["DataLoader", "get_worker_info", "default_collate_fn",
           "default_convert_fn", "WorkerInfo", "prefetch_to_device"]


def _describe_exit(code: Optional[int]) -> str:
    """Human-readable worker exit: decodes the signal for negative codes
    (multiprocessing convention) so 'exit code -9' reads as the OOM kill
    it almost always is."""
    if code is None:
        return "still exiting"
    if code < 0:
        try:
            name = _signal.Signals(-code).name
        except ValueError:
            name = f"signal {-code}"
        hint = " (likely the kernel OOM killer)" if -code == 9 else \
            " (segfault in dataset/native code)" if -code == 11 else ""
        return f"killed by {name}{hint}"
    return f"exit code {code}"


def _fetch_sample(dataset, idx, retries: int, backoff_s: float):
    """``dataset[idx]`` with bounded retry + exponential backoff — the
    self-healing path for transient failures. Deterministic failures
    exhaust the retries and re-raise for the caller's quarantine/raise
    decision."""
    attempt = 0
    while True:
        try:
            return dataset[idx]
        except Exception:
            if attempt >= retries:
                raise
            time.sleep(backoff_s * (2 ** attempt))
            attempt += 1


class _SkippedBatch:
    """Worker->parent marker: every index of this batch is quarantined —
    the batch is dropped, the epoch continues."""


def _gather_batch(dataset, indices, quarantined: set, retries: int,
                  backoff_s: float, quarantine: bool, who: str = "DataLoader",
                  on_quarantine: Optional[Callable] = None):
    """Fetch a batch's samples with the self-healing policy — shared by
    the worker loop and the single-process path. Mutates ``quarantined``
    in place; calls ``on_quarantine(idx)`` for each NEWLY quarantined
    index. Returns the item list, or ``None`` when quarantine left the
    batch EMPTY (the batch is skipped, not fatal)."""
    items, last_exc = [], None
    for i in indices:
        if i in quarantined:
            continue
        try:
            items.append(_fetch_sample(dataset, i, retries, backoff_s))
        except Exception as e:
            if not quarantine:
                raise
            last_exc = e
            quarantined.add(i)
            if on_quarantine is not None:
                on_quarantine(i)
            warnings.warn(
                f"{who}: sample {i} failed {retries + 1}x and was "
                f"quarantined ({type(e).__name__}: {e}); the batch "
                f"continues without it")
    if not items:
        if quarantine:
            if last_exc is not None:   # newly emptied this epoch: say so
                warnings.warn(f"{who}: every index of a batch is "
                              f"quarantined; skipping the batch")
            return None
        raise last_exc if last_exc is not None else RuntimeError(
            "batch: every index quarantined")
    return items


class WorkerInfo:
    def __init__(self, id: int, num_workers: int, seed: int, dataset):  # noqa: A002
        self.id = id
        self.num_workers = num_workers
        self.seed = seed
        self.dataset = dataset


_worker_info: Optional[WorkerInfo] = None


def get_worker_info() -> Optional[WorkerInfo]:
    """Inside a worker: this worker's (id, num_workers, seed, dataset);
    ``None`` in the main process (reference parity)."""
    return _worker_info


def default_convert_fn(batch):
    return batch


def default_collate_fn(batch: List[Any]):
    """Stack a list of samples into batched CPU torch tensors (nested
    structures follow the reference: dict -> dict of stacks, tuple ->
    tuple of stacks; Python floats become float32, ints int64)."""
    sample = batch[0]
    if isinstance(sample, torch.Tensor):
        return torch.stack(batch)
    if isinstance(sample, np.ndarray):
        return torch.from_numpy(np.stack(batch))
    if isinstance(sample, (np.floating, float)):
        return torch.from_numpy(np.asarray(batch, np.float32))
    if isinstance(sample, (np.integer, int)):
        return torch.from_numpy(np.asarray(batch, np.int64))
    if isinstance(sample, (str, bytes)):
        return batch
    if isinstance(sample, dict):
        return {k: default_collate_fn([d[k] for d in batch]) for k in sample}
    if isinstance(sample, (tuple, list)):
        return type(sample)(default_collate_fn(list(fields))
                            for fields in zip(*batch))
    try:
        return torch.from_numpy(np.stack([np.asarray(s) for s in batch]))
    except (TypeError, ValueError):
        return batch


def _map_tree(fn, batch):
    if isinstance(batch, dict):
        return {k: _map_tree(fn, v) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(_map_tree(fn, v) for v in batch)
    return fn(batch)


def _as_numpy(x):
    return x.numpy() if isinstance(x, torch.Tensor) else x


def _as_tensor(x):
    return torch.from_numpy(x) if isinstance(x, np.ndarray) else x


class _ExceptionWrapper:
    def __init__(self, exc):
        self.exc_type = type(exc).__name__
        self.msg = f"{exc}\n{traceback.format_exc()}"

    def reraise(self):
        raise RuntimeError(
            f"DataLoader worker raised {self.exc_type}: {self.msg}")


class _Sender:
    """The worker's end of its result pipe. Each put is written whole by
    the calling thread before the worker fetches its next sample (no
    feeder thread, no lock shared with other workers), so a worker killed
    in dataset code leaves no torn message. Tensors go as they are (the
    ``torch.multiprocessing`` pickler moves them into shared memory) or,
    with ``shared=False``, as numpy arrays (pickled bytes)."""

    def __init__(self, conn, shared: bool):
        self.conn = conn
        self.shared = shared

    def put(self, item):
        if not self.shared:
            item = (item[0], _map_tree(_as_numpy, item[1]))
        self.conn.send_bytes(ForkingPickler.dumps(item))


class _Results:
    """The parent's end: one pipe per worker, read as they become ready
    (``multiprocessing.connection.wait``), round-robin. ``get`` raises
    ``queue.Empty`` on timeout, like a queue."""

    def __init__(self, readers):
        self.readers = list(readers)
        self._next = 0

    def get(self, timeout=None):
        ready = mp_connection.wait(self.readers, timeout)
        if not ready:
            raise pyqueue.Empty
        n = len(self.readers)
        for k in range(n):
            r = self.readers[(self._next + k) % n]
            if r in ready:
                self._next = (self._next + k + 1) % n
                return ForkingPickler.loads(r.recv_bytes())
        raise pyqueue.Empty


def _worker_loop(dataset, index_queue, result_conn, collate_fn, init_fn,
                 worker_id, num_workers, seed, iterable, shared,
                 retry_cfg=(0, 0.05, False, frozenset())):
    global _worker_info
    # the parent's OpenMP pool did not survive the fork: a parallel region
    # here (the shared-memory pickler copies a large storage with one)
    # would wait for its threads forever
    torch.set_num_threads(1)
    _worker_info = WorkerInfo(worker_id, num_workers, seed, dataset)
    np.random.seed(seed % (2 ** 31))
    out = _Sender(result_conn, shared)
    try:
        if init_fn is not None:
            init_fn(worker_id)
    except Exception as e:  # init failure poisons every batch
        out.put((-1, _ExceptionWrapper(e)))
        return
    if iterable:
        # stream split: worker w takes items w, w+N, w+2N, ... and batches
        # arrive pre-chunked as (batch_idx, batch_size) requests
        it = itertools.islice(iter(dataset), worker_id, None, num_workers)
        while True:
            req = index_queue.get()
            if req is None:
                return
            bidx, bsize = req
            items = list(itertools.islice(it, bsize))
            if not items:
                out.put((bidx, StopIteration()))
                continue
            try:
                out.put((bidx, collate_fn(items)))
            except Exception as e:
                out.put((bidx, _ExceptionWrapper(e)))
    else:
        retries, backoff_s, quarantine, initial_q = retry_cfg
        # seeded from the parent loader's set at fork: indices quarantined
        # in earlier epochs are skipped without re-paying the retries
        quarantined: set = set(initial_q)
        while True:
            req = index_queue.get()
            if req is None:
                return
            bidx, indices = req
            try:
                items = _gather_batch(
                    dataset, indices, quarantined, retries, backoff_s,
                    quarantine, who=f"DataLoader worker {worker_id}",
                    # tell the parent so the NEXT epoch's workers inherit
                    on_quarantine=lambda i: out.put((-2, i)))
                out.put((bidx, _SkippedBatch() if items is None
                         else collate_fn(items)))
            except Exception as e:
                out.put((bidx, _ExceptionWrapper(e)))


def _to_device(batch, device, non_blocking=False):
    """Tensors (and numpy arrays) of a batch onto ``device``; CPU sources
    are pinned first when the copy is ``non_blocking``."""
    def move(x):
        x = _as_tensor(x)
        if not isinstance(x, torch.Tensor) or x.device == device:
            return x
        if non_blocking and x.device.type == "cpu":
            x = x.pin_memory()
        return x.to(device, non_blocking=non_blocking)
    return _map_tree(move, batch)


def _record_stream(batch, stream):
    def rec(x):
        if isinstance(x, torch.Tensor) and x.device.type == "cuda":
            x.record_stream(stream)
        return x
    _map_tree(rec, batch)


def prefetch_to_device(iterable, size: int = 2, device=None):
    """Keep ``size`` batches' host-to-device copies in flight ahead of the
    consumer (the pinned-memory + side-stream pipeline), over ANY batch
    iterable. ``device`` is the card unless the caller asks for another.

    On a card: each batch is pinned and copied with ``non_blocking=True``
    on a side stream, an event marks the copy's end, and the consuming
    stream waits on that event when the batch is handed out — so the copy
    of batch N+1 overlaps step N. The next copy starts BEFORE the
    current batch is handed out. ``"data"`` / ``"h2d"``
    ``torch.profiler.record_function`` spans mark the host fetch and the
    copy's launch. On the CPU (``device="cpu"``) it is a plain convert-and-
    yield loop. Batches may be tensors, numpy arrays, or nested
    dict/tuple/list trees of them."""
    dev = resolve_device(device)
    it = iter(iterable)
    try:
        if dev.type == "cpu":
            for b in it:
                yield _to_device(b, dev)
        else:
            yield from _prefetch_cuda(it, max(1, int(size)), dev)
    finally:
        close = getattr(it, "close", None)
        if close is not None:          # a loader's workers stop with it
            close()


def _prefetch_cuda(it, size, dev):
    copy_stream = torch.cuda.Stream(device=dev)
    buf = collections.deque()

    def _fill():
        with torch.profiler.record_function("data"):
            try:
                b = next(it)
            except StopIteration:
                return False
        with torch.profiler.record_function("h2d"), \
                torch.cuda.stream(copy_stream):
            out = _to_device(b, dev, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(copy_stream)
        buf.append((out, ev))
        return True

    while len(buf) < size and _fill():
        pass
    while buf:
        out, ev = buf.popleft()
        consumer = torch.cuda.current_stream(dev)
        consumer.wait_event(ev)
        # the copy stream allocated these; the allocator must not hand
        # their memory out again before the consumer's work on them ends
        _record_stream(out, consumer)
        _fill()
        yield out


class _WorkerSet:
    """Worker processes + transport + in-flight bookkeeping, with
    resurrection: a dead worker (OOM kill, segfault in dataset code) is
    replaced by a fresh fork — same worker id, FRESH index queue and
    result pipe (the old ones may hold a torn request or reply) — and
    every batch that was in flight on it is re-queued, so one lost worker
    costs a recompute instead of the epoch.

    Resurrection is map-style only: an IterableDataset worker's stream
    position died with the process, so replaying its requests would
    silently skip or duplicate samples — those keep the fail-fast path.
    Queues and pipes are written synchronously (no feeder threads), so
    the parent forks a replacement with no queue thread running.
    """

    def __init__(self, loader: "DataLoader"):
        import torch.multiprocessing as tmp
        self.loader = loader
        self.ctx = tmp.get_context("fork")  # workers reuse the dataset
        self.nw = loader.num_workers
        self.base_seed = np.random.randint(0, 2 ** 31 - 1)
        self.index_queues: List = []
        self.conns: List = []             # (parent reader, worker writer)
        self.procs: List = []
        self.inflight: dict = {}       # bidx -> (worker_id, payload)
        self.restarts_left = (0 if loader._iterable
                              else loader.worker_restarts)
        self.generation = 0
        for w in range(self.nw):
            self.index_queues.append(self.ctx.SimpleQueue())
            self.conns.append(self.ctx.Pipe(duplex=False))
            self.procs.append(self._spawn(w))
        self.results = _Results(r for r, _ in self.conns)

    def _spawn(self, w: int):
        p = self.ctx.Process(
            target=_worker_loop,
            args=(self.loader.dataset, self.index_queues[w],
                  self.conns[w][1], self.loader.collate_fn,
                  self.loader.worker_init_fn, w, self.nw,
                  self.base_seed + w + self.generation * self.nw,
                  self.loader._iterable, self.loader.use_shared_memory,
                  (self.loader.sample_retries,
                   self.loader.sample_retry_backoff,
                   self.loader.quarantine_bad_samples,
                   frozenset(self.loader._quarantined))),
            daemon=True)
        p.start()
        return p

    # -- in-flight bookkeeping (map-style) ----------------------------------
    def submit(self, bidx: int, payload):
        w = bidx % self.nw
        self.index_queues[w].put((bidx, payload))
        self.inflight[bidx] = (w, payload)

    def done(self, bidx: int):
        self.inflight.pop(bidx, None)

    def revive(self, dead) -> bool:
        """Replace dead workers and re-queue their in-flight batches.
        Returns False (caller raises) when the restart budget is spent or
        the dataset is iterable."""
        if self.restarts_left < len(dead):
            return False
        self.restarts_left -= len(dead)
        self.generation += 1
        for w, code in dead:
            warnings.warn(
                f"DataLoader worker {w} died ({_describe_exit(code)}); "
                f"resurrecting it and re-queuing "
                f"{sum(1 for ww, _ in self.inflight.values() if ww == w)} "
                f"in-flight batch(es) "
                f"({self.restarts_left} restart(s) left)")
            self.procs[w].join(timeout=0.1)
            for c in self.conns[w]:
                c.close()
            self.index_queues[w].close()
            self.index_queues[w] = self.ctx.SimpleQueue()
            self.conns[w] = self.ctx.Pipe(duplex=False)
            self.results.readers[w] = self.conns[w][0]
            self.procs[w] = self._spawn(w)
            for bidx, (ww, payload) in sorted(self.inflight.items()):
                if ww == w:
                    self.index_queues[w].put((bidx, payload))
        return True

    def shutdown(self):
        for iq in self.index_queues:
            iq.put(None)
        for p in self.procs:
            p.join(timeout=1.0)
            if p.is_alive():
                p.terminate()
                p.join(timeout=1.0)
        for r, wr in self.conns:
            r.close()
            wr.close()
        for iq in self.index_queues:
            iq.close()


class DataLoader:
    """ref: paddle.io.DataLoader (return_list=True semantics only). Batches
    are CPU torch tensors; wrap the loader in :func:`prefetch_to_device`
    to put them on the card. ``feed_list``, ``places`` and
    ``use_buffer_reader`` are accepted for API compatibility and ignored
    (the reference's device prefetch is :func:`prefetch_to_device` here);
    ``prefetch_factor`` is the batches in flight per worker."""

    def __init__(self, dataset: Dataset, feed_list=None, places=None,
                 return_list: bool = True, batch_sampler=None,
                 batch_size: int = 1, shuffle: bool = False,
                 drop_last: bool = False, collate_fn: Optional[Callable] = None,
                 num_workers: int = 0, use_buffer_reader: bool = True,
                 prefetch_factor: int = 2, use_shared_memory: bool = True,
                 timeout: float = 0, worker_init_fn: Optional[Callable] = None,
                 persistent_workers: bool = False,
                 sample_retries: Optional[int] = None,
                 sample_retry_backoff: Optional[float] = None,
                 quarantine_bad_samples: Optional[bool] = None,
                 worker_restarts: Optional[int] = None):
        """Self-healing knobs (defaults from the FLAGS_health_* flags, which
        default OFF so error propagation is unchanged unless opted in):

        * ``sample_retries`` — retry a failing ``Dataset.__getitem__``
          with bounded exponential backoff (transient I/O);
        * ``quarantine_bad_samples`` — after the retries, drop the sample
          and quarantine its index (warn once) instead of poisoning the
          epoch (defaults on when retries are enabled);
        * ``worker_restarts`` — resurrect a dead worker process up to N
          times, re-queuing its in-flight batches (map-style datasets).

        ``timeout`` (seconds, 0 = none) bounds each wait for a worker's
        batch. ``persistent_workers`` is accepted for parity; as in the
        reference, workers are forked per epoch (which is how a new
        epoch's workers inherit the quarantine set).
        """
        from ..flags import flag
        self.dataset = dataset
        self.return_list = return_list
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = max(0, int(num_workers))
        self.use_shared_memory = bool(use_shared_memory)
        self.prefetch_factor = max(1, int(prefetch_factor))
        self.timeout = timeout
        self.worker_init_fn = worker_init_fn
        self.sample_retries = int(
            flag("FLAGS_health_data_retries") if sample_retries is None
            else sample_retries)
        self.sample_retry_backoff = float(
            flag("FLAGS_health_data_backoff_s")
            if sample_retry_backoff is None else sample_retry_backoff)
        self.quarantine_bad_samples = bool(
            self.sample_retries > 0 if quarantine_bad_samples is None
            else quarantine_bad_samples)
        self.worker_restarts = int(
            flag("FLAGS_health_worker_restarts") if worker_restarts is None
            else worker_restarts)
        self._quarantined: set = set()
        self._iterable = isinstance(dataset, IterableDataset)
        if self._iterable:
            if batch_sampler is not None or shuffle:
                raise ValueError(
                    "IterableDataset does not accept batch_sampler/shuffle")
            self.batch_size = int(batch_size)
            self.drop_last = bool(drop_last)
            self.batch_sampler = None
        elif batch_sampler is not None:
            if batch_size != 1 or shuffle or drop_last:
                raise ValueError(
                    "batch_sampler is mutually exclusive with "
                    "batch_size/shuffle/drop_last")
            self.batch_sampler = batch_sampler
            self.batch_size = batch_sampler.batch_size
        else:
            self.batch_sampler = BatchSampler(
                dataset, shuffle=shuffle, batch_size=batch_size,
                drop_last=drop_last)
            self.batch_size = int(batch_size)

    def __len__(self):
        if self._iterable:
            raise TypeError("DataLoader over an IterableDataset has no length")
        return len(self.batch_sampler)

    # -- iteration ----------------------------------------------------------

    def _raw_batches(self):
        """Yield collated CPU-tensor batches (single- or multi-process)."""
        if self.num_workers == 0:
            if self._iterable:
                it = iter(self.dataset)
                while True:
                    items = list(itertools.islice(it, self.batch_size))
                    if not items or (self.drop_last and
                                     len(items) < self.batch_size):
                        return
                    yield self.collate_fn(items)
            else:
                for indices in self.batch_sampler:
                    items = self._fetch_batch(indices)
                    if items is None:   # fully-quarantined batch: skip
                        continue
                    yield self.collate_fn(items)
            return
        for b in self._multiprocess_batches():
            yield b if self.use_shared_memory else _map_tree(_as_tensor, b)

    def _fetch_batch(self, indices):
        """Single-process fetch with the same retry/quarantine healing the
        workers apply (shared quarantine set across epochs)."""
        return _gather_batch(self.dataset, indices, self._quarantined,
                             self.sample_retries, self.sample_retry_backoff,
                             self.quarantine_bad_samples)

    def _multiprocess_batches(self):
        ws = _WorkerSet(self)
        try:
            if self._iterable:
                yield from self._mp_iterable(ws.index_queues, ws.results,
                                             ws.nw, ws.procs)
            else:
                yield from self._mp_map(ws)
        finally:
            ws.shutdown()

    @staticmethod
    def _await_death(workers, wait_s: float = 2.0) -> bool:
        """True once some worker is dead (polling up to ``wait_s``: a
        killed worker's socket closes a moment before it can be reaped)."""
        deadline = time.monotonic() + wait_s
        while True:
            if any(not p.is_alive() for p in workers):
                return True
            if time.monotonic() > deadline:
                return False
            time.sleep(0.01)

    def _get(self, result_queue, workers=(), revive=None):
        """Queue get with a liveness watchdog: wait in short slices; when a
        worker died (OOM kill/segfault) either resurrect it via ``revive``
        (self-healing map-style path) or fail fast with the worker's
        decoded exit signal instead of blocking forever."""
        from ..health import watchdog
        deadline = (None if not self.timeout
                    else time.monotonic() + self.timeout)
        while True:
            slice_t = 1.0
            if deadline is not None:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise RuntimeError(
                        f"DataLoader timed out after {self.timeout}s waiting "
                        f"for a worker batch")
                slice_t = min(slice_t, left)
            try:
                out = result_queue.get(timeout=slice_t)
                # progress tick ONLY on a real batch: ticking the empty
                # poll slices would mask the stalled-input hang
                watchdog.touch()
                return out
            except (OSError, EOFError):
                # a shared-memory batch whose sender died before handing
                # its memory over: it stays in flight, re-queued on revive
                if revive is None or not self._await_death(workers):
                    raise
                continue
            except pyqueue.Empty:
                dead = [(i, p.exitcode) for i, p in enumerate(workers)
                        if not p.is_alive()]
                if dead:
                    # final drain: a worker may have enqueued its result (or
                    # the real exception) just before exiting
                    try:
                        return result_queue.get(timeout=0.2)
                    except (pyqueue.Empty, OSError, EOFError):
                        pass
                    if revive is not None and revive(dead):
                        continue   # replacements spawned, work re-queued
                    descr = ", ".join(
                        f"worker {i}: {_describe_exit(c)}" for i, c in dead)
                    raise RuntimeError(
                        f"DataLoader worker(s) died unexpectedly ({descr}); "
                        f"the remaining batch will never arrive. Map-style "
                        f"datasets can self-heal via worker_restarts= / "
                        f"FLAGS_health_worker_restarts."
                    ) from None

    def _mp_map(self, ws: "_WorkerSet"):
        batches = list(self.batch_sampler)
        depth = min(len(batches), self.prefetch_factor * ws.nw)
        for nxt in range(depth):
            ws.submit(nxt, batches[nxt])
        nxt = depth
        reorder = {}
        for want in range(len(batches)):
            while want not in reorder:
                bidx, data = self._get(ws.results, ws.procs,
                                       revive=ws.revive)
                if bidx == -2:
                    # quarantine notice: the next epoch's workers (a fresh
                    # fork) inherit it and skip the index outright
                    self._quarantined.add(data)
                    continue
                if isinstance(data, _ExceptionWrapper):
                    data.reraise()
                if bidx not in ws.inflight:
                    continue        # a re-queued batch's first copy
                ws.done(bidx)
                reorder[bidx] = data
            data = reorder.pop(want)
            if nxt < len(batches):
                ws.submit(nxt, batches[nxt])
                nxt += 1
            if isinstance(data, _SkippedBatch):
                continue            # fully-quarantined batch: dropped
            yield data

    def _mp_iterable(self, index_queues, result_queue, nw, workers=()):
        # request batches round-robin; a worker answering StopIteration is
        # retired, remaining workers drain their stream tails
        active = set(range(nw))
        bidx = 0
        inflight = collections.deque()
        depth = self.prefetch_factor * nw

        def request():
            nonlocal bidx
            if not active:
                return False
            w = bidx % nw
            if w not in active:
                w = next(iter(active))
            index_queues[w].put((bidx, self.batch_size))
            inflight.append(bidx)
            bidx += 1
            return True

        for _ in range(depth):
            request()
        reorder = {}
        while inflight:
            while inflight[0] not in reorder:
                i, data = self._get(result_queue, workers)
                if isinstance(data, _ExceptionWrapper):
                    data.reraise()
                reorder[i] = data
            i = inflight.popleft()
            data = reorder.pop(i)
            if isinstance(data, StopIteration):
                active.discard(i % nw)
                continue
            request()
            if self.drop_last and self._batch_len(data) < self.batch_size:
                continue
            yield data

    @staticmethod
    def _batch_len(data):
        if isinstance(data, (torch.Tensor, np.ndarray)):
            return data.shape[0]
        if isinstance(data, dict):
            return DataLoader._batch_len(next(iter(data.values())))
        if isinstance(data, (tuple, list)) and data:
            return DataLoader._batch_len(data[0])
        return 0

    def __iter__(self):
        return self._raw_batches()

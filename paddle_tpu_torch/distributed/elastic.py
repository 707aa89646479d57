"""Elastic training: liveness heartbeats, hung-rank detection and
preemption — counterpart of ``paddle_tpu/distributed/elastic.py``.

The launcher (:mod:`.launch`) hosts the rendezvous store
(:class:`~.store.TCPStore`, ``torch.distributed.TCPStore`` underneath) and
every worker runs a daemon thread stamping ``hb/<job>/<rank>`` with the
wall clock; the launcher's watch loop declares a rank HUNG when its stamp
goes stale for ``--elastic_timeout`` seconds — a worker alive but frozen
(a deadlock, a stuck collective), which exit codes alone cannot show.
Detection takes the same kill-all and restart path as a crash; the next
round gets a fresh rendezvous port and the script resumes from its own
checkpoint.

Worker side: :func:`~.collective.init_parallel_env` calls
:func:`start_heartbeat` when the launcher exported
``PADDLE_ELASTIC_STORE``; a script that skips it can call it directly.

Preemption: the launcher forwards SIGTERM to the workers with a bounded
grace window; a worker that installed :func:`install_preemption_handler`
runs an emergency save (for example ``AsyncCheckpointer.save_sync``) under
a deadline and exits with :data:`EMERGENCY_EXIT_RC`, so the next round
resumes from a commit at most one step old.
"""

from __future__ import annotations

import os
import signal
import sys
import threading
import time
from typing import Callable, Optional

__all__ = ["start_heartbeat", "stop_heartbeat", "HeartbeatMonitor",
           "RankWatchdog", "install_preemption_handler",
           "uninstall_preemption_handler", "preempted", "EMERGENCY_EXIT_RC"]

_worker = {"thread": None, "stop": None, "pause": None}
_worker_lock = threading.Lock()

EMERGENCY_EXIT_RC = 87  # worker exit code after a preemption-triggered save

# seconds a worker's store client may take to connect before the heartbeat
# is given up (the launcher then watches exit codes only)
_CONNECT_TIMEOUT_S = 10.0


def start_heartbeat(store_addr: Optional[str] = None,
                    rank: Optional[int] = None,
                    interval: Optional[float] = None):
    """Begin stamping liveness into the launcher's store (idempotent: a
    second call while the thread runs returns None).

    A daemon thread SETs ``hb/<job>/<rank>`` = wall clock every
    ``interval`` seconds (``PADDLE_HEARTBEAT_INTERVAL``, default 5). A
    store that cannot be reached warns and returns None: liveness never
    aborts training."""
    addr = store_addr or os.environ.get("PADDLE_ELASTIC_STORE")
    with _worker_lock:
        if not addr or _worker["thread"] is not None:
            return None
    rank = int(os.environ.get("PADDLE_TRAINER_ID", "0")) if rank is None \
        else int(rank)
    interval = interval if interval is not None else float(
        os.environ.get("PADDLE_HEARTBEAT_INTERVAL", "5.0"))
    job = os.environ.get("PADDLE_JOB_ID", "default")
    host, port = addr.rsplit(":", 1)

    try:
        from .store import TCPStore
        store = TCPStore(host, int(port), timeout=_CONNECT_TIMEOUT_S)
    except Exception as e:
        import warnings
        warnings.warn(f"elastic heartbeat disabled: cannot reach the "
                      f"launcher store at {addr} ({e})")
        return None
    key = f"hb/{job}/{rank}"
    stop = threading.Event()
    pause = threading.Event()  # chaos harness: stall stamping past the TTL

    def beat():
        try:
            while not stop.is_set():
                if not pause.is_set():
                    try:
                        store.set(key, f"{time.time():.3f}")
                    except Exception:
                        pass  # the store may be gone during teardown
                stop.wait(interval)
        finally:
            store.close()  # the beat thread owns its connection

    t = threading.Thread(target=beat, daemon=True, name="elastic-heartbeat")
    with _worker_lock:
        if _worker["thread"] is not None:  # raced with another caller
            stop.set()
            store.close()
            return _worker["thread"]
        _worker["thread"], _worker["stop"] = t, stop
        _worker["pause"] = pause
    t.start()
    return t


def stop_heartbeat(join_timeout: float = 2.0):
    """Stop the stamping thread and join it (bounded), so a later
    :func:`start_heartbeat` cannot race a stale stamp. Idempotent."""
    with _worker_lock:
        t, stop = _worker["thread"], _worker["stop"]
        _worker["thread"] = _worker["stop"] = _worker["pause"] = None
    if stop is not None:
        stop.set()
    if t is not None and t.is_alive():
        t.join(timeout=join_timeout)


def _pause_event() -> Optional[threading.Event]:
    """The running heartbeat's pause event (the chaos harness's
    ``stall_heartbeat`` sets it), or None."""
    with _worker_lock:
        return _worker["pause"]


class HeartbeatMonitor:
    """Launcher side: host the store, read stamps, report stale ranks."""

    def __init__(self, job_id: str = "default"):
        from .store import TCPStore
        self.store = TCPStore(is_master=True)
        self.addr = f"127.0.0.1:{self.store.port}"
        self.job = job_id

    def last_beat(self, rank: int) -> Optional[float]:
        """The rank's newest stamp, or None when it never stamped (a
        script that does not use the framework)."""
        try:
            return float(self.store.get(f"hb/{self.job}/{rank}"))
        except Exception:
            return None

    def hung_ranks(self, ranks, ttl: float):
        """The ranks whose last stamp is older than ``ttl`` seconds; ranks
        that never stamped are not reported."""
        now = time.time()
        out = []
        for r in ranks:
            t = self.last_beat(r)
            if t is not None and now - t > ttl:
                out.append(r)
        return out

    def clear(self, world_size: int):
        for r in range(world_size):
            self.store.delete_key(f"hb/{self.job}/{r}")

    def start_watchdog(self, ranks, ttl: float,
                       on_hang: Optional[Callable] = None,
                       poll: float = 0.5) -> "RankWatchdog":
        """A watchdog thread over :meth:`hung_ranks`: on the first stale
        stamp it records the hung ranks, calls ``on_hang(ranks)`` (default:
        the diagnosis on stderr), sets its event and stands down."""
        return RankWatchdog(self, list(ranks), float(ttl), on_hang,
                            float(poll))

    def close(self):
        self.store.close()


class RankWatchdog:
    """Handle of :meth:`HeartbeatMonitor.start_watchdog`: ``.hung`` (the
    ranks, once detected), ``.event`` (set on detection), ``wait()``
    (raises ``TimeoutError`` naming the ranks), ``.stop()``."""

    def __init__(self, monitor: HeartbeatMonitor, ranks, ttl: float,
                 on_hang: Optional[Callable], poll: float):
        self.monitor = monitor
        self.ranks = ranks
        self.ttl = ttl
        self.on_hang = on_hang
        self.hung = []
        self.event = threading.Event()
        self._stop = threading.Event()
        self._poll = max(0.05, poll)
        self._thread = threading.Thread(target=self._watch, daemon=True,
                                        name="rank-watchdog")
        self._thread.start()

    def _watch(self):
        while not self._stop.wait(self._poll):
            try:
                hung = self.monitor.hung_ranks(self.ranks, self.ttl)
            except Exception:
                continue   # store teardown race: never crash the watcher
            if hung:
                self.hung = hung
                if self.on_hang is not None:
                    self.on_hang(hung)
                else:
                    print(f"[health] rank watchdog: rank(s) {hung} "
                          f"alive-but-frozen (no heartbeat for "
                          f">{self.ttl}s)", file=sys.stderr)
                self.event.set()
                return

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until a hang is detected, then raise ``TimeoutError``
        naming the frozen ranks; False when ``timeout`` elapses first."""
        if self.event.wait(timeout):
            raise TimeoutError(
                f"rank(s) {self.hung} hung: alive but not stamping "
                f"heartbeats for >{self.ttl}s (frozen in a collective, "
                f"native deadlock, or swap storm)")
        return False

    def stop(self, join_timeout: float = 2.0):
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=join_timeout)


# ---------------------------------------------------------------------------
# preemption (SIGTERM) handling, worker side
# ---------------------------------------------------------------------------

_preempt = {"flag": False, "prev": None, "installed": False}


def preempted() -> bool:
    """True once SIGTERM was observed: a train loop with no emergency save
    polls this each step to stop cleanly."""
    return _preempt["flag"]


def install_preemption_handler(save_fn: Optional[Callable[[], None]] = None,
                               deadline: Optional[float] = None,
                               exit_code: Optional[int] = EMERGENCY_EXIT_RC):
    """Install a SIGTERM handler that runs ``save_fn`` (an emergency
    checkpoint, e.g. ``lambda: ck.save_sync(state, step)``) for at most
    ``deadline`` seconds, then exits with ``exit_code``.

    ``deadline`` defaults to ``PADDLE_PREEMPT_GRACE`` (the launcher's)
    less a 2 s margin, else ``FLAGS_emergency_ckpt_deadline_s``.
    ``exit_code=None`` only sets :func:`preempted` and runs ``save_fn``;
    the train loop exits itself. The save runs on a helper thread joined
    with the deadline: a save that cannot commit in time is abandoned (its
    step directory stays uncommitted, and restores skip it). Returns the
    handler, or None off the main thread."""
    if deadline is None:
        grace = os.environ.get("PADDLE_PREEMPT_GRACE")
        if grace is not None:
            deadline = max(1.0, float(grace) - 2.0)
        else:
            from ..flags import flag
            deadline = float(flag("FLAGS_emergency_ckpt_deadline_s"))

    def _handler(signum, frame):
        _preempt["flag"] = True
        if save_fn is not None:
            t = threading.Thread(target=save_fn, daemon=True,
                                 name="emergency-ckpt")
            t.start()
            t.join(deadline)
        if exit_code is not None:
            os._exit(exit_code)

    try:
        prev = signal.signal(signal.SIGTERM, _handler)
    except ValueError:  # not the main thread: the caller polls preempted()
        return None
    if not _preempt["installed"]:
        _preempt["prev"] = prev
        _preempt["installed"] = True
    return _handler


def uninstall_preemption_handler():
    if _preempt["installed"]:
        try:
            signal.signal(signal.SIGTERM, _preempt["prev"] or signal.SIG_DFL)
        except ValueError:
            pass
        _preempt["installed"] = False
    _preempt["flag"] = False
    _preempt["prev"] = None

"""Hang watchdog: liveness for the ALIVE-but-frozen failure mode.

Counterpart of ``paddle_tpu/health/watchdog.py`` (``HangWatchdog``,
``WatchdogAlarm`` and the process-global ``install`` / ``uninstall`` /
``current`` / ``touch`` / ``section``), the same contract in the same
words. Exit codes and heartbeats catch dead processes; they cannot catch
a process frozen inside a device wait — on a card, the main thread
blocked in ``torch.cuda.synchronize()`` or a tensor's ``.item()`` behind
a kernel that does not finish. The process is alive and stamps nothing
unusual. The watchdog closes that gap in-process:

* the serving step (or any caller) calls :func:`touch` per unit of
  progress — a ~free global-None check when no watchdog is installed;
* long-latency regions mark themselves with :func:`section` (the
  engine's ``serving.step`` / ``serving.prefill`` / ``serving.decode``),
  so the hang report says *where* the process froze, not just that it
  froze;
* a daemon thread checks the last tick; past ``timeout`` it fires ONCE:
  builds a diagnosis (stalled duration, active section, stack dump of
  every thread via ``sys._current_frames``), hands it to ``on_hang``
  (default: print to stderr), and — with ``fatal=True`` — exits the
  process with :data:`HUNG_EXIT_RC`.

The watch thread needs the GIL to run. PyTorch's CUDA bindings release
it around the blocking waits (``synchronize``, the device-to-host copy
under ``.item()``), so the watchdog fires while the main thread is still
blocked there; the engine supervisor then treats the trip as a crash
once the wait returns.
"""

from __future__ import annotations

import os
import sys
import threading
import time
import traceback
from typing import Callable, Optional

__all__ = ["HangWatchdog", "WatchdogAlarm", "install", "uninstall", "touch",
           "section", "current", "HUNG_EXIT_RC"]

HUNG_EXIT_RC = 98   # process self-terminated: progress stalled past timeout


class WatchdogAlarm(RuntimeError):
    """Raised by wait()-style consumers when the watchdog fired."""


class HangWatchdog:
    def __init__(self, timeout: float, name: str = "run",
                 on_hang: Optional[Callable[[str], None]] = None,
                 fatal: bool = False, poll: Optional[float] = None,
                 exit_code: int = HUNG_EXIT_RC):
        self.timeout = float(timeout)
        self.name = name
        self.on_hang = on_hang
        self.fatal = bool(fatal)
        self.exit_code = int(exit_code)
        self.fired = threading.Event()
        self.diagnosis: Optional[str] = None
        self._last = time.monotonic()
        # per-thread active sections: tid -> (label, since). Concurrent
        # threads (train loop vs async checkpoint writer) must not clobber
        # each other's region markers — the diagnosis reports all of them.
        self._sections: dict = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._poll = poll if poll is not None else max(0.05,
                                                       self.timeout / 4.0)
        self._thread = threading.Thread(target=self._watch, daemon=True,
                                        name=f"hang-watchdog-{name}")
        self._thread.start()

    # -- progress ------------------------------------------------------------
    def tick(self):
        self._last = time.monotonic()

    def section(self, label: str):
        """Mark a long-latency region (e.g. one collective): the hang
        report names it. Entry and exit both count as progress. Sections
        nest per thread; concurrent threads keep independent markers."""
        return _Section(self, label)

    # -- the watch loop ------------------------------------------------------
    def _watch(self):
        while not self._stop.wait(self._poll):
            stalled = time.monotonic() - self._last
            if stalled < self.timeout or self.fired.is_set():
                continue
            self.diagnosis = self._diagnose(stalled)
            self.fired.set()
            try:
                if self.on_hang is not None:
                    self.on_hang(self.diagnosis)
                else:
                    print(self.diagnosis, file=sys.stderr)
                    sys.stderr.flush()
            finally:
                if self.fatal:
                    os._exit(self.exit_code)
            return   # report once; a fired non-fatal watchdog stands down

    def _diagnose(self, stalled: float) -> str:
        with self._lock:
            secs = dict(self._sections)
        names = {t.ident: t.name for t in threading.enumerate()}
        now = time.monotonic()
        where = ""
        if secs:
            parts = [f"'{label}' ({names.get(tid, tid)}, entered "
                     f"{now - since:.1f}s ago)"
                     for tid, (label, since) in secs.items()]
            where = " inside " + ", ".join(parts)
        lines = [f"[health] hang watchdog '{self.name}': no progress for "
                 f"{stalled:.1f}s (timeout {self.timeout}s){where}. "
                 f"Thread stacks:"]
        frames = sys._current_frames()
        for t in threading.enumerate():
            f = frames.get(t.ident)
            if f is None or t is self._thread:
                continue
            lines.append(f"--- {t.name} ---")
            lines.extend(l.rstrip() for l in traceback.format_stack(f))
        return "\n".join(lines)

    # -- lifecycle -----------------------------------------------------------
    def check(self):
        """Raise :class:`WatchdogAlarm` if the watchdog fired (for callers
        that poll instead of installing a callback)."""
        if self.fired.is_set():
            raise WatchdogAlarm(self.diagnosis)

    def stop(self, join_timeout: float = 2.0):
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=join_timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()
        return False


class _Section:
    """Per-use region marker (module-level: section() sits on the
    per-collective hot path — no per-call class creation)."""

    __slots__ = ("_wd", "_label", "_tid", "_prev")

    def __init__(self, wd: HangWatchdog, label: str):
        self._wd = wd
        self._label = label

    def __enter__(self):
        wd = self._wd
        wd.tick()
        self._tid = threading.get_ident()
        with wd._lock:
            self._prev = wd._sections.get(self._tid)
            wd._sections[self._tid] = (self._label, time.monotonic())
        return self

    def __exit__(self, *exc):
        wd = self._wd
        with wd._lock:
            if self._prev is None:
                wd._sections.pop(self._tid, None)
            else:
                wd._sections[self._tid] = self._prev
        wd.tick()
        return False


# ---------------------------------------------------------------------------
# process-global watchdog: touch()/section() are called from hot paths
# (train step, DataLoader, collectives) and must cost a None-check when off
# ---------------------------------------------------------------------------

_global: Optional[HangWatchdog] = None
_lock = threading.Lock()


def install(timeout: Optional[float] = None, **kwargs) -> HangWatchdog:
    """Install the process watchdog (idempotent per timeout). ``timeout``
    defaults to ``FLAGS_health_watchdog_timeout_s``; a value <= 0 is a
    no-op returning None (the flag's off state)."""
    global _global
    if timeout is None:
        from ..flags import flag
        timeout = float(flag("FLAGS_health_watchdog_timeout_s", 0.0))
    if not timeout or timeout <= 0:
        return None
    with _lock:
        if _global is not None:
            _global.stop()
        _global = HangWatchdog(timeout, **kwargs)
        return _global


def uninstall():
    global _global
    with _lock:
        if _global is not None:
            _global.stop()
            _global = None


def current() -> Optional[HangWatchdog]:
    return _global


def touch():
    wd = _global
    if wd is not None:
        wd.tick()


class _NullSection:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _NullSection()


def section(label: str):
    """Mark a long-latency region on the global watchdog (no-op when none
    is installed)."""
    wd = _global
    return _NULL if wd is None else wd.section(label)

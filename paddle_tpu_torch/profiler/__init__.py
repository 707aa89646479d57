"""``paddle.profiler`` — counterpart of ``paddle_tpu/profiler``.

Parity target: ``python/paddle/profiler/profiler.py`` in the reference
(Profiler with targets, ``make_scheduler`` step states, RecordEvent host
spans, chrome-trace export; the CUPTI device tracer). The port's device
side is ``torch.profiler`` (CUPTI on the card): a RECORD window runs a
``torch.profiler.profile`` over the CPU and, for a GPU target on a host
with a card, CUDA activities; ``export_chrome_tracing`` writes its
chrome trace, which :func:`load_profiler_result` reads back. Host spans
(:class:`RecordEvent`, :func:`annotate`) are
``torch.profiler.record_function`` ranges, plus a wall-clock aggregator
for ``summary()``.
"""

from __future__ import annotations

import contextlib
import enum
import json
import os
import time
from collections import defaultdict
from typing import Callable, Iterable, Optional

import torch

__all__ = ["Profiler", "ProfilerTarget", "ProfilerState", "RecordEvent",
           "make_scheduler", "export_chrome_tracing", "load_profiler_result",
           "SummaryView", "annotate"]


def annotate(name: str):
    """A profiling span gated by ``FLAGS_profile_annotations``, free when
    off.

    The perf layer (the fused train step, ``jit_step``, hapi's jit step)
    wraps its stages in ``annotate("step")`` so a trace shows where host
    time goes without any code changes — flip the flag on and trace. Off
    (the default) this returns a nullcontext; on, a
    ``torch.profiler.record_function`` range."""
    from ..flags import flag
    if not flag("FLAGS_profile_annotations"):
        return contextlib.nullcontext()
    return torch.profiler.record_function(name)


class ProfilerTarget(enum.Enum):
    CPU = 0
    GPU = 1
    XPU = 2
    CUSTOM_DEVICE = 3
    TPU = 4


class ProfilerState(enum.Enum):
    CLOSED = 0
    READY = 1
    RECORD = 2
    RECORD_AND_RETURN = 3


class SummaryView(enum.Enum):
    DeviceView = 0
    OverView = 1
    ModelView = 2
    DistributedView = 3
    KernelView = 4
    OperatorView = 5
    MemoryView = 6
    MemoryManipulationView = 7
    UDFView = 8


def make_scheduler(*, closed: int, ready: int, record: int, repeat: int = 0,
                   skip_first: int = 0) -> Callable[[int], ProfilerState]:
    """Step-state schedule (reference semantics): skip_first, then cycles
    of closed/ready/record with RECORD_AND_RETURN closing each cycle."""
    cycle = closed + ready + record

    def schedule(step: int) -> ProfilerState:
        if step < skip_first:
            return ProfilerState.CLOSED
        s = step - skip_first
        if repeat and s >= repeat * cycle:
            return ProfilerState.CLOSED
        pos = s % cycle
        if pos < closed:
            return ProfilerState.CLOSED
        if pos < closed + ready:
            return ProfilerState.READY
        if pos == cycle - 1:
            return ProfilerState.RECORD_AND_RETURN
        return ProfilerState.RECORD
    return schedule


def _default_schedule(step: int) -> ProfilerState:
    return ProfilerState.RECORD


def export_chrome_tracing(dir_name: str, worker_name: Optional[str] = None):
    """on_trace_ready callback: write the last RECORD window's chrome
    trace into ``dir_name`` (``<worker>.pt.trace.json``; open it in
    Perfetto or chrome://tracing)."""
    def handler(prof: "Profiler"):
        os.makedirs(dir_name, exist_ok=True)
        name = worker_name or f"host_{os.getpid()}"
        path = os.path.join(dir_name, f"{name}.pt.trace.json")
        if prof._last is not None and prof._last is not prof._exported:
            prof._last.export_chrome_trace(path)
            prof._exported = prof._last
            prof._last_export = path
        prof._last_export_dir = dir_name
    return handler


def export_protobuf(dir_name: str, worker_name: Optional[str] = None):
    return export_chrome_tracing(dir_name, worker_name)


def load_profiler_result(path: str):
    """The chrome trace :func:`export_chrome_tracing` wrote, as a dict
    (``traceEvents`` and the trace's metadata)."""
    with open(path) as f:
        return json.load(f)


# -- host-side spans ---------------------------------------------------------

_host_stats = defaultdict(lambda: [0, 0.0])  # name -> [count, total_s]
_collecting = False


class RecordEvent:
    """Host span (ref: paddle.profiler.RecordEvent): a
    ``torch.profiler.record_function`` range in the trace, and a line of
    ``Profiler.summary()``'s aggregates."""

    def __init__(self, name: str, event_type=None):
        self.name = name
        self._rf = None
        self._t0 = None

    def begin(self):
        self._rf = torch.profiler.record_function(self.name)
        self._rf.__enter__()
        self._t0 = time.perf_counter()

    def end(self):
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
            if _collecting and self._t0 is not None:
                st = _host_stats[self.name]
                st[0] += 1
                st[1] += time.perf_counter() - self._t0
            self._rf = None

    def __enter__(self):
        self.begin()
        return self

    def __exit__(self, *exc):
        self.end()
        return False


class Profiler:
    """ref: paddle.profiler.Profiler(targets, scheduler, on_trace_ready).

    ``step()`` drives the scheduler; RECORD states run under a
    ``torch.profiler.profile`` over the targets' activities."""

    def __init__(self, *, targets: Optional[Iterable] = None, scheduler=None,
                 on_trace_ready: Optional[Callable] = None,
                 timer_only: bool = False, record_shapes: bool = False,
                 profile_memory: bool = False, with_flops: bool = False,
                 trace_dir: str = "./profiler_log"):
        self.targets = list(targets or [ProfilerTarget.CPU])
        if scheduler is None:
            self.scheduler = _default_schedule
        elif callable(scheduler):
            self.scheduler = scheduler
        elif isinstance(scheduler, (tuple, list)) and len(scheduler) == 2:
            lo, hi = scheduler
            self.scheduler = make_scheduler(closed=max(0, lo), ready=0,
                                            record=hi - lo, repeat=1)
        else:
            raise ValueError(f"unsupported scheduler: {scheduler!r}")
        self.on_trace_ready = on_trace_ready
        self.timer_only = timer_only
        self.trace_dir = trace_dir
        self._record_shapes = record_shapes
        self._profile_memory = profile_memory
        self._with_flops = with_flops
        self._last_export_dir = None
        self._last_export = None
        self.step_num = 0
        self.current_state = ProfilerState.CLOSED
        self._tracing = None        # the running torch profile
        self._last = None           # the last finished one
        self._exported = None       # the last one exported
        self._step_t0 = None
        self._step_times = []

    def _activities(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if ProfilerTarget.GPU in self.targets and torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        return acts

    # -- lifecycle -----------------------------------------------------------
    def start(self):
        global _collecting
        _collecting = True
        self.current_state = self.scheduler(self.step_num)
        self._maybe_toggle_trace()
        self._step_t0 = time.perf_counter()

    def stop(self):
        global _collecting
        if self._tracing is not None:
            self._stop_trace()
        _collecting = False
        if self.on_trace_ready is not None:
            self.on_trace_ready(self)

    def step(self, num_samples: Optional[int] = None):
        if self._step_t0 is not None:
            self._step_times.append(time.perf_counter() - self._step_t0)
        self.step_num += 1
        prev = self.current_state
        self.current_state = self.scheduler(self.step_num)
        if prev != self.current_state:
            self._maybe_toggle_trace()
            if prev == ProfilerState.RECORD_AND_RETURN and \
                    self.on_trace_ready is not None:
                self.on_trace_ready(self)
        self._step_t0 = time.perf_counter()

    def _maybe_toggle_trace(self):
        want = self.current_state in (ProfilerState.RECORD,
                                      ProfilerState.RECORD_AND_RETURN)
        if want and self._tracing is None and not self.timer_only:
            self._start_trace()
        elif not want and self._tracing is not None:
            self._stop_trace()

    def _start_trace(self):
        os.makedirs(self.trace_dir, exist_ok=True)
        prof = torch.profiler.profile(
            activities=self._activities(), record_shapes=self._record_shapes,
            profile_memory=self._profile_memory, with_flops=self._with_flops)
        prof.__enter__()
        self._tracing = prof

    def _stop_trace(self):
        prof, self._tracing = self._tracing, None
        prof.__exit__(None, None, None)
        self._last = prof

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()
        return False

    # -- reporting -----------------------------------------------------------
    def summary(self, sorted_by=None, op_detail=True, thread_sep=False,
                time_unit="ms", views=None):
        lines = ["-" * 64,
                 f"paddle_tpu_torch profiler summary ({self.step_num} steps)"]
        if self._step_times:
            import numpy as np
            ts = np.asarray(self._step_times) * 1e3
            lines.append(f"step time ms: avg {ts.mean():.2f}  min "
                         f"{ts.min():.2f}  max {ts.max():.2f}")
        if _host_stats:
            lines.append(f"{'host span':<40}{'calls':>8}{'total ms':>12}")
            for name, (cnt, tot) in sorted(_host_stats.items(),
                                           key=lambda kv: -kv[1][1]):
                lines.append(f"{name:<40}{cnt:>8}{tot * 1e3:>12.2f}")
        if self._last_export:
            lines.append(f"chrome trace: {self._last_export}")
        lines.append("-" * 64)
        out = "\n".join(lines)
        print(out)
        return out

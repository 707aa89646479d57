"""The port's ``paddle.profiler`` against the JAX package's:
``tests/test_surface.py``'s ``TestProfiler`` cases — ``make_scheduler``'s
step states, ``RecordEvent`` and ``Profiler`` start, step and stop — run
through both packages, plus the port's chrome-trace export
(``export_chrome_tracing`` / ``load_profiler_result`` over
``torch.profiler``; the JAX package writes an XPlane dump and cannot load
one back).
"""

import os

import numpy as np
import pytest

import paddle_tpu as J
import paddle_tpu_torch as T

BOTH = pytest.mark.parametrize("P", [J, T], ids=["jax", "torch"])


@pytest.fixture(autouse=True)
def _port_on_cpu():
    prev = T.get_device()
    T.set_device("cpu")
    yield
    T.set_device(prev)


@pytest.mark.parametrize("kw", [
    dict(closed=1, ready=1, record=2, repeat=1),
    dict(closed=0, ready=0, record=3),
    dict(closed=2, ready=1, record=1, repeat=2, skip_first=3),
])
def test_scheduler_states_equal(kw):
    sj = J.profiler.make_scheduler(**kw)
    st = T.profiler.make_scheduler(**kw)
    assert [sj(i).name for i in range(14)] == [st(i).name for i in range(14)]


@BOTH
def test_scheduler_states(P):
    sched = P.profiler.make_scheduler(closed=1, ready=1, record=2, repeat=1)
    S = P.profiler.ProfilerState
    assert [sched(i) for i in range(4)] == [S.CLOSED, S.READY, S.RECORD,
                                            S.RECORD_AND_RETURN]
    assert sched(4) == S.CLOSED  # repeat exhausted


@BOTH
def test_profiler_timer_only(P, tmp_path):
    p = P.profiler.Profiler(timer_only=True, trace_dir=str(tmp_path))
    p.start()
    for _ in range(3):
        with P.profiler.RecordEvent("host_span"):
            pass
        p.step()
    p.stop()
    assert "host_span" in p.summary()
    assert p.step_num == 3


@BOTH
def test_record_event_standalone(P):
    ev = P.profiler.RecordEvent("manual")
    ev.begin()
    ev.end()


def test_profiler_steps_and_chrome_trace(tmp_path):
    """A scheduled Profiler records its RECORD window into a chrome trace
    that ``load_profiler_result`` reads back: the RecordEvent spans and
    the ops of the recorded steps are in it, and the step states follow
    the JAX package's Profiler."""
    states = {}
    for P in (J, T):
        seen = []
        handler = P.profiler.export_chrome_tracing(str(tmp_path / P.__name__))
        prof = P.profiler.Profiler(
            scheduler=P.profiler.make_scheduler(closed=1, ready=0, record=2,
                                                repeat=1),
            on_trace_ready=handler, trace_dir=str(tmp_path / "xla"))
        prof.start()
        for i in range(4):
            seen.append(prof.current_state.name)
            with P.profiler.RecordEvent(f"span{i}"):
                (P.to_tensor(np.ones((4, 4), np.float32)) * 2.0).sum()
            prof.step()
        prof.stop()
        states[P] = seen
    assert states[T] == states[J]
    path = prof._last_export
    assert path and os.path.exists(path)
    trace = T.profiler.load_profiler_result(path)
    names = {e.get("name") for e in trace["traceEvents"]}
    assert {"span1", "span2"} <= names
    assert "span0" not in names and "span3" not in names

"""Functionalization machinery for ``paddle.jit.to_static`` — counterpart
of ``paddle_tpu/jit/trace.py``.

The reference turns an imperative step into one XLA executable: a
discovery trace finds the step's implicit state (every pre-existing
Tensor it reads or writes: parameters, optimizer accumulators, master
weights, BatchNorm statistics, the sentinel's EMA), the host scalars it
reads (the optimizer's lr) and whether it draws random numbers; a second
trace binds all of that as the inputs and outputs of one ``jax.jit``
function. The port captures the same step into one CUDA graph:

* **Capture.** The function runs once inside ``torch.cuda.CUDAGraph``
  capture on a side stream, over static buffers: an input buffer per
  Tensor argument, the state Tensors' own values, one device scalar per
  host scalar (:meth:`TraceContext.host_scalar`, refilled before every
  replay) and the port's per-device generator, registered with the graph
  so every replay draws fresh numbers. While it runs, ``Tensor._value``
  is watched (``core.tensor.watch_values``): the first touch of a
  pre-existing Tensor makes it state, and a write that rebinds a state
  Tensor (Adam's moments, the master weight, a BatchNorm statistic) is
  copied back into the buffer the next replay reads — at once when the
  program donates its state (the counterpart of XLA's donation: no second
  copy of the state is live), else at the end of the step. Parameters are
  written in place by the optimizers and need no copy. The capture
  executes nothing; a host read of a tensor (``bool``, ``item``, ...)
  raises :class:`HostReadError`, the counterpart of JAX's
  ``TracerBoolConversionError``, on which ``to_static`` retries through
  dy2static.
* **Replay.** A call copies its inputs into the input buffers, copies any
  state the user rebound since (``set_value``, ``set_state_dict``:
  the Tensor's value is no longer its buffer, or its version moved) into
  its buffer, refills the host scalars and replays the graph. The kernel
  wrappers do not run during a replay, so the program adds the launch
  counts the capture recorded to every wrapper's counter. Outputs are
  cloned out of the graph's memory; gradients the step left on state
  Tensors are re-attached.
* **On the CPU** (which only the tests ask for) the same program records
  the step instead (:class:`_CpuGraph`: every ATen operation the step
  dispatches, in order, with the tensors it read and wrote) and replays
  the recording, so the binding, the write-back, the host scalars and the
  fresh random draws are exercised there as on the card: Python does not
  run again, and a value the step read on the host is baked into the
  recording as it would be into a graph.

A ``while_loop`` on a tensor predicate cannot live in one graph: inside a
capture it ends the current graph, captures its prologue (the carry and
the first predicate) and its body (the new carry and the next predicate)
as graphs of their own, and the replay reads the predicate on the host
before each trip (:meth:`TraceContext.while_loop`).
"""

from __future__ import annotations

import contextlib
import gc
import threading
import warnings
import weakref
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.utils._pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from ..core import tensor as _tensor_mod
from ..core.place import torch_device
from ..core.tensor import (Tensor, _wrap, raw_value, set_raw_value,
                           watch_values)

__all__ = ["HostReadError", "TraceContext", "activate", "current_ctx",
           "CompiledProgram", "build_program", "capture_stream"]


class HostReadError(RuntimeError):
    """A tensor's value was read on the host (``bool``, ``int``,
    ``float``, ``item``, ``numpy``) inside a captured program: the graph
    cannot branch on a value it has not computed yet (JAX's
    ``TracerBoolConversionError``)."""


class StaleProgram(Exception):
    """A state Tensor changed shape, dtype or device since the capture:
    the caller captures the function again."""


_local = threading.local()


def current_ctx() -> Optional["TraceContext"]:
    """The capture running on this thread, or None."""
    return getattr(_local, "ctx", None)


@contextlib.contextmanager
def activate(ctx):
    prev = current_ctx()
    _local.ctx = ctx
    try:
        yield ctx
    finally:
        _local.ctx = prev


def flatten(tree):
    """Leaves (port Tensors are leaves) and the tree's spec."""
    return pytree.tree_flatten(tree)


_streams: Dict[str, Any] = {}


def capture_stream(device: torch.device):
    """The side stream warm-ups and captures run on (PyTorch's rule:
    warm up on a side stream, then capture), one per device."""
    key = str(device)
    s = _streams.get(key)
    if s is None:
        s = _streams[key] = torch.cuda.Stream(device=device)
    return s


@contextlib.contextmanager
def on_capture_stream(device: torch.device):
    """Run the block on :func:`capture_stream` ordered after and before
    the current stream's work."""
    main = torch.cuda.current_stream(device)
    side = capture_stream(device)
    side.wait_stream(main)
    with torch.cuda.stream(side):
        yield side
    main.wait_stream(side)


# ---------------------------------------------------------------------------
# the capture's bookkeeping
# ---------------------------------------------------------------------------

class TraceContext:
    """What one capture sees: the state Tensors and their buffers, the
    writes to them, the host scalars and the Tensors it created."""

    def __init__(self, program: "CompiledProgram", immediate: bool):
        self.program = program
        self.immediate = immediate
        self.tid = threading.get_ident()
        self.seen: set = set()
        self.created: set = set()
        self.created_refs: List[Any] = []
        # id -> [tensor, buffer, version at first touch]
        self.state: Dict[int, list] = {}
        self.saved: Dict[int, Tuple[torch.Tensor, int]] = {}
        self.written: Dict[int, Tensor] = {}
        self.stashed_grads: List[Tuple[torch.Tensor, torch.Tensor]] = []
        self.hosts: Dict[Any, Tuple[Callable, torch.Tensor]] = {}

    # -- the value watch ----------------------------------------------------
    def _touch(self, t: Tensor, v: torch.Tensor):
        self.seen.add(id(t))
        self.state[id(t)] = [t, v, t._version]
        # a compiled call's gradients are that call's (the reference binds
        # every state gradient to None inside the trace): a gradient left
        # from before would otherwise be accumulated into on every replay
        if v.is_leaf and v.requires_grad and v.grad is not None:
            self.stashed_grads.append((v, v.grad))
            v.grad = None

    def on_read(self, t: Tensor, v: torch.Tensor):
        if id(t) in self.seen or threading.get_ident() != self.tid:
            return
        self._touch(t, v)

    def on_write(self, t: Tensor, v: torch.Tensor) -> torch.Tensor:
        if threading.get_ident() != self.tid:
            return v
        i = id(t)
        try:
            old = raw_value(t)
        except AttributeError:          # a Tensor being built
            self.seen.add(i)
            self.created.add(i)
            self.created_refs.append(weakref.ref(t))
            return v
        if i in self.created:
            return v
        if i not in self.seen:
            self._touch(t, old)
        if i not in self.saved:
            self.saved[i] = (old, t._version)
        self.written[i] = t
        if not self.immediate:
            return v
        buf = self.state[i][1]
        if v is not buf:
            _copy_into(buf, v, t)
        return buf

    def write_back(self):
        """Copy every rebound state value into its buffer (the end-of-step
        write-back of a program that does not donate its state)."""
        for i, t in self.written.items():
            buf = self.state[i][1]
            v = raw_value(t)
            if v is not buf:
                _copy_into(buf, v, t)
                set_raw_value(t, buf)

    def restore(self):
        """Undo the capture's Python-side effects on the state."""
        for i, (old, ver) in self.saved.items():
            t = self.state[i][0]
            set_raw_value(t, old)
            t._version = ver
        for v, g in self.stashed_grads:
            v.grad = g

    # -- host scalars ---------------------------------------------------------
    def host_scalar(self, tag, provider: Callable[[], float]) -> torch.Tensor:
        """A float64 device scalar holding ``provider()``, refilled before
        every replay (the optimizer's lr): what the step reads must not be
        baked into the graph."""
        h = self.hosts.get(tag)
        if h is None:
            buf = self.program._host_buffer(float(provider()))
            h = self.hosts[tag] = (provider, buf)
        return h[1]

    # -- control flow -------------------------------------------------------
    def while_loop(self, cond_fn, body_fn, loop_vars):
        return self.program._while_loop(cond_fn, body_fn, loop_vars)


def _copy_into(buf: torch.Tensor, v: torch.Tensor, t: Tensor):
    if v.shape != buf.shape or v.dtype != buf.dtype or \
            v.device != buf.device:
        raise RuntimeError(
            f"to_static: the step changed state tensor {t.name!r} from "
            f"{tuple(buf.shape)} {buf.dtype} on {buf.device} to "
            f"{tuple(v.shape)} {v.dtype} on {v.device}; a compiled step "
            "keeps every state tensor's shape, dtype and device")
    with torch.no_grad():
        buf.copy_(v)


def _host_read(kind, t, read):
    raise HostReadError(
        f"to_static: a tensor was read on the host ({kind}) inside a "
        "captured program; data-dependent Python control flow cannot be "
        "captured. Use paddle_tpu_torch.jit.cond / while_loop / scan, or "
        "to_static(backend='sot')")


@contextlib.contextmanager
def _materialize_guard(hook):
    prev = _tensor_mod._materialize_hook
    _tensor_mod._materialize_hook = hook
    try:
        yield
    finally:
        _tensor_mod._materialize_hook = prev


def _is_capture_error(e: BaseException) -> bool:
    msg = str(e)
    return ("is capturing" in msg or "during capture" in msg
            or "cudaErrorStreamCapture" in msg)


# ---------------------------------------------------------------------------
# the CPU's graph: a recording of the ATen operations a step dispatches
# ---------------------------------------------------------------------------

def _aten(*names):
    out = set()
    for n in names:
        op, _, overload = n.partition(".")
        packet = getattr(torch.ops.aten, op, None)
        fn = getattr(packet, overload or "default", None) \
            if packet is not None else None
        if fn is not None:
            out.add(fn)
    return frozenset(out)


# operations that read a value on the host or size their output by the data:
# a CUDA graph cannot hold them
_HOST_OPS = _aten("_local_scalar_dense", "is_nonzero", "equal", "allclose",
                  "nonzero", "masked_select", "_unique2", "unique_dim",
                  "unique_consecutive")
_EMPTY_OPS = _aten("empty.memory_format", "empty_like", "empty_strided",
                   "new_empty", "new_empty_strided")


def _mutated(func, args, kwargs):
    """The tensors ``func`` writes (its ``(a!)`` arguments)."""
    out = []
    for i, a in enumerate(func._schema.arguments):
        if a.alias_info is None or not a.alias_info.is_write:
            continue
        v = args[i] if i < len(args) else kwargs.get(a.name)
        if isinstance(v, torch.Tensor):
            out.append(v)
        elif isinstance(v, (list, tuple)):
            out.extend(x for x in v if isinstance(x, torch.Tensor))
    return out


class _Recorder(TorchDispatchMode):
    def __init__(self, graph: "_CpuGraph"):
        super().__init__()
        self.graph = graph

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        g = self.graph
        if func in _HOST_OPS:
            raise HostReadError(
                f"to_static: {func} reads a tensor on the host (or sizes "
                "its output by the data) inside a captured program")
        for a in _mutated(func, args, kwargs):
            if id(a) not in g.created and id(a) not in g.saved:
                g.saved[id(a)] = (a, a.detach().clone())
        out = func(*args, **kwargs)
        rets = func._schema.returns
        outs = [o for o in pytree.tree_leaves(out)
                if isinstance(o, torch.Tensor)]
        for o in outs:
            g.created.add(id(o))
        if func in _EMPTY_OPS:
            g.keep.append(out)
        elif rets and all(r.alias_info is not None for r in rets):
            if any(r.alias_info.is_write for r in rets):
                g.ops.append((func, args, kwargs, None))   # in place
            # a view reads its base's memory: nothing to replay
        else:
            g.ops.append((func, args, kwargs, outs))
        return out


class _CpuGraph:
    """The CPU's stand-in for a captured CUDA graph: ``begin`` / ``end``
    record every ATen operation in between (executing it), ``replay``
    runs the recording again writing each result into the tensor the
    recording produced, so later operations find it where they read it.
    In-place operations write their arguments again; views need nothing.
    """

    def __init__(self):
        self.ops: List[tuple] = []
        self.keep: List[Any] = []
        self.created: set = set()
        self.saved: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}
        self._mode = None

    def begin(self):
        self._mode = _Recorder(self)
        self._mode.__enter__()

    def end(self, undo=False):
        """End the recording; ``undo`` copies back what it wrote to tensors
        that existed before it (the recording then only recorded)."""
        self._mode.__exit__(None, None, None)
        self._mode = None
        if undo:
            self._undo()
        self.saved = {}

    def _undo(self):
        with torch.no_grad():
            for a, snap in self.saved.values():
                a.copy_(snap)

    def abort(self):
        """End the recording and undo the writes it made to tensors that
        existed before it (a CUDA capture executes nothing)."""
        if self._mode is not None:
            self._mode.__exit__(None, None, None)
            self._mode = None
        self._undo()
        self.saved = {}

    @contextlib.contextmanager
    def paused(self):
        if self._mode is None:
            yield
            return
        self._mode.__exit__(None, None, None)
        try:
            yield
        finally:
            self._mode.__enter__()

    def replay(self):
        with torch.no_grad():
            for func, args, kwargs, outs in self.ops:
                res = func(*args, **kwargs)
                if outs is None:
                    continue
                for o, r in zip(outs, (x for x in pytree.tree_leaves(res)
                                       if isinstance(x, torch.Tensor))):
                    if r.data_ptr() != o.data_ptr() or r.shape != o.shape:
                        o.copy_(r)


# ---------------------------------------------------------------------------
# the program
# ---------------------------------------------------------------------------

_MAX_HOST_SCALARS = 16


class CompiledProgram:
    """One captured (signature-specialized) program: the graph and the
    plan that binds the state to it (the reference's ConcreteProgram and
    ``run_program``). Build with :func:`build_program`."""

    def __init__(self, fn, args, kwargs, donate_states=False, run=True):
        self._fn = fn
        self._run = run
        self._donate = bool(donate_states)
        leaves, self._in_tree = flatten((args, kwargs))
        self._tensor_pos = [i for i, l in enumerate(leaves)
                            if isinstance(l, Tensor)]
        self._static_leaves = [None if isinstance(l, Tensor) else l
                               for l in leaves]
        self._arg_meta = [(bool(leaves[i].stop_gradient), leaves[i].name)
                          for i in self._tensor_pos]
        vals = [leaves[i]._value for i in self._tensor_pos]
        self.device = vals[0].device if vals else torch_device()
        self.cuda = self.device.type == "cuda"
        with torch.no_grad():
            self._in_bufs = [v.detach().clone() for v in vals]
        for buf, (sg, _) in zip(self._in_bufs, self._arg_meta):
            if not sg and buf.is_floating_point():
                buf.requires_grad_(True)
        # ("graph", graph, launch-count delta) and
        # ("loop", body graph, predicate buffer, body's delta)
        self._steps: List[tuple] = []
        self._cur = None
        self._cur_counts = None
        self._pool = None
        self._in_body = False
        # the host scalars' device memory, made before the capture: a
        # buffer the graph's pool handed out mid-capture may be the
        # scratch of an earlier operation of the same graph, which would
        # overwrite the value filled in before the replay
        self._host_store = torch.zeros(_MAX_HOST_SCALARS,
                                       dtype=torch.float64,
                                       device=self.device) \
            if self.cuda else None
        self._n_hosts = 0
        self._capture()

    # -- segments -----------------------------------------------------------
    def _begin_segment(self):
        from ..kernels import launch_counts
        self._cur_counts = launch_counts()
        if self.cuda:
            from ..ops.random import generator
            g = torch.cuda.CUDAGraph()
            g.register_generator_state(generator(self.device))
            g.capture_begin(pool=self._pool,
                            capture_error_mode="thread_local")
        else:
            g = _CpuGraph()
            g.begin()
        self._cur = g

    def _end_segment(self, append=True):
        from ..kernels import count_delta, launch_counts, set_launch_counts
        g, self._cur = self._cur, None
        if self.cuda:
            with warnings.catch_warnings():
                # a segment may hold no kernel (a while_loop at the end of
                # the step): its graph replays as a no-op
                warnings.filterwarnings("ignore", "The CUDA Graph is empty")
                g.capture_end()
            if self._pool is None:
                self._pool = g.pool()
        else:
            g.end(undo=not self._run)
        delta = count_delta(self._cur_counts, launch_counts())
        if self.cuda:                   # the capture launched nothing
            set_launch_counts(self._cur_counts)
        step = ("graph", g, delta)
        if append:
            self._steps.append(step)
        return step

    def _abort_segment(self):
        from ..kernels import set_launch_counts
        g, self._cur = self._cur, None
        if g is None:
            return
        if self.cuda:
            try:
                g.capture_end()
            except Exception:
                pass
            set_launch_counts(self._cur_counts)
        else:
            g.abort()

    @contextlib.contextmanager
    def _untraced(self):
        """Run host-side set-up inside a CPU recording without recording
        it (a CUDA capture only allocates there)."""
        if not self.cuda and self._cur is not None:
            with self._cur.paused():
                yield
        else:
            yield

    def _host_buffer(self, value: float) -> torch.Tensor:
        if self.cuda:           # a slot of the store, filled before replays
            if self._n_hosts == _MAX_HOST_SCALARS:
                raise RuntimeError(f"to_static: more than "
                                   f"{_MAX_HOST_SCALARS} host scalars in "
                                   "one program")
            self._n_hosts += 1
            return self._host_store[self._n_hosts - 1]
        with self._untraced():
            return torch.full((), value, dtype=torch.float64,
                              device=self.device)

    # -- capture ------------------------------------------------------------
    def _rebuild(self):
        leaves = list(self._static_leaves)
        for pos, buf, (sg, name) in zip(self._tensor_pos, self._in_bufs,
                                        self._arg_meta):
            t = _wrap(buf, name=name)
            t._sg = sg
            leaves[pos] = t
        return pytree.tree_unflatten(leaves, self._in_tree)

    def _capture(self):
        ctx = TraceContext(self, immediate=self._donate)
        stream = on_capture_stream(self.device) if self.cuda \
            else contextlib.nullcontext()
        if self.cuda:
            torch.cuda.synchronize(self.device)
        with stream, watch_values(ctx), activate(ctx), \
                _materialize_guard(_host_read):
            try:
                self._begin_segment()
                out_ids = self._run_fn(ctx)
                self._end_segment()
            except BaseException as e:
                self._abort_segment()
                ctx.restore()
                if self.cuda and _is_capture_error(e):
                    raise HostReadError(
                        f"to_static: the step did something a CUDA graph "
                        f"cannot hold ({e})") from e
                raise
        self._check_escaped(ctx, out_ids)
        self._state = [(t, buf) for t, buf, _ in ctx.state.values()]
        self._versions = [t._version for t, _ in self._state]
        self._written = [t for t, buf, ver in ctx.state.values()
                         if id(t) in ctx.written or t._version != ver]
        self._hosts = list(ctx.hosts.values())
        self._grad_slots = [(buf, buf.grad) for _, buf in self._state
                            if buf.is_leaf and buf.grad is not None]

    def _run_fn(self, ctx) -> set:
        """The function on the input buffers; keeps its outputs' values and
        returns the ids of the output Tensors (its locals die with it, so
        only what the step stored elsewhere outlives the capture)."""
        call_args, call_kwargs = self._rebuild()
        out = self._fn(*call_args, **call_kwargs)
        if not ctx.immediate:
            ctx.write_back()
        out_leaves, self._out_tree = flatten(out)
        self._out_is_tensor = [isinstance(l, Tensor) for l in out_leaves]
        self._out_vals = [raw_value(l).detach() if isinstance(l, Tensor)
                          else l for l in out_leaves]
        return {id(l) for l in out_leaves}

    @staticmethod
    def _check_escaped(ctx, out_ids):
        """Tensors the capture created that are still alive, other than
        the outputs, were stored into long-lived objects (state created
        lazily inside the step): a graph cannot carry them. One eager
        call first creates such state with real values (StaticFunction
        does this)."""
        gc.collect()
        escaped = [t.name for t in (r() for r in ctx.created_refs)
                   if t is not None and id(t) not in out_ids
                   and "_grad_of" not in t.__dict__]
        if escaped:
            raise RuntimeError(
                "to_static: state was lazily created during the capture "
                f"and escaped it ({escaped[:5]}...). Run the function "
                "eagerly once before compiling (StaticFunction's first "
                "call does this automatically).")

    # -- while_loop inside a capture ----------------------------------------
    def _while_loop(self, cond_fn, body_fn, loop_vars):
        if self._in_body:
            raise RuntimeError("to_static: a tensor while_loop inside "
                               "another while_loop's body is not supported")
        vals = [raw_value(v) if isinstance(v, Tensor)
                else torch.as_tensor(v, device=self.device)
                for v in loop_vars]

        def pred(bufs):
            p = cond_fn(*[_wrap(b) for b in bufs])
            p = raw_value(p) if isinstance(p, Tensor) else \
                torch.as_tensor(p, device=self.device)
            return p.reshape(()).to(torch.bool)

        self._end_segment()
        with torch.no_grad():
            # the prologue: the carry in buffers of its own, the first test
            self._begin_segment()
            bufs = [v.detach().clone() for v in vals]
            flag = pred(bufs).clone()
            self._end_segment()
            if not self.cuda:           # the CPU recording ran it: keep
                with self._untraced():  # the state to run the loop for real
                    keep = [b.clone() for b in bufs] + [flag.clone()]
            self._in_body = True
            self._begin_segment()
            new = body_fn(*[_wrap(b) for b in bufs])
            new = list(new) if isinstance(new, (list, tuple)) else [new]
            for b, n in zip(bufs, new):
                b.copy_(raw_value(n) if isinstance(n, Tensor)
                        else torch.as_tensor(n, device=self.device))
            flag.copy_(pred(bufs))
            _, body, delta = self._end_segment(append=False)
            self._in_body = False
            self._steps.append(("loop", body, flag, delta))
            if not self.cuda:
                with self._untraced():
                    for b, k in zip(bufs + [flag], keep):
                        b.copy_(k)
                    while self._run and bool(flag):
                        body.replay()
            self._begin_segment()
        return [_wrap(b) for b in bufs]

    # -- run ----------------------------------------------------------------
    def _refresh_state(self):
        """Copy into its buffer any state the user rebound or rewrote since
        the last call (never replay on stale weights)."""
        for k, (t, buf) in enumerate(self._state):
            v = raw_value(t)
            if v is buf and t._version == self._versions[k]:
                continue
            if v.shape != buf.shape or v.dtype != buf.dtype or \
                    v.device != buf.device:
                raise StaleProgram(t.name)
            if v is not buf:
                with torch.no_grad():
                    buf.copy_(v)
                set_raw_value(t, buf)
            self._versions[k] = t._version

    def _replay(self):
        from ..kernels import add_launch_counts
        for step in self._steps:
            if step[0] == "graph":
                step[1].replay()
                add_launch_counts(step[2])
            else:
                _, body, flag, delta = step
                while bool(flag):
                    body.replay()
                    add_launch_counts(delta)

    def _finish(self):
        """Versions, gradients and cloned outputs after a run."""
        for t in self._written:
            t._version += 1
        self._versions = [t._version for t, _ in self._state]
        for buf, g in self._grad_slots:
            buf.grad = g
        outs = [_wrap(v.clone()) if is_t else v
                for is_t, v in zip(self._out_is_tensor, self._out_vals)]
        return pytree.tree_unflatten(outs, self._out_tree)

    def first_result(self, args, kwargs):
        """The build call's result: on the card the capture executed
        nothing, so the graph replays; on the CPU the recording ran it."""
        if self.cuda:
            return self(args, kwargs)
        return self._finish()

    def __call__(self, args, kwargs):
        leaves, _ = flatten((args, kwargs))
        with torch.no_grad():
            for buf, i in zip(self._in_bufs, self._tensor_pos):
                buf.copy_(leaves[i]._value)
            self._refresh_state()
            for provider, hbuf in self._hosts:
                hbuf.fill_(float(provider()))
        self._replay()
        return self._finish()

    # -- rollback (SOT) -------------------------------------------------------
    def snapshot_written(self):
        with torch.no_grad():
            return [raw_value(t).detach().clone() for t in self._written]

    def restore_written(self, snap):
        with torch.no_grad():
            for t, v in zip(self._written, snap):
                raw_value(t).copy_(v)


def build_program(fn, args, kwargs, donate_states=False, run=True):
    """Capture ``fn`` on ``(args, kwargs)``; returns ``(program, result of
    this call)``, the result None when ``run`` is False (the program is
    built and not run: SOT's eager capture call has the result)."""
    prog = CompiledProgram(fn, args, kwargs, donate_states=donate_states,
                           run=run)
    return prog, (prog.first_result(args, kwargs) if run else None)

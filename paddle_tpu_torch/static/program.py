"""The Program / Executor tier of ``paddle.static`` — counterpart of
``paddle_tpu/static/program.py``.

The classic static-graph workflow of Paddle's ``framework.py`` Program and
``executor.py`` Executor::

    paddle.enable_static()
    x = paddle.static.data("x", [None, 4], "float32")
    out = my_layers(x)
    loss = paddle.mean(out)
    opt.minimize(loss)
    exe = paddle.static.Executor()
    exe.run(paddle.static.default_startup_program())
    exe.run(feed={"x": arr}, fetch_list=[loss])

As in the reference, the dispatcher builds the Program: while a
Program records (static mode, or inside ``program_guard``), every op that
goes through ``core.dispatch.forward_op`` appends ``(fn, argument refs,
kwargs, output refs)`` to the Program's tape. Python object identity
names the variables; each record pins its outputs, so no id is reused
while the Program lives. Construction still runs each op eagerly on the
placeholders (zeros), which is the shape inference. ``Executor.run``
replays the tape with the feeds in place of the placeholders, as a pure
function of the feeds and the live Parameters: an optimizer's update
persists into the next run. ``Optimizer.minimize(loss)`` makes the
Program a training Program: its replay ends with ``loss.backward()``, the
optimizer's step and ``clear_grad``.

The reference's limits are kept (ROADMAP §C):

* a replay re-runs each op with its recorded arguments, so every shape
  constant is the construction's: a placeholder declared with a ``None``
  dim is built at 1, and a feed of another size fails in the first op that
  holds a shape (a ``reshape``), through that op's typed error;
* an op that closes over construction-time state (a dropout mask, running
  statistics) replays that state, with a warning at record time;
* a value computed outside the dispatcher is a constant of the Program.

Fed numpy arrays go to the Program's device, that of its placeholders
(the card unless the Program was built on the CPU). A Program with no
optimizer replays under ``no_grad``.
"""

from __future__ import annotations

import warnings
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

__all__ = ["Program", "Executor", "MissingFeedError", "data",
           "default_main_program", "default_startup_program",
           "program_guard", "append_backward"]


class MissingFeedError(KeyError):
    """``Executor.run`` was asked for something that depends on a feed
    placeholder with no entry in ``feed`` (a mistyped feed name). The
    replay would otherwise read the construction-time placeholder (zeros,
    dynamic dims as 1) and give wrong numbers where the reference Executor
    raises. ``missing`` holds the placeholder names the fetch needs."""

    def __init__(self, missing):
        self.missing = sorted(missing)
        super().__init__(
            f"feed is missing placeholder(s) {self.missing} that the "
            f"fetched subgraph depends on; pass them in `feed` "
            f"(check for typo'd feed names)")

    def __str__(self):           # KeyError quotes repr(args[0]) by default
        return self.args[0]


_main_program: Optional["Program"] = None
_startup_program: Optional["Program"] = None


class _OpRecord:
    __slots__ = ("name", "fn", "arg_ids", "raw_args", "kwargs", "out_ids",
                 "raw_outs", "differentiable")

    def __init__(self, name, fn, arg_ids, raw_args, kwargs, out_ids,
                 raw_outs, differentiable):
        self.name = name
        self.fn = fn
        self.arg_ids = arg_ids      # per arg: ("var", id) | ("const", val)
        self.raw_args = raw_args
        self.kwargs = kwargs
        self.out_ids = out_ids
        # pinned for the Program's lifetime: the replay's environment is
        # keyed by id(), and a collected output's id could be reused by an
        # unrelated later tensor
        self.raw_outs = raw_outs
        self.differentiable = differentiable


class Program:
    """The op tape (the ProgramDesc's counterpart)."""

    def __init__(self):
        self.ops: List[_OpRecord] = []
        self.feeds: Dict[str, Any] = {}       # name -> placeholder Tensor
        self.train_spec = None                 # (optimizer, loss tensor)
        self._warned_stateful = False

    _STATEFUL_MARKERS = ("dropout", "bernoulli", "uniform", "normal",
                         "rand", "batch_norm", "rrelu", "multinomial",
                         "gumbel", "alpha_dropout")

    def record(self, name, fn, args, kwargs, outs, differentiable):
        """The recorder hook ``core.dispatch.forward_op`` calls."""
        from ..core.tensor import Tensor
        if not self._warned_stateful and any(
                m in (name or "") for m in self._STATEFUL_MARKERS):
            self._warned_stateful = True
            warnings.warn(
                f"paddle.static: op '{name}' closes over construction-time "
                "state (an RNG key / running statistics); Executor.run "
                "replays the SAME state every call — random masks freeze "
                "and BN running stats do not advance. Use "
                "paddle.jit.to_static for stochastic/stateful training "
                "steps (the jit tier re-keys per call).", stacklevel=4)
        arg_ids = [("var", id(a)) if isinstance(a, Tensor) else ("const", a)
                   for a in args]
        out_list = outs if isinstance(outs, (tuple, list)) else (outs,)
        raw_outs = [o for o in out_list if isinstance(o, Tensor)]
        self.ops.append(_OpRecord(
            name, fn, arg_ids, list(args), dict(kwargs),
            [id(o) for o in raw_outs], raw_outs, differentiable))

    def global_block(self):
        return self

    @property
    def var_names(self):
        return list(self.feeds)

    def __repr__(self):
        kind = "train" if self.train_spec else "inference"
        return (f"Program(ops={len(self.ops)}, feeds={list(self.feeds)}, "
                f"{kind})")


def default_main_program() -> Program:
    global _main_program
    if _main_program is None:
        _main_program = Program()
    return _main_program


def default_startup_program() -> Program:
    """An empty Program: parameters are initialised when their layers are
    built, so ``exe.run(startup)`` has nothing to do (the reference's
    startup program runs the initializer ops)."""
    global _startup_program
    if _startup_program is None:
        _startup_program = Program()
    return _startup_program


class _ProgramGuard:
    def __init__(self, main: Program, startup: Optional[Program]):
        self.main = main
        self.startup = startup

    def __enter__(self):
        global _main_program
        from ..core import dispatch as _d
        self._prev = _main_program
        self._prev_rec = _d._static_recorder
        _main_program = self.main
        _d._static_recorder = self.main
        return self.main

    def __exit__(self, *exc):
        global _main_program
        from ..core import dispatch as _d
        _d._static_recorder = self._prev_rec
        _main_program = self._prev
        return False


def program_guard(main_program: Program, startup_program: Optional[Program]
                  = None):
    return _ProgramGuard(main_program, startup_program)


def data(name: str, shape: Sequence[int], dtype="float32", lod_level=0):
    """A feed placeholder (``paddle.static.data``) on the current place:
    zeros, each dynamic dim (None / -1) built at 1. A replay keeps the
    construction's shapes (see the module note)."""
    from ..core.dtype import canonical_dtype
    from ..core.place import torch_device
    from ..core.tensor import Tensor
    concrete = tuple(1 if (s is None or int(s) < 0) else int(s)
                     for s in shape)
    ph = Tensor(torch.zeros(concrete, dtype=canonical_dtype(dtype),
                            device=torch_device()), name=name)
    ph.stop_gradient = True
    default_main_program().feeds[name] = ph
    return ph


def append_backward(loss, parameter_list=None):
    """Mark the default Program's loss (``append_backward``); with no
    optimizer recorded, a run computes no gradient (as the reference)."""
    prog = default_main_program()
    prog.train_spec = (prog.train_spec[0] if prog.train_spec else None,
                       loss)
    return []


class Executor:
    """Replays a Program as a pure function of its feeds
    (``paddle.static.Executor``). ``place`` is accepted: a Program runs on
    the device of its placeholders."""

    def __init__(self, place=None):
        self.place = place

    def run(self, program: Optional[Program] = None, feed=None,
            fetch_list=None, return_numpy: bool = True):
        prog = program or default_main_program()
        feed = feed or {}
        fetch_list = fetch_list or []
        if prog is _startup_program:
            return []          # start-up: initialisation already happened

        from ..core import dispatch as _d
        from ..core.tensor import Tensor, to_tensor

        # a placeholder the FETCHED subgraph needs must be fed
        needed = self._needed_placeholders(prog, fetch_list)
        missing = [name for name, ph in prog.feeds.items()
                   if id(ph) in needed and name not in feed]
        if missing:
            raise MissingFeedError(missing)

        env: Dict[int, Any] = {}
        for name, ph in prog.feeds.items():
            if name in feed:
                v = feed[name]
                env[id(ph)] = v if isinstance(v, Tensor) else to_tensor(
                    np.asarray(v), place=ph.place)
            else:
                env[id(ph)] = ph

        train = prog.train_spec is not None and \
            prog.train_spec[0] is not None
        saved_rec, _d._static_recorder = _d._static_recorder, None
        try:
            with torch.enable_grad() if train else torch.no_grad():
                outs = self._replay(prog, env)
            if train:
                opt, loss = prog.train_spec
                outs.get(id(loss), loss).backward()
                opt.step()
                opt.clear_grad()
        finally:
            _d._static_recorder = saved_rec

        results = []
        for f in fetch_list:
            t = outs.get(id(f), f)
            results.append(np.asarray(t.numpy()) if return_numpy else t)
        return results

    @staticmethod
    def _needed_placeholders(prog: Program, fetch_list) -> set:
        """Ids of every variable the fetches (and a training Program's
        loss) depend on: the tape walked backward, the needed set grown
        through each record whose outputs it holds. A fetched placeholder
        counts itself."""
        needed = {id(f) for f in fetch_list}
        if prog.train_spec and prog.train_spec[1] is not None:
            needed.add(id(prog.train_spec[1]))       # loss drives backward
        for rec in reversed(prog.ops):
            if any(oid in needed for oid in rec.out_ids):
                needed.update(ref for kind, ref in rec.arg_ids
                              if kind == "var")
        return needed

    def _replay(self, prog: Program, env: Dict[int, Any]) -> Dict[int, Any]:
        """Every record re-dispatched through ``forward_op`` with the feeds
        and intermediates in place; Parameters are read live."""
        from ..core.dispatch import forward_op
        from ..core.tensor import Tensor
        for rec in prog.ops:
            args = [env[ref] if kind == "var" and ref in env else raw
                    for (kind, ref), raw in zip(rec.arg_ids, rec.raw_args)]
            out = forward_op(rec.name, rec.fn, args, rec.kwargs,
                             differentiable=rec.differentiable)
            out_list = out if isinstance(out, (tuple, list)) else (out,)
            for oid, o in zip(rec.out_ids, [o for o in out_list
                                            if isinstance(o, Tensor)]):
                env[oid] = o
        return env

    def close(self):
        pass


def reset_programs():
    """Drop the module's default Programs (a test hook). A recorder that
    was recording into the dropped main Program moves to the new one, so
    ops go on recording where ``data`` registers its feeds."""
    global _main_program, _startup_program
    from ..core import dispatch as _d
    dropped = _main_program
    _main_program = None
    _startup_program = None
    if dropped is not None and _d._static_recorder is dropped:
        _d._static_recorder = default_main_program()

"""SOT — the bytecode-tier dynamic-to-static capture (guards, graph breaks,
path-specialized compilation) — counterpart of ``paddle_tpu/jit/sot.py``.

Parity target: the reference's ``python/paddle/jit/sot/`` ("Symbolic Opcode
Translator": a CPython-bytecode interpreting tracer with guard-based graph
capture and graph-break fallback — the torchdynamo equivalent; SURVEY §2.4).

The JAX package's redesign, kept: every tensor op funnels through ONE
dispatcher (``core.dispatch.forward_op``) and every tensor->Python
materialization goes through the host-read dunders
(``core.tensor._materialize``), so the capture semantics fall out of two
small mechanisms:

* **Materialization events** (the graph-break points): ``bool(t)`` /
  ``int(t)`` / ``float(t)`` / ``t.item()`` are exactly the places the
  reference's opcode translator breaks the graph. A hook on them records
  each event's concrete outcome during an eager CAPTURE run, and feeds the
  recorded outcome back while the path's program is captured
  (``jit/trace.py``: a CUDA graph) — so the capture proceeds through
  data-dependent ``if``/``while``/``for`` (including ``return`` inside a
  branch) along the OBSERVED path, and the event tensors become extra
  outputs of the graph, read after each replay to VALIDATE the path.
* **Guards**: (a) the input signature (pytree structure, tensor
  shapes/dtypes, non-tensor argument values); (b) a CPython-bytecode scan
  (``dis``) of the function's code object — recursing into nested code
  constants — collecting every ``LOAD_GLOBAL``/``LOAD_DEREF`` name whose
  current value is a guardable scalar, snapshotted at capture and checked
  per call (closure-const guards); (c) the per-path event outcomes, checked
  against the compiled program's own event outputs after each run.
* **Path specialization** (the resume-function equivalent): each distinct
  control-flow path through the tensor-dependent branches compiles to its
  own full program. A run whose event outputs diverge from the path's
  recorded outcomes is rolled back (copies of the state the program writes,
  taken before the run, are copied back: the graphs write in place) and
  re-dispatched to the matching path, or re-captured eagerly. The path
  table is capped; overflow (e.g. a ``float(loss)`` that changes every
  step) degrades to permanent eager execution with one warning — the
  graph-break-with-eager-fallback contract (each such call counts on
  ``jit.api.fallbacks["sot_graph_break"]``).

What this tier adds over the AST tier (``jit/dy2static.py``): branches
containing ``return``/``break``/``continue``, attribute/object stores,
data-dependent ``for``/``while`` (specialized per trip count), and
gradients through data-dependent control flow (the branch is resolved at
trace time, so backward compiles through the taken path — the AST tier's
``while`` refusal does not apply here).

Semantics contract (same as ``to_static`` generally): Python side effects
(prints, attribute/global/item stores) run during capture and are NOT
replayed by compiled calls — a bytecode scan DETECTS store ops up front
and warns once; ``.numpy()``/``.tolist()`` inside the compiled
region are a hard graph break (permanent eager fallback for that
signature). Guards cover scalar AND small container/ndarray
globals/closures by content digest, so mutating a guarded list/dict/array
recompiles instead of serving a stale path. The first call captures
and compiles — there is no warmup-eager call.
"""

from __future__ import annotations

import dis
import warnings
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from ..core import tensor as _tensor_mod
from ..core.tensor import Tensor, _wrap, raw_value
from .trace import build_program

__all__ = ["SOTFunction", "sot_capture_active", "GuardedEntry"]

_MAX_PATHS = 8          # live per-signature path-table cap (LRU-evicted)
_MAX_CHURN = 32         # total compiles per entry before eager demotion
_MISSING = object()


# ---------------------------------------------------------------------------
# materialization-event hook (installed into core.tensor dunders)
# ---------------------------------------------------------------------------

class _EventCtx:
    """Active while a SOT capture (eager) or replay (compile trace) runs."""

    def __init__(self, mode: str, recorded: Optional[List] = None):
        assert mode in ("capture", "replay")
        self.mode = mode
        self.outcomes: List[Tuple[str, Any]] = []   # capture: recorded here
        self.recorded = recorded or []              # replay: fed from here
        self.cursor = 0
        self.event_vals: List[Any] = []             # replay: event tracers

    def on_event(self, kind: str, t: Tensor, read):
        if self.mode == "capture":
            val = read()
            if kind in _EVENT_KINDS:
                self.outcomes.append((kind, val))
            return val
        if kind not in _EVENT_KINDS:      # .numpy() / .tolist(): no path
            raise _GraphBreak(f"{kind}() of a tensor inside the compiled "
                              "region")
        # replay: the value is not computed yet — keep the tensor as an
        # extra program output and return the recorded concrete outcome so
        # Python control flow proceeds along the captured path
        if self.cursor >= len(self.recorded):
            raise _PathDiverged(
                f"extra materialization event #{self.cursor} ({kind}) during "
                f"replay — the function is not deterministic given its guards")
        rk, rv = self.recorded[self.cursor]
        if rk != kind:
            raise _PathDiverged(
                f"event #{self.cursor} kind changed ({rk} -> {kind})")
        self.cursor += 1
        self.event_vals.append(raw_value(t).detach().reshape(()))
        return rv


_EVENT_KINDS = ("bool", "int", "float", "item")


class _PathDiverged(RuntimeError):
    pass


class _GraphBreak(RuntimeError):
    pass


def sot_capture_active() -> bool:
    return _ACTIVE[0] > 0


_ACTIVE = [0]


class _hook_installed:
    def __init__(self, ctx: _EventCtx):
        self.ctx = ctx

    def __enter__(self):
        self.prev = _tensor_mod._materialize_hook
        _tensor_mod._materialize_hook = self.ctx.on_event
        _ACTIVE[0] += 1
        return self.ctx

    def __exit__(self, *exc):
        _tensor_mod._materialize_hook = self.prev
        _ACTIVE[0] -= 1
        return False


# ---------------------------------------------------------------------------
# guards
# ---------------------------------------------------------------------------

def _guardable(v) -> bool:
    if v is None or isinstance(v, (bool, int, float, str, bytes)):
        return True
    if isinstance(v, (tuple, list)) and len(v) <= 8:
        return all(_guardable(x) for x in v)
    if isinstance(v, dict) and len(v) <= 8:
        return all(isinstance(k, (str, int)) and _guardable(x)
                   for k, x in v.items())
    if isinstance(v, np.ndarray) and v.size <= 64:
        return True
    return False


def _guard_digest(v):
    """Canonical, content-based snapshot value: mutating a guarded list /
    dict / small ndarray closure INVALIDATES the entry (recompile) instead
    of silently serving a stale path."""
    if isinstance(v, (tuple, list)):
        return ("seq", type(v).__name__,
                tuple(_guard_digest(x) for x in v))
    if isinstance(v, dict):
        # keys may mix int/str (both admitted by _guardable): sort by a
        # type-tagged repr so the sort never compares across types
        return ("map", tuple(sorted(
            ((type(k).__name__, repr(k), _guard_digest(x))
             for k, x in v.items()))))
    if isinstance(v, np.ndarray):
        return ("nd", v.shape, str(v.dtype), v.tobytes())
    return v


def _scan_code_reads(code) -> Tuple[set, set]:
    """Bytecode scan: every global / closure name the code object (and its
    nested code constants) reads. This is the tier's actual bytecode pass —
    the guard SOURCES the reference's opcode translator derives from
    LOAD_GLOBAL / LOAD_DEREF while interpreting."""
    globals_read, derefs_read = set(), set()
    stack = [code]
    while stack:
        c = stack.pop()
        for ins in dis.get_instructions(c):
            if ins.opname == "LOAD_GLOBAL":
                globals_read.add(ins.argval)
            elif ins.opname in ("LOAD_DEREF", "LOAD_CLASSDEREF"):
                derefs_read.add(ins.argval)
        for const in c.co_consts:
            if hasattr(const, "co_code"):
                stack.append(const)
    return globals_read, derefs_read


_SIDE_EFFECT_OPS = {"STORE_GLOBAL", "DELETE_GLOBAL", "STORE_ATTR",
                    "DELETE_ATTR", "STORE_SUBSCR", "DELETE_SUBSCR"}
# mutating METHOD calls (list.append etc.) don't emit store opcodes; the
# scan flags loads of these names as probable mutations (heuristic — a
# false positive only costs an informational warning)
_MUTATING_METHODS = {"append", "extend", "insert", "update", "setdefault",
                     "pop", "popitem", "remove", "clear", "add", "discard",
                     "write", "sort", "reverse"}


def _container_mutated_names(code) -> set:
    """Names of GLOBAL/CLOSURE variables the code mutates through
    subscript stores or mutating method calls, found by tracking the
    loaded object through a SYMBOLIC stack: a STORE_SUBSCR marks a name
    only when its container operand actually originates from that
    LOAD_GLOBAL/LOAD_DEREF (directly, or via a chained subscript/attr —
    ``cfg[i][j] = v`` and ``cfg.data[k] = v`` still count as mutating
    ``cfg``). The earlier flat 12-instruction window marked a container
    whenever ANY subscript store followed its load, so ``x = cfg[k];
    buf[i] = x`` dropped the guard on the read-only global ``cfg`` and
    external mutation of it served a stale compiled path.
    Unmodeled opcodes conservatively clear every tag: a false NEGATIVE
    only keeps a guard alive (worst case a recompile); a false positive
    would silently disable stale-path protection."""
    names = set()
    codes = [code]
    while codes:
        c = codes.pop()
        _scan_container_mutations(c, names)
        for const in c.co_consts:
            if hasattr(const, "co_code"):
                codes.append(const)
    return names


def _scan_container_mutations(c, names: set) -> None:
    sym: list = []          # one entry per stack slot: a name tag or None

    def pop(n):
        del sym[len(sym) - n:]

    for ins in dis.get_instructions(c):
        op = ins.opname
        if ins.is_jump_target:
            sym = [None] * len(sym)       # merged control flow: unknown
        if op in ("STORE_GLOBAL", "DELETE_GLOBAL"):
            names.add(ins.argval)
            if op == "STORE_GLOBAL":
                pop(1)
            continue
        if op in ("LOAD_GLOBAL", "LOAD_DEREF", "LOAD_CLASSDEREF"):
            # 3.11+ LOAD_GLOBAL may push NULL below the value (eff 2)
            try:
                eff = dis.stack_effect(ins.opcode, ins.arg)
            except ValueError:
                eff = 1
            sym.extend([None] * (eff - 1) + [ins.argval])
            continue
        if op in ("LOAD_CONST", "LOAD_FAST", "LOAD_SMALL_INT"):
            sym.append(None)
            continue
        if op in ("LOAD_ATTR", "LOAD_METHOD"):
            owner = sym[-1] if sym else None
            if owner is not None and ins.argval in _MUTATING_METHODS:
                names.add(owner)
            pop(1)
            try:
                eff = dis.stack_effect(ins.opcode, ins.arg)
            except ValueError:
                eff = 0
            # attribute access propagates the tag: mutating cfg.data
            # mutates what the digest of cfg covers
            sym.extend([None] * eff + [owner])
            continue
        if op == "BINARY_SUBSCR":
            tag = sym[-2] if len(sym) >= 2 else None
            pop(2)
            sym.append(tag)               # cfg[i] is still "part of" cfg
            continue
        if op == "BINARY_SLICE":          # 3.12+: TOS2[TOS1:TOS], pops 3
            tag = sym[-3] if len(sym) >= 3 else None
            pop(3)
            sym.append(tag)
            continue
        if op == "STORE_SLICE":           # 3.12+: TOS2[TOS1:TOS] = TOS3
            if len(sym) >= 3 and sym[-3] is not None:
                names.add(sym[-3])
            pop(4)
            continue
        if op == "STORE_SUBSCR":
            if len(sym) >= 2 and sym[-2] is not None:
                names.add(sym[-2])
            pop(3)
            continue
        if op == "DELETE_SUBSCR":
            if len(sym) >= 2 and sym[-2] is not None:
                names.add(sym[-2])
            pop(2)
            continue
        if op == "POP_TOP":
            pop(1)
            continue
        if op == "DUP_TOP":
            sym.append(sym[-1] if sym else None)
            continue
        if op == "DUP_TOP_TWO":
            sym.extend(sym[-2:] if len(sym) >= 2 else [None, None])
            continue
        if op in ("ROT_TWO", "ROT_THREE", "ROT_FOUR"):
            n = {"ROT_TWO": 2, "ROT_THREE": 3, "ROT_FOUR": 4}[op]
            if len(sym) >= n:
                sym[-n:] = [sym[-1]] + sym[-n:-1]
            continue
        if op == "COPY":                  # 3.11+
            i = ins.arg or 1
            sym.append(sym[-i] if len(sym) >= i else None)
            continue
        if op == "SWAP":                  # 3.11+
            i = ins.arg or 1
            if len(sym) >= i:
                sym[-1], sym[-i] = sym[-i], sym[-1]
            continue
        if op == "BINARY_OP" or op.startswith(("BINARY_", "INPLACE_")):
            pop(2)
            sym.append(None)              # a fresh (or consumed) value
            continue
        if op.startswith("UNARY_"):
            if sym:
                sym[-1] = None            # pop 1 push 1, tag dropped
            continue
        if op in ("STORE_FAST", "STORE_DEREF", "STORE_NAME", "STORE_ATTR"):
            try:
                eff = dis.stack_effect(ins.opcode, ins.arg)
            except ValueError:
                eff = -1
            pop(-eff)
            continue
        # anything else: keep the depth honest, drop every tag — an
        # unmodeled opcode may have rearranged the stack arbitrarily
        try:
            eff = dis.stack_effect(ins.opcode, ins.arg)
        except ValueError:
            sym = []
            continue
        sym = [None] * max(0, len(sym) + eff)


def _detect_side_effects(fn: Callable) -> Optional[str]:
    """Static bytecode scan for Python side effects (object/global/item
    stores) the compiled replay will NOT re-run (detect
    and warn instead of silently dropping). Returns a description or
    None."""
    fn = getattr(fn, "__func__", fn)
    code = getattr(fn, "__code__", None)
    if code is None:
        return None
    hits = []
    stack = [code]
    while stack:
        c = stack.pop()
        for ins in dis.get_instructions(c):
            if ins.opname in _SIDE_EFFECT_OPS:
                hits.append(f"{ins.opname} {ins.argval}")
            elif ins.opname in ("LOAD_METHOD", "LOAD_ATTR") and \
                    ins.argval in _MUTATING_METHODS:
                hits.append(f"call .{ins.argval}()")
        for const in c.co_consts:
            if hasattr(const, "co_code"):
                stack.append(const)
    if hits:
        uniq = sorted(set(hits))[:5]
        return ", ".join(uniq)
    return None


def _code_guard_snapshot(fn: Callable) -> Dict[str, Any]:
    """name -> digest for every guardable global/closure value the
    function's bytecode reads. Container/ndarray digests are only taken
    for functions with NO store bytecodes: a function that mutates
    subscripts/attributes itself (a step counter, an appended log) would
    otherwise invalidate its own guards every call and recompile forever —
    for those, containers stay unguarded (scalars still guard) and the
    side-effect warning covers the semantics."""
    fn = getattr(fn, "__func__", fn)          # unwrap bound methods
    code = getattr(fn, "__code__", None)
    if code is None:
        return {}
    # container guards are skipped ONLY for the specific global/closure
    # names the code itself mutates (a step counter, an appended log) —
    # other container guards stay live even in functions with local
    # mutations (the previous all-or-nothing switch
    # disabled stale-path protection for most real functions)
    mutated = _container_mutated_names(code)
    globals_read, derefs_read = _scan_code_reads(code)
    snap: Dict[str, Any] = {}
    g = getattr(fn, "__globals__", {})
    for name in globals_read:
        v = g.get(name, _MISSING)
        if v is _MISSING or not _guardable(v):
            continue
        if name in mutated and not isinstance(
                v, (bool, int, float, str, bytes, tuple, type(None))):
            continue
        snap[f"g:{name}"] = _guard_digest(v)
    cells = dict(zip(code.co_freevars, fn.__closure__ or ()))
    for name in derefs_read:
        cell = cells.get(name)
        if cell is not None:
            try:
                v = cell.cell_contents
            except ValueError:      # empty cell
                continue
            if not _guardable(v):
                continue
            if name in mutated and not isinstance(
                    v, (bool, int, float, str, bytes, tuple, type(None))):
                continue
            snap[f"c:{name}"] = _guard_digest(v)
    return snap




def _input_sig(args, kwargs, train_flags=()):
    from .api import _signature
    return _signature(args, kwargs, train_flags)


# ---------------------------------------------------------------------------
# per-signature entry: guards + path table
# ---------------------------------------------------------------------------

class GuardedEntry:
    def __init__(self, code_guards: Dict[str, Any]):
        self.code_guards = code_guards
        # insertion/use-ordered: the path table evicts LRU on overflow
        # (overflow is not a permanent
        # demotion); churn beyond _MAX_CHURN total compiles demotes to
        # eager (a truly path-unstable function would thrash-compile)
        from collections import OrderedDict
        self.paths: "OrderedDict[Tuple, Any]" = OrderedDict()
        self.compile_count = 0
        self.last_path: Optional[Tuple] = None
        self.eager_only: Optional[str] = None  # reason, once broken

    def guards_pass(self, fn) -> bool:
        if not self.code_guards:
            return True
        snap = _code_guard_snapshot(fn)
        return all(snap.get(k, _MISSING) == v
                   for k, v in self.code_guards.items())


def _outcome_key(outcomes) -> Tuple:
    return tuple((k, v) for k, v in outcomes)


class SOTFunction:
    """The ``backend="sot"`` tier of ``to_static`` (reference:
    ``paddle.jit.to_static`` with SOT enabled)."""

    def __init__(self, function, input_spec=None, donate_states=False,
                 layer=None, guard_target=None):
        self._fn = function
        self._guard_fn = guard_target or function  # what the bytecode scan
        # reads (the Layer case wraps forward in a lambda; guards must come
        # from the real forward's code object)
        self._input_spec = input_spec
        self._donate = donate_states
        self._layer = layer
        self._entries: Dict[Any, List[GuardedEntry]] = {}
        self._side_effects_checked = False

    # surface parity with StaticFunction
    @property
    def _train_flags(self):
        from .api import _train_flags
        return _train_flags(self._layer)

    def _capture_call(self, args, kwargs):
        """Eager run recording materialization outcomes (always correct —
        this IS plain eager execution with a recorder attached)."""
        ctx = _EventCtx("capture")
        with _hook_installed(ctx):
            out = self._fn(*args, **kwargs)
        return out, ctx.outcomes

    def _compile_path(self, outcomes, args, kwargs):
        """Build the path-specialized program: the standard capture
        (CompiledProgram: state binding, backward-in-program), with the
        event hook feeding recorded outcomes and exporting each event
        tensor as an extra output for runtime path validation. The capture
        call's result is already the eager run's: the program is built,
        not run."""
        recorded = list(outcomes)

        def fn_with_events(*a, **k):
            ctx = _EventCtx("replay", recorded)
            with _hook_installed(ctx):
                out = self._fn(*a, **k)
            if ctx.cursor != len(recorded):
                raise _PathDiverged(
                    f"only {ctx.cursor} of {len(recorded)} events fired "
                    "during replay")
            events = tuple(_wrap(v) for v in ctx.event_vals)
            return (out, events)

        prog, _ = build_program(fn_with_events, args, kwargs,
                                donate_states=self._donate, run=False)
        return prog

    def _run_checked(self, entry: GuardedEntry, key, args, kwargs):
        """Run the path's program; validate event outputs against the
        recorded outcomes; roll back state and return None on divergence."""
        from ..ops import random as _random
        prog = entry.paths[key]
        state_saved = prog.snapshot_written()
        gen = _random.default_generator()
        key_saved = gen.get_state()
        out, events = prog(args, kwargs)
        actual = []
        ok = True
        for (kind, recv), ev in zip(key, events):
            conv = {"bool": bool, "int": int, "float": float,
                    "item": lambda v: v.item()}[kind]
            a = conv(raw_value(ev))
            actual.append((kind, a))
            if a != recv:
                ok = False
                break
        if ok:
            entry.last_path = key
            entry.paths.move_to_end(key)      # LRU: mark most-recent
            return True, out
        # divergence: undo the program's state writes (the graph wrote the
        # state in place: copy the values taken before the run back)
        prog.restore_written(state_saved)
        gen.set_state(key_saved)
        return False, _outcome_key(actual)   # trustworthy prefix

    def __call__(self, *args, **kwargs):
        from . import api
        if not api._to_static_enabled:
            api.fallbacks["to_static_disabled"] += 1
            return self._fn(*args, **kwargs)
        if api.autograd_under_trace() or sot_capture_active():
            api.fallbacks["nested"] += 1
            return self._fn(*args, **kwargs)
        # no warmup-eager special case — the
        # FIRST call captures and compiles. Capture IS a plain eager run
        # with a recorder attached, so lazy state init (Parameter creation
        # on first forward) happens during capture exactly as it would
        # eagerly, and the compile trace that follows sees fully-built
        # state. Once-called functions therefore compile too.
        if not self._side_effects_checked:
            self._side_effects_checked = True
            se = _detect_side_effects(self._guard_fn)
            if se is not None:
                warnings.warn(
                    "to_static[sot]: Python side effects detected in the "
                    f"captured function ({se}); they execute during "
                    "capture runs only and are NOT replayed by compiled "
                    "calls (the documented capture contract)",
                    stacklevel=2)

        sig = _input_sig(args, kwargs, self._train_flags)
        entries = self._entries.setdefault(sig, [])
        entry = next((e for e in entries if e.guards_pass(self._guard_fn)),
                     None)
        if entry is None:
            # new guard set (first sight of this signature, or a
            # closure/global constant changed): capture + compile fresh
            entry = GuardedEntry(_code_guard_snapshot(self._guard_fn))
            entries.append(entry)

        if entry.eager_only is not None:
            api.fallbacks["sot_graph_break"] += 1
            return self._fn(*args, **kwargs)

        # fast path: try the last successful path, then any whose prefix
        # matches what we actually observe
        tried = set()
        key = entry.last_path
        while key is not None and key not in tried:
            tried.add(key)
            ok, res = self._run_checked(entry, key, args, kwargs)
            if ok:
                return res
            actual_prefix = res
            key = next(
                (k for k in entry.paths
                 if k not in tried and len(k) >= len(actual_prefix)
                 and k[:len(actual_prefix)] == actual_prefix), None)

        # no compiled path matches: eager capture (correct result), then
        # compile this path for future calls
        out, outcomes = self._capture_call(args, kwargs)
        pkey = _outcome_key(outcomes)
        if pkey not in entry.paths:
            if entry.compile_count >= _MAX_CHURN:
                entry.eager_only = (
                    f"path table churned through {_MAX_CHURN} compiles "
                    "(a materialized scalar changes every call?) — "
                    "falling back to eager execution for this signature")
                warnings.warn(f"to_static[sot]: {entry.eager_only}",
                              stacklevel=2)
                return out
            if len(entry.paths) >= _MAX_PATHS:
                # evict the least-recently-used path (front of the ordered
                # table); its program is rebuilt if that path recurs
                entry.paths.popitem(last=False)
            try:
                entry.paths[pkey] = self._compile_path(outcomes, args, kwargs)
                entry.compile_count += 1
                entry.last_path = pkey
            except Exception as e:   # graph break: permanent eager fallback
                entry.eager_only = (
                    f"graph break — path trace failed with "
                    f"{type(e).__name__}: {str(e)[:200]}")
                warnings.warn(f"to_static[sot]: {entry.eager_only}",
                              stacklevel=2)
        return out

    # paddle API compat (StaticFunction surface)
    @property
    def code(self):
        import inspect
        try:
            return inspect.getsource(self._fn)
        except (OSError, TypeError):
            return "<source unavailable>"

    def rollback(self):
        return self._fn

    def concrete_program_specify_input_spec(self, *a, **k):
        return None

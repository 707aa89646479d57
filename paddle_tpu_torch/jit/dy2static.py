"""AST-level dy2static: tensor-dependent Python control flow ->
``jit.control_flow`` — counterpart of ``paddle_tpu/jit/dy2static.py``.

Parity target: ``python/paddle/jit/dy2static/transformers/`` in the
reference (IfElseTransformer / LoopTransformer rewriting ``if``/``while``
into ``convert_ifelse``/``convert_while`` calls, with the SOT bytecode tier
above it). The rewrite is the JAX package's, kept here as a copy of its
own; it targets ``jit.control_flow``, whose lowering suits a CUDA graph
(``cond`` runs both branches and selects with ``torch.where`` inside a
capture, ``while_loop`` replays its body's graph while the host reads the
predicate true, ``scan`` unrolls). The runtime ``convert_*`` helpers
dispatch on the predicate's type, so python-bool conditions keep exact
eager semantics and only Tensor conditions lower.

Engagement is the reference's fallback UX: ``to_static`` traces the
function as-is first, and on a data-dependent-control-flow trace error
retries with the transformed function (StaticFunction.__call__).

Scope (documented): ``if``/``elif``/``else`` and ``while`` whose branches
assign plain local names; branches containing ``return``/``break``/
``continue`` or attribute/subscript stores are left untouched (they only
fail if actually tensor-dependent, with the original error). Counted
``for i in range(...)`` loops with clean bodies lower to ``jit.scan``
(differentiable; shape-varying carries fall back to python unrolling).
``while`` lowers to ``jit.while_loop`` and is forward-only — the SOT tier
(``to_static(backend="sot")``) covers everything beyond this scope.
"""

from __future__ import annotations

import ast
import functools
import inspect
import textwrap
from typing import Callable, Tuple

__all__ = ["ast_transform", "convert_ifelse", "convert_while",
           "convert_range_for", "Dy2StaticError"]


class Dy2StaticError(RuntimeError):
    pass


# ---------------------------------------------------------------------------
# runtime dispatch helpers (ref: paddle.jit.dy2static.convert_ifelse/...)
# ---------------------------------------------------------------------------

def convert_ifelse(pred, true_fn: Callable, false_fn: Callable, ins: Tuple):
    """Tensor predicate -> jit.control_flow.cond (grads flow
    through the threaded ``ins``); python predicate -> plain if. The branch
    fns return a bare value for a single rewritten name and a tuple for
    several — the call-site target mirrors that exactly."""
    from ..core.tensor import Tensor
    if isinstance(pred, Tensor):
        from .control_flow import cond
        return cond(pred, true_fn, false_fn, *ins)
    return true_fn(*ins) if pred else false_fn(*ins)


def convert_range_for(range_args: Tuple, body_fn: Callable,
                      loop_vars: Tuple) -> Tuple:
    """Counted ``for i in range(...)`` over tensor-carried loop vars ->
    ``jit.scan`` (differentiable); python-only carries, or bodies whose
    carried shapes change across iterations (concat-style accumulators),
    fall back to the plain python loop.
    """
    from ..core.tensor import Tensor
    n_range = range(*[int(a) for a in range_args])
    has_tensor = any(isinstance(v, Tensor) for v in loop_vars)
    if has_tensor and len(n_range) >= 2:
        import torch
        from ..core.place import torch_device
        from ..core.tensor import _wrap

        def step(carry, idx):
            return tuple(body_fn(idx, *carry)), ()
        try:
            from .control_flow import scan
            # the indices made on the device (a host-to-device copy cannot
            # be captured)
            idx = _wrap(torch.arange(n_range.start, n_range.stop,
                                     n_range.step, dtype=torch.int32,
                                     device=torch_device()))
            carry, _ = scan(step, tuple(loop_vars), xs=idx)
            return tuple(carry)
        except Exception:
            pass     # shape-varying carry etc. — unroll like before
    vs = tuple(loop_vars)
    for i in n_range:
        vs = tuple(body_fn(i, *vs))
    return vs


def convert_while(cond_fn: Callable, body_fn: Callable,
                  loop_vars: Tuple) -> Tuple:
    """Tensor condition -> jit.while_loop (forward-only; REFUSES when a
    loop var wants gradients — silent zero-grad is worse than the loud
    error pointing at jit.scan); python condition -> plain while."""
    from ..core import autograd
    from ..core.tensor import Tensor
    first = cond_fn(*loop_vars)
    if isinstance(first, Tensor):
        if autograd.is_grad_enabled() and any(
                isinstance(v, Tensor) and not v.stop_gradient
                for v in loop_vars):
            raise Dy2StaticError(
                "tensor-dependent `while` lowers to jit.while_loop, which "
                "is forward-only — gradients through the loop would be "
                "silently zero. Rewrite the loop with paddle_tpu_torch.jit.scan "
                "(differentiable), or mark the loop vars stop_gradient")
        from .control_flow import while_loop
        res = while_loop(cond_fn, lambda *vs: tuple(body_fn(*vs)),
                         list(loop_vars))
        return tuple(res)
    # python predicate: reuse the probe evaluation — an impure condition
    # must run exactly once per iteration check
    vs = tuple(loop_vars)
    res = first
    while res:
        vs = tuple(body_fn(*vs))
        res = cond_fn(*vs)
    return vs


# ---------------------------------------------------------------------------
# static analysis
# ---------------------------------------------------------------------------


def _param_names(args: ast.arguments) -> set:
    names = {a.arg for a in (args.posonlyargs + args.args + args.kwonlyargs)}
    if args.vararg:
        names.add(args.vararg.arg)
    if args.kwarg:
        names.add(args.kwarg.arg)
    return names


def _assigned_names(stmts) -> set:
    """Plain local names bound by the statements (nested defs excluded)."""
    names = set()

    class V(ast.NodeVisitor):
        def visit_FunctionDef(self, node):  # don't descend into nested defs
            names.add(node.name)

        visit_AsyncFunctionDef = visit_FunctionDef

        def visit_Name(self, node):
            if isinstance(node.ctx, (ast.Store, ast.Del)):
                names.add(node.id)

    for s in stmts:
        V().visit(s)
    return names


def _loaded_names(node) -> set:
    """Names the code READS from the enclosing scope. Scope-aware: a load
    inside a nested def of a name that nested def itself binds (param or
    assignment) is local to it and not counted."""
    names = set()

    class V(ast.NodeVisitor):
        def visit_Name(self, n):
            if isinstance(n.ctx, ast.Load):
                names.add(n.id)

        def visit_AugAssign(self, n):
            # `y += 1` reads y even though its target ctx is Store
            if isinstance(n.target, ast.Name):
                names.add(n.target.id)
            self.generic_visit(n)

        def visit_FunctionDef(self, n):
            own = _param_names(n.args) | _assigned_names(n.body)
            inner = _loaded_names(ast.Module(body=list(n.body),
                                             type_ignores=[]))
            names.update(inner - own)

        visit_AsyncFunctionDef = visit_FunctionDef

    V().visit(node)
    return names


def _has_jump(stmts) -> bool:
    class V(ast.NodeVisitor):
        found = False

        def visit_Return(self, n):
            self.found = True

        def visit_Break(self, n):
            self.found = True

        def visit_Continue(self, n):
            self.found = True

        def visit_FunctionDef(self, n):  # jumps inside nested defs are fine
            pass

        visit_AsyncFunctionDef = visit_FunctionDef

    v = V()
    for s in stmts:
        v.visit(s)
    return v.found


def _has_object_store(stmts) -> bool:
    """Side effects we cannot thread through the branches: attribute/
    subscript stores, and STATEMENT-level calls (``cache.append(x)``) —
    a captured cond runs BOTH branches, so a mutating call would run regardless
    of the predicate. (Value-producing calls inside assignments are assumed
    pure, the contract a cond that runs both branches imposes.)"""
    class V(ast.NodeVisitor):
        found = False

        def visit_Attribute(self, n):
            if isinstance(n.ctx, ast.Store):
                self.found = True
            self.generic_visit(n)

        def visit_Subscript(self, n):
            if isinstance(n.ctx, ast.Store):
                self.found = True
            self.generic_visit(n)

        def visit_Expr(self, n):
            if isinstance(n.value, ast.Call):
                self.found = True   # bare call: presumed side-effecting
            self.generic_visit(n)

    v = V()
    for s in stmts:
        v.visit(s)
    return v.found


def _definitely_bound(stmts) -> set:
    """Names guaranteed bound after the statements run on EVERY path — a
    name assigned only inside one if-branch or a possibly-zero-iteration
    loop is NOT definite (reading it later may raise in eager python, so
    the rewrite must not turn it into an unconditional call-site load)."""
    out = set()
    for s in stmts:
        if isinstance(s, ast.If):
            out |= (_definitely_bound(s.body) & _definitely_bound(s.orelse))
        elif isinstance(s, (ast.While, ast.For, ast.Try)):
            pass                      # may run zero times / partially
        else:
            out |= _assigned_names([s])
    return out


def _free_reads(stmts, pre_bound=()) -> set:
    """Names READ before being written, walking statements in order — a
    branch-local temporary (``t = ...; y = t + 1``) is not a free read and
    must not become a call-site input."""
    bound = set(pre_bound)
    free = set()

    def reads(node):
        free.update(_loaded_names(node) - bound)

    for s in stmts:
        if isinstance(s, ast.Assign):
            reads(s.value)
            bound |= _assigned_names([s])
        elif isinstance(s, ast.AugAssign):
            reads(s.value)
            if isinstance(s.target, ast.Name) and s.target.id not in bound:
                free.add(s.target.id)
            bound |= _assigned_names([s])
        elif isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef)):
            own = _param_names(s.args) | _assigned_names(s.body)
            free.update((_loaded_names(ast.Module(body=list(s.body),
                                                  type_ignores=[])) - own)
                        - bound)
            bound.add(s.name)
        elif isinstance(s, ast.If):
            reads(s.test)
            free.update(_free_reads(s.body, bound))
            free.update(_free_reads(s.orelse, bound))
            bound |= (_assigned_names(s.body) | _assigned_names(s.orelse))
        else:
            reads(s)
            bound |= _assigned_names([s])
    return free


# ---------------------------------------------------------------------------
# the transformer
# ---------------------------------------------------------------------------

def _names_tuple(names, ctx):
    return ast.Tuple(elts=[ast.Name(id=n, ctx=ctx()) for n in names],
                     ctx=ctx())


def _names_target(names, ctx):
    """Single name -> bare Name node; several -> Tuple (keeps 1-output
    control flow a pytree LEAF end to end, which the autograd tape's
    single-output cotangent path requires)."""
    if len(names) == 1:
        return ast.Name(id=names[0], ctx=ctx())
    return _names_tuple(names, ctx)


class _ControlFlowTransformer:
    """Statement-ordered rewriter: walking each block in order tracks which
    names are BOUND before a given if/while, which decides both the
    call-site inputs (must be bound) and the outputs (a name assigned in
    only one branch is an output only if it was bound before — the other
    branch then passes the incoming value through; a one-sided NEW name
    stays branch-local, same as the reference's UndefinedVar stance)."""

    def __init__(self, local_names: set):
        self.locals = set(local_names)
        self.n = 0

    def transform_function(self, fdef):
        fdef.body = self._block(fdef.body, _param_names(fdef.args))
        return fdef

    def _block(self, stmts, bound, rest=frozenset()):
        """``bound`` tracks names DEFINITELY bound on every path — a
        conditional assignment must not license an unconditional call-site
        load further down."""
        out = []
        for i, s in enumerate(stmts):
            # names the REST of the function may read: the tail of this
            # block plus whatever the enclosing blocks read after us
            tail_reads = _free_reads(stmts[i + 1:]) | set(rest)
            if isinstance(s, ast.If):
                new, defb = self._if(s, bound, tail_reads)
                out.extend(new)
                bound |= defb
            elif isinstance(s, ast.While):
                new, defb = self._while(s, bound, tail_reads)
                out.extend(new)
                bound |= defb
            elif isinstance(s, ast.For):
                new, defb = self._for_range(s, bound, tail_reads)
                out.extend(new)
                bound |= defb
            elif isinstance(s, ast.With):
                # loop bodies re-read their own names across iterations —
                # count the whole statement's loads as "later reads"
                sub_rest = tail_reads | _loaded_names(s)
                s.body = self._block(s.body, set(bound), sub_rest)
                if getattr(s, "orelse", None):
                    s.orelse = self._block(s.orelse, set(bound), sub_rest)
                out.append(s)
                bound |= _definitely_bound([s])
            else:
                out.append(s)
                bound |= _assigned_names([s])
        return out

    # -- if/elif/else -------------------------------------------------------
    def _if(self, node: ast.If, bound, rest=frozenset()):
        node.body = self._block(node.body, set(bound), rest)
        node.orelse = self._block(node.orelse, set(bound), rest)
        branches = node.body + node.orelse
        if _has_jump(branches) or _has_object_store(branches):
            return [node], _definitely_bound([node])
        a_t = _assigned_names(node.body) & self.locals
        a_f = _assigned_names(node.orelse) & self.locals
        # outputs: assigned on both paths, or assigned on one path with a
        # pre-bound value flowing through the other
        outs = sorted((a_t & a_f) | ((a_t | a_f) & bound))
        if not outs:
            return [node], _definitely_bound([node])
        # a one-sided NEW name (no pre-bound value, not assigned on the
        # other path) becomes branch-local in the rewrite. That is fine for
        # genuine temporaries, but if anything LATER reads the name the
        # rewrite would silently drop a live binding — leave the if
        # untouched instead (python-bool branches keep exact eager
        # semantics, tensor predicates fail loudly at trace)
        if ((a_t | a_f) - set(outs)) & set(rest):
            return [node], _definitely_bound([node])
        reads = (_free_reads(node.body) | _free_reads(node.orelse)
                 | _loaded_names(node.test))
        ins = sorted(((reads | set(outs)) & self.locals & bound))
        i = self.n
        self.n += 1

        def mk_branch(name, body):
            body = list(body) or [ast.Pass()]
            body.append(ast.Return(value=_names_target(outs, ast.Load)))
            return ast.FunctionDef(
                name=name,
                args=ast.arguments(
                    posonlyargs=[], args=[ast.arg(arg=a) for a in ins],
                    kwonlyargs=[], kw_defaults=[], defaults=[]),
                body=body, decorator_list=[], type_params=[])

        t_name, f_name = f"__pt_true_{i}", f"__pt_false_{i}"
        call = ast.Assign(
            targets=[_names_target(outs, ast.Store)],
            value=ast.Call(
                func=ast.Attribute(
                    value=ast.Name(id="__pt_jst", ctx=ast.Load()),
                    attr="convert_ifelse", ctx=ast.Load()),
                args=[node.test,
                      ast.Name(id=t_name, ctx=ast.Load()),
                      ast.Name(id=f_name, ctx=ast.Load()),
                      _names_tuple(ins, ast.Load)],
                keywords=[]))
        # the call site assigns every out unconditionally
        return ([mk_branch(t_name, node.body),
                 mk_branch(f_name, node.orelse), call], set(outs))

    # -- counted for --------------------------------------------------------
    def _for_range(self, node: ast.For, bound, rest=frozenset()):
        """``for i in range(...)`` with a clean body -> convert_range_for
        (jit.scan when the carry holds tensors: one trace instead of
        trip-count unrolls; see the runtime helper for the fallbacks).
        Anything else keeps python semantics (recursed body only)."""
        sub_rest = set(rest) | _loaded_names(node)
        node.body = self._block(node.body, set(bound), sub_rest)
        if node.orelse:
            node.orelse = self._block(node.orelse, set(bound), sub_rest)

        def keep():
            return [node], _definitely_bound([node])

        if (node.orelse or _has_jump(node.body)
                or _has_object_store(node.body)
                or not isinstance(node.target, ast.Name)
                or not (isinstance(node.iter, ast.Call)
                        and isinstance(node.iter.func, ast.Name)
                        and node.iter.func.id == "range"
                        and not node.iter.keywords)):
            return keep()
        tname = node.target.id
        assigned = _assigned_names(node.body) & self.locals
        loop = sorted((assigned - {tname}) & bound)
        if not loop:
            return keep()
        # the rewrite drops body-new names and the final index binding —
        # bail if anything later reads them (same stance as _while)
        if ((assigned - set(loop) - {tname}) | {tname}) & set(rest):
            return keep()
        i = self.n
        self.n += 1
        args = ast.arguments(
            posonlyargs=[],
            args=[ast.arg(arg=tname)] + [ast.arg(arg=a) for a in loop],
            kwonlyargs=[], kw_defaults=[], defaults=[])
        body_def = ast.FunctionDef(
            name=f"__pt_forbody_{i}", args=args,
            body=list(node.body) + [
                ast.Return(value=_names_tuple(loop, ast.Load))],
            decorator_list=[], type_params=[])
        call = ast.Assign(
            targets=[_names_tuple(loop, ast.Store)],
            value=ast.Call(
                func=ast.Attribute(
                    value=ast.Name(id="__pt_jst", ctx=ast.Load()),
                    attr="convert_range_for", ctx=ast.Load()),
                args=[ast.Tuple(elts=list(node.iter.args), ctx=ast.Load()),
                      ast.Name(id=f"__pt_forbody_{i}", ctx=ast.Load()),
                      _names_tuple(loop, ast.Load)],
                keywords=[]))
        return [body_def, call], set(loop)

    # -- while --------------------------------------------------------------
    def _while(self, node: ast.While, bound, rest=frozenset()):
        node.body = self._block(node.body, set(bound),
                                set(rest) | _loaded_names(node))
        if node.orelse or _has_jump(node.body) or \
                _has_object_store(node.body):
            return [node], set()
        # carry = mutated names with a pre-loop value (while_loop needs
        # an initial carry; body temporaries stay local to the body fn)
        assigned = _assigned_names(node.body) & self.locals
        loop = sorted(assigned & bound)
        if not loop:
            return [node], set()
        # a body-new name read later would be dropped by the rewrite
        if (assigned - set(loop)) & set(rest):
            return [node], set()
        i = self.n
        self.n += 1
        args = ast.arguments(
            posonlyargs=[], args=[ast.arg(arg=a) for a in loop],
            kwonlyargs=[], kw_defaults=[], defaults=[])
        cond_def = ast.FunctionDef(
            name=f"__pt_cond_{i}", args=args,
            body=[ast.Return(value=node.test)], decorator_list=[],
            type_params=[])
        body_def = ast.FunctionDef(
            name=f"__pt_body_{i}", args=args,
            body=list(node.body) + [
                ast.Return(value=_names_tuple(loop, ast.Load))],
            decorator_list=[], type_params=[])
        call = ast.Assign(
            targets=[_names_tuple(loop, ast.Store)],
            value=ast.Call(
                func=ast.Attribute(
                    value=ast.Name(id="__pt_jst", ctx=ast.Load()),
                    attr="convert_while", ctx=ast.Load()),
                args=[ast.Name(id=f"__pt_cond_{i}", ctx=ast.Load()),
                      ast.Name(id=f"__pt_body_{i}", ctx=ast.Load()),
                      _names_tuple(loop, ast.Load)],
                keywords=[]))
        return [cond_def, body_def, call], set(loop)


def ast_transform(fn: Callable) -> Callable:
    """Rewrite ``fn``'s tensor-dependent if/while into ``convert_*`` calls;
    returns the rebuilt function (closure values captured at transform
    time)."""
    try:
        src = textwrap.dedent(inspect.getsource(fn))
    except (OSError, TypeError) as e:
        raise Dy2StaticError(f"dy2static: source unavailable for "
                             f"{fn!r} ({e})") from None
    tree = ast.parse(src)
    fdef = tree.body[0]
    if not isinstance(fdef, (ast.FunctionDef, ast.AsyncFunctionDef)):
        raise Dy2StaticError("dy2static: expected a function definition")
    fdef.decorator_list = []

    local_names = _param_names(fdef.args) | _assigned_names(fdef.body)

    new_fdef = _ControlFlowTransformer(local_names).transform_function(fdef)
    ast.fix_missing_locations(new_fdef)

    # rebuild inside a factory taking the original closure's freevars
    free = fn.__code__.co_freevars
    factory = ast.FunctionDef(
        name="__pt_factory",
        args=ast.arguments(
            posonlyargs=[], args=[ast.arg(arg=v) for v in free],
            kwonlyargs=[], kw_defaults=[], defaults=[]),
        body=[new_fdef,
              ast.Return(value=ast.Name(id=new_fdef.name, ctx=ast.Load()))],
        decorator_list=[], type_params=[])
    module = ast.Module(body=[factory], type_ignores=[])
    ast.fix_missing_locations(module)

    glb = dict(fn.__globals__)
    import paddle_tpu_torch.jit.dy2static as _jst_mod
    glb["__pt_jst"] = _jst_mod
    code = compile(module, filename=f"<dy2static {fn.__name__}>",
                   mode="exec")
    ns: dict = {}
    exec(code, glb, ns)
    cells = [c.cell_contents for c in (fn.__closure__ or ())]
    new_fn = ns["__pt_factory"](*cells)
    functools.wraps(fn)(new_fn)
    return new_fn

"""The port's dy2static AST tier against the JAX package's: every case of
``tests/test_dy2static.py``, run through both packages on the same
inputs, each against the same expected values (exact, or ``rtol=1e-6``
where the case states it).

Tensor-dependent Python ``if`` / ``while`` / counted ``for`` inside
``to_static`` lower to ``jit.cond`` / ``jit.while_loop`` / ``jit.scan``,
engaged when the capture reads a tensor on the host. The port's lowering
suits a CUDA graph (``paddle_tpu_torch/jit/control_flow.py``): inside a
capture ``cond`` runs both branches and selects with ``torch.where``,
``while_loop`` replays its body's graph while the host reads the
predicate true, and ``scan`` unrolls its (static) trip count —
``test_scan_lowering_single_trace`` checks the JAX package's scan
primitive and the port's unrolled capture.
"""

import importlib

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
def t(P, a, sg=True):
    return P.to_tensor(np.asarray(a, np.float32), stop_gradient=sg)


class TestAstTransform:
    @BOTH
    def test_if_else_on_tensor(self, P):
        def f(x):
            if x.mean() > 0:
                y = x * 2.0
            else:
                y = x - 1.0
            return y + 1.0

        g = P.jit.dy2static.ast_transform(f)
        xp = t(P, [1.0, 2.0])
        xn = t(P, [-1.0, -2.0])
        np.testing.assert_allclose(g(xp).numpy(), [3.0, 5.0])
        np.testing.assert_allclose(g(xn).numpy(), [-1.0, -2.0])

    @BOTH
    def test_elif_chain(self, P):
        def f(x):
            if x.mean() > 1:
                y = x * 10.0
            elif x.mean() > 0:
                y = x * 2.0
            else:
                y = x * 0.0
            return y

        g = P.jit.dy2static.ast_transform(f)
        np.testing.assert_allclose(g(t(P, [2.0])).numpy(), [20.0])
        np.testing.assert_allclose(g(t(P, [0.5])).numpy(), [1.0])
        np.testing.assert_allclose(g(t(P, [-3.0])).numpy(), [0.0])

    @BOTH
    def test_while_on_tensor(self, P):
        def f(x):
            s = x * 0.0 + 1.0
            while s.sum() < 100.0:
                s = s * 2.0
            return s

        g = P.jit.dy2static.ast_transform(f)
        out = float(g(t(P, [1.0])).numpy()[0])
        assert out == 128.0  # first power of 2 with sum >= 100

    @BOTH
    def test_python_bool_keeps_python_semantics(self, P):
        def f(x, flag):
            if flag:                   # plain python predicate
                y = x + 1.0
            else:
                y = x - 1.0
            return y

        g = P.jit.dy2static.ast_transform(f)
        np.testing.assert_allclose(g(t(P, [1.0]), True).numpy(), [2.0])
        np.testing.assert_allclose(g(t(P, [1.0]), False).numpy(), [0.0])

    @BOTH
    def test_closure_and_nested_if(self, P):
        scale = 3.0

        def f(x):
            if x.mean() > 0:
                if x.mean() > 10:
                    y = x * scale * 2.0
                else:
                    y = x * scale
            else:
                y = x
            return y

        g = P.jit.dy2static.ast_transform(f)
        np.testing.assert_allclose(g(t(P, [1.0])).numpy(), [3.0])
        np.testing.assert_allclose(g(t(P, [20.0])).numpy(), [120.0])
        np.testing.assert_allclose(g(t(P, [-1.0])).numpy(), [-1.0])

    @BOTH
    def test_gradients_flow_through_rewritten_if(self, P):
        def f(x):
            if x.sum() > 0:
                y = x * 2.0
            else:
                y = x * 3.0
            return y.sum()

        g = P.jit.dy2static.ast_transform(f)
        x = t(P, [1.0, 1.0], sg=False)
        g(x).backward()
        np.testing.assert_allclose(x.grad.numpy(), [2.0, 2.0])
        x2 = t(P, [-1.0, -1.0], sg=False)
        g(x2).backward()
        np.testing.assert_allclose(x2.grad.numpy(), [3.0, 3.0])

    @BOTH
    def test_branch_with_return_left_untouched(self, P):
        def f(x):
            if x.mean() > 0:       # early return: out of rewrite scope
                return x * 2.0
            return x

        g = P.jit.dy2static.ast_transform(f)       # transform succeeds (node untouched)...
        out = g(t(P, [1.0]))          # ...and still works EAGERLY
        np.testing.assert_allclose(out.numpy(), [2.0])


class TestToStaticFallback:
    @BOTH
    def test_tensor_if_compiles_via_fallback(self, P):
        calls = {"n": 0}

        @P.jit.to_static
        def step(x):
            calls["n"] += 1
            if x.mean() > 0:
                y = x * 2.0
            else:
                y = x - 5.0
            return y.sum()

        xp = t(P, [1.0, 3.0])
        a = float(step(xp))      # warmup (eager)
        b = float(step(xp))      # compile: trace fails -> dy2static retry
        c = float(step(xp))      # cached program
        assert a == b == c == 8.0
        xn = t(P, [-1.0, -3.0])
        assert float(step(xn)) == -14.0   # both branches live in ONE program
        assert step._ast_fn is not None   # the fallback actually engaged
        # warmup + failed trace + transformed trace; NOT re-run per call
        assert calls["n"] <= 4

    @BOTH
    def test_tensor_while_compiles(self, P):
        @P.jit.to_static
        def grow(x):
            s = x * 0.0 + 1.0
            while s.sum() < 10.0:
                s = s + 1.0
            return s

        x = t(P, [0.0])
        float(grow(x).numpy()[0])                 # warmup
        out = float(grow(x).numpy()[0])           # compiled via fallback
        assert out == 10.0

    @BOTH
    def test_unsupported_gets_actionable_error(self, P):
        @P.jit.to_static
        def bad(x):
            if x.mean() > 0:
                return x * 2.0      # early return: not rewritable
            return x

        x = t(P, [1.0])
        bad(x)                      # warmup ok (eager)
        with pytest.raises(RuntimeError, match="dy2static"):
            bad(x)


class TestReviewRegressions:
    @BOTH
    def test_branch_local_temporary(self, P):
        """A temp assigned-then-read inside the branch must not become a
        required call-site input."""
        def f(x):
            if x.mean() > 0:
                tmp = x * 2.0
                y = tmp + 1.0
            else:
                y = x
            return y

        g = P.jit.dy2static.ast_transform(f)
        np.testing.assert_allclose(g(t(P, [1.0])).numpy(), [3.0])
        np.testing.assert_allclose(g(t(P, [-1.0])).numpy(), [-1.0])

    @BOTH
    def test_while_body_temporary(self, P):
        def f(x):
            s = x * 0.0
            while s.sum() < 3.0:
                step = x * 0.0 + 1.0
                s = s + step
            return s

        g = P.jit.dy2static.ast_transform(f)
        np.testing.assert_allclose(g(t(P, [0.0])).numpy(), [3.0])

    @BOTH
    def test_mutating_call_left_untouched(self, P):
        """cache.append in a branch: lax.cond would run it for BOTH
        branches at trace time — the rewrite must refuse."""
        cache = []

        def f(x):
            if x.mean() > 0:
                cache.append(1)
                y = x * 2.0
            else:
                y = x
            return y

        g = P.jit.dy2static.ast_transform(f)        # if left as plain python
        g(t(P, [1.0]))
        g(t(P, [1.0]))
        assert cache == [1, 1]      # ran exactly per taken branch (eager)

    @BOTH
    def test_failed_transform_does_not_poison(self, P):
        @P.jit.to_static
        def bad(x):
            if x.mean() > 0:
                return x * 2.0      # unsupported: early return
            return x

        x = t(P, [1.0])
        bad(x)                                          # warmup
        with pytest.raises(RuntimeError, match="dy2static"):
            bad(x)
        with pytest.raises(RuntimeError, match="dy2static"):
            bad(x)                  # SAME actionable error, not a raw crash

    @BOTH
    def test_layer_forward_fallback(self, P):
        nn = P.nn

        class Gated(nn.Layer):
            def __init__(self):
                super().__init__()
                self.fc = nn.Linear(4, 4)

            def forward(self, x):
                h = self.fc(x)
                if h.mean() > 100.0:
                    y = h * 0.0
                else:
                    y = h
                return y.sum()

        net = P.jit.to_static(Gated())
        x = t(P, np.ones((2, 4), np.float32))
        a = float(net(x))           # warmup
        b = float(net(x))           # compiled via the Layer-forward rewrite
        np.testing.assert_allclose(a, b, rtol=1e-6)
        assert net._static_function._ast_fn is not None

    @BOTH
    def test_one_sided_assignment_with_prebound_value(self, P):
        """`y = ...; if p: y = ...` — the else path must pass the incoming
        value through."""
        def f(x):
            y = x * 1.0
            if x.mean() > 0:
                y = x * 5.0
            return y

        g = P.jit.dy2static.ast_transform(f)
        np.testing.assert_allclose(g(t(P, [2.0])).numpy(), [10.0])
        np.testing.assert_allclose(g(t(P, [-2.0])).numpy(), [-2.0])

    @BOTH
    def test_one_sided_new_name_read_later_left_untouched(self, P):
        """A python-bool branch binding a NEW name read later must keep
        exact eager semantics (no silent drop)."""
        def f(x, flag):
            y = x * 1.0
            if flag:
                y = x * 5.0
                z = x + 1.0
            else:
                y = x - 1.0
            if flag:
                out = y + z
            else:
                out = y
            return out

        g = P.jit.dy2static.ast_transform(f)
        np.testing.assert_allclose(g(t(P, [2.0]), True).numpy(), [13.0])
        np.testing.assert_allclose(g(t(P, [2.0]), False).numpy(), [1.0])

    @BOTH
    def test_impure_python_while_condition_runs_once_per_check(self, P):
        """The dispatch probe must not consume an extra condition
        evaluation."""
        evals = []

        def f(x):
            s = x * 0.0
            while (evals.append(1) or len(evals)) <= 3:
                s = s + 1.0
            return s

        g = P.jit.dy2static.ast_transform(f)
        out = g(t(P, [0.0]))
        np.testing.assert_allclose(out.numpy(), [3.0])
        assert len(evals) == 4      # 3 true checks + the final false one

    @BOTH
    def test_tensor_while_under_grad_refuses_loudly(self, P):
        """Forward-only while must not silently zero gradients
       ."""
        Dy2StaticError = P.jit.dy2static.Dy2StaticError

        def f(x):
            s = x * 1.0
            while s.sum() < 4.0:
                s = s * 2.0
            return s.sum()

        g = P.jit.dy2static.ast_transform(f)
        xg = t(P, [1.0], sg=False)
        with pytest.raises(Dy2StaticError, match="scan"):
            g(xg)
        # without gradients it runs fine
        out = g(t(P, [1.0]))
        assert float(out.numpy()) == 4.0


class TestCountedForToScan:
    """`for i in range(n)` over tensor-carried loop vars
    lowers to jit.scan (one trace, differentiable) instead of trace-time
    unrolling; non-conforming loops keep exact python semantics."""

    @BOTH
    def test_parity_and_engagement(self, P):
        D = P.jit.dy2static

        def f(x, n):
            y = x
            for i in range(n):
                y = y * 2.0 + 0.1
            return y

        g = P.jit.dy2static.ast_transform(f)
        x = t(P, [1.0])
        np.testing.assert_allclose(g(x, 5).numpy(), f(x, 5).numpy(),
                                   rtol=1e-6)
        hits = []
        orig = D.convert_range_for
        D.convert_range_for = lambda *a: hits.append(a) or orig(*a)
        try:
            g(x, 7)
        finally:
            D.convert_range_for = orig
        assert hits, "rewrite did not engage"

    @BOTH
    def test_gradients_flow_through_scan(self, P):
        def h(w):
            y = w
            for i in range(4):
                y = y * 2.0
            return y.sum()

        hh = P.jit.dy2static.ast_transform(h)
        w = t(P, [1.0], sg=False)
        loss = hh(w)
        loss.backward()
        np.testing.assert_allclose(w.grad.numpy(), [16.0])

    @BOTH
    def test_scan_lowering_single_trace(self, P):
        """The counted loop lowers to scan inside the compiled program:
        the JAX package's jaxpr holds one scan (its op count does not grow
        with the 64 trips); the port's capture holds the 64 unrolled trips
        (a CUDA graph replays a fixed kernel list) and its replays equal
        eager."""
        def f(x):
            y = x
            for i in range(64):
                y = y * 2.0 + 0.1
            return y

        g = P.jit.dy2static.ast_transform(f)
        if P is J:
            import jax
            import jax.numpy as jnp
            from paddle_tpu.core.tensor import _wrap_value
            jaxpr = jax.make_jaxpr(
                lambda v: g(_wrap_value(v, stop_gradient=True))._value)(
                    jnp.ones((2,)))
            assert any(e.primitive.name == "scan"
                       for e in jaxpr.eqns), jaxpr
            assert len(jaxpr.eqns) < 20   # 64 iterations did not unroll
            return
        D = P.jit.dy2static
        hits = []
        orig = D.convert_range_for
        D.convert_range_for = lambda *a: hits.append(1) or orig(*a)
        try:
            sf = P.jit.to_static(g)
            x = t(P, [1.0, -0.5])
            outs = [sf(x).numpy() for _ in range(3)]
        finally:
            D.convert_range_for = orig
        assert len(hits) == 2             # the warm-up and the capture
        for o in outs:
            np.testing.assert_allclose(o, f(x).numpy(), rtol=1e-6)

    @BOTH
    def test_shape_growing_body_falls_back(self, P):
        def grow(x, n):
            y = x
            for i in range(n):
                y = P.concat([y, y], axis=0)
            return y

        gg = P.jit.dy2static.ast_transform(grow)
        assert gg(t(P, [1.0]), 3).shape == [8]

    @BOTH
    def test_index_read_after_loop_keeps_python(self, P):
        def tail(x, n):
            for i in range(n):
                x = x + 1.0
            return x, i

        tt = P.jit.dy2static.ast_transform(tail)
        out, last = tt(t(P, [0.0]), 4)
        assert last == 3
        np.testing.assert_allclose(out.numpy(), [4.0])

    @BOTH
    def test_python_only_carry_unchanged(self, P):
        def acc(n):
            s = 0
            for i in range(n):
                s = s + i
            return s

        assert P.jit.dy2static.ast_transform(acc)(5) == 10

"""The port's SOT tier (``to_static(backend="sot")``) against the JAX
package's: every case of ``tests/test_sot.py``, run through both packages
on the same inputs, each against the same expected values.

Oracles: eager execution (capture runs ARE eager, so every compiled
result is checked against a plain eager call); compiled-path reuse is
asserted by counting Python-body executions — a compiled call must not
re-run the body. In the port a path's program is a captured CUDA graph
(on the CPU, a recording of its ATen operations: ``jit/trace.py``), its
materialization events are outputs of the graph read after each replay,
and a diverged run is rolled back by copying back the state values taken
before it.
"""

import importlib
import warnings

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


def _sot(P):
    return importlib.import_module(P.__name__ + ".jit.sot")
def t(P, a, sg=True):
    return P.to_tensor(np.asarray(a, np.float32), stop_gradient=sg)




class TestReturnInBranch:
    """The AST tier leaves branches containing `return` untouched; SOT
    compiles each return path as its own program."""

    @BOTH
    def test_both_paths_compile_and_match_eager(self, P):
        def f(x):
            if x.mean() > 0:
                return x * 2.0
            return x - 1.0

        sf = P.jit.to_static(f, backend="sot")
        xp, xn = t(P, [1.0, 2.0]), t(P, [-1.0, -2.0])
        np.testing.assert_allclose(sf(xp).numpy(), [2.0, 4.0])  # warmup
        np.testing.assert_allclose(sf(xp).numpy(), [2.0, 4.0])  # capture
        np.testing.assert_allclose(sf(xp).numpy(), [2.0, 4.0])  # compiled
        np.testing.assert_allclose(sf(xn).numpy(), [-2.0, -3.0])
        np.testing.assert_allclose(sf(xn).numpy(), [-2.0, -3.0])
        entry = next(iter(sf._entries.values()))[0]
        assert len(entry.paths) == 2          # one program per return path

    @BOTH
    def test_compiled_call_skips_python_body(self, P):
        count = [0]

        def f(x):
            count[0] += 1             # python side effect: capture-only
            if x.sum() > 0:
                return x + 1.0
            return x - 1.0

        sf = P.jit.to_static(f, backend="sot")
        x = t(P, [3.0])
        sf(x)                         # warmup (eager)
        sf(x)                         # capture (eager; compile traces run
        n = count[0]                  # the body too, but lazily later)
        out = sf(x)                   # compiled replay after trace
        out2 = sf(x)                  # steady state: body must NOT run
        assert count[0] >= n
        n2 = count[0]
        sf(x)
        assert count[0] == n2         # no body execution once compiled
        np.testing.assert_allclose(out.numpy(), [4.0])
        np.testing.assert_allclose(out2.numpy(), [4.0])


class TestDy2StaticSuiteViaSot:
    """The AST-tier scenarios, through the bytecode tier."""

    @BOTH
    def test_if_else_on_tensor(self, P):
        def f(x):
            if x.mean() > 0:
                y = x * 2.0
            else:
                y = x - 1.0
            return y + 1.0

        sf = P.jit.to_static(f, backend="sot")
        for _ in range(3):
            np.testing.assert_allclose(sf(t(P, [1.0, 2.0])).numpy(), [3.0, 5.0])
            np.testing.assert_allclose(sf(t(P, [-1.0, -2.0])).numpy(),
                                       [-1.0, -2.0])

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

        sf = P.jit.to_static(f, backend="sot")
        for _ in range(3):
            np.testing.assert_allclose(sf(t(P, [2.0])).numpy(), [20.0])
            np.testing.assert_allclose(sf(t(P, [0.5])).numpy(), [1.0])
            np.testing.assert_allclose(sf(t(P, [-3.0])).numpy(), [0.0])

    @BOTH
    def test_while_on_tensor(self, P):
        def f(x):
            s = x * 0.0 + 1.0
            while s.sum() < 100.0:
                s = s * 2.0
            return s

        sf = P.jit.to_static(f, backend="sot")
        for _ in range(3):
            assert float(sf(t(P, [1.0])).numpy()[0]) == 128.0

    @BOTH
    def test_python_bool_keeps_python_semantics(self, P):
        def f(x, flag):
            if flag:
                return x + 1.0
            return x - 1.0

        sf = P.jit.to_static(f, backend="sot")
        for _ in range(3):
            np.testing.assert_allclose(sf(t(P, [0.0]), True).numpy(), [1.0])
            np.testing.assert_allclose(sf(t(P, [0.0]), False).numpy(), [-1.0])

    @BOTH
    def test_gradients_flow_through_branch(self, P):
        """backward() runs INSIDE the compiled region (the to_static train-
        step contract); the Parameter's grad is state the program returns."""
        w = P.Parameter(np.asarray([1.0, 2.0], np.float32))

        def f(x):
            y = (w * x).sum()
            if y > 0:
                loss = y * 3.0
            else:
                loss = y * 5.0
            loss.backward()
            g = w.grad
            w.clear_grad()
            return g

        sf = P.jit.to_static(f, backend="sot")
        for expect, sign in ((3.0, 1.0), (3.0, 1.0), (5.0, -1.0),
                             (5.0, -1.0), (3.0, 1.0)):
            g = sf(t(P, [sign * 1.0, sign * 2.0]))
            np.testing.assert_allclose(
                g.numpy(), [expect * sign * 1.0, expect * sign * 2.0])


class TestBeyondAstTier:
    @BOTH
    def test_data_dependent_for_loop(self, P):
        """for i in range(int(t)) — specialized per trip count."""
        def f(x, n):
            y = x
            for _ in range(int(n)):
                y = y * 2.0
            return y

        sf = P.jit.to_static(f, backend="sot")
        n3 = P.to_tensor(np.int32(3))
        n5 = P.to_tensor(np.int32(5))
        for _ in range(3):
            np.testing.assert_allclose(sf(t(P, [1.0]), n3).numpy(), [8.0])
            np.testing.assert_allclose(sf(t(P, [1.0]), n5).numpy(), [32.0])

    @BOTH
    def test_gradients_through_tensor_while(self, P):
        """The AST tier REFUSES grads through tensor `while` (lax.while_loop
        is forward-only); SOT unrolls the captured path, so backward works."""
        w = P.Parameter(np.asarray([1.0], np.float32))

        def f(x):
            y = w * x
            while y.sum() < 10.0:     # tensor-dependent while
                y = y * 2.0
            loss = y.sum()
            loss.backward()
            g = w.grad
            w.clear_grad()
            return loss, g

        sf = P.jit.to_static(f, backend="sot")
        for _ in range(4):
            loss, g = sf(t(P, [1.0]))
            # 1 -> 2 -> 4 -> 8 -> 16: four doublings, dloss/dw = 16
            assert float(loss.numpy()) == 16.0
            np.testing.assert_allclose(g.numpy(), [16.0])

    @BOTH
    def test_attribute_store_in_branch(self, P):
        """Object mutation in a branch (AST tier bails) — capture runs it,
        replay bakes the captured path."""
        class Box:
            pass

        box = Box()

        def f(x):
            if x.mean() > 0:
                box.mode = "pos"
                return x * 2.0
            box.mode = "neg"
            return x * -1.0

        sf = P.jit.to_static(f, backend="sot")
        for _ in range(3):
            np.testing.assert_allclose(sf(t(P, [2.0])).numpy(), [4.0])
        assert box.mode == "pos"


class TestGraphBreak:
    @BOTH
    def test_numpy_materialization_falls_back_eager(self, P):
        def f(x):
            if x.mean() > 0:
                arr = x.numpy()           # hard break inside compile trace
                return x * float(arr.sum())
            return x

        sf = P.jit.to_static(f, backend="sot")
        x = t(P, [1.0, 2.0])
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            sf(x)                         # capture + compile -> graph break
            # (no warmup call — the FIRST call captures)
            out = sf(x)                   # eager fallback thereafter
            np.testing.assert_allclose(out.numpy(), [3.0, 6.0])
        entry = next(iter(sf._entries.values()))[0]
        assert entry.eager_only is not None
        assert any("graph break" in str(x.message).lower()
                   or "eager" in str(x.message).lower() for x in w)
        # subsequent calls keep working (eagerly)
        np.testing.assert_allclose(sf(x).numpy(), [3.0, 6.0])

    @BOTH
    def test_per_call_scalar_overflows_path_table(self, P):
        """A float() whose value changes every call can never replay — the
        path table LRU-evicts (capped live size), and only sustained churn
        demotes the signature to eager (eviction, not immediate
        permanent demotion), still correct throughout."""
        _MAX_CHURN, _MAX_PATHS = _sot(P)._MAX_CHURN, _sot(P)._MAX_PATHS

        def f(x):
            s = float(x.sum())            # different every call
            return x * s

        sf = P.jit.to_static(f, backend="sot")
        with warnings.catch_warnings(record=True):
            warnings.simplefilter("always")
            for i in range(1, _MAX_CHURN + 6):
                x = t(P, [float(i)])
                np.testing.assert_allclose(sf(x).numpy(), [float(i) ** 2])
                entry = next(iter(sf._entries.values()))[0]
                # the live table never exceeds the LRU cap
                assert len(entry.paths) <= _MAX_PATHS
        entry = next(iter(sf._entries.values()))[0]
        assert entry.eager_only is not None


class TestGuards:
    @BOTH
    def test_closure_const_guard_invalidation_recompiles(self, P):
        scale = 2.0

        def f(x):
            return x * scale

        sf = P.jit.to_static(f, backend="sot")
        x = t(P, [1.0, 2.0])
        sf(x)                                     # warmup
        np.testing.assert_allclose(sf(x).numpy(), [2.0, 4.0])   # capture
        np.testing.assert_allclose(sf(x).numpy(), [2.0, 4.0])   # compiled
        sig_entries = next(iter(sf._entries.values()))
        assert len(sig_entries) == 1
        scale = 7.0                               # invalidate the guard
        np.testing.assert_allclose(sf(x).numpy(), [7.0, 14.0])
        np.testing.assert_allclose(sf(x).numpy(), [7.0, 14.0])
        assert len(sig_entries) == 2              # recompiled under new guard

    @BOTH
    def test_global_const_guard(self, P):
        globals()["_GLOBAL_K"] = 3.0

        def f(x):
            return x + _GLOBAL_K

        sf = P.jit.to_static(f, backend="sot")
        x = t(P, [1.0])
        sf(x)
        np.testing.assert_allclose(sf(x).numpy(), [4.0])
        np.testing.assert_allclose(sf(x).numpy(), [4.0])
        globals()["_GLOBAL_K"] = 10.0
        np.testing.assert_allclose(sf(x).numpy(), [11.0])

    @BOTH
    def test_bytecode_scan_finds_guard_sources(self, P):
        k = 5

        def f(x):
            return x * k + _GLOBAL_K2

        snap = _sot(P)._code_guard_snapshot(f)
        assert snap.get("c:k") == 5
        assert snap.get("g:_GLOBAL_K2") == 9.0

    @BOTH
    def test_shape_guard_separate_entries(self, P):
        def f(x):
            if x.mean() > 0:
                return x * 2.0
            return x

        sf = P.jit.to_static(f, backend="sot")
        a = t(P, [1.0, 2.0])
        b = t(P, [[1.0], [2.0]])
        for _ in range(3):
            np.testing.assert_allclose(sf(a).numpy(), [2.0, 4.0])
            np.testing.assert_allclose(sf(b).numpy(), [[2.0], [4.0]])
        assert len(sf._entries) == 2      # one signature per shape


_GLOBAL_K = 3.0
_GLOBAL_K2 = 9.0


class TestLayerAndState:
    @BOTH
    def test_layer_forward_with_branch(self, P):
        nn = P.nn

        class Net(nn.Layer):
            def __init__(self):
                super().__init__()
                self.fc = nn.Linear(4, 4)

            def forward(self, x):
                h = self.fc(x)
                if h.mean() > 0:
                    return h * 2.0
                return h * -1.0

        net = Net()
        sf = P.jit.to_static(net, backend="sot")
        rng = np.random.default_rng(0)
        x = P.to_tensor(rng.standard_normal((2, 4)).astype(np.float32))
        outs = [sf(x).numpy() for _ in range(4)]
        for o in outs[1:]:
            np.testing.assert_allclose(o, outs[0], rtol=1e-5)

    @BOTH
    def test_train_step_with_branch_updates_state(self, P):
        """State mutation (optimizer step) compiles through the sot path —
        the CompiledProgram state binding underneath is shared machinery."""
        nn = P.nn
        SGD = P.optimizer.SGD

        net = nn.Linear(2, 1)
        opt = SGD(learning_rate=0.01, parameters=net.parameters())
        xs = P.to_tensor(np.array([[0.1, 0.2], [0.3, 0.4]], np.float32))
        ys = P.to_tensor(np.array([[1.0], [2.0]], np.float32))

        def step(x, y):
            loss = ((net(x) - y) ** 2).mean()
            if loss > 1.0:                # tensor-dependent branch
                loss = loss * 0.5
            loss.backward()
            opt.step()
            opt.clear_grad()
            return loss

        sf = P.jit.to_static(step, backend="sot")
        losses = [float(sf(xs, ys).numpy()) for _ in range(20)]
        assert losses[-1] < losses[0]     # training proceeds through replays
        entry = next(iter(sf._entries.values()))[0]
        assert entry.paths                # at least one compiled path ran


class TestR5Hardening:
    """LRU eviction, first-call compile,
    container guards, side-effect detection."""

    @BOTH
    def test_first_call_compiles(self, P):
        def f(x):
            if x.sum() > 0:
                return x + 1.0
            return x - 1.0

        sf = P.jit.to_static(f, backend="sot")
        x = t(P, [2.0])
        np.testing.assert_allclose(sf(x).numpy(), [3.0])
        entry = next(iter(sf._entries.values()))[0]
        assert len(entry.paths) == 1   # compiled on the FIRST call

    @BOTH
    def test_lru_evicted_path_recompiles_on_recurrence(self, P):
        _MAX_PATHS = _sot(P)._MAX_PATHS

        def f(x, k):
            # k distinct trip counts -> k distinct paths
            i = 0
            while i < int(x[0]):
                i += 1
            return x * float(i)

        sf = P.jit.to_static(f, backend="sot")
        # fill the table past the cap with distinct paths (same input sig)
        for v in range(1, _MAX_PATHS + 3):
            np.testing.assert_allclose(sf(t(P, [float(v)]), 0).numpy(),
                                       [float(v) ** 2])
        entry = next(iter(sf._entries.values()))[0]
        assert entry.eager_only is None          # NOT demoted
        assert len(entry.paths) <= _MAX_PATHS    # LRU held the cap
        # the evicted earliest path still computes correctly (recompiles)
        np.testing.assert_allclose(sf(t(P, [1.0]), 0).numpy(), [1.0])

    @BOTH
    def test_mutated_list_closure_invalidates_guard(self, P):
        cfg = [2.0]

        def f(x):
            if x.sum() > 0:
                return x * cfg[0]
            return x

        sf = P.jit.to_static(f, backend="sot")
        x = t(P, [3.0])
        np.testing.assert_allclose(sf(x).numpy(), [6.0])
        np.testing.assert_allclose(sf(x).numpy(), [6.0])  # compiled replay
        cfg[0] = 5.0                     # external mutation of the closure
        # this used to serve the stale compiled path (12.0);
        # the content-digest guard now recompiles
        np.testing.assert_allclose(sf(x).numpy(), [15.0])

    @BOTH
    def test_mutated_ndarray_global_invalidates_guard(self, P):
        jit = P.jit
        arr = np.array([2.0, 3.0], np.float32)

        def f(x):
            if x.sum() > 0:
                return x * float(arr[0])
            return x

        sf = P.jit.to_static(f, backend="sot")
        x = t(P, [1.0])
        np.testing.assert_allclose(sf(x).numpy(), [2.0])
        arr[0] = 7.0
        np.testing.assert_allclose(sf(x).numpy(), [7.0])

    @BOTH
    def test_side_effect_warning_fires_once(self, P):
        log = []

        def f(x):
            log.append(1)                # STORE-op side effect
            if x.sum() > 0:
                return x + 1.0
            return x

        sf = P.jit.to_static(f, backend="sot")
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            sf(t(P, [1.0]))
            sf(t(P, [1.0]))
        msgs = [str(x.message) for x in w
                if "side effect" in str(x.message).lower()]
        assert len(msgs) == 1, msgs

    @BOTH
    def test_self_mutating_counter_still_compiles(self, P):
        """A function that mutates its own closure must NOT thrash-compile
        (container guards are skipped for self-mutating code)."""
        count = [0]

        def f(x):
            count[0] += 1
            if x.sum() > 0:
                return x + 1.0
            return x

        sf = P.jit.to_static(f, backend="sot")
        x = t(P, [1.0])
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            sf(x)
            sf(x)
            n = count[0]
            sf(x)
            sf(x)
        assert count[0] == n             # compiled replays skip the body

    @BOTH
    def test_unrelated_local_subscr_store_keeps_container_guard(self, P):
        """`x = cfg[k]; buf[i] = x` — a subscript
        store into an unrelated LOCAL right after a container load — must
        NOT drop the guard on the read-only global: external mutation of
        the container must invalidate the compiled path, not serve it
        stale."""
        _container_mutated_names = _sot(P)._container_mutated_names
        cfg = [2.0]

        def f(x):
            scale = cfg[0]               # read-only use of the closure
            buf = {}
            buf[0] = scale               # store targets the LOCAL buf
            if x.sum() > 0:
                return x * buf[0]
            return x

        assert "cfg" not in _container_mutated_names(f.__code__)
        sf = P.jit.to_static(f, backend="sot")
        x = t(P, [3.0])
        np.testing.assert_allclose(sf(x).numpy(), [6.0])
        np.testing.assert_allclose(sf(x).numpy(), [6.0])  # compiled replay
        cfg[0] = 5.0                     # external mutation
        # the old 12-instruction window marked cfg as self-mutated here,
        # suppressed its guard, and replayed the stale 2.0 path (-> 6.0)
        np.testing.assert_allclose(sf(x).numpy(), [15.0])

    @BOTH
    def test_chained_subscript_store_still_marks_container(self, P):
        """The symbolic-stack scan must keep the TRUE positives: a store
        through a chained subscript/attr (`cfg[i][j] = v`) and a mutating
        method load still mark the container, so self-mutating code keeps
        its guard suppression (no thrash-compile)."""
        _container_mutated_names = _sot(P)._container_mutated_names
        nested = [[0.0]]
        log = []

        def g(x):
            nested[0][0] = float(x.sum())
            log.append(1)
            return x

        marked = _container_mutated_names(g.__code__)
        assert "nested" in marked and "log" in marked

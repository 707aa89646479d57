"""The port's ``paddle.jit`` against the JAX package's: every case of
``tests/test_jit.py``, run through both packages.

The port captures a program into a CUDA graph on the card; on the CPU
the same program records the ATen operations the step dispatches and
replays the recording (``paddle_tpu_torch/jit/trace.py``), so the cases
here exercise the capture, the state binding, the write-back, the host
scalars and the fresh random draws that the card runs. Twins start from
the same weights (the port's layer loaded from the JAX layer's
``state_dict()``) and take the same numpy inputs. Tolerances: single
outputs ``rtol=1e-6``; training trajectories ``rtol=1e-4, atol=1e-6``
(``test_loss_trajectory_parity``'s); the ``jit.save`` / ``jit.load``
round trip ``1e-5``.

The Python function of a compiled call runs once for the eager warm-up
and once for the capture, and not again: the reference runs it once more
(its discovery and compile traces are two).
"""

import io
import os
import pickle

import numpy as np
import pytest
import torch

import paddle_tpu as J
import paddle_tpu_torch as T

BOTH = pytest.mark.parametrize("P", [J, T], ids=["jax", "torch"])


@pytest.fixture(autouse=True)
def _port_on_cpu():
    prev = T.get_device()
    T.set_device("cpu")
    yield
    T.set_device(prev)


def make_data(n=32, din=4):
    rng = np.random.RandomState(7)
    X = rng.rand(n, din).astype(np.float32)
    Y = (X @ rng.rand(din, 1).astype(np.float32) + 0.1).astype(np.float32)
    return X, Y


def twin(build, seed=0):
    J.seed(seed)
    jl = build(J)
    tl = build(T)
    tl.set_state_dict({k: v.numpy() for k, v in jl.state_dict().items()})
    return jl, tl


class TestFunctionCompile:
    @BOTH
    def test_pure_fn_parity_and_cache(self, P):
        calls = {"n": 0}

        @P.jit.to_static
        def f(x, y):
            calls["n"] += 1
            return P.matmul(x, y) + 1.0

        rng = np.random.default_rng(0)
        a = P.to_tensor(rng.random((3, 4)).astype(np.float32))
        b = P.to_tensor(rng.random((4, 5)).astype(np.float32))
        want = (P.matmul(a, b) + 1.0).numpy()
        for _ in range(3):   # warm-up, build, cached program
            np.testing.assert_allclose(f(a, b).numpy(), want, rtol=1e-6)
        traces = 2 if P is J else 1     # the port captures once
        assert calls["n"] == 1 + traces
        a2 = P.to_tensor(rng.random((6, 4)).astype(np.float32))
        np.testing.assert_allclose(f(a2, b).numpy(),
                                   (P.matmul(a2, b) + 1.0).numpy(), rtol=1e-6)
        assert calls["n"] == 1 + 2 * traces      # a new shape: a new program

    @BOTH
    def test_static_kwargs_in_cache_key(self, P):
        @P.jit.to_static
        def f(x, flag=False):
            return x * 2 if flag else x * 3

        x = P.to_tensor(np.ones(2, np.float32))
        f(x, flag=True)
        assert f(x, flag=True).numpy()[0] == 2
        assert f(x, flag=False).numpy()[0] == 3
        assert f(x, flag=True).numpy()[0] == 2


def _train(P, model, opt, X, Y, steps, compiled):
    def step(x, y):
        loss = P.nn.functional.mse_loss(model(x), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    if compiled:
        step = P.jit.to_static(step)
    return [float(step(P.to_tensor(X), P.to_tensor(Y)).numpy())
            for _ in range(steps)]


def _mlp(P):
    return P.nn.Sequential(P.nn.Linear(4, 8), P.nn.Tanh(), P.nn.Linear(8, 1))


class TestTrainStepCompile:
    def test_loss_trajectory_parity(self):
        """8 compiled Adam steps: the port's equal its eager steps and the
        JAX package's compiled ones (1e-4), from the same weights."""
        X, Y = make_data()
        runs = {}
        for compiled in (False, True):
            jm, tm = twin(_mlp, seed=42)
            runs[("J", compiled)] = _train(
                J, jm, J.optimizer.Adam(0.05, parameters=jm.parameters()),
                X, Y, 8, compiled)
            runs[("T", compiled)] = _train(
                T, tm, T.optimizer.Adam(0.05, parameters=tm.parameters()),
                X, Y, 8, compiled)
        np.testing.assert_allclose(runs[("T", True)], runs[("T", False)],
                                   rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(runs[("T", True)], runs[("J", True)],
                                   rtol=1e-4, atol=1e-6)
        assert runs[("T", True)][-1] < runs[("T", True)][0]

    @BOTH
    def test_scheduler_lr_feeds_compiled_step(self, P):
        X, Y = make_data()
        P.seed(0)
        model = P.nn.Linear(4, 1)
        sched = P.optimizer.lr.StepDecay(learning_rate=0.5, step_size=1,
                                         gamma=0.1)
        opt = P.optimizer.SGD(learning_rate=sched,
                              parameters=model.parameters())

        @P.jit.to_static
        def step(x, y):
            loss = P.nn.functional.mse_loss(model(x), y)
            loss.backward()
            opt.step()
            opt.clear_grad()
            return loss

        x, y = P.to_tensor(X), P.to_tensor(Y)
        step(x, y)  # warmup (lr=0.5)
        w_before = model.weight.numpy().copy()
        step(x, y)  # compiled, lr=0.5
        d1 = np.abs(model.weight.numpy() - w_before).max()
        sched.step()
        sched.step()  # lr -> 0.005
        w_before = model.weight.numpy().copy()
        step(x, y)  # the same program, a much smaller lr
        d2 = np.abs(model.weight.numpy() - w_before).max()
        assert d2 < d1 * 0.2, (d1, d2)

    def test_lr_is_a_host_scalar_of_the_program(self):
        """The optimizer's lr reaches the captured step as a device scalar
        the program refills before every replay, not as a baked float."""
        model = T.nn.Linear(4, 1)
        sched = T.optimizer.lr.StepDecay(0.5, step_size=1, gamma=0.1)
        opt = T.optimizer.SGD(learning_rate=sched,
                              parameters=model.parameters())

        @T.jit.to_static
        def step(x):
            loss = model(x).sum()
            loss.backward()
            opt.step()
            opt.clear_grad()
            return loss

        x = T.to_tensor(np.ones((2, 4), np.float32))
        step(x)
        step(x)
        (prog,) = step._programs.values()
        assert [t for t in prog._hosts] and len(prog._hosts) == 1
        provider, buf = prog._hosts[0]
        sched.step()
        step(x)
        assert float(buf) == pytest.approx(0.05)

    @BOTH
    def test_rng_fresh_per_compiled_call(self, P):
        drop = P.nn.Dropout(0.5)
        drop.train()

        @P.jit.to_static
        def f(x):
            return drop(x)

        x = P.to_tensor(np.ones((4, 64), np.float32))
        f(x)  # warmup
        m1 = f(x).numpy()
        m2 = f(x).numpy()
        assert (m1 != m2).any(), "compiled dropout must draw fresh masks"

    @BOTH
    def test_grads_visible_after_compiled_backward(self, P):
        model = P.nn.Linear(4, 1)

        @P.jit.to_static
        def fwd_bwd(x, y):
            loss = P.nn.functional.mse_loss(model(x), y)
            loss.backward()
            return loss

        X, Y = make_data()
        x, y = P.to_tensor(X), P.to_tensor(Y)
        fwd_bwd(x, y)
        model.clear_gradients()
        fwd_bwd(x, y)  # compiled
        fwd_bwd(x, y)
        assert model.weight.grad is not None
        assert np.abs(model.weight.grad.numpy()).max() > 0

    def test_compiled_grads_equal_the_jax_package(self):
        X, Y = make_data()
        jm, tm = twin(lambda P: P.nn.Linear(4, 1))
        grads = []
        for P, m in ((J, jm), (T, tm)):
            @P.jit.to_static
            def fwd_bwd(x, y):
                loss = P.nn.functional.mse_loss(m(x), y)
                loss.backward()
                return loss

            x, y = P.to_tensor(X), P.to_tensor(Y)
            for _ in range(3):
                m.clear_gradients()
                fwd_bwd(x, y)
            grads.append(m.weight.grad.numpy())
        np.testing.assert_allclose(grads[1], grads[0], rtol=1e-5, atol=1e-6)

    def test_rebound_state_reaches_the_program(self):
        """set_value / set_state_dict between calls: the program copies the
        new value in instead of replaying on stale weights."""
        model = T.nn.Linear(4, 1)

        @T.jit.to_static
        def f(x):
            return model(x)

        x = T.to_tensor(np.ones((2, 4), np.float32))
        f(x)
        f(x)
        model.weight.set_value(np.full((4, 1), 2.0, np.float32))
        model.bias.set_value(np.zeros((1,), np.float32))
        np.testing.assert_allclose(f(x).numpy(), [[8.0], [8.0]])
        model.set_state_dict({"weight": np.full((4, 1), 0.5, np.float32),
                              "bias": np.ones((1,), np.float32)})
        np.testing.assert_allclose(f(x).numpy(), [[3.0], [3.0]])

    def test_moments_written_back_between_replays(self):
        """Adam's moments are rebound by each step: the program copies them
        into the buffers the next replay reads (else every replay would
        restart from the first step's moments)."""
        X, Y = make_data()
        losses = {}
        for compiled in (False, True):
            T.seed(1)
            m = _mlp(T)
            opt = T.optimizer.Adam(0.05, parameters=m.parameters())
            losses[compiled] = _train(T, m, opt, X, Y, 6, compiled)
            moments = [t.numpy() for t in opt._accumulators["moment1"]
                       .values()]
            losses[(compiled, "m")] = moments
        np.testing.assert_array_equal(losses[True], losses[False])
        for a, b in zip(losses[(True, "m")], losses[(False, "m")]):
            np.testing.assert_array_equal(a, b)


class TestTrainEvalModes:
    @BOTH
    def test_training_flag_in_cache_key(self, P):
        model = P.nn.Sequential(P.nn.Linear(8, 8), P.nn.Dropout(0.9))
        static_model = P.jit.to_static(model)
        x = P.to_tensor(np.ones((2, 8), np.float32))
        static_model(x)  # warmup
        static_model(x)
        model.eval()
        out_eval1 = static_model(x).numpy()
        out_eval2 = static_model(x).numpy()
        np.testing.assert_array_equal(out_eval1, out_eval2)
        model.train()
        outs = [static_model(x).numpy() for _ in range(3)]
        assert any((o != outs[0]).any() for o in outs[1:])


class TestControlFlow:
    @BOTH
    def test_cond(self, P):
        x = P.to_tensor(np.array([2.0], np.float32), stop_gradient=False)
        out = P.jit.cond(P.to_tensor(True), lambda a: a * 2, lambda a: a * 3,
                         x)
        assert out.numpy()[0] == 4.0
        out.sum().backward()
        assert x.grad.numpy()[0] == 2.0
        out2 = P.jit.cond(P.to_tensor(False), lambda a: a * 2,
                          lambda a: a * 3, x)
        assert out2.numpy()[0] == 6.0

    @BOTH
    def test_while_loop(self, P):
        i = P.to_tensor(np.array(0, np.int32))
        s = P.to_tensor(np.array(0.0, np.float32))
        i2, s2 = P.jit.while_loop(lambda i, s: i < 5,
                                  lambda i, s: (i + 1, s + 2.0), [i, s])
        assert int(i2.numpy()) == 5 and float(s2.numpy()) == 10.0

    @BOTH
    def test_scan_differentiable(self, P):
        xs = P.to_tensor(np.arange(4, dtype=np.float32), stop_gradient=False)
        c0 = P.to_tensor(np.array(1.0, np.float32), stop_gradient=False)

        def body(c, x):
            new = c * x
            return new, new

        carry, ys = P.jit.scan(body, c0, xs)
        assert float(carry.numpy()) == 0.0
        np.testing.assert_array_equal(ys.numpy(), [0.0, 0.0, 0.0, 0.0])
        x2 = P.to_tensor(np.array([2., 3.], np.float32), stop_gradient=False)
        c1 = P.to_tensor(np.array(1.0, np.float32), stop_gradient=False)
        carry2, _ = P.jit.scan(body, c1, x2)
        carry2.backward()
        np.testing.assert_allclose(x2.grad.numpy(), [3.0, 2.0])

    @BOTH
    def test_fori_loop(self, P):
        out = P.jit.fori_loop(0, 4, lambda i, v: v + i,
                              P.to_tensor(np.array(1.0, np.float32)))
        assert float(out.numpy()) == 7.0

    @BOTH
    def test_data_dependent_branch_raises_helpfully(self, P):
        @P.jit.to_static
        def f(x):
            if (x.sum() > 0).item():
                return x * 2
            return x * 3

        x = P.to_tensor(np.ones(3, np.float32))
        f(x)  # warmup, eager: fine
        with pytest.raises(Exception) as ei:
            f(x)
        assert "cond" in str(ei.value) or "Tracer" in str(ei.value)

    def test_control_flow_inside_a_program(self):
        """cond selects and while_loop loops on the predicate inside a
        captured program: the replay follows the data, not the capture."""
        @T.jit.to_static
        def f(x):
            y = T.jit.cond(x.sum() > 0, lambda a: a * 2.0,
                           lambda a: a - 1.0, x)
            n, z = T.jit.while_loop(lambda n, z: z.sum() < 50.0,
                                    lambda n, z: (n + 1, z * 2.0),
                                    [T.to_tensor(np.array(0, np.int64)),
                                     y.abs() + 1.0])
            return y, n, z

        def eager(a):
            y = a * 2.0 if a.sum() > 0 else a - 1.0
            z, n = np.abs(y) + 1.0, 0
            while z.sum() < 50.0:
                z, n = z * 2.0, n + 1
            return y, n, z

        for v in ([1.0, 2.0], [1.0, 2.0], [-3.0, 0.5], [4.0, 9.0],
                  [-0.5, 0.1]):
            a = np.asarray(v, np.float32)
            y, n, z = f(T.to_tensor(a))
            wy, wn, wz = eager(a)
            np.testing.assert_allclose(y.numpy(), wy, rtol=1e-6)
            assert int(n) == wn
            np.testing.assert_allclose(z.numpy(), wz, rtol=1e-6)


class TestSaveLoad:
    def test_save_load_roundtrip(self, tmp_path):
        """Two batch sizes through the loaded program within 1e-5; the
        ``.pdiparams`` holds the JAX package's names and shapes."""
        jm, tm = twin(lambda P: P.nn.Sequential(
            P.nn.Linear(4, 8), P.nn.ReLU(), P.nn.Linear(8, 2)))
        for m in (jm, tm):
            m.eval()
        paths = {}
        for P, m in ((J, jm), (T, tm)):
            paths[P] = str(tmp_path / P.__name__ / "infer/model")
            P.jit.save(m, paths[P],
                       input_spec=[P.jit.InputSpec([None, 4], "float32")])
        loaded = T.jit.load(paths[T])
        jloaded = J.jit.load(paths[J])
        rng = np.random.default_rng(0)
        for n in (5, 3):
            x = rng.random((n, 4)).astype(np.float32)
            want = tm(T.to_tensor(x)).numpy()
            got = loaded(T.to_tensor(x)).numpy()
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(got, jloaded(J.to_tensor(x)).numpy(),
                                       rtol=1e-5, atol=1e-6)
        files = []
        for P in (J, T):
            with open(paths[P] + ".pdiparams", "rb") as f:
                files.append({k: np.asarray(v).shape
                              for k, v in pickle.load(f).items()})
        assert files[0] == files[1]

    def test_export_holds_the_flash_op(self, tmp_path):
        """A function calling the flash kernel's wrapper exports the
        ``paddle_tpu_torch::flash_attention_fwd`` op; loaded on the CPU the
        op runs the plain version (1e-5 of the wrapper's output)."""
        from paddle_tpu_torch.kernels import flash_attention

        def attend(q, k, v):
            return T.Tensor(flash_attention(q._value, k._value, v._value,
                                            causal=True))

        path = str(tmp_path / "attend")
        spec = T.jit.InputSpec([None, 16, 2, 8], "float32")
        T.jit.save(attend, path, input_spec=[spec] * 3)
        with open(path + ".pdmodel", "rb") as f:
            ep = torch.export.load(io.BytesIO(pickle.load(f)["program"]))
        targets = [str(n.target) for n in ep.graph.nodes
                   if n.op == "call_function"]
        assert any("flash_attention_fwd" in t for t in targets), targets
        loaded = T.jit.load(path)
        rng = np.random.default_rng(1)
        for b in (3, 1):
            q, k, v = (rng.standard_normal((b, 16, 2, 8)).astype(np.float32)
                       for _ in range(3))
            want = flash_attention(torch.tensor(q), torch.tensor(k),
                                   torch.tensor(v), causal=True)
            np.testing.assert_allclose(loaded(q, k, v).numpy(),
                                       want.numpy(), rtol=1e-5, atol=1e-6)

    def test_save_from_to_static_layer_spec(self, tmp_path):
        """``jit.save`` takes the input spec a to_static Layer was given."""
        J.seed(0)
        tm = T.nn.Linear(3, 2)
        st = T.jit.to_static(tm, input_spec=[T.jit.InputSpec([None, 3])])
        path = str(tmp_path / "lin")
        T.jit.save(st, path)
        x = np.ones((4, 3), np.float32)
        np.testing.assert_allclose(T.jit.load(path)(x).numpy(),
                                   tm(T.to_tensor(x)).numpy(), rtol=1e-6)
        assert os.path.exists(path + ".pdiparams")

"""The port's ``nn`` and ``optimizer`` against the JAX package's, mirroring
``tests/test_nn.py``'s ``TestActivations``, ``TestLinearEmbedding``,
``TestNorms``, ``TestLayerMechanics``, ``TestOptimizers`` and
``TestMLPTraining`` for the classes this slice ports.

Every twin starts from the same weights: the JAX layer's ``state_dict()``
loads into the port's layer by name (``Layer.set_state_dict`` through
``models/convert.py:state_dict_from_jax``). Inputs come from numpy with a
seed. Tolerances: single forwards and gradients within ``rtol=1e-5,
atol=1e-6``; training trajectories step by step within ``1e-4 * |loss|``
at fp32 (the frameworks sum in different orders; each case states the
largest gap it saw when written). State dicts cross between the packages
through ``framework.io`` files in both directions.
"""

import numpy as np
import pytest

import paddle_tpu as J
import paddle_tpu_torch as T

TOL = dict(rtol=1e-5, atol=1e-6)
TRAJ_RTOL = 1e-4


@pytest.fixture(autouse=True)
def _port_on_cpu():
    prev = T.get_device()
    T.set_device("cpu")
    yield
    T.set_device(prev)


def twin(build):
    """``build(paddle)`` on both packages; the port's weights set from the
    JAX layer's state dict."""
    J.seed(0)
    jl = build(J)
    tl = build(T)
    tl.set_state_dict(jl.state_dict())
    return jl, tl


def np_(x):
    return np.asarray(x.numpy())


class TestActivations:
    NAMES = ("relu", "gelu", "silu", "softplus", "leaky_relu", "elu",
             "hardswish", "log_softmax", "softmax", "mish", "relu6",
             "hardshrink", "softshrink", "tanhshrink", "selu", "celu",
             "softsign", "sigmoid", "tanh", "hardsigmoid", "hardtanh",
             "log_sigmoid", "thresholded_relu")

    @pytest.mark.parametrize("name", NAMES)
    def test_functional_matches(self, name):
        a = np.random.default_rng(0).standard_normal((4, 7)).astype(np.float32)
        outs = []
        for p in (J, T):
            x = p.to_tensor(a, stop_gradient=False)
            y = getattr(p.nn.functional, name)(x)
            (y * y).sum().backward()
            outs.append((np_(y), np_(x.grad)))
        np.testing.assert_allclose(outs[1][0], outs[0][0], **TOL)
        np.testing.assert_allclose(outs[1][1], outs[0][1], rtol=1e-5, atol=1e-5)

    def test_gelu_approximate(self):
        a = np.random.default_rng(1).standard_normal(10).astype(np.float32)
        got = T.nn.functional.gelu(T.to_tensor(a), approximate=True)
        want = J.nn.functional.gelu(J.to_tensor(a), approximate=True)
        np.testing.assert_allclose(np_(got), np_(want), **TOL)

    @pytest.mark.parametrize("cls,args", [
        ("ReLU", ()), ("LeakyReLU", (0.2,)), ("Softmax", ()), ("GELU", ()),
        ("PReLU", ()), ("Maxout", (2,)), ("GLU", ())])
    def test_layers_match(self, cls, args):
        a = np.random.default_rng(2).standard_normal((2, 4, 6)).astype(
            np.float32)
        jl, tl = twin(lambda p: getattr(p.nn, cls)(*args))
        np.testing.assert_allclose(np_(tl(T.to_tensor(a))),
                                   np_(jl(J.to_tensor(a))), **TOL)


class TestLinearEmbedding:
    def test_linear_layout(self):
        jl, tl = twin(lambda p: p.nn.Linear(4, 3))
        assert tl.weight.shape == [4, 3]
        x = np.random.default_rng(3).random((2, 4)).astype(np.float32)
        np.testing.assert_allclose(np_(tl(T.to_tensor(x))),
                                   np_(jl(J.to_tensor(x))), **TOL)

    def test_embedding_padding_idx(self):
        jl, tl = twin(lambda p: p.nn.Embedding(10, 4, padding_idx=0))
        assert np.all(np_(tl.weight)[0] == 0)
        idx = np.array([[0, 3], [5, 0]])
        out = tl(T.to_tensor(idx))
        assert out.shape == [2, 2, 4]
        np.testing.assert_allclose(np_(out), np_(jl(J.to_tensor(idx))), **TOL)

    def test_embedding_grad(self):
        grads = []
        jl, tl = twin(lambda p: p.nn.Embedding(5, 3))
        for p, layer in ((J, jl), (T, tl)):
            layer(p.to_tensor(np.array([1, 1, 2]))).sum().backward()
            grads.append(np_(layer.weight.grad))
        np.testing.assert_allclose(grads[1], grads[0], **TOL)
        assert grads[1][1].sum() == pytest.approx(6.0)
        assert grads[1][3].sum() == 0

    def test_dropout_pad_flatten(self):
        x = np.random.default_rng(4).random((2, 3, 4, 4)).astype(np.float32)
        for mode in ("constant", "reflect", "replicate", "circular"):
            got = T.nn.functional.pad(T.to_tensor(x), [1, 2, 2, 1], mode=mode)
            want = J.nn.functional.pad(J.to_tensor(x), [1, 2, 2, 1], mode=mode)
            np.testing.assert_allclose(np_(got), np_(want), **TOL,
                                       err_msg=mode)
        jf, tf = twin(lambda p: p.nn.Flatten())
        np.testing.assert_allclose(np_(tf(T.to_tensor(x))),
                                   np_(jf(J.to_tensor(x))))
        d = T.nn.Dropout(0.5)
        T.seed(3)
        y = np_(d(T.to_tensor(np.ones((200, 50), np.float32))))
        assert set(np.unique(y)) <= {0.0, 2.0}
        assert abs((y == 0).mean() - 0.5) < 0.02
        d.eval()
        assert np.all(np_(d(T.to_tensor(x))) == x)


class TestNorms:
    def _check(self, build, x):
        """Forward, and the gradients of ``sum(y * c)`` for a fixed random
        ``c`` (``sum(y * y)`` of a normalized y is constant: its gradient
        is zero and would compare rounding noise)."""
        jl, tl = twin(build)
        c = np.random.default_rng(99).standard_normal(x.shape).astype(
            np.float32)
        outs = []
        for p, layer in ((J, jl), (T, tl)):
            xt = p.to_tensor(x, stop_gradient=False)
            y = layer(xt)
            (y * p.to_tensor(c)).sum().backward()
            outs.append([np_(y), np_(xt.grad)] +
                        [np_(q.grad) for q in layer.parameters()])
        for a, b in zip(*outs):
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5)
        return jl, tl

    def test_layer_norm(self):
        x = np.random.default_rng(5).random((4, 6, 8)).astype(np.float32)
        self._check(lambda p: p.nn.LayerNorm(8), x)

    def test_batch_norm_train_and_eval(self):
        x = np.random.default_rng(6).random((8, 3, 4, 4)).astype(np.float32)
        jl, tl = twin(lambda p: p.nn.BatchNorm2D(3, momentum=0.9))
        jl.train()
        tl.train()
        np.testing.assert_allclose(np_(tl(T.to_tensor(x))),
                                   np_(jl(J.to_tensor(x))), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(np_(tl._mean), np_(jl._mean), **TOL)
        np.testing.assert_allclose(np_(tl._variance), np_(jl._variance), **TOL)
        jl.eval()
        tl.eval()
        np.testing.assert_allclose(np_(tl(T.to_tensor(x))),
                                   np_(jl(J.to_tensor(x))), rtol=1e-5, atol=1e-5)

    def test_group_instance_norm(self):
        x = np.random.default_rng(7).random((2, 6, 5, 5)).astype(np.float32)
        self._check(lambda p: p.nn.GroupNorm(3, 6), x)
        self._check(lambda p: p.nn.InstanceNorm2D(6), x)

    def test_rms_norm(self):
        x = np.random.default_rng(8).random((3, 7)).astype(np.float32)
        self._check(lambda p: p.nn.RMSNorm(7), x)
        w = np.random.default_rng(9).random(7).astype(np.float32)
        got = T.nn.functional.rms_norm(T.to_tensor(x), T.to_tensor(w))
        want = J.nn.functional.rms_norm(J.to_tensor(x), J.to_tensor(w))
        np.testing.assert_allclose(np_(got), np_(want), **TOL)


class TestLosses:
    def test_cross_entropy_variants(self):
        r = np.random.default_rng(10)
        logits = r.standard_normal((6, 5)).astype(np.float32)
        lab = np.array([0, 4, 2, -100, 1, 3])
        w = r.random(5).astype(np.float32)
        soft = r.random((6, 5)).astype(np.float32)
        soft /= soft.sum(-1, keepdims=True)
        for kw in ({}, {"label_smoothing": 0.1}, {"reduction": "sum"},
                   {"reduction": "none"}, {"weight": w}):
            res = []
            for p in (J, T):
                x = p.to_tensor(logits, stop_gradient=False)
                kws = dict(kw)
                if "weight" in kws:
                    kws["weight"] = p.to_tensor(kws["weight"])
                loss = p.nn.functional.cross_entropy(x, p.to_tensor(lab), **kws)
                loss.sum().backward()
                res.append((np_(loss), np_(x.grad)))
            for a, b in zip(*res):
                np.testing.assert_allclose(b, a, **TOL, err_msg=str(kw))
        got = T.nn.CrossEntropyLoss(soft_label=True)(T.to_tensor(logits),
                                                     T.to_tensor(soft))
        want = J.nn.CrossEntropyLoss(soft_label=True)(J.to_tensor(logits),
                                                      J.to_tensor(soft))
        np.testing.assert_allclose(np_(got), np_(want), **TOL)

    def test_mse(self):
        r = np.random.default_rng(11)
        a, b = (r.random((4, 3)).astype(np.float32) for _ in range(2))
        for red in ("mean", "sum", "none"):
            got = T.nn.MSELoss(red)(T.to_tensor(a), T.to_tensor(b))
            want = J.nn.MSELoss(red)(J.to_tensor(a), J.to_tensor(b))
            np.testing.assert_allclose(np_(got), np_(want), **TOL)


def _mlp(p):
    return p.nn.Sequential(p.nn.Linear(4, 8), p.nn.ReLU(), p.nn.Linear(8, 2))


class TestLayerMechanics:
    def test_state_dict_roundtrip_across_packages(self, tmp_path):
        jm, tm = twin(_mlp)
        assert list(tm.state_dict()) == list(jm.state_dict())
        x = np.random.default_rng(12).random((3, 4)).astype(np.float32)
        np.testing.assert_allclose(np_(tm(T.to_tensor(x))),
                                   np_(jm(J.to_tensor(x))), **TOL)
        # the port saves, JAX loads
        T.save(tm.state_dict(), str(tmp_path / "t.pdparams"))
        J.seed(5)
        jm2 = _mlp(J)
        jm2.set_state_dict(J.load(str(tmp_path / "t.pdparams")))
        np.testing.assert_array_equal(np_(jm2(J.to_tensor(x))),
                                      np_(jm(J.to_tensor(x))))
        # JAX saves, the port loads
        J.save(jm.state_dict(), str(tmp_path / "j.pdparams"))
        tm2 = _mlp(T)
        tm2.set_state_dict(T.load(str(tmp_path / "j.pdparams"), device="cpu"))
        for k, v in tm2.state_dict().items():
            np.testing.assert_array_equal(np_(v), np_(jm.state_dict()[k]))

    def test_named_parameters_and_buffers(self):
        m = T.nn.Sequential(T.nn.Linear(2, 2),
                            T.nn.BatchNorm1D(2, data_format="NCL"))
        assert {"0.weight", "1.weight"} <= {n for n, _ in m.named_parameters()}
        assert "1._mean" in [n for n, _ in m.named_buffers()]
        assert "1._variance" in m.state_dict()

    def test_train_eval_propagates(self):
        m = T.nn.Sequential(T.nn.Linear(2, 2), T.nn.Dropout(0.5))
        m.eval()
        assert not m[1].training
        x = T.to_tensor(np.ones((4, 2), np.float32))
        np.testing.assert_allclose(np_(m[1](x)), np.ones((4, 2)))
        m.train()
        assert m[1].training

    def test_forward_hooks(self):
        lin = T.nn.Linear(2, 2)
        calls = []
        h1 = lin.register_forward_pre_hook(lambda l, inp: calls.append("pre"))
        h2 = lin.register_forward_post_hook(lambda l, inp, out: calls.append("post"))
        lin(T.to_tensor(np.zeros((1, 2), np.float32)))
        assert calls == ["pre", "post"]
        h1.remove()
        h2.remove()
        lin(T.to_tensor(np.zeros((1, 2), np.float32)))
        assert calls == ["pre", "post"]

    def test_apply_and_sublayers(self):
        m = T.nn.Sequential(T.nn.Linear(2, 2), T.nn.Sequential(T.nn.Linear(2, 2)))
        count = []
        m.apply(lambda l: count.append(type(l).__name__))
        assert count.count("Linear") == 2
        assert len(m.sublayers()) == 3

    def test_parameters_dedup(self):
        shared = T.nn.Linear(3, 3)
        assert len(T.nn.LayerList([shared, shared]).parameters()) == 2

    def test_to_and_bfloat16_keep_leaves(self):
        m = _mlp(T)
        opt = T.optimizer.SGD(0.1, parameters=m.parameters())
        m.bfloat16()
        assert all(p.dtype == T.bfloat16 and p.is_leaf and not p.stop_gradient
                   for p in m.parameters())
        m.to(dtype="float32")
        m(T.randn([2, 4])).sum().backward()
        opt.step()          # the optimizer still holds the same Parameters
        assert all(p.grad is not None for p in m.parameters())


def _train(p, model, opt_fn, X, Y, steps, loss="mse"):
    opt = opt_fn(p, model.parameters())
    x, y = p.to_tensor(X), p.to_tensor(Y)
    lf = p.nn.functional.mse_loss if loss == "mse" else p.nn.CrossEntropyLoss()
    losses = []
    for _ in range(steps):
        out = lf(model(x), y)
        out.backward()
        opt.step()
        opt.clear_grad()
        if isinstance(opt._lr, p.optimizer.lr.LRScheduler):
            opt._lr.step()
        losses.append(float(out))
    return np.asarray(losses), opt


OPTIMIZERS = {
    "sgd": lambda p, ps: p.optimizer.SGD(0.1, parameters=ps),
    "momentum": lambda p, ps: p.optimizer.Momentum(0.05, parameters=ps),
    "momentum_nesterov": lambda p, ps: p.optimizer.Momentum(
        0.05, parameters=ps, use_nesterov=True),
    "adam": lambda p, ps: p.optimizer.Adam(0.01, parameters=ps),
    "adamw": lambda p, ps: p.optimizer.AdamW(0.01, parameters=ps),
    "adamw_clip": lambda p, ps: p.optimizer.AdamW(
        0.01, parameters=ps, grad_clip=p.nn.ClipGradByGlobalNorm(0.5)),
    "sgd_l2": lambda p, ps: p.optimizer.SGD(
        0.1, parameters=ps, weight_decay=p.regularizer.L2Decay(0.01)),
    "rmsprop": lambda p, ps: p.optimizer.RMSProp(0.005, parameters=ps),
    "lamb": lambda p, ps: p.optimizer.Lamb(0.01, parameters=ps),
    "adamax": lambda p, ps: p.optimizer.Adamax(0.01, parameters=ps),
    "adagrad": lambda p, ps: p.optimizer.Adagrad(0.05, parameters=ps),
    "adadelta": lambda p, ps: p.optimizer.Adadelta(1.0, parameters=ps),
    "nadam": lambda p, ps: p.optimizer.NAdam(0.01, parameters=ps),
    "radam": lambda p, ps: p.optimizer.RAdam(0.01, parameters=ps),
    "asgd": lambda p, ps: p.optimizer.ASGD(0.05, batch_num=4, parameters=ps),
    "adam_sched": lambda p, ps: p.optimizer.Adam(
        p.optimizer.lr.StepDecay(0.02, step_size=10, gamma=0.5),
        parameters=ps),
}


class TestOptimizers:
    @pytest.mark.parametrize("name", sorted(OPTIMIZERS))
    def test_trajectory_matches(self, name):
        """60 steps of the same MLP (weights carried), loss by loss within
        1e-4 * |loss| (largest gap seen when written: 1.1e-5 relative,
        Momentum; the others below 2e-6)."""
        r = np.random.default_rng(13)
        X = r.random((64, 4)).astype(np.float32)
        Y = (X.sum(1, keepdims=True) * 0.7).astype(np.float32)
        build = lambda p: p.nn.Sequential(p.nn.Linear(4, 16), p.nn.Tanh(),
                                          p.nn.Linear(16, 1))
        jm, tm = twin(build)
        fn = OPTIMIZERS[name]
        jl, _ = _train(J, jm, fn, X, Y, 60)
        tl, _ = _train(T, tm, fn, X, Y, 60)
        np.testing.assert_allclose(tl, jl, rtol=TRAJ_RTOL)
        assert tl[-1] < tl[0]

    def test_adamw_step_is_the_reference_formula(self):
        """One AdamW step against optimizer.py:255-318 written out: the
        decoupled decay value * (1 - lr * wd), then the Adam step."""
        r = np.random.default_rng(14)
        w0 = r.random((3, 2)).astype(np.float32)
        g = r.random((3, 2)).astype(np.float32)
        p = T.Parameter(w0.copy())
        opt = T.optimizer.AdamW(0.1, parameters=[p], weight_decay=0.05)
        p.grad = T.to_tensor(g)
        opt.step()
        f = np.float32
        lr, wd, b1, b2, eps = f(0.1), f(0.05), f(0.9), f(0.999), f(1e-8)
        v = w0 * (f(1) - lr * wd)
        m1 = (f(1) - b1) * g
        m2 = (f(1) - b2) * g * g
        want = v - lr * (m1 / (f(1) - b1)) / (np.sqrt(m2 / (f(1) - b2)) + eps)
        np.testing.assert_allclose(np_(p), want, rtol=0,
                                   atol=1e-6 * np.abs(want).max())

    def test_grad_clip_global_norm(self):
        p = T.Parameter(np.zeros((4,), np.float32))
        opt = T.optimizer.SGD(1.0, parameters=[p],
                              grad_clip=T.nn.ClipGradByGlobalNorm(1.0))
        p.grad = T.to_tensor(np.full(4, 10.0, np.float32))
        opt.step()
        assert np.linalg.norm(np_(p)) == pytest.approx(1.0, rel=1e-4)

    def test_lr_scheduler_integration(self):
        p = T.Parameter(np.zeros((1,), np.float32))
        sched = T.optimizer.lr.StepDecay(0.1, step_size=2, gamma=0.5)
        opt = T.optimizer.SGD(sched, parameters=[p])
        lrs = []
        for _ in range(5):
            lrs.append(opt.get_lr())
            sched.step()
        np.testing.assert_allclose(lrs, [0.1, 0.1, 0.05, 0.05, 0.025], rtol=1e-6)

    def test_multi_precision_master_weights(self):
        res = []
        for p in (J, T):
            wb = p.Parameter(p.to_tensor(np.ones(4, np.float32),
                                         dtype="bfloat16"), name="mp_b")
            opt = p.optimizer.Adam(1e-3, parameters=[wb], multi_precision=True)
            for _ in range(3):
                wb.grad = p.to_tensor(np.full((4,), 0.5, np.float32),
                                      dtype="bfloat16")
                opt.step()
            sd = opt.state_dict()
            res.append((np_(wb.astype("float32")),
                        np_(sd["master_weights"]["mp_b"])))
        np.testing.assert_allclose(res[1][1], res[0][1], rtol=1e-6)
        np.testing.assert_array_equal(res[1][0], res[0][0])

    def test_optimizer_state_roundtrip_across_packages(self, tmp_path):
        """Adam's state_dict, saved by JAX, restores into the port's (and
        the port's into JAX's): the next step is the same."""
        g = np.ones(2, np.float32)
        for src, dst in ((J, T), (T, J)):
            p = src.Parameter(np.ones((2,), np.float32), name="p0")
            opt = src.optimizer.Adam(0.01, parameters=[p])
            p.grad = src.to_tensor(g)
            opt.step()
            path = str(tmp_path / f"{src.__name__}.pdopt")
            src.save(opt.state_dict(), path)
            loaded = dst.load(path, device="cpu") if dst is T else dst.load(path)
            p2 = dst.Parameter(np_(p).copy(), name="p0")
            opt2 = dst.optimizer.Adam(0.01, parameters=[p2])
            opt2.set_state_dict(loaded)
            p.grad = src.to_tensor(g)
            p2.grad = dst.to_tensor(g)
            opt.step()
            opt2.step()
            np.testing.assert_allclose(np_(p2), np_(p), rtol=1e-6)

    def test_lbfgs_matches(self):
        """LBFGS's closure API on a least-squares problem: the same
        iterates as the reference's within 1e-4 (the line search branches
        on float comparisons of the two frameworks' losses)."""
        r = np.random.default_rng(15)
        A = r.standard_normal((8, 3)).astype(np.float32)
        b = r.standard_normal(8).astype(np.float32)
        res = []
        for p in (J, T):
            w = p.Parameter(np.zeros(3, np.float32))
            opt = p.optimizer.LBFGS(1.0, max_iter=5, parameters=[w])
            a_t, b_t = p.to_tensor(A), p.to_tensor(b)

            def closure():
                opt.clear_grad()
                loss = ((p.matmul(a_t, w) - b_t) ** 2).sum()
                loss.backward()
                return loss

            for _ in range(3):
                opt.step(closure)
            res.append(np_(w))
        np.testing.assert_allclose(res[1], res[0], rtol=1e-4, atol=1e-5)
        want = np.linalg.lstsq(A, b, rcond=None)[0]
        np.testing.assert_allclose(res[1], want, rtol=1e-3, atol=1e-3)

    def test_minimize_and_fuse(self):
        p = T.Parameter(np.ones((2,), np.float32))
        opt = T.optimizer.SGD(0.5, parameters=[p])
        opt.minimize((p * p).sum())
        np.testing.assert_allclose(np_(p), [0.0, 0.0])
        # fuse is the fused train step (it raised before jit/ was ported)
        net = T.nn.Linear(2, 1)
        opt = T.optimizer.SGD(0.5, parameters=net.parameters())
        step = opt.fuse(net, T.nn.MSELoss())
        assert isinstance(step, T.jit.TrainStep) and step.optimizer is opt


class TestMLPTraining:
    def test_mlp_classifier_trajectory(self):
        """tests/test_nn.py's classifier: 100 Adam steps from the JAX
        twin's weights, loss by loss within 1e-4 * |loss| (largest gap
        seen when written: 5.3e-7 relative); it converges as the
        reference's does."""
        r = np.random.default_rng(42)
        X = r.standard_normal((128, 10)).astype(np.float32)
        y = (X[:, 0] + X[:, 1] > 0).astype(np.int64)
        build = lambda p: p.nn.Sequential(p.nn.Linear(10, 32), p.nn.ReLU(),
                                          p.nn.Linear(32, 2))
        jm, tm = twin(build)
        fn = lambda p, ps: p.optimizer.Adam(0.01, parameters=ps)
        jl, _ = _train(J, jm, fn, X, y, 100, loss="ce")
        tl, _ = _train(T, tm, fn, X, y, 100, loss="ce")
        np.testing.assert_allclose(tl, jl, rtol=TRAJ_RTOL)
        assert tl[-1] < tl[0] * 0.1
        acc = (np.argmax(np_(tm(T.to_tensor(X))), 1) == y).mean()
        assert acc > 0.95

"""The port's fused train step (``jit.TrainStep``), hapi's jit path and the
imperative ``Sentinel`` against the JAX package's: ``tests/test_train_step
.py``'s ``TestDonationParity``, ``TestPrefetch``'s profile-annotations
case and ``TestHapiJit``, and ``tests/test_health.py``'s
``TestSentinelFused``, each run through both packages from the same
weights (the port's net loaded from the JAX net's ``state_dict()``).

``TestDonationParity`` and ``TestNHWCLayout`` run the reference's
``ConvNet`` (conv + BatchNorm2D + pool + fc: parameters, optimizer
accumulators and buffers the forward mutates); the other classes a
``BNNet`` (Linear + BatchNorm1D + ReLU + Linear). ``TestNHWCLayout``'s
eight cases compare the port's ChannelsLast net with its NCHW twin, as
the reference's compare its own. Tolerances are the reference's: fused against eager
``rtol=1e-4, atol=1e-6`` at fp32 (``1e-3`` / ``5e-3`` under bf16 AMP),
donated against undonated bitwise. On the CPU the program is a
recording of the step's ATen operations replayed per call
(``jit/trace.py``); donation there is the write-back of each rebound
state value at the moment it is written (the card's path), against the
end-of-step copy without it.

The captured step replayed on the card against the eager one is in
``tests/test_torch_cuda_kernels.py`` (``-k captured``; that file imports
no jax, so it runs on the card).
"""

import contextlib

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


def _bnnet(P):
    nn = P.nn

    class BNNet(nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc1 = nn.Linear(12, 8)
            self.bn = nn.BatchNorm1D(8)
            self.relu = nn.ReLU()
            self.fc2 = nn.Linear(8, 4)

        def forward(self, x):
            return self.fc2(self.relu(self.bn(self.fc1(x))))

    return BNNet()


def _twins(seed=0, n=2):
    """``n`` port nets and one JAX net, all from the JAX net's weights."""
    J.seed(seed)
    jn = _bnnet(J)
    sd = {k: v.numpy() for k, v in jn.state_dict().items()}
    tns = []
    for _ in range(n):
        t = _bnnet(T)
        t.set_state_dict(sd)
        tns.append(t)
    return jn, tns


def _batches(k=4, batch=4, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((batch, 12)).astype("float32"),
             rng.integers(0, 4, (batch,)).astype("int64")) for _ in range(k)]


def _convnet(P):
    """``tests/test_train_step.py``'s ``ConvNet``: conv + BatchNorm (its
    running statistics rebound by the forward) + pool + fc, so a step
    carries parameters, optimizer accumulators and mutated buffers."""
    nn = P.nn

    class ConvNet(nn.Layer):
        def __init__(self):
            super().__init__()
            self.conv = nn.Conv2D(3, 8, 3, padding=1)
            self.bn = nn.BatchNorm2D(8)
            self.relu = nn.ReLU()
            self.pool = nn.AdaptiveAvgPool2D((1, 1))
            self.fc = nn.Linear(8, 4)

        def forward(self, x):
            x = self.pool(self.relu(self.bn(self.conv(x))))
            return self.fc(P.flatten(x, 1))

    return ConvNet()


def _conv_twins(seed=0, n=2):
    """``n`` port ConvNets and one JAX ConvNet, all from the JAX net's
    weights."""
    J.seed(seed)
    jn = _convnet(J)
    sd = {k: v.numpy() for k, v in jn.state_dict().items()}
    tns = []
    for _ in range(n):
        t = _convnet(T)
        t.set_state_dict(sd)
        tns.append(t)
    return jn, tns


def _conv_batches(k=4, batch=4, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((batch, 3, 8, 8)).astype("float32"),
             rng.integers(0, 4, (batch,)).astype("int64")) for _ in range(k)]


def _acc_arrays(opt):
    order = {p.name: i for i, p in enumerate(opt._params())}
    return {(a, order[p]): t.numpy() for a, store in
            opt._accumulators.items() for p, t in store.items()}


def _state(net):
    return {k: v.numpy() for k, v in net.state_dict().items()}


class TestDonationParity:
    def test_fp32_fused_matches_eager(self):
        """K fused steps vs K eager steps (the port's), and vs the JAX
        package's fused steps: params, accumulators, BN running stats."""
        jn, (t1, t2) = _conv_twins()
        loss_fn = T.nn.CrossEntropyLoss()
        o1 = T.optimizer.Momentum(0.1, momentum=0.9,
                                  parameters=t1.parameters())
        o2 = T.optimizer.Momentum(0.1, momentum=0.9,
                                  parameters=t2.parameters())
        oj = J.optimizer.Momentum(0.1, momentum=0.9,
                                  parameters=jn.parameters())
        step = T.jit.make_train_step(t2, o2, loss_fn)
        jstep = J.jit.make_train_step(jn, oj, J.nn.CrossEntropyLoss())
        for x, y in _conv_batches():
            t1.train()
            loss = loss_fn(t1(T.to_tensor(x)), T.to_tensor(y))
            loss.backward()
            o1.step()
            o1.clear_grad()
            fused = step(T.to_tensor(x), T.to_tensor(y))
            jfused = jstep(J.to_tensor(x), J.to_tensor(y))
            np.testing.assert_allclose(float(fused), float(loss),
                                       rtol=1e-4, atol=1e-6)
            np.testing.assert_allclose(float(fused), float(jfused),
                                       rtol=1e-4, atol=1e-6)
        s1, s2, sj = _state(t1), _state(t2), _state(jn)
        for k in s1:
            np.testing.assert_allclose(s2[k], s1[k], rtol=1e-4, atol=1e-6,
                                       err_msg=k)
            np.testing.assert_allclose(s2[k], sj[k], rtol=1e-4, atol=1e-6,
                                       err_msg=k)
        a1, a2, aj = _acc_arrays(o1), _acc_arrays(o2), _acc_arrays(oj)
        assert len(a1) == len(a2) == len(aj) > 0
        for k in a1:
            np.testing.assert_allclose(a2[k], a1[k], rtol=1e-4, atol=1e-6)
            np.testing.assert_allclose(a2[k], aj[k], rtol=1e-4, atol=1e-6)

    def test_donated_bitwise_equals_undonated(self):
        jn, (t1, t2) = _conv_twins(seed=1)
        loss_fn = T.nn.CrossEntropyLoss()
        o1 = T.optimizer.Adam(0.01, parameters=t1.parameters())
        o2 = T.optimizer.Adam(0.01, parameters=t2.parameters())
        s_undonated = T.jit.make_train_step(t1, o1, loss_fn, donate=False)
        s_donated = T.jit.make_train_step(t2, o2, loss_fn, donate=True)
        for x, y in _conv_batches(seed=1):
            l1 = s_undonated(T.to_tensor(x), T.to_tensor(y))
            l2 = s_donated(T.to_tensor(x), T.to_tensor(y))
            assert float(l1) == float(l2)
        s1, s2 = _state(t1), _state(t2)
        for k in s1:
            assert np.array_equal(s1[k], s2[k]), k
        for (k1, v1), (k2, v2) in zip(sorted(_acc_arrays(o1).items()),
                                      sorted(_acc_arrays(o2).items())):
            assert np.array_equal(v1, v2), (k1, k2)

    def test_amp_bf16_fused_matches_eager(self):
        jn, (t1, t2) = _conv_twins(seed=2)
        loss_fn = T.nn.CrossEntropyLoss()
        o1 = T.optimizer.Momentum(0.05, momentum=0.9,
                                  parameters=t1.parameters())
        o2 = T.optimizer.Momentum(0.05, momentum=0.9,
                                  parameters=t2.parameters())
        step = T.jit.make_train_step(t2, o2, loss_fn, amp=True)
        for x, y in _conv_batches(k=3, seed=2):
            t1.train()
            with T.amp.auto_cast():
                loss = loss_fn(t1(T.to_tensor(x)), T.to_tensor(y))
            loss.backward()
            o1.step()
            o1.clear_grad()
            fused = step(T.to_tensor(x), T.to_tensor(y))
        np.testing.assert_allclose(float(loss), float(fused),
                                   rtol=1e-3, atol=1e-4)
        s1, s2 = _state(t1), _state(t2)
        for k in s1:
            np.testing.assert_allclose(s1[k], s2[k], rtol=5e-3, atol=5e-4,
                                       err_msg=k)

    def test_amp_donated_bitwise_equals_undonated(self):
        jn, (t1, t2) = _conv_twins(seed=3)
        loss_fn = T.nn.CrossEntropyLoss()
        o1 = T.optimizer.Momentum(0.05, parameters=t1.parameters())
        o2 = T.optimizer.Momentum(0.05, parameters=t2.parameters())
        s1 = T.jit.make_train_step(t1, o1, loss_fn, amp=True, donate=False)
        s2 = T.jit.make_train_step(t2, o2, loss_fn, amp=True, donate=True)
        for x, y in _conv_batches(k=3, seed=3):
            s1(T.to_tensor(x), T.to_tensor(y))
            s2(T.to_tensor(x), T.to_tensor(y))
        d1, d2 = _state(t1), _state(t2)
        for k in d1:
            assert np.array_equal(d1[k], d2[k]), k

    def test_state_stays_in_its_buffers_after_donated_step(self):
        """The reference rebinds every state Tensor to the program's
        outputs (the donated inputs are consumed); the port's graph writes
        the new state into the buffers the next replay reads, so every
        state Tensor keeps its value's storage and sees the update."""
        T.seed(4)
        net = _convnet(T)
        opt = T.optimizer.Momentum(0.1, parameters=net.parameters())
        step = T.jit.make_train_step(net, opt, T.nn.CrossEntropyLoss(),
                                     donate=True)
        batches = _conv_batches(k=3, seed=4)
        for x, y in batches[:2]:   # warm-up eager + capture
            step(T.to_tensor(x), T.to_tensor(y))
        before = {k: (t._value.data_ptr(), t.numpy().copy())
                  for k, t in net.state_dict().items()}
        accs = [(t, t._value.data_ptr()) for s in opt._accumulators.values()
                for t in s.values()]
        x, y = batches[2]
        step(T.to_tensor(x), T.to_tensor(y))
        for k, t in net.state_dict().items():
            ptr, old = before[k]
            assert t._value.data_ptr() == ptr, f"{k} left its buffer"
            assert np.isfinite(t.numpy()).all()
            assert not np.array_equal(t.numpy(), old), f"{k} not updated"
        for t, ptr in accs:
            assert t._value.data_ptr() == ptr

    @BOTH
    def test_backend_auto_donation_off_cpu(self, P):
        assert P.jit.donation_supported("cpu") is False
        assert P.jit.donation_supported("tpu" if P is J else "cuda") is True
        step = P.jit.TrainStep(_convnet(P), P.optimizer.Momentum(parameters=[]),
                               lambda o, y: o)
        assert step.donate is False      # these runs are on the CPU

    @BOTH
    def test_scaler_falls_back_to_eager(self, P):
        P.seed(5)
        net = _convnet(P)
        opt = P.optimizer.Momentum(0.1, parameters=net.parameters())
        scaler = P.amp.GradScaler(init_loss_scaling=2.0 ** 8)
        step = P.jit.make_train_step(net, opt, P.nn.CrossEntropyLoss(),
                                     scaler=scaler)
        assert step._sf is None  # eager-only
        before = T.jit.fallbacks["scaler"]
        losses = [float(step(P.to_tensor(x), P.to_tensor(y)))
                  for x, y in _conv_batches(k=3, seed=5)]
        assert all(np.isfinite(l) for l in losses)
        assert losses[-1] < losses[0]
        if P is T:
            assert T.jit.fallbacks["scaler"] == before + 3

    def test_jit_step_functional(self):
        """jit_step over a pure function of tensors: no donation on the
        CPU, the same result as the JAX package's."""
        import jax
        import jax.numpy as jnp

        def jsgd(params, grads):
            return jax.tree_util.tree_map(lambda p, g: p - 0.1 * g,
                                          params, grads)

        def tsgd(params, grads):
            return {k: params[k] - 0.1 * grads[k] for k in params}

        jf = J.jit.jit_step(jsgd, donate_argnums=(0,))
        tf = T.jit.jit_step(tsgd, donate_argnums=(0,))
        assert tf._donate_argnums == ()
        p = np.linspace(0, 1, 4).astype(np.float32)
        g = np.full((4,), 2.0, np.float32)
        want = np.asarray(jf({"w": jnp.asarray(p)},
                             {"w": jnp.asarray(g)})["w"])
        for i in range(3):       # warm-up, capture, replay
            out = tf({"w": torch.tensor(p)}, {"w": torch.tensor(g * i)})
            assert isinstance(out["w"], torch.Tensor)
            np.testing.assert_allclose(out["w"].numpy(), p - 0.2 * i,
                                       rtol=1e-6)
        np.testing.assert_allclose(want, p - 0.2, rtol=1e-6)

    @BOTH
    def test_optimizer_fuse_spelling(self, P):
        P.seed(6)
        net = _convnet(P)
        opt = P.optimizer.Momentum(0.1, parameters=net.parameters())
        step = opt.fuse(net, P.nn.CrossEntropyLoss())
        assert isinstance(step, P.jit.TrainStep)
        for x, y in _conv_batches(k=2, seed=6):
            assert np.isfinite(float(step(P.to_tensor(x), P.to_tensor(y))))


class TestNHWCLayout:
    """``tests/test_train_step.py::TestNHWCLayout`` on the port: its
    ChannelsLast nets against its own NCHW twins from the same weights.
    The reference's eval forward is bitwise; the port's NHWC convs run
    other kernels than its NCHW ones (cuDNN's or oneDNN's channels-last
    kernels), so its bound is ``1e-6 * max|ref|``; the per-layout parity
    with JAX is ``tests/test_torch_layout.py``."""

    def _twins(self, factory, seed=7):
        T.seed(seed)
        m1 = factory()
        m2 = T.nn.ChannelsLast(factory())
        m2.set_state_dict(m1.state_dict())
        return m1, m2

    def test_resnet_eval_forward_nhwc_matches_nchw(self):
        from paddle_tpu_torch.vision.models import resnet18
        m1, m2 = self._twins(lambda: resnet18(num_classes=10))
        x = T.to_tensor(np.random.default_rng(0).standard_normal(
            (2, 3, 32, 32)).astype("float32"))
        m1.eval()
        m2.eval()
        a, b = m1(x).numpy(), m2(x).numpy()
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-6 * np.abs(a).max())

    def test_resnet_train_forward_backward_parity(self):
        """Train mode: BN batch statistics and the backward through the
        whole stack, within the reference's bounds."""
        from paddle_tpu_torch.vision.models import resnet18
        m1, m2 = self._twins(lambda: resnet18(num_classes=10), seed=8)
        rng = np.random.default_rng(1)
        x = T.to_tensor(rng.standard_normal((4, 3, 32, 32)).astype("float32"))
        y = T.to_tensor(rng.integers(0, 10, (4,)).astype("int64"))
        loss_fn = T.nn.CrossEntropyLoss()
        m1.train()
        m2.train()
        o1, o2 = m1(x), m2(x)
        np.testing.assert_allclose(o1.numpy(), o2.numpy(), rtol=1e-3,
                                   atol=1e-4)
        loss_fn(o1, y).backward()
        loss_fn(o2, y).backward()
        g1 = m1.conv1.weight.grad.numpy()
        g2 = m2.net.conv1.weight.grad.numpy()
        np.testing.assert_allclose(g1, g2, rtol=1e-2,
                                   atol=1e-3 * np.abs(g1).max())
        np.testing.assert_allclose(m1.bn1._mean.numpy(),
                                   m2.net.bn1._mean.numpy(), rtol=1e-5,
                                   atol=1e-6)

    def test_mobilenet_feature_maps_transposed_back(self):
        from paddle_tpu_torch.vision.models import mobilenet_v3_small
        m1, m2 = self._twins(
            lambda: mobilenet_v3_small(feature_only=True), seed=9)
        x = T.to_tensor(np.random.default_rng(2).standard_normal(
            (1, 3, 64, 64)).astype("float32"))
        m1.eval()
        m2.eval()
        f1, f2 = m1(x), m2(x)
        assert len(f1) == len(f2) == 3
        for a, b in zip(f1, f2):
            assert a.shape == b.shape  # NCHW both
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                       atol=1e-5)

    def test_adaptive_max_pool_channels_last(self):
        """The layout pass sets data_format on AdaptiveMaxPool layers; their
        forward passes it to the functional."""
        class P(T.nn.Layer):
            def __init__(self):
                super().__init__()
                self.pool = T.nn.AdaptiveMaxPool2D(1)

            def forward(self, x):
                return self.pool(x)

        m1, m2 = P(), T.nn.ChannelsLast(P())
        x = T.to_tensor(np.random.default_rng(4).standard_normal(
            (2, 3, 8, 8)).astype("float32"))
        a, b = m1(x), m2(x)
        assert a.shape == b.shape == [2, 3, 1, 1]
        np.testing.assert_array_equal(a.numpy(), b.numpy())

    def test_container_inputs_transposed(self):
        class M(T.nn.Layer):
            def __init__(self):
                super().__init__()
                self.conv = T.nn.Conv2D(3, 4, 1, bias_attr=False)

            def forward(self, d):
                return self.conv(d["img"])

        T.seed(14)
        m1 = M()
        m2 = T.nn.ChannelsLast(M())
        m2.set_state_dict(m1.state_dict())
        x = T.to_tensor(np.random.default_rng(5).standard_normal(
            (2, 3, 6, 6)).astype("float32"))
        np.testing.assert_allclose(m1({"img": x}).numpy(),
                                   m2({"img": x}).numpy(), rtol=1e-6,
                                   atol=1e-6)

    def test_data_format_flip_and_inverse(self):
        net = _convnet(T)
        assert net.conv.data_format == "NCHW"
        T.nn.to_channels_last(net)
        assert net.conv.data_format == "NHWC"
        assert net.bn.data_format == "NHWC"
        assert net.pool.data_format == "NHWC"  # adaptive pool (None before)
        T.nn.to_channels_first(net)
        assert net.conv.data_format == "NCHW"
        assert net.bn.data_format == "NCHW"

    def test_state_dict_interchange(self):
        T.seed(10)
        nchw = _convnet(T)
        wrapped = T.nn.ChannelsLast(_convnet(T))
        sd = wrapped.state_dict()
        assert set(sd) == set(nchw.state_dict())
        assert list(sd["conv.weight"].shape) == [8, 3, 3, 3]
        nchw.set_state_dict(sd)
        wrapped.set_state_dict(nchw.state_dict())

    def test_fused_nhwc_train_step(self):
        """A ChannelsLast net under the captured step tracks the NCHW
        twin's loss, and BatchNorm's running statistics written back by
        the replays match."""
        _, (n1, n2) = _conv_twins(seed=11)
        wrapped = T.nn.ChannelsLast(n2)
        loss_fn = T.nn.CrossEntropyLoss()
        o1 = T.optimizer.Momentum(0.1, parameters=n1.parameters())
        o2 = T.optimizer.Momentum(0.1, parameters=wrapped.parameters())
        s1 = T.jit.make_train_step(n1, o1, loss_fn)
        s2 = T.jit.make_train_step(wrapped, o2, loss_fn)
        for x, y in _conv_batches(k=3, seed=11):
            l1 = s1(T.to_tensor(x), T.to_tensor(y))
            l2 = s2(T.to_tensor(x), T.to_tensor(y))
        np.testing.assert_allclose(float(l1), float(l2), rtol=1e-3,
                                   atol=1e-4)
        np.testing.assert_allclose(n1.bn._mean.numpy(), n2.bn._mean.numpy(),
                                   rtol=1e-5, atol=1e-6)


class TestBatchNormWriteBack:
    def test_running_stats_after_three_captured_steps_equal_eager(self):
        """The captured step rebinds BatchNorm's ``_mean`` / ``_variance``
        every replay (the CPU recording, ``jit/trace.py``): after three
        steps (eager, capture, replay) they equal three eager steps'."""
        _, (t1, t2) = _conv_twins(seed=15)
        loss_fn = T.nn.CrossEntropyLoss()
        o1 = T.optimizer.Momentum(0.1, momentum=0.9,
                                  parameters=t1.parameters())
        o2 = T.optimizer.Momentum(0.1, momentum=0.9,
                                  parameters=t2.parameters())
        step = T.jit.make_train_step(t2, o2, loss_fn)
        for x, y in _conv_batches(k=3, seed=15):
            t1.train()
            loss = loss_fn(t1(T.to_tensor(x)), T.to_tensor(y))
            loss.backward()
            o1.step()
            o1.clear_grad()
            step(T.to_tensor(x), T.to_tensor(y))
        for name in ("_mean", "_variance"):
            np.testing.assert_array_equal(getattr(t2.bn, name).numpy(),
                                          getattr(t1.bn, name).numpy())


class TestPrefetch:
    def test_profile_annotations_flag(self):
        """annotate() is a nullcontext when the flag is off and a real
        span when on, in both packages."""
        from paddle_tpu.profiler import annotate as jannotate
        from paddle_tpu_torch.io.dataloader import prefetch_to_device
        from paddle_tpu_torch.profiler import annotate

        for P, ann in ((J, jannotate), (T, annotate)):
            assert P.get_flags("FLAGS_profile_annotations")[
                "FLAGS_profile_annotations"] is False
            assert isinstance(ann("step"), contextlib.nullcontext)
            P.set_flags({"FLAGS_profile_annotations": True})
            try:
                span = ann("step")
                assert not isinstance(span, contextlib.nullcontext)
                with span:
                    pass
            finally:
                P.set_flags({"FLAGS_profile_annotations": False})
        T.set_flags({"FLAGS_profile_annotations": True})
        try:
            with torch.profiler.profile() as prof:
                net = _bnnet(T)
                opt = T.optimizer.SGD(0.1, parameters=net.parameters())
                step = T.jit.make_train_step(net, opt,
                                             T.nn.CrossEntropyLoss())
                for x, y in _batches(k=3):
                    step(T.to_tensor(x), T.to_tensor(y))
                out = list(prefetch_to_device(
                    [np.zeros((2, 2), np.float32)], size=2, device="cpu"))
        finally:
            T.set_flags({"FLAGS_profile_annotations": False})
        assert len(out) == 1
        names = [e.name for e in prof.events()]
        assert names.count("step") == 3, names.count("step")


class TestHapiJit:
    def test_model_fit_jit_matches_eager(self):
        """Model.prepare(jit=True) trains through fit() on the same loss
        trajectory as the eager Model and as the JAX package's jit Model."""
        rng = np.random.default_rng(3)
        xs = rng.standard_normal((16, 12)).astype("float32")
        ys = rng.integers(0, 4, (16, 1)).astype("int64")
        jn, (te, tj) = _twins(seed=12)
        hist = {}
        for key, P, net, jit in (("J", J, jn, True), ("Te", T, te, False),
                                 ("Tj", T, tj, True)):
            model = P.Model(net)
            model.prepare(P.optimizer.Momentum(0.1,
                                               parameters=net.parameters()),
                          P.nn.CrossEntropyLoss(), jit=jit)
            ds = P.io.TensorDataset([P.to_tensor(xs), P.to_tensor(ys)])
            loader = P.io.DataLoader(ds, batch_size=4)
            hist[key] = model.fit(loader, epochs=2, verbose=0)
        np.testing.assert_allclose(hist["Tj"]["loss"], hist["Te"]["loss"],
                                   rtol=1e-3, atol=1e-4)
        np.testing.assert_allclose(hist["Tj"]["loss"], hist["J"]["loss"],
                                   rtol=1e-3, atol=1e-4)
        assert hist["Tj"]["loss"][-1] < hist["Tj"]["loss"][0]

    def test_bert_train_batch_jit_matches_eager(self):
        """examples/finetune_bert.py's network (dropout 0, the reference's
        tiny config) through ``prepare(jit=True)``: three ``train_batch``
        losses within 1e-5 of the eager Model's and of the JAX package's
        jit Model's, the Accuracy of each batch equal."""
        import importlib
        rng = np.random.default_rng(0)
        ids = rng.integers(0, 1000, (24, 32)).astype("int64")
        labels = (ids[:, 0] >= 500).astype("int64").reshape(-1, 1)
        runs = {}
        J.seed(0)
        sd = None
        for key, P, jit in (("J", J, True), ("Te", T, False),
                            ("Tj", T, True)):
            B = importlib.import_module(P.__name__ + ".models.bert")
            cfg = B.BertConfig(vocab_size=1000, hidden_size=64,
                               num_hidden_layers=2, num_attention_heads=4,
                               intermediate_size=128,
                               max_position_embeddings=64,
                               hidden_dropout_prob=0.0,
                               attention_probs_dropout_prob=0.0)
            if P is J:
                J.seed(0)
            net = B.BertForSequenceClassification(cfg, num_classes=2)
            if sd is None:
                # the reference's deep-copied encoder layers share names
                # and with them AdamW's state (ROADMAP section C): unique
                for i, q in enumerate(net.parameters()):
                    q.name = f"bert_param_{i}"
                sd = {k: v.numpy() for k, v in net.state_dict().items()}
            else:
                net.set_state_dict(sd)
            model = P.Model(net)
            model.prepare(P.optimizer.AdamW(3e-4,
                                            parameters=net.parameters()),
                          P.nn.CrossEntropyLoss(), P.metric.Accuracy(),
                          jit=jit)
            runs[key] = [model.train_batch([ids[i:i + 8]],
                                           [labels[i:i + 8]])
                         for i in range(0, 24, 8)]
        for key in ("Te", "J"):
            for (lt, mt), (lo, mo) in zip(runs["Tj"], runs[key]):
                np.testing.assert_allclose(lt, lo, rtol=1e-5)
                np.testing.assert_allclose(mt, mo)

    @BOTH
    def test_train_batch_metrics_with_jit(self, P):
        P.seed(13)
        net = _bnnet(P)
        model = P.Model(net)
        model.prepare(P.optimizer.Momentum(0.1, parameters=net.parameters()),
                      P.nn.CrossEntropyLoss(), metrics=P.metric.Accuracy(),
                      jit=True)
        for x, y in _batches(k=3, seed=13):
            res = model.train_batch([x], [y.reshape(-1, 1)])
            assert isinstance(res, tuple)  # (losses, metrics)
            assert np.isfinite(res[0][0])


# -- the imperative Sentinel fused into the step -----------------------------

def _sentinel_setup(P, opt_cls="Momentum"):
    P.seed(0)
    net = P.nn.Sequential(P.nn.Linear(4, 8), P.nn.ReLU(), P.nn.Linear(8, 2))
    opt = (P.optimizer.Momentum(0.1, momentum=0.9,
                                parameters=net.parameters())
           if opt_cls == "Momentum" else
           P.optimizer.Adam(0.05, parameters=net.parameters()))
    step = P.jit.make_train_step(net, opt, P.nn.CrossEntropyLoss(),
                                 sentinel=True)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((8, 4)).astype("float32")
    y = rng.integers(0, 2, (8,)).astype("int64")
    return net, opt, step, x, y


def _chaos(P):
    import importlib
    return importlib.import_module(P.__name__ + ".testing.chaos")


class TestSentinelFused:
    @BOTH
    def test_nan_batch_skipped_state_intact_compiled(self, P):
        net, opt, step, x, y = _sentinel_setup(P)
        float(step(P.to_tensor(x), P.to_tensor(y)))  # eager warm-up
        float(step(P.to_tensor(x), P.to_tensor(y)))  # compiled
        assert not step.sentinel.last_bad
        w0 = {p.name: p.numpy().copy() for p in net.parameters()}
        acc0 = {k: {n: t.numpy().copy() for n, t in s.items()}
                for k, s in opt._accumulators.items()}
        loss = float(step(P.to_tensor(_chaos(P).nan_payload(x)),
                          P.to_tensor(y)))
        assert not np.isfinite(loss) and step.sentinel.last_bad
        for p in net.parameters():
            np.testing.assert_array_equal(p.numpy(), w0[p.name])
        for k, s in opt._accumulators.items():
            for n, t in s.items():
                np.testing.assert_array_equal(t.numpy(), acc0[k][n])
        l2 = float(step(P.to_tensor(x), P.to_tensor(y)))
        assert np.isfinite(l2) and not step.sentinel.last_bad

    @BOTH
    def test_nan_on_very_first_step_rolls_back_unborn_accumulators(self, P):
        net, opt, step, x, y = _sentinel_setup(P, "Adam")
        w0 = {p.name: p.numpy().copy() for p in net.parameters()}
        loss = float(step(P.to_tensor(_chaos(P).nan_payload(x)),
                          P.to_tensor(y)))   # FIRST call, eager, NaN
        assert not np.isfinite(loss) and step.sentinel.last_bad
        for p in net.parameters():
            np.testing.assert_array_equal(p.numpy(), w0[p.name])
        for name, store in opt._accumulators.items():
            for pname, t in store.items():
                v = t.numpy()
                assert np.isfinite(v).all(), (name, pname)
                if name in ("moment1", "moment2"):
                    np.testing.assert_array_equal(v, np.zeros_like(v))
                if name in ("beta1_pow_acc", "beta2_pow_acc"):
                    np.testing.assert_array_equal(v, np.ones_like(v))
        for _ in range(3):
            l2 = float(step(P.to_tensor(x), P.to_tensor(y)))
            assert np.isfinite(l2) and not step.sentinel.last_bad
        for p in net.parameters():
            assert np.isfinite(p.numpy()).all()

    def test_sentinel_parity_with_unguarded(self):
        """On clean data the sentinel changes nothing: K guarded fused
        steps == K unguarded ones, bitwise, and the guarded losses equal
        the JAX package's guarded ones (1e-5)."""
        losses = {}
        params = {}
        for P in (J, T):
            nets = []
            for guard in (True, False):
                J.seed(0)
                jn = J.nn.Sequential(J.nn.Linear(4, 8), J.nn.ReLU(),
                                     J.nn.Linear(8, 2))
                net = jn if P is J else P.nn.Sequential(
                    P.nn.Linear(4, 8), P.nn.ReLU(), P.nn.Linear(8, 2))
                if P is T:
                    net.set_state_dict({k: v.numpy() for k, v in
                                        jn.state_dict().items()})
                opt = P.optimizer.SGD(0.1, parameters=net.parameters())
                nets.append((net, P.jit.make_train_step(
                    net, opt, P.nn.CrossEntropyLoss(), sentinel=guard)))
            rng = np.random.default_rng(1)
            for i in range(3):
                x = rng.standard_normal((8, 4)).astype("float32")
                y = rng.integers(0, 2, (8,)).astype("int64")
                la, lb = (float(s(P.to_tensor(x), P.to_tensor(y)))
                          for _, s in nets)
                assert la == lb, (P.__name__, i, la, lb)
                losses.setdefault(P, []).append(la)
            for pa, pb in zip(nets[0][0].parameters(),
                              nets[1][0].parameters()):
                np.testing.assert_array_equal(pa.numpy(), pb.numpy())
            params[P] = [p.numpy() for p in nets[0][0].parameters()]
        np.testing.assert_allclose(losses[T], losses[J], rtol=1e-5)
        for a, b in zip(params[T], params[J]):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)

    @BOTH
    def test_flag_default_off(self, P):
        net = P.nn.Sequential(P.nn.Linear(2, 2))
        opt = P.optimizer.SGD(0.1, parameters=net.parameters())
        step = P.jit.make_train_step(net, opt, P.nn.CrossEntropyLoss())
        assert step.sentinel is None

    @BOTH
    def test_flag_enables_sentinel(self, P):
        P.set_flags({"FLAGS_health_sentinel": True})
        try:
            net = P.nn.Sequential(P.nn.Linear(2, 2))
            opt = P.optimizer.SGD(0.1, parameters=net.parameters())
            step = P.jit.make_train_step(net, opt, P.nn.CrossEntropyLoss())
            assert step.sentinel is not None
        finally:
            P.set_flags({"FLAGS_health_sentinel": False})

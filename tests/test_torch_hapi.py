"""The port's high-level API (``Model``, ``summary``), ``metric`` and
``callbacks`` against the JAX package's.

* ``tests/test_surface.py``'s ``TestHapi`` and ``TestMetric`` cases, each
  run through both packages from the same weights (the port's network
  loaded from the JAX network's ``state_dict()``) on the same data
  (``shuffle=False``: the samplers draw unseeded permutations): losses,
  metrics and predictions within ``1e-5``.
* The callbacks cases of ``tests/test_health.py`` (``AnomalyMonitor``'s
  rollback, abort, LR backoff, clean run and the warn-once path under an
  ``LRScheduler``; ``EarlyStopping`` and ``ReduceLROnPlateau`` with NaN
  metrics), each beside the JAX package's run of the same case.
* ``examples/finetune_bert.py``'s loop at that script's config (hidden
  64, 2 layers, 4 heads, B 8 x S 32) with dropout 0 and 2 epochs:
  ``fit``'s per-epoch loss and accuracy, its eval loss and accuracy,
  ``evaluate`` and ``predict`` equal the JAX package's within ``1e-5``.
  The JAX network's parameters are named uniquely first: the reference's
  deep-copied encoder layers share names and with them AdamW's state
  (ROADMAP §C).
* The functional metrics against JAX's, ``prepare(jit=True)`` and
  ``save(training=False)`` raising ``NotImplementedError`` naming
  ROADMAP item 4, ``prepare(sentinel=True)`` warning, and
  ``ModelCheckpoint`` files (``keep_last_k``, ``async_save``) loading in
  the JAX package's ``framework.io``.
"""

import warnings

import numpy as np
import pytest

import paddle_tpu as J
import paddle_tpu_torch as T

RTOL = 1e-5


@pytest.fixture(autouse=True)
def _port_on_cpu():
    prev = T.get_device()
    T.set_device("cpu")
    yield
    T.set_device(prev)


def both(build, seed=0):
    J.seed(seed)
    jl = build(J)
    tl = build(T)
    tl.set_state_dict(jl.state_dict())
    return jl, tl


def regression_set(p, n=32):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((n, 8)).astype("float32")
    w = rng.standard_normal((8, 1)).astype("float32")
    return p.io.TensorDataset([x, (x @ w).astype("float32")])


class Recorder:
    """A callback of either package recording every epoch's logs."""

    @staticmethod
    def of(p):
        class _Rec(p.callbacks.Callback):
            def __init__(self):
                super().__init__()
                self.epochs = []

            def on_epoch_end(self, epoch, logs=None):
                self.epochs.append(dict(logs or {}))
        return _Rec()


def logs_close(got, want, rtol=RTOL):
    assert got.keys() == want.keys(), (got.keys(), want.keys())
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=rtol,
                                   atol=1e-7, err_msg=k)


class TestHapi:
    def test_fit_decreases_loss(self):
        def build(p):
            return p.nn.Sequential(p.nn.Linear(8, 16), p.nn.ReLU(),
                                   p.nn.Linear(16, 1))
        nets = both(build)
        hists = []
        for p, net in zip((J, T), nets):
            model = p.Model(net)
            model.prepare(optimizer=p.optimizer.Adam(
                learning_rate=1e-2, parameters=net.parameters()),
                loss=p.nn.MSELoss())
            hists.append(model.fit(regression_set(p), batch_size=8,
                                   epochs=3, verbose=0, shuffle=False))
        assert hists[1]["loss"][-1] < hists[1]["loss"][0]
        np.testing.assert_allclose(hists[1]["loss"], hists[0]["loss"],
                                   rtol=RTOL)

    def test_evaluate_and_predict(self):
        nets = both(lambda p: p.nn.Sequential(p.nn.Linear(8, 1)))
        res = []
        for p, net in zip((J, T), nets):
            model = p.Model(net)
            model.prepare(loss=p.nn.MSELoss())
            logs = model.evaluate(regression_set(p, 16), batch_size=8,
                                  verbose=0)
            assert "loss" in logs
            preds = model.predict(regression_set(p, 16), batch_size=8,
                                  stack_outputs=True)
            assert preds[0].shape == (16, 1)
            res.append((logs, preds[0]))
        logs_close(res[1][0], res[0][0])
        np.testing.assert_allclose(res[1][1], res[0][1], rtol=RTOL,
                                   atol=1e-7)

    def test_summary(self):
        def build(p):
            return p.nn.Sequential(p.nn.Linear(8, 16), p.nn.ReLU(),
                                   p.nn.Linear(16, 1))
        stats = [p.summary(net, (1, 8)) for p, net in zip((J, T),
                                                          both(build))]
        assert stats[1] == stats[0]
        assert stats[1]["total_params"] == 8 * 16 + 16 + 16 * 1 + 1

    def test_early_stopping(self):
        nets = both(lambda p: p.nn.Sequential(p.nn.Linear(8, 1)))
        for p, net in zip((J, T), nets):
            model = p.Model(net)
            model.prepare(optimizer=p.optimizer.SGD(
                learning_rate=0.0, parameters=net.parameters()),
                loss=p.nn.MSELoss())
            cb = p.callbacks.EarlyStopping(monitor="loss", patience=1,
                                           verbose=0)
            model.fit(regression_set(p, 16), batch_size=8, epochs=10,
                      verbose=0, callbacks=[cb])
            assert model.stop_training  # zero lr -> no improvement


class TestMetric:
    def test_accuracy(self):
        pred = np.asarray([[0.9, 0.1], [0.3, 0.7], [0.8, 0.2]], np.float32)
        label = np.asarray([[0], [1], [1]])
        for p in (J, T):
            m = p.metric.Accuracy()
            m.update(m.compute(p.to_tensor(pred), p.to_tensor(label)))
            np.testing.assert_allclose(m.accumulate(), 2 / 3, atol=1e-6)
            m.reset()
            assert m.accumulate() == 0.0
        rng = np.random.default_rng(1)
        pred = rng.random((20, 5)).astype(np.float32)
        label = rng.integers(0, 5, (20, 1))
        accs = []
        for p in (J, T):
            m = p.metric.Accuracy(topk=(1, 3))
            m.update(m.compute(p.to_tensor(pred), p.to_tensor(label)))
            assert m.name() == ["acc_top1", "acc_top3"]
            accs.append(m.accumulate())
        assert accs[1] == accs[0]

    def test_precision_recall(self):
        preds = np.asarray([0.9, 0.8, 0.2, 0.6], np.float32)
        labels = np.asarray([1, 0, 1, 1])
        for p in (J, T):
            pr, rc = p.metric.Precision(), p.metric.Recall()
            pr.update(preds, labels)
            rc.update(preds, labels)
            np.testing.assert_allclose(pr.accumulate(), 2 / 3, atol=1e-6)
            np.testing.assert_allclose(rc.accumulate(), 2 / 3, atol=1e-6)

    def test_auc(self):
        rng = np.random.default_rng(2)
        preds = rng.random(64).astype(np.float32)
        labels = rng.integers(0, 2, 64)
        vals = []
        for p in (J, T):
            auc = p.metric.Auc()
            auc.update(np.asarray([0.9, 0.8, 0.1, 0.2], np.float32),
                       np.asarray([1, 1, 0, 0]))
            assert auc.accumulate() > 0.99      # a perfect classifier
            auc.reset()
            auc.update(p.to_tensor(preds), labels)
            vals.append(auc.accumulate())
        assert vals[1] == vals[0]

    @pytest.mark.parametrize("name", ["accuracy", "auc", "precision_recall",
                                      "positive_negative_pair"])
    def test_functional(self, name):
        rng = np.random.default_rng(3)
        args = {"accuracy": (rng.random((6, 3)).astype(np.float32),
                             rng.integers(0, 3, (6, 1))),
                "auc": (rng.random(8).astype(np.float32),
                        rng.integers(0, 2, 8)),
                "precision_recall": (rng.random((6, 3)).astype(np.float32),
                                     rng.integers(0, 3, 6)),
                "positive_negative_pair": (rng.random(6).astype(np.float32),
                                           rng.integers(0, 3, 6),
                                           np.asarray([0, 0, 0, 1, 1, 1]))
                }[name]
        outs = [getattr(p.metric, name)(*[p.to_tensor(a) for a in args])
                for p in (J, T)]
        jo = outs[0] if isinstance(outs[0], tuple) else (outs[0],)
        to = outs[1] if isinstance(outs[1], tuple) else (outs[1],)
        for a, b in zip(to, jo):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6)
        from paddle_tpu_torch.core.dispatch import OP_REGISTRY
        assert OP_REGISTRY[name].category == "metric"


# -- callbacks (tests/test_health.py) --------------------------------------

def toy_set(p, n=32, nan_from=None, nan_until=None):
    class _ToyDS(p.io.Dataset):
        def __init__(self):
            rng = np.random.default_rng(0)
            self.x = rng.standard_normal((n, 4)).astype("float32")
            self.y = rng.integers(0, 2, (n,)).astype("int64")
            self.until = n if nan_until is None else nan_until

        def __len__(self):
            return len(self.x)

        def __getitem__(self, i):
            x = self.x[i]
            if nan_from is not None and nan_from <= i < self.until:
                x = np.full_like(x, np.nan)
            return x, self.y[i]
    return _ToyDS()


def toy_models(lr=None):
    def build(p):
        return p.nn.Sequential(p.nn.Linear(4, 8), p.nn.ReLU(),
                               p.nn.Linear(8, 2))
    out = []
    for p, net in zip((J, T), both(build)):
        model = p.Model(net)
        model.prepare(p.optimizer.SGD(
            learning_rate=0.1 if lr is None else lr(p),
            parameters=net.parameters()), p.nn.CrossEntropyLoss())
        out.append((p, model))
    return out


def weights(model):
    return [q.numpy() for q in model.network.parameters()]


def weights_close(tm, jm):
    for a, b in zip(weights(tm), weights(jm)):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7)


class TestAnomalyMonitor:
    def test_rollback_after_k_consecutive_bad(self):
        runs = []
        for p, model in toy_models():
            cb = p.callbacks.AnomalyMonitor(skip_threshold=2,
                                            max_restores=3, verbose=0)
            model.fit(toy_set(p, nan_from=8, nan_until=16), batch_size=4,
                      epochs=1, verbose=0, shuffle=False, callbacks=[cb])
            assert cb.monitor.restores == 1
            assert cb.monitor.bad_steps == 2
            for w in weights(model):   # the rollback left finite weights
                assert np.isfinite(w).all()
            runs.append(model)
        weights_close(runs[1], runs[0])

    def test_abort_after_m_restores(self):
        for p, model in toy_models():
            cb = p.callbacks.AnomalyMonitor(skip_threshold=2,
                                            max_restores=1, verbose=0)
            with pytest.raises(p.health.HealthAbortError):
                model.fit(toy_set(p, nan_from=8), batch_size=4, epochs=2,
                          verbose=0, shuffle=False, callbacks=[cb])
            assert cb.monitor.restores == 1
            for w in weights(model):
                assert np.isfinite(w).all()

    def test_lr_backoff_applied(self):
        runs = []
        for p, model in toy_models():
            cb = p.callbacks.AnomalyMonitor(skip_threshold=1,
                                            max_restores=4, lr_backoff=0.5,
                                            verbose=0)
            model.fit(toy_set(p, nan_from=8, nan_until=12), batch_size=4,
                      epochs=1, verbose=0, shuffle=False, callbacks=[cb])
            assert cb.monitor.restores >= 1
            assert model._optimizer.get_lr() == pytest.approx(
                0.1 * 0.5 ** cb.monitor.restores)
            runs.append((cb.monitor.restores, model))
        assert runs[1][0] == runs[0][0]
        weights_close(runs[1][1], runs[0][1])

    def test_clean_run_untouched(self):
        runs = []
        for p, model in toy_models():
            cb = p.callbacks.AnomalyMonitor(verbose=0)
            model.fit(toy_set(p), batch_size=4, epochs=1, verbose=0,
                      shuffle=False, callbacks=[cb])
            assert cb.monitor.bad_steps == 0 and cb.monitor.restores == 0
            runs.append(model)
        weights_close(runs[1], runs[0])

    def test_lr_backoff_with_scheduler_rolls_back_without_crash(self):
        for p, model in toy_models(
                lr=lambda p: p.optimizer.lr.StepDecay(0.1, step_size=10)):
            cb = p.callbacks.AnomalyMonitor(skip_threshold=2,
                                            max_restores=3, lr_backoff=0.5,
                                            verbose=0)
            with warnings.catch_warnings(record=True) as w:
                warnings.simplefilter("always")
                model.fit(toy_set(p, nan_from=8, nan_until=16),
                          batch_size=4, epochs=1, verbose=0, shuffle=False,
                          callbacks=[cb])
            assert cb.monitor.restores == 1
            assert sum("LRScheduler" in str(x.message) for x in w) == 1
            for v in weights(model):
                assert np.isfinite(v).all()


class _StubModel:
    def __init__(self):
        self.stop_training = False
        self._optimizer = None


class TestNaNMetricCallbacks:
    @pytest.mark.parametrize("p", [J, T], ids=["jax", "port"])
    def test_early_stopping_nan_first_epoch_not_best(self, p):
        cb = p.callbacks.EarlyStopping(monitor="loss", patience=2, verbose=0)
        cb.set_model(_StubModel())
        cb.on_epoch_end(0, {"loss": float("nan")})
        assert cb.best is None and cb.wait == 1

    @pytest.mark.parametrize("p", [J, T], ids=["jax", "port"])
    def test_early_stopping_nan_run_stops_on_patience(self, p):
        cb = p.callbacks.EarlyStopping(monitor="loss", patience=2, verbose=0)
        m = _StubModel()
        cb.set_model(m)
        cb.on_epoch_end(0, {"loss": 1.0})
        for e in range(1, 3):
            cb.on_epoch_end(e, {"loss": float("nan")})
        assert m.stop_training and cb.best == 1.0

    @pytest.mark.parametrize("p", [J, T], ids=["jax", "port"])
    def test_early_stopping_max_mode_nan(self, p):
        cb = p.callbacks.EarlyStopping(monitor="acc", mode="max", patience=1,
                                       verbose=0)
        cb.set_model(_StubModel())
        cb.on_epoch_end(0, {"acc": float("nan")})
        assert cb.best is None and cb.wait == 1

    @pytest.mark.parametrize("p", [J, T], ids=["jax", "port"])
    def test_reduce_lr_nan_not_best_and_plateaus(self, p):
        class _Opt:
            _lr = 0.1

            def set_lr(self, v):
                self._lr = v

            def get_lr(self):
                return self._lr

        m = _StubModel()
        m._optimizer = _Opt()
        cb = p.callbacks.ReduceLROnPlateau(monitor="loss", factor=0.5,
                                           patience=2, verbose=0)
        cb.set_model(m)
        cb.on_epoch_end(0, {"loss": float("nan")})
        assert cb.best is None and cb.wait == 1
        cb.on_epoch_end(1, {"loss": float("nan")})
        assert m._optimizer._lr == pytest.approx(0.05)


# -- examples/finetune_bert.py's loop ---------------------------------------

def finetune_bert(p, rename, epochs=2, batch=8):
    """``examples/finetune_bert.py`` in package ``p`` with dropout 0 and
    no shuffle; returns the per-epoch logs, ``evaluate``'s and
    ``predict``'s results."""
    import paddle_tpu.models.bert as JB
    import paddle_tpu_torch.models.bert as TB
    B = JB if p is J else TB
    cfg = B.BertConfig(vocab_size=1000, hidden_size=64, num_hidden_layers=2,
                       num_attention_heads=4, intermediate_size=128,
                       max_position_embeddings=64, hidden_dropout_prob=0.0,
                       attention_probs_dropout_prob=0.0)
    p.seed(0)
    net = B.BertForSequenceClassification(cfg, num_classes=2)
    rename(net)

    rng = np.random.default_rng(0)
    ids = rng.integers(0, cfg.vocab_size, (256, 32)).astype("int64")
    labels = (ids[:, 0] >= cfg.vocab_size // 2).astype("int64")
    train = p.io.TensorDataset([ids[:192], labels[:192]])
    val = p.io.TensorDataset([ids[192:], labels[192:]])

    class Net(p.nn.Layer):
        def __init__(self, bert):
            super().__init__()
            self.bert = bert

        def forward(self, x):
            return self.bert(x)

    model = p.Model(Net(net))
    model.prepare(
        optimizer=p.optimizer.AdamW(learning_rate=3e-4,
                                    parameters=net.parameters()),
        loss=p.nn.CrossEntropyLoss(), metrics=p.metric.Accuracy())
    rec = Recorder.of(p)
    model.fit(train, val, batch_size=batch, epochs=epochs, verbose=0,
              shuffle=False, callbacks=[rec])
    ev = model.evaluate(val, batch_size=batch, verbose=0)
    pred = model.predict(val, batch_size=batch, stack_outputs=True)[0]
    return rec.epochs, ev, pred, net


def test_finetune_bert_matches_jax():
    state = {}

    def rename_j(net):
        for i, q in enumerate(net.parameters()):
            q.name = f"bert_param_{i}"
        state["sd"] = {k: np.array(v.numpy())     # before training moves
                       for k, v in net.state_dict().items()}

    def load_t(net):
        net.set_state_dict(state["sd"])

    ej, evj, pj, _ = finetune_bert(J, rename_j)
    et, evt, pt, _ = finetune_bert(T, load_t)
    assert len(et) == len(ej) == 2
    for a, b in zip(et, ej):
        logs_close(a, b)
        assert {"loss", "acc", "eval_loss", "eval_acc"} <= set(a)
    logs_close(evt, evj)
    np.testing.assert_allclose(pt, pj, rtol=RTOL, atol=1e-6)


# -- refusals, sentinel, checkpoints ----------------------------------------

def test_jit_paths_raise_naming_item_4(tmp_path):
    net = T.nn.Sequential(T.nn.Linear(8, 1))
    model = T.Model(net)
    with pytest.raises(NotImplementedError, match="item 4"):
        model.prepare(T.optimizer.SGD(parameters=net.parameters()),
                      T.nn.MSELoss(), jit=True)
    model.prepare(T.optimizer.SGD(parameters=net.parameters()),
                  T.nn.MSELoss())
    with pytest.raises(NotImplementedError, match="item 4"):
        model.save(str(tmp_path / "infer"), training=False)


def test_sentinel_without_jit_warns_and_is_ignored():
    for p in (J, T):
        net = p.nn.Sequential(p.nn.Linear(8, 1))
        model = p.Model(net)
        with pytest.warns(UserWarning, match="ignoring sentinel"):
            model.prepare(p.optimizer.SGD(parameters=net.parameters()),
                          p.nn.MSELoss(), sentinel=True)
        model.fit(regression_set(p, 8), batch_size=4, verbose=0)
    assert T.get_flags("FLAGS_health_sentinel") == \
        J.get_flags("FLAGS_health_sentinel")


@pytest.mark.parametrize("async_save", [False, True])
def test_model_checkpoint_files_load_in_jax(tmp_path, async_save):
    from paddle_tpu.framework import io as jio

    def build(p):
        return p.nn.Sequential(p.nn.Linear(8, 16), p.nn.ReLU(),
                               p.nn.Linear(16, 1))
    _, net = both(build)
    model = T.Model(net)
    model.prepare(T.optimizer.Adam(learning_rate=1e-2,
                                   parameters=net.parameters()),
                  T.nn.MSELoss(), amp_configs={"level": "O1"})
    cb = T.callbacks.ModelCheckpoint(save_dir=str(tmp_path), keep_last_k=1,
                                     async_save=async_save)
    model.fit(regression_set(T), batch_size=8, epochs=3, verbose=0,
              shuffle=False, callbacks=[cb])
    names = sorted(x.name for x in tmp_path.iterdir())
    assert names == ["2.pdopt", "2.pdparams", "final.pdopt",
                     "final.pdparams"], names
    sd = jio.load(str(tmp_path / "final.pdparams"))
    own = net.state_dict()
    assert sd.keys() == own.keys()
    for k in own:
        np.testing.assert_array_equal(np.asarray(sd[k].numpy()),
                                      own[k].numpy())
    # and back: the port's Model.load restores them
    fresh = T.Model(build(T))
    fresh.prepare(T.optimizer.Adam(parameters=fresh.parameters()),
                  T.nn.MSELoss())
    fresh.load(str(tmp_path / "final"))
    for a, b in zip(fresh.parameters(), net.parameters()):
        np.testing.assert_array_equal(a.numpy(), b.numpy())

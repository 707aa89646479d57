"""``paddle.static`` on the port (``paddle_tpu_torch/static``) against the
JAX package's: every case of ``tests/test_static_program.py`` runs through
both packages on the same inputs, then a 2-layer, 32-wide BERT Program on
non-zero feeds, static SGD and AdamW training over 5 steps, the
inference-model round trip, the AMP and distributed-region contracts of
the recorder, and the records of two reference faults (ROADMAP §C):

* F6: a Program built on ``data("ids", [None, 16])`` fails at batch 4 in
  both packages (``reshape`` holds the construction's shape), and the
  same Program declared ``[4, 16]`` replays;
* F7: the reference's ``paddle.disable_static()`` does nothing, so
  static mode and the recording go on; the port leaves static mode.

Fetched values within ``1e-5 * max|ref|`` of the JAX package's (the
losses of a training run within ``1e-5 * |loss|`` a step, SGD's final
weights within ``1e-4 * max|w|``, ``max|w|`` at least 1e-2 of the
model's largest weight: the key biases get a gradient that is zero
analytically, and both packages move them by rounding noise); the port's
static replay equals its own eager run bit for bit.
"""

import warnings

import numpy as np
import pytest

import paddle_tpu as J
import paddle_tpu_torch as T
from paddle_tpu.models import bert as JB
from paddle_tpu.static.program import reset_programs as j_reset
from paddle_tpu_torch.models import bert as TB
from paddle_tpu_torch.static.program import reset_programs as t_reset

FWD = 1e-5
BERT = dict(vocab_size=64, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=2, intermediate_size=64,
            max_position_embeddings=32, hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0)
RESET = {J: j_reset, T: t_reset}


@pytest.fixture(autouse=True)
def _clean():
    prev = T.get_device()
    T.set_device("cpu")
    for p in (J, T):
        RESET[p]()
    yield
    for p in (J, T):
        p.static.disable_static()
        RESET[p]()
    T.set_device(prev)


def both(scenario):
    """``scenario(p)`` in static mode for the JAX package, then the port:
    [JAX's result, the port's]."""
    outs = []
    for p in (J, T):
        RESET[p]()
        p.static.enable_static()
        try:
            outs.append(scenario(p))
        finally:
            p.static.disable_static()
    return outs


def close(got, want, rtol=FWD, what="", floor=1e-30):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max(initial=0.0))
    assert err <= rtol * max(float(np.abs(want).max(initial=0.0)), floor), \
        f"{what}: {err}"


def linear_twin(p, w, b):
    lin = p.nn.Linear(int(w.shape[0]), int(w.shape[1]))
    lin.weight.set_value(w)
    lin.bias.set_value(b)
    return lin


# -- tests/test_static_program.py, through both packages ------------------------

class TestStaticWorkflow:
    def test_inference_program_replays_with_feeds(self):
        w = np.arange(8, dtype=np.float32).reshape(4, 2)
        xv = np.random.default_rng(0).standard_normal((5, 4)).astype(
            np.float32)                       # batch 5 != 1

        def run(p):
            x = p.static.data("x", [None, 4], "float32")
            out2 = p.matmul(x, p.to_tensor(w)) + 1.0
            exe = p.static.Executor()
            exe.run(p.static.default_startup_program())
            return exe.run(feed={"x": xv}, fetch_list=[out2])[0]
        jr, tr = both(run)
        close(tr, jr)
        close(tr, xv @ w + 1.0)

    def test_layers_record_and_params_update_across_runs(self):
        rng = np.random.default_rng(0)
        w0 = rng.standard_normal((3, 1)).astype(np.float32)
        b0 = np.zeros(1, np.float32)
        Xv = rng.standard_normal((16, 3)).astype(np.float32)
        Yv = Xv @ np.array([[1.0], [-1.0], [0.5]], np.float32)

        def run(p):
            x = p.static.data("x", [None, 3], "float32")
            y = p.static.data("y", [None, 1], "float32")
            lin = linear_twin(p, w0, b0)
            loss = ((lin(x) - y) ** 2).mean()
            opt = p.optimizer.SGD(learning_rate=0.1,
                                  parameters=lin.parameters())
            opt.minimize(loss)
            exe = p.static.Executor()
            exe.run(p.static.default_startup_program())
            losses = [float(exe.run(feed={"x": Xv, "y": Yv},
                                    fetch_list=[loss])[0])
                      for _ in range(30)]
            return losses, lin.weight.numpy()
        (jl, jw), (tl, tw) = both(run)
        assert tl[-1] < tl[0] * 0.1, (tl[0], tl[-1])
        close(tl, jl, what="losses")
        close(tw, jw, 1e-4, "weights")

    def test_program_guard_isolation(self):
        def run(p):
            main2 = p.static.Program()
            with p.static.program_guard(main2):
                a = p.to_tensor(np.ones(2, np.float32))
                a * 3.0
            assert p.static.default_main_program() is not main2
            return len(main2.ops)
        jn, tn = both(run)
        assert tn == jn >= 1

    def test_fetch_intermediate(self):
        xv = np.ones((2, 2), np.float32)

        def run(p):
            x = p.static.data("x", [2, 2], "float32")
            mid = x * 2.0
            out = mid + 1.0
            return p.static.Executor().run(feed={"x": xv},
                                           fetch_list=[mid, out])
        (jm, jo), (tm, to) = both(run)
        close(tm, jm)
        close(to, jo)
        close(to, 2 * xv + 1)

    def test_static_nn_fc(self):
        rng = np.random.default_rng(1)
        w = rng.standard_normal((4, 3)).astype(np.float32)
        xv = rng.standard_normal((6, 4)).astype(np.float32)

        def run(p):
            x = p.static.data("x", [None, 4], "float32")
            out = p.static.nn.fc(x, 3, weight=p.to_tensor(w))
            return p.static.Executor().run(feed={"x": xv},
                                           fetch_list=[out])[0]
        jr, tr = both(run)
        close(tr, jr)
        close(tr, xv @ w)

    def test_eager_mode_unaffected_after_disable(self):
        def run(p):
            p.static.disable_static()
            n_before = len(p.static.default_main_program().ops)
            out = p.to_tensor(np.ones(3, np.float32)) + 1.0
            return out.numpy(), len(p.static.default_main_program().ops) \
                - n_before
        (jo, jn), (to, tn) = both(run)
        close(to, [2, 2, 2])
        assert jn == tn == 0

    def test_passthrough_fetch_of_fed_placeholder(self):
        def run(p):
            x = p.static.data("x", [2], "float32")
            return p.static.Executor().run(
                feed={"x": np.array([3.0, 4.0], np.float32)},
                fetch_list=[x])[0]
        jr, tr = both(run)
        close(tr, jr)
        close(tr, [3.0, 4.0])

    def test_stateful_op_warns(self):
        def run(p):
            x = p.static.data("x", [4, 4], "float32")
            with warnings.catch_warnings(record=True) as w:
                warnings.simplefilter("always")
                p.nn.functional.dropout(x, 0.5, training=True)
            return any("construction-time state" in str(m.message)
                       for m in w)
        assert both(run) == [True, True]


class TestMissingFeed:
    def test_missing_feed_raises_with_name(self):
        def run(p):
            x = p.static.data("x", [None, 4], "float32")
            out = p.matmul(x, p.to_tensor(np.ones((4, 2), np.float32)))
            with pytest.raises(p.static.MissingFeedError) as ei:
                p.static.Executor().run(
                    feed={"X_typo": np.ones((3, 4), np.float32)},
                    fetch_list=[out])
            return ei.value.missing, "x" in str(ei.value)
        assert both(run) == [(["x"], True)] * 2

    def test_unrelated_placeholder_may_stay_unfed(self):
        def run(p):
            x = p.static.data("x", [2], "float32")
            y = p.static.data("y", [2], "float32")
            out_x = x * 2.0
            y + 1.0                          # another head, not fetched
            return p.static.Executor().run(
                feed={"x": np.array([1.0, 2.0], np.float32)},
                fetch_list=[out_x])[0]
        jr, tr = both(run)
        close(tr, jr)
        close(tr, [2.0, 4.0])

    def test_training_program_requires_loss_feeds(self):
        def run(p):
            x = p.static.data("x", [None, 3], "float32")
            y = p.static.data("y", [None, 1], "float32")
            lin = linear_twin(p, np.ones((3, 1), np.float32),
                              np.zeros(1, np.float32))
            pred = lin(x)
            loss = ((pred - y) ** 2).mean()
            p.optimizer.SGD(learning_rate=0.1,
                            parameters=lin.parameters()).minimize(loss)
            with pytest.raises(p.static.MissingFeedError) as ei:
                p.static.Executor().run(
                    feed={"x": np.ones((4, 3), np.float32)},
                    fetch_list=[pred])
            return ei.value.missing
        assert both(run) == [["y"], ["y"]]

    def test_passthrough_fetch_of_unfed_placeholder_raises(self):
        def run(p):
            x = p.static.data("x", [2], "float32")
            with pytest.raises(p.static.MissingFeedError):
                p.static.Executor().run(feed={}, fetch_list=[x])
            return True
        assert both(run) == [True, True]


# -- BERT as a static Program ---------------------------------------------------

def bert_twins(seed=0, **kw):
    J.seed(seed)
    jnet = JB.BertForSequenceClassification(JB.BertConfig(**BERT), **kw)
    tnet = TB.BertForSequenceClassification(TB.BertConfig(**BERT), **kw)
    missing, unexpected = tnet.set_state_dict(jnet.state_dict())
    assert not missing and not unexpected
    for i, q in enumerate(jnet.parameters()):
        q.name = f"static_bert_param_{i}"     # the reference's shared names
    return {J: jnet, T: tnet}


def test_bert_program_matches_jax_on_nonzero_feeds():
    nets = bert_twins(num_classes=2, dropout=0.0)
    feeds = [np.random.default_rng(s).integers(1, 64, (4, 16))
             for s in range(3)]

    def run(p):
        net = nets[p]
        net.eval()
        ids = p.static.data("input_ids", [4, 16], "int64")
        logits = net(ids)
        exe = p.static.Executor()
        return [exe.run(feed={"input_ids": f}, fetch_list=[logits])[0]
                for f in feeds], len(p.static.default_main_program().ops)
    (jr, jops), (tr, tops) = both(run)
    assert tops >= 40
    for i, f in enumerate(feeds):
        close(tr[i], jr[i], what=f"feed {i}")
        eager = nets[T](T.to_tensor(f)).numpy()
        np.testing.assert_array_equal(tr[i], eager)


@pytest.mark.parametrize("opt_name", ["SGD", "AdamW"])
def test_bert_static_training_matches_jax(opt_name):
    nets = bert_twins(seed=1, num_classes=2, dropout=0.0)
    rng = np.random.default_rng(2)
    ids = rng.integers(1, 64, (4, 16))
    labels = rng.integers(0, 2, (4,))
    t_start = {k: v.numpy().copy() for k, v in nets[T].state_dict().items()}
    lr = 0.05 if opt_name == "SGD" else 1e-3

    def run(p):
        net = nets[p]
        x = p.static.data("input_ids", [4, 16], "int64")
        y = p.static.data("labels", [4], "int64")
        loss, _ = net(x, labels=y)
        getattr(p.optimizer, opt_name)(
            learning_rate=lr, parameters=net.parameters()).minimize(loss)
        exe = p.static.Executor()
        return [float(exe.run(feed={"input_ids": ids, "labels": labels},
                              fetch_list=[loss])[0]) for _ in range(5)]
    jl, tl = both(run)
    assert tl[-1] < tl[0]
    for a, b in zip(tl, jl):
        assert abs(a - b) <= FWD * abs(b), (tl, jl)
    t_static = {k: v.numpy() for k, v in nets[T].state_dict().items()}
    if opt_name == "SGD":
        j_final = {k: v.numpy() for k, v in nets[J].state_dict().items()}
        top = max(float(np.abs(v).max()) for v in j_final.values())
        for k in t_static:
            close(t_static[k], j_final[k], 1e-4, k, 1e-2 * top)
    # the same 5 steps eagerly from the same weights: equal bit for bit
    net = TB.BertForSequenceClassification(TB.BertConfig(**BERT),
                                           num_classes=2, dropout=0.0)
    net.set_state_dict(t_start)
    opt = getattr(T.optimizer, opt_name)(learning_rate=lr,
                                         parameters=net.parameters())
    eager = []
    for _ in range(5):
        loss, _ = net(T.to_tensor(ids), labels=T.to_tensor(labels))
        loss.backward()
        opt.step()
        opt.clear_grad()
        eager.append(float(loss))
    assert eager == tl
    for k, v in net.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), t_static[k])


def test_inference_model_round_trip(tmp_path):
    rng = np.random.default_rng(3)
    w = rng.standard_normal((4, 3)).astype(np.float32)
    b = rng.standard_normal(3).astype(np.float32)
    xv = rng.standard_normal((2, 4)).astype(np.float32)
    outs = []
    for p in (J, T):
        net = linear_twin(p, w, b)
        net.eval()
        path = str(tmp_path / p.__name__ / "lin")
        p.static.save_inference_model(
            path, [p.static.InputSpec([2, 4], "float32", "x")], net)
        loaded = p.static.load_inference_model(path)
        got = loaded(p.to_tensor(xv))
        got = got[0] if isinstance(got, (list, tuple)) else got
        close(got.numpy(), net(p.to_tensor(xv)).numpy())
        outs.append(got.numpy())
    close(outs[1], outs[0])


def test_amp_replay_outside_auto_cast_matches_reference():
    """The recorder keeps the op's own function, not the auto_cast around
    it: a Program built under ``auto_cast`` replays uncast outside it, as
    the reference's does."""
    rng = np.random.default_rng(4)
    w = rng.standard_normal((4, 4)).astype(np.float32)
    xv = rng.standard_normal((2, 4)).astype(np.float32)

    def run(p):
        x = p.static.data("x", [2, 4], "float32")
        with p.amp.auto_cast(dtype="bfloat16"):
            out = p.matmul(x, p.to_tensor(w))
        built = str(out.dtype)
        return built, p.static.Executor().run(feed={"x": xv},
                                              fetch_list=[out])[0]
    (jd, jr), (td, tr) = both(run)
    assert "bfloat16" in jd and "bfloat16" in td
    assert jr.dtype == tr.dtype == np.float32
    close(tr, jr)
    close(tr, xv @ w)


def test_distributed_region_refuses_to_record(monkeypatch):
    from paddle_tpu_torch.core import dispatch
    monkeypatch.setattr(dispatch._Regions, "active", object())
    T.static.enable_static()
    with pytest.raises(RuntimeError, match="static Program"):
        T.to_tensor(np.ones(2, np.float32)) * 2.0


# -- records of the reference's faults (ROADMAP §C) -----------------------------

def test_f6_replay_keeps_the_construction_shapes():
    """F6: ``Executor.run`` does not re-trace per feed shape: a Program on
    a ``[None, 16]`` placeholder (built at batch 1) fails at batch 4 in
    ``reshape`` in both packages; declared ``[4, 16]``, it replays."""
    nets = bert_twins(num_classes=2, dropout=0.0)
    feed = np.random.default_rng(5).integers(1, 64, (4, 16))

    def run(p):
        net = nets[p]
        net.eval()
        ids = p.static.data("ids", [None, 16], "int64")
        out = net(ids)
        with pytest.raises(p.core.enforce.InvalidArgumentError,
                           match="reshape"):
            p.static.Executor().run(feed={"ids": feed}, fetch_list=[out])
        RESET[p]()
        p.static.enable_static()
        ids = p.static.data("ids", [4, 16], "int64")
        out = net(ids)
        return p.static.Executor().run(feed={"ids": feed},
                                       fetch_list=[out])[0]
    jr, tr = both(run)
    close(tr, jr)


def test_f7_disable_static_leaves_static_mode():
    """F7: the reference's ``paddle.disable_static()`` is a no-op (static
    mode and the recording go on, and ``in_dynamic_mode()`` says True
    throughout); the port's leaves static mode."""
    J.enable_static()
    J.disable_static()
    n = len(J.static.default_main_program().ops)
    J.to_tensor(np.ones(2, np.float32)) + 1.0
    assert J.static.in_static_mode() and J.in_dynamic_mode()
    assert len(J.static.default_main_program().ops) == n + 1
    J.static.disable_static()

    T.enable_static()
    assert T.static.in_static_mode() and not T.in_dynamic_mode()
    T.disable_static()
    n = len(T.static.default_main_program().ops)
    T.to_tensor(np.ones(2, np.float32)) + 1.0
    assert not T.static.in_static_mode() and T.in_dynamic_mode()
    assert len(T.static.default_main_program().ops) == n


def test_reset_programs_moves_the_recorder():
    """``reset_programs`` under static mode: the ops that follow record
    into the new default Program, where ``data`` registers its feed, and
    the Program replays them."""
    T.enable_static()
    T.to_tensor(np.ones(2, np.float32)) + 1.0
    t_reset()
    x = T.static.data("x", [2], "float32")
    y = x * 3.0
    T.disable_static()
    prog = T.static.default_main_program()
    assert len(prog.ops) == 1 and list(prog.feeds) == ["x"]
    got = T.static.Executor().run(
        feed={"x": np.array([1.0, 2.0], np.float32)}, fetch_list=[y])[0]
    np.testing.assert_array_equal(got, [3.0, 6.0])

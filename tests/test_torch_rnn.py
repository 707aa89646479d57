"""The port's recurrent layers (``nn/layers/rnn.py``) and fused RNN ops
(``nn/functional/fused_rnn.py``) against the JAX package's: the cells,
``SimpleRNN`` / ``LSTM`` / ``GRU`` at 1-2 layers, both directions and
both ``time_major`` settings, with and without initial states, ``RNN`` /
``BiRNN`` over each cell, ``fusion_gru`` / ``fusion_lstm`` / ``multi_gru``
/ ``gru_unit`` / ``lstm_unit``, and their gradients. Ports
``tests/test_nn.py::TestRNN`` and ``tests/test_legacy_ops.py::
TestIncubateFused::test_fusion_rnn_shapes``.

The JAX layer's weights are carried across with ``state_dict_from_jax``;
inputs are seeded numpy. Outputs and final states within ``1e-5 *
max|ref|``, gradients of ``sum(out)`` within ``1e-5 * max|g|``.

``sequence_length``: the reference accepts it and ignores it
(``test_reference_ignores_sequence_length`` records that, ROADMAP §C);
the port masks as Paddle does, held to per-row runs on each row's own
steps. Dropout between layers draws from the port's generator, so the
parity runs use ``dropout=0`` (or eval mode) and the dropout test holds
the mask's statistics.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as J
import paddle_tpu_torch as T
from paddle_tpu_torch.models.convert import state_dict_from_jax


@pytest.fixture(autouse=True)
def _port_on_cpu():
    prev = T.get_device()
    T.set_device("cpu")
    yield
    T.set_device(prev)


def close(got, want, rtol=1e-5, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max(initial=0.0)), 1e-30)
    err = float(np.abs(got - want).max(initial=0.0))
    assert err <= rtol * scale, f"{what}: max err {err} > {rtol} * {scale}"


def _leaves(x):
    if isinstance(x, (tuple, list)):
        out = []
        for v in x:
            out += _leaves(v)
        return out
    return [x]


def twins(make_j, make_t):
    J.seed(0)
    jm = make_j()
    tm = make_t()
    tm.set_state_dict(state_dict_from_jax(jm))
    return jm, tm


def run_both(jm, tm, arrays, call=None, grad=True):
    """Forward both on the same arrays; compare every output leaf, then
    the gradients of the sum of the first output leaf for the inputs and
    every parameter."""
    call = call or (lambda m, *a: m(*a))
    res = []
    for P, m in ((J, jm), (T, tm)):
        ins = [None if a is None else
               [P.to_tensor(x, stop_gradient=False) for x in a]
               if isinstance(a, tuple) else
               P.to_tensor(a, stop_gradient=not (grad and a.dtype.kind == "f"))
               for a in arrays]
        args = [tuple(i) if isinstance(i, list) else i for i in ins]
        out = _leaves(call(m, *args))
        res.append((ins, out, m))
    (ji, jo, jm), (ti, to, tm) = res
    assert len(jo) == len(to)
    for i, (a, b) in enumerate(zip(jo, to)):
        close(b.numpy(), a.numpy(), what=f"output {i}")
    if not grad:
        return to
    jo[0].sum().backward()
    to[0].sum().backward()
    flat = lambda ins: [t for i in ins if i is not None  # noqa: E731
                        for t in (i if isinstance(i, list) else [i])
                        if not t.stop_gradient]
    for a, b in zip(flat(ji), flat(ti)):
        close(b.grad.numpy(), a.grad.numpy(), what="input grad")
    jp = dict(jm.named_parameters())
    for name, p in tm.named_parameters():
        close(p.grad.numpy(), jp[name].grad.numpy(), what=f"grad {name}")
    return to


RNG = np.random.default_rng(0)


def randn(*shape):
    return RNG.standard_normal(shape).astype(np.float32)


# -- cells --------------------------------------------------------------------

@pytest.mark.parametrize("cell,kw", [("SimpleRNNCell", {}),
                                     ("SimpleRNNCell",
                                      {"activation": "relu"}),
                                     ("LSTMCell", {}), ("GRUCell", {})])
@pytest.mark.parametrize("with_state", [False, True])
def test_cells(cell, kw, with_state):
    jm, tm = twins(lambda: getattr(J.nn, cell)(3, 5, **kw),
                   lambda: getattr(T.nn, cell)(3, 5, **kw))
    x = randn(4, 3)
    state = None
    if with_state:
        state = (randn(4, 5), randn(4, 5)) if cell == "LSTMCell" else \
            randn(4, 5)
    run_both(jm, tm, [x, state])


# -- multi-layer recurrences --------------------------------------------------

@pytest.mark.parametrize("cls", ["SimpleRNN", "LSTM", "GRU"])
@pytest.mark.parametrize("layers,direction", [(1, "forward"),
                                              (2, "bidirect"),
                                              (2, "forward"),
                                              (1, "bidirectional")])
@pytest.mark.parametrize("time_major", [False, True])
def test_recurrent_layers(cls, layers, direction, time_major):
    kw = dict(num_layers=layers, direction=direction, time_major=time_major)
    jm, tm = twins(lambda: getattr(J.nn, cls)(3, 4, **kw),
                   lambda: getattr(T.nn, cls)(3, 4, **kw))
    x = randn(5, 2, 3) if time_major else randn(2, 5, 3)
    run_both(jm, tm, [x])


@pytest.mark.parametrize("cls", ["SimpleRNN", "LSTM", "GRU"])
def test_initial_states(cls):
    kw = dict(num_layers=2, direction="bidirect")
    jm, tm = twins(lambda: getattr(J.nn, cls)(3, 4, **kw),
                   lambda: getattr(T.nn, cls)(3, 4, **kw))
    h0 = randn(4, 2, 4)
    st = (h0, randn(4, 2, 4)) if cls == "LSTM" else h0
    run_both(jm, tm, [randn(2, 6, 3), st])


def test_simple_rnn_relu():
    kw = dict(num_layers=2, activation="relu")
    jm, tm = twins(lambda: J.nn.SimpleRNN(3, 4, **kw),
                   lambda: T.nn.SimpleRNN(3, 4, **kw))
    run_both(jm, tm, [randn(2, 5, 3)])


def test_lstm_matches_torch():
    """``tests/test_nn.py::TestRNN::test_lstm_matches_torch``: torch's
    LSTM has the same layout and gate order."""
    torch.manual_seed(0)
    x = RNG.random((2, 5, 3)).astype(np.float32)
    lstm = T.nn.LSTM(3, 4)
    tl = torch.nn.LSTM(3, 4, batch_first=True)
    for n in ("weight_ih_l0", "weight_hh_l0", "bias_ih_l0", "bias_hh_l0"):
        getattr(lstm, n).set_value(getattr(tl, n).detach().numpy())
    out, (h, c) = lstm(T.to_tensor(x))
    tout, (th, tc) = tl(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), tout.detach().numpy(), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(h.numpy(), th.detach().numpy(), rtol=1e-4,
                               atol=1e-5)


def test_gru_bidirectional_shapes():
    out, h = T.nn.GRU(3, 4, num_layers=2, direction="bidirect")(
        T.to_tensor(RNG.random((2, 5, 3)).astype(np.float32)))
    assert out.shape == [2, 5, 8] and h.shape == [4, 2, 4]


def test_dropout_between_layers():
    """A 3-layer LSTM at dropout 0.5 in training: the two inter-layer
    masks zero about half of the entries and scale the rest by 2 (seen
    through the layer after: its outputs differ from eval mode), and eval
    mode equals the JAX package's."""
    kw = dict(num_layers=3, dropout=0.5)
    jm, tm = twins(lambda: J.nn.LSTM(3, 4, **kw),
                   lambda: T.nn.LSTM(3, 4, **kw))
    x = randn(8, 6, 3)
    T.seed(1)
    keep = []
    orig = T.nn.functional.common._keep_mask

    def spy(v, p, shape):
        k = orig(v, p, shape)
        keep.append(k)
        return k
    T.nn.functional.common._keep_mask = spy
    try:
        train_out = tm(T.to_tensor(x))[0].numpy()
    finally:
        T.nn.functional.common._keep_mask = orig
    assert len(keep) == 2 and keep[0].shape == (6, 8, 4)
    frac = float(torch.cat([k.flatten() for k in keep]).float().mean())
    assert 0.35 < frac < 0.65, frac
    jm.eval()
    tm.eval()
    eval_out = run_both(jm, tm, [x], grad=False)[0].numpy()
    assert np.abs(train_out - eval_out).max() > 1e-3


# -- sequence_length ---------------------------------------------------------

LENS = np.array([5, 2, 4, 1], np.int64)


@pytest.mark.parametrize("cls", ["LSTM", "GRU", "SimpleRNN"])
def test_sequence_length_masks_each_row(cls):
    """Each row equals a run on its own first ``len`` steps; its later
    outputs are zeros and its final state is the state at its length, in
    both directions (the reverse direction starts at the row's last
    step)."""
    kw = dict(num_layers=2, direction="bidirect")
    m = getattr(T.nn, cls)(3, 4, **kw)
    x = randn(4, 5, 3)
    out, st = m(T.to_tensor(x), sequence_length=T.to_tensor(LENS))
    finals = [s.numpy() for s in (st if cls == "LSTM" else (st,))]
    for b, n in enumerate(LENS):
        o1, s1 = m(T.to_tensor(x[b:b + 1, :n]))
        close(out.numpy()[b, :n], o1.numpy()[0], what=f"row {b}")
        assert (out.numpy()[b, n:] == 0).all()
        for f, g in zip(finals, (s1 if cls == "LSTM" else (s1,))):
            close(f[:, b], g.numpy()[:, 0], what=f"row {b} state")


def test_reference_ignores_sequence_length():
    """ROADMAP §C: the JAX package accepts ``sequence_length`` and ignores
    it (``paddle_tpu/nn/layers/rnn.py:174``), so a padded row's outputs
    past its length are not zeros and its final state runs over the
    padding; Paddle masks them."""
    jm = J.nn.GRU(3, 4)
    x = randn(4, 5, 3)
    a = jm(J.to_tensor(x))[0].numpy()
    b = jm(J.to_tensor(x), sequence_length=J.to_tensor(LENS))[0].numpy()
    np.testing.assert_array_equal(a, b)
    assert np.abs(b[1, 2:]).max() > 1e-3


# -- the RNN / BiRNN wrappers ------------------------------------------------

@pytest.mark.parametrize("cell", ["SimpleRNNCell", "LSTMCell", "GRUCell"])
@pytest.mark.parametrize("is_reverse,time_major", [(False, False),
                                                   (True, False),
                                                   (False, True)])
def test_rnn_wrapper(cell, is_reverse, time_major):
    jm, tm = twins(lambda: J.nn.RNN(getattr(J.nn, cell)(3, 4), is_reverse,
                                    time_major),
                   lambda: T.nn.RNN(getattr(T.nn, cell)(3, 4), is_reverse,
                                    time_major))
    run_both(jm, tm, [randn(5, 2, 3) if time_major else randn(2, 5, 3)])


@pytest.mark.parametrize("cell", ["LSTMCell", "GRUCell"])
def test_birnn(cell):
    jm, tm = twins(lambda: J.nn.BiRNN(getattr(J.nn, cell)(3, 4),
                                      getattr(J.nn, cell)(3, 4)),
                   lambda: T.nn.BiRNN(getattr(T.nn, cell)(3, 4),
                                      getattr(T.nn, cell)(3, 4)))
    run_both(jm, tm, [randn(2, 5, 3)])


def test_birnn_sequence_length_matches_the_layer():
    """``BiRNN`` over GRU cells with ``sequence_length`` equals ``GRU``
    (bidirectional) with the same weights and lengths."""
    bi = T.nn.BiRNN(T.nn.GRUCell(3, 4), T.nn.GRUCell(3, 4))
    gru = T.nn.GRU(3, 4, direction="bidirect")
    sd = bi.state_dict()
    for d, sfx in (("rnn_fw", "_l0"), ("rnn_bw", "_l0_reverse")):
        for n in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"):
            getattr(gru, n + sfx).set_value(sd[f"{d}.cell.{n}"].numpy())
    x = T.to_tensor(randn(4, 5, 3))
    lens = T.to_tensor(LENS)
    a, (hf, hb) = bi(x, sequence_length=lens)
    b, h = gru(x, sequence_length=lens)
    close(a.numpy(), b.numpy(), what="outputs")
    close(np.stack([hf.numpy(), hb.numpy()]), h.numpy(), what="states")


# -- fused ops ---------------------------------------------------------------

def _fused(name, arrays, **kw):
    res = []
    for P in (J, T):
        ins = [[P.to_tensor(x, stop_gradient=False) for x in a]
               if isinstance(a, list) else
               P.to_tensor(a, stop_gradient=False) for a in arrays]
        out = _leaves(getattr(P.nn.functional, name)(*ins, **kw))
        total = out[0].sum()
        for o in out[1:]:
            total = total + o.sum()
        total.backward()
        flat = [t for i in ins for t in (i if isinstance(i, list) else [i])]
        res.append(([o.numpy() for o in out], [t.grad.numpy() for t in flat]))
    (jo, jg), (to, tg) = res
    for i, (a, b) in enumerate(zip(jo, to)):
        close(b, a, what=f"{name} out {i}")
    for i, (a, b) in enumerate(zip(jg, tg)):
        close(b, a, what=f"{name} grad {i}")
    return to


@pytest.mark.parametrize("kw", [{}, {"is_reverse": True},
                                {"origin_mode": True}])
def test_fusion_gru(kw):
    out = _fused("fusion_gru", [randn(2, 5, 3), randn(3, 12), randn(4, 12),
                                randn(12), randn(2, 4)], **kw)
    assert out[0].shape == (2, 5, 4)


@pytest.mark.parametrize("kw", [{}, {"is_reverse": True}])
def test_fusion_lstm(kw):
    out = _fused("fusion_lstm", [randn(2, 5, 3), randn(3, 16), randn(4, 16),
                                 randn(16), randn(2, 4), randn(2, 4)], **kw)
    assert out[0].shape == (2, 5, 4) and out[1].shape == (2, 5, 4)


def test_fusion_rnn_shapes_without_bias_or_state():
    x = randn(2, 5, 3)
    assert _fused("fusion_gru", [x, randn(3, 12), randn(4, 12)])[0].shape == \
        (2, 5, 4)
    hs, cs = _fused("fusion_lstm", [x, randn(3, 16), randn(4, 16)])
    assert hs.shape == cs.shape == (2, 5, 4)


def test_multi_gru():
    wx = [randn(3, 12), randn(3, 12), randn(8, 12), randn(8, 12)]
    wh = [randn(4, 12) for _ in range(4)]
    out = _fused("multi_gru", [randn(2, 5, 3), wx, wh])
    assert out[0].shape == (2, 5, 8)


@pytest.mark.parametrize("origin", [False, True])
def test_gru_unit(origin):
    _fused("gru_unit", [randn(3, 12), randn(3, 4), randn(4, 12), randn(12)],
           origin_mode=origin)


def test_lstm_unit():
    _fused("lstm_unit", [randn(3, 16), randn(3, 4)], forget_bias=0.5)


def test_registration_mirrors_the_reference():
    """``fusion_*`` and ``multi_gru`` in the "fused" category; ``gru_unit``
    and ``lstm_unit`` registered by ``nn.functional``, in both packages."""
    from paddle_tpu.core.dispatch import OP_REGISTRY as JR
    from paddle_tpu_torch.core.dispatch import OP_REGISTRY as TR
    for n in ("fusion_gru", "fusion_lstm", "multi_gru", "gru_unit",
              "lstm_unit"):
        assert n in JR and n in TR, n
        assert TR[n].category == JR[n].category, n

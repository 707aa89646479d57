"""The port's weight-only int8 surface (``ops.quant.weight_quantize`` /
``weight_dequantize``, ``nn.quant.WeightOnlyLinear``,
``nn.quant.quantize_linears``) against the JAX package's, with the cases
of ``tests/test_quant_inference.py::TestNnQuant``.

Same weights in both (the port's layers loaded from the JAX layers'
``state_dict()``), same numpy inputs. ``weight_quantize`` gives the same
int8 values and scale bits; ``WeightOnlyLinear`` outputs agree within
``1e-5 * max|ref|`` (on the CPU the port runs the int8 matmul's plain
version); ``quantize_linears`` swaps the same count; a quantized BERT's
logits equal the JAX quantized BERT's within ``1e-5 * max|logit|``.
"""

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


def close(got, want, rtol=RTOL, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max(initial=0.0))
    assert err <= rtol * float(np.abs(want).max(initial=0.0)), (what, err)


def both(build, seed=0):
    J.seed(seed)
    jl = build(J)
    tl = build(T)
    tl.set_state_dict(jl.state_dict())
    return jl, tl


def x_of(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def test_weight_quantize_same_bits():
    w = x_of((64, 48), seed=3)
    w[:, 5] = 0.0                                   # a zero column
    qj, sj = J.ops.quant.weight_quantize(J.to_tensor(w))
    qt, st = T.ops.quant.weight_quantize(T.to_tensor(w))
    assert qt.numpy().dtype == np.int8 and st.numpy().dtype == np.float32
    np.testing.assert_array_equal(qt.numpy(), qj.numpy())
    np.testing.assert_array_equal(st.numpy(), sj.numpy())
    np.testing.assert_array_equal(
        T.ops.quant.weight_dequantize(qt, st).numpy(),
        J.ops.quant.weight_dequantize(qj, sj).numpy())
    with pytest.raises(ValueError):
        T.ops.quant.weight_quantize(T.to_tensor(w), algo="weight_only_int4")


class TestNnQuant:
    def test_weight_only_linear_parity(self):
        jl, tl = both(lambda p: p.nn.Linear(32, 16))
        x = x_of((4, 32))
        ref = tl(T.to_tensor(x)).numpy()
        outs = []
        for p, lin in ((J, jl), (T, tl)):
            q = p.nn.quant.WeightOnlyLinear.from_linear(lin)
            assert q.weight.numpy().dtype == np.int8
            outs.append(q(p.to_tensor(x)).numpy())
        close(outs[1], outs[0], what="WeightOnlyLinear")
        assert np.abs(outs[1] - ref).max() < 0.03 * np.abs(ref).max() + 1e-3

    def test_quantize_linears_swaps_in_place(self):
        def build(p):
            return p.nn.Sequential(p.nn.Linear(16, 32), p.nn.ReLU(),
                                   p.nn.Linear(32, 4))
        jm, tm = both(build, seed=1)
        x = x_of((3, 16), seed=1)
        ref = tm(T.to_tensor(x)).numpy()
        outs = []
        for p, m in ((J, jm), (T, tm)):
            assert p.nn.quant.quantize_linears(m) == 2
            assert isinstance(m[0], p.nn.quant.WeightOnlyLinear)
            outs.append(m(p.to_tensor(x)).numpy())
        close(outs[1], outs[0], what="quantized Sequential")
        assert np.abs(outs[1] - ref).max() < 0.05 * np.abs(ref).max() + 1e-3

    def test_nested_model_walk(self):
        def build(p):
            class Block(p.nn.Layer):
                def __init__(self):
                    super().__init__()
                    self.fc = p.nn.Linear(8, 8)

                def forward(self, x):
                    return self.fc(x)

            class Net(p.nn.Layer):
                def __init__(self):
                    super().__init__()
                    self.b1 = Block()
                    self.b2 = Block()
                    self.head = p.nn.Linear(8, 2)

                def forward(self, x):
                    return self.head(self.b2(self.b1(x)))
            return Net()
        jn, tn = both(build, seed=2)
        counts = [p.nn.quant.quantize_linears(n, min_features=4)
                  for p, n in ((J, jn), (T, tn))]
        assert counts == [3, 3]
        x = x_of((2, 8), seed=2)
        outs = [n(p.to_tensor(x)).numpy() for p, n in ((J, jn), (T, tn))]
        assert outs[1].shape == (2, 2)
        close(outs[1], outs[0], what="nested")
        assert T.nn.quant.quantize_linears(build(T), min_features=9) == 0


def test_quantized_bert_logits_match_jax():
    from paddle_tpu.models import bert as JB
    from paddle_tpu_torch.models import bert as TB
    kw = dict(vocab_size=100, hidden_size=32, num_hidden_layers=2,
              num_attention_heads=4, intermediate_size=64,
              max_position_embeddings=16, hidden_dropout_prob=0.0,
              attention_probs_dropout_prob=0.0)
    J.seed(4)
    jnet = JB.BertForSequenceClassification(JB.BertConfig(**kw))
    tnet = TB.BertForSequenceClassification(TB.BertConfig(**kw))
    tnet.set_state_dict(jnet.state_dict())
    ids = np.random.default_rng(4).integers(0, 100, (3, 12))
    mask = np.ones((3, 12), np.int64)
    mask[1, 9:] = 0
    logits = []
    for p, net in ((J, jnet), (T, tnet)):
        net.eval()
        assert p.nn.quant.quantize_linears(net) == 2 * 6 + 2
        logits.append(net(p.to_tensor(ids),
                          attention_mask=p.to_tensor(mask)).numpy())
    close(logits[1], logits[0], what="quantized BERT logits")

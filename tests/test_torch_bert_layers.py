"""The port's BERT ``Layer`` classes (``BertModel``,
``BertForSequenceClassification``, ``BertForPretraining``) against the
JAX package's, covering ``tests/test_bert.py::TestBertModel``.

Each pair is built from one ``BertConfig`` with dropout 0 (dropout masks
cannot match across frameworks) and the port's weights loaded from the
JAX model's ``state_dict()``. Logits within ``1e-5 * max|logit|``,
losses within ``1e-5 * |loss|``, every parameter's gradient within
``1e-4 * max|g|`` (``max|g|`` at least 1e-2 of the model's largest
gradient: the key biases get a gradient that is zero analytically).
Five AdamW steps of the classifier equal the JAX package's within
``1e-5 * |loss|`` a step; for that the JAX model's parameters are given
names of their own first, since the reference's deep-copied encoder
layers share their names and with them one optimizer state (ROADMAP
§C).
"""

import numpy as np
import pytest

import paddle_tpu as J
import paddle_tpu_torch as T
from paddle_tpu.models import bert as JB
from paddle_tpu_torch.models import bert as TB

FWD, GRAD = 1e-5, 1e-4
CFG = dict(vocab_size=100, hidden_size=32, num_hidden_layers=2,
           num_attention_heads=4, intermediate_size=64,
           max_position_embeddings=64, type_vocab_size=2,
           hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)


@pytest.fixture(autouse=True)
def _port_on_cpu():
    prev = T.get_device()
    T.set_device("cpu")
    yield
    T.set_device(prev)


def close(got, want, rtol, what="", floor=1e-30):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max(initial=0.0))
    assert err <= rtol * max(float(np.abs(want).max(initial=0.0)), floor), \
        f"{what}: {err}"


def twins(cls_name, seed=0, **kw):
    J.seed(seed)
    jnet = getattr(JB, cls_name)(JB.BertConfig(**CFG), **kw)
    tnet = getattr(TB, cls_name)(TB.BertConfig(**CFG), **kw)
    missing, unexpected = tnet.set_state_dict(jnet.state_dict())
    assert not missing and not unexpected
    return jnet, tnet


def ids_of(B=2, S=12, seed=0):
    return np.random.default_rng(seed).integers(0, 100, (B, S)).astype(
        np.int64)


def grads_close(jnet, tnet):
    gj = {n: q.grad.numpy() for n, q in jnet.named_parameters()
          if q.grad is not None}
    gt = {n: q.grad.numpy() for n, q in tnet.named_parameters()
          if q.grad is not None}
    assert gt.keys() == gj.keys() and gj
    floor = 1e-2 * max(float(np.abs(g).max()) for g in gj.values())
    for n in gj:
        close(gt[n], gj[n], GRAD, f"grad {n}", floor)


class TestBertModel:
    def test_forward_and_grads(self):
        jnet, tnet = twins("BertModel")
        ids = ids_of()
        tt = np.zeros_like(ids)
        tt[:, 6:] = 1
        outs = []
        for p, net in ((J, jnet), (T, tnet)):
            seq, pooled = net(p.to_tensor(ids), p.to_tensor(tt))
            assert list(seq.shape) == [2, 12, 32]
            assert list(pooled.shape) == [2, 32]
            ((seq * seq).sum() + pooled.sum()).backward()
            outs.append((seq.numpy(), pooled.numpy()))
        for a, b in zip(outs[1], outs[0]):
            close(a, b, FWD, "BertModel")
        grads_close(jnet, tnet)

    def test_attention_mask_blocks_padding(self):
        jnet, tnet = twins("BertModel", seed=1)
        ids = ids_of(seed=1)
        mask = np.ones((2, 12), np.int64)
        mask[:, 8:] = 0
        ids2 = ids.copy()
        ids2[:, 8:] = 5
        for p, net in ((J, jnet), (T, tnet)):
            net.eval()
        seqs = [[net(p.to_tensor(i), attention_mask=p.to_tensor(mask))[0]
                 .numpy() for i in (ids, ids2)]
                for p, net in ((J, jnet), (T, tnet))]
        np.testing.assert_allclose(seqs[1][0][:, :8], seqs[1][1][:, :8],
                                   atol=1e-5)
        close(seqs[1][0], seqs[0][0], FWD, "masked seq")


class TestBertForSequenceClassification:
    def test_loss_logits_grads_with_mask(self):
        jnet, tnet = twins("BertForSequenceClassification", seed=2,
                           num_classes=3)
        ids = ids_of(seed=2)
        mask = np.ones((2, 12), np.int64)
        mask[0, 9:] = 0
        labels = np.asarray([0, 2])
        outs = []
        for p, net in ((J, jnet), (T, tnet)):
            loss, logits = net(p.to_tensor(ids),
                               attention_mask=p.to_tensor(mask),
                               labels=p.to_tensor(labels))
            assert list(logits.shape) == [2, 3]
            loss.backward()
            outs.append((float(loss), logits.numpy()))
        assert abs(outs[1][0] - outs[0][0]) <= FWD * abs(outs[0][0])
        close(outs[1][1], outs[0][1], FWD, "logits")
        grads_close(jnet, tnet)

    def test_finetune_steps_match(self):
        jnet, tnet = twins("BertForSequenceClassification", seed=3,
                           num_classes=3)
        for i, q in enumerate(jnet.parameters()):
            q.name = f"bert_param_{i}"       # the reference's shared names
        ids = ids_of(seed=3)
        labels = np.asarray([0, 2])
        losses = []
        for p, net in ((J, jnet), (T, tnet)):
            opt = p.optimizer.AdamW(learning_rate=1e-3,
                                    parameters=net.parameters())
            run = []
            for _ in range(5):
                loss, _ = net(p.to_tensor(ids), labels=p.to_tensor(labels))
                loss.backward()
                opt.step()
                opt.clear_grad()
                run.append(float(loss))
            losses.append(run)
        assert losses[1][-1] < losses[1][0]
        np.testing.assert_allclose(losses[1], losses[0], rtol=FWD)


class TestBertForPretraining:
    def test_heads_loss_and_grads(self):
        jnet, tnet = twins("BertForPretraining", seed=4)
        ids = ids_of(seed=4)
        mlm = ids.copy()
        mlm[:, ::2] = -100           # only odd positions contribute
        nsp = np.asarray([0, 1])
        outs = []
        for p, net in ((J, jnet), (T, tnet)):
            mlm_logits, nsp_logits = net(p.to_tensor(ids))
            loss = net(p.to_tensor(ids), masked_lm_labels=p.to_tensor(mlm),
                       next_sentence_labels=p.to_tensor(nsp))
            loss.backward()
            outs.append((mlm_logits.numpy(), nsp_logits.numpy(),
                         float(loss)))
        close(outs[1][0], outs[0][0], FWD, "mlm logits")
        close(outs[1][1], outs[0][1], FWD, "nsp logits")
        assert abs(outs[1][2] - outs[0][2]) <= FWD * abs(outs[0][2])
        grads_close(jnet, tnet)

"""``chip_smoke.py`` phase 61's BiGRU-CRF sequence labeller
(``chip_smoke.lexical_net``: PaddleNLP's lexical-analysis network from the
public API) at narrow widths, built in both packages from the same numpy
weights (``state_dict_from_jax``).

* Three Adam steps' losses agree within 1e-5. The GRU gets no
  ``sequence_length`` there, because the reference ignores it (ROADMAP
  §C); both packages give the lengths to the CRF.
* The port's masked run (lengths to the GRU too) equals per-row runs on
  each row's own steps: emissions within 1e-5, and the batch's CRF loss
  the mean of the rows'.
* ``crf_decoding`` on the network's emissions equals brute-force
  enumeration in both packages.
"""

import itertools
import pathlib
import sys

import numpy as np
import pytest

import paddle_tpu as J
import paddle_tpu_torch as T
from paddle_tpu_torch.models.convert import state_dict_from_jax

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

W = dict(vocab=40, emb_dim=12, hidden=10, num_tags=7)
B, S = 5, 9


@pytest.fixture(autouse=True)
def _port_on_cpu():
    prev = T.get_device()
    T.set_device("cpu")
    yield
    T.set_device(prev)


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


def _twins():
    J.seed(3)
    jm = chip_smoke.lexical_net(J, **W)
    tm = chip_smoke.lexical_net(T, **W)
    tm.set_state_dict(state_dict_from_jax(jm))
    return jm, tm


def _batch(seed=0, batch=B, seq=S):
    return chip_smoke.lexical_batch(np.random.default_rng(seed), batch, seq,
                                    W["vocab"], W["num_tags"])


def test_three_adam_steps_agree_with_jax():
    jm, tm = _twins()
    losses = {}
    for p, m in ((J, jm), (T, tm)):
        opt = p.optimizer.Adam(1e-3, parameters=m.parameters())
        loss_fn = chip_smoke.lexical_loss(p)
        out = []
        for k in range(3):
            ids, tags, lens = (p.to_tensor(a) for a in _batch(k))
            loss = loss_fn(*m(ids), tags, lens)
            loss.backward()
            opt.step()
            opt.clear_grad()
            out.append(float(loss.numpy()))
        losses[p] = out
    for a, b in zip(losses[T], losses[J]):
        assert _rel(a, b) <= 1e-5, (losses[T], losses[J])


def test_gradients_agree_with_jax():
    jm, tm = _twins()
    grads = {}
    for p, m in ((J, jm), (T, tm)):
        ids, tags, lens = (p.to_tensor(a) for a in _batch(4))
        chip_smoke.lexical_loss(p)(*m(ids), tags, lens).backward()
        grads[p] = {k: v.grad.numpy() for k, v in m.named_parameters()}
    assert grads[T].keys() == grads[J].keys()
    for k, g in grads[J].items():
        err = np.abs(grads[T][k] - g).max()
        assert err <= 1e-4 * max(np.abs(g).max(), 1e-30), k


def test_masked_run_equals_per_row_runs():
    _, tm = _twins()
    ids, tags, lens = _batch(5)
    em, trans = tm(T.to_tensor(ids), T.to_tensor(lens))
    loss = chip_smoke.lexical_loss(T)(em, trans, T.to_tensor(tags),
                                      T.to_tensor(lens))
    rows = []
    for r in range(B):
        n = int(lens[r])
        em_r, _ = tm(T.to_tensor(ids[r:r + 1, :n]))
        got = em.numpy()[r, :n]
        scale = np.abs(em_r.numpy()[0]).max()
        assert np.abs(got - em_r.numpy()[0]).max() <= 1e-5 * scale, r
        rows.append(float(T.linear_chain_crf(
            em_r, trans, T.to_tensor(tags[r:r + 1, :n])).numpy()[0]))
    assert _rel(float(loss.numpy()), float(np.mean(rows))) <= 1e-5


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_crf_decoding_equals_brute_force(pkg):
    p = J if pkg == "jax" else T
    jm, tm = _twins()
    m = jm if pkg == "jax" else tm
    ids, _, _ = _batch(6, batch=2, seq=5)
    em, trans = m(p.to_tensor(ids))
    path = p.crf_decoding(em, trans).numpy()
    e, t = em.numpy(), trans.numpy()
    K = W["num_tags"]
    for r in range(2):
        def score(q):
            return (t[0, q[0]] + t[1, q[-1]]
                    + sum(e[r, i, q[i]] for i in range(5))
                    + sum(t[2 + q[i], q[i + 1]] for i in range(4)))
        best = max(itertools.product(range(K), repeat=5), key=score)
        assert path[r].tolist() == list(best)


def test_chunk_eval_of_the_decoded_paths_agrees_with_jax():
    jm, tm = _twins()
    ids, tags, lens = _batch(7)
    outs = []
    for p, m in ((J, jm), (T, tm)):
        em, trans = m(p.to_tensor(ids))
        path = p.crf_decoding(em, trans, p.to_tensor(lens))
        outs.append([float(v.numpy()) for v in p.chunk_eval(
            path, p.to_tensor(tags), num_chunk_types=3,
            seq_lens=p.to_tensor(lens))])
    assert outs[0] == outs[1]

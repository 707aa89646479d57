"""The port's deployment ``inference.Predictor`` against the JAX
package's: a network saved by each package's ``jit.save`` from the same
weights, served by each package's ``create_predictor(Config(...))``
through the input and output handles, at two batch sizes (outputs within
``1e-5``), with ``clone`` and the Config knobs.
"""

import numpy as np
import pytest

import paddle_tpu as J
import paddle_tpu_torch as T


@pytest.fixture(autouse=True)
def _port_on_cpu():
    prev = T.get_device()
    T.set_device("cpu")
    yield
    T.set_device(prev)


def _net(P):
    nn = P.nn
    return nn.Sequential(nn.Linear(6, 16), nn.GELU(), nn.LayerNorm(16),
                         nn.Linear(16, 3))


@pytest.fixture
def saved(tmp_path):
    J.seed(0)
    jn = _net(J)
    tn = _net(T)
    tn.set_state_dict({k: v.numpy() for k, v in jn.state_dict().items()})
    paths = {}
    for P, net in ((J, jn), (T, tn)):
        net.eval()
        paths[P] = str(tmp_path / P.__name__ / "net")
        P.jit.save(net, paths[P], input_spec=[
            P.jit.InputSpec([None, 6], "float32", name="features")])
    return paths, tn


def _run(P, path, x):
    pred = P.inference.create_predictor(
        P.inference.Config(path + ".pdmodel", path + ".pdiparams"))
    names = pred.get_input_names()
    h = pred.get_input_handle(names[0])
    h.reshape(x.shape)
    h.copy_from_cpu(x)
    pred.run()
    out = pred.get_output_handle(pred.get_output_names()[0])
    return names, out.copy_to_cpu(), pred


def test_predictor_matches_the_jax_package(saved):
    paths, tn = saved
    rng = np.random.default_rng(0)
    for n in (5, 2):
        x = rng.standard_normal((n, 6)).astype(np.float32)
        jnames, jout, _ = _run(J, paths[J], x)
        tnames, tout, pred = _run(T, paths[T], x)
        assert tnames == jnames == ["features"]
        np.testing.assert_allclose(tout, jout, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(tout, tn(T.to_tensor(x)).numpy(),
                                   rtol=1e-5, atol=1e-6)
        # the list form of run() returns the outputs
        np.testing.assert_allclose(pred.run([x])[0], tout, rtol=0, atol=0)


def test_clone_has_its_own_slots(saved):
    paths, _ = saved
    x = np.ones((3, 6), np.float32)
    _, out, pred = _run(T, paths[T], x)
    twin = pred.clone()
    assert twin.get_input_names() == pred.get_input_names()
    with pytest.raises(RuntimeError, match="run"):
        twin.get_output_handle("out0")
    with pytest.raises(RuntimeError, match="not set"):
        twin.run()
    twin.get_input_handle("features").copy_from_cpu(x * 2.0)
    twin.run()
    np.testing.assert_allclose(
        pred.get_output_handle("out0").copy_to_cpu(), out)


def test_config_knobs_recorded(saved):
    paths, _ = saved
    cfg = T.inference.Config(paths[T] + ".pdmodel")
    assert cfg.prog_file() == paths[T] + ".pdmodel"
    assert cfg.params_file() == paths[T] + ".pdiparams"
    cfg.disable_gpu()
    assert cfg.use_gpu() is False
    with pytest.warns(UserWarning, match="no effect"):
        cfg.enable_tensorrt_engine()
    c2 = cfg.clone()
    assert c2._records == cfg._records and c2.model_dir() == paths[T]
    x = np.zeros((2, 6), np.float32)
    pred = T.inference.create_predictor(cfg)
    assert pred.run([x])[0].shape == (2, 3)
    assert T.inference.PrecisionType.Int8 == J.inference.PrecisionType.Int8
    assert T.inference.PlaceType.GPU == J.inference.PlaceType.GPU
    assert "inference" in T.inference.get_version()
    with pytest.raises(KeyError):
        pred.get_input_handle("nope")


def _tiny_bert(P):
    import importlib
    B = importlib.import_module(P.__name__ + ".models.bert")
    cfg = B.BertConfig(vocab_size=1000, hidden_size=64, num_hidden_layers=2,
                       num_attention_heads=4, intermediate_size=128,
                       max_position_embeddings=64, hidden_dropout_prob=0.0,
                       attention_probs_dropout_prob=0.0)
    return B.BertForSequenceClassification(cfg, num_classes=2)


def test_bert_predictor_matches_the_jax_package(tmp_path):
    """``Model(inputs=...).save(training=False)`` of the same BERT in both
    packages, served by each package's Predictor at two batch sizes
    (1e-5), then the port's ``quantize_linears`` network against its eager
    int8 forward (1e-5 x max|logit|)."""
    J.seed(0)
    jn = _tiny_bert(J)
    tn = _tiny_bert(T)
    tn.set_state_dict({k: v.numpy() for k, v in jn.state_dict().items()})
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 1000, (4, 32)).astype("int64")
    paths = {}
    for P, net in ((J, jn), (T, tn)):
        net.eval()
        paths[P] = str(tmp_path / P.__name__ / "bert")
        # the JAX package's export of BERT cannot keep the batch symbolic
        # (ROADMAP section C): its artifact takes batch 4 only
        P.Model(net, inputs=[P.jit.InputSpec([4 if P is J else None, 32],
                                             "int64", "input_ids")]).save(
            paths[P], training=False)
    _, jout, _ = _run(J, paths[J], ids)
    for n in (4, 3):
        _, tout, _ = _run(T, paths[T], ids[:n])
        np.testing.assert_allclose(tout, jout[:n], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(tout, tn(T.to_tensor(ids[:n])).numpy(),
                                   rtol=1e-5, atol=1e-5)
    assert T.nn.quant.quantize_linears(tn) == 6 * 2 + 2
    want = tn(T.to_tensor(ids)).numpy()
    qpath = str(tmp_path / "int8" / "bert")
    T.Model(tn, inputs=[T.jit.InputSpec([None, 32], "int64",
                                        "input_ids")]).save(qpath,
                                                            training=False)
    for n in (4, 2):
        _, got, _ = _run(T, qpath, ids[:n])
        assert np.abs(got - want[:n]).max() <= 1e-5 * np.abs(want).max()

"""The port's ``LayerDesc`` / ``PipelineLayer`` / ``PipelineParallel``
against the JAX package, case for case with
``tests/test_pipeline.py:281-653`` (the layer list, the wrapper, and
``train_batch``'s routes: the stacked ring, the heterogeneous ring, the
opt-in eager fallback).

Both packages run dp 2 x pp 4 (JAX: its 8-device CPU mesh; the port:
``["cpu"] * 8``). Each training case builds the layer list on both,
loads the JAX weights into the port's by name, and holds
``train_batch``'s loss and the weights after the steps to JAX's
``train_batch`` and to serial gradient accumulation within 1e-5 (the
reference's tolerance; bf16 within 3e-2, the reference's), and asserts
the route the reference asserts.
"""

import numpy as np
import pytest

import paddle_tpu as J
import paddle_tpu.nn as jnn
from paddle_tpu.distributed import fleet as jfleet
from paddle_tpu.distributed import pipeline as jpp
from paddle_tpu.distributed.topology import \
    set_hybrid_communicate_group as jset

import paddle_tpu_torch as T
import paddle_tpu_torch.nn as tnn
from paddle_tpu_torch.distributed import fleet as tfleet
from paddle_tpu_torch.distributed import pipeline as tpp
from paddle_tpu_torch.distributed.topology import \
    set_hybrid_communicate_group as tset


@pytest.fixture(autouse=True)
def _port_on_cpu():
    prev = T.get_device()
    T.set_device("cpu")
    yield
    T.set_device(prev)


@pytest.fixture
def pp_mesh():
    for fl, kw in ((jfleet, {}), (tfleet, {"devices": ["cpu"] * 8})):
        st = fl.DistributedStrategy()
        st.hybrid_configs = {"dp_degree": 2, "mp_degree": 1, "pp_degree": 4}
        fl.init(is_collective=True, strategy=st, **kw)
    yield tfleet.get_hybrid_communicate_group()
    jset(None)
    tset(None)


class TestPipelineLayer:
    def test_uniform_segmentation(self, pp_mesh):
        for pp, nn in ((jpp, jnn), (tpp, tnn)):
            pl = pp.PipelineLayer(layers=[pp.LayerDesc(nn.Linear, 8, 8)
                                          for _ in range(10)], num_stages=4)
            assert pl.segment_parts == [0, 3, 6, 8, 10]
            assert sum(len(pl.get_stage_layers(s)) for s in range(4)) == 10

    def test_layer_mark_segmentation(self, pp_mesh):
        parts = []
        for pp, nn in ((jpp, jnn), (tpp, tnn)):
            descs = []
            for _ in range(4):
                descs += [pp.LayerDesc(nn.Linear, 8, 8), pp.LayerDesc(nn.ReLU)]
            pl = pp.PipelineLayer(layers=descs, num_stages=4,
                                  seg_method="layer:Linear")
            for s in range(4):
                assert type(pl.get_stage_layers(s)[0]).__name__ == "Linear"
            parts.append(pl.segment_parts)
        assert parts[0] == parts[1]

    def test_serial_forward(self, pp_mesh):
        J.seed(0)
        outs = []
        a = np.random.default_rng(0).standard_normal((2, 8)).astype("float32")
        pls = []
        for p, pp, nn in ((J, jpp, jnn), (T, tpp, tnn)):
            descs = [pp.LayerDesc(nn.Linear, 8, 8), pp.LayerDesc(nn.ReLU),
                     pp.LayerDesc(nn.Linear, 8, 4), pp.LayerDesc(nn.ReLU)]
            pls.append(pp.PipelineLayer(layers=descs, num_stages=4))
        pls[1].set_state_dict(pls[0].state_dict())
        for p, pl in zip((J, T), pls):
            y = pl(p.to_tensor(a))
            assert list(y.shape) == [2, 4]
            outs.append(y.numpy())
        np.testing.assert_allclose(outs[1], outs[0], atol=1e-6)

    def test_too_few_layers(self, pp_mesh):
        for pp, nn in ((jpp, jnn), (tpp, tnn)):
            with pytest.raises(ValueError, match="cannot split"):
                pp.PipelineLayer(layers=[pp.LayerDesc(nn.Linear, 4, 4)],
                                 num_stages=4)
        with pytest.raises(TypeError, match="Layer subclass"):
            tpp.LayerDesc(int)


class TestPipelineParallel:
    def test_distributed_model_wraps(self, pp_mesh):
        pl = tpp.PipelineLayer(layers=[tpp.LayerDesc(tnn.Linear, 8, 8)
                                       for _ in range(4)], num_stages=4,
                               loss_fn=tnn.MSELoss())
        assert isinstance(tfleet.distributed_model(pl), tpp.PipelineParallel)

    def test_requires_pipeline_layer(self, pp_mesh):
        for pp, nn in ((jpp, jnn), (tpp, tnn)):
            with pytest.raises(TypeError, match="PipelineLayer"):
                pp.PipelineParallel(nn.Linear(4, 4), pp_mesh)

    def test_train_batch_parity_vs_serial(self, pp_mesh):
        """train_batch (4 micro-batches through 4 stages) against JAX's
        train_batch and against serial gradient accumulation."""
        def make(pp, nn):
            return [pp.LayerDesc(nn.Linear, 8, 8), pp.LayerDesc(nn.Tanh),
                    pp.LayerDesc(nn.Linear, 8, 8), pp.LayerDesc(nn.Tanh)]

        J.seed(7)
        models, opts, pls = [], [], []
        for p, pp, nn, fl in ((J, jpp, jnn, jfleet), (T, tpp, tnn, tfleet)):
            st = fl.DistributedStrategy()
            st.pipeline_configs = {"accumulate_steps": 4, "micro_batch_size": 2}
            pl = pp.PipelineLayer(layers=make(pp, nn), num_stages=4,
                                  loss_fn=nn.MSELoss())
            pls.append(pl)
            models.append(pp.PipelineParallel(
                pl, fl.get_hybrid_communicate_group(), st))
        pls[1].set_state_dict(pls[0].state_dict())
        serial = tnn.Sequential(tnn.Linear(8, 8), tnn.Tanh(),
                                tnn.Linear(8, 8), tnn.Tanh())
        serial.set_state_dict(dict(zip(serial.state_dict().keys(),
                                       [v.numpy() for v in
                                        pls[1].state_dict().values()])))
        for p, m in zip((J, T), models):
            opts.append(p.optimizer.SGD(learning_rate=0.1,
                                        parameters=m.parameters()))
        opt_s = T.optimizer.SGD(learning_rate=0.1,
                                parameters=serial.parameters())
        mse = tnn.MSELoss()
        rng = np.random.RandomState(5)
        for _ in range(2):
            xb = rng.randn(8, 8).astype("float32")
            yb = rng.randn(8, 8).astype("float32")
            losses = [float(m.train_batch((p.to_tensor(xb), p.to_tensor(yb)),
                                          o))
                      for p, m, o in zip((J, T), models, opts)]
            assert models[1].last_path == "compiled-hetero"
            total = 0.0
            for k in range(4):
                loss = mse(serial(T.to_tensor(xb[k * 2:(k + 1) * 2])),
                           T.to_tensor(yb[k * 2:(k + 1) * 2]))
                (loss / 4).backward()
                total += float(loss)
            opt_s.step()
            opt_s.clear_grad()
            np.testing.assert_allclose(losses[1], losses[0], atol=1e-5)
            np.testing.assert_allclose(losses[1], total / 4, atol=1e-5)
        for (k1, v1), (k2, v2), (k3, v3) in zip(
                pls[1].state_dict().items(), serial.state_dict().items(),
                pls[0].state_dict().items()):
            np.testing.assert_allclose(v1.numpy(), v2.numpy(), atol=1e-5)
            np.testing.assert_allclose(v1.numpy(), np.asarray(v3.numpy()),
                                       atol=1e-5)
        # eval_batch: the loss of the trained model on one batch
        xb = rng.randn(8, 8).astype("float32")
        yb = rng.randn(8, 8).astype("float32")
        ev = [float(m.eval_batch((p.to_tensor(xb), p.to_tensor(yb))))
              for p, m in zip((J, T), models)]
        np.testing.assert_allclose(ev[1], ev[0], atol=1e-5)

    def test_fleet_no_ghost_import(self, pp_mesh):
        pl = tpp.PipelineLayer(layers=[tpp.LayerDesc(tnn.Linear, 8, 8)
                                       for _ in range(4)], num_stages=4,
                               loss_fn=tnn.MSELoss())
        assert tfleet.distributed_model(pl) is not None
        from paddle_tpu_torch.distributed.fleet import meta_parallel
        assert meta_parallel.PipelineParallel is tpp.PipelineParallel
        assert meta_parallel.LayerDesc is tpp.LayerDesc

    def test_shared_layer_and_recompute_interval(self, pp_mesh):
        """A SharedLayerDesc key builds one layer for both stages (its
        weight gets both stages' gradients); recompute_interval gives the
        same loss and gradients."""
        def make(pp, nn, interval):
            descs = [pp.SharedLayerDesc("tied", nn.Linear, 8, 8),
                     pp.LayerDesc(nn.Tanh), pp.LayerDesc(nn.Linear, 8, 8),
                     pp.SharedLayerDesc("tied", nn.Linear, 8, 8)]
            return pp.PipelineLayer(layers=descs, num_stages=4,
                                    loss_fn=nn.MSELoss(),
                                    recompute_interval=interval)

        J.seed(4)
        jpl = make(jpp, jnn, 0)
        a = np.random.RandomState(1).randn(4, 8).astype("float32")
        grads = []
        for p, pl in ((J, jpl), (T, make(tpp, tnn, 0)), (T, make(tpp, tnn, 1))):
            if pl is not jpl:
                pl.set_state_dict(jpl.state_dict())
            assert pl._layers_list[0] is pl._layers_list[3]
            y = pl(p.to_tensor(a))
            (y ** 2).mean().backward()
            grads.append([q.grad.numpy() for q in pl.parameters()])
        for g in grads[1:]:
            for a_, b_ in zip(g, grads[0]):
                np.testing.assert_allclose(a_, np.asarray(b_), atol=1e-5)


class _JBlock(jnn.Layer):
    def __init__(self, h):
        super().__init__()
        self.fc = jnn.Linear(h, h)

    def forward(self, x):
        return J.tanh(self.fc(x))


class _TBlock(tnn.Layer):
    def __init__(self, h):
        super().__init__()
        self.fc = tnn.Linear(h, h)

    def forward(self, x):
        return T.tanh(self.fc(x))


def _twins(make, seed, cfg):
    """``make(pp, nn, block)`` on both packages into PipelineParallels with
    ``cfg`` as pipeline_configs, the port's weights set from JAX's."""
    J.seed(seed)
    out = []
    for p, pp, nn, fl, blk in ((J, jpp, jnn, jfleet, _JBlock),
                               (T, tpp, tnn, tfleet, _TBlock)):
        st = fl.DistributedStrategy()
        st.pipeline_configs = dict(cfg)
        pl = pp.PipelineLayer(layers=make(pp, nn, blk), num_stages=4,
                              loss_fn=nn.MSELoss())
        out.append((pl, pp.PipelineParallel(
            pl, fl.get_hybrid_communicate_group(), st)))
    out[1][0].set_state_dict({k: np.asarray(v.numpy()) for k, v in
                              out[0][0].state_dict().items()})
    return out


def _run_parity(pairs, serial_layers, ser_params, steps, rng, in_w, out_w,
                path, tol=1e-5, dtype="float32"):
    (jpl, jm), (tpl, tm) = pairs
    opts = [J.optimizer.SGD(learning_rate=0.1, parameters=jm.parameters()),
            T.optimizer.SGD(learning_rate=0.1, parameters=tm.parameters())]
    opt_s = T.optimizer.SGD(learning_rate=0.1, parameters=ser_params)
    mse = tnn.MSELoss()
    for _ in range(steps):
        xb = rng.randn(8, in_w).astype("float32")
        yb = rng.randn(8, out_w).astype("float32")
        lj = float(jm.train_batch((J.to_tensor(xb), J.to_tensor(yb)), opts[0]))
        lt = float(tm.train_batch((T.to_tensor(xb), T.to_tensor(yb)), opts[1]))
        assert tm.last_path == path, tm.last_path
        total = 0.0
        for m in range(4):
            h = T.to_tensor(xb[m * 2:(m + 1) * 2])
            for l in serial_layers:
                h = l(h)
            loss = mse(h, T.to_tensor(yb[m * 2:(m + 1) * 2]))
            (loss / 4).backward()
            total += float(loss)
        opt_s.step()
        opt_s.clear_grad()
        np.testing.assert_allclose(lt, lj, atol=tol, rtol=tol)
        np.testing.assert_allclose(lt, total / 4, atol=tol, rtol=tol)
    for a, b, c in zip(tpl.parameters(), ser_params, jpl.parameters()):
        assert str(a.dtype) == str(b.dtype)
        np.testing.assert_allclose(a.numpy().astype("float32"),
                                   b.numpy().astype("float32"), atol=tol,
                                   rtol=tol)
        np.testing.assert_allclose(a.numpy().astype("float32"),
                                   np.asarray(c.numpy()).astype("float32"),
                                   atol=tol, rtol=tol)


def _serial_from(pl, make_serial):
    layers = make_serial()
    params = [p for l in layers for p in l.parameters()]
    for ps, pp_ in zip(params, pl.parameters()):
        ps.set_value(pp_.numpy() if str(pp_.dtype) != "torch.bfloat16"
                     else pp_._value)
    return layers, params


class TestCompiledTrainBatch:
    def test_compiled_parity_vs_serial(self, pp_mesh):
        """Interleaved (virtual_pp_degree 2) with a prologue and an
        epilogue: the stacked route; loss and weights as serial
        accumulation's and JAX's."""
        def make(pp, nn, blk):
            return ([pp.LayerDesc(nn.Linear, 8, 8)] +
                    [pp.LayerDesc(blk, 8) for _ in range(8)] +
                    [pp.LayerDesc(nn.Linear, 8, 4)])

        pairs = _twins(make, 7, {"accumulate_steps": 4,
                                 "micro_batch_size": 2,
                                 "virtual_pp_degree": 2})
        layers, params = _serial_from(pairs[1][0], lambda: [
            tnn.Linear(8, 8)] + [_TBlock(8) for _ in range(8)] +
            [tnn.Linear(8, 4)])
        import warnings as w
        with w.catch_warnings():
            w.simplefilter("error")         # the ring route does not warn
            _run_parity(pairs, layers, params, 2, np.random.RandomState(5),
                        8, 4, "compiled")
        assert pairs[1][1]._compiled_step is not None

    @staticmethod
    def _unstable(pp, nn, blk):
        # boundary widths 8 -> 6 -> 5 -> 4: no stackable run, no
        # shape-stable run of 4 layers
        return [pp.LayerDesc(nn.Linear, 8, 6), pp.LayerDesc(nn.Tanh),
                pp.LayerDesc(nn.Linear, 6, 5), pp.LayerDesc(nn.Linear, 5, 4)]

    def test_uncompilable_model_raises_without_optin(self, pp_mesh):
        pairs = _twins(self._unstable, 3, {"accumulate_steps": 2,
                                           "micro_batch_size": 2})
        xb, yb = np.random.randn(4, 8).astype("float32"), \
            np.random.randn(4, 4).astype("float32")
        for p, (_, m) in zip((J, T), pairs):
            opt = p.optimizer.SGD(learning_rate=0.01,
                                  parameters=m.parameters())
            with pytest.raises(RuntimeError, match="allow_eager_fallback"):
                m.train_batch((p.to_tensor(xb), p.to_tensor(yb)), opt)

    def test_fallback_warns_once_when_opted_in(self, pp_mesh):
        pairs = _twins(self._unstable, 3, {"accumulate_steps": 2,
                                           "micro_batch_size": 2,
                                           "allow_eager_fallback": True})
        xb, yb = np.random.randn(4, 8).astype("float32"), \
            np.random.randn(4, 4).astype("float32")
        losses = []
        for p, (_, m) in zip((J, T), pairs):
            opt = p.optimizer.SGD(learning_rate=0.01,
                                  parameters=m.parameters())
            with pytest.warns(UserWarning, match="no stackable block run"):
                m.train_batch((p.to_tensor(xb), p.to_tensor(yb)), opt)
            assert m._compiled_step is None and m.last_path == "eager"
            import warnings as w
            with w.catch_warnings():
                w.simplefilter("error")     # attempted once: no warning now
                losses.append(float(m.train_batch(
                    (p.to_tensor(xb), p.to_tensor(yb)), opt)))
        np.testing.assert_allclose(losses[1], losses[0], atol=1e-5)


def _hetero(pp, nn, blk):
    return [pp.LayerDesc(nn.Linear, 8, 8), pp.LayerDesc(nn.Tanh),
            pp.LayerDesc(nn.Linear, 8, 3), pp.LayerDesc(nn.Linear, 3, 8),
            pp.LayerDesc(nn.GELU), pp.LayerDesc(nn.Linear, 8, 8),
            pp.LayerDesc(nn.ReLU), pp.LayerDesc(nn.Linear, 8, 8)]


def _hetero_serial():
    return [tnn.Linear(8, 8), tnn.Tanh(), tnn.Linear(8, 3), tnn.Linear(3, 8),
            tnn.GELU(), tnn.Linear(8, 8), tnn.ReLU(), tnn.Linear(8, 8)]


class TestHeteroCompiledPipeline:
    def test_genuinely_heterogeneous_stages_parity(self, pp_mesh):
        pairs = _twins(_hetero, 11, {"accumulate_steps": 4,
                                     "micro_batch_size": 2})
        layers, params = _serial_from(pairs[1][0], _hetero_serial)
        _run_parity(pairs, layers, params, 2, np.random.RandomState(6), 8,
                    8, "compiled-hetero")

    def test_bf16_model_compiles_in_bf16_and_matches_eager(self, pp_mesh):
        """A bf16 model's packed stages stay bf16 (the flat pack keeps the
        parameter dtype)."""
        pairs = _twins(_hetero, 21, {"accumulate_steps": 4,
                                     "micro_batch_size": 2})
        for pl, _ in pairs:
            pl.bfloat16()
        layers, params = _serial_from(pairs[1][0], lambda: [
            l.bfloat16() or l for l in _hetero_serial()])
        _run_parity(pairs, layers, params, 2, np.random.RandomState(9), 8,
                    8, "compiled-hetero", tol=3e-2)
        import torch
        assert pairs[1][1]._compiled_step["stack"]().dtype == torch.bfloat16

    def test_mixed_dtype_stages_fall_back_with_reason(self, pp_mesh):
        pairs = _twins(_hetero, 23, {"accumulate_steps": 4,
                                     "micro_batch_size": 2,
                                     "allow_eager_fallback": True})
        xb, yb = np.random.randn(8, 8).astype("float32"), \
            np.random.randn(8, 8).astype("float32")
        for p, (pl, m) in zip((J, T), pairs):
            pl._layers_list[5].bfloat16()   # one interior layer off-dtype
            opt = p.optimizer.SGD(learning_rate=0.05,
                                  parameters=m.parameters())
            with pytest.warns(UserWarning,
                              match="mixed stage parameter dtypes"):
                loss = m.train_batch((p.to_tensor(xb), p.to_tensor(yb)), opt)
            assert m.last_path == "eager"
            assert np.isfinite(float(loss))

    def test_prologue_epilogue_split_off_shape_changes(self, pp_mesh):
        def make(pp, nn, blk):
            return [pp.LayerDesc(nn.Linear, 4, 16),                 # prologue
                    pp.LayerDesc(nn.Linear, 16, 16), pp.LayerDesc(nn.Tanh),
                    pp.LayerDesc(nn.Linear, 16, 16), pp.LayerDesc(nn.GELU),
                    pp.LayerDesc(nn.Linear, 16, 16), pp.LayerDesc(nn.ReLU),
                    pp.LayerDesc(nn.Linear, 16, 16),
                    pp.LayerDesc(nn.Linear, 16, 2)]                 # epilogue

        pairs = _twins(make, 12, {"accumulate_steps": 4,
                                  "micro_batch_size": 2})
        xb, yb = np.random.randn(8, 4).astype("float32"), \
            np.random.randn(8, 2).astype("float32")
        curves = []
        for p, (_, m) in zip((J, T), pairs):
            opt = p.optimizer.SGD(learning_rate=0.05,
                                  parameters=m.parameters())
            curve = [float(m.train_batch((p.to_tensor(xb), p.to_tensor(yb)),
                                         opt)) for _ in range(11)]
            assert m.last_path == "compiled-hetero"
            assert curve[-1] < curve[0]
            curves.append(curve)
        np.testing.assert_allclose(curves[1], curves[0], atol=1e-5, rtol=1e-5)

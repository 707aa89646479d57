"""The port's eager distributed API against the JAX package: the
auto-parallel layouts (``ProcessMesh``, ``shard_tensor``, ``reshard``),
the fleet topology, ``DataParallel``, the ZeRO stages
(``group_sharded_parallel``) and ``fleet.distributed_model`` /
``distributed_optimizer``, case for case with
``tests/test_distributed.py:71-190``.

The JAX package runs on its 8-device CPU mesh, the port over
``["cpu"] * 8``. The training cases start both packages' MLPs from the
JAX model's weights and feed the same numpy batches; each loss
trajectory is held to the JAX package's and to the port's serial run
within ``rtol=2e-4, atol=1e-6`` (the reference's tolerance), and the
layouts are compared shard shape for shard shape.
"""

import numpy as np
import pytest

import paddle_tpu as J
import paddle_tpu.distributed as jdist
import paddle_tpu.nn as jnn
from paddle_tpu.distributed import fleet as jfleet

import paddle_tpu_torch as T
import paddle_tpu_torch.distributed as tdist
import paddle_tpu_torch.nn as tnn
from paddle_tpu_torch.distributed import fleet as tfleet

CPU8 = ["cpu"] * 8
TRAJ = dict(rtol=2e-4, atol=1e-6)


@pytest.fixture(autouse=True)
def _reset():
    prev = T.get_device()
    T.set_device("cpu")
    yield
    T.set_device(prev)
    jdist.set_hybrid_communicate_group(None)
    tdist.set_hybrid_communicate_group(None)


def both_init(**degrees):
    for fl, kw in ((jfleet, {}), (tfleet, {"devices": CPU8})):
        st = fl.DistributedStrategy()
        st.hybrid_configs = {"dp_degree": 1, "mp_degree": 1, "pp_degree": 1,
                             "sharding_degree": 1, "sep_degree": 1, **degrees}
        fl.init(is_collective=True, strategy=st, **kw)


def local_shapes(t):
    return {tuple(v.shape) for v in t.locals.values()}


class TestShardTensor:
    def test_shard_and_layout(self):
        a = np.random.default_rng(0).random((8, 6)).astype(np.float32)
        jm = jdist.ProcessMesh(np.arange(8).reshape(4, 2), ["x", "y"])
        tm = tdist.ProcessMesh(np.arange(8).reshape(4, 2), ["x", "y"])
        jw = jdist.shard_tensor(J.to_tensor(a), jm,
                                [jdist.Shard(0), jdist.Replicate()])
        tw = tdist.shard_tensor(T.to_tensor(a), tm,
                                [tdist.Shard(0), tdist.Replicate()])
        want = {tuple(s.data.shape) for s in jw._value.addressable_shards}
        assert local_shapes(tw) == want == {(2, 6)}
        assert len(tw.locals) == 8
        np.testing.assert_array_equal(tw.numpy(), a)
        np.testing.assert_array_equal(tw.numpy(), np.asarray(jw._value))

    def test_reshard(self):
        a = np.random.default_rng(1).random((8, 8)).astype(np.float32)
        outs = []
        for d, p in ((jdist, J), (tdist, T)):
            mesh = d.ProcessMesh(np.arange(8).reshape(4, 2), ["x", "y"])
            sw = d.shard_tensor(p.to_tensor(a), mesh, [d.Shard(0), d.Shard(1)])
            outs.append((sw, d.reshard(sw, mesh, [d.Replicate(), d.Shard(0)])))
        (jsw, jrw), (tsw, trw) = outs
        assert local_shapes(tsw) == {(2, 4)}
        want = {tuple(s.data.shape) for s in jrw._value.addressable_shards}
        assert local_shapes(trw) == want == {(4, 8)}
        np.testing.assert_array_equal(trw.numpy(), a)

    def test_computation_on_dist_tensors(self):
        r = np.random.default_rng(2)
        a, b = r.random((16, 4)).astype(np.float32), \
            r.random((4, 3)).astype(np.float32)
        outs = []
        for d, p in ((jdist, J), (tdist, T)):
            mesh = d.ProcessMesh(np.arange(8), ["x"])
            da = d.shard_tensor(p.to_tensor(a), mesh, [d.Shard(0)])
            db = d.shard_tensor(p.to_tensor(b), mesh, [d.Replicate()])
            out = p.matmul(da, db)
            assert out.shape == [16, 3]
            outs.append(out.numpy())
        np.testing.assert_allclose(outs[1], outs[0], rtol=1e-5)
        np.testing.assert_allclose(outs[1], a @ b, rtol=1e-5)

    def test_partial_refused_and_parameter_kept(self):
        mesh = tdist.ProcessMesh(np.arange(8), ["x"])
        with pytest.raises(ValueError, match="Partial"):
            tdist.shard_tensor(T.ones([8]), mesh, [tdist.Partial()])
        lin = tnn.Linear(8, 4)
        p = tdist.shard_tensor(lin.weight, mesh, [tdist.Shard(0)])
        assert isinstance(p, T.Parameter) and p.name == lin.weight.name
        assert not p.stop_gradient and local_shapes(p) == {(1, 4)}
        layer = tdist.shard_layer(tnn.Linear(4, 4), mesh)
        assert all(isinstance(q, tdist.DistParameter)
                   for q in layer.parameters())


class TestFleetTopology:
    def test_hybrid_mesh(self):
        both_init(dp_degree=2, mp_degree=2, sharding_degree=2)
        for fl in (jfleet, tfleet):
            hcg = fl.get_hybrid_communicate_group()
            assert hcg.get_data_parallel_world_size() == 2
            assert hcg.get_model_parallel_world_size() == 2
            assert hcg.get_sharding_parallel_world_size() == 2
            assert hcg.mesh.shape["dp"] == 2 and hcg.mesh.shape["mp"] == 2

    def test_wrong_degrees_raise(self):
        for fl, kw in ((jfleet, {}), (tfleet, {"devices": CPU8})):
            st = fl.DistributedStrategy()
            st.hybrid_configs = {"dp_degree": 3, "mp_degree": 1,
                                 "pp_degree": 1, "sharding_degree": 1,
                                 "sep_degree": 1}
            with pytest.raises(ValueError):
                fl.init(strategy=st, **kw)


def _mlp(nn):
    return nn.Sequential(nn.Linear(8, 16), nn.Tanh(), nn.Linear(16, 1))


def _train(p, nn, sd, steps=6, wrap=None, shard_level=None, lr=0.1,
           batch=16, fleet_wrap=False):
    rng = np.random.RandomState(5)
    X = rng.rand(batch, 8).astype(np.float32)
    Y = rng.rand(batch, 1).astype(np.float32)
    model = _mlp(nn)
    model.set_state_dict(sd)
    opt = p.optimizer.Adam(learning_rate=lr, parameters=model.parameters())
    if shard_level:
        model, opt, _ = p.distributed.group_sharded_parallel(model, opt,
                                                             shard_level)
    if wrap:
        model = wrap(model)
    if fleet_wrap:
        fl = p.distributed.fleet
        model, opt = fl.distributed_model(model), fl.distributed_optimizer(opt)
    losses = []
    for _ in range(steps):
        loss = nn.functional.mse_loss(model(p.to_tensor(X)), p.to_tensor(Y))
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.numpy()))
    return losses, model, opt


def _weights():
    J.seed(123)
    return {k: v.numpy() for k, v in _mlp(jnn).state_dict().items()}


class TestDataParallelParity:
    def test_dp_loss_matches_serial(self):
        sd = _weights()
        jfleet.init(is_collective=True)                    # dp 8
        tfleet.init(is_collective=True, devices=CPU8)
        serial = _train(T, tnn, sd)[0]
        jdp = _train(J, jnn, sd, wrap=jdist.DataParallel)[0]
        tdp, model, _ = _train(T, tnn, sd, wrap=tdist.DataParallel)
        np.testing.assert_allclose(tdp, serial, **TRAJ)
        np.testing.assert_allclose(tdp, jdp, **TRAJ)
        assert tdp[-1] < tdp[0]
        # eight replicas, still bit-equal after six steps
        for q in model.parameters():
            vals = list(q.locals.values())
            assert len(vals) == 8
            for v in vals[1:]:
                assert bool((v == vals[0]).all())

    def test_indivisible_batch_warns_and_replicates(self):
        tfleet.init(is_collective=True, devices=CPU8)
        m = tdist.DataParallel(_mlp(tnn))
        with pytest.warns(RuntimeWarning, match="not divisible"):
            y = m(T.ones([3, 8]))
        assert y.shape == [3, 1]
        assert m.scale_loss(y) is y


def _llama_batch(vocab, B=8, S=8):
    """Ids and shifted labels with -100 spread unevenly over the rows
    (one row per dp piece at dp 8: 0 to 7 masked tokens a row)."""
    r = np.random.default_rng(11)
    ids = r.integers(0, vocab, (B, S)).astype(np.int32)
    lbl = r.integers(0, vocab, (B, S)).astype(np.int32)
    for b in range(B):
        lbl[b, :(b * 3) % S] = -100
    return ids, lbl


class TestDataParallelModelLoss:
    """A model that reduces its own loss (``LlamaForCausalLM``: the mean
    over the tokens whose label is not -100, plus the MoE aux loss) under
    ``DataParallel`` at dp 8: the loss and every gradient equal JAX's
    ``DataParallel`` (one call on the dp-sharded batch) within 1e-5
    relative and 1e-4 x max|g|, and the port's unwrapped model."""

    @pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
    def test_llama_loss_over_the_whole_batch(self, moe):
        import jax
        from paddle_tpu.models import llama as JL
        from paddle_tpu_torch.models import llama as TL
        from paddle_tpu_torch.models.convert import config_from_jax
        kw = dict(moe_num_experts=4, moe_top_k=2) if moe else {}
        cfg = JL.LlamaConfig(vocab_size=97, hidden_size=32,
                             intermediate_size=64, num_hidden_layers=2,
                             num_attention_heads=4, num_key_value_heads=2,
                             max_position_embeddings=64, **kw)
        ids, lbl = _llama_batch(cfg.vocab_size)
        jfleet.init(is_collective=True)                    # dp 8
        tfleet.init(is_collective=True, devices=CPU8)
        jnet = JL.LlamaForCausalLM(cfg, key=jax.random.PRNGKey(0))
        nets = [TL.LlamaForCausalLM(config_from_jax(cfg)) for _ in range(2)]
        for net in nets:
            net.set_state_dict(jnet.state_dict())
        jl = jdist.DataParallel(jnet)(J.to_tensor(ids), J.to_tensor(lbl))
        jl.backward()
        got = []
        for model, net in ((tdist.DataParallel(nets[0]), nets[0]),
                           (nets[1], nets[1])):
            loss = model(T.to_tensor(ids), T.to_tensor(lbl))
            loss.backward()
            got.append((float(loss.numpy()),
                        [np.asarray(p.grad.numpy()) for p in net.parameters()]))
        want = float(jl.numpy())
        jgrads = [np.asarray(p.grad.numpy()) for p in jnet.parameters()]
        for loss, grads in got:
            assert abs(loss - want) <= 1e-5 * abs(want), (loss, want)
            for g, w in zip(grads, jgrads):
                assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max()


class TestGroupSharded:
    def test_stage1_parity_and_layout(self):
        sd = _weights()
        both_init(sharding_degree=8)
        serial = _train(T, tnn, sd)[0]
        jsh = _train(J, jnn, sd, shard_level="os")[0]
        tsh, _, opt = _train(T, tnn, sd, shard_level="os")
        np.testing.assert_allclose(tsh, serial, **TRAJ)
        np.testing.assert_allclose(tsh, jsh, **TRAJ)

    def test_stage3_parity(self):
        sd = _weights()
        both_init(sharding_degree=8)
        serial = _train(T, tnn, sd)[0]
        jsh = _train(J, jnn, sd, shard_level="p_g_os")[0]
        tsh, model, _ = _train(T, tnn, sd, shard_level="p_g_os")
        np.testing.assert_allclose(tsh, serial, **TRAJ)
        np.testing.assert_allclose(tsh, jsh, **TRAJ)
        # parameters live cut over sharding: [8, 16] -> (1, 16) a coordinate
        assert local_shapes(model[0].weight) == {(1, 16)}

    def test_stage1_states_are_sharded(self):
        both_init(sharding_degree=8)
        shapes = []
        for p, nn, d in ((J, jnn, jdist), (T, tnn, tdist)):
            p.seed(0)
            model = nn.Linear(16, 16)
            opt = p.optimizer.Adam(parameters=model.parameters())
            d.group_sharded_parallel(model, opt, "os")
            x = p.to_tensor(np.random.default_rng(3).random((4, 16))
                            .astype(np.float32))
            nn.functional.mse_loss(model(x), p.to_tensor(
                np.zeros((4, 16), np.float32))).backward()
            opt.step()
            m = opt._accumulators["moment1"][model.weight.name]
            shapes.append(m)
        want = {tuple(s.data.shape) for s in shapes[0]._raw.addressable_shards}
        assert local_shapes(shapes[1]) == want == {(2, 16)}

    def test_unknown_level_refused(self):
        both_init(sharding_degree=8)
        m = tnn.Linear(4, 4)
        opt = T.optimizer.Adam(parameters=m.parameters())
        with pytest.raises(ValueError, match="unknown group_sharded level"):
            tdist.group_sharded_parallel(m, opt, "bogus")


class TestFleetWrappers:
    def test_distributed_model_and_optimizer_dp_sharding(self):
        """dp 4 x sharding 2: distributed_model gives DataParallel,
        distributed_optimizer the stage-1 state layout; the trajectory is
        the serial one and JAX's."""
        sd = _weights()
        both_init(dp_degree=4, sharding_degree=2)
        serial = _train(T, tnn, sd)[0]
        jl = _train(J, jnn, sd, fleet_wrap=True)[0]
        tl, model, opt = _train(T, tnn, sd, fleet_wrap=True)
        assert isinstance(model, tdist.DataParallel)
        np.testing.assert_allclose(tl, serial, **TRAJ)
        np.testing.assert_allclose(tl, jl, **TRAJ)
        w = model.parameters()[0]                  # [8, 16], replicated
        assert local_shapes(opt._accumulators["moment1"][w.name]) == {(4, 16)}
        vals = list(w.locals.values())
        assert all(bool((v == vals[0]).all()) for v in vals[1:])

    def test_distributed_model_mp_is_the_model(self):
        both_init(mp_degree=8)
        m = tnn.Linear(4, 4)
        assert tfleet.distributed_model(m) is m
        opt = T.optimizer.SGD(parameters=m.parameters())
        assert tfleet.distributed_optimizer(opt) is opt
        assert not hasattr(opt, "_sharding_axis")

    def test_state_dict_round_trip_through_io(self, tmp_path):
        """An mp layer's state dict is its full logical weight: saved by the
        port, loaded by JAX and back."""
        from paddle_tpu_torch.distributed.fleet.layers.mpu import \
            ColumnParallelLinear
        both_init(mp_degree=4, dp_degree=2)
        T.seed(0)
        col = ColumnParallelLinear(8, 16)
        path = str(tmp_path / "col.pdparams")
        T.save(col.state_dict(), path)
        loaded = J.load(path)
        np.testing.assert_array_equal(np.asarray(loaded["weight"]),
                                      col.weight.numpy())
        jcol = jnn.Linear(8, 16)
        jcol.set_state_dict(loaded)
        J.save(jcol.state_dict(), str(tmp_path / "j.pdparams"))
        col2 = ColumnParallelLinear(8, 16)
        col2.set_state_dict(T.load(str(tmp_path / "j.pdparams"), device="cpu"))
        np.testing.assert_array_equal(col2.weight.numpy(), col.weight.numpy())
        assert local_shapes(col2.weight) == {(8, 4)}

"""The port's eager ``MoELayer`` and gates against the JAX package, case
for case with ``tests/test_moe.py`` and ``tests/test_surface.py``'s
``TestMoE``.

Both packages build the same experts (the JAX experts' weights loaded
into the port's by name) and the port's gate takes the JAX gate's weight;
the ep cases run on dp 2 x ep 4 (JAX: its 8-device CPU mesh; the port:
``["cpu"] * 8``). Outputs and aux losses within 1e-5 / 1e-6 absolute
(the reference's tolerances), gradients within 1e-5 x max|g|; dropped
tokens exactly zero.
"""

import numpy as np
import pytest

import paddle_tpu as J
import paddle_tpu.nn as jnn
from paddle_tpu.distributed import moe as jmoe
from paddle_tpu.distributed.topology import (
    HybridCommunicateGroup as JHCG,
    set_hybrid_communicate_group as jset)

import paddle_tpu_torch as T
import paddle_tpu_torch.nn as tnn
from paddle_tpu_torch.distributed import moe as tmoe
from paddle_tpu_torch.distributed.dist_tensor import DistParameter
from paddle_tpu_torch.distributed.topology import (
    HybridCommunicateGroup as THCG,
    set_hybrid_communicate_group as tset)


@pytest.fixture(autouse=True)
def _port_on_cpu():
    prev = T.get_device()
    T.set_device("cpu")
    yield
    T.set_device(prev)
    jset(None)
    tset(None)


@pytest.fixture
def ep_mesh():
    jset(JHCG(dp=2, ep=4))
    hcg = THCG(dp=2, ep=4, devices=["cpu"] * 8)
    tset(hcg)
    yield hcg


def _experts(p, nn, d, n):
    return [nn.Sequential(nn.Linear(d, 2 * d), nn.GELU(), nn.Linear(2 * d, d))
            for _ in range(n)]


def twin_experts(make, seed):
    """The JAX experts from ``seed`` and port experts with their weights."""
    J.seed(seed)
    je = make(J, jnn)
    te = make(T, tnn)
    for a, b in zip(je, te):
        b.set_state_dict(a.state_dict())
    return je, te


def twin_moe(make, seed, gate, moe_group=None):
    je, te = twin_experts(make, seed)
    jm = jmoe.MoELayer(d_model=je[0].parameters()[0].shape[0], experts=je,
                       gate=dict(gate) if isinstance(gate, dict) else gate,
                       moe_group=moe_group)
    tm = tmoe.MoELayer(d_model=te[0].parameters()[0].shape[0], experts=te,
                       gate=dict(gate) if isinstance(gate, dict) else gate,
                       moe_group=moe_group)
    tm.gate.weight.set_value(jm.gate.weight.numpy())
    return jm, tm, je, te


def close(a, b, atol=1e-5):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol, rtol=0)


def x_of(p, a, sg=True):
    return p.to_tensor(a, stop_gradient=sg)


class TestExpertParallel:
    def test_ep4_parity_vs_replicated(self, ep_mesh):
        d = 8
        a = np.random.RandomState(0).randn(2, 8, d).astype("float32")
        mk = lambda p, nn: _experts(p, nn, d, 4)   # noqa: E731
        gate = {"type": "gshard", "capacity_factor": 4.0}
        jm, tm, _, _ = twin_moe(mk, 3, gate, moe_group="ep")
        _, trep, _, _ = twin_moe(mk, 3, gate, moe_group=None)
        trep.gate.weight.set_value(jm.gate.weight.numpy())
        y = tm(x_of(T, a)).numpy()
        close(y, jm(x_of(J, a)).numpy())
        close(y, trep(x_of(T, a)).numpy())
        close(float(tm.aux_loss), float(jm.aux_loss), 1e-6)
        close(float(tm.aux_loss), float(trep.aux_loss), 1e-6)

    def test_expert_weights_sharded_per_device(self, ep_mesh):
        d = 8
        moe = tmoe.MoELayer(d_model=d, experts=_experts(T, tnn, d, 4),
                            moe_group="ep")
        assert moe._stacked is not None
        for p in moe._stacked:
            assert isinstance(p, DistParameter)
            assert p.spec[0] == "ep"
            for c, v in p.locals.items():         # E/ep = 1 expert each
                assert v.shape[0] * 4 == p.shape[0]
                assert v.numel() * 4 == int(np.prod(p.shape))

    def test_sharding_survives_training_step(self, ep_mesh):
        d = 8
        a = np.random.RandomState(1).randn(2, 8, d).astype("float32")
        mk = lambda p, nn: _experts(p, nn, d, 4)   # noqa: E731
        jm, tm, _, _ = twin_moe(mk, 2, None, moe_group="ep")
        losses = []
        for p, m in ((J, jm), (T, tm)):
            opt = p.optimizer.SGD(learning_rate=0.05, parameters=m.parameters())
            rec = []
            for _ in range(5):
                y = m(x_of(p, a))
                loss = (y ** 2).mean() + 0.01 * m.aux_loss
                loss.backward()
                opt.step()
                opt.clear_grad()
                rec.append(float(loss))
            losses.append(rec)
        assert losses[1][-1] < losses[1][0]
        close(losses[1], losses[0], 1e-5)
        for p in tm._stacked:
            assert isinstance(p, DistParameter) and p.spec[0] == "ep"

    def test_num_experts_not_divisible_raises(self, ep_mesh):
        with pytest.raises(ValueError, match="not divisible"):
            tmoe.MoELayer(d_model=8, experts=_experts(T, tnn, 8, 6),
                          moe_group="ep")
        with pytest.raises(ValueError, match="not divisible"):
            jmoe.MoELayer(d_model=8, experts=_experts(J, jnn, 8, 6),
                          moe_group="ep")

    def test_differing_activations_do_not_consolidate(self, ep_mesh):
        d = 8
        for p, nn, m in ((J, jnn, jmoe), (T, tnn, tmoe)):
            experts = [nn.Sequential(nn.Linear(d, d), nn.GELU(), nn.Linear(d, d)),
                       nn.Sequential(nn.Linear(d, d), nn.ReLU(), nn.Linear(d, d))]
            assert m.MoELayer(d_model=d, experts=experts)._stacked is None

    def test_eval_mode_reaches_consolidated_experts(self, ep_mesh):
        d = 8
        experts = [tnn.Sequential(tnn.Linear(d, d), tnn.Dropout(0.5))
                   for _ in range(4)]
        moe = tmoe.MoELayer(d_model=d, experts=experts, moe_group="ep")
        assert moe._stacked is not None
        moe.eval()
        assert all(not l.training for e in moe.experts
                   for l in [e] + e.sublayers())
        x = x_of(T, np.random.RandomState(6).randn(1, 4, d).astype("float32"))
        np.testing.assert_array_equal(moe(x).numpy(), moe(x).numpy())
        moe.train()
        assert all(l.training for e in moe.experts
                   for l in [e] + e.sublayers())

    def test_lazy_shard_after_fleet_init(self):
        d = 8
        tset(None)
        moe = tmoe.MoELayer(d_model=d, experts=_experts(T, tnn, d, 4),
                            moe_group="ep")
        assert not moe._ep_sharded
        tset(THCG(dp=2, ep=4, devices=["cpu"] * 8))
        x = x_of(T, np.random.RandomState(7).randn(1, 4, d).astype("float32"))
        y0 = moe(x)
        assert moe._ep_sharded
        for p in moe._stacked:
            assert isinstance(p, DistParameter) and p.spec[0] == "ep"
        assert y0.shape == [1, 4, d]

    def test_heterogeneous_experts_fall_back(self, ep_mesh):
        d = 8

        def mk(p, nn):
            return [nn.Linear(d, d),
                    nn.Sequential(nn.Linear(d, 4), nn.Tanh(), nn.Linear(4, d)),
                    nn.Linear(d, d),
                    nn.Sequential(nn.Linear(d, 4), nn.Tanh(), nn.Linear(4, d))]

        jm, tm, je, te = twin_moe(mk, 5, None)
        assert tm._stacked is None
        a = np.random.RandomState(2).randn(2, 4, d).astype("float32")
        res = []
        for p, m, ex in ((J, jm, je), (T, tm, te)):
            y = m(x_of(p, a))
            (y ** 2).mean().backward()
            res.append([y.numpy()] + [q.grad.numpy() for e in ex
                                      for q in e.parameters()])
        for g, w in zip(res[1], res[0]):
            close(g, w, 1e-5 * max(1.0, float(np.abs(w).max())))


class TestCapacityTokenDrop:
    def test_overflow_tokens_dropped_to_zero(self):
        d = 4
        T.seed(0)
        e0, e1 = tnn.Linear(d, d), tnn.Linear(d, d)
        moe = tmoe.MoELayer(d_model=d, experts=[e0, e1],
                            gate={"type": "switch", "capacity_factor": 0.6})
        gw = np.zeros((d, 2), np.float32)
        gw[:, 0] = 1.0
        moe.gate.weight.set_value(gw)
        assert moe.gate.capacity(3) == 1
        a = np.abs(np.random.RandomState(3).randn(1, 3, d).astype("float32"))
        y = moe(x_of(T, a)).numpy()[0]
        close(y[0], e0(x_of(T, a[0, :1])).numpy()[0])
        np.testing.assert_array_equal(y[1], np.zeros(d))
        np.testing.assert_array_equal(y[2], np.zeros(d))

    def test_large_capacity_keeps_everything(self):
        d = 4
        mk = lambda p, nn: [nn.Linear(d, d) for _ in range(2)]  # noqa: E731
        jm, tm, _, _ = twin_moe(mk, 1, {"type": "switch",
                                        "capacity_factor": 100.0})
        a = np.random.RandomState(4).randn(1, 6, d).astype("float32")
        y = tm(x_of(T, a)).numpy()[0]
        assert not np.any(np.all(y == 0, axis=-1))
        close(y, jm(x_of(J, a)).numpy()[0])

    def test_stacked_matches_unrolled_path(self):
        d = 8
        a = np.random.RandomState(5).randn(2, 6, d).astype("float32")
        mk = lambda p, nn: _experts(p, nn, d, 4)   # noqa: E731
        gate = {"type": "gshard", "capacity_factor": 4.0}
        jm, tm, _, te = twin_moe(mk, 7, gate)
        y_fast = tm(x_of(T, a)).numpy()
        tm2 = tmoe.MoELayer(d_model=d, experts=te, gate=dict(gate))
        tm2.gate.weight.set_value(jm.gate.weight.numpy())
        object.__setattr__(tm2, "_stacked", None)
        from paddle_tpu_torch.nn.layers.container import LayerList
        tm2.experts = LayerList(list(tm2.experts))
        close(tm2(x_of(T, a)).numpy(), y_fast)
        close(y_fast, jm(x_of(J, a)).numpy())


class TestSurfaceMoE:
    def test_routing_output_and_aux(self):
        d = 16
        mk = lambda p, nn: [nn.Sequential(nn.Linear(d, 32), nn.GELU(),  # noqa
                                          nn.Linear(32, d)) for _ in range(4)]
        jm, tm, _, _ = twin_moe(mk, 0, {"type": "gshard",
                                        "capacity_factor": 8.0})
        a = np.random.randn(2, 6, d).astype("float32")
        res = []
        for p, m in ((J, jm), (T, tm)):
            y = m(x_of(p, a, sg=False))
            assert list(y.shape) == [2, 6, d]
            assert m.aux_loss is not None and np.isfinite(float(m.aux_loss))
            (y ** 2).mean().backward()
            assert m.gate.weight.grad is not None
            assert m._stacked is not None
            grads = [q.grad for q in m._stacked]
            assert all(g is not None and g.shape[0] == 4 for g in grads)
            res.append([y.numpy(), m.gate.weight.grad.numpy()] +
                       [g.numpy() for g in grads])
        for g, w in zip(res[1], res[0]):
            close(g, w, 1e-5 * max(1.0, float(np.abs(w).max())))

    def test_top1_switch_with_huge_capacity_matches_dense_expert(self):
        d = 8
        experts = [tnn.Linear(d, d) for _ in range(2)]
        moe = tmoe.MoELayer(d_model=d, experts=experts,
                            gate={"type": "switch", "capacity_factor": 100.0})
        x = x_of(T, np.random.randn(1, 5, d).astype("float32"))
        y = moe(x).numpy()[0]
        choice = (x.numpy()[0] @ moe.gate.weight.numpy()).argmax(-1)
        for t in range(5):
            e = experts[choice[t]]
            close(y[t], x.numpy()[0][t] @ e.weight.numpy() + e.bias.numpy())

    def test_capacity_drops_tokens(self):
        for m in (jmoe, tmoe):
            assert m.GShardGate(4, 2, capacity_factor=0.25).capacity(8) == 2

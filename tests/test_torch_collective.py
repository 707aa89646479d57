"""The port's topology and collective API (``paddle_tpu_torch.distributed``:
``build_mesh``, ``HybridCommunicateGroup``, ``fleet``, ``all_reduce`` and
the rest) against the JAX package's, on the same numpy inputs.

The JAX side runs on the 8-device CPU mesh of ``tests/conftest.py`` under
``fleet.init`` (dp 8, the reference's default); the port's group is dp 8
over ``["cpu"] * 8``, one process driving every rank, as JAX's single
controller does. ``tests/test_distributed.py:26-66`` (seven collective
cases) and ``:102-120`` (two topology cases) are mirrored; ``reduce``,
``scatter`` in both forms, the ``all_reduce`` ops min, avg and prod (a
negative and a zero among the factors), the ``all_gather`` list
convention and the per-rank list encoding are added. Every result equals
JAX's exactly (the values are small integers, and both packages reduce in
rank order). Under autograd the gradients are held to their adjoints:
``all_gather``'s is ``reduce_scatter`` of the upstream gradient,
``reduce_scatter``'s is ``all_gather``, ``all_reduce(sum)``'s is the
gradient itself per rank, and ``copy_to_group``'s is the sum over the
ranks.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.distributed as jdist
from paddle_tpu.distributed import fleet as jfleet
import paddle_tpu_torch.distributed as tdist
from paddle_tpu_torch.distributed import collective as TCOL
from paddle_tpu_torch.distributed import fleet as tfleet

CPU8 = ["cpu"] * 8


@pytest.fixture(autouse=True)
def _reset_topology():
    yield
    jdist.set_hybrid_communicate_group(None)
    tdist.set_hybrid_communicate_group(None)


def _dp8():
    jfleet.init(is_collective=True)
    tfleet.init(is_collective=True, devices=CPU8)


def _jax(a):
    return paddle.to_tensor(np.asarray(a))


def _port(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return np.asarray(x.numpy() if hasattr(x, "numpy") else x)


ARANGE8 = np.arange(8, dtype=np.float32).reshape(8, 1)
SIGNED = np.array([[-2.0, 3.0], [1.5, -1.0], [0.5, 2.0], [-1.0, 0.0],
                   [2.0, 1.0], [1.0, -2.0], [-0.5, 1.0], [4.0, 1.0]],
                  np.float32)


def _all_reduce(op):
    def run(d, mk, x):
        t = mk(x)
        d.all_reduce(t, op=getattr(d.ReduceOp, op))
        return t
    return run


# (name, input, run(dist module, tensor maker, input) -> result)
CASES = {
    "all_reduce_sum": (ARANGE8, _all_reduce("SUM")),
    "all_reduce_max": (ARANGE8, _all_reduce("MAX")),
    "all_reduce_min": (SIGNED, _all_reduce("MIN")),
    "all_reduce_avg": (ARANGE8, _all_reduce("AVG")),
    "all_reduce_prod": (SIGNED, _all_reduce("PROD")),
    "all_gather": (np.arange(16, dtype=np.float32).reshape(8, 2),
                   lambda d, mk, x: d.all_gather(mk(x))),
    "reduce_scatter": (np.ones((8, 8), np.float32),
                       lambda d, mk, x: d.reduce_scatter(mk(x))),
    "alltoall": (np.arange(64, dtype=np.float32).reshape(8, 8),
                 lambda d, mk, x: d.alltoall(mk(x))),
    "broadcast": (ARANGE8, lambda d, mk, x: d.broadcast(mk(x), src=3)),
    "reduce": (SIGNED, lambda d, mk, x: d.reduce(mk(x), dst=0)),
    "scatter_list": (np.arange(24, dtype=np.float32).reshape(8, 3),
                     lambda d, mk, x: d.scatter(
                         mk(np.zeros((8, 3), np.float32)),
                         tensor_list=[mk(r) for r in x])),
    "scatter_split": (np.arange(16, dtype=np.float32),
                      lambda d, mk, x: d.scatter(mk(x))),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_collective_matches_jax(case):
    _dp8()
    x, run = CASES[case]
    want = _np(run(jdist, _jax, x))
    got = run(tdist, _port, x)
    assert isinstance(got, torch.Tensor)
    np.testing.assert_array_equal(got.numpy(), want)
    # the per-rank list form gives each rank its row of the same result
    # (scatter's split form takes the whole value, not per-rank rows)
    if not case.startswith("scatter"):
        got_l = run(tdist, lambda a: [_port(r) for r in a], x)
        assert isinstance(got_l, list) and len(got_l) == 8
        np.testing.assert_array_equal(torch.stack(got_l).numpy(), want)


def test_in_place_and_world():
    """``all_reduce`` and ``broadcast`` update the given tensor (and a
    per-rank list's tensors) in place; the world is dp 8, rank 0."""
    _dp8()
    assert tdist.get_world_size() == jdist.get_world_size() == 8
    assert tdist.get_rank() == jdist.get_rank() == 0
    assert tdist.get_world_size("dp") == 8
    x = _port(ARANGE8)
    assert tdist.all_reduce(x) is x
    np.testing.assert_array_equal(x.numpy(), np.full((8, 1), 28.0))
    xs = [torch.full((2,), float(r)) for r in range(8)]
    ptrs = [t.data_ptr() for t in xs]
    assert tdist.broadcast(xs, src=5) is xs
    assert [t.data_ptr() for t in xs] == ptrs
    assert all(torch.equal(t, torch.full((2,), 5.0)) for t in xs)
    assert tdist.barrier() is None


def test_all_gather_list_convention():
    _dp8()
    x = np.arange(16, dtype=np.float32).reshape(8, 2)
    jl, tl = [], []
    jdist.all_gather(jl, _jax(x))
    assert tdist.all_gather(tl, _port(x)) is tl
    assert len(tl) == len(jl) == 8
    for a, b in zip(tl, jl):
        np.testing.assert_array_equal(a.numpy(), _np(b))


def test_wrong_leading_dim_raises():
    _dp8()
    with pytest.raises(ValueError, match="leading rank dim 8"):
        tdist.all_reduce(torch.zeros(4, 1))
    with pytest.raises(ValueError, match="divisible by group size 8"):
        tdist.scatter(torch.zeros(12))
    with pytest.raises(ValueError, match="options"):
        tdist.all_reduce(torch.zeros(8, 1), op="median")


def test_gradients_are_the_adjoints():
    """all_gather <-> reduce_scatter; all_reduce(sum) passes each rank's
    gradient through; copy_to_group sums the ranks' gradients."""
    _dp8()
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((8, 3), np.float32))
    g = torch.from_numpy(rng.standard_normal((8, 24), np.float32))
    xg = x.clone().requires_grad_()
    tdist.all_gather(xg).backward(g)
    assert torch.equal(xg.grad, tdist.reduce_scatter(g))

    y = torch.from_numpy(rng.standard_normal((8, 16), np.float32))
    gy = torch.from_numpy(rng.standard_normal((8, 2), np.float32))
    yg = y.clone().requires_grad_()
    tdist.reduce_scatter(yg).backward(gy)
    assert torch.equal(yg.grad, tdist.all_gather(gy))

    xs = [r.clone().requires_grad_() for r in x]
    gs = [torch.from_numpy(rng.standard_normal(3, np.float32))
          for _ in range(8)]
    outs = TCOL.all_reduce_sum(xs)
    torch.autograd.backward(outs, gs)
    for a, b in zip(xs, gs):
        assert torch.equal(a.grad, b)
    # the in-place public form carries the same adjoint
    xr = x.clone().requires_grad_()
    z = xr * 1
    tdist.all_reduce(z)
    z.backward(g[:, :3])
    assert torch.equal(xr.grad, g[:, :3])

    xs = [r.clone().requires_grad_() for r in x]
    torch.autograd.backward(TCOL.copy_to_group(xs), gs)
    total = gs[0]
    for t in gs[1:]:
        total = total + t
    for a in xs:
        assert torch.equal(a.grad, total)


@pytest.mark.parametrize("case", ["hybrid", "wrong_degrees"])
def test_fleet_topology_matches_jax(case):
    """``tests/test_distributed.py:102-120`` on both packages."""
    def strategy(mod, dp, mp, sh):
        s = mod.DistributedStrategy()
        s.hybrid_configs = {"dp_degree": dp, "mp_degree": mp,
                            "pp_degree": 1, "sharding_degree": sh,
                            "sep_degree": 1}
        return s
    if case == "wrong_degrees":
        with pytest.raises(ValueError, match="require 3 devices, got 8") \
                as je:
            jfleet.init(strategy=strategy(jfleet, 3, 1, 1))
        with pytest.raises(ValueError) as te:
            tfleet.init(strategy=strategy(tfleet, 3, 1, 1), devices=CPU8)
        assert str(te.value) == str(je.value)
        return
    jfleet.init(is_collective=True, strategy=strategy(jfleet, 2, 2, 2))
    tfleet.init(is_collective=True, strategy=strategy(tfleet, 2, 2, 2),
                devices=CPU8)
    jh, th = jfleet.get_hybrid_communicate_group(), \
        tfleet.get_hybrid_communicate_group()
    for q in ("data", "model", "sharding", "pipe", "sep", "expert"):
        name = f"get_{q}_parallel_world_size"
        assert getattr(th, name)() == getattr(jh, name)()
    for q in ("data", "model", "sharding", "sep", "expert"):
        assert getattr(th, f"get_{q}_parallel_rank")() == 0
        assert getattr(jh, f"get_{q}_parallel_rank")() == 0
    assert th.get_stage_id() == jh.get_stage_id() == 0
    assert dict(th.mesh.shape) == dict(jh.mesh.shape)
    assert th.mesh.axis_names == tuple(jh.mesh.axis_names)
    assert th.get_model_parallel_group().nranks == 2
    assert th.mesh.devices.shape == jh.mesh.devices.shape
    # dp fills the devices left when only the other axes are set
    tfleet.init(strategy=strategy(tfleet, 1, 2, 1), devices=CPU8)
    jfleet.init(strategy=strategy(jfleet, 1, 2, 1))
    assert (tfleet.get_hybrid_communicate_group().degrees
            == jfleet.get_hybrid_communicate_group().degrees)
    assert tfleet.worker_num() == 1 and tfleet.worker_index() == 0
    assert tfleet.is_first_worker() and tfleet.barrier_worker() is None


def test_default_group_and_multi_process_refused(monkeypatch):
    """With no group set, the port's default is dp over the devices the
    process drives (one CPU here). A launcher's multi-process environment
    (it was refused before the launcher was ported) joins
    ``torch.distributed``'s gloo group at the launcher's rendezvous, as
    that rank; the two-process run is ``tests/test_torch_launch.py``."""
    hcg = tdist.get_hybrid_communicate_group()
    assert hcg.get_data_parallel_world_size() == 1
    assert [str(d) for d in hcg.mesh.devices.flat] == ["cpu"]
    tdist.init_parallel_env()
    assert tdist.is_initialized()
    calls = []
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda *a, **kw: calls.append((a, kw)))
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: False)
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "2")
    monkeypatch.setenv("PADDLE_TRAINER_ID", "1")
    monkeypatch.setenv("PADDLE_MASTER", "127.0.0.1:6170")
    tdist.init_parallel_env(timeout=30)
    (args, kw), = calls
    assert args == ("gloo",)
    assert (kw["init_method"], kw["rank"], kw["world_size"]) == \
        ("tcp://127.0.0.1:6170", 1, 2)
    assert kw["timeout"].total_seconds() == 30

"""The sparse convolution family of the port
(``paddle_tpu_torch/sparse/nn_conv.py``) against the JAX package's
(``paddle_tpu/sparse/nn_conv.py``): ``conv3d`` at five geometries,
``subm_conv3d``, ``max_pool3d`` and ``batch_norm``, the four layers, the
rulebook's host reads, and SECOND's sparse encoder (``chip_smoke.
second_layers``, the layer list of phase 66) narrowed to widths (8, 16,
32, 32, 32) on a [25, 32, 32] grid (the smallest z that its (3, 1, 1)
output conv still covers after three stride-2 levels) with ~300 voxels a
sample, its weights carried across by ``models.convert.
sparse_state_dict_from_jax``.

Outputs are compared as coordinate sets sorted by linear key (the port
keeps Paddle's sorted order for a strided conv, the reference insertion
order; a submanifold conv keeps the input's order in both), values row by
row within ``1e-5 * max|ref|``; gradients of an order-free loss (the mean
of ``v ** 2 * (v + 1)`` over the output values ``v``: not a function of
their norm alone, which BatchNorm's output keeps fixed) with respect to
the input values, the weights and the bias within ``1e-4 * max|g|``.
"""

import pathlib
import sys

import numpy as np
import pytest

import paddle_tpu as J
import paddle_tpu.sparse as JS
import paddle_tpu_torch as T
import paddle_tpu_torch.sparse as TS
from paddle_tpu_torch.models.convert import sparse_state_dict_from_jax
from paddle_tpu_torch.sparse import _keys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

SPARSE = {J: JS, T: TS}
FWD, GRAD = 1e-5, 1e-4


@pytest.fixture(autouse=True)
def _port_on_cpu():
    prev = T.get_device()
    T.set_device("cpu")
    yield
    T.set_device(prev)


def close(got, want, rtol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max(initial=0.0))
    assert err <= rtol * max(float(np.abs(want).max(initial=0.0)), 1e-30), \
        f"{what}: {err}"


def cloud(seed, B=2, grid=(7, 9, 8), C=3, n=60):
    rng = np.random.default_rng(seed)
    keys = rng.choice(B * int(np.prod(grid)), n, replace=False)
    b, rest = np.divmod(keys, int(np.prod(grid)))
    z, rest = np.divmod(rest, grid[1] * grid[2])
    y, x = np.divmod(rest, grid[2])
    idx = np.stack([b, z, y, x]).astype(np.int64)
    return idx, rng.standard_normal((n, C)).astype(np.float32), \
        [B, *grid, C]


def canon(sp):
    idx = np.asarray(sp.indices().numpy()).astype(np.int64)
    order = np.lexsort(idx[::-1])
    return idx[:, order], np.asarray(sp.values().numpy())[order]


def run_op(p, fn, idx, vals, shape, params, **kw):
    """``fn`` of package ``p`` on the cloud: (sorted indices, values, the
    gradients of the loss for the input values and each of ``params``)."""
    v = p.to_tensor(vals, stop_gradient=False)
    ps = [p.to_tensor(a, stop_gradient=False) for a in params]
    x = SPARSE[p].sparse_coo_tensor(idx, v, shape)
    out = fn(p)(x, *ps, **kw)
    out = out[0] if isinstance(out, tuple) else out
    o = out.values()
    loss = (o * o * (o + 1.0)).mean()
    gs = p.grad([loss], [v] + ps, allow_unused=True)
    return canon(out), out.shape, [np.zeros(a.shape) if g is None
                                   else g.numpy() for g, a in
                                   zip(gs, [vals] + params)]


def compare(fn, idx, vals, shape, params, **kw):
    (ji, jv), js, jg = run_op(J, fn, idx, vals, shape, params, **kw)
    (ti, tv), ts, tg = run_op(T, fn, idx, vals, shape, params, **kw)
    assert ts == js
    np.testing.assert_array_equal(ti, ji)
    close(tv, jv, FWD, "values")
    for i, (a, b) in enumerate(zip(tg, jg)):
        close(a, b, GRAD, f"grad {i}")
    return ti


GEOMETRIES = [dict(kernel=(3, 3, 3), stride=1, padding=1),
              dict(kernel=(3, 3, 3), stride=2, padding=1),
              dict(kernel=(3, 3, 3), stride=2, padding=(0, 1, 1)),
              dict(kernel=(3, 1, 1), stride=(2, 1, 1), padding=0),
              dict(kernel=(2, 2, 2), stride=2, padding=0)]


@pytest.mark.parametrize("g", GEOMETRIES, ids=lambda g: "k{}s{}p{}".format(
    *(str(g[k]).replace(" ", "") for k in ("kernel", "stride", "padding"))))
def test_conv3d(g):
    idx, vals, shape = cloud(0)
    rng = np.random.default_rng(1)
    w = rng.standard_normal(g["kernel"] + (3, 4)).astype(np.float32)
    b = rng.standard_normal(4).astype(np.float32)
    compare(lambda p: SPARSE[p].nn.functional.conv3d, idx, vals, shape,
            [w, b], stride=g["stride"], padding=g["padding"])


def test_subm_conv3d_keeps_the_input_order():
    idx, vals, shape = cloud(2)
    rng = np.random.default_rng(3)
    w = rng.standard_normal((3, 3, 3, 3, 5)).astype(np.float32)
    compare(lambda p: SPARSE[p].nn.functional.subm_conv3d, idx, vals,
            shape, [w])
    x = TS.sparse_coo_tensor(idx, vals, shape)
    out = TS.nn.functional.subm_conv3d(x, w)
    assert out.indices() is x.indices()


@pytest.mark.parametrize("k,s,p", [(2, None, 0), (3, 2, 1)])
def test_max_pool3d(k, s, p):
    idx, vals, shape = cloud(4)
    compare(lambda q: SPARSE[q].nn.functional.max_pool3d, idx, vals, shape,
            [], kernel_size=k, stride=s, padding=p)


@pytest.mark.parametrize("training", [False, True])
def test_batch_norm(training):
    idx, vals, shape = cloud(5)
    rng = np.random.default_rng(6)
    rm = rng.standard_normal(3).astype(np.float32)
    rv = rng.uniform(0.5, 2, 3).astype(np.float32)
    w = rng.standard_normal(3).astype(np.float32)
    b = rng.standard_normal(3).astype(np.float32)
    compare(lambda p: SPARSE[p].nn.functional.batch_norm, idx, vals, shape,
            [rm, rv, w, b], training=training, momentum=0.8, epsilon=1e-3)
    stats = []
    for p in (J, T):
        x = SPARSE[p].sparse_coo_tensor(idx, vals, shape)
        _, nrm, nrv = SPARSE[p].nn.functional.batch_norm(
            x, rm, rv, training=training, momentum=0.8)
        stats.append((nrm.numpy(), nrv.numpy()))
    for a, b_ in zip(stats[1], stats[0]):
        close(a, b_, FWD, "running stats")


def test_layers_take_the_reference_arguments_and_weights():
    idx, vals, shape = cloud(7)
    outs = []
    for p in (J, T):
        nn = SPARSE[p].nn
        layers = [nn.SubmConv3D(3, 4, 3, seed=3), nn.BatchNorm(4, momentum=0.5),
                  nn.ReLU(), nn.Conv3D(4, 6, 3, stride=2, padding=1, seed=4),
                  nn.MaxPool3D(2, stride=1), nn.BatchNorm(6)]
        x = SPARSE[p].sparse_coo_tensor(idx, vals, shape)
        for lay in layers:
            x = lay(x)
        outs.append((canon(x), [np.asarray(getattr(lay, k).numpy()
                                           if hasattr(getattr(lay, k),
                                                      "numpy")
                                           else getattr(lay, k))
                                for lay in layers
                                for k in ("weight", "bias", "_mean", "_var")
                                if getattr(lay, k, None) is not None]))
    (jc, js), (tc, ts) = outs
    np.testing.assert_array_equal(tc[0], jc[0])
    close(tc[1], jc[1], FWD, "layers")
    assert len(ts) == len(js)
    for a, b in zip(ts, js):           # the seeded weights are equal, and
        close(a, b, FWD, "state")      # the running stats moved alike
    net = T.nn.Sequential(*[TS.nn.SubmConv3D(3, 4, 3), TS.nn.BatchNorm(4)])
    assert sorted(net.state_dict()) == ["0.bias", "0.weight", "1._mean",
                                        "1._var", "1.bias", "1.weight"]
    assert len(T.optimizer.SGD(0.1, parameters=net.parameters())
               ._params()) == 4


def test_rulebook_host_reads_and_cache():
    """A submanifold rulebook reads one size (the per-offset pair counts),
    a strided one two (the output count too); the second submanifold conv
    of a level, and a repeat, read nothing (the cache on the indices)."""
    idx, vals, shape = cloud(8)
    w = np.ones((3, 3, 3, 3, 3), np.float32)
    x = TS.sparse_coo_tensor(idx, vals, shape)
    n0 = _keys.syncs
    y = TS.nn.functional.subm_conv3d(x, w)
    assert _keys.syncs == n0 + 1
    TS.nn.functional.subm_conv3d(TS.relu(y), w)
    assert _keys.syncs == n0 + 1
    z = TS.nn.functional.conv3d(y, w, stride=2, padding=1)
    assert _keys.syncs == n0 + 3
    TS.nn.functional.conv3d(y, w, stride=2, padding=1)
    assert _keys.syncs == n0 + 3
    assert z.indices() is TS.nn.functional.conv3d(
        y, w, stride=2, padding=1).indices()


def test_second_encoder_narrow():
    rows = chip_smoke.second_layers((8, 16, 32, 32, 32))
    grid = (25, 32, 32)
    idx, feats = chip_smoke.lidar_voxels(np.random.default_rng(9), 2, 150,
                                         grid)
    shape = [2, *grid, 4]
    J.seed(0)
    jlayers = chip_smoke.second_encoder(JS.nn, rows, seed=11)
    tnet = T.nn.Sequential(*chip_smoke.second_encoder(TS.nn, rows))
    missing, unexpected = tnet.set_state_dict(
        sparse_state_dict_from_jax(jlayers))
    assert not missing and not unexpected
    res = []
    for p, net in ((J, jlayers), (T, tnet)):
        x = SPARSE[p].sparse_coo_tensor(idx, feats, shape)
        for lay in net:
            x = lay(x)
        loss = (x.values() * x.values()).mean()
        params = [q for lay in net for q in getattr(lay, "parameters",
                                                      lambda: [])()]
        gs = p.grad([loss], params)
        res.append((x, canon(x), [g.numpy() for g in gs]))
    (jx, (ji, jv), jg), (tx, (ti, tv), tg) = res
    assert tx.shape == jx.shape == [2, 1, 4, 4, 32]
    np.testing.assert_array_equal(ti, ji)
    close(tv, jv, FWD, "encoder output")
    assert len(tg) == len(jg) == 36
    for i, (a, b) in enumerate(zip(tg, jg)):
        close(a, b, GRAD, f"grad {i}")
    bev = chip_smoke.second_bev(T, tx).numpy()
    dense = np.zeros(tx.shape, np.float32)
    dense[tuple(ji)] = jv
    close(bev, dense.transpose(0, 4, 1, 2, 3).reshape(2, 32, 4, 4), FWD,
          "BEV")
    for k, v in sparse_state_dict_from_jax(jlayers).items():
        if k.endswith(("_mean", "_var")):
            close(tnet.state_dict()[k].numpy(), v, FWD, k)

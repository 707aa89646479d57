"""The port's ``nn.utils`` (``paddle_tpu_torch/nn/utils.py``) against the
JAX package's on the same weights: ``parameters_to_vector`` /
``vector_to_parameters``, ``weight_norm`` / ``remove_weight_norm`` and
``spectral_norm`` (its power-iteration vector ``u`` carried across from
the reference), forward within 1e-5 x max|ref| and gradients within
1e-4 x max|g|.
"""

import numpy as np
import pytest

import paddle_tpu as J
import paddle_tpu_torch as T
from _torch_sweep import close


@pytest.fixture(autouse=True)
def _port_on_cpu():
    prev = T.get_device()
    T.set_device("cpu")
    yield
    T.set_device(prev)


def _twin_linears(n_in, n_out, seed):
    """A Linear of each package with the same weights."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((n_in, n_out)).astype(np.float32)
    b = rng.standard_normal((n_out,)).astype(np.float32)
    lay = {}
    for p in (J, T):
        lay[p] = p.nn.Linear(n_in, n_out)
        lay[p].weight.set_value(w)
        lay[p].bias.set_value(b)
    return lay


def _forward_grads(p, layer, x):
    out = layer(p.to_tensor(x))
    names, params = zip(*layer.named_parameters())
    gs = p.grad([(out * out).sum()], list(params))
    return out.numpy(), dict(zip(names, (g.numpy() for g in gs)))


def _agree(lay, x):
    (oj, gj), (ot, gt) = (_forward_grads(p, lay[p], x) for p in (J, T))
    close(ot, oj)
    assert sorted(gt) == sorted(gj)
    for k in gj:
        close(gt[k], gj[k], rtol=1e-4, what=k)


def test_parameters_to_vector_round_trip():
    lay = _twin_linears(4, 3, 0)
    vj = J.nn.utils.parameters_to_vector(lay[J].parameters())
    vt = T.nn.utils.parameters_to_vector(lay[T].parameters())
    close(vt.numpy(), vj.numpy())
    new = np.arange(vt.shape[0], dtype=np.float32)
    for p in (J, T):
        p.nn.utils.vector_to_parameters(p.to_tensor(new),
                                        lay[p].parameters())
    for a, b in zip(lay[T].parameters(), lay[J].parameters()):
        close(a.numpy(), b.numpy())
    # the port's vector carries the graph back to the parameters
    t = T.nn.utils.parameters_to_vector(lay[T].parameters())
    gs = T.grad([(t * t).sum()], list(lay[T].parameters()))
    for g, q in zip(gs, lay[T].parameters()):
        close(g.numpy(), 2 * q.numpy())


@pytest.mark.parametrize("dim", [0, 1])
def test_weight_norm_matches_jax(dim):
    lay = _twin_linears(5, 4, 1)
    for p in (J, T):
        p.nn.utils.weight_norm(lay[p], dim=dim)
    assert sorted(n for n, _ in lay[T].named_parameters()) == \
        ["bias", "weight_g", "weight_v"]
    x = np.random.default_rng(2).standard_normal((3, 5)).astype(np.float32)
    _agree(lay, x)
    # the hook rebuilds the weight from g and v on every call
    g = lay[J].weight_g.numpy() * 1.5
    for p in (J, T):
        lay[p].weight_g.set_value(g)
    _agree(lay, x)
    for p in (J, T):
        p.nn.utils.remove_weight_norm(lay[p])
    assert sorted(n for n, _ in lay[T].named_parameters()) == \
        ["bias", "weight"]
    close(lay[T].weight.numpy(), lay[J].weight.numpy())
    _agree(lay, x)


@pytest.mark.parametrize("iters", [1, 3])
def test_spectral_norm_matches_jax_with_u_carried(iters):
    lay = _twin_linears(6, 4, 3)
    for p in (J, T):
        p.nn.utils.spectral_norm(lay[p], n_power_iterations=iters)
    u = lay[T].weight_u
    u.set_value(lay[J].weight_u.numpy())
    ptr = u._value.data_ptr()
    x = np.random.default_rng(4).standard_normal((2, 6)).astype(np.float32)
    for _ in range(3):
        _agree(lay, x)
        close(lay[T].weight_u.numpy(), lay[J].weight_u.numpy())
    # the power iteration's vector is updated where it lives
    assert lay[T].weight_u._value.data_ptr() == ptr
    assert lay[T].weight_u is u
    assert sorted(n for n, _ in lay[T].named_parameters()) == \
        ["bias", "weight_orig"]
    sigma = np.linalg.svd(lay[J].weight_orig.numpy(), compute_uv=False)[0]
    close(lay[T].weight.numpy(), lay[J].weight_orig.numpy() / sigma,
          rtol=1e-2)


def test_spectral_norm_first_u_from_the_port_generator():
    a = _twin_linears(6, 4, 5)[T]
    b = _twin_linears(6, 4, 5)[T]
    T.seed(3)
    T.nn.utils.spectral_norm(a)
    T.seed(3)
    T.nn.utils.spectral_norm(b)
    u = a.weight_u.numpy()
    np.testing.assert_array_equal(u, b.weight_u.numpy())
    assert abs(float(np.linalg.norm(u)) - 1.0) < 1e-6

"""The port's functional update rules (``paddle_tpu_torch/optimizer/ops.py``,
``optimizer.ops`` / ``optimizer.optimizer_ops``) against the JAX
package's: each rule over 5 steps with its state carried, every output
within 1e-5 x max|ref|; and the optimizer classes that apply the same
rule give, on one step, what the ``*_update`` op gives.
"""

import numpy as np
import pytest

import paddle_tpu as J
import paddle_tpu.optimizer.ops  # noqa: F401
import paddle_tpu_torch as T
import paddle_tpu_torch.optimizer.ops  # noqa: F401
from _torch_sweep import check_sweep, close, shared_ops


@pytest.fixture(autouse=True)
def _port_on_cpu():
    prev = T.get_device()
    T.set_device("cpu")
    yield
    T.set_device(prev)


SHAPE = (3, 4)


def _pos(rng, shape=SHAPE):
    return rng.uniform(0.1, 1.0, shape).astype(np.float32)


def _f(rng, shape=SHAPE):
    return rng.standard_normal(shape).astype(np.float32)


# name: (state builder from rng -> list of arrays after (param, grad),
#        kwargs, number of outputs that are state carried to the next step)
RULES = {
    "sgd_update": (lambda r: [], {"learning_rate": 0.1}),
    "momentum_update": (lambda r: [_f(r)], {"mu": 0.8,
                                             "use_nesterov": True}),
    "adagrad_update": (lambda r: [_pos(r)], {"learning_rate": 0.05}),
    "rmsprop_update": (lambda r: [_f(r), _pos(r)], {"momentum": 0.5}),
    "adam_update": (lambda r: [_f(r), _pos(r), np.float32(0.9),
                               np.float32(0.999)], {}),
    "adamw_update": (lambda r: [_f(r), _pos(r), np.float32(0.9),
                                np.float32(0.999)], {"weight_decay": 0.1}),
    "adamax_update": (lambda r: [_f(r), _pos(r), np.float32(0.9)], {}),
    "adadelta_update": (lambda r: [_pos(r), _pos(r)], {"rho": 0.9}),
    "lamb_update": (lambda r: [_f(r), _pos(r), np.float32(0.9),
                               np.float32(0.999)], {"weight_decay": 0.05}),
    "nadam_update": (lambda r: [_f(r), _pos(r), np.float32(0.9),
                                np.float32(0.999)], {}),
    "ftrl_update": (lambda r: [_pos(r), _f(r)], {"l1": 0.01, "l2": 0.1}),
    "lars_momentum_update": (lambda r: [_f(r)], {"learning_rate": 0.1}),
    "proximal_adagrad_update": (lambda r: [_pos(r)], {"l1": 0.01,
                                                       "l2": 0.1}),
    "proximal_gd_update": (lambda r: [], {"l1": 0.01, "l2": 0.1}),
    "decayed_adagrad_update": (lambda r: [_pos(r)], {}),
    "dgc_momentum_update": (lambda r: [_f(r), _f(r)], {"sparsity": 0.5}),
}


@pytest.mark.parametrize("name", sorted(RULES))
def test_rule_over_steps_matches_jax(name):
    build, kw = RULES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    p0, state0 = _f(rng), build(rng)
    vals = {J: [p0] + state0, T: [p0] + state0}
    for step in range(5):
        g = _f(rng)
        for pk in (J, T):
            fn = getattr(pk.optimizer.ops, name)
            out = fn(pk.to_tensor(vals[pk][0]), pk.to_tensor(g),
                     *[pk.to_tensor(s) for s in vals[pk][1:]], **kw)
            out = out if isinstance(out, (tuple, list)) else [out]
            vals[pk] = [o.numpy() for o in out]
        assert len(vals[T]) == len(vals[J])
        for i, (a, b) in enumerate(zip(vals[T], vals[J])):
            close(a, b, what=f"{name} step {step} output {i}")


def test_radam_and_sparse_momentum_match_jax():
    rng = np.random.default_rng(0)
    p, g, m, v = _f(rng), _f(rng), _f(rng), _pos(rng)
    for t in (1.0, 7.0):                      # both sides of rho_t > 5
        b1p, b2p = np.float32(0.9 ** t), np.float32(0.999 ** t)
        args = [p, g, m, v, b1p, b2p, np.float32(t)]
        got = T.optimizer.ops.radam_update(*[T.to_tensor(a) for a in args])
        want = J.optimizer.ops.radam_update(*[J.to_tensor(a) for a in args])
        for a, b in zip(got, want):
            close(a.numpy(), b.numpy())
    idx = np.array([0, 2], np.int64)
    for axis, gshape in ((0, (2, 4)), (1, (3, 2))):
        grows = _f(rng, gshape)
        args = [p, grows, m, idx]
        got = T.optimizer.ops.sparse_momentum_update(
            *[T.to_tensor(a) for a in args], axis=axis)
        want = J.optimizer.ops.sparse_momentum_update(
            *[J.to_tensor(a) for a in args], axis=axis)
        for a, b in zip(got, want):
            close(a.numpy(), b.numpy())


def test_namespaces():
    assert T.optimizer.ops is T.optimizer.optimizer_ops
    assert sorted(T.optimizer.ops.__all__) == sorted(J.optimizer.ops.__all__)
    for n in T.optimizer.ops.__all__:
        assert T.OP_REGISTRY[n].category == "optimizer"
        assert T.OP_REGISTRY[n].differentiable is False


# -- the classes and the ops share one formula -------------------------------------

CLASSES = [
    ("SGD", {}, "sgd_update", [], {}),
    ("Momentum", {"momentum": 0.8, "use_nesterov": True}, "momentum_update",
     ["velocity"], {"mu": 0.8, "use_nesterov": True}),
    ("Adagrad", {"epsilon": 1e-6}, "adagrad_update", ["moment"], {}),
    ("RMSProp", {"rho": 0.9, "momentum": 0.3}, "rmsprop_update",
     ["momentum", "mean_square"], {"rho": 0.9, "momentum": 0.3}),
    ("Adam", {}, "adam_update", ["moment1", "moment2", "pow1", "pow2"], {}),
    ("AdamW", {"weight_decay": 0.1}, "adamw_update",
     ["moment1", "moment2", "pow1", "pow2"], {"weight_decay": 0.1}),
    ("Adamax", {}, "adamax_update", ["moment", "inf_norm", "pow1"], {}),
    ("Adadelta", {"rho": 0.9}, "adadelta_update",
     ["avg_squared_grad", "avg_squared_update"], {"rho": 0.9}),
    ("Lamb", {"lamb_weight_decay": 0.05}, "lamb_update",
     ["moment1", "moment2", "pow1", "pow2"], {"weight_decay": 0.05}),
]


@pytest.mark.parametrize("cls,ckw,op,state,okw", CLASSES,
                         ids=[c[0] for c in CLASSES])
def test_class_step_equals_its_update_op(cls, ckw, op, state, okw):
    """One step of the class from zero state equals the op from the same
    state (the betas' powers of step 1), bit for bit."""
    rng = np.random.default_rng(1)
    w, g = _f(rng), _f(rng)
    lr = 0.05
    param = T.create_parameter(list(SHAPE), "float32")
    param.set_value(w)
    param.grad = T.to_tensor(g)
    getattr(T.optimizer, cls)(learning_rate=lr, parameters=[param],
                              **ckw).step()
    zeros = np.zeros(SHAPE, np.float32)
    pows = {"pow1": np.float32(0.9), "pow2": np.float32(0.999)}
    args = [T.to_tensor(pows.get(s, zeros)) for s in state]
    out = getattr(T.optimizer.ops, op)(T.to_tensor(w), T.to_tensor(g), *args,
                                       learning_rate=lr, **okw)
    new = out[0] if isinstance(out, (tuple, list)) else out
    np.testing.assert_array_equal(param.numpy(), new.numpy())


@pytest.mark.parametrize("name", shared_ops("optimizer"))
def test_registry_sweep(name):
    check_sweep(name)

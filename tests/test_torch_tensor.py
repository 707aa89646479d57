"""The port's eager Tensor and autograd (``paddle_tpu_torch.core``) against
the JAX package's, case for case with ``tests/test_tensor.py`` and
``tests/test_autograd.py``, plus the probes of the verify recipe
(backward on a stop_gradient tensor, a second backward without
retain_graph, ``u[0] = 5.0`` zeroing that slot's gradient, an in-place add
keeping the graph, ``FLAGS_check_nan_inf``).

Each case runs the same body, on the same inputs made from a seed with
numpy, through ``paddle_tpu`` (JAX, CPU) and ``paddle_tpu_torch`` (set to
the CPU by this file's fixture) and compares what the body returns:
float results within ``rtol=1e-6`` (``1e-5`` where a division or a
transcendental function enters), integer and bool results exactly.
Dtypes are compared by name; where JAX's 32-bit default makes an integer
int32 and Paddle's (and torch's) int64, the values are compared, and the
port's own dtype is checked against Paddle's.
"""

import numpy as np
import pytest

import paddle_tpu as J
import paddle_tpu_torch as T
from paddle_tpu_torch.core.dtype import dtype_name


@pytest.fixture(autouse=True)
def _port_on_cpu():
    prev = T.get_device()
    T.set_device("cpu")
    yield
    T.set_device(prev)


def _np(v):
    if isinstance(v, (list, tuple)):
        return [_np(x) for x in v]
    if hasattr(v, "numpy"):
        return np.asarray(v.numpy())
    return np.asarray(v)


def same(body, rtol=1e-6, atol=0.0):
    """Run ``body(paddle)`` on both packages; compare the returned values
    (a dict of arrays / tensors / scalars). Returns (jax, port) results."""
    rj, rt = body(J), body(T)
    assert rj.keys() == rt.keys()
    for k in rj:
        a, b = _np(rj[k]), _np(rt[k])
        if isinstance(a, list):
            for x, y in zip(a, b):
                np.testing.assert_allclose(y, x, rtol=rtol, atol=atol, err_msg=k)
        elif a.dtype.kind in "biu":
            np.testing.assert_array_equal(b, a, err_msg=k)
        else:
            np.testing.assert_allclose(b, a, rtol=rtol, atol=atol, err_msg=k)
    return rj, rt


def rng(seed=0):
    return np.random.default_rng(seed)


# -- tests/test_tensor.py ---------------------------------------------------

def test_to_tensor_roundtrip():
    def body(p):
        x = p.to_tensor([[1.0, 2.0], [3.0, 4.0]])
        assert x.shape == [2, 2]
        assert dtype_name(x.dtype) == "float32"
        return {"x": x}
    same(body)


def test_python_float_uses_default_dtype():
    def body(p):
        x = p.to_tensor(3.14)
        assert dtype_name(x.dtype) == "float32"
        p.set_default_dtype("float64")
        try:
            assert dtype_name(p.get_default_dtype()) == "float64"
        finally:
            p.set_default_dtype("float32")
        return {"x": x}
    same(body)


def test_dtype_strings():
    for p in (J, T):
        assert dtype_name(p.to_tensor([1], dtype="int32").dtype) == "int32"
        assert dtype_name(p.to_tensor([1.0], dtype="bfloat16").dtype) == \
            "bfloat16"
    assert T.to_tensor([1], dtype="int32").dtype == T.int32


def test_creation_ops():
    def body(p):
        return {"zeros": p.zeros([2, 3]), "ones": p.ones([2]),
                "full": p.full([2], 7), "arange": p.arange(5),
                "linspace": p.linspace(0, 1, 5), "eye": p.eye(3)}
    same(body)
    assert T.arange(5).dtype == T.int64  # Paddle's integer default


def test_item_and_scalar_protocol():
    def body(p):
        x = p.to_tensor(2.5)
        assert float(x) == 2.5
        return {"item": x.item(), "int": int(p.to_tensor(3)),
                "bool": bool(p.to_tensor(True))}
    same(body)


def test_indexing_and_setitem():
    a = np.arange(12, dtype=np.float32).reshape(3, 4)

    def body(p):
        x = p.to_tensor(a)
        out = {"row": x[1], "col": x[:, 1], "block": x[1:, 2:]}
        x[0, 0] = 100.0
        m = x > 5
        assert dtype_name(m.dtype) == "bool"
        out.update(x=x, mask=m)
        return out
    same(body)


def test_inplace_version_bumps():
    def body(p):
        x = p.ones([2, 2])
        v0 = x.inplace_version
        x.zero_()
        assert x.inplace_version == v0 + 1
        z = x.numpy().copy()
        x.fill_(5.0)
        return {"zero": z, "fill": x}
    same(body)


def test_operators_match_numpy():
    r = rng(1)
    a = r.random((3, 4)).astype(np.float32)
    b = r.random((3, 4)).astype(np.float32) + 0.5

    def body(p):
        x, y = p.to_tensor(a), p.to_tensor(b)
        return {"add": x + y, "sub": x - y, "mul": x * y, "div": x / y,
                "pow": x ** 2, "rsub": 2.0 - x, "rdiv": 1.0 / y,
                "matmul": x @ y.T, "gt": x > y, "neg": -x, "abs": abs(-x)}
    same(body, rtol=1e-5)


def test_astype_cast():
    def body(p):
        x = p.to_tensor([1.7, 2.3])
        y = x.astype("int32")
        assert dtype_name(y.dtype) == "int32"
        z = p.cast(y, "float32")
        assert dtype_name(z.dtype) == "float32"
        return {"y": y, "z": z}
    same(body)


def test_clone_detach():
    def body(p):
        x = p.to_tensor([1.0, 2.0], stop_gradient=False)
        c = x.clone()
        d = x.detach()
        assert not c.stop_gradient
        assert d.stop_gradient
        return {"c": c, "d": d}
    same(body)


def test_parameter():
    for p in (J, T):
        prm = p.Parameter(np.zeros((2, 2), np.float32))
        assert not prm.stop_gradient
        assert prm.trainable
        prm.trainable = False
        assert prm.stop_gradient


def test_repr_smoke():
    assert "Tensor" in repr(J.ones([2])) and "Tensor" in repr(T.ones([2]))


def test_iteration_and_len():
    def body(p):
        x = p.to_tensor(np.arange(6).reshape(2, 3))
        assert len(x) == 2
        return {"rows": [r.numpy() for r in x]}
    same(body)


def test_tensor_hashable_identity():
    x, y = T.ones([2]), T.ones([2])
    d = {x: 1, y: 2}
    assert d[x] == 1 and d[y] == 2


# -- tests/test_autograd.py -------------------------------------------------

def test_simple_backward():
    def body(p):
        x = p.to_tensor([1.0, 2.0, 3.0], stop_gradient=False)
        (x * x).sum().backward()
        return {"g": x.grad}
    same(body)


def test_chain_and_broadcast():
    r = rng(2)
    a = r.random((3, 4)).astype(np.float32)
    b = r.random(4).astype(np.float32)

    def body(p):
        x = p.to_tensor(a, stop_gradient=False)
        y = p.to_tensor(b, stop_gradient=False)
        ((x + y) * 2.0).mean().backward()
        return {"gx": x.grad, "gy": y.grad}
    same(body)


def test_grad_accumulation_across_backwards():
    def body(p):
        x = p.to_tensor([1.0], stop_gradient=False)
        (x * 2).backward()
        (x * 3).backward()
        g = x.grad.numpy().copy()
        x.clear_grad()
        assert x.grad is None
        return {"g": g}
    same(body)


def test_multi_use_fanout():
    def body(p):
        x = p.to_tensor([2.0], stop_gradient=False)
        (x * x + x * 3).backward()
        return {"g": x.grad}
    same(body)


def test_stop_gradient_blocks():
    def body(p):
        x = p.to_tensor([1.0], stop_gradient=False)
        y = p.to_tensor([1.0], stop_gradient=True)
        (x * y).backward()
        assert y.grad is None
        return {"g": x.grad}
    same(body)


def test_detach_cuts_graph():
    def body(p):
        x = p.to_tensor([3.0], stop_gradient=False)
        z = (x * 2).detach() * x
        z.backward()
        return {"g": x.grad}
    same(body)


def test_matmul_grad_vs_numeric():
    r = rng(3)
    a = r.random((3, 4)).astype(np.float32)
    b = r.random((4, 2)).astype(np.float32)

    def body(p):
        x = p.to_tensor(a, stop_gradient=False)
        w = p.to_tensor(b, stop_gradient=False)
        p.matmul(x, w).sum().backward()
        return {"gx": x.grad, "gw": w.grad}
    same(body, rtol=1e-5)


def test_unary_grads_vs_numeric():
    a = rng(4).random(5).astype(np.float32) + 0.5

    def body(p):
        out = {}
        for name in ("tanh", "exp", "log", "sqrt", "sigmoid"):
            x = p.to_tensor(a, stop_gradient=False)
            getattr(p, name)(x).sum().backward()
            out[name] = x.grad
        return out
    same(body, rtol=1e-5)


def test_backward_non_scalar_requires_grad_tensor():
    def body(p):
        x = p.to_tensor([1.0, 2.0], stop_gradient=False)
        with pytest.raises(RuntimeError):
            (x * 2).backward()
        (x * 2).backward(p.to_tensor([1.0, 0.5]))
        return {"g": x.grad}
    same(body)


def test_retain_graph():
    def body(p):
        x = p.to_tensor([1.0], stop_gradient=False)
        y = x * x
        y.backward(retain_graph=True)
        y.backward()
        g = x.grad.numpy().copy()
        z = x * x
        z.backward()
        with pytest.raises(RuntimeError, match="retain_graph"):
            z.backward()
        return {"g": g}
    same(body)


def test_hooks():
    def body(p):
        x = p.to_tensor([1.0], stop_gradient=False)
        seen = []

        def hook(g):
            seen.append(g.numpy().copy())
            return g * 2

        y = x * 3
        y.register_hook(hook)
        (y * 5).backward()
        assert len(seen) == 1
        return {"seen": seen[0], "g": x.grad}
    same(body)


def test_leaf_hook():
    def body(p):
        x = p.to_tensor([2.0], stop_gradient=False)
        x.register_hook(lambda g: g * 10)
        (x * 1.0).backward()
        return {"g": x.grad}
    same(body)


def test_paddle_grad_api():
    def body(p):
        x = p.to_tensor([2.0], stop_gradient=False)
        (g,) = p.grad([x * x], [x])
        assert x.grad is None  # paddle.grad must not pollute .grad
        return {"g": g}
    same(body)


def test_double_grad():
    def body(p):
        x = p.to_tensor([3.0], stop_gradient=False)
        (g,) = p.grad([x * x * x], [x], create_graph=True)
        assert not g.stop_gradient
        (gg,) = p.grad([g], [x])
        return {"g": g, "gg": gg}
    same(body)


def test_no_grad_context():
    for p in (J, T):
        x = p.to_tensor([1.0], stop_gradient=False)
        with p.no_grad():
            y = x * 2
        assert y.stop_gradient

        @p.no_grad()
        def f(t):
            return t * 3

        assert f(x).stop_gradient


def test_multi_output_op_grad():
    def body(p):
        x = p.to_tensor(np.arange(6, dtype=np.float32).reshape(2, 3),
                        stop_gradient=False)
        parts = p.split(x, 3, axis=1)
        (parts[0].sum() * 1 + parts[2].sum() * 3).backward()
        return {"g": x.grad}
    same(body)


def test_setitem_grad_flows():
    def body(p):
        x = p.to_tensor([1.0, 2.0, 3.0], stop_gradient=False)
        v = p.to_tensor([10.0], stop_gradient=False)
        y = x * 1.0
        y[1] = v
        y.sum().backward()
        return {"gx": x.grad, "gv": v.grad}
    same(body)


def test_inplace_add_keeps_tape():
    def body(p):
        x = p.to_tensor([1.0], stop_gradient=False)
        y = x * 2
        y.add_(p.to_tensor([5.0]))
        y.backward()
        return {"y": y, "g": x.grad}
    same(body)


def test_nan_check_flag():
    for p in (J, T):
        p.set_flags({"FLAGS_check_nan_inf": True})
        try:
            x = p.to_tensor([-1.0], stop_gradient=False)
            with pytest.raises(
                    (FloatingPointError, p.enforce.FatalError)) as ei:
                p.log(x)
            assert "log" in str(ei.value)
        finally:
            p.set_flags({"FLAGS_check_nan_inf": False})


def test_retain_grad_for_all_tensor_flag():
    def body(p):
        p.set_flags({"FLAGS_retain_grad_for_all_tensor": True})
        try:
            x = p.to_tensor([1.0, 2.0], stop_gradient=False)
            y = x * 2
            (y * y).sum().backward()
        finally:
            p.set_flags({"FLAGS_retain_grad_for_all_tensor": False})
        z = x * 2
        (z * z).sum().backward()
        assert z.grad is None
        return {"y": y.grad, "x": x.grad}
    same(body)


# -- the verify recipe's probes ---------------------------------------------

def test_backward_on_stop_gradient_raises():
    for p in (J, T):
        with pytest.raises(RuntimeError, match="stop_gradient"):
            p.to_tensor([1.0]).sum().backward()


def test_setitem_zeroes_the_overwritten_slots_gradient():
    def body(p):
        x = p.to_tensor([1.0, 2.0, 3.0], stop_gradient=False)
        u = x * 2.0
        u[0] = 5.0
        (u * u).sum().backward()
        return {"u": u, "g": x.grad}
    rj, _ = same(body)
    assert _np(rj["g"])[0] == 0.0


def test_setitem_leaves_earlier_backward_values():
    """An op that ran before the write keeps the value it saw: its
    backward differentiates the old value (the rebinding protocol)."""
    def body(p):
        x = p.to_tensor([1.0, 2.0], stop_gradient=False)
        u = x * 1.0
        s = (u * u).sum()          # saves u = [1, 2]
        u[1] = 7.0
        (s + u.sum()).backward()
        return {"g": x.grad}
    same(body)


def test_linear_regression_converges():
    """The verify recipe's eager drive: ``Parameter`` + ``backward`` +
    ``set_value`` updates; both packages take the same steps."""
    r = rng(5)
    xs = r.standard_normal((64, 3)).astype(np.float32)
    ys = xs @ np.array([1.5, -2.0, 0.5], np.float32) + 0.25

    def body(p):
        w = p.Parameter(np.zeros(3, np.float32))
        b = p.Parameter(np.zeros((), np.float32))
        x, y = p.to_tensor(xs), p.to_tensor(ys)
        for _ in range(200):
            loss = ((p.matmul(x, w) + b - y) ** 2).mean()
            loss.backward()
            w.set_value(w - 0.1 * w.grad)
            b.set_value(b - 0.1 * b.grad)
            w.clear_grad()
            b.clear_grad()
        assert loss.item() < 1e-4
        return {"w": w, "b": b}
    same(body, rtol=1e-4, atol=1e-6)


def test_no_card_raises_naming_set_device(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    T.set_device("gpu:0")
    with pytest.raises(RuntimeError, match=r'set_device\("cpu"\)'):
        T.to_tensor([1.0])
    T.set_device("cpu")
    assert T.to_tensor([1.0]).place == T.CPUPlace()


def test_places_and_dtypes_map_to_torch():
    import torch
    assert T.float32 is torch.float32 and T.bfloat16 is torch.bfloat16
    assert T.TPUPlace(1) == T.CUDAPlace(1)
    assert T.set_device("cuda:1") == T.CUDAPlace(1)
    assert T.get_device() == "gpu:1"
    assert T.set_device(T.CPUPlace()).is_cpu_place()
    assert T.canonical_dtype(np.dtype("int8")) is torch.int8

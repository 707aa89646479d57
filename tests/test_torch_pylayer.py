"""The port's ``autograd.PyLayer`` against the JAX package's: the two
cases of ``tests/test_surface.py::TestPyLayer`` run through both packages
on the same inputs (outputs and gradients within ``1e-6``), plus the
port's ``torch.autograd.Function`` plumbing: a non-Tensor argument and
keyword, a gradient for the differentiable inputs only,
``mark_non_differentiable``, a saved tensor written in place after the
forward (torch's version check raises), and ``saved_tensors_hooks``
raising as the reference's does."""

import numpy as np
import pytest

import paddle_tpu as J
import paddle_tpu_torch as T

TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(autouse=True)
def _port_on_cpu():
    prev = T.get_device()
    T.set_device("cpu")
    yield
    T.set_device(prev)


def cube_grad(p):
    class CubeGrad(p.autograd.PyLayer):
        @staticmethod
        def forward(ctx, x):
            ctx.save_for_backward(x)
            return x * x

        @staticmethod
        def backward(ctx, g):
            (x,) = ctx.saved_tensor()
            return g * 3 * x * x  # deliberately NOT d(x^2): verify used
    return CubeGrad


def split(p):
    class Split(p.autograd.PyLayer):
        @staticmethod
        def forward(ctx, x):
            return x * 2, x * 3

        @staticmethod
        def backward(ctx, g1, g2):
            return g1 * 2 + g2 * 3
    return Split


class TestPyLayer:
    def test_custom_forward_backward(self):
        a = np.random.default_rng(0).standard_normal(5).astype(np.float32)
        res = []
        for p in (J, T):
            x = p.to_tensor(a, stop_gradient=False)
            y = cube_grad(p).apply(x)
            (y * y).sum().backward()
            res.append((y.numpy(), x.grad.numpy()))
        np.testing.assert_allclose(res[1][0], res[0][0], **TOL)
        np.testing.assert_allclose(res[1][1], res[0][1], **TOL)
        np.testing.assert_allclose(res[1][1], 2 * a * a * 3 * a * a,
                                   rtol=1e-5)

    def test_multi_output(self):
        a = np.random.default_rng(1).standard_normal(3).astype(np.float32)
        res = []
        for p in (J, T):
            x = p.to_tensor(a, stop_gradient=False)
            u, v = split(p).apply(x)
            (u.sum() + (v * v).sum()).backward()
            res.append((u.numpy(), v.numpy(), x.grad.numpy()))
        for got, want in zip(res[1], res[0]):
            np.testing.assert_allclose(got, want, **TOL)


def test_non_tensor_args_and_partial_grads():
    class Scale(T.autograd.PyLayer):
        @staticmethod
        def forward(ctx, x, w, alpha, bias=0.0):
            ctx.save_for_backward(x, w)
            ctx.alpha = alpha
            return x * w * alpha + bias

        @staticmethod
        def backward(ctx, g):
            x, w = ctx.saved_tensor()
            return g * w * ctx.alpha, g * x * ctx.alpha

    x = T.to_tensor(np.array([1.0, 2.0], np.float32), stop_gradient=False)
    w = T.to_tensor(np.array([3.0, 4.0], np.float32))     # no gradient
    y = Scale.apply(x, w, 2.0, bias=1.0)
    np.testing.assert_allclose(y.numpy(), [7.0, 17.0])
    y.sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), [6.0, 8.0])
    assert w.grad is None


def test_mark_non_differentiable_and_version_check():
    class ArgMaxAnd(T.autograd.PyLayer):
        @staticmethod
        def forward(ctx, x):
            idx = x.argmax()
            ctx.mark_non_differentiable(idx)
            ctx.save_for_backward(x)
            return x * 2, idx

        @staticmethod
        def backward(ctx, g, g_idx):
            return g * 2

    x = T.to_tensor(np.array([1.0, 5.0, 2.0], np.float32),
                    stop_gradient=False)
    y, idx = ArgMaxAnd.apply(x)
    assert idx.stop_gradient and int(idx) == 1
    y.sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), [2.0] * 3)

    z = T.to_tensor(np.ones(3, np.float32), stop_gradient=False)
    h = z * 1.0
    out = cube_grad(T).apply(h)
    h._value.mul_(2.0)               # the saved tensor changes under it
    with pytest.raises(RuntimeError):
        out.sum().backward()


def test_saved_tensors_hooks_raises_as_the_reference():
    for p in (J, T):
        with pytest.raises(NotImplementedError):
            p.autograd.saved_tensors_hooks(lambda t: t, lambda t: t)

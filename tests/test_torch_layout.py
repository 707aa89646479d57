"""The port's channels-last layout pass (``nn/layout.py``) against the JAX
package's: the ``data_format`` flip table, ``ChannelsLast``'s boundary and
its ``state_dict`` delegation, and conv nets run NHWC in each package from
the same weights.

The reference's NHWC forward equals its NCHW one bitwise on the CPU
(``tests/test_train_step.py:254-265``); the port holds each layout to
JAX's instead: a conv + BatchNorm + pool net within ``1e-5 * max|ref|``
in either layout (MobileNetV3's feature maps: ``test_torch_mobilenet.py``).
The port's own NHWC against its NCHW meets ``1e-6 * max|ref|`` on the
eval forward (the conv libraries' NHWC and NCHW kernels sum in different
orders).
"""

import numpy as np
import pytest
import torch

import paddle_tpu as J
import paddle_tpu_torch as T
from paddle_tpu_torch.models.convert import state_dict_from_jax


@pytest.fixture(autouse=True)
def _port_on_cpu():
    prev = T.get_device()
    T.set_device("cpu")
    yield
    T.set_device(prev)


def close(got, want, rtol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, f"{what}: max err {err} > {rtol} * {scale}"


def _net(P):
    nn = P.nn

    class Net(nn.Layer):
        def __init__(self):
            super().__init__()
            self.conv = nn.Conv2D(3, 8, 3, padding=1)
            self.bn = nn.BatchNorm2D(8)
            self.pool = nn.MaxPool2D(3, 2, 1)
            self.conv2 = nn.Conv2D(8, 6, 3, stride=2, groups=2)
            self.gap = nn.AdaptiveAvgPool2D((1, 1))
            self.fc = nn.Linear(6, 4)

        def forward(self, x):
            x = self.pool(P.nn.functional.relu(self.bn(self.conv(x))))
            x = self.gap(self.conv2(x))
            return self.fc(P.flatten(x, 1))

    return Net()


def _twins(seed=0):
    J.seed(seed)
    jn = _net(J)
    sd = state_dict_from_jax(jn)
    tn = _net(T)
    tn.set_state_dict(sd)
    return jn, tn, sd


X = np.random.default_rng(0).standard_normal((4, 3, 12, 12)).astype(
    np.float32)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_each_layout_matches_jax(train):
    """The same net NCHW and under ChannelsLast in both packages: outputs,
    the input gradient, the conv weight gradient and BatchNorm's running
    statistics."""
    jn, _, sd = _twins()
    got = {}
    for P in (J, T):
        for layout in ("nchw", "nhwc"):
            fresh = _net(P)
            fresh.set_state_dict(sd)
            m = P.nn.ChannelsLast(fresh) if layout == "nhwc" else fresh
            m.train() if train else m.eval()
            x = P.to_tensor(X, stop_gradient=False)
            out = m(x)
            (out * out).sum().backward()
            inner = m.net if layout == "nhwc" else m
            got[(P is T, layout)] = (out.numpy(), x.grad.numpy(),
                                     inner.conv.weight.grad.numpy(),
                                     inner.bn._mean.numpy())
    for layout in ("nchw", "nhwc"):
        for i, (a, b) in enumerate(zip(got[(False, layout)],
                                       got[(True, layout)])):
            close(b, a, 1e-5 if i == 0 else 1e-4, f"{layout} {i}")
    for i, (a, b) in enumerate(zip(got[(True, "nchw")], got[(True, "nhwc")])):
        close(b, a, 1e-6 if i == 0 and not train else 1e-4,
              f"port nhwc vs nchw {i}")


def test_flip_table_and_inverse():
    for P in (J, T):
        net = _net(P)
        P.nn.to_channels_last(net)
        assert net.conv.data_format == "NHWC"
        assert net.bn.data_format == "NHWC"
        assert net.pool.data_format == "NHWC"
        assert net.gap.data_format == "NHWC"    # None before: the rank's
        P.nn.to_channels_first(net)
        assert net.conv.data_format == "NCHW"
        assert net.gap.data_format == "NCHW"
    for cls, fmt in (("Conv1D", "NLC"), ("Conv3D", "NDHWC"),
                     ("AdaptiveMaxPool1D", "NLC")):
        args = (2, 2, 1) if cls.startswith("Conv") else (1,)
        layer = getattr(T.nn, cls)(*args)
        T.nn.to_channels_last(layer)
        assert layer.data_format == fmt


def test_state_dict_delegates_and_interchanges_with_jax():
    jn, tn, sd = _twins(seed=1)
    wrapped = T.nn.ChannelsLast(_net(T))
    assert set(wrapped.state_dict()) == set(sd)
    wrapped.set_state_dict(sd)
    for k, v in wrapped.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), sd[k], err_msg=k)
    # conv weights keep [O, I, kh, kw] under the wrapper
    assert list(wrapped.state_dict()["conv.weight"].shape) == [8, 3, 3, 3]
    jw = J.nn.ChannelsLast(_net(J))
    jw.set_state_dict({k: v.numpy() for k, v in wrapped.state_dict().items()})


def test_boundary_makes_nhwc_memory_once_and_hands_back_views():
    """ChannelsLast copies each 4-D input into NHWC memory once (outside
    the net); a 4-D output comes back NCHW as a view; inside, a conv gets
    a channels_last view, not a copy."""
    seen = []

    class Probe(T.nn.Layer):
        def __init__(self):
            super().__init__()
            self.conv = T.nn.Conv2D(3, 4, 1, bias_attr=False)

        def forward(self, d):
            seen.append(d["img"]._value)
            return self.conv(d["img"])

    m = T.nn.ChannelsLast(Probe())
    out = m({"img": T.to_tensor(X)})
    v = seen[0]
    assert list(v.shape) == [4, 12, 12, 3] and v.is_contiguous()
    assert list(out.shape) == [4, 4, 12, 12]
    assert out._value.is_contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize("P", [J, T], ids=["jax", "torch"])
def test_container_inputs_and_non4d_outputs(P):
    """Regression (reference): 4-D tensors inside list/dict inputs are
    transposed; non-4-D outputs pass through."""
    class M(P.nn.Layer):
        def __init__(self):
            super().__init__()
            self.conv = P.nn.Conv2D(3, 4, 1, bias_attr=False)

        def forward(self, d):
            return self.conv(d["img"]), P.flatten(d["img"], 1)

    P.seed(14)
    m1 = M()
    m2 = P.nn.ChannelsLast(M())
    m2.set_state_dict(m1.state_dict())
    x = P.to_tensor(X)
    a, fa = m1({"img": x})
    b, fb = m2({"img": x})
    close(b.numpy(), a.numpy(), 1e-6)
    assert fa.shape == fb.shape

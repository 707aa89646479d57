"""MobileNetV3 (``vision/models.py``), the detector's backbone, against the
JAX package's from the same weights: the ``feature_only`` backbone's
three maps in each layout (NCHW and under ``nn.ChannelsLast``) within
``1e-5 * max|ref|`` in eval, and the port's NHWC against its NCHW within
``1e-6``. Its own file: the JAX package builds and runs the net eagerly,
op by op, in about 45 s on a CPU.
"""

import numpy as np
import pytest

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


def test_mobilenet_feature_maps_per_layout_match_jax():
    """feature_only backbones return 4-D maps: handed back NCHW, and each
    layout within 1e-5 of JAX's."""
    J.seed(9)
    jm = J.vision.models.mobilenet_v3_small(feature_only=True)
    sd = state_dict_from_jax(jm)
    jm.eval()
    x = np.random.default_rng(2).standard_normal((1, 3, 64, 64)).astype(
        np.float32)
    want = [f.numpy() for f in jm(J.to_tensor(x))]
    import paddle_tpu_torch.vision.models as TM
    outs = {}
    for layout in ("nchw", "nhwc"):
        m = TM.mobilenet_v3_small(feature_only=True)
        m.set_state_dict(sd)
        if layout == "nhwc":
            m = T.nn.ChannelsLast(m)
        m.eval()
        outs[layout] = [f.numpy() for f in m(T.to_tensor(x))]
        assert len(outs[layout]) == 3
        for i, (a, b) in enumerate(zip(want, outs[layout])):
            close(b, a, 1e-5, f"{layout} level {i}")
    for a, b in zip(outs["nchw"], outs["nhwc"]):
        close(b, a, 1e-6, "port nhwc vs nchw")

"""The port's model zoo beyond ResNet-18 (``vision/models.py``) against
the JAX package's: every net's state-dict names and shapes are the
reference's (so ``state_dict_from_jax`` loads it as it is), LeNet's
forward matches from the same weights within ``1e-5 * max|ref|``,
ResNet-50 has its published parameter count, ``pretrained=True`` raises
in both, and the public names are the reference's.
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


@pytest.mark.parametrize("name,kw,shape", [
    ("LeNet", dict(num_classes=10), (2, 1, 28, 28)),
    ("resnet50", dict(num_classes=0, with_pool=False), None),
    ("vgg11", dict(num_classes=0, batch_norm=True), None),
], ids=["lenet", "resnet50-structure", "vgg11-structure"])
def test_zoo_names_shapes_and_forward(name, kw, shape):
    """Each net's state-dict names and shapes are the reference's; LeNet's
    forward matches from the same weights."""
    J.seed(1)
    jn = getattr(J.vision.models, name)(**kw)
    tn = getattr(T.vision.models, name)(**kw)
    sd = state_dict_from_jax(jn)
    assert {k: v.shape for k, v in sd.items()} == \
        {k: tuple(v.shape) for k, v in tn.state_dict().items()}
    if shape is None:
        return
    tn.set_state_dict(sd)
    x = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    close(tn(T.to_tensor(x)).numpy(), jn(J.to_tensor(x)).numpy(), 1e-5)


def test_resnet50_bottleneck_forward_shape():
    net = T.vision.models.resnet50(num_classes=7)
    out = net(T.to_tensor(np.zeros((1, 3, 64, 64), np.float32)))
    assert list(out.shape) == [1, 7]
    n = sum(int(np.prod(p.shape)) for p in
            T.vision.models.resnet50(num_classes=1000).parameters())
    assert n == 25557032          # ResNet-50's published parameter count


def test_pretrained_raises_and_exports():
    for fn in ("resnet18", "vgg16", "mobilenet_v3_small", "alexnet"):
        with pytest.raises(RuntimeError, match="pretrained"):
            getattr(T.vision.models, fn)(pretrained=True)
    for n in J.vision.models.__all__:
        assert hasattr(T.vision.models, n), n
    for n in J.vision.__all__:
        assert hasattr(T.vision, n), n


def test_make_divisible_and_mobilenet_large_structure():
    from paddle_tpu.vision.models import _make_divisible as jmd
    from paddle_tpu_torch.vision.models import _make_divisible as tmd
    for v in (3, 8, 15.5, 16 * 0.75, 72 * 1.25, 100):
        assert tmd(v) == jmd(v)
    tn = T.vision.models.mobilenet_v3_large(feature_only=True)
    assert tn._feature_cuts() == [5, 11, 14]     # the stride-8/16/32 levels
    feats = tn(T.to_tensor(np.zeros((1, 3, 64, 64), np.float32)))
    assert [list(f.shape) for f in feats] == [[1, 40, 8, 8], [1, 112, 4, 4],
                                              [1, 160, 2, 2]]

"""The port's model zoo (``vision/models.py``) against the JAX package's,
and the slice as a whole: ResNet-18 through both packages'
``make_train_step``.

Every port net loads the JAX net's ``state_dict()`` by name
(``state_dict_from_jax``): the parameter and buffer names (BatchNorm's
``_mean`` / ``_variance``) and the conv layout ``[out, in/groups, *k]``
are the reference's, so no weight is transposed. Tolerances (fp32):

* ResNet-18 at 32 x 32, B 4, train mode: the loss within ``1e-5 *
  |loss|``, every gradient within ``1e-3 * max|g|`` (both packages sit
  ~7e-5 of max|g| from an fp64 run of the same net when written, so the
  bound is the one the reference's own NHWC test sets through a BatchNorm
  stack), the running statistics within ``1e-5``;
* three Momentum steps (lr 1e-3) through ``make_train_step`` (an eager
  call, the capture, a replay), within ``1e-4 * |loss|`` each, on three
  batches of 32. At B 4 (or B 16 at lr 1e-2) the net is ill-conditioned
  in fp32 itself: BatchNorm over layer4's 1 x 1 maps cancels most of
  some gradients (layer4.0.conv1's is 21 % off its fp64 value at B 16),
  a ResNet-18 stepped on one batch of 4 memorizes it in two steps even
  at lr 1e-5, and the port's fp32 trajectory leaves its own fp64 one by
  up to 4e-2, as the JAX package's does. At B 32, lr 1e-3 it stays
  within 6e-7 of fp64 over the three steps.

The JAX net is built and run once for the module (about 40 s of the
JAX package's eager op-by-op compiles on a CPU).
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


LR = 1e-3


def _batch(rng, b):
    return (rng.standard_normal((b, 3, 32, 32)).astype(np.float32),
            rng.integers(0, 10, (b,)).astype(np.int64))


@pytest.fixture(scope="module")
def jax_resnet18():
    """The JAX ResNet-18's weights, one train-mode forward/backward on B 4
    (loss, gradients, running statistics) and three make_train_step
    losses on three batches of 32 from the same weights."""
    J.seed(0)
    jn = J.vision.models.resnet18(num_classes=10)
    sd = state_dict_from_jax(jn)
    rng = np.random.default_rng(0)
    x, y = _batch(rng, 4)
    jn.train()
    loss = J.nn.CrossEntropyLoss()(jn(J.to_tensor(x)), J.to_tensor(y))
    loss.backward()
    grads = {n: p.grad.numpy() for n, p in jn.named_parameters()}
    stats = {k: v.numpy() for k, v in jn.state_dict().items()
             if k.endswith(("_mean", "_variance"))}
    jn.set_state_dict(sd)
    jn.clear_gradients()
    opt = J.optimizer.Momentum(LR, momentum=0.9, parameters=jn.parameters())
    step = J.jit.make_train_step(jn, opt, J.nn.CrossEntropyLoss())
    batches = [_batch(rng, 32) for _ in range(3)]
    losses = [float(step(J.to_tensor(a), J.to_tensor(b)))
              for a, b in batches]
    return dict(sd=sd, x=x, y=y, loss=float(loss), grads=grads, stats=stats,
                batches=batches, losses=losses)


def test_resnet18_loss_grads_and_running_stats(jax_resnet18):
    ref = jax_resnet18
    net = T.vision.models.resnet18(num_classes=10)
    assert set(net.state_dict()) == set(ref["sd"])
    net.set_state_dict(ref["sd"])
    net.train()
    loss = T.nn.CrossEntropyLoss()(net(T.to_tensor(ref["x"])),
                                   T.to_tensor(ref["y"]))
    loss.backward()
    assert abs(float(loss) - ref["loss"]) <= 1e-5 * abs(ref["loss"])
    grads = {n: p.grad.numpy() for n, p in net.named_parameters()}
    assert set(grads) == set(ref["grads"])
    for k, g in ref["grads"].items():
        close(grads[k], g, 1e-3, k)
    for k, v in net.state_dict().items():
        if k in ref["stats"]:
            np.testing.assert_allclose(v.numpy(), ref["stats"][k], rtol=0,
                                       atol=1e-5, err_msg=k)


def test_resnet18_three_captured_momentum_steps(jax_resnet18):
    """The slice as a whole: the port's make_train_step (eager, capture,
    replay) from the JAX net's weights on the JAX run's batches."""
    ref = jax_resnet18
    net = T.vision.models.resnet18(num_classes=10)
    net.set_state_dict(ref["sd"])
    opt = T.optimizer.Momentum(LR, momentum=0.9,
                               parameters=net.parameters())
    step = T.jit.make_train_step(net, opt, T.nn.CrossEntropyLoss())
    losses = [float(step(T.to_tensor(a), T.to_tensor(b)))
              for a, b in ref["batches"]]
    assert abs(losses[0] - ref["losses"][0]) <= 1e-5 * abs(ref["losses"][0])
    for got, want in zip(losses, ref["losses"]):
        assert abs(got - want) <= 1e-4 * abs(want), (losses, ref["losses"])


def test_resnet18_channels_last_step_matches_jax(jax_resnet18):
    """The same three steps with the port's net under ChannelsLast."""
    ref = jax_resnet18
    net = T.vision.models.resnet18(num_classes=10)
    net.set_state_dict(ref["sd"])
    net = T.nn.ChannelsLast(net)
    opt = T.optimizer.Momentum(LR, momentum=0.9,
                               parameters=net.parameters())
    step = T.jit.make_train_step(net, opt, T.nn.CrossEntropyLoss())
    losses = [float(step(T.to_tensor(a), T.to_tensor(b)))
              for a, b in ref["batches"]]
    for got, want in zip(losses, ref["losses"]):
        assert abs(got - want) <= 1e-4 * abs(want), (losses, ref["losses"])

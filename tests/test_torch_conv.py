"""The port's convolutions (``nn/functional/conv.py``, ``nn/layers/conv.py``)
against the JAX package's, mirroring ``tests/test_nn.py::TestConv`` and
``tests/test_enforce.py::test_conv_channel_mismatch``.

Every case runs the same numpy inputs (seeded) through both packages'
functional; layers start from the JAX layer's weights
(``state_dict_from_jax``). Forwards and gradients at fp32 within
``1e-5 * max|ref|`` (the two convolution libraries sum in different
orders; the largest gap seen when written was 3e-7 of max|ref|). The
cases cover what the reference resolves before XLA: SAME padding at
stride 2, asymmetric pads in both spellings, groups, dilation, NHWC,
and the transposed conv's ``output_padding`` / dilation / groups /
asymmetric pads (the reference's window, which torch's own padding
cannot take past ``output_padding < max(stride, dilation)``).
"""

import numpy as np
import pytest
import torch

import paddle_tpu as J
import paddle_tpu_torch as T
from paddle_tpu_torch.models.convert import state_dict_from_jax

RTOL = 1e-5


@pytest.fixture(autouse=True)
def _port_on_cpu():
    prev = T.get_device()
    T.set_device("cpu")
    yield
    T.set_device(prev)


def close(got, want, rtol=RTOL, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, f"{what}: max err {err} > {rtol} * {scale}"


def both(fn_name, arrays, grad=True, **kw):
    """``F.<fn_name>`` of both packages on the same arrays; the outputs and
    the gradients of ``sum(out * r)`` (r a fixed random cotangent) for
    every float input compared."""
    outs, grads = [], []
    for P in (J, T):
        ts = [P.to_tensor(a, stop_gradient=not grad) if a is not None
              else None for a in arrays]
        out = getattr(P.nn.functional, fn_name)(*ts, **kw)
        outs.append(out.numpy())
        if grad:
            r = np.random.default_rng(7).standard_normal(
                out.shape).astype(np.float32)
            (out * P.to_tensor(r)).sum().backward()
            grads.append([t.grad.numpy() for t in ts if t is not None])
    close(outs[1], outs[0], what=f"{fn_name} out")
    for i, (gj, gt) in enumerate(zip(*grads) if grad else ()):
        close(gt, gj, what=f"{fn_name} grad {i}")
    return outs[1]


RNG = np.random.default_rng(0)


def _x(*shape):
    return RNG.standard_normal(shape).astype(np.float32)


CONV2D_CASES = [
    # the reference's TestConv legs
    dict(stride=1, padding=0, dilation=1, groups=1),
    dict(stride=2, padding=1, dilation=1, groups=1),
    dict(stride=1, padding=2, dilation=2, groups=1),
    dict(stride=1, padding=1, dilation=1, groups=2),
    dict(stride=1, padding="SAME", dilation=1, groups=1),
    # XLA's SAME at stride 2 (torch's padding="same" refuses it), with
    # groups and dilation
    dict(stride=2, padding="SAME", dilation=2, groups=2),
    dict(stride=2, padding="VALID", dilation=1, groups=1),
    # asymmetric pads, both spellings
    dict(stride=1, padding=[[1, 2], [0, 3]], dilation=1, groups=2),
    dict(stride=(2, 1), padding=[1, 2, 0, 3], dilation=1, groups=1),
]


@pytest.mark.parametrize("kw", CONV2D_CASES, ids=lambda kw: "-".join(
    f"{k}{v}" for k, v in kw.items()).replace(" ", ""))
def test_conv2d(kw):
    x, w, b = _x(2, 4, 9, 11), _x(6, 4 // kw["groups"], 3, 3), _x(6)
    both("conv2d", [x, w, b], **kw)


def test_conv2d_nhwc_matches_nchw():
    """NHWC runs the channels-first conv on a permuted view; its output is
    the NCHW output permuted, within the conv's own rounding (the
    reference's NHWC and NCHW are bitwise on the CPU; here they are within
    1e-6 of max|ref|)."""
    x, w, b = _x(2, 4, 9, 11), _x(6, 2, 3, 3), _x(6)
    xh = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    got = both("conv2d", [xh, w, b], padding=1, groups=2, stride=2,
               data_format="NHWC")
    nchw = T.nn.functional.conv2d(T.to_tensor(x), T.to_tensor(w),
                                  T.to_tensor(b), padding=1, groups=2,
                                  stride=2).numpy()
    close(got.transpose(0, 3, 1, 2), nchw, rtol=1e-6)


def test_conv1d_3d():
    both("conv1d", [_x(2, 3, 16), _x(5, 3, 3), None], padding=1)
    both("conv1d", [_x(2, 10, 3), _x(5, 3, 3), _x(5)], stride=2,
         padding="SAME", data_format="NLC")
    both("conv3d", [_x(1, 2, 5, 6, 7), _x(4, 2, 3, 3, 3), None])
    both("conv3d", [_x(1, 2, 5, 6, 7), _x(4, 1, 3, 3, 3), _x(4)], stride=2,
         padding=[1, 0, 2, 1, 0, 1], groups=2)


CONVT_CASES = [
    # the reference's TestConv transposed legs
    dict(stride=1, padding=0, output_padding=0),
    dict(stride=2, padding=1, output_padding=0),
    dict(stride=2, padding=1, output_padding=1),
    # groups, dilation, and output_padding past torch's own limit
    dict(stride=2, padding=1, output_padding=1, groups=2),
    dict(stride=2, padding=0, output_padding=1, groups=2, dilation=2),
    dict(stride=1, padding=1, output_padding=2, dilation=1),
    dict(stride=2, padding=3, output_padding=1, groups=2),
    dict(stride=2, padding=[1, 2, 0, 1], groups=2),
    dict(stride=3, padding=[[0, 2], [1, 0]], output_padding=2, dilation=2),
]


@pytest.mark.parametrize("kw", CONVT_CASES, ids=lambda kw: "-".join(
    f"{k}{v}" for k, v in kw.items()).replace(" ", ""))
def test_conv2d_transpose(kw):
    g = kw.get("groups", 1)
    x, w, b = _x(2, 4, 7, 6), _x(4, 6 // g, 3, 3), _x(6)
    both("conv2d_transpose", [x, w, b], **kw)


def test_conv_transpose_1d_3d_and_nhwc():
    both("conv1d_transpose", [_x(2, 4, 9), _x(4, 3, 3), None], stride=2,
         padding=1, output_padding=1)
    both("conv3d_transpose", [_x(1, 2, 3, 4, 5), _x(2, 3, 2, 2, 2), _x(3)],
         stride=2)
    both("conv2d_transpose", [_x(2, 7, 6, 4), _x(4, 3, 3, 3), _x(6)],
         stride=2, padding=1, output_padding=1, groups=2,
         data_format="NHWC")


def test_conv_transpose_string_padding_raises_as_reference():
    for P in (J, T):
        with pytest.raises(Exception):
            P.nn.functional.conv2d_transpose(
                P.to_tensor(_x(1, 2, 4, 4)), P.to_tensor(_x(2, 2, 3, 3)),
                stride=2, padding="SAME")


def test_conv_transpose_output_size_accepted_not_applied():
    x, w = _x(1, 2, 4, 4), _x(2, 3, 3, 3)
    got = both("conv2d_transpose", [x, w, None], stride=2, padding=1,
               output_size=[9, 9])
    assert got.shape == (1, 3, 7, 7)


def test_depthwise_and_fusion():
    x = _x(2, 4, 8, 8)
    both("depthwise_conv2d", [x, _x(4, 1, 3, 3), _x(4)], padding=1)
    both("depthwise_conv2d_transpose", [x, _x(4, 1, 3, 3), None], stride=2)
    both("conv2d_fusion", [x, _x(6, 4, 3, 3), _x(6), _x(2, 6, 8, 8)],
         padding=1)
    both("conv2d_fusion", [x, _x(6, 4, 1, 1), None, None],
         activation="sigmoid")


LAYERS = [
    ("Conv1D", (3, 5, 3), dict(stride=2, padding=1), (2, 3, 11)),
    ("Conv2D", (4, 6, 3), dict(padding=1, groups=2), (2, 4, 8, 8)),
    ("Conv3D", (2, 4, 2), dict(stride=2), (1, 2, 6, 6, 6)),
    ("Conv1DTranspose", (3, 4, 3), dict(stride=2, output_padding=1),
     (2, 3, 5)),
    ("Conv2DTranspose", (4, 6, 3), dict(stride=2, padding=1, groups=2),
     (2, 4, 5, 5)),
    ("Conv3DTranspose", (2, 3, 2), dict(stride=2), (1, 2, 3, 3, 3)),
]


@pytest.mark.parametrize("cls,args,kw,shape", LAYERS,
                         ids=[c[0] for c in LAYERS])
def test_layers_from_jax_weights(cls, args, kw, shape):
    """Parameter names and shapes are the reference's ([out, in/groups, *k];
    transposed [in, out/groups, *k]), so the JAX layer's state_dict loads
    as it is, and the layers agree forward and backward."""
    J.seed(3)
    jl = getattr(J.nn, cls)(*args, **kw)
    tl = getattr(T.nn, cls)(*args, **kw)
    sd = state_dict_from_jax(jl)
    assert {k: v.shape for k, v in sd.items()} == \
        {k: tuple(v.shape) for k, v in tl.state_dict().items()}
    tl.set_state_dict(sd)
    x = _x(*shape)
    outs = []
    for P, layer in ((J, jl), (T, tl)):
        xt = P.to_tensor(x, stop_gradient=False)
        out = layer(xt)
        out.sum().backward()
        outs.append((out.numpy(), xt.grad.numpy(), layer.weight.grad.numpy()))
    for i, (a, b) in enumerate(zip(*outs)):
        close(b, a, what=f"{cls} {i}")


def test_layer_init_matches_reference_distribution():
    """KaimingUniform(fan_in, sqrt(5)) weight, Uniform(+-1/sqrt(fan_in))
    bias (the reference's initializers; the draws differ by RNG)."""
    T.seed(0)
    c = T.nn.Conv2D(16, 32, 3)
    fan_in = 16 * 9
    bound = 1.0 / np.sqrt(fan_in)
    w = c.weight.numpy()
    assert np.abs(w).max() <= np.sqrt(6.0 / ((1 + 5.0) * fan_in)) + 1e-7
    assert np.abs(c.bias.numpy()).max() <= bound + 1e-7
    assert T.nn.Conv2D(4, 4, 1, bias_attr=False).bias is None


def test_conv_channel_mismatch_is_enforce_error():
    """tests/test_enforce.py::test_conv_channel_mismatch: a typed error
    naming the user's line."""
    from paddle_tpu_torch.core.enforce import EnforceNotMet
    conv = T.nn.Conv2D(3, 8, 3)
    with pytest.raises(EnforceNotMet) as ei:
        conv(T.to_tensor(np.zeros((1, 5, 16, 16), np.float32)))
    assert "test_torch_conv.py" in str(ei.value)
    assert "conv2d" in str(ei.value)


def test_conv_is_on_amp_white_list():
    """Under auto_cast the conv runs at bf16 (the white list names it), as
    the reference's."""
    x, w = _x(1, 3, 6, 6), _x(4, 3, 3, 3)
    outs = []
    for P in (J, T):
        with P.amp.auto_cast(dtype="bfloat16"):
            out = P.nn.functional.conv2d(P.to_tensor(x), P.to_tensor(w),
                                         padding=1)
        assert "bfloat16" in str(out.dtype)
        outs.append(np.asarray(out.astype("float32").numpy()))
    close(outs[1], outs[0], rtol=2e-2, what="bf16 conv")


def test_registered_under_reference_names():
    from paddle_tpu_torch.core.dispatch import OP_REGISTRY
    for n in ("conv1d", "conv2d", "conv3d", "conv2d_transpose",
              "depthwise_conv2d", "conv2d_fusion"):
        assert n in OP_REGISTRY, n


def test_nhwc_conv_makes_no_copy_of_its_input():
    """A contiguous NHWC input reaches the conv as a channels-first view of
    the same memory (torch.channels_last), not a copy."""
    seen = []
    real = torch.nn.functional.conv2d

    def spy(v, *a, **k):
        seen.append(v)
        return real(v, *a, **k)

    import paddle_tpu_torch.nn.functional.conv as C
    xh = T.to_tensor(_x(2, 5, 5, 4))
    C._CONV[2] = spy
    try:
        T.nn.functional.conv2d(xh, T.to_tensor(_x(6, 4, 3, 3)), padding=1,
                               data_format="NHWC")
    finally:
        C._CONV[2] = real
    v = seen[0]
    assert v.data_ptr() == xh._value.data_ptr()
    assert v.is_contiguous(memory_format=torch.channels_last)

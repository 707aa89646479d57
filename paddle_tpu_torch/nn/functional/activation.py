"""Activation functionals — counterpart of
``paddle_tpu/nn/functional/activation.py``: each maps to a torch
primitive."""

from __future__ import annotations

import torch
import torch.nn.functional as TF

from ...core.dtype import canonical_dtype
from ...ops._helpers import ensure_tensor, forward_op, unary_factory
from ...ops.random import generator

relu = unary_factory("relu", torch.relu)
relu6 = unary_factory("relu6", TF.relu6)
sigmoid = unary_factory("sigmoid", torch.sigmoid)
tanh = unary_factory("tanh", torch.tanh)
silu = unary_factory("silu", TF.silu)
swish = silu
mish = unary_factory("mish", TF.mish)
softsign = unary_factory("softsign", TF.softsign)
tanhshrink = unary_factory("tanhshrink", lambda x: x - torch.tanh(x))
hardswish = unary_factory("hardswish", TF.hardswish)
hardsigmoid = unary_factory("hardsigmoid",
                            lambda x: torch.clamp(x / 6.0 + 0.5, 0.0, 1.0))


def gelu(x, approximate=False, name=None):
    x = ensure_tensor(x)
    mode = "tanh" if approximate else "none"
    return forward_op("gelu", lambda v: TF.gelu(v, approximate=mode), [x])


def leaky_relu(x, negative_slope=0.01, name=None):
    return forward_op("leaky_relu",
                      lambda v: TF.leaky_relu(v, negative_slope),
                      [ensure_tensor(x)])


def elu(x, alpha=1.0, name=None):
    return forward_op("elu", lambda v: TF.elu(v, alpha), [ensure_tensor(x)])


def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772, name=None):
    return forward_op("selu",
                      lambda v: scale * torch.where(v > 0, v,
                                                    alpha * torch.expm1(v)),
                      [ensure_tensor(x)])


def celu(x, alpha=1.0, name=None):
    return forward_op("celu", lambda v: TF.celu(v, alpha), [ensure_tensor(x)])


def hardtanh(x, min=-1.0, max=1.0, name=None):  # noqa: A002
    return forward_op("hardtanh", lambda v: torch.clamp(v, min, max),
                      [ensure_tensor(x)])


def hardshrink(x, threshold=0.5, name=None):
    return forward_op("hardshrink",
                      lambda v: torch.where(v.abs() > threshold, v,
                                            torch.zeros_like(v)),
                      [ensure_tensor(x)])


def softshrink(x, threshold=0.5, name=None):
    return forward_op(
        "softshrink",
        lambda v: torch.where(v > threshold, v - threshold,
                              torch.where(v < -threshold, v + threshold,
                                          torch.zeros_like(v))),
        [ensure_tensor(x)])


def softplus(x, beta=1.0, threshold=20.0, name=None):
    return forward_op(
        "softplus",
        lambda v: torch.where(v * beta > threshold, v,
                              torch.log1p(torch.exp(beta * v)) / beta),
        [ensure_tensor(x)])


def logsigmoid(x, name=None):
    return forward_op("logsigmoid", TF.logsigmoid, [ensure_tensor(x)])


log_sigmoid = logsigmoid


def softmax(x, axis=-1, dtype=None, name=None):
    x = ensure_tensor(x)
    dt = canonical_dtype(dtype)

    def impl(v):
        if dt is not None:
            v = v.to(dt)
        return torch.softmax(v, dim=int(axis))

    return forward_op("softmax", impl, [x])


def log_softmax(x, axis=-1, dtype=None, name=None):
    x = ensure_tensor(x)
    dt = canonical_dtype(dtype)

    def impl(v):
        if dt is not None:
            v = v.to(dt)
        return torch.log_softmax(v, dim=int(axis))

    return forward_op("log_softmax", impl, [x])


def _gumbel(v):
    u = torch.empty(v.shape, dtype=v.dtype, device=v.device).uniform_(
        generator=generator(v.device))
    tiny = torch.finfo(v.dtype).tiny
    return -torch.log(-torch.log(u.clamp(min=tiny)).clamp(min=tiny))


def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1, name=None):
    x = ensure_tensor(x)
    g = _gumbel(x._value)

    def impl(v):
        y = torch.softmax((v + g) / temperature, dim=int(axis))
        if hard:  # straight-through: hard value, soft gradient
            idx = torch.argmax(y, dim=int(axis), keepdim=True)
            y_hard = torch.zeros_like(y).scatter(int(axis), idx, 1.0)
            y = y_hard - y.detach() + y
        return y

    return forward_op("gumbel_softmax", impl, [x])


def prelu(x, weight, data_format="NCHW", name=None):
    x, weight = ensure_tensor(x), ensure_tensor(weight)

    def impl(v, w):
        if w.numel() > 1:
            ch_axis = 1 if data_format == "NCHW" else v.dim() - 1
            shape = [1] * v.dim()
            shape[ch_axis] = w.numel()
            w = w.reshape(shape)
        return torch.where(v >= 0, v, w * v)

    return forward_op("prelu", impl, [x, weight])


def rrelu(x, lower=0.125, upper=0.3333333333333333, training=False, name=None):
    x = ensure_tensor(x)
    if training:
        v = x._value
        slope = torch.empty(v.shape, dtype=v.dtype, device=v.device).uniform_(
            lower, upper, generator=generator(v.device))
        return forward_op("rrelu", lambda v: torch.where(v >= 0, v, v * slope),
                          [x])
    mid = (lower + upper) / 2.0
    return forward_op("rrelu", lambda v: torch.where(v >= 0, v, v * mid), [x])


def glu(x, axis=-1, name=None):
    return forward_op("glu", lambda v: TF.glu(v, dim=int(axis)),
                      [ensure_tensor(x)])


def maxout(x, groups, axis=1, name=None):
    x = ensure_tensor(x)

    def impl(v):
        ax = axis % v.dim()
        c = v.shape[ax]
        new_shape = tuple(v.shape[:ax]) + (c // groups, groups) + \
            tuple(v.shape[ax + 1:])
        return torch.amax(v.reshape(new_shape), dim=ax + 1)

    return forward_op("maxout", impl, [x])


def stanh(x, scale_a=0.67, scale_b=1.7159, name=None):
    return forward_op("stanh", lambda v: scale_b * torch.tanh(scale_a * v),
                      [ensure_tensor(x)])


def thresholded_relu(x, threshold=1.0, value=0.0, name=None):
    return forward_op("thresholded_relu",
                      lambda v: torch.where(v > threshold, v,
                                            torch.full_like(v, value)),
                      [ensure_tensor(x)])

"""Weight initializers — counterpart of ``paddle_tpu/nn/initializer.py``
(Constant, Normal, TruncatedNormal, Uniform, XavierNormal/Uniform,
KaimingNormal/Uniform, Assign, Orthogonal, Dirac, calculate_gain).

Each writes the Parameter's value through ``Tensor.set_value`` (a leaf
stays a leaf), drawing from the global generator of the parameter's
device (``ops/random.py``), so ``paddle.seed`` makes init deterministic.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core.tensor import Tensor, as_torch
from ..ops.random import generator

__all__ = ["Initializer", "Constant", "Normal", "TruncatedNormal", "Uniform",
           "XavierNormal", "XavierUniform", "KaimingNormal", "KaimingUniform",
           "Assign", "Orthogonal", "Dirac", "calculate_gain", "set_global_initializer"]


def _fans(shape):
    shape = tuple(shape)
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    # conv kernels: paddle layout [out_c, in_c, *spatial]
    receptive = int(np.prod(shape[2:]))
    return shape[1] * receptive, shape[0] * receptive


def _normal(param, mean, std):
    v = param._value
    z = torch.randn(v.shape, generator=generator(v.device), device=v.device,
                    dtype=torch.float32)
    return param.set_value(mean + std * z)


def _uniform(param, low, high):
    v = param._value
    u = torch.empty(v.shape, device=v.device, dtype=torch.float32).uniform_(
        low, high, generator=generator(v.device))
    return param.set_value(u)


class Initializer:
    def __call__(self, param: Tensor, block=None):
        raise NotImplementedError


class Constant(Initializer):
    def __init__(self, value: float = 0.0):
        self.value = value

    def __call__(self, param, block=None):
        return param.set_value(torch.full_like(param._value, self.value))


class Normal(Initializer):
    def __init__(self, mean: float = 0.0, std: float = 1.0):
        self.mean, self.std = mean, std

    def __call__(self, param, block=None):
        return _normal(param, self.mean, self.std)


class TruncatedNormal(Initializer):
    """Truncated at ±2σ (paddle default a=-2,b=2)."""

    def __init__(self, mean: float = 0.0, std: float = 1.0, a: float = -2.0,
                 b: float = 2.0):
        self.mean, self.std, self.a, self.b = mean, std, a, b

    def __call__(self, param, block=None):
        v = param._value
        z = torch.empty(v.shape, device=v.device, dtype=torch.float32)
        # inverse-CDF draw between the bounds, from the global generator
        lo = 0.5 * (1 + math.erf(self.a / math.sqrt(2)))
        hi = 0.5 * (1 + math.erf(self.b / math.sqrt(2)))
        z.uniform_(lo, hi, generator=generator(v.device))
        z = torch.special.ndtri(z).clamp_(self.a, self.b)
        return param.set_value(self.mean + self.std * z)


class Uniform(Initializer):
    def __init__(self, low: float = -1.0, high: float = 1.0):
        self.low, self.high = low, high

    def __call__(self, param, block=None):
        return _uniform(param, self.low, self.high)


class XavierNormal(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain: float = 1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, param, block=None):
        fi, fo = _fans(param.shape)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        return _normal(param, 0.0, self.gain * math.sqrt(2.0 / (fi + fo)))


class XavierUniform(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain: float = 1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, param, block=None):
        fi, fo = _fans(param.shape)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        limit = self.gain * math.sqrt(6.0 / (fi + fo))
        return _uniform(param, -limit, limit)


class KaimingNormal(Initializer):
    def __init__(self, fan_in=None, negative_slope: float = 0.0,
                 nonlinearity: str = "relu"):
        self.fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def __call__(self, param, block=None):
        fi, _ = _fans(param.shape)
        fi = self.fan_in if self.fan_in is not None else fi
        gain = calculate_gain(self.nonlinearity, self.negative_slope)
        return _normal(param, 0.0, gain / math.sqrt(fi))


class KaimingUniform(Initializer):
    def __init__(self, fan_in=None, negative_slope: float = 0.0,
                 nonlinearity: str = "relu"):
        self.fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def __call__(self, param, block=None):
        fi, _ = _fans(param.shape)
        fi = self.fan_in if self.fan_in is not None else fi
        gain = calculate_gain(self.nonlinearity, self.negative_slope)
        limit = gain * math.sqrt(3.0 / fi)
        return _uniform(param, -limit, limit)


class Assign(Initializer):
    def __init__(self, value):
        self.value = value

    def __call__(self, param, block=None):
        v = as_torch(self.value, device=param.place)
        return param.set_value(v.reshape(param._value.shape))


class Orthogonal(Initializer):
    def __init__(self, gain: float = 1.0):
        self.gain = gain

    def __call__(self, param, block=None):
        v = param._value
        rows, cols = v.shape[0], int(np.prod(v.shape[1:]))
        flat = torch.randn((max(rows, cols), min(rows, cols)),
                           generator=generator(v.device), device=v.device)
        q, r = torch.linalg.qr(flat)
        q = q * torch.sign(torch.diagonal(r))
        q = q.T if rows < cols else q
        return param.set_value((self.gain * q[:rows, :cols]).reshape(v.shape))


class Dirac(Initializer):
    """Identity-preserving conv kernel init (ref: paddle.nn.initializer.Dirac)."""

    def __init__(self, groups: int = 1):
        self.groups = groups

    def __call__(self, param, block=None):
        shape = tuple(param.shape)  # [out_c, in_c, *spatial]
        v = np.zeros(shape, np.float32)
        out_c, in_c = shape[0], shape[1]
        centers = tuple(s // 2 for s in shape[2:])
        per = out_c // self.groups
        for g in range(self.groups):
            for i in range(min(per, in_c)):
                v[(g * per + i, i) + centers] = 1.0
        return param.set_value(v)


def calculate_gain(nonlinearity: str, param=None) -> float:
    recipes = {
        "sigmoid": 1.0, "linear": 1.0, "conv1d": 1.0, "conv2d": 1.0, "conv3d": 1.0,
        "conv_transpose1d": 1.0, "conv_transpose2d": 1.0, "conv_transpose3d": 1.0,
        "tanh": 5.0 / 3.0, "relu": math.sqrt(2.0),
        "selu": 3.0 / 4.0,
    }
    if nonlinearity == "leaky_relu":
        slope = 0.01 if param is None else param
        return math.sqrt(2.0 / (1 + slope ** 2))
    if nonlinearity in recipes:
        return recipes[nonlinearity]
    raise ValueError(f"unknown nonlinearity {nonlinearity}")


_global_weight_init = None
_global_bias_init = None


def set_global_initializer(weight_init, bias_init=None):
    global _global_weight_init, _global_bias_init
    _global_weight_init, _global_bias_init = weight_init, bias_init

"""paddle.nn.utils — counterpart of ``paddle_tpu/nn/utils.py``
(python/paddle/nn/utils/ in Paddle): ``parameters_to_vector`` /
``vector_to_parameters``, and the weight and spectral normalizations as
forward pre-hooks that rebuild the weight from its reparametrization on
every call, so gradients reach the new parameters.

``spectral_norm`` keeps its power-iteration vector ``u`` as a buffer on
the weight's device and updates it there each forward (the reference
reads it back to the host every call). Its first draw comes from the
port's generator of that device (``ops/random.py``).
"""

from __future__ import annotations

import math

import torch

from ..core.tensor import Parameter, Tensor, _wrap
from ..ops._helpers import forward_op
from .clip import clip_grad_norm_  # noqa: F401

__all__ = ["clip_grad_norm_", "parameters_to_vector", "vector_to_parameters",
           "weight_norm", "remove_weight_norm", "spectral_norm"]


def parameters_to_vector(parameters, name=None) -> Tensor:
    """The parameters flattened and concatenated into one 1-D Tensor."""
    params = list(parameters)
    return forward_op("parameters_to_vector",
                      lambda *vs: torch.cat([v.reshape(-1) for v in vs]),
                      params)


def vector_to_parameters(vec: Tensor, parameters, name=None):
    """Write consecutive slices of ``vec`` into ``parameters`` (in place,
    on their device)."""
    offset = 0
    for p in parameters:
        n = math.prod(p.shape)
        p.set_value(vec._value[offset:offset + n].reshape(p._value.shape))
        offset += n


def _norm_except(v, dim):
    axes = tuple(i for i in range(v.dim()) if i != dim)
    return torch.linalg.vector_norm(v, dim=axes, keepdim=True)


def weight_norm(layer, name="weight", dim=0):
    """Reparametrize ``weight = g * v / ||v||`` (norms over every axis but
    ``dim``): ``weight`` leaves the parameters, ``weight_g`` and
    ``weight_v`` join them, and a forward pre-hook rebuilds ``weight``."""
    w = getattr(layer, name)
    g = Parameter(_norm_except(w._value.detach(), dim).clone())
    v = Parameter(w._value.detach().clone())
    # the original weight is replaced by the reparametrization (Paddle
    # deletes it at set-up too)
    del layer._parameters[name]
    layer.add_parameter(name + "_g", g)
    layer.add_parameter(name + "_v", v)

    def compute():
        return forward_op(
            "weight_norm",
            lambda vv, gv: vv * (gv / torch.clamp(_norm_except(vv, dim),
                                                  min=1e-12)), [v, g])

    def hook(lay, inputs):
        object.__setattr__(lay, name, compute())

    object.__setattr__(layer, name, compute())
    layer._weight_norm_hook = layer.register_forward_pre_hook(hook)
    return layer


def remove_weight_norm(layer, name="weight"):
    """Fold ``g * v / ||v||`` back into one ``weight`` parameter."""
    hook = layer.__dict__.pop("_weight_norm_hook", None)
    if hook is not None:
        hook.remove()
    g = layer._parameters.pop(name + "_g", None)
    v = layer._parameters.pop(name + "_v", None)
    if g is not None and v is not None:
        gv, vv = g._value.detach(), v._value.detach()
        axes = tuple(i for i in range(vv.dim()) if gv.shape[i] == 1)
        norm = torch.linalg.vector_norm(vv, dim=axes, keepdim=True)
        layer.__dict__.pop(name, None)   # the computed weight
        layer._parameters[name] = Parameter(gv * vv / torch.clamp(norm,
                                                                  min=1e-12))
    return layer


def spectral_norm(layer, name="weight", n_power_iterations=1, eps=1e-12,
                  dim=None):
    """``weight / sigma``, sigma the largest singular value of the weight
    as a matrix ``[shape[dim], -1]``, estimated by ``n_power_iterations``
    steps of power iteration each forward from the buffer ``weight_u``."""
    from ..ops.random import generator
    w = getattr(layer, name)
    dim = 0 if dim is None else dim
    h = w.shape[dim]
    dev = w._value.device
    u0 = torch.randn((h,), generator=generator(dev), device=dev,
                     dtype=torch.float32)
    layer.register_buffer(name + "_u", _wrap(u0 / torch.linalg.vector_norm(u0)))
    orig = Parameter(w._value.detach().clone())
    del layer._parameters[name]       # replaced by the reparametrization
    layer.add_parameter(name + "_orig", orig)

    def impl(wv, uv):
        # the graph keeps a copy: the buffer itself is written below
        uv = uv.clone()
        wm = torch.movedim(wv, dim, 0).reshape(h, -1)
        for _ in range(n_power_iterations):
            vv = wm.T @ uv
            vv = vv / torch.clamp(torch.linalg.vector_norm(vv), min=eps)
            uv = wm @ vv
            uv = uv / torch.clamp(torch.linalg.vector_norm(uv), min=eps)
        return wv / (uv @ wm @ vv), uv

    def hook(lay, inputs):
        u = getattr(lay, name + "_u")
        new_w, new_u = forward_op("spectral_norm_reparam", impl, [orig, u])
        with torch.no_grad():
            u._value.copy_(new_u._value)       # on the device, no host read
        object.__setattr__(lay, name, new_w)

    object.__setattr__(layer, name, _wrap(w._value.detach()))
    layer.register_forward_pre_hook(hook)
    return layer

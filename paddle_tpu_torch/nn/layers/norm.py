"""Norm layers — counterpart of ``paddle_tpu/nn/layers/norm.py``
(python/paddle/nn/layer/norm.py in Paddle). ``RMSNorm`` reaches the
RMSNorm kernel through ``functional.rms_norm`` on a card."""

from __future__ import annotations

import numpy as np
import torch

from ...core.place import torch_device
from ...core.tensor import Tensor
from .. import functional as F
from .. import initializer as I
from ..layer import Layer


class _BatchNormBase(Layer):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, data_format="NCHW", use_global_stats=None,
                 name=None):
        super().__init__()
        self.num_features = num_features
        self.momentum = momentum
        self.epsilon = epsilon
        self.data_format = data_format
        self.use_global_stats = use_global_stats
        self.weight = self.create_parameter(
            [num_features], attr=weight_attr, default_initializer=I.Constant(1.0))
        self.bias = self.create_parameter([num_features], attr=bias_attr,
                                          is_bias=True)
        self.register_buffer("_mean", Tensor(torch.zeros(
            num_features, dtype=torch.float32, device=torch_device())))
        self.register_buffer("_variance", Tensor(torch.ones(
            num_features, dtype=torch.float32, device=torch_device())))

    def forward(self, x):
        return F.batch_norm(x, self._mean, self._variance, self.weight, self.bias,
                            training=self.training, momentum=self.momentum,
                            epsilon=self.epsilon, data_format=self.data_format,
                            use_global_stats=self.use_global_stats)

    def extra_repr(self):
        return f"num_features={self.num_features}, momentum={self.momentum}"


class BatchNorm(_BatchNormBase):
    """Legacy paddle.nn.BatchNorm (acts like 2-D by default)."""

    def __init__(self, num_channels, act=None, momentum=0.9, epsilon=1e-5,
                 param_attr=None, bias_attr=None, data_layout="NCHW",
                 use_global_stats=None, **kwargs):
        super().__init__(num_channels, momentum, epsilon, param_attr, bias_attr,
                         data_layout, use_global_stats)
        self._act = act

    def forward(self, x):
        out = super().forward(x)
        if self._act:
            out = getattr(F, self._act)(out)
        return out


class BatchNorm1D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, data_format="NCL", use_global_stats=None, name=None):
        super().__init__(num_features, momentum, epsilon, weight_attr, bias_attr,
                         data_format, use_global_stats)


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, data_format="NCDHW", use_global_stats=None,
                 name=None):
        super().__init__(num_features, momentum, epsilon, weight_attr, bias_attr,
                         data_format, use_global_stats)


class SyncBatchNorm(_BatchNormBase):
    """Cross-replica batch norm (ref: paddle.nn.SyncBatchNorm). In one
    process it is BatchNorm; the cross-process statistics come with the
    distributed eager wrappers (ROADMAP §A item 11)."""

    @classmethod
    def convert_sync_batchnorm(cls, layer):
        if isinstance(layer, _BatchNormBase) and not isinstance(layer, cls):
            new = cls(layer.num_features, layer.momentum, layer.epsilon,
                      data_format=layer.data_format)
            new.weight.set_value(layer.weight.numpy())
            new.bias.set_value(layer.bias.numpy())
            new._mean.set_value(layer._mean.numpy())
            new._variance.set_value(layer._variance.numpy())
            return new
        for name, sub in list(layer._sub_layers.items()):
            layer._sub_layers[name] = cls.convert_sync_batchnorm(sub)
        return layer


class LayerNorm(Layer):
    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, name=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self.normalized_shape = list(normalized_shape)
        self.epsilon = epsilon
        if weight_attr is False:
            self.weight = None
        else:
            self.weight = self.create_parameter(
                self.normalized_shape, attr=weight_attr,
                default_initializer=I.Constant(1.0))
        if bias_attr is False:
            self.bias = None
        else:
            self.bias = self.create_parameter(self.normalized_shape, attr=bias_attr,
                                              is_bias=True)

    def forward(self, x):
        return F.layer_norm(x, self.normalized_shape, self.weight, self.bias,
                            self.epsilon)

    def extra_repr(self):
        return f"normalized_shape={self.normalized_shape}"


class RMSNorm(Layer):
    """RMSNorm layer (ref capability: paddle.incubate fused_rms_norm); the
    kernel route of ``functional.rms_norm``."""

    def __init__(self, hidden_size, epsilon=1e-6, weight_attr=None, name=None):
        super().__init__()
        self.epsilon = epsilon
        self.weight = self.create_parameter(
            [hidden_size], attr=weight_attr, default_initializer=I.Constant(1.0))

    def forward(self, x):
        return F.rms_norm(x, self.weight, self.epsilon)


class GroupNorm(Layer):
    def __init__(self, num_groups, num_channels, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, data_format="NCHW", name=None):
        super().__init__()
        self.num_groups = num_groups
        self.num_channels = num_channels
        self.epsilon = epsilon
        self.data_format = data_format
        self.weight = None if weight_attr is False else self.create_parameter(
            [num_channels], attr=weight_attr, default_initializer=I.Constant(1.0))
        self.bias = None if bias_attr is False else self.create_parameter(
            [num_channels], attr=bias_attr, is_bias=True)

    def forward(self, x):
        return F.group_norm(x, self.num_groups, self.epsilon, self.weight, self.bias,
                            self.data_format)


class _InstanceNormBase(Layer):
    def __init__(self, num_features, epsilon=1e-5, momentum=0.9, weight_attr=None,
                 bias_attr=None, data_format="NCHW", name=None):
        super().__init__()
        self.epsilon = epsilon
        self.data_format = data_format
        if weight_attr is False:
            self.weight = None
            self.bias = None
        else:
            self.weight = self.create_parameter(
                [num_features], attr=weight_attr, default_initializer=I.Constant(1.0))
            self.bias = self.create_parameter([num_features], attr=bias_attr,
                                              is_bias=True)

    def forward(self, x):
        return F.instance_norm(x, weight=self.weight, bias=self.bias,
                               eps=self.epsilon, data_format=self.data_format)


class InstanceNorm1D(_InstanceNormBase):
    pass


class InstanceNorm2D(_InstanceNormBase):
    pass


class InstanceNorm3D(_InstanceNormBase):
    pass


class LocalResponseNorm(Layer):
    def __init__(self, size, alpha=1e-4, beta=0.75, k=1.0, data_format="NCHW",
                 name=None):
        super().__init__()
        self.size = size
        self.alpha = alpha
        self.beta = beta
        self.k = k
        self.data_format = data_format

    def forward(self, x):
        return F.local_response_norm(x, self.size, self.alpha, self.beta, self.k,
                                     self.data_format)


class SpectralNorm(Layer):
    def __init__(self, weight_shape, dim=0, power_iters=1, epsilon=1e-12, name=None):
        super().__init__()
        self.dim = dim
        self.power_iters = power_iters
        self.epsilon = epsilon
        h = weight_shape[dim]
        w = int(np.prod(weight_shape)) // h
        self.weight_u = self.create_parameter(
            [h], default_initializer=I.Normal(0.0, 1.0))
        self.weight_u.stop_gradient = True
        self.weight_v = self.create_parameter(
            [w], default_initializer=I.Normal(0.0, 1.0))
        self.weight_v.stop_gradient = True

    def forward(self, weight):
        return F.spectral_norm(weight, self.weight_u, self.weight_v, self.dim,
                               self.power_iters, self.epsilon)

"""Conv layers — counterpart of ``paddle_tpu/nn/layers/conv.py``
(python/paddle/nn/layer/conv.py in Paddle): the reference's parameter
names, shapes (``[out, in/groups, *k]``; transposed ``[in, out/groups,
*k]``), initializers and ``data_format``, so a JAX net's ``state_dict``
loads as it is."""

from __future__ import annotations

import numpy as np

from .. import functional as F
from .. import initializer as I
from ..layer import Layer


def _ntuple(v, n):
    return (int(v),) * n if isinstance(v, (int, np.integer)) else tuple(int(x) for x in v)


class _ConvNd(Layer):
    def __init__(self, rank, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 transpose=False, output_padding=0):
        super().__init__()
        self._rank = rank
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.kernel_size = _ntuple(kernel_size, rank)
        self.stride = stride
        self.padding = padding
        self.dilation = dilation
        self.groups = groups
        self.padding_mode = padding_mode
        self.data_format = data_format
        self.output_padding = output_padding
        self._transpose = transpose
        if transpose:
            w_shape = [in_channels, out_channels // groups, *self.kernel_size]
        else:
            w_shape = [out_channels, in_channels // groups, *self.kernel_size]
        fan_in = (in_channels // groups) * int(np.prod(self.kernel_size))
        self.weight = self.create_parameter(
            w_shape, attr=weight_attr,
            default_initializer=I.KaimingUniform(fan_in=fan_in,
                                                 negative_slope=np.sqrt(5.0),
                                                 nonlinearity="leaky_relu"))
        bound = 1.0 / np.sqrt(fan_in)
        self.bias = self.create_parameter(
            [out_channels], attr=bias_attr, is_bias=True,
            default_initializer=I.Uniform(-bound, bound))

    def extra_repr(self):
        return (f"{self.in_channels}, {self.out_channels}, "
                f"kernel_size={list(self.kernel_size)}, stride={self.stride}")


class Conv1D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1, padding=0,
                 dilation=1, groups=1, padding_mode="zeros", weight_attr=None,
                 bias_attr=None, data_format="NCL"):
        super().__init__(1, in_channels, out_channels, kernel_size, stride, padding,
                         dilation, groups, padding_mode, weight_attr, bias_attr,
                         data_format)

    def forward(self, x):
        return F.conv1d(x, self.weight, self.bias, self.stride, self.padding,
                        self.dilation, self.groups, self.data_format)


class Conv2D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1, padding=0,
                 dilation=1, groups=1, padding_mode="zeros", weight_attr=None,
                 bias_attr=None, data_format="NCHW"):
        super().__init__(2, in_channels, out_channels, kernel_size, stride, padding,
                         dilation, groups, padding_mode, weight_attr, bias_attr,
                         data_format)

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, self.stride, self.padding,
                        self.dilation, self.groups, self.data_format)


class Conv3D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1, padding=0,
                 dilation=1, groups=1, padding_mode="zeros", weight_attr=None,
                 bias_attr=None, data_format="NCDHW"):
        super().__init__(3, in_channels, out_channels, kernel_size, stride, padding,
                         dilation, groups, padding_mode, weight_attr, bias_attr,
                         data_format)

    def forward(self, x):
        return F.conv3d(x, self.weight, self.bias, self.stride, self.padding,
                        self.dilation, self.groups, self.data_format)


class Conv1DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1, padding=0,
                 output_padding=0, groups=1, dilation=1, weight_attr=None,
                 bias_attr=None, data_format="NCL"):
        super().__init__(1, in_channels, out_channels, kernel_size, stride, padding,
                         dilation, groups, "zeros", weight_attr, bias_attr,
                         data_format, transpose=True, output_padding=output_padding)

    def forward(self, x, output_size=None):
        return F.conv1d_transpose(x, self.weight, self.bias, self.stride,
                                  self.padding, self.output_padding, self.groups,
                                  self.dilation, self.data_format, output_size)


class Conv2DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1, padding=0,
                 output_padding=0, dilation=1, groups=1, weight_attr=None,
                 bias_attr=None, data_format="NCHW"):
        super().__init__(2, in_channels, out_channels, kernel_size, stride, padding,
                         dilation, groups, "zeros", weight_attr, bias_attr,
                         data_format, transpose=True, output_padding=output_padding)

    def forward(self, x, output_size=None):
        return F.conv2d_transpose(x, self.weight, self.bias, self.stride,
                                  self.padding, self.output_padding, self.groups,
                                  self.dilation, self.data_format, output_size)


class Conv3DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1, padding=0,
                 output_padding=0, dilation=1, groups=1, weight_attr=None,
                 bias_attr=None, data_format="NCDHW"):
        super().__init__(3, in_channels, out_channels, kernel_size, stride, padding,
                         dilation, groups, "zeros", weight_attr, bias_attr,
                         data_format, transpose=True, output_padding=output_padding)

    def forward(self, x, output_size=None):
        return F.conv3d_transpose(x, self.weight, self.bias, self.stride,
                                  self.padding, self.output_padding, self.groups,
                                  self.dilation, self.data_format, output_size)

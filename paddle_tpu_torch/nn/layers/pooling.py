"""Pooling layers — counterpart of ``paddle_tpu/nn/layers/pooling.py``
(python/paddle/nn/layer/pooling.py in Paddle). Each layer keeps a
``data_format`` the layout pass (``nn/layout.py``) flips."""

from __future__ import annotations

from .. import functional as F
from ..layer import Layer


class _Pool(Layer):
    _fn = None
    _default_fmt = "NCHW"

    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 return_mask=False, exclusive=True, divisor_override=None,
                 data_format=None, name=None):
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding
        self.ceil_mode = ceil_mode
        self.return_mask = return_mask
        self.exclusive = exclusive
        self.divisor_override = divisor_override
        self.data_format = data_format or self._default_fmt

    def forward(self, x):
        fn = getattr(F, self._fn)
        kwargs = dict(stride=self.stride, padding=self.padding,
                      ceil_mode=self.ceil_mode, data_format=self.data_format)
        if self._fn.startswith("max"):
            kwargs["return_mask"] = self.return_mask
        else:
            kwargs["exclusive"] = self.exclusive
            kwargs["divisor_override"] = self.divisor_override
        return fn(x, self.kernel_size, **kwargs)


class MaxPool1D(_Pool):
    _fn = "max_pool1d"
    _default_fmt = "NCL"


class MaxPool2D(_Pool):
    _fn = "max_pool2d"


class MaxPool3D(_Pool):
    _fn = "max_pool3d"
    _default_fmt = "NCDHW"


class AvgPool1D(_Pool):
    _fn = "avg_pool1d"
    _default_fmt = "NCL"


class AvgPool2D(_Pool):
    _fn = "avg_pool2d"


class AvgPool3D(_Pool):
    _fn = "avg_pool3d"
    _default_fmt = "NCDHW"


class _AdaptivePool(Layer):
    _fn = None

    def __init__(self, output_size, return_mask=False, data_format=None, name=None):
        super().__init__()
        self.output_size = output_size
        self.return_mask = return_mask
        self.data_format = data_format

    def forward(self, x):
        fn = getattr(F, self._fn)
        if self._fn.startswith("adaptive_max"):
            # data_format is not part of the reference AdaptiveMaxPool API,
            # but the layout pass (nn/layout.py) sets it on the layer — the
            # functional accepts it, so it must flow through here too
            return fn(x, self.output_size, return_mask=self.return_mask,
                      data_format=self.data_format)
        return fn(x, self.output_size, data_format=self.data_format)


class AdaptiveAvgPool1D(_AdaptivePool):
    _fn = "adaptive_avg_pool1d"


class AdaptiveAvgPool2D(_AdaptivePool):
    _fn = "adaptive_avg_pool2d"


class AdaptiveAvgPool3D(_AdaptivePool):
    _fn = "adaptive_avg_pool3d"


class AdaptiveMaxPool1D(_AdaptivePool):
    _fn = "adaptive_max_pool1d"


class AdaptiveMaxPool2D(_AdaptivePool):
    _fn = "adaptive_max_pool2d"


class AdaptiveMaxPool3D(_AdaptivePool):
    _fn = "adaptive_max_pool3d"

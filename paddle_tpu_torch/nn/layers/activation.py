"""Activation layers — counterpart of ``paddle_tpu/nn/layers/activation.py``
(python/paddle/nn/layer/activation.py in Paddle)."""

from __future__ import annotations

from .. import functional as F
from .. import initializer as I
from ..layer import Layer


def _wrap(fname, **fixed):
    class _Act(Layer):
        def __init__(self, *args, **kwargs):
            super().__init__()
            self._kwargs = dict(fixed)
            # positional args map onto the functional's named params in order
            fn = getattr(F, fname)
            import inspect
            params = [p for p in inspect.signature(fn).parameters if p not in ("x", "name")]
            for n, v in zip(params, args):
                self._kwargs[n] = v
            self._kwargs.update({k: v for k, v in kwargs.items() if k != "name"})

        def forward(self, x):
            return getattr(F, fname)(x, **self._kwargs)

    _Act.__name__ = fname.title().replace("_", "")
    return _Act


ReLU = _wrap("relu")
ReLU6 = _wrap("relu6")
Sigmoid = _wrap("sigmoid")
Tanh = _wrap("tanh")
GELU = _wrap("gelu")
SiLU = _wrap("silu")
Swish = _wrap("swish")
Mish = _wrap("mish")
Hardswish = _wrap("hardswish")
Hardsigmoid = _wrap("hardsigmoid")
Hardtanh = _wrap("hardtanh")
Hardshrink = _wrap("hardshrink")
Softshrink = _wrap("softshrink")
Softplus = _wrap("softplus")
Softsign = _wrap("softsign")
Tanhshrink = _wrap("tanhshrink")
LogSigmoid = _wrap("log_sigmoid")
ELU = _wrap("elu")
CELU = _wrap("celu")
SELU = _wrap("selu")
LeakyReLU = _wrap("leaky_relu")
Softmax = _wrap("softmax")
LogSoftmax = _wrap("log_softmax")
Maxout = _wrap("maxout")
ThresholdedReLU = _wrap("thresholded_relu")
GLU = _wrap("glu")


class RReLU(Layer):
    """Needs self.training forwarded (random slopes only while training)."""

    def __init__(self, lower=0.125, upper=1.0 / 3.0, name=None):
        super().__init__()
        self.lower = lower
        self.upper = upper

    def forward(self, x):
        return F.rrelu(x, self.lower, self.upper, training=self.training)


class PReLU(Layer):
    def __init__(self, num_parameters=1, init=0.25, weight_attr=None,
                 data_format="NCHW", name=None):
        super().__init__()
        self.data_format = data_format
        self.weight = self.create_parameter(
            [num_parameters], attr=weight_attr,
            default_initializer=I.Constant(init))

    def forward(self, x):
        return F.prelu(x, self.weight, self.data_format)

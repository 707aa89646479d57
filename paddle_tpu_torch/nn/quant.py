"""``paddle.nn.quant`` — counterpart of ``paddle_tpu/nn/quant.py``: the
weight-only int8 inference surface (ref:
``python/paddle/nn/quant/quantized_linear.py``).

:class:`WeightOnlyLinear` holds int8 weights with per-output-column
scales; its forward is ``ops.quant.weight_only_linear``, which on a CUDA
tensor launches ``csrc/quant_matmul.cu`` (``weight_only_matmul``) and on
a CPU tensor runs that wrapper's plain version. :func:`quantize_linears`
swaps every ``nn.Linear`` of a model in place.
"""

from __future__ import annotations

from ..ops._helpers import ensure_tensor
from ..ops.quant import weight_only_linear, weight_quantize
from .layer import Layer

__all__ = ["WeightOnlyLinear", "quantize_linears"]


class WeightOnlyLinear(Layer):
    """Inference Linear with int8 weights ``[in, out]`` and per-output-
    channel scales (ref: paddle.nn.quant.WeightOnlyLinear)."""

    def __init__(self, weight, scale, bias=None, weight_dtype="int8"):
        super().__init__()
        self.weight = ensure_tensor(weight)
        self.weight_scale = ensure_tensor(scale)
        self.bias = ensure_tensor(bias) if bias is not None else None
        self.weight_dtype = weight_dtype
        self.in_features = int(self.weight.shape[0])
        self.out_features = int(self.weight.shape[1])

    @classmethod
    def from_linear(cls, linear) -> "WeightOnlyLinear":
        q, s = weight_quantize(linear.weight)
        return cls(q, s, linear.bias)

    def forward(self, x):
        return weight_only_linear(x, self.weight, self.weight_scale,
                                  bias=self.bias,
                                  weight_dtype=self.weight_dtype)

    def extra_repr(self):
        return (f"in_features={self.in_features}, "
                f"out_features={self.out_features}, int8")


def quantize_linears(model: Layer, min_features: int = 1) -> int:
    """Swap every ``nn.Linear`` sublayer for a :class:`WeightOnlyLinear`
    in place; returns the count swapped. ``min_features`` skips
    projections with fewer input features."""
    from .layers.common import Linear
    swapped = 0

    def walk(layer):
        nonlocal swapped
        for key, sub in list(layer._sub_layers.items()):
            if isinstance(sub, Linear) and sub.in_features >= min_features:
                layer._sub_layers[key] = WeightOnlyLinear.from_linear(sub)
                swapped += 1
            else:
                walk(sub)
    walk(model)
    return swapped

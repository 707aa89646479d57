"""The channels-last layout pass — counterpart of
``paddle_tpu/nn/layout.py``.

The pass converts a conv net to run channels-last inside while its
callers keep Paddle's NCHW contract:

* every layout-bearing layer's ``data_format`` is flipped in place
  (``NCL``→``NLC``, ``NCHW``→``NHWC``, ``NCDHW``→``NDHWC``; an adaptive
  pool's ``None`` by the rank its functional names); no weight is
  permuted, so ``state_dict``s interchange with the NCHW net;
* :class:`ChannelsLast` wraps the converted net: each 4-D input is made
  NHWC in memory once at the boundary (one copy a step, outside the
  net), each 4-D output is permuted back to NCHW as a view.

Inside, an NHWC conv or pool hands cuDNN its input as a channels-first
view of that NHWC memory (``torch.channels_last``), so the card runs its
NHWC kernels, and the result comes back NHWC without a copy
(``functional/conv.py``). Elementwise layers and BatchNorm keep the
layout they are given.

Scope, as the reference's: nets whose cross-layout dataflow is
per-channel (conv, norm, pooling, activations, elementwise) and whose
flattens come after global pooling — ResNet, VGG without its classifier
reshape, MobileNet. A net that reshapes spatial maps mid-way (a
detection head) needs its reshapes made layout-aware first.
"""

from __future__ import annotations

from typing import Any

from ..core.tensor import Tensor
from ..ops._helpers import forward_op
from .layer import Layer

__all__ = ["ChannelsLast", "to_channels_last", "to_channels_first"]

_TO_LAST = {"NCL": "NLC", "NCHW": "NHWC", "NCDHW": "NDHWC"}
_TO_FIRST = {v: k for k, v in _TO_LAST.items()}
# adaptive pools default data_format=None (channels-first); the rank
# comes from the functional they dispatch to
_RANK_LAST = {"1d": "NLC", "2d": "NHWC", "3d": "NDHWC"}


def _flip(layer: Layer, table) -> int:
    n = 0
    for sub in layer.sublayers(include_self=True):
        df = getattr(sub, "data_format", "missing")
        if df == "missing":
            continue
        if isinstance(df, str) and df in table:
            sub.data_format = table[df]
            n += 1
        elif df is None and table is _TO_LAST:
            fn = getattr(sub, "_fn", "") or ""
            for suffix, fmt in _RANK_LAST.items():
                if fn.endswith(suffix):
                    sub.data_format = fmt
                    n += 1
                    break
    return n


def to_channels_last(layer: Layer) -> Layer:
    """In place: flip every layout-bearing sublayer to channels-last.
    Returns the same layer."""
    _flip(layer, _TO_LAST)
    return layer


def to_channels_first(layer: Layer) -> Layer:
    """Inverse of :func:`to_channels_last` (e.g. before ``jit.save`` of
    an NCHW inference artifact)."""
    _flip(layer, _TO_FIRST)
    return layer


def _nhwc(x):
    # NHWC in memory: the one copy of the boundary
    return forward_op("transpose", lambda v: v.permute(0, 2, 3, 1)
                      .contiguous(), [x])


def _nchw(x):
    return forward_op("transpose", lambda v: v.permute(0, 3, 1, 2), [x])


def _map_spatial(obj: Any, fn):
    if isinstance(obj, Tensor):
        return fn(obj) if obj.ndim == 4 else obj
    if isinstance(obj, dict):
        return {k: _map_spatial(v, fn) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_map_spatial(v, fn) for v in obj)
    return obj


class ChannelsLast(Layer):
    """Boundary wrapper: NCHW in, NCHW out, channels-last inside.

        net = ChannelsLast(resnet50())      # converts in place and wraps
        loss = loss_fn(net(x_nchw), y)      # convs run on cuDNN's NHWC kernels

    4-D inputs (also inside lists and dicts) become NHWC once a call;
    4-D outputs (``feature_only`` backbones' maps) are handed back NCHW;
    other outputs (logits) pass through. ``state_dict`` /
    ``set_state_dict`` delegate to the wrapped net, so checkpoints
    interchange with the NCHW model.
    """

    def __init__(self, net: Layer):
        super().__init__()
        self.net = to_channels_last(net)

    def forward(self, *inputs):
        ins = [_map_spatial(x, _nhwc) for x in inputs]
        return _map_spatial(self.net(*ins), _nchw)

    # checkpoint interchange with the unwrapped NCHW model
    def state_dict(self, *args, **kwargs):
        return self.net.state_dict(*args, **kwargs)

    def set_state_dict(self, state_dict, *args, **kwargs):
        return self.net.set_state_dict(state_dict, *args, **kwargs)

    set_dict = set_state_dict
    load_dict = set_state_dict

"""auto_cast, the op lists and ``decorate`` — counterpart of
``paddle_tpu/amp/auto_cast.py`` (ref: ``python/paddle/amp/auto_cast.py``
and ``amp_lists.py``).

White ops (matmul and convolution class: fast and safe in low precision)
take their fp32 inputs cast to the AMP dtype; black ops (reductions,
transcendentals, norms: they want fp32 accumulation) take their
low-precision inputs cast back to fp32. Under O2 every op outside the
black list casts. The cast is the hook of ``core.dispatch.forward_op``:
it rewrites an op's input values before the op runs, on every route of
``forward_op`` (a distributed region included, per coordinate), and
``Tensor.to``'s backward casts the gradient back to the input's dtype.

The compute dtype defaults to bfloat16, as in the reference. The flash
kernels take fp32 and bf16 only (``nn.functional.attention.flash_route``),
so under ``dtype="float16"`` attention runs the plain formula.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional, Set

import torch

__all__ = ["WHITE_LIST", "BLACK_LIST", "white_list", "black_list",
           "auto_cast", "autocast", "amp_guard", "decorate",
           "amp_cast_inputs", "amp_active", "is_float16_supported",
           "is_bfloat16_supported"]

# -- op lists (keyed by forward_op names; the reference's own) ---------------

WHITE_LIST: Set[str] = {
    "matmul", "mm", "bmm", "linear", "einsum", "conv1d", "conv2d", "conv3d",
    "conv1d_transpose", "conv2d_transpose", "conv3d_transpose", "addmm",
    "scaled_dot_product_attention", "flash_attention", "llama_forward",
    "llama_loss",
}

BLACK_LIST: Set[str] = {
    "exp", "expm1", "log", "log2", "log10", "log1p", "pow", "square", "sqrt",
    "rsqrt", "softmax", "log_softmax", "logsumexp", "cross_entropy",
    "softmax_with_cross_entropy", "binary_cross_entropy",
    "binary_cross_entropy_with_logits", "nll_loss", "kl_div", "cosh", "sinh",
    "tan", "asin", "acos", "atan", "mean", "sum", "prod", "cumsum", "cumprod",
    "norm", "p_norm", "var", "std", "renorm", "erfinv", "logit",
    "layer_norm", "batch_norm", "instance_norm", "group_norm", "rms_norm",
}

_LOW = (torch.bfloat16, torch.float16)


def white_list():
    return frozenset(WHITE_LIST)


def black_list():
    return frozenset(BLACK_LIST)


class _AmpState(threading.local):
    def __init__(self):
        self.enable = False
        self.dtype = torch.bfloat16
        self.level = "O1"
        self.white: Set[str] = set()
        self.black: Set[str] = set()


_amp_state = _AmpState()


def _cast_val(v, dtype):
    if isinstance(v, torch.Tensor) and v.dtype == torch.float32:
        return v.to(dtype)
    return v


def _uncast_val(v):
    if isinstance(v, torch.Tensor) and v.dtype in _LOW:
        return v.to(torch.float32)
    return v


def amp_cast_inputs(name: str, vals):
    """The dispatcher hook: ``vals`` (an op's raw input values) rewritten
    for op ``name`` under the active auto_cast state."""
    st = _amp_state
    if not st.enable:
        return vals
    if name in st.black:
        return [_uncast_val(v) for v in vals]      # fp32 islands
    if name in st.white or st.level == "O2":
        return [_cast_val(v, st.dtype) for v in vals]
    return vals


def amp_active() -> bool:
    return _amp_state.enable


_DTYPES = {"float16": torch.float16, "bfloat16": torch.bfloat16,
           "float32": torch.float32}


@contextlib.contextmanager
def auto_cast(enable: bool = True, custom_white_list=None,
              custom_black_list=None, level: str = "O1",
              dtype: str = "bfloat16", use_promote: bool = True):
    """``paddle.amp.auto_cast``: O1 casts the white list, O2 every op but
    the black list; O0 is off and OD is O1. ``dtype`` defaults to
    bfloat16."""
    if level not in ("O0", "O1", "O2", "OD"):
        raise ValueError(f"auto_cast level must be O0/O1/O2/OD, got {level!r}")
    if dtype not in _DTYPES:
        raise ValueError(f"auto_cast dtype must be one of {list(_DTYPES)}")
    st = _amp_state
    prev = (st.enable, st.dtype, st.level, st.white, st.black)
    st.enable = bool(enable) and level != "O0"
    st.dtype = _DTYPES[dtype]
    st.level = "O1" if level == "OD" else level
    st.white = (WHITE_LIST | set(custom_white_list or ())) - \
        set(custom_black_list or ())
    st.black = BLACK_LIST | set(custom_black_list or ())
    try:
        yield
    finally:
        (st.enable, st.dtype, st.level, st.white, st.black) = prev


autocast = auto_cast
amp_guard = auto_cast  # legacy alias (paddle.fluid.dygraph.amp.amp_guard)


def _capability(device):
    """The CUDA compute capability of ``device`` (a Place, a string, a
    torch device; the current place when None), or None for the CPU."""
    from ..core.place import torch_device
    dev = torch_device(device)
    if dev.type == "cpu":
        return None
    return torch.cuda.get_device_capability(dev)


def is_float16_supported(device=None) -> bool:
    """Whether ``device`` computes in float16: the CPU does (PyTorch's CPU
    kernels take half), a card from compute capability 5.3 on."""
    cap = _capability(device)
    return cap is None or cap >= (5, 3)


def is_bfloat16_supported(device=None) -> bool:
    """Whether ``device`` computes in bfloat16: the CPU does, a card from
    compute capability 8.0 (Ampere) on."""
    cap = _capability(device)
    return cap is None or cap >= (8, 0)


def decorate(models, optimizers=None, level: str = "O2", dtype: str = "bfloat16",
             master_weight: Optional[bool] = None, save_dtype: Optional[str] = None,
             master_grad: bool = False, excluded_layers=None):
    """``paddle.amp.decorate``: O2 casts the models' fp32 parameters to
    ``dtype`` (norm layers and ``excluded_layers`` stay fp32) and gives
    the optimizers fp32 master weights (``_multi_precision``)."""
    from ..nn.layer import Layer
    from ..nn.layers.norm import BatchNorm1D, BatchNorm2D, BatchNorm3D, \
        LayerNorm

    if level not in ("O1", "O2"):
        raise ValueError(f"decorate level must be O1 or O2, got {level!r}")
    target = _DTYPES[dtype]
    model_list = models if isinstance(models, (list, tuple)) else [models]
    excluded = tuple(excluded_layers or ())
    if level == "O2":
        for m in model_list:
            if not isinstance(m, Layer):
                raise TypeError(f"decorate expects nn.Layer, got {type(m)}")
            for layer in m.sublayers(include_self=True):
                if excluded and isinstance(layer, excluded):
                    continue
                if isinstance(layer, (LayerNorm, BatchNorm1D, BatchNorm2D,
                                      BatchNorm3D)):
                    continue   # norm layers stay fp32 (reference behavior)
                for p in layer.parameters(include_sublayers=False):
                    if p._value.dtype == torch.float32:
                        p._replace(p._value.to(target), cast=True)
    if optimizers is not None:
        opt_list = optimizers if isinstance(optimizers, (list, tuple)) \
            else [optimizers]
        use_master = master_weight if master_weight is not None \
            else (level == "O2")
        for opt in opt_list:
            opt._multi_precision = bool(use_master)
    if optimizers is None:
        return models
    return models, optimizers

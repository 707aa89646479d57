"""PyTorch/CUDA port of ``paddle_tpu`` (``import paddle_tpu_torch as paddle``).

The package keeps the JAX package's module layout so every module has a
counterpart a reader can find, and imports only ``torch`` and numpy —
never ``jax`` and nothing of ``paddle_tpu``. It holds:

* the eager framework core: ``Tensor`` / ``Parameter`` / ``to_tensor``
  over PyTorch's autograd, the op surface (``core/``, ``ops/``), ``nn``
  (``Layer`` and its first layers, ``nn.functional``), the optimizers,
  and ``incubate.nn.functional``'s fused callers;
* the functional LLaMA model (``models/llama.py``) — its train steps
  (dense, sharded, pipelined, context- and expert-parallel) and the eager
  ``LlamaForCausalLM`` — with generation, the paged serving engine and
  its fleet, front end and tensor-parallel tier (``inference/serving``);
* fault tolerance (checkpoints, the health ladder, the DataLoader) and
  the distributed launcher;
* ``amp`` (``auto_cast``, ``GradScaler``), ``autograd.PyLayer``, the
  high-level API (``Model`` and ``summary``, ``metric``, ``callbacks``),
  BERT's layers and the parameter-server tables
  (``distributed/ps.py``);
* ``vision`` (conv and pooling in ``nn``, the channels-last layout
  pass, the model zoo with ResNet and MobileNetV3, datasets,
  transforms, the box and NMS ops and the PP-YOLOE detector);
* the whole op library of the reference (special functions, windows,
  sets, sequences, CRF and beam decoding, the legacy ops, the rest of
  linalg and quant, the in-place family) and the ``linalg``, ``fft`` and
  ``signal`` namespaces;
* ``static`` (the Program / Executor workflow over the dispatcher's
  tape) and ``sparse`` (COO / CSR tensors, their math, the sparse
  convolutions with a rulebook built on the device, sparse attention);
* ``jit`` (``to_static`` as a captured CUDA graph, the fused
  ``TrainStep``, dy2static and SOT, ``jit.save`` / ``jit.load`` through
  ``torch.export``), the deployment ``inference.Predictor`` and
  ``profiler``;
* the hand-written CUDA C++ kernels for Hopper (``csrc/``: paged
  attention, the int8 matmul, flash attention forward and backward,
  RMSNorm, RoPE), built with ``nvcc`` at first use (``kernels/build.py``).

The eager tier places tensors on ``gpu:0`` by default; on a host with no
card the first tensor raises until ``paddle.set_device("cpu")``. The
functional entry points take an explicit ``device`` and run on ``cuda``
unless the caller passes ``device="cpu"``
(:func:`paddle_tpu_torch.device.resolve_device`). Heavy submodules load
lazily (PEP 562), so the serving path's ``import`` stays light.
"""

from __future__ import annotations

import importlib

__version__ = "0.1.0"

from .device import resolve_device
from .flags import get_flags, set_flags
from .core.dtype import (bfloat16, bool_ as bool8, canonical_dtype, complex64,
                         complex128, dtype, finfo, float16, float32, float64,
                         get_default_dtype, iinfo, int8, int16, int32, int64,
                         promote_types, set_default_dtype, uint8)
from .core.place import (CPUPlace, CUDAPlace, Place, TPUPlace, XPUPlace,
                         get_device, is_compiled_with_cuda, is_compiled_with_tpu,
                         is_compiled_with_xpu, set_device)
from .core.tensor import Parameter, Tensor, to_tensor
from .core.autograd import enable_grad, grad, is_grad_enabled, no_grad, set_grad_enabled
from .core.dispatch import OP_REGISTRY
from .core import enforce  # typed-error layer (PADDLE_ENFORCE parity)
from .ops import *  # noqa: F401,F403 — the tensor op surface
from .ops import __all__ as _ops_all
from .ops import seed  # paddle.seed is the RNG seed

_LAZY_SUBMODULES = (
    "nn", "optimizer", "io", "distributed", "framework", "incubate",
    "kernels", "regularizer", "inference", "models", "testing", "health",
    "amp", "autograd", "metric", "callbacks", "hapi", "jit", "profiler",
    "vision", "linalg", "fft", "signal", "static", "sparse",
)


def __getattr__(name):
    if name in _LAZY_SUBMODULES:
        mod = importlib.import_module(f".{name}", __name__)
        globals()[name] = mod
        return mod
    # paddle.save/load live in framework.io
    if name in ("save", "load"):
        mod = importlib.import_module(".framework.io", __name__)
        fn = getattr(mod, name)
        globals()[name] = fn
        return fn
    if name == "summary":
        from .hapi import summary as fn
        globals()[name] = fn
        return fn
    if name == "Model":
        from .hapi import Model as cls
        globals()[name] = cls
        return cls
    if name in ("enable_static", "disable_static"):
        return getattr(importlib.import_module(".static", __name__), name)
    raise AttributeError(f"module 'paddle_tpu_torch' has no attribute {name!r}")


def in_dynamic_mode() -> bool:
    """False while ``paddle.enable_static()`` holds."""
    from .static import in_static_mode
    return not in_static_mode()


def is_grad_enabled_():
    return is_grad_enabled()


# numpy-style dtype aliases used throughout reference scripts
bool = bool8  # noqa: A001

"""The eager framework core — counterpart of ``paddle_tpu/core``: dtypes,
places, typed errors, grad mode, the ``Tensor`` and the op dispatcher."""

from . import autograd, dispatch, dtype, place
from .autograd import enable_grad, grad, is_grad_enabled, no_grad, set_grad_enabled
from .dispatch import OP_REGISTRY, forward_op, register_op
from .dtype import (bfloat16, bool_, canonical_dtype, complex64, complex128, float16,
                    float32, float64, get_default_dtype, int8, int16, int32, int64,
                    set_default_dtype, uint8)
from .place import (CPUPlace, CUDAPlace, Place, TPUPlace, XPUPlace, get_device,
                    set_device)
from .tensor import Parameter, Tensor, to_tensor

"""The port's kernels: hand-written CUDA C++ for Hopper (``csrc/``), each
wrapped beside its plain PyTorch version (counterpart of
``paddle_tpu/kernels``). Importing this package builds nothing; a kernel
is compiled at its first launch (``build.py``)."""

from .flash_attention import flash_attention, flash_attention_with_lse
from .paged_attention import paged_attention
from .quant_matmul import weight_only_matmul
from .rms_norm import rms_norm
from .rope import apply_rope

__all__ = ["apply_rope", "flash_attention", "flash_attention_with_lse",
           "paged_attention", "rms_norm", "weight_only_matmul"]

"""``paddle.jit`` — dynamic-to-static compilation (counterpart of
``paddle_tpu/jit``): a program is a captured CUDA graph (``trace.py``),
``jit.save`` writes a ``torch.export`` program (``api.py``)."""

from .api import (InputSpec, StaticFunction, TranslatedLayer, enable_to_static,
                  fallbacks, ignore_module, load, not_to_static, save,
                  to_static)
from .control_flow import cond, fori_loop, scan, while_loop
from .train_step import TrainStep, donation_supported, jit_step, make_train_step
from . import dy2static

__all__ = ["InputSpec", "StaticFunction", "TranslatedLayer", "enable_to_static",
           "ignore_module", "load", "not_to_static", "save", "to_static",
           "cond", "fori_loop", "scan", "while_loop",
           "TrainStep", "make_train_step", "jit_step", "donation_supported",
           "fallbacks"]

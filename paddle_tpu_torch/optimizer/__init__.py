"""paddle.optimizer — counterpart of ``paddle_tpu/optimizer``: the
optimizer classes, ``lr`` and the functional update rules ``ops`` (also
``optimizer_ops``, the reference's name)."""

from . import lr
from . import ops
from . import ops as optimizer_ops
from .optimizer import (ASGD, LBFGS, SGD, Adadelta, Adagrad, Adam, Adamax,
                        AdamW, Lamb, Momentum, NAdam, Optimizer, RAdam,
                        RMSProp, Rprop)

__all__ = ["lr", "SGD", "Momentum", "Adam", "AdamW", "Adamax", "Adagrad",
           "RMSProp", "Lamb", "Optimizer", "Adadelta", "Rprop", "NAdam",
           "RAdam", "ASGD", "LBFGS"]

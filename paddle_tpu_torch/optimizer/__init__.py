"""paddle.optimizer — counterpart of ``paddle_tpu/optimizer``. The
reference's functional ``optimizer.ops`` are ROADMAP §A item 11."""

from . import lr
from .optimizer import (ASGD, LBFGS, SGD, Adadelta, Adagrad, Adam, Adamax,
                        AdamW, Lamb, Momentum, NAdam, Optimizer, RAdam,
                        RMSProp, Rprop)

__all__ = ["lr", "SGD", "Momentum", "Adam", "AdamW", "Adamax", "Adagrad",
           "RMSProp", "Lamb", "Optimizer", "Adadelta", "Rprop", "NAdam",
           "RAdam", "ASGD", "LBFGS"]

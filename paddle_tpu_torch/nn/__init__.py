"""paddle.nn — counterpart of ``paddle_tpu/nn``: ``Layer``, ``ParamAttr``,
the initializers, gradient clipping, and the layers ported so far. The
reference's conv, pooling, RNN, transformer and the remaining loss and
common layers, ``nn.utils``, ``nn.quant`` and the layout helpers are
ROADMAP §A item 11."""

from . import functional, initializer
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue
from .layer import Layer, ParamAttr
from .layers.activation import (CELU, ELU, GELU, GLU, SELU, Hardshrink, Hardsigmoid,
                                Hardswish, Hardtanh, LeakyReLU, LogSigmoid,
                                LogSoftmax, Maxout, Mish, PReLU, ReLU, ReLU6, RReLU,
                                Sigmoid, SiLU, Softmax, Softplus, Softshrink,
                                Softsign, Swish, Tanh, Tanhshrink, ThresholdedReLU)
from .layers.common import (AlphaDropout, Bilinear, CosineSimilarity, Dropout,
                            Dropout2D, Dropout3D, Embedding, Flatten, Identity,
                            Linear, Pad1D, Pad2D, Pad3D, ZeroPad2D)
from .layers.container import LayerDict, LayerList, ParameterList, Sequential
from .layers.loss import CrossEntropyLoss, MSELoss
from .layers.norm import (BatchNorm, BatchNorm1D, BatchNorm2D, BatchNorm3D,
                          GroupNorm, InstanceNorm1D, InstanceNorm2D, InstanceNorm3D,
                          LayerNorm, LocalResponseNorm, RMSNorm, SpectralNorm,
                          SyncBatchNorm)

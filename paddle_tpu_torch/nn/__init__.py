"""paddle.nn — counterpart of ``paddle_tpu/nn``: ``Layer``, ``ParamAttr``,
the initializers, gradient clipping, the layers ported so far (the
transformer, conv and pooling layers among them), the channels-last
layout pass and ``nn.quant``. The reference's RNN layers are ROADMAP §A
item 5b; the remaining loss and common layers and ``nn.utils`` item 7."""

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
from .layers.conv import (Conv1D, Conv1DTranspose, Conv2D, Conv2DTranspose,
                          Conv3D, Conv3DTranspose)
from .layers.container import LayerDict, LayerList, ParameterList, Sequential
from .layers.loss import CrossEntropyLoss, MSELoss
from .layers.norm import (BatchNorm, BatchNorm1D, BatchNorm2D, BatchNorm3D,
                          GroupNorm, InstanceNorm1D, InstanceNorm2D, InstanceNorm3D,
                          LayerNorm, LocalResponseNorm, RMSNorm, SpectralNorm,
                          SyncBatchNorm)
from .layers.pooling import (AdaptiveAvgPool1D, AdaptiveAvgPool2D,
                             AdaptiveAvgPool3D, AdaptiveMaxPool1D,
                             AdaptiveMaxPool2D, AdaptiveMaxPool3D, AvgPool1D,
                             AvgPool2D, AvgPool3D, MaxPool1D, MaxPool2D,
                             MaxPool3D)
from .layers.transformer import (MultiHeadAttention, Transformer,
                                 TransformerDecoder, TransformerDecoderLayer,
                                 TransformerEncoder, TransformerEncoderLayer)

from .layout import ChannelsLast, to_channels_first, to_channels_last  # noqa: E402

from . import quant  # noqa: E402

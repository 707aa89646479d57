"""paddle.incubate.nn — counterpart of ``paddle_tpu/incubate/nn``: the
fused functional names and the fused layer names. The fused layers are
the standard ones, as in the reference: their attention already takes the
flash kernels on the card (``nn.functional.scaled_dot_product_attention``)
and ``RMSNorm`` the RMSNorm kernels."""

from . import functional  # noqa: F401
from ...nn.layers.norm import RMSNorm
from ...nn.layers.transformer import (MultiHeadAttention,
                                      TransformerEncoderLayer)

__all__ = ["functional", "FusedMultiHeadAttention",
           "FusedTransformerEncoderLayer", "FusedRMSNorm"]

FusedMultiHeadAttention = MultiHeadAttention
FusedTransformerEncoderLayer = TransformerEncoderLayer
FusedRMSNorm = RMSNorm

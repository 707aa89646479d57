"""paddle.nn.functional — counterpart of ``paddle_tpu/nn/functional``. The
functionals ported so far (``conv`` and ``pooling`` among them); the
reference's ``vision`` and ``fused_rnn`` modules are ROADMAP §A item 5b,
the rest of ``loss`` and the interpolation / pixel / unfold functionals
of ``common`` item 7."""

from .activation import (celu, elu, gelu, glu, gumbel_softmax, hardshrink,
                         hardsigmoid, hardswish, hardtanh, leaky_relu, log_sigmoid,
                         log_softmax, logsigmoid, maxout, mish, prelu, relu, relu6,
                         rrelu, selu, sigmoid, silu, softmax, softplus, softshrink,
                         softsign, stanh, swish, tanh, tanhshrink, thresholded_relu)
from .attention import (attention_probs, flash_attention,
                        scaled_dot_product_attention, sequence_mask)
from .conv import (conv1d, conv1d_transpose, conv2d, conv2d_fusion,
                   conv2d_transpose, conv3d, conv3d_transpose,
                   conv_transpose1d, conv_transpose2d, conv_transpose3d,
                   depthwise_conv2d, depthwise_conv2d_transpose)
from .common import (alpha_dropout, cosine_similarity, dropout, dropout2d,
                     dropout3d, embedding, label_smooth, linear, normalize,
                     one_hot, pad, pad2d, pad3d, pairwise_distance, softmax2d,
                     zeropad2d)
from .loss import cross_entropy, mse_loss
from .pooling import (adaptive_avg_pool1d, adaptive_avg_pool2d,
                      adaptive_avg_pool3d, adaptive_max_pool1d,
                      adaptive_max_pool2d, adaptive_max_pool3d, avg_pool1d,
                      avg_pool2d, avg_pool3d, fractional_max_pool2d,
                      fractional_max_pool3d, lp_pool1d, lp_pool2d,
                      max_pool1d, max_pool2d, max_pool2d_with_index,
                      max_pool3d, max_pool3d_with_index, max_unpool1d,
                      max_unpool2d, max_unpool3d, pool2d, pool3d, spp,
                      unpool, unpool3d)
from .norm import (batch_norm, group_norm, instance_norm, layer_norm,
                   local_response_norm, rms_norm, spectral_norm,
                   sync_batch_norm)


# The functional surface in the op schema registry, as the reference
# registers it (each is a phi kernel upstream).
def _register_functional():
    import types as _t

    from ...core.dispatch import OP_REGISTRY, register_op
    for _k, _v in list(globals().items()):
        if _k.startswith("_") or isinstance(_v, (_t.ModuleType, type)):
            continue
        if not callable(_v) or _k in OP_REGISTRY:
            continue
        register_op(_k, _v, doc=(_v.__doc__ or "").strip().split("\n")[0],
                    public=_v)


_register_functional()

"""paddle.nn.functional — counterpart of ``paddle_tpu/nn/functional``. The
functionals ported so far; the reference's ``conv``, ``pooling``,
``vision``, ``fused_rnn`` modules, the rest of ``loss`` and the
interpolation / pixel / unfold functionals of ``common`` are ROADMAP §A
item 11."""

from .activation import (celu, elu, gelu, glu, gumbel_softmax, hardshrink,
                         hardsigmoid, hardswish, hardtanh, leaky_relu, log_sigmoid,
                         log_softmax, logsigmoid, maxout, mish, prelu, relu, relu6,
                         rrelu, selu, sigmoid, silu, softmax, softplus, softshrink,
                         softsign, stanh, swish, tanh, tanhshrink, thresholded_relu)
from .attention import (attention_probs, flash_attention,
                        scaled_dot_product_attention, sequence_mask)
from .common import (alpha_dropout, cosine_similarity, dropout, dropout2d,
                     dropout3d, embedding, label_smooth, linear, normalize,
                     one_hot, pad, pad2d, pad3d, pairwise_distance, softmax2d,
                     zeropad2d)
from .loss import cross_entropy, mse_loss
from .norm import (batch_norm, group_norm, instance_norm, layer_norm,
                   local_response_norm, rms_norm, spectral_norm)


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

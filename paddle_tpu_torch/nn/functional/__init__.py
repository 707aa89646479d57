"""paddle.nn.functional — counterpart of ``paddle_tpu/nn/functional``:
every functional of the reference."""

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
from .common import (alpha_dropout, bicubic_interp, bilinear_interp,
                     channel_shuffle, cosine_similarity, dropout, dropout2d,
                     dropout3d, embedding, interpolate, label_smooth, linear,
                     linear_interp, nearest_interp, normalize, one_hot, pad,
                     pad2d, pad3d, pairwise_distance, pixel_shuffle,
                     pixel_unshuffle, softmax2d, sparse_attention,
                     trilinear_interp, unfold,
                     upsample, zeropad2d)
from .loss import (adaptive_log_softmax_with_loss, binary_cross_entropy,
                   binary_cross_entropy_with_logits, bpr_loss, center_loss,
                   class_center_sample, cos_sim, cosine_embedding_loss,
                   cross_entropy, ctc_loss, dice_loss, gaussian_nll_loss,
                   hinge_embedding_loss, hsigmoid_loss, huber_loss,
                   identity_loss, kl_div, l1_loss, log_loss,
                   margin_cross_entropy, margin_ranking_loss,
                   modified_huber_loss, mse_loss, multi_label_soft_margin_loss,
                   multi_margin_loss, nll_loss, npair_loss, poisson_nll_loss,
                   rank_loss, rnnt_loss, sigmoid_focal_loss, smooth_l1_loss,
                   soft_margin_loss, softmax_with_cross_entropy,
                   square_error_cost, squared_l2_distance, squared_l2_norm,
                   teacher_student_sigmoid_loss, triplet_margin_loss,
                   triplet_margin_with_distance_loss)
from .pooling import (adaptive_avg_pool1d, adaptive_avg_pool2d,
                      adaptive_avg_pool3d, adaptive_max_pool1d,
                      adaptive_max_pool2d, adaptive_max_pool3d, avg_pool1d,
                      avg_pool2d, avg_pool3d, fractional_max_pool2d,
                      fractional_max_pool3d, lp_pool1d, lp_pool2d,
                      max_pool1d, max_pool2d, max_pool2d_with_index,
                      max_pool3d, max_pool3d_with_index, max_unpool1d,
                      max_unpool2d, max_unpool3d, pool2d, pool3d, spp,
                      unpool, unpool3d)
from .vision import (affine_grid, bilinear, feature_alpha_dropout, fold,
                     grid_sample, temporal_shift)
from .fused_rnn import fusion_gru, fusion_lstm, gru_unit, lstm_unit, multi_gru
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

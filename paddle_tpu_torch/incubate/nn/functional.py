"""incubate.nn.functional — counterpart of
``paddle_tpu/incubate/nn/functional.py`` (Paddle's fused-op names).

``fused_rotary_position_embedding`` and ``fused_rms_norm`` call the kernel
wrappers directly: ``kernels.rope.apply_rope`` (tables from
``rope_cos_sin``) and ``kernels.rms_norm.rms_norm``, which launch
``csrc/rope.cu`` and ``csrc/rms_norm.cu`` on CUDA tensors (x float32 or
bfloat16) and run their plain versions on CPU tensors.

The fused attention names (``fused_multi_head_attention``,
``fused_attention``, ``fused_multi_transformer``) attend through
``nn.functional.scaled_dot_product_attention``, so a call on the card
with no mask and no active dropout takes the flash kernels
(``flash_route``). The other names are compositions of torch ops, as in
the reference (convolutions through the port's ``conv2d``);
``masked_multihead_attention`` and
``variable_length_memory_efficient_attention`` are plain attention there
too. ``block_multihead_attention`` raises, as the reference's does.

Two names compute Paddle's contract where the reference departs from it
(ROADMAP §C): ``fused_multi_transformer`` with ``pre_layer_norm=False``
applies ``ln_scales`` / ``ln_biases`` after attention and
``ffn_ln_scales`` / ``ffn_ln_biases`` after the FFN (the reference drops
them), and ``variable_length_memory_efficient_attention`` masks the keys
by ``kv_seq_lens`` and adds ``mask`` (the reference reads neither).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as TF

from ...core.dispatch import register_op
from ...nn import functional as F
from ...ops._helpers import ensure_tensor, forward_op
from ...ops.manipulation import reshape, transpose

__all__ = ["fused_rotary_position_embedding", "fused_rms_norm",
           "fused_layer_norm", "fused_multi_head_attention", "swiglu",
           "fused_linear", "fused_bias_dropout_residual_layer_norm",
           "fused_dropout_add", "fused_bias_act", "fused_matmul_bias",
           "fused_gemm_epilogue", "fused_linear_activation",
           "fused_feedforward", "fused_attention", "fused_gate_attention",
           "softmax_mask_fuse", "softmax_mask_fuse_upper_triangle",
           "fused_bn_add_act", "resnet_unit", "masked_multihead_attention",
           "variable_length_memory_efficient_attention",
           "block_multihead_attention", "fused_multi_transformer",
           "fused_moe", "fused_ec_moe"]


def fused_rotary_position_embedding(q, k=None, v=None, sin=None, cos=None,
                                    position_ids=None, use_neox_rotary_style=True,
                                    time_major=False, rotary_emb_base=10000.0):
    """ref: incubate fused_rope — applies RoPE to q/k (v passes through).
    q/k: [B, S, H, D]; sin/cos default to tables built from rotary_emb_base."""
    from ...kernels.rope import apply_rope, rope_cos_sin
    qt = ensure_tensor(q)
    B, S, H, D = qt.shape
    dev = qt._value.device
    if cos is None or sin is None:
        pos = None if position_ids is None else \
            ensure_tensor(position_ids)._value.to(dev)
        cos_v, sin_v = rope_cos_sin(S, D, rotary_emb_base, position_ids=pos,
                                    device=dev)
    else:
        cos_v = ensure_tensor(cos)._value.reshape(S, D)
        sin_v = ensure_tensor(sin)._value.reshape(S, D)

    def rope_one(t):
        return forward_op("fused_rope",
                          lambda x: apply_rope(x, cos_v, sin_v), [t])
    out_q = rope_one(qt)
    out_k = rope_one(ensure_tensor(k)) if k is not None else None
    out_v = ensure_tensor(v) if v is not None else None
    return out_q, out_k, out_v


def fused_rms_norm(x, norm_weight, norm_bias=None, epsilon=1e-6,
                   begin_norm_axis=-1, **kwargs):
    """ref: incubate fused_rms_norm — the RMSNorm kernel's Function."""
    from ...kernels.rms_norm import rms_norm
    t, w = ensure_tensor(x), ensure_tensor(norm_weight)
    out = forward_op("fused_rms_norm",
                     lambda v, wv: rms_norm(v, wv, epsilon), [t, w])
    if norm_bias is not None:
        out = out + ensure_tensor(norm_bias)
    return out


def fused_layer_norm(x, norm_weight, norm_bias, epsilon=1e-5,
                     begin_norm_axis=-1, **kwargs):
    """ref: incubate fused_layer_norm — LayerNorm over the last axis."""
    return F.layer_norm(x, ensure_tensor(x).shape[-1:], weight=norm_weight,
                           bias=norm_bias, epsilon=epsilon)


def fused_multi_head_attention(x, qkv_weight, qkv_bias=None, *,
                               num_heads: int, causal: bool = False,
                               linear_weight=None, linear_bias=None,
                               dropout_rate=0.0, training=True, **kwargs):
    """ref: incubate fused_multi_head_attention — the fused qkv
    projection ``[E, 3E]``, attention (the flash kernels where
    ``flash_route`` allows) and the output projection."""
    from ...ops.linalg import matmul
    t = ensure_tensor(x)
    B, S, E = t.shape
    qkv = matmul(t, ensure_tensor(qkv_weight))        # [B, S, 3E]
    if qkv_bias is not None:
        qkv = qkv + ensure_tensor(qkv_bias)
    D = E // num_heads
    q, k, v = (reshape(qkv[:, :, i * E:(i + 1) * E], [B, S, num_heads, D])
               for i in range(3))
    out = reshape(F.scaled_dot_product_attention(
        q, k, v, is_causal=causal, dropout_p=dropout_rate,
        training=training), [B, S, E])
    if linear_weight is not None:
        out = matmul(out, ensure_tensor(linear_weight))
        if linear_bias is not None:
            out = out + ensure_tensor(linear_bias)
    return out


def _silu_mul(a, b):
    return (a * (1 / (1 + torch.exp(-a)))) * b


def swiglu(x, y=None, name=None):
    """ref: incubate swiglu — silu(x) * y (y defaults to the second half
    of x's last axis, the fused FFN's convention)."""
    t = ensure_tensor(x)
    if y is None:
        return forward_op("swiglu", lambda v: _silu_mul(*v.chunk(2, dim=-1)),
                          [t])
    return forward_op("swiglu", _silu_mul, [t, ensure_tensor(y)])


def fused_linear(x, weight, bias=None, transpose_weight=False, name=None):
    """ref: incubate fused_linear (gemm + bias epilogue)."""
    w = ensure_tensor(weight)
    if transpose_weight:
        w = transpose(w, [1, 0])
    return F.linear(x, w, bias)


def fused_bias_dropout_residual_layer_norm(x, residual, bias=None,
                                           ln_scale=None, ln_bias=None,
                                           dropout_rate=0.5, ln_epsilon=1e-5,
                                           training=True, **kwargs):
    """ref: incubate fused_bias_dropout_residual_layer_norm."""
    t = ensure_tensor(x)
    if bias is not None:
        t = t + ensure_tensor(bias)
    if dropout_rate:
        t = F.dropout(t, dropout_rate, training=training)
    t = t + ensure_tensor(residual)
    return F.layer_norm(t, t.shape[-1:], weight=ln_scale, bias=ln_bias,
                        epsilon=ln_epsilon)


def fused_dropout_add(x, y, p=0.5, training=True, mode="upscale_in_train",
                      name=None):
    """ref: incubate fused_dropout_add — dropout(x) + y."""
    t = ensure_tensor(x)
    if p and training:
        t = F.dropout(t, p, training=training, mode=mode)
    return t + ensure_tensor(y)


def fused_bias_act(x, bias=None, dequant_scales=None, shift=None, smooth=None,
                   act_method="gelu", compute_dtype="default",
                   quant_scale=-1.0, name=None):
    """ref: incubate fused_bias_act — bias + activation (gelu / relu /
    silu / swiglu / geglu)."""
    t = ensure_tensor(x)
    if bias is not None:
        t = t + ensure_tensor(bias)
    act = act_method.lower()
    if act == "gelu":
        return F.gelu(t)
    if act == "relu":
        return F.relu(t)
    if act in ("silu", "swish"):
        return F.silu(t)
    if act == "swiglu":
        return swiglu(t)
    if act == "geglu":
        def geglu(v):
            # the reference's jax.nn.gelu: the tanh approximation
            a, b = v.chunk(2, dim=-1)
            return TF.gelu(a, approximate="tanh") * b
        return forward_op("fused_bias_act_geglu", geglu, [t])
    raise ValueError(f"unknown act_method {act_method!r}")


def fused_matmul_bias(x, y, bias=None, transpose_x=False, transpose_y=False,
                      name=None):
    """ref: incubate fused_matmul_bias (the cublasLt bias epilogue
    upstream)."""
    args = [ensure_tensor(x), ensure_tensor(y)] + \
        ([ensure_tensor(bias)] if bias is not None else [])

    def impl(a, b, *bb):
        if transpose_x:
            a = a.transpose(-1, -2)
        if transpose_y:
            b = b.transpose(-1, -2)
        out = a @ b
        return out + bb[0] if bb else out

    return forward_op("fused_matmul_bias", impl, args)


def fused_gemm_epilogue(x, y, bias, trans_x=False, trans_y=False,
                        activation="none", name=None):
    """ref: fused_gemm_epilogue_op — gemm + bias + optional relu/gelu
    epilogue."""
    out = fused_matmul_bias(x, y, bias, trans_x, trans_y)
    if activation == "relu":
        return F.relu(out)
    if activation == "gelu":
        return F.gelu(out)
    return out


def fused_linear_activation(x, y, bias, trans_x=False, trans_y=False,
                            activation="gelu", name=None):
    """ref: incubate fused_linear_activation — fused_gemm_epilogue with the
    activation on."""
    return fused_gemm_epilogue(x, y, bias, trans_x, trans_y, activation)


def fused_feedforward(x, linear1_weight, linear2_weight, linear1_bias=None,
                      linear2_bias=None, ln1_scale=None, ln1_bias=None,
                      ln2_scale=None, ln2_bias=None, dropout1_rate=0.5,
                      dropout2_rate=0.5, activation="relu",
                      ln1_epsilon=1e-5, ln2_epsilon=1e-5,
                      pre_layer_norm=False, training=True, name=None):
    """ref: fused_feedforward_op — the transformer FFN block (ln -> linear
    -> act -> dropout -> linear -> dropout -> residual -> ln)."""
    t = ensure_tensor(x)
    residual = t
    if pre_layer_norm:
        t = F.layer_norm(t, t.shape[-1:], weight=ln1_scale, bias=ln1_bias,
                         epsilon=ln1_epsilon)
    t = F.linear(t, ensure_tensor(linear1_weight), linear1_bias)
    t = F.relu(t) if activation == "relu" else F.gelu(t)
    if dropout1_rate and training:
        t = F.dropout(t, dropout1_rate, training=training)
    t = F.linear(t, ensure_tensor(linear2_weight), linear2_bias)
    if dropout2_rate and training:
        t = F.dropout(t, dropout2_rate, training=training)
    t = t + residual
    if not pre_layer_norm:
        t = F.layer_norm(t, t.shape[-1:], weight=ln2_scale, bias=ln2_bias,
                         epsilon=ln2_epsilon)
    return t


def _qkv_matrix(qkv_weight, num_heads, E):
    """The qkv weight as ``[E, 3 H D]`` with its head count and head size:
    Paddle's ``[3, H, D, E]``, or ``[E, 3E]`` with ``num_heads``."""
    w = ensure_tensor(qkv_weight)
    if len(w.shape) == 4:
        H, D = int(w.shape[1]), int(w.shape[2])
        return transpose(reshape(w, [3 * H * D, E]), [1, 0]), H, D
    return w, num_heads, E // num_heads


def fused_attention(x, qkv_weight, linear_weight, qkv_bias=None,
                    linear_bias=None, pre_ln_scale=None, pre_ln_bias=None,
                    ln_scale=None, ln_bias=None, pre_layer_norm=False,
                    epsilon=1e-5, attn_mask=None, dropout_rate=0.5,
                    attn_dropout_rate=0.5, num_heads=None, training=True,
                    name=None):
    """ref: fused_attention_op — ln + qkv projection + attention + output
    projection + residual + ln. ``qkv_weight`` ``[3, H, D, E]`` (Paddle's
    layout) or ``[E, 3E]`` with ``num_heads``; ``qkv_bias`` ``[3, H, D]``
    or ``[3E]``."""
    t = ensure_tensor(x)
    residual = t
    if pre_layer_norm:
        t = F.layer_norm(t, t.shape[-1:], weight=pre_ln_scale,
                         bias=pre_ln_bias, epsilon=epsilon)
    B, S, E = t.shape
    w2, H, D = _qkv_matrix(qkv_weight, num_heads, E)
    if qkv_bias is not None:
        qkv_bias = reshape(ensure_tensor(qkv_bias), [3 * H * D])
    qkv = reshape(F.linear(t, w2, qkv_bias), [B, S, 3, H, D])
    out = F.scaled_dot_product_attention(
        qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], attn_mask=attn_mask,
        dropout_p=attn_dropout_rate if training else 0.0)
    out = F.linear(reshape(out, [B, S, H * D]), ensure_tensor(linear_weight),
                   linear_bias)
    if dropout_rate and training:
        out = F.dropout(out, dropout_rate, training=training)
    out = out + residual
    if not pre_layer_norm:
        out = F.layer_norm(out, out.shape[-1:], weight=ln_scale,
                           bias=ln_bias, epsilon=epsilon)
    return out


def fused_gate_attention(query, key=None, query_weight=None, key_weight=None,
                         value_weight=None, qkv_weight=None,
                         gate_linear_weight=None, gate_linear_bias=None,
                         out_linear_weight=None, out_linear_bias=None,
                         nonbatched_bias=None, attn_mask=None,
                         has_gating=True, merge_qkv=True, name=None):
    """ref: fused_gate_attention_op (AlphaFold-style gated attention):
    attention with an optional pair bias, a sigmoid gate on the values."""
    q_in = ensure_tensor(query)
    k_in = ensure_tensor(key) if key is not None else q_in
    lead_q = list(q_in.shape[:-1])
    if merge_qkv and qkv_weight is not None:
        w = ensure_tensor(qkv_weight)                   # [3, H, D, E]
        _, H, D, E = (int(s) for s in w.shape)
        qkv = reshape(q_in @ transpose(reshape(w, [3 * H * D, E]), [1, 0]),
                      lead_q + [3, H, D])
        q, k, v = qkv[..., 0, :, :], qkv[..., 1, :, :], qkv[..., 2, :, :]
    else:
        E, H, D = (int(s) for s in ensure_tensor(query_weight).shape)
        lead_k = list(k_in.shape[:-1])

        def proj(t, wt, lead):
            return reshape(t @ reshape(ensure_tensor(wt), [E, H * D]),
                           lead + [H, D])
        q = proj(q_in, query_weight, lead_q)
        k = proj(k_in, key_weight, lead_k)
        v = proj(k_in, value_weight, lead_k)
    extras = [ensure_tensor(a) for a in (nonbatched_bias, attn_mask)
              if a is not None]

    def attn(qv, kv, vv, *ex):
        s = torch.einsum("...qhd,...khd->...hqk", qv, kv) / (qv.shape[-1] ** 0.5)
        i = 0
        if nonbatched_bias is not None:
            s = s + ex[0]
            i = 1
        if attn_mask is not None:
            s = s + (1.0 - ex[i]) * -1e9
        return torch.einsum("...hqk,...khd->...qhd", torch.softmax(s, -1), vv)

    out = forward_op("fused_gate_attention", attn, [q, k, v] + extras)
    if has_gating and gate_linear_weight is not None:
        gw = ensure_tensor(gate_linear_weight)          # [E, H, D]
        E, H, D = (int(s) for s in gw.shape)
        gate = reshape(q_in @ reshape(gw, [E, H * D]), lead_q + [H, D])
        if gate_linear_bias is not None:
            gate = gate + ensure_tensor(gate_linear_bias)
        out = F.sigmoid(gate) * out
    if out_linear_weight is not None:
        ow = ensure_tensor(out_linear_weight)           # [H, D, E]
        H, D, E = (int(s) for s in ow.shape)
        out = reshape(out, list(out.shape[:-2]) + [H * D]) @ \
            reshape(ow, [H * D, E])
        if out_linear_bias is not None:
            out = out + ensure_tensor(out_linear_bias)
    return out


def softmax_mask_fuse(x, mask, name=None):
    """ref: incubate softmax_mask_fuse — softmax(x + mask) over the last
    axis (the mask broadcast over heads)."""
    return forward_op("softmax_mask_fuse",
                      lambda xv, mv: torch.softmax(xv + mv, dim=-1),
                      [ensure_tensor(x), ensure_tensor(mask)])


def softmax_mask_fuse_upper_triangle(x, name=None):
    """ref: incubate softmax_mask_fuse_upper_triangle — the causally
    masked softmax over the last axis."""
    def impl(xv):
        q = torch.arange(xv.shape[-2], device=xv.device)[:, None]
        k = torch.arange(xv.shape[-1], device=xv.device)[None, :]
        s = torch.where(k <= q, xv, torch.full_like(xv, -1e30))
        return torch.softmax(s, dim=-1)

    return forward_op("softmax_mask_fuse_upper_triangle", impl,
                      [ensure_tensor(x)])


def _bn_act(v, mv, vv, sv, bv, epsilon, act, *residual):
    c = (None, slice(None), None, None)
    out = (v - mv[c]) * torch.rsqrt(vv[c] + epsilon) * sv[c] + bv[c]
    if residual:
        out = out + residual[0]
    return torch.clamp(out, min=0) if act == "relu" else out


def fused_bn_add_act(x, y, running_mean, running_var, scale, bias,
                     epsilon=1e-5, act="relu", name=None):
    """ref: fused_bn_add_act_op — inference batch norm of x, plus y, then
    the activation."""
    return forward_op(
        "fused_bn_add_act",
        lambda xv, yv, mv, vv, sv, bv: _bn_act(xv, mv, vv, sv, bv, epsilon,
                                               act, yv),
        [ensure_tensor(a) for a in (x, y, running_mean, running_var, scale,
                                    bias)])


def resnet_unit(x, filter_x, scale_x, bias_x, mean_x, var_x, z=None,
                stride=1, padding=1, epsilon=1e-5, act="relu", name=None):
    """ref: resnet_unit_op — conv (the port's ``conv2d``) + inference batch
    norm (+ the residual z) + relu."""
    out = F.conv2d(x, filter_x, stride=stride, padding=padding)
    args = [out] + [ensure_tensor(a) for a in (mean_x, var_x, scale_x,
                                               bias_x)]
    if z is not None:
        args.append(ensure_tensor(z))
    return forward_op(
        "resnet_unit",
        lambda o, mv, vv, sv, bv, *zz: _bn_act(o, mv, vv, sv, bv, epsilon,
                                               act, *zz), args)


def masked_multihead_attention(x, cache_kv, src_mask=None, seq_lens=None,
                               rotary_tensor=None, num_heads=None, name=None):
    """ref: masked_multihead_attention_op — one decode step's attention
    against a static-capacity KV cache: ``x [B, 3E]`` (the fused qkv of
    one token), ``cache_kv [2, B, H, C, D]``, ``seq_lens [B]`` the
    positions written. Returns ``(out [B, E], new cache)``: the in-place
    CUDA update made pure, as in the reference."""
    args = [ensure_tensor(x), ensure_tensor(cache_kv)] + \
        [ensure_tensor(a) for a in (src_mask, seq_lens) if a is not None]

    def impl(xv, cv, *rest):
        mask_v = rest[0] if src_mask is not None else None
        lens_v = rest[-1] if seq_lens is not None else None
        B = xv.shape[0]
        _, _, H, C, D = cv.shape
        qkv = xv.reshape(B, 3, H, D)
        pos = (lens_v.reshape(-1).long() if lens_v is not None
               else torch.zeros(B, dtype=torch.long, device=xv.device))
        b = torch.arange(B, device=xv.device)
        ck, cvv = cv[0].clone(), cv[1].clone()
        ck[b, :, pos] = qkv[:, 1].to(ck.dtype)
        cvv[b, :, pos] = qkv[:, 2].to(cvv.dtype)
        s = torch.einsum("bhd,bhcd->bhc", qkv[:, 0], ck) / (D ** 0.5)
        if mask_v is not None:
            s = s + mask_v.reshape(B, 1, -1)[:, :, :C]
        valid = torch.arange(C, device=xv.device)[None, None, :] <= \
            pos[:, None, None]
        s = torch.where(valid, s, torch.full_like(s, -1e30))
        p = torch.softmax(s.to(torch.float32), dim=-1).to(s.dtype)
        out = torch.einsum("bhc,bhcd->bhd", p, cvv).reshape(B, H * D)
        return out, torch.stack([ck, cvv])

    return forward_op("masked_multihead_attention", impl, args)


def variable_length_memory_efficient_attention(query, key, value, seq_lens=None,
                                               kv_seq_lens=None, mask=None,
                                               scale=None, causal=False,
                                               name=None):
    """ref: incubate variable_length_memory_efficient_attention on
    ``[B, H, S, D]``: keys past ``kv_seq_lens`` (``seq_lens`` when it is
    None) masked out, the additive ``mask`` added, causal if asked."""
    lens = kv_seq_lens if kv_seq_lens is not None else seq_lens
    args = [ensure_tensor(query), ensure_tensor(key), ensure_tensor(value)] + \
        [ensure_tensor(a) for a in (lens, mask) if a is not None]

    def impl(qv, kv, vv, *rest):
        sc = scale if scale is not None else 1.0 / math.sqrt(qv.shape[-1])
        s = torch.einsum("bhqd,bhkd->bhqk", qv, kv) * sc
        if mask is not None:
            s = s + rest[-1]
        neg = torch.full_like(s, -1e30)
        if lens is not None:
            keys = torch.arange(kv.shape[2], device=kv.device)[None, :] < \
                rest[0].reshape(-1, 1)
            s = torch.where(keys[:, None, None, :], s, neg)
        if causal:
            qn = torch.arange(qv.shape[2], device=qv.device)[:, None]
            kn = torch.arange(kv.shape[2], device=kv.device)[None, :]
            s = torch.where((kn <= qn)[None, None], s, neg)
        return torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, dim=-1), vv)

    return forward_op("variable_length_memory_efficient_attention", impl,
                      args)


def block_multihead_attention(qkv, key_cache, value_cache, seq_lens_encoder,
                              seq_lens_decoder, seq_lens_this_time,
                              padding_offsets=None, cum_offsets=None,
                              cu_seqlens_q=None, cu_seqlens_k=None,
                              block_tables=None, max_seq_len=None, name=None):
    """ref: incubate block_multihead_attention (paged-KV decode) — not
    provided, as in the reference."""
    raise NotImplementedError(
        "block_multihead_attention is not provided: serve a paged KV cache "
        "through inference.serving.ServingEngine (the paged-attention "
        "kernel), or use masked_multihead_attention for one decode step "
        "over a static cache.")


def fused_multi_transformer(x, ln_scales, ln_biases, qkv_weights, qkv_biases,
                            linear_weights, linear_biases, ffn_ln_scales,
                            ffn_ln_biases, ffn1_weights, ffn1_biases,
                            ffn2_weights, ffn2_biases, attn_mask=None,
                            pre_layer_norm=True, epsilon=1e-5,
                            num_heads=None, training=False, name=None):
    """ref: fused_multi_transformer_op — N transformer layers in one call,
    each ``fused_attention`` then ``fused_feedforward`` (GELU). Pre-LN:
    ``ln_*`` before attention, ``ffn_ln_*`` before the FFN; post-LN:
    ``ln_*`` after attention, ``ffn_ln_*`` after the FFN (Paddle's
    contract; see the module note)."""
    def at(seq, i):
        return seq[i] if seq else None

    t = x
    for i in range(len(qkv_weights)):
        ln = dict(pre_ln_scale=at(ln_scales, i), pre_ln_bias=at(ln_biases, i)) \
            if pre_layer_norm else \
            dict(ln_scale=at(ln_scales, i), ln_bias=at(ln_biases, i))
        t = fused_attention(
            t, qkv_weights[i], linear_weights[i], qkv_bias=at(qkv_biases, i),
            linear_bias=at(linear_biases, i), pre_layer_norm=pre_layer_norm,
            epsilon=epsilon, attn_mask=attn_mask, dropout_rate=0.0,
            attn_dropout_rate=0.0, num_heads=num_heads, training=training,
            **ln)
        ffn_ln = dict(ln1_scale=at(ffn_ln_scales, i),
                      ln1_bias=at(ffn_ln_biases, i)) if pre_layer_norm else \
            dict(ln2_scale=at(ffn_ln_scales, i), ln2_bias=at(ffn_ln_biases, i))
        t = fused_feedforward(
            t, ffn1_weights[i], ffn2_weights[i],
            linear1_bias=at(ffn1_biases, i), linear2_bias=at(ffn2_biases, i),
            dropout1_rate=0.0, dropout2_rate=0.0, activation="gelu",
            ln1_epsilon=epsilon, ln2_epsilon=epsilon,
            pre_layer_norm=pre_layer_norm, training=training, **ffn_ln)
    return t


def fused_moe(x, gate_weight, ffn1_weights, ffn2_weights, ffn1_biases=None,
              ffn2_biases=None, top_k=2, name=None):
    """ref: incubate fused_moe — gate, top-k routing, the expert FFNs (GELU)
    and the weighted combine, dense over the stacked expert weights
    ``[X, E, I]`` / ``[X, I, E]``."""
    args = [ensure_tensor(a) for a in (x, gate_weight, ffn1_weights,
                                       ffn2_weights)]
    if ffn1_biases is not None:
        args += [ensure_tensor(ffn1_biases), ensure_tensor(ffn2_biases)]

    def impl(xv, gv, w1v, w2v, *bb):
        lead, E = xv.shape[:-1], xv.shape[-1]
        toks = xv.reshape(-1, E)
        vals, idx = torch.topk(torch.softmax(toks @ gv, -1), top_k, dim=-1)
        vals = vals / torch.clamp(vals.sum(-1, keepdim=True), min=1e-9)
        weight = (TF.one_hot(idx, gv.shape[1]).to(vals.dtype) *
                  vals[..., None]).sum(1)                # [T, X]
        h = torch.einsum("te,xei->txi", toks, w1v)
        if bb:
            h = h + bb[0][None]
        out = torch.einsum("txi,xie->txe", TF.gelu(h, approximate="tanh"), w2v)
        if bb:
            out = out + bb[1][None]
        return (out * weight[..., None]).sum(1).reshape(*lead, E)

    return forward_op("fused_moe", impl, args)


def fused_ec_moe(x, gate, ffn1_weight, ffn2_weight, ffn1_bias=None,
                 ffn2_bias=None, act_type="gelu", name=None):
    """ref: incubate fused_ec_moe (expert-choice routing): each expert
    takes its top ``2T / X`` tokens, and the outputs are summed back onto
    the tokens."""
    args = [ensure_tensor(a) for a in (x, gate, ffn1_weight, ffn2_weight)]
    if ffn1_bias is not None:
        args += [ensure_tensor(ffn1_bias), ensure_tensor(ffn2_bias)]

    def impl(xv, gv, w1v, w2v, *bb):
        B, S, E = xv.shape
        toks = xv.reshape(-1, E)
        cap = max(1, (2 * toks.shape[0]) // gv.shape[1])
        vals, idx = torch.topk(torch.softmax(toks @ gv, -1).T, cap, dim=-1)
        h = torch.einsum("xce,xei->xci", toks[idx], w1v)   # [X, C, I]
        if bb:
            h = h + bb[0]
        h = TF.gelu(h, approximate="tanh") if act_type == "gelu" else \
            torch.clamp(h, min=0)
        out = torch.einsum("xci,xie->xce", h, w2v)
        if bb:
            out = out + bb[1]
        out = out * vals[..., None]
        combined = torch.zeros_like(toks).index_add(
            0, idx.reshape(-1), out.reshape(-1, E))
        return combined.reshape(B, S, E)

    return forward_op("fused_ec_moe", impl, args)


for _n in __all__:
    _f = globals()[_n]
    register_op(_n, _f, (_f.__doc__ or "").strip().split("\n")[0],
                category="fused", public=_f)

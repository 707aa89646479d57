"""Transformer layers — counterpart of
``paddle_tpu/nn/layers/transformer.py`` (ref:
``python/paddle/nn/layer/transformer.py``: ``MultiHeadAttention`` with its
caches, the encoder and decoder layers and stacks, ``Transformer``).

Attention goes through ``nn.functional.scaled_dot_product_attention``:
with no mask and no active dropout, a call on the card takes the flash
kernels (``csrc/flash_attention.cu``). ``need_weights`` materializes the
probabilities with ``nn.functional.attention_probs``.

The stacks deep-copy their first layer, as the reference does, and give
every copied parameter a name of its own (Paddle's ``deepcopy`` renames
too): the optimizers key their state by parameter name.
"""

from __future__ import annotations

import collections
import copy

import numpy as np

from ...core.tensor import _auto_name, to_tensor
from ...ops import concat, manipulation
from ...ops.creation import zeros
from ...ops.linalg import matmul
from .. import functional as F
from ..layer import Layer
from .common import Dropout, Linear
from .container import LayerList
from .norm import LayerNorm

__all__ = ["MultiHeadAttention", "TransformerEncoderLayer",
           "TransformerEncoder", "TransformerDecoderLayer",
           "TransformerDecoder", "Transformer"]


def _clones(layer: Layer, n: int) -> LayerList:
    """``layer`` and ``n - 1`` deep copies, each copied parameter renamed."""
    out = [layer]
    for _ in range(n - 1):
        c = copy.deepcopy(layer)
        for p in c.parameters():
            p.name = _auto_name("param")
        out.append(c)
    return LayerList(out)


class MultiHeadAttention(Layer):
    """ref: paddle.nn.MultiHeadAttention (q/k/v/out projections + SDPA +
    cache), on ``[batch, seq, embed]`` inputs."""

    Cache = collections.namedtuple("Cache", ["k", "v"])
    StaticCache = collections.namedtuple("StaticCache", ["k", "v"])

    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None, vdim=None,
                 need_weights=False, weight_attr=None, bias_attr=None):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        assert self.head_dim * num_heads == embed_dim
        self.dropout = dropout
        self.need_weights = need_weights
        kdim = kdim or embed_dim
        vdim = vdim or embed_dim
        self.q_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr)
        self.k_proj = Linear(kdim, embed_dim, weight_attr, bias_attr)
        self.v_proj = Linear(vdim, embed_dim, weight_attr, bias_attr)
        self.out_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr)

    def _shape(self, x):
        # [B, S, E] -> [B, S, H, D]
        b, s = x.shape[0], x.shape[1]
        return manipulation.reshape(x, [b, s, self.num_heads, self.head_dim])

    def gen_cache(self, key, value=None, type=None):  # noqa: A002
        if type == MultiHeadAttention.StaticCache:
            k = self._shape(self.k_proj(key))
            v = self._shape(self.v_proj(value if value is not None else key))
            return self.StaticCache(k, v)
        b = key.shape[0]
        k = zeros([b, 0, self.num_heads, self.head_dim], key.dtype)
        v = zeros([b, 0, self.num_heads, self.head_dim], key.dtype)
        return self.Cache(k, v)

    def forward(self, query, key=None, value=None, attn_mask=None, cache=None):
        key = query if key is None else key
        value = key if value is None else value
        q = self._shape(self.q_proj(query))
        if isinstance(cache, self.StaticCache):
            k, v = cache.k, cache.v
            new_cache = cache
        else:
            k = self._shape(self.k_proj(key))
            v = self._shape(self.v_proj(value))
            if isinstance(cache, self.Cache):
                k = concat([cache.k, k], axis=1)
                v = concat([cache.v, v], axis=1)
                new_cache = self.Cache(k, v)
            else:
                new_cache = None

        if self.need_weights:
            # the materialized-probabilities path: flash never exposes them
            weights = F.attention_probs(q, k, attn_mask=attn_mask)
            if self.dropout and self.training:
                weights = F.dropout(weights, self.dropout)
            # [B,H,Sq,Sk] @ [B,H,Sk,D] -> [B,Sq,H,D]
            vh = manipulation.transpose(v, [0, 2, 1, 3])
            out = manipulation.transpose(matmul(weights, vh), [0, 2, 1, 3])
        else:
            weights = None
            out = F.scaled_dot_product_attention(
                q, k, v, attn_mask=attn_mask,
                dropout_p=self.dropout, training=self.training)
        b, s = out.shape[0], out.shape[1]
        out = manipulation.reshape(out, [b, s, self.embed_dim])
        out = self.out_proj(out)
        outs = (out,)
        if self.need_weights:
            outs += (weights,)
        if cache is not None and new_cache is not None:
            outs += (new_cache,)
        return outs if len(outs) > 1 else out


class TransformerEncoderLayer(Layer):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 layer_norm_eps=1e-5):
        super().__init__()
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(
            d_model, nhead, attn_dropout if attn_dropout is not None else dropout,
            weight_attr=weight_attr, bias_attr=bias_attr)
        self.linear1 = Linear(d_model, dim_feedforward, weight_attr, bias_attr)
        self.linear2 = Linear(dim_feedforward, d_model, weight_attr, bias_attr)
        self.norm1 = LayerNorm(d_model, layer_norm_eps)
        self.norm2 = LayerNorm(d_model, layer_norm_eps)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.dropout_act = Dropout(act_dropout if act_dropout is not None
                                   else dropout)
        self.activation = activation

    def forward(self, src, src_mask=None, cache=None):
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        if cache is not None:
            src, cache = self.self_attn(src, src, src, src_mask, cache)
        else:
            src = self.self_attn(src, src, src, src_mask)
        src = residual + self.dropout1(src)
        if not self.normalize_before:
            src = self.norm1(src)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        src = self.linear2(self.dropout_act(getattr(F, self.activation)(
            self.linear1(src))))
        src = residual + self.dropout2(src)
        if not self.normalize_before:
            src = self.norm2(src)
        return (src, cache) if cache is not None else src

    def gen_cache(self, src):
        return self.self_attn.gen_cache(src)


class TransformerEncoder(Layer):
    def __init__(self, encoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = _clones(encoder_layer, num_layers)
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, src, src_mask=None, cache=None):
        output = src
        new_caches = []
        for i, mod in enumerate(self.layers):
            if cache is not None:
                output, c = mod(output, src_mask, cache[i])
                new_caches.append(c)
            else:
                output = mod(output, src_mask)
        if self.norm is not None:
            output = self.norm(output)
        return (output, new_caches) if cache is not None else output

    def gen_cache(self, src):
        return [layer.gen_cache(src) for layer in self.layers]


class TransformerDecoderLayer(Layer):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 layer_norm_eps=1e-5):
        super().__init__()
        self.normalize_before = normalize_before
        ad = attn_dropout if attn_dropout is not None else dropout
        self.self_attn = MultiHeadAttention(d_model, nhead, ad,
                                            weight_attr=weight_attr,
                                            bias_attr=bias_attr)
        self.cross_attn = MultiHeadAttention(d_model, nhead, ad,
                                             weight_attr=weight_attr,
                                             bias_attr=bias_attr)
        self.linear1 = Linear(d_model, dim_feedforward, weight_attr, bias_attr)
        self.linear2 = Linear(dim_feedforward, d_model, weight_attr, bias_attr)
        self.norm1 = LayerNorm(d_model, layer_norm_eps)
        self.norm2 = LayerNorm(d_model, layer_norm_eps)
        self.norm3 = LayerNorm(d_model, layer_norm_eps)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.dropout3 = Dropout(dropout)
        self.dropout_act = Dropout(act_dropout if act_dropout is not None
                                   else dropout)
        self.activation = activation

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None, cache=None):
        residual = tgt
        if self.normalize_before:
            tgt = self.norm1(tgt)
        if cache is None:
            tgt = self.self_attn(tgt, tgt, tgt, tgt_mask)
            incr = None
        else:
            tgt, incr = self.self_attn(tgt, tgt, tgt, tgt_mask, cache[0])
        tgt = residual + self.dropout1(tgt)
        if not self.normalize_before:
            tgt = self.norm1(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm2(tgt)
        if cache is None:
            tgt = self.cross_attn(tgt, memory, memory, memory_mask)
            static = None
        else:
            tgt, static = self.cross_attn(tgt, memory, memory, memory_mask,
                                          cache[1])
        tgt = residual + self.dropout2(tgt)
        if not self.normalize_before:
            tgt = self.norm2(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm3(tgt)
        tgt = self.linear2(self.dropout_act(getattr(F, self.activation)(
            self.linear1(tgt))))
        tgt = residual + self.dropout3(tgt)
        if not self.normalize_before:
            tgt = self.norm3(tgt)
        return tgt if cache is None else (tgt, (incr, static))

    def gen_cache(self, memory):
        incr = self.self_attn.gen_cache(memory)
        static = self.cross_attn.gen_cache(memory, memory,
                                           type=MultiHeadAttention.StaticCache)
        return incr, static


class TransformerDecoder(Layer):
    def __init__(self, decoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = _clones(decoder_layer, num_layers)
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None, cache=None):
        output = tgt
        new_caches = []
        for i, mod in enumerate(self.layers):
            if cache is None:
                output = mod(output, memory, tgt_mask, memory_mask)
            else:
                output, c = mod(output, memory, tgt_mask, memory_mask, cache[i])
                new_caches.append(c)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, memory, do_zip=False):
        return [layer.gen_cache(memory) for layer in self.layers]


class Transformer(Layer):
    def __init__(self, d_model=512, nhead=8, num_encoder_layers=6,
                 num_decoder_layers=6, dim_feedforward=2048, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 custom_encoder=None, custom_decoder=None):
        super().__init__()
        self.d_model = d_model
        self.nhead = nhead
        if custom_encoder is not None:
            self.encoder = custom_encoder
        else:
            enc_layer = TransformerEncoderLayer(
                d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, weight_attr,
                bias_attr)
            enc_norm = LayerNorm(d_model) if normalize_before else None
            self.encoder = TransformerEncoder(enc_layer, num_encoder_layers,
                                              enc_norm)
        if custom_decoder is not None:
            self.decoder = custom_decoder
        else:
            dec_layer = TransformerDecoderLayer(
                d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, weight_attr,
                bias_attr)
            dec_norm = LayerNorm(d_model) if normalize_before else None
            self.decoder = TransformerDecoder(dec_layer, num_decoder_layers,
                                              dec_norm)

    def forward(self, src, tgt, src_mask=None, tgt_mask=None, memory_mask=None):
        memory = self.encoder(src, src_mask)
        return self.decoder(tgt, memory, tgt_mask, memory_mask)

    @staticmethod
    def generate_square_subsequent_mask(length):
        """``[length, length]`` additive causal mask: 0 on and below the
        diagonal, -inf above."""
        m = np.where(np.tril(np.ones((length, length), bool)), 0.0, -np.inf)
        return to_tensor(m.astype(np.float32))

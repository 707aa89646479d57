"""BERT encoder, functional half — the serving engine's embeddings model.

Counterpart of the functional part of ``paddle_tpu/models/bert.py``
(``BertConfig``, ``bert_init_params``, ``_bert_ln``, ``bert_encode``): a
pure ``(params, ids, lengths) -> pooled [B, E]`` function over STACKED
per-layer params. Post-norm BERT blocks, bidirectional length-masked
attention, first-token tanh pooler; no dropout (inference) and no
token-type embeddings (single-segment requests).

The reference reaches no Pallas kernel here (einsum, softmax, GELU,
LayerNorm), so the matrix products stay ``torch.matmul`` in fp32. The
reference's numerics are kept on purpose: GELU is the tanh approximation
(``jax.nn.gelu``'s default), LayerNorm is the explicit formula with
``layer_norm_eps``, the key mask is an additive -1e9, and pad rows
(``lengths == 0``) see their own position 0. TF32 is never enabled
here: a product runs at full fp32 unless the caller turned TF32 on.

The eager ``Layer`` classes of the reference (``BertModel`` and the heads)
are not ported yet (ROADMAP.md section A item 11).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device

__all__ = ["BertConfig", "bert_init_params", "bert_encode"]


@dataclasses.dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "gelu"
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    pad_token_id: int = 0


def bert_init_params(cfg: BertConfig, seed: int = 0,
                     device=None) -> Dict[str, torch.Tensor]:
    """Random stacked encoder params (fp32) on ``device`` (the card unless
    ``device="cpu"``): embeddings (word + position + LayerNorm),
    ``num_hidden_layers`` stacked transformer blocks and the pooler dense.
    Drawn from ``np.random.default_rng(seed)`` in the reference's order,
    so the same seed gives the same arrays in both packages."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    E, I = cfg.hidden_size, cfg.intermediate_size
    L = cfg.num_hidden_layers

    def w(*shape, scale=0.02):
        a = (rng.standard_normal(shape) * scale).astype(np.float32)
        return torch.from_numpy(a).to(dev)

    def ones(*shape):
        return torch.ones(shape, dtype=torch.float32, device=dev)

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=dev)

    return {
        "embed": w(cfg.vocab_size, E),
        "pos_embed": w(cfg.max_position_embeddings, E),
        "ln_embed_w": ones(E), "ln_embed_b": zeros(E),
        "layers": {
            "wq": w(L, E, E), "bq": zeros(L, E),
            "wk": w(L, E, E), "bk": zeros(L, E),
            "wv": w(L, E, E), "bv": zeros(L, E),
            "wo": w(L, E, E), "bo": zeros(L, E),
            "ln_attn_w": ones(L, E), "ln_attn_b": zeros(L, E),
            "w_in": w(L, E, I), "b_in": zeros(L, I),
            "w_out": w(L, I, E), "b_out": zeros(L, E),
            "ln_mlp_w": ones(L, E), "ln_mlp_b": zeros(L, E),
        },
        "pool_w": w(E, E), "pool_b": zeros(E),
    }


def _bert_ln(x, w, b, eps):
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * w + b


def bert_encode(params, cfg: BertConfig, ids, lengths) -> torch.Tensor:
    """Pooled sentence embeddings for a right-padded batch: ``ids [B, S]``
    integer, ``lengths [B]`` real token counts -> ``[B, E]`` fp32 on the
    params' device (the first-token tanh pooler). Pad rows (``lengths ==
    0``) attend only themselves; their pooled rows are never read."""
    dev = params["embed"].device
    ids = torch.as_tensor(ids).to(dev).long()
    lengths = torch.as_tensor(lengths).to(dev).long()
    B, S = ids.shape
    H = cfg.num_attention_heads
    E = cfg.hidden_size
    D = E // H
    eps = cfg.layer_norm_eps
    x = params["embed"][ids] + params["pos_embed"][None, :S]
    x = _bert_ln(x, params["ln_embed_w"], params["ln_embed_b"], eps)
    j = torch.arange(S, device=dev)
    # bidirectional length mask (keys beyond a row's length are invisible);
    # pad rows get their own position 0 so softmax stays finite
    visible = j[None, :] < lengths.clamp(min=1)[:, None]       # [B, S]
    bias = torch.where(visible, 0.0, -1e9).to(torch.float32)
    bias = bias[:, None, None, :]                               # [B,1,1,S]
    lp_all = params["layers"]
    scale = math.sqrt(float(D))
    for li in range(cfg.num_hidden_layers):
        lp = {k: v[li] for k, v in lp_all.items()}
        q = (x @ lp["wq"] + lp["bq"]).reshape(B, S, H, D)
        k = (x @ lp["wk"] + lp["bk"]).reshape(B, S, H, D)
        v = (x @ lp["wv"] + lp["bv"]).reshape(B, S, H, D)
        scores = torch.einsum("bshd,bthd->bhst", q, k) / scale
        p = torch.softmax(scores + bias, dim=-1)
        o = torch.einsum("bhst,bthd->bshd", p, v).reshape(B, S, E)
        x = _bert_ln(x + (o @ lp["wo"] + lp["bo"]),
                     lp["ln_attn_w"], lp["ln_attn_b"], eps)
        f = F.gelu(x @ lp["w_in"] + lp["b_in"], approximate="tanh") \
            @ lp["w_out"] + lp["b_out"]
        x = _bert_ln(x + f, lp["ln_mlp_w"], lp["ln_mlp_b"], eps)
    pooled = torch.tanh(x[:, 0] @ params["pool_w"] + params["pool_b"])
    return pooled.to(torch.float32)

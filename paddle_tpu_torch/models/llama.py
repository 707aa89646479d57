"""LLaMA-family decoder, inference core — counterpart of ``paddle_tpu/models/llama.py``.

The same stacked ``[L, ...]`` parameter layout as the JAX package (a plain
dict of tensors: ``embed``, ``layers/{wq,wk,wv,wo,w_gate,w_up,w_down,
ln_attn,ln_mlp}``, ``ln_f``, ``lm_head``), so a JAX parameter tree
converts leaf by leaf (``models.convert.params_from_jax``). Ported here:
the config, ``init_params``, the norm / RoPE / masked-attention helpers the
paged serving path uses, ``_mm`` with the weight-only int8 route, and the
quantization helpers. The dense training ``forward``, the MoE FFN and the
fused-norm kernel wait for the training slice.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch

from ..device import resolve_device
from ..kernels.quant_matmul import quantize_weights, weight_only_matmul

__all__ = ["LlamaConfig", "init_params", "quantize_params",
           "validate_quant_mode", "ensure_quantized", "QUANTIZE_MODES",
           "KV_QUANT_MODES"]


@dataclasses.dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 2048
    intermediate_size: int = 5504
    num_hidden_layers: int = 16
    num_attention_heads: int = 16
    num_key_value_heads: Optional[int] = None   # None -> MHA
    max_position_embeddings: int = 2048
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    tie_word_embeddings: bool = False
    use_fused_norm: bool = False     # the fused rms_norm kernel: training
    #                                  slice (raises here when set)
    dtype: Any = torch.float32       # activation/compute dtype
    param_dtype: Any = torch.float32  # storage dtype

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def kv_heads(self) -> int:
        return self.num_key_value_heads or self.num_attention_heads


def init_params(cfg: LlamaConfig, seed: int = 0, device=None) -> Dict:
    """Stacked-[L, ...] parameter dict: normal weights scaled by
    ``1/sqrt(fan_in)``, ones for the norms — the shapes and scheme of the
    JAX ``init_params``, drawn from a ``torch.Generator`` seeded with
    ``seed`` on ``device`` (the numbers differ from JAX's PRNG; tests
    that compare against JAX convert JAX's weights instead)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    E, I, V, L = (cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size,
                  cfg.num_hidden_layers)
    D = cfg.head_dim
    H, Hk = cfg.num_attention_heads, cfg.kv_heads
    pd = cfg.param_dtype

    def dense(shape, fan_in):
        w = torch.randn(shape, generator=gen, device=dev,
                        dtype=torch.float32)
        return w.div_(math.sqrt(fan_in)).to(pd)

    params = {
        "embed": dense((V, E), E),
        "layers": {
            "wq": dense((L, E, H * D), E),
            "wk": dense((L, E, Hk * D), E),
            "wv": dense((L, E, Hk * D), E),
            "wo": dense((L, H * D, E), H * D),
            "w_gate": dense((L, E, I), E),
            "w_up": dense((L, E, I), E),
            "w_down": dense((L, I, E), I),
            "ln_attn": torch.ones((L, E), dtype=pd, device=dev),
            "ln_mlp": torch.ones((L, E), dtype=pd, device=dev),
        },
        "ln_f": torch.ones((E,), dtype=pd, device=dev),
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = dense((E, V), E)
    return params


def _rms_norm(x, w, eps, use_kernels):
    if use_kernels:
        raise NotImplementedError(
            "use_fused_norm: the fused rms_norm kernel is ported with the "
            "training slice (ROADMAP.md section B)")
    xf = x.to(torch.float32)
    y = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (y * w.to(torch.float32)).to(x.dtype)


def _rope(x, cos, sin):
    """Rotate-half RoPE on ``x [B, S, H, D]`` with ``cos``/``sin`` ``[S, D]``
    or per-row ``[B, S, D]``."""
    d = x.shape[-1]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    rot = torch.cat([-x2, x1], dim=-1)
    if cos.dim() == 2:
        c, s = cos[None, :, None, :], sin[None, :, None, :]
    else:
        c, s = cos[:, :, None, :], sin[:, :, None, :]
    return x * c.to(x.dtype) + rot * s.to(x.dtype)


def _masked_sdpa(q, kk, vv, kv_mask):
    """Attention over an explicit KV set: ``q [B, T, H, D]`` against
    ``kk/vv [B, C, Hk, D]`` with ``kv_mask [B, T, C]`` (True = query t may
    attend key j). fp32 scores, GQA kv-head expansion, masked positions at
    -1e30 (their exp underflows to an exact 0.0).

    V at positions NO query may attend (the paged null block, stale KV in a
    reused block's tail) is zeroed, not merely zero-weighted: a poisoned
    request can park non-finite KV there, and 0 * NaN = NaN would wipe
    every other row. For finite KV the select is bit-invisible."""
    H, Hk = q.shape[2], kk.shape[2]
    pos_valid = kv_mask.any(dim=1)                       # [B, C]
    vv = vv.masked_fill(~pos_valid[:, :, None, None], 0)
    if Hk != H:
        rep = H // Hk
        kk = kk.repeat_interleave(rep, dim=2)
        vv = vv.repeat_interleave(rep, dim=2)
    scale = 1.0 / (q.shape[-1] ** 0.5)
    s = torch.einsum("bthd,bjhd->bhtj", q.to(torch.float32),
                     kk.to(torch.float32)) * scale
    s = s.masked_fill(~kv_mask[:, None], -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhtj,bjhd->bthd", p.to(vv.dtype), vv)


def _mm(h, lp, name, dt):
    """Weight matmul with the weight-only int8 route: when
    ``quantize_params`` replaced ``lp[name]`` with int8 and added
    ``lp[name + "_s"]`` scales, the product goes through
    ``kernels.quant_matmul.weight_only_matmul`` — the CUDA kernel on a
    card, the off-TPU formula ``h @ (w * s)`` on the CPU; otherwise the
    plain matmul in ``dt``."""
    w = lp[name]
    s = lp.get(name + "_s")
    if s is None:
        return h @ w.to(dt)
    lead = h.shape[:-1]
    h2 = h.reshape(-1, h.shape[-1]).to(dt).contiguous()
    out = weight_only_matmul(h2, w, s, out_dtype=dt)
    return out.reshape(*lead, w.shape[-1]).to(dt)


def quantize_params(params: Dict) -> Dict:
    """Per-output-channel symmetric int8 quantization of every dense
    projection (stacked ``[L, K, N]`` layer weights + lm_head); scales join
    the dict as ``<name>_s`` leaves. The embed stays fp (it is a gather,
    not a matmul)."""
    qp = dict(params)
    layers = dict(params["layers"])
    for name in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
        if name not in layers:
            continue
        qs = [quantize_weights(w) for w in layers[name]]
        layers[name] = torch.stack([q for q, _ in qs])
        layers[name + "_s"] = torch.stack([s for _, s in qs])
    qp["layers"] = layers
    if "lm_head" in params:
        qp["lm_head"], qp["lm_head_s"] = quantize_weights(params["lm_head"])
    return qp


QUANTIZE_MODES = (None, "int8")     # weight-only (ensure_quantized)
KV_QUANT_MODES = (None, "int8")     # paged KV-cache pools; composes with
#                                     the weight mode


def validate_quant_mode(mode, modes, what: str = "quantize"):
    """The one unknown-quantize-mode error: a ValueError naming the
    supported modes."""
    if mode not in modes:
        raise ValueError(f"unknown {what} mode {mode!r}; options: {modes}")
    return mode


def ensure_quantized(params: Dict, mode) -> Dict:
    """Validate a weight-only quantize mode and make the dict match it:
    ``None`` returns ``params`` untouched, ``"int8"`` runs
    :func:`quantize_params` unless the dict already carries the scale
    leaves (``wq_s``)."""
    validate_quant_mode(mode, QUANTIZE_MODES)
    if mode == "int8" and "wq_s" not in params.get("layers", {}):
        return quantize_params(params)
    return params

"""LLaMA-family decoder — counterpart of ``paddle_tpu/models/llama.py``.

The same stacked ``[L, ...]`` parameter layout as the JAX package (a plain
dict of tensors: ``embed``, ``layers/{wq,wk,wv,wo,w_gate,w_up,w_down,
ln_attn,ln_mlp}`` plus ``layers/moe_gate`` and ``[L, Ex, ...]`` expert
weights under MoE, ``ln_f``, ``lm_head``), so a JAX parameter tree converts
leaf by leaf (``models.convert.params_from_jax``). Ported here: the
config, ``init_params``, ``num_params``, the norm / RoPE / attention
helpers, ``_mm`` with the weight-only int8 route, the quantization
helpers, the GShard-routed MoE FFN (``_moe_ffn``, over
``distributed.moe.gshard_routing``) and the training path:
``decoder_layer``, ``forward`` (``return_aux`` for MoE), ``loss_fn``
(token-chunked cross-entropy; the MoE load-balancing term), the AdamW
update and ``make_train_step`` (``sentinel=True``: the health-guarded
step). ``cfg.use_kernels`` sends attention to the flash kernels
(``kernels.flash_attention``); ``cfg.use_fused_norm`` sends every RMSNorm
to the fused kernels (``kernels.rms_norm``) and the training forward's
RoPE with shared ``[S, D]`` tables to ``kernels.rope.apply_rope``;
``cfg.remat`` checkpoints each layer under ``cfg.remat_policy`` (full
remat or one of the JAX package's seven named policies, see
:func:`_remat_policy`). Context parallelism (``sep_axis``) is not ported
and raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..distributed.moe import gshard_routing
from ..health.sentinel import pack_health, sentinel_check
from ..kernels.flash_attention import flash_attention, flash_attention_with_lse
from ..kernels.quant_matmul import quantize_weights, weight_only_matmul
from ..kernels.rms_norm import rms_norm
from ..kernels.rope import apply_rope, rope_cos_sin

__all__ = ["LlamaConfig", "init_params", "num_params", "forward", "loss_fn",
           "make_train_step", "quantize_params", "validate_quant_mode",
           "ensure_quantized", "QUANTIZE_MODES", "KV_QUANT_MODES"]


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
    use_kernels: bool = False        # attention through the flash kernels
    use_fused_norm: bool = False     # the fused rms_norm / rope kernels
    dtype: Any = torch.float32       # activation/compute dtype
    param_dtype: Any = torch.float32  # storage dtype
    remat: bool = False              # checkpoint each decoder layer
    remat_policy: Optional[str] = None  # None / "nothing" = full remat, or
    #                                     a named policy (_remat_policy)
    sep_axis: Optional[str] = None   # context parallelism: raises (not
    #                                  ported)
    moe_num_experts: int = 0         # > 0: every FFN is that many
    #                                  GShard-routed SwiGLU experts
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01
    ce_chunks: int = 1               # > 1: token-chunked cross-entropy, each
    #                                  chunk's logits recomputed in backward

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def kv_heads(self) -> int:
        return self.num_key_value_heads or self.num_attention_heads


def num_params(cfg: LlamaConfig) -> int:
    """The parameter count of ``init_params(cfg)`` (the JAX formula)."""
    E, I, V, L = (cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size,
                  cfg.num_hidden_layers)
    kvd = cfg.kv_heads * cfg.head_dim
    ffn, gate = 3 * E * I, 0
    if cfg.moe_num_experts:
        ffn = cfg.moe_num_experts * 3 * E * I
        gate = E * cfg.moe_num_experts
    per_layer = E * E + 2 * E * kvd + E * E + ffn + gate + 2 * E
    n = V * E + L * per_layer + E
    if not cfg.tie_word_embeddings:
        n += E * V
    return n


def init_params(cfg: LlamaConfig, seed: int = 0, device=None) -> Dict:
    """Stacked-[L, ...] parameter dict: normal weights scaled by
    ``1/sqrt(fan_in)``, ones for the norms — the shapes and scheme of the
    JAX ``init_params``, drawn from a ``torch.Generator`` seeded with
    ``seed`` on ``device`` (the numbers differ from JAX's PRNG; tests
    that compare against JAX convert JAX's weights instead). MoE configs
    get ``[L, Ex, E, I]`` / ``[L, Ex, I, E]`` expert weights and a
    ``moe_gate [L, E, Ex]`` router, drawn last."""
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

    Ex = cfg.moe_num_experts
    ffn_shape = (L, Ex, E, I) if Ex else (L, E, I)
    ffn_dshape = (L, Ex, I, E) if Ex else (L, I, E)
    params = {
        "embed": dense((V, E), E),
        "layers": {
            "wq": dense((L, E, H * D), E),
            "wk": dense((L, E, Hk * D), E),
            "wv": dense((L, E, Hk * D), E),
            "wo": dense((L, H * D, E), H * D),
            "w_gate": dense(ffn_shape, E),
            "w_up": dense(ffn_shape, E),
            "w_down": dense(ffn_dshape, I),
            "ln_attn": torch.ones((L, E), dtype=pd, device=dev),
            "ln_mlp": torch.ones((L, E), dtype=pd, device=dev),
        },
        "ln_f": torch.ones((E,), dtype=pd, device=dev),
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = dense((E, V), E)
    if Ex:
        params["layers"]["moe_gate"] = dense((L, E, Ex), E)
    return params


def _embed(params: Dict, ids: torch.Tensor, dt) -> torch.Tensor:
    """``jnp.take(embed, ids, axis=0)`` with its fill semantics: ids in
    ``[-V, V)`` wrap like Python indices, anything else embeds as NaN."""
    emb = params["embed"]
    V = emb.shape[0]
    ids = ids.long()
    ok = (ids >= -V) & (ids < V)
    x = emb[torch.where(ids < 0, ids + V, ids).clamp(0, V - 1)].to(dt)
    return x.masked_fill(~ok[..., None], float("nan"))


def _rms_norm(x, w, eps, use_kernels):
    if use_kernels:
        return rms_norm(x, w, eps)
    xf = x.to(torch.float32)
    y = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (y * w.to(torch.float32)).to(x.dtype)


def _rope(x, cos, sin, use_kernels=False):
    """Rotate-half RoPE on ``x [B, S, H, D]`` with ``cos``/``sin`` ``[S, D]``
    or per-row ``[B, S, D]``. ``use_kernels`` with ``[S, D]`` tables runs
    ``kernels.rope.apply_rope`` (fp32 arithmetic); otherwise the tables are
    cast to x's dtype and applied with plain tensor ops."""
    if use_kernels and cos.dim() == 2:
        return apply_rope(x, cos, sin)
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
    not a matmul). MoE parameters raise (:func:`ensure_quantized`)."""
    _refuse_moe_int8(params)
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


def _refuse_moe_int8(params: Dict) -> None:
    """Weight-only int8 has no MoE form here: the expert weights ``[L, Ex,
    K, N]`` would need per-expert scales and an int8 route through the
    expert products, which the JAX package does not have either (its
    ``quantize_params`` takes the amax over the expert axis and its
    ``_moe_ffn`` ignores the scales)."""
    if "moe_gate" in params.get("layers", {}):
        raise ValueError(
            "quantize='int8' with moe_num_experts > 0 is not supported: the "
            "weight-only int8 route has no per-expert scales; serve an MoE "
            "model with quantize=None (kv_quant='int8' is allowed)")


def ensure_quantized(params: Dict, mode) -> Dict:
    """Validate a weight-only quantize mode and make the dict match it:
    ``None`` returns ``params`` untouched, ``"int8"`` runs
    :func:`quantize_params` unless the dict already carries the scale
    leaves (``wq_s``). ``"int8"`` on MoE parameters raises ``ValueError``
    naming ``quantize`` and ``moe_num_experts``."""
    validate_quant_mode(mode, QUANTIZE_MODES)
    if mode == "int8":
        _refuse_moe_int8(params)
    if mode == "int8" and "wq_s" not in params.get("layers", {}):
        return quantize_params(params)
    return params


# ---------------------------------------------------------------------------
# the training forward
# ---------------------------------------------------------------------------

# The JAX package's named jax.checkpoint policies (llama.py:_remat_policy)
# by what each keeps across the backward: the two dot policies keep the
# projection outputs; the others keep the tensors the JAX layer names with
# checkpoint_name ("qk": q and k after RoPE, "v_proj": v, "attn_out": the
# attention output [B, S, H*D]) and the flash kernel's VJP names
# ("flash_out", "flash_lse").
_DOTS = "dots"
_REMAT_POLICIES = {
    "dots": _DOTS,
    "dots_saveable": _DOTS,
    "save_attn": frozenset({"attn_out"}),
    "save_qkv_attn": frozenset({"attn_out", "qk", "v_proj"}),
    "save_flash": frozenset({"flash_out", "flash_lse", "qk", "v_proj"}),
    "save_flash_qk": frozenset({"flash_out", "flash_lse", "qk"}),
    "save_flash_only": frozenset({"flash_out", "flash_lse"}),
}


def _remat_policy(name: Optional[str]):
    """``cfg.remat_policy`` -> what the policy keeps: ``None`` for full
    remat (``None`` / ``"nothing"``: each layer recomputed whole in
    backward), ``"dots"`` for ``"dots"`` and ``"dots_saveable"``, else the
    frozenset of kept names. An unknown name raises ``ValueError`` (the
    JAX message)."""
    if name is None or name == "nothing":
        return None
    if name not in _REMAT_POLICIES:
        raise ValueError(f"unknown remat_policy {name!r}; "
                         f"options: {sorted(_REMAT_POLICIES)} or None")
    return _REMAT_POLICIES[name]


def _check_training_config(cfg: LlamaConfig) -> None:
    if cfg.sep_axis is not None:
        raise NotImplementedError(
            "sep_axis: context-parallel (ring) attention is not ported yet "
            "(ROADMAP.md section A, training queue item (iii))")


def _attention(q, k, v, cfg: LlamaConfig, segment_ids=None):
    """Causal self-attention on ``[B, S, H(k), D]``; ``segment_ids [B, S]``
    confines attention within packed sequences. ``cfg.use_kernels`` runs
    the flash kernels; otherwise one fp32 masked softmax, rows with no
    visible key output 0."""
    if cfg.use_kernels:
        return flash_attention(q, k, v, causal=True, segment_ids=segment_ids)
    B, S, H, D = q.shape
    Hk = k.shape[2]
    if Hk != H:
        k = k.repeat_interleave(H // Hk, dim=2)
        v = v.repeat_interleave(H // Hk, dim=2)
    scale = 1.0 / math.sqrt(D)
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32),
                     k.to(torch.float32)) * scale
    mask = torch.tril(torch.ones((S, S), dtype=torch.bool,
                                 device=q.device))[None, None]
    if segment_ids is not None:
        seg = segment_ids
        mask = mask & (seg[:, None, :, None] == seg[:, None, None, :])
    s = s.masked_fill(~mask, -1e30)
    p = torch.softmax(s, dim=-1)
    if segment_ids is not None:
        p = torch.where(mask.any(dim=-1, keepdim=True), p, 0.0)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)
    return o.to(q.dtype)


def _moe_ffn(lp: Dict, h, cfg: LlamaConfig):
    """GShard-routed SwiGLU experts on ``h [B, S, E]`` -> ``(out, aux,
    kept)``, the JAX ``_moe_ffn``: capacity ``max(1, ceil(T *
    capacity_factor * top_k / Ex))`` over the call's ``T = B * S`` tokens
    (padding rows included), the router in fp32, ``dispatch`` and
    ``combine`` cast to the activation dtype before the einsums, one
    SwiGLU per expert. ``kept`` (a 0-d fp32 tensor) counts the (token,
    choice) pairs that found a place in their expert's queue; JAX returns
    the dropped ones, ``T * top_k - kept``, which the paged entry points
    compute once over all layers (``generation._dropped``)."""
    B, S, M = h.shape
    T = B * S
    Ex = cfg.moe_num_experts
    cap = max(1, math.ceil(T * cfg.moe_capacity_factor * cfg.moe_top_k / Ex))
    h2 = h.reshape(T, M)
    logits = h2.to(torch.float32) @ lp["moe_gate"].to(torch.float32)
    combine, dispatch, aux = gshard_routing(logits, cfg.moe_top_k, cap)
    dt = h2.dtype
    einp = torch.einsum("tec,tm->ecm", dispatch.to(dt), h2)
    g = F.silu(torch.bmm(einp, lp["w_gate"].to(dt))) * \
        torch.bmm(einp, lp["w_up"].to(dt))
    eout = torch.bmm(g, lp["w_down"].to(dt))
    y = torch.einsum("tec,ecm->tm", combine.to(dt), eout)
    return y.reshape(B, S, M), aux, dispatch.sum()


def _ffn_tail(lp: Dict, x, cfg: LlamaConfig):
    """The post-attention half of a decoder block on ``x [B, T, E]``:
    pre-norm, then dense SwiGLU or the routed MoE FFN. Returns ``(block
    output, aux, kept)`` (:func:`_moe_ffn`): 0-d fp32 tensors under MoE,
    ``0.0`` for a dense FFN."""
    dt = cfg.dtype
    h = _rms_norm(x, lp["ln_mlp"], cfg.rms_norm_eps, cfg.use_fused_norm)
    if cfg.moe_num_experts:
        y, aux, kept = _moe_ffn(lp, h, cfg)
        return x + y, aux, kept
    g = F.silu(_mm(h, lp, "w_gate", dt)) * _mm(h, lp, "w_up", dt)
    return x + _mm(g, lp, "w_down", dt), 0.0, 0.0


def _tail(lp: Dict, x, o, cfg: LlamaConfig):
    """``x + o @ wo``, then the FFN half: ``(block output, aux)``, the
    MoE load-balancing loss (``0.0`` for a dense FFN)."""
    out, aux, _ = _ffn_tail(lp, x + _mm(o, lp, "wo", cfg.dtype), cfg)
    return out, aux


# the attention inputs: (name, projection weight, the JAX name that keeps
# it: q and k after RoPE, v)
_QKV = (("q", "wq", "qk"), ("k", "wk", "qk"), ("v", "wv", "v_proj"))


def _heads(t, name: str, cfg: LlamaConfig):
    """A projection output ``[B, S, N]`` as ``[B, S, heads, D]``."""
    H = cfg.num_attention_heads if name == "q" else cfg.kv_heads
    return t.reshape(*t.shape[:2], H, cfg.head_dim)


def decoder_layer(lp: Dict, x, cos, sin, cfg: LlamaConfig, segment_ids=None):
    """One pre-norm decoder block on un-stacked layer params ``lp``; the
    residual stream ``x [B, S, E]`` stays in ``cfg.dtype``. Returns
    ``(output, aux)``: the MoE load-balancing loss, ``0.0`` for a dense
    FFN (JAX's dense layer returns the output alone)."""
    return _attend(lp, x, {}, cos, sin, cfg, segment_ids, True)


def _qkv_from(lp: Dict, x, held: Dict, cos, sin, cfg: LlamaConfig):
    """``(q, k, v)`` of the layer input ``x``: the tensors ``held`` names,
    the others computed here (norm, projection, RoPE for q and k)."""
    out, h = [], None
    for n, w, _ in _QKV:
        t = held.get(n)
        if t is None:
            if h is None:
                h = _rms_norm(x, lp["ln_attn"], cfg.rms_norm_eps,
                              cfg.use_fused_norm)
            t = _heads(_mm(h, lp, w, cfg.dtype), n, cfg)
            if n != "v":
                t = _rope(t, cos, sin, cfg.use_fused_norm)
        out.append(t)
    return tuple(out)


def _attend(lp: Dict, x, held: Dict, cos, sin, cfg: LlamaConfig, seg,
            tail: bool):
    """q/k/v (``held``; the rest from ``x``), attention, then the tail
    when ``tail`` (else the attention output ``[B, S, H*D]``)."""
    q, k, v = _qkv_from(lp, x, held, cos, sin, cfg)
    o = _attention(q, k, v, cfg, seg).reshape(x.shape)
    return _tail(lp, x, o, cfg) if tail else o


class _NormProj(torch.autograd.Function):
    """``h = rms_norm(x, w_ln)``, then ``h @ w`` for each projection
    weight (through ``_mm``). Saves ``x`` and the weights, not ``h``: the
    backward recomputes ``h`` from ``x`` once and takes the projections'
    and the norm's gradients from it. So the projections run once a step
    while their input is not kept, as in the JAX policies that keep the
    projection outputs or q/k/v and recompute only the norm."""

    @staticmethod
    def forward(ctx, x, w_ln, cfg, names, *ws):
        h = _rms_norm(x, w_ln, cfg.rms_norm_eps, cfg.use_fused_norm)
        ctx.save_for_backward(x, w_ln, *ws)
        ctx.cfg = cfg
        return tuple(_mm(h, {n: w}, n, cfg.dtype) for n, w in zip(names, ws))

    @staticmethod
    def backward(ctx, *gys):
        x, w_ln, *ws = ctx.saved_tensors
        cfg = ctx.cfg
        dt = cfg.dtype
        with torch.enable_grad():
            xd = x.detach().requires_grad_()
            wd = w_ln.detach().requires_grad_()
            h = _rms_norm(xd, wd, cfg.rms_norm_eps, cfg.use_fused_norm)
        h2 = h.detach().reshape(-1, h.shape[-1])
        dh, dws = None, []
        for w, gy in zip(ws, gys):
            g2 = gy.reshape(-1, gy.shape[-1]).to(dt)
            part = g2 @ w.to(dt).T
            dh = part if dh is None else dh + part
            dws.append((h2.T @ g2).to(w.dtype))
        dx, dw_ln = torch.autograd.grad(h, (xd, wd), dh.reshape(h.shape))
        return (dx, dw_ln, None, None, *dws)


def _norm_proj(lp: Dict, x, names: str, cfg: LlamaConfig) -> Dict:
    """The projections of ``names`` (``"qkv"`` or an ordered part of it)
    of the layer input ``x`` through :class:`_NormProj`, as heads, RoPE
    not applied."""
    ws = tuple("w" + n for n in names)
    outs = _NormProj.apply(x, lp["ln_attn"], cfg, ws, *(lp[w] for w in ws))
    return {n: _heads(t, n, cfg) for n, t in zip(names, outs)}


def _rope_qk(held: Dict, cos, sin, cfg: LlamaConfig) -> Dict:
    return {n: t if n == "v" else _rope(t, cos, sin, cfg.use_fused_norm)
            for n, t in held.items()}


def _policy_layer(lp: Dict, x, cos, sin, cfg: LlamaConfig, seg, keep):
    """One decoder block under a named remat policy (``keep`` from
    :func:`_remat_policy`): what ``keep`` names outlives the forward,
    everything else is recomputed in backward from the layer input ``x``.

    * ``"dots"``: the q/k/v projections run once (:class:`_NormProj`;
      their outputs are kept); RoPE and attention are recomputed; the
      tail runs outside any recompute, so autograd keeps its activations.
    * flash residuals kept (``save_flash*`` with ``cfg.use_kernels``): the
      flash forward runs once and keeps ``out`` and ``lse``; the q/k/v
      the policy does not keep are dropped after the forward and rebuilt
      from ``x`` for the flash backward (``regen_inputs``).
    * otherwise the attention is recomputed from the kept q/k/v (the
      rest rebuilt from ``x``), with the tail in the same region unless
      ``attn_out`` is kept.

    A recomputed region is re-run whole by ``torch.utils.checkpoint``
    (JAX's recompute is dead-code-eliminated): ROADMAP.md section C lists
    the GEMMs that run more often than in JAX."""
    def ckpt(fn, *args):
        return checkpoint(fn, *args, use_reentrant=False)

    if keep == _DOTS:
        held = _norm_proj(lp, x, "qkv", cfg)
        o = ckpt(lambda: _attend(lp, x, _rope_qk(held, cos, sin, cfg), cos,
                                 sin, cfg, seg, False))
        return _tail(lp, x, o, cfg)
    names = "".join(n for n, _, name in _QKV if name in keep)
    if cfg.use_kernels and "flash_out" in keep:
        q, k, v = _rope_qk(_norm_proj(lp, x, "qkv", cfg), cos, sin,
                           cfg).values()
        regen = None
        if names != "qkv":
            held = {n: t for n, t in zip("qkv", (q, k, v)) if n in names}

            def regen():
                return _qkv_from(lp, x, held, cos, sin, cfg)
        o, _ = flash_attention_with_lse(q, k, v, causal=True,
                                        segment_ids=seg, regen_inputs=regen)
        return ckpt(_tail, lp, x, o.reshape(x.shape), cfg)
    held = _rope_qk(_norm_proj(lp, x, names, cfg), cos, sin, cfg) \
        if names else {}
    if "attn_out" in keep:
        o = ckpt(_attend, lp, x, held, cos, sin, cfg, seg, False)
        return ckpt(_tail, lp, x, o, cfg)
    return ckpt(_attend, lp, x, held, cos, sin, cfg, seg, True)


def forward(params: Dict, input_ids, cfg: LlamaConfig, segment_ids=None,
            position_ids=None, return_aux: bool = False,
            return_hidden: bool = False):
    """``input_ids [B, S] -> logits [B, S, V]`` in ``cfg.dtype``.

    ``segment_ids [B, S]`` confines attention within packed sequences;
    ``position_ids`` (``[S]`` or per-row ``[B, S]``) set the RoPE positions
    (default ``0..S-1``). The layers run as a Python loop over the stacked
    ``[L, ...]`` leaves; ``cfg.remat`` checkpoints each under
    ``cfg.remat_policy``: full remat wraps the layer in
    ``torch.utils.checkpoint.checkpoint(use_reentrant=False)`` (backward
    re-runs the whole layer, the flash forward included), a named policy
    keeps what it names (:func:`_policy_layer`). ``return_aux`` returns
    ``(logits, aux)``: the mean MoE load-balancing loss over the layers
    (0.0 for a dense model). ``return_hidden`` returns the final-norm
    hidden states instead.
    """
    _check_training_config(cfg)
    keep = _remat_policy(cfg.remat_policy) if cfg.remat else None
    dev = params["embed"].device
    ids = torch.as_tensor(input_ids, device=dev)
    B, S = ids.shape
    x = _embed(params, ids, cfg.dtype)
    if position_ids is None:
        cos, sin = rope_cos_sin(S, cfg.head_dim, cfg.rope_theta, device=dev)
    else:
        cos, sin = rope_cos_sin(S, cfg.head_dim, cfg.rope_theta,
                                position_ids=torch.as_tensor(position_ids,
                                                             device=dev))
    seg = None if segment_ids is None else torch.as_tensor(segment_ids,
                                                           device=dev)
    # unbind, not one index per layer: the gradient of the L slices then
    # lands in each stacked leaf as one stack, where L indexing views would
    # each add a zero-filled full-size gradient into the leaf
    names = list(params["layers"])
    slices = zip(*(params["layers"][n].unbind(0) for n in names))
    auxes = []
    for l, ws in zip(range(cfg.num_hidden_layers), slices):
        lp = dict(zip(names, ws))
        if not cfg.remat:
            x, aux = decoder_layer(lp, x, cos, sin, cfg, seg)
        elif keep is None:
            x, aux = checkpoint(decoder_layer, lp, x, cos, sin, cfg, seg,
                                use_reentrant=False)
        else:
            x, aux = _policy_layer(lp, x, cos, sin, cfg, seg, keep)
        auxes.append(aux)
    x = _rms_norm(x, params["ln_f"], cfg.rms_norm_eps, cfg.use_fused_norm)
    if return_hidden:
        return x
    if cfg.tie_word_embeddings:
        logits = x @ params["embed"].T.to(cfg.dtype)
    else:
        logits = _mm(x, params, "lm_head", cfg.dtype)
    if return_aux:
        aux = (torch.stack(auxes).mean() if cfg.moe_num_experts else
               torch.zeros((), dtype=torch.float32, device=dev))
        return logits, aux
    return logits


def _ce_chunk(hc, lc, head, dt):
    """(summed CE, valid-token count) of one token chunk."""
    logits = (hc @ head.to(dt)).to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    tgt = logits.gather(-1, lc.clamp(min=0)[..., None])[..., 0]
    m = lc >= 0
    return torch.where(m, lse - tgt, 0.0).sum(), m.sum()


def loss_fn(params: Dict, input_ids, labels, cfg: LlamaConfig,
            segment_ids=None, position_ids=None):
    """Mean next-token cross-entropy over the tokens whose label is not
    -100 (labels already shifted). MoE configs add ``cfg.moe_aux_weight *``
    the load-balancing loss.

    ``cfg.ce_chunks > 1`` computes it over token chunks, each checkpointed,
    so the fp32 ``[T, V]`` logits and their gradient never live at once;
    the token count must divide into the chunks. MoE configs ignore it, as
    the JAX ``loss_fn`` does."""
    dev = params["embed"].device
    labels = torch.as_tensor(labels, device=dev).long()
    if cfg.ce_chunks > 1 and not cfg.moe_num_experts:
        T, C = labels.numel(), cfg.ce_chunks
        if T % C:
            raise ValueError(f"tokens {T} not divisible by ce_chunks {C}")
        hidden = forward(params, input_ids, cfg, segment_ids, position_ids,
                         return_hidden=True)
        head = (params["embed"].T if cfg.tie_word_embeddings
                else params["lm_head"])
        h2 = hidden.reshape(C, T // C, hidden.shape[-1])
        lbl = labels.reshape(C, T // C)
        tot, cnt = 0.0, 0
        for c in range(C):
            s, n = checkpoint(_ce_chunk, h2[c], lbl[c], head, cfg.dtype,
                              use_reentrant=False)
            tot, cnt = tot + s, cnt + n
        return tot / cnt.clamp(min=1)
    logits, aux = forward(params, input_ids, cfg, segment_ids,
                          position_ids, return_aux=True)
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    tgt = logits.gather(-1, labels.clamp(min=0)[..., None])[..., 0]
    mask = labels >= 0
    per_tok = torch.where(mask, lse - tgt, 0.0)
    ce = per_tok.sum() / mask.sum().clamp(min=1)
    return ce + cfg.moe_aux_weight * aux


# ---------------------------------------------------------------------------
# the train step (AdamW, fp32 moment arithmetic)
# ---------------------------------------------------------------------------

def _tree_map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k])]
    return [tree]


def _adamw_init(params: Dict, opt_dtype=torch.float32) -> Dict:
    """Zero moments in ``opt_dtype`` and an int32 step counter."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=opt_dtype, device=p.device)
    return {"m": _tree_map(zeros, params), "v": _tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32,
                                device=_leaves(params)[0].device)}


def _adamw_apply(params: Dict, grads: Dict, opt_state: Dict, *, lr, beta1,
                 beta2, eps, weight_decay, opt_dtype, skip=None):
    """One AdamW update, the JAX arithmetic: fp32 moments, ``u =
    (m / bc1) / (sqrt(v / bc2) + eps) + weight_decay * p``, moments stored
    in ``opt_dtype``. ``skip`` (a bool scalar) makes the update an exact
    no-op through the same gates as the JAX version.

    Updates the parameter and moment tensors IN PLACE (call it under
    ``torch.no_grad()``) and returns ``(params, opt_state)`` holding them,
    with a new step tensor."""
    step = opt_state["step"]
    if skip is None:
        step = step + 1
        t = step.to(torch.float32)
        b1, b2, c1, c2, lr_eff = beta1, beta2, 1 - beta1, 1 - beta2, lr
    else:
        skip = torch.as_tensor(skip, device=step.device)
        step = step + (~skip).to(torch.int32)
        # a skipped FIRST step leaves t = 0 and bc1 = 0: clamp, as in JAX
        t = step.to(torch.float32).clamp(min=1.0)
        b1 = torch.where(skip, 1.0, beta1)
        b2 = torch.where(skip, 1.0, beta2)
        c1 = torch.where(skip, 0.0, 1 - beta1)
        c2 = torch.where(skip, 0.0, 1 - beta2)
        lr_eff = torch.where(skip, 0.0, lr)
    bc1 = 1.0 - beta1 ** t
    bc2 = 1.0 - beta2 ** t

    def upd(p, g, m, v):
        g = g.to(torch.float32)
        if skip is not None:
            g = torch.where(skip, 0.0, g)
        mf = b1 * m.to(torch.float32) + c1 * g
        vf = b2 * v.to(torch.float32) + c2 * (g * g)
        u = (mf / bc1) / (torch.sqrt(vf / bc2) + eps)
        pf = p.to(torch.float32)
        if weight_decay:
            u = u + weight_decay * pf
        p.copy_(pf - lr_eff * u)
        m.copy_(mf)
        v.copy_(vf)

    for p, g, m, v in zip(_leaves(params), _leaves(grads),
                          _leaves(opt_state["m"]), _leaves(opt_state["v"])):
        upd(p, g, m, v)
    return params, {"m": opt_state["m"], "v": opt_state["v"], "step": step}


def make_train_step(cfg: LlamaConfig, lr: float = 3e-4, beta1=0.9,
                    beta2=0.95, eps=1e-8, weight_decay=0.0,
                    opt_dtype=torch.float32, grad_dtype=None,
                    sentinel: bool = False, spike_factor=None,
                    spike_warmup=None):
    """Returns ``(init_opt_state, train_step)``.

    ``train_step(params, opt_state, input_ids, labels) -> (params,
    opt_state, loss)``: :func:`loss_fn` and its gradient by autograd, then
    one AdamW update (fp32 moment arithmetic; ``opt_dtype`` is the moments'
    storage dtype, ``grad_dtype`` rounds every gradient first). Unlike the
    JAX step it is not pure: the update writes the parameter and moment
    tensors IN PLACE under ``torch.no_grad()`` (the returned dicts hold the
    same tensors), which saves a second copy of the model and optimizer
    state. ``loss`` is a detached 0-d fp32 tensor.

    ``sentinel=True`` returns the health-guarded step instead:
    ``(params, opt_state, sent, input_ids, labels) -> (params, opt_state,
    sent, health)`` with ``sent`` from ``health.sentinel_init()`` and
    ``health`` the packed ``[loss, bad, ema]`` vector
    (``health.unpack_health``). The verdict (``health.sentinel_check``
    with ``spike_factor`` / ``spike_warmup``) gates the update inside
    ``_adamw_apply(skip=bad)``, on the device: a bad step leaves every
    parameter and moment tensor with the bits it had and the step count
    unchanged; a good step is bit-identical to the unguarded step.
    """

    def init_opt_state(params):
        return _adamw_init(params, opt_dtype)

    def loss_and_grads(params, input_ids, labels):
        leaves = _leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        loss = loss_fn(params, input_ids, labels, cfg)
        grads = torch.autograd.grad(loss, leaves)
        if grad_dtype is not None:
            grads = [g.to(grad_dtype) for g in grads]
        it = iter(grads)
        return loss.detach(), _tree_map(lambda _: next(it), params)

    def update(params, grads, opt_state, skip=None):
        with torch.no_grad():
            return _adamw_apply(
                params, grads, opt_state, lr=lr, beta1=beta1, beta2=beta2,
                eps=eps, weight_decay=weight_decay, opt_dtype=opt_dtype,
                skip=skip)

    def train_step(params, opt_state, input_ids, labels):
        loss, grads = loss_and_grads(params, input_ids, labels)
        params, opt_state = update(params, grads, opt_state)
        return params, opt_state, loss

    def train_step_sentinel(params, opt_state, sent, input_ids, labels):
        loss, grads = loss_and_grads(params, input_ids, labels)
        bad, sent = sentinel_check(loss, sent, spike_factor=spike_factor,
                                   warmup=spike_warmup)
        params, opt_state = update(params, grads, opt_state, skip=bad)
        return params, opt_state, sent, pack_health(loss, bad, sent)

    return init_opt_state, (train_step_sentinel if sentinel else train_step)

"""LLaMA-family decoder — counterpart of ``paddle_tpu/models/llama.py``.

The same stacked ``[L, ...]`` parameter layout as the JAX package (a plain
dict of tensors: ``embed``, ``layers/{wq,wk,wv,wo,w_gate,w_up,w_down,
ln_attn,ln_mlp}``, ``ln_f``, ``lm_head``), so a JAX parameter tree
converts leaf by leaf (``models.convert.params_from_jax``). Ported here:
the config, ``init_params``, ``num_params``, the norm / RoPE / attention
helpers, ``_mm`` with the weight-only int8 route, the quantization
helpers, and the dense training path: ``decoder_layer``, ``forward``,
``loss_fn`` (with token-chunked cross-entropy), the AdamW update and
``make_train_step``. ``cfg.use_kernels`` sends attention to the flash
kernels (``kernels.flash_attention``); ``cfg.use_fused_norm`` sends every
RMSNorm to the fused kernels (``kernels.rms_norm``) and the training
forward's RoPE with shared ``[S, D]`` tables to ``kernels.rope.apply_rope``;
``cfg.remat`` checkpoints each layer. Not ported yet, and raising
``NotImplementedError`` naming the ROADMAP.md item that brings them: the
named remat policies, the health sentinel, MoE and context parallelism
(``sep_axis``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..kernels.flash_attention import flash_attention
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
    remat_policy: Optional[str] = None  # None / "nothing" = full remat; the
    #                                     named policies raise (not ported)
    sep_axis: Optional[str] = None   # context parallelism: raises (not
    #                                  ported)
    moe_num_experts: int = 0         # MoE FFN: raises when > 0 (not ported)
    ce_chunks: int = 1               # > 1: token-chunked cross-entropy, each
    #                                  chunk's logits recomputed in backward

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def kv_heads(self) -> int:
        return self.num_key_value_heads or self.num_attention_heads


def num_params(cfg: LlamaConfig) -> int:
    """The parameter count of ``init_params(cfg)`` (the JAX formula for a
    dense model; an MoE config raises as ``forward`` does)."""
    _check_training_config(cfg)
    E, I, V, L = (cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size,
                  cfg.num_hidden_layers)
    kvd = cfg.kv_heads * cfg.head_dim
    per_layer = E * E + 2 * E * kvd + E * E + 3 * E * I + 2 * E
    n = V * E + L * per_layer + E
    if not cfg.tie_word_embeddings:
        n += E * V
    return n


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


# ---------------------------------------------------------------------------
# the dense training forward
# ---------------------------------------------------------------------------

# the JAX package's named jax.checkpoint policies (llama.py:_remat_policy)
_REMAT_POLICIES = ("dots", "dots_saveable", "save_attn", "save_qkv_attn",
                   "save_flash", "save_flash_qk", "save_flash_only")


def _remat_policy(name: Optional[str]) -> None:
    """Validate ``cfg.remat_policy``: ``None`` / ``"nothing"`` is full remat
    (each layer recomputed whole in backward), the only policy the port
    runs; a named policy raises ``NotImplementedError``, an unknown name
    ``ValueError`` (the JAX message)."""
    if name is None or name == "nothing":
        return None
    if name not in _REMAT_POLICIES:
        raise ValueError(f"unknown remat_policy {name!r}; "
                         f"options: {sorted(_REMAT_POLICIES)} or None")
    raise NotImplementedError(
        f"remat_policy {name!r}: the named remat policies are not ported yet "
        f"(ROADMAP.md section A, training queue item (i)); use None (full "
        f"remat)")


def _check_training_config(cfg: LlamaConfig) -> None:
    if cfg.moe_num_experts:
        raise NotImplementedError(
            "moe_num_experts > 0: the MoE FFN is not ported yet (ROADMAP.md "
            "section A, training queue item (ii))")
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


def _ffn_tail(lp: Dict, x, cfg: LlamaConfig):
    """The post-attention half of a decoder block on ``x [B, T, E]``:
    pre-norm + dense SwiGLU."""
    dt = cfg.dtype
    h = _rms_norm(x, lp["ln_mlp"], cfg.rms_norm_eps, cfg.use_fused_norm)
    g = torch.nn.functional.silu(_mm(h, lp, "w_gate", dt)) * \
        _mm(h, lp, "w_up", dt)
    return x + _mm(g, lp, "w_down", dt)


def decoder_layer(lp: Dict, x, cos, sin, cfg: LlamaConfig, segment_ids=None):
    """One pre-norm decoder block on un-stacked layer params ``lp``; the
    residual stream ``x [B, S, E]`` stays in ``cfg.dtype``."""
    B, S, E = x.shape
    H, Hk, D = cfg.num_attention_heads, cfg.kv_heads, cfg.head_dim
    dt = cfg.dtype
    h = _rms_norm(x, lp["ln_attn"], cfg.rms_norm_eps, cfg.use_fused_norm)
    q = _rope(_mm(h, lp, "wq", dt).reshape(B, S, H, D), cos, sin,
              cfg.use_fused_norm)
    k = _rope(_mm(h, lp, "wk", dt).reshape(B, S, Hk, D), cos, sin,
              cfg.use_fused_norm)
    v = _mm(h, lp, "wv", dt).reshape(B, S, Hk, D)
    o = _attention(q, k, v, cfg, segment_ids).reshape(B, S, H * D)
    return _ffn_tail(lp, x + _mm(o, lp, "wo", dt), cfg)


def forward(params: Dict, input_ids, cfg: LlamaConfig, segment_ids=None,
            position_ids=None, return_hidden: bool = False):
    """``input_ids [B, S] -> logits [B, S, V]`` in ``cfg.dtype``.

    ``segment_ids [B, S]`` confines attention within packed sequences;
    ``position_ids`` (``[S]`` or per-row ``[B, S]``) set the RoPE positions
    (default ``0..S-1``). The layers run as a Python loop over the stacked
    ``[L, ...]`` leaves; ``cfg.remat`` wraps each in
    ``torch.utils.checkpoint.checkpoint(use_reentrant=False)``, so backward
    re-runs the whole layer (the flash forward included).
    ``return_hidden`` returns the final-norm hidden states instead.
    """
    _check_training_config(cfg)
    if cfg.remat:
        _remat_policy(cfg.remat_policy)
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
    for l, ws in zip(range(cfg.num_hidden_layers), slices):
        lp = dict(zip(names, ws))
        if cfg.remat:
            x = checkpoint(decoder_layer, lp, x, cos, sin, cfg, seg,
                           use_reentrant=False)
        else:
            x = decoder_layer(lp, x, cos, sin, cfg, seg)
    x = _rms_norm(x, params["ln_f"], cfg.rms_norm_eps, cfg.use_fused_norm)
    if return_hidden:
        return x
    if cfg.tie_word_embeddings:
        return x @ params["embed"].T.to(cfg.dtype)
    return _mm(x, params, "lm_head", cfg.dtype)


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
    -100 (labels already shifted).

    ``cfg.ce_chunks > 1`` computes it over token chunks, each checkpointed,
    so the fp32 ``[T, V]`` logits and their gradient never live at once;
    the token count must divide into the chunks."""
    dev = params["embed"].device
    labels = torch.as_tensor(labels, device=dev).long()
    if cfg.ce_chunks > 1:
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
    logits = forward(params, input_ids, cfg, segment_ids,
                     position_ids).to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    tgt = logits.gather(-1, labels.clamp(min=0)[..., None])[..., 0]
    mask = labels >= 0
    per_tok = torch.where(mask, lse - tgt, 0.0)
    return per_tok.sum() / mask.sum().clamp(min=1)


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
                    sentinel: bool = False):
    """Returns ``(init_opt_state, train_step)``.

    ``train_step(params, opt_state, input_ids, labels) -> (params,
    opt_state, loss)``: :func:`loss_fn` and its gradient by autograd, then
    one AdamW update (fp32 moment arithmetic; ``opt_dtype`` is the moments'
    storage dtype, ``grad_dtype`` rounds every gradient first). Unlike the
    JAX step it is not pure: the update writes the parameter and moment
    tensors IN PLACE under ``torch.no_grad()`` (the returned dicts hold the
    same tensors), which saves a second copy of the model and optimizer
    state. ``loss`` is a detached 0-d fp32 tensor.

    ``sentinel=True`` (the health-guarded step) is not ported yet.
    """
    if sentinel:
        raise NotImplementedError(
            "sentinel=True: the health sentinel is not ported yet "
            "(ROADMAP.md section A, training queue item (i))")

    def init_opt_state(params):
        return _adamw_init(params, opt_dtype)

    def train_step(params, opt_state, input_ids, labels):
        leaves = _leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        loss = loss_fn(params, input_ids, labels, cfg)
        grads = torch.autograd.grad(loss, leaves)
        if grad_dtype is not None:
            grads = [g.to(grad_dtype) for g in grads]
        it = iter(grads)
        grads = _tree_map(lambda _: next(it), params)
        with torch.no_grad():
            params, opt_state = _adamw_apply(
                params, grads, opt_state, lr=lr, beta1=beta1, beta2=beta2,
                eps=eps, weight_decay=weight_decay, opt_dtype=opt_dtype)
        return params, opt_state, loss.detach()

    return init_opt_state, train_step

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
:func:`_remat_policy`). :func:`shard_serving_params` lays params out for
serving tensor parallelism. :func:`param_specs`, :func:`batch_spec` and
:func:`shard_params` lay them out for hybrid-parallel training (dp x mp x
sharding over a mesh); ``forward``, ``loss_fn`` and ``make_train_step``
take such a sharded tree and run the sharded path (its design:
:func:`_sharded_trunk`); under MoE, ``cfg.ep_axis`` lays the experts out
E/ep over the expert-parallel axis, and the router runs over the global
batch (:func:`_sharded_moe`). ``cfg.sep_axis`` runs context parallelism: the
attention of every layer as ring or Ulysses attention (``cfg.cp_impl``)
over the hybrid group's ``sep`` ranks on unsharded params, and the
sequence split over ``sep`` in the sharded path. :func:`to_pp_layout`,
:func:`pp_param_specs` and :func:`make_pp_train_step` run the pipelined
step (dp x pp, and pp x ep under MoE, over a mesh, the ring schedule of
``distributed.pipeline``). :func:`moe_kept` counts what each MoE layer's
router kept.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..distributed.collective import (ReduceOp, all_reduce_sum,
                                      copy_to_group, gather_to, reduce_ranks)
from ..distributed.context_parallel import (cp_attention,
                                            sep_parallel_attention)
from ..distributed.moe import gshard_routing
from ..distributed.pipeline import ring_schedule
from ..distributed.sharding import (ShardedTensor, assemble, shard_to_mesh,
                                    shard_tree, spec_axes)
from ..distributed.topology import get_hybrid_communicate_group
from ..health.sentinel import pack_health, sentinel_check
from ..kernels.flash_attention import flash_attention, flash_attention_with_lse
from ..kernels.quant_matmul import quantize_weights, weight_only_matmul
from ..kernels.rms_norm import rms_norm
from ..kernels.rope import apply_rope, rope_cos_sin

__all__ = ["LlamaConfig", "init_params", "num_params", "forward", "loss_fn",
           "make_train_step", "quantize_params", "validate_quant_mode",
           "ensure_quantized", "QUANTIZE_MODES", "KV_QUANT_MODES",
           "shard_serving_params", "serving_placement", "param_specs",
           "batch_spec", "shard_params", "is_sharded", "placement_bytes",
           "to_pp_layout", "from_pp_layout", "pp_param_specs",
           "make_pp_train_step", "moe_kept"]


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
    sep_axis: Optional[str] = None   # context-parallel mesh axis ("sep")
    cp_impl: str = "ring"            # "ring" | "ulysses" attention over it
    moe_num_experts: int = 0         # > 0: every FFN is that many
    #                                  GShard-routed SwiGLU experts
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01
    ep_axis: Optional[str] = None    # expert-parallel mesh axis ("ep"):
    #                                  experts sharded E/ep over it
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
# the serving tensor-parallel layout
# ---------------------------------------------------------------------------

# QKV projections (and their weight-only int8 scale leaves) are the only
# params the serving tensor-parallel layout shards — on the head output
# dim, so each shard computes exactly the q/k/v head slice whose KV pool
# shard it owns. Everything else stays replicated on the lead device.
_SERVING_TP_SHARDED = ("wq", "wk", "wv", "wq_s", "wk_s", "wv_s")


def shard_serving_params(params: Dict, devices) -> Dict:
    """Lay the (fp or weight-only int8) param dict out for serving tensor
    parallelism over the placement ``devices``
    (:func:`~paddle_tpu_torch.distributed.topology.tp_devices`):
    ``wq``/``wk``/``wv`` and their ``*_s`` scales become tuples of
    ``len(devices)`` contiguous column shards (shard ``s`` on
    ``devices[s]``, holding heads ``[s H/tp, (s+1) H/tp)``); every other
    leaf stays where it is (the engine keeps them on the lead device).

    This is not the Megatron training layout: attention is head-sharded
    and the shards' outputs merge by an exact concatenation, so ``wo``,
    the FFN and the head stay replicated and the math after attention is
    the single-device engine's bit for bit. The ONE helper behind which
    dense weights are sharded: the engine, the supervisor's rebuild and
    every router replica place params through here (the latter two by
    taking an engine's ``prepared_params``). An indivisible head axis
    raises the structured error naming the leaf."""
    from ..distributed.sharding import shard_tensor
    layers = dict(params["layers"])
    for name in _SERVING_TP_SHARDED:
        if name in layers:
            layers[name] = shard_tensor(layers[name], devices, dim=-1,
                                        name=f"params.layers.{name}")
    out = dict(params)
    out["layers"] = layers
    return out


def serving_placement(params: Dict):
    """The placement a sharded param dict was laid out over (the devices
    of ``wq``'s shards), or ``None`` for an unsharded dict."""
    wq = params["layers"]["wq"]
    return [t.device for t in wq] if isinstance(wq, tuple) else None


# ---------------------------------------------------------------------------
# the hybrid-parallel training layout (dp x mp x sharding over a mesh)
# ---------------------------------------------------------------------------

def param_specs(cfg: LlamaConfig, mp_axis: Optional[str] = "mp",
                fsdp_axis: Optional[str] = None) -> Dict:
    """The JAX ``param_specs`` as plain tuples (one entry per leading dim:
    an axis name or None): Megatron's layout over ``mp_axis`` (heads and
    the FFN's intermediate dim, the vocab of ``embed`` and ``lm_head``),
    with ``fsdp_axis`` sharding each matmul's other dim (ZeRO-3). Under MoE
    the expert weights ``[L, Ex, ...]`` carry ``cfg.ep_axis`` on the expert
    dim (E/ep experts an entry) and mp / fsdp on their matmul dims, as in
    JAX."""
    mp, fs, ep = mp_axis, fsdp_axis, cfg.ep_axis
    if cfg.moe_num_experts:
        ffn_in, ffn_out = (None, ep, fs, mp), (None, ep, mp, fs)
    else:
        ffn_in, ffn_out = (None, fs, mp), (None, mp, fs)
    specs = {
        "embed": (mp, fs),
        "layers": {
            "wq": (None, fs, mp),
            "wk": (None, fs, mp),
            "wv": (None, fs, mp),
            "wo": (None, mp, fs),
            "w_gate": ffn_in,
            "w_up": ffn_in,
            "w_down": ffn_out,
            "ln_attn": (None, None),
            "ln_mlp": (None, None),
        },
        "ln_f": (None,),
    }
    if cfg.moe_num_experts:
        specs["layers"]["moe_gate"] = (None, None, None)
    if not cfg.tie_word_embeddings:
        specs["lm_head"] = (fs, mp)
    return specs


def batch_spec(dp_axes=("dp",), sep_axis: Optional[str] = None) -> tuple:
    """The spec of a ``[B, S]`` token batch: the batch over the data axes,
    the sequence over ``sep_axis`` (an entry of one axis is that axis and
    of none is None, as ``PartitionSpec`` reads them)."""
    axes = tuple(a for a in dp_axes if a)
    return (axes[0] if len(axes) == 1 else axes or None, sep_axis)


def _whole(t, dev) -> torch.Tensor:
    """A token batch as one tensor on ``dev`` (a :class:`ShardedTensor`
    assembled)."""
    if isinstance(t, ShardedTensor):
        return assemble(t, dev)
    return torch.as_tensor(t, device=dev)


def is_sharded(params: Dict) -> bool:
    """Whether ``params`` is a :func:`shard_params` tree."""
    return isinstance(params.get("embed"), ShardedTensor)


def _refuse_sharded(cfg: LlamaConfig, mesh=None) -> None:
    """What the sharded path has no layout for."""
    if mesh is not None and mesh.shape.get("pp", 1) > 1:
        raise NotImplementedError(
            "shard_params: a pp degree > 1 has no layout here (JAX's "
            "param_specs has no pp entry either); lay the params out with "
            "to_pp_layout and pp_param_specs (distributed.sharding."
            "shard_tree) and train them with make_pp_train_step")


def shard_params(params: Dict, mesh, cfg: LlamaConfig, mp_axis="mp",
                 fsdp_axis=None) -> Dict:
    """The param dict laid out over ``mesh``
    (:func:`~paddle_tpu_torch.distributed.topology.build_mesh`) by
    :func:`param_specs`: the same tree, each leaf a
    :class:`~paddle_tpu_torch.distributed.sharding.ShardedTensor` holding
    one local tensor per mesh coordinate (replicas along dp hold their own
    copies, as JAX's per-device arrays do). Query and kv heads must split
    over ``mp_axis``; an indivisible dim raises the layout's
    ``ValueError`` (under MoE the experts must split over ``cfg.ep_axis``).
    A pp degree > 1 raises ``NotImplementedError`` (the sharded step also
    refuses a named ``remat_policy``)."""
    _refuse_sharded(cfg, mesh)
    if cfg.moe_num_experts and cfg.ep_axis is not None:
        if cfg.ep_axis not in mesh.shape:
            raise ValueError(f"cfg.ep_axis {cfg.ep_axis!r} is not an axis "
                             f"of the mesh {mesh.axis_names}")
        if cfg.moe_num_experts % mesh.shape[cfg.ep_axis]:
            raise ValueError(
                f"cannot shard the experts: {cfg.moe_num_experts} do not "
                f"split over mesh axis {cfg.ep_axis!r} (size "
                f"{mesh.shape[cfg.ep_axis]})")
    if mp_axis is not None:
        n = mesh.shape[mp_axis]
        for what, heads in (("wq", cfg.num_attention_heads),
                            ("wk", cfg.kv_heads), ("wv", cfg.kv_heads)):
            if heads % n:
                raise ValueError(
                    f"cannot shard params.layers.{what}: {heads} heads do "
                    f"not split over mesh axis {mp_axis!r} (size {n})")
    return shard_tree(params, mesh, param_specs(cfg, mp_axis, fsdp_axis))


def placement_bytes(tree, coord) -> int:
    """The bytes the sharded leaves of ``tree`` hold at mesh coordinate
    ``coord`` (one placement entry's share of the state)."""
    return sum(t.nbytes_at(coord) for t in _leaves(tree)
               if isinstance(t, ShardedTensor))


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


def _expand_kv(k, v, H):
    """GQA: each kv head repeated for its query heads."""
    Hk = k.shape[2]
    if Hk == H:
        return k, v
    return (k.repeat_interleave(H // Hk, dim=2),
            v.repeat_interleave(H // Hk, dim=2))


def _refuse_packed_sep(segment_ids) -> None:
    if segment_ids is not None:
        raise NotImplementedError(
            "packed-sequence masking under sep context parallelism is not "
            "supported yet (the ring schedule assumes a plain causal mask)")


def _attention(q, k, v, cfg: LlamaConfig, segment_ids=None):
    """Causal self-attention on ``[B, S, H(k), D]``; ``segment_ids [B, S]``
    confines attention within packed sequences. ``cfg.sep_axis``: ring or
    Ulysses attention (``cfg.cp_impl``) over the hybrid group's ``sep``
    ranks, GQA heads expanded first (packed batches raise). Otherwise
    ``cfg.use_kernels`` runs the flash kernels, or one fp32 masked
    softmax, rows with no visible key output 0."""
    if cfg.sep_axis is not None:
        _refuse_packed_sep(segment_ids)
        k, v = _expand_kv(k, v, q.shape[2])
        return sep_parallel_attention(
            q, k, v, causal=True, impl=cfg.cp_impl,
            mesh=get_hybrid_communicate_group().mesh,
            axis_name=cfg.sep_axis, use_kernels=cfg.use_kernels)
    if cfg.use_kernels:
        return flash_attention(q, k, v, causal=True, segment_ids=segment_ids)
    B, S, H, D = q.shape
    k, v = _expand_kv(k, v, H)
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
    compute once over all layers (``generation._dropped``).

    Expert weights given as a tuple of ep shards (``[Ex / ep, ...]`` each
    on its device: the pipelined step's pp x ep) run expert-parallel: each
    shard's rows of the dispatched ``[Ex, C, M]`` go to its device and the
    outputs come back (:func:`_experts`)."""
    B, S, M = h.shape
    T = B * S
    cap = _capacity(T, cfg)
    h2 = h.reshape(T, M)
    logits = h2.to(torch.float32) @ lp["moe_gate"].to(torch.float32)
    combine, dispatch, aux = gshard_routing(logits, cfg.moe_top_k, cap)
    kept = dispatch.sum()
    dt = h2.dtype
    einp = torch.einsum("tec,tm->ecm", dispatch.to(dt), h2)
    eout = _experts(lp, einp, dt)
    y = torch.einsum("tec,ecm->tm", combine.to(dt), eout)
    return y.reshape(B, S, M), aux, kept


def _capacity(T: int, cfg: LlamaConfig) -> int:
    """An expert's queue length for ``T`` routed tokens (JAX's
    ``_moe_ffn``)."""
    return max(1, math.ceil(T * cfg.moe_capacity_factor * cfg.moe_top_k
                            / cfg.moe_num_experts))


def _swiglu(x, wg, wu, wd, dt):
    """One SwiGLU per expert: ``x [e, C, M]`` through ``[e, M, I]`` /
    ``[e, I, M]`` weights."""
    g = F.silu(torch.bmm(x, wg.to(dt))) * torch.bmm(x, wu.to(dt))
    return torch.bmm(g, wd.to(dt))


def _experts(lp: Dict, einp, dt):
    """The experts' outputs ``[Ex, C, M]`` for the dispatched ``einp``: one
    SwiGLU per expert, or, with the expert weights a tuple of ep shards,
    each shard's experts on its device (the outputs concatenated back on
    ``einp``'s)."""
    wg, wu, wd = lp["w_gate"], lp["w_up"], lp["w_down"]
    if not isinstance(wg, tuple):
        return _swiglu(einp, wg, wu, wd, dt)
    out, lo = [], 0
    for g_, u_, d_ in zip(wg, wu, wd):
        n = g_.shape[0]
        out.append(_swiglu(einp[lo:lo + n].to(g_.device), g_, u_, d_, dt)
                   .to(einp.device))
        lo += n
    return torch.cat(out)


def moe_kept(params: Dict, input_ids, cfg: LlamaConfig) -> List[int]:
    """The (token, choice) pairs each MoE layer's router kept in one
    forward of ``input_ids`` (``T * top_k`` less its drops), layer by
    layer, for a serial or a sharded tree: the sharded router runs over
    the global batch, so its counts equal the serial ones."""
    with torch.no_grad():
        _, kept = forward(params, input_ids, cfg, return_kept=True)
    return [int(k) for k in kept]


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
    """``x + o @ wo``, then the FFN half: ``(block output, aux, kept)``
    (:func:`_ffn_tail`)."""
    return _ffn_tail(lp, x + _mm(o, lp, "wo", cfg.dtype), cfg)


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
    ``(output, aux, kept)``: the MoE load-balancing loss and the (token,
    choice) pairs the router kept (:func:`_moe_ffn`), each ``0.0`` for a
    dense FFN (JAX's dense layer returns the output alone)."""
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
    if cfg.use_kernels and "flash_out" in keep and cfg.sep_axis is None:
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
            return_hidden: bool = False, return_kept: bool = False):
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
    (0.0 for a dense model). ``return_kept`` appends to what is returned
    the list of each layer's kept (token, choice) pairs (0-d tensors under
    MoE, ``0.0`` for a dense layer). ``return_hidden`` returns the
    final-norm hidden states instead.

    A sharded tree (:func:`shard_params`) runs the sharded path
    (:func:`_sharded_trunk`) and returns the whole logits (or hidden
    states) on the mesh's first device, the pieces in batch order.
    """
    if is_sharded(params):
        return _sharded_forward(params, input_ids, cfg, segment_ids,
                                position_ids, return_aux, return_hidden,
                                return_kept)
    keep = _remat_policy(cfg.remat_policy) if cfg.remat else None
    dev = params["embed"].device
    ids = _whole(input_ids, dev)
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
    auxes, keeps = [], []
    for l, ws in zip(range(cfg.num_hidden_layers), slices):
        lp = dict(zip(names, ws))
        if not cfg.remat:
            x, aux, kept = decoder_layer(lp, x, cos, sin, cfg, seg)
        elif keep is None:
            x, aux, kept = checkpoint(decoder_layer, lp, x, cos, sin, cfg,
                                      seg, use_reentrant=False)
        else:
            x, aux, kept = _policy_layer(lp, x, cos, sin, cfg, seg, keep)
        auxes.append(aux)
        keeps.append(kept)
    x = _rms_norm(x, params["ln_f"], cfg.rms_norm_eps, cfg.use_fused_norm)
    if return_hidden:
        return x
    if cfg.tie_word_embeddings:
        logits = x @ params["embed"].T.to(cfg.dtype)
    else:
        logits = _mm(x, params, "lm_head", cfg.dtype)
    out = (logits,)
    if return_aux:
        out += (torch.stack(auxes).mean() if cfg.moe_num_experts else
                torch.zeros((), dtype=torch.float32, device=dev)),
    if return_kept:
        out += keeps,
    return out if len(out) > 1 else logits


def _ce_chunk(hc, lc, head, dt):
    """(summed CE, valid-token count) of one token chunk."""
    logits = (hc @ head.to(dt)).to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    tgt = logits.gather(-1, lc.clamp(min=0)[..., None])[..., 0]
    m = lc >= 0
    return torch.where(m, lse - tgt, 0.0).sum(), m.sum()


def _sharded_forward(params, input_ids, cfg, segment_ids, position_ids,
                     return_aux, return_hidden, return_kept):
    plan, hidden, heads, aux, keeps = _sharded_trunk(
        params, input_ids, cfg, segment_ids, position_ids)
    lead = plan.mesh.devices.flat[0]
    if return_hidden:
        return plan.join([h[0] for h in hidden])
    logits = plan.join([torch.cat([(h @ heads[c].to(cfg.dtype)).to(lead)
                                   for h, c in zip(hs, cs)], dim=-1)
                        for hs, cs in zip(hidden, plan.coords)])
    out = (logits,)
    if return_aux:
        out += (aux[0].to(lead) if aux is not None else
                torch.zeros((), dtype=torch.float32, device=lead)),
    if return_kept:
        out += keeps,
    return out if len(out) > 1 else logits


def loss_fn(params: Dict, input_ids, labels, cfg: LlamaConfig,
            segment_ids=None, position_ids=None):
    """Mean next-token cross-entropy over the tokens whose label is not
    -100 (labels already shifted). MoE configs add ``cfg.moe_aux_weight *``
    the load-balancing loss.

    ``cfg.ce_chunks > 1`` computes it over token chunks, each checkpointed,
    so the fp32 ``[T, V]`` logits and their gradient never live at once;
    the token count must divide into the chunks. MoE configs ignore it, as
    the JAX ``loss_fn`` does. A sharded tree runs :func:`_sharded_loss`
    (vocab-parallel cross-entropy)."""
    if is_sharded(params):
        return _sharded_loss(params, input_ids, labels, cfg, segment_ids,
                             position_ids)
    dev = params["embed"].device
    labels = _whole(labels, dev).long()
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
# the sharded path: one controller over the mesh
# ---------------------------------------------------------------------------

class _Plan:
    """Where the sharded forward runs. The batch ``ids`` (a
    :class:`ShardedTensor` by :func:`batch_spec`, or a tensor, which is
    split by ``batch_spec(("dp",), cfg.sep_axis)``) is cut into PIECES, one
    per coordinate of its batch axes and, under ``cfg.sep_axis``, of the
    sep axis (a part of the sequence); piece ``p`` runs on mp shard ``k``
    at ``coords[p][k]``: the piece's batch and sep coordinates, ``k`` on
    the mp axis, 0 on every other axis. The sep rank is innermost, so each
    ``n_sep`` consecutive pieces are one ring (piece ``p`` holds sequence
    part ``p % n_sep``). Under MoE, ``ep`` is ``cfg.ep_axis``: the experts'
    axis, on which a piece's coordinate says nothing (each ep coordinate
    runs its own experts, :func:`_sharded_moe`)."""

    def __init__(self, params: Dict, ids, cfg: LlamaConfig, what: str):
        emb = params["embed"]
        self.mesh = mesh = emb.mesh
        self.mp, self.fs = emb.spec[0], emb.spec[1]
        spec = ids.spec if isinstance(ids, ShardedTensor) else batch_spec()
        self.batch = spec_axes(spec[0]) if spec else ()
        self.sep = cfg.sep_axis
        seq = spec[1] if len(spec) > 1 else None
        if seq is not None and seq != self.sep:
            raise ValueError(f"{what}: the sequence is split over {seq!r} "
                             f"but cfg.sep_axis is {self.sep!r}")
        if self.sep is not None and self.sep not in mesh.shape:
            raise ValueError(f"{what}: cfg.sep_axis {self.sep!r} is not an "
                             f"axis of the mesh {mesh.axis_names}")
        if self.mp is not None and self.mp in self.batch:
            raise ValueError(f"{what}: the batch cannot be split over the "
                             f"model-parallel axis {self.mp!r}")
        if self.sep is not None and self.sep in self.batch:
            raise ValueError(f"{what}: the batch cannot be split over the "
                             f"sequence axis {self.sep!r}")
        self.n_sep = mesh.shape[self.sep] if self.sep else 1
        self.ep = cfg.ep_axis if cfg.moe_num_experts else None
        if self.ep is not None and self.ep not in mesh.shape:
            raise ValueError(f"{what}: cfg.ep_axis {self.ep!r} is not an "
                             f"axis of the mesh {mesh.axis_names}")
        self.spec = batch_spec(self.batch, self.sep)
        base = (0,) * len(mesh.axis_names)
        split = self.batch + ((self.sep,) if self.sep else ())
        self.coords = [mesh.group(c, (self.mp,) if self.mp else ())
                       for c in mesh.group(base, split)]

    def pieces(self, t, what: str):
        """``[piece][mp shard]``: each piece of ``t`` (laid out by
        :attr:`spec` first when it is not) on the device of each of its
        mp shards."""
        if not isinstance(t, ShardedTensor) or (
                [spec_axes(e) for e in (tuple(t.spec) + (None,))[:2]]
                != [spec_axes(e) for e in self.spec]):
            t = shard_to_mesh(_whole(t, self.mesh.devices.flat[0]),
                              self.mesh, self.spec, what)
        return [[t.local(cs[0]).to(self.mesh.devices[c]) for c in cs]
                for cs in self.coords]

    def join(self, per_piece, dev=None):
        """One tensor per piece (``[b, s, ...]``) -> the whole batch on
        ``dev`` (default: the mesh's first device): each ring's pieces
        concatenated on the sequence, the rings on the batch."""
        lead = self.mesh.devices.flat[0] if dev is None else dev
        t = [x.to(lead) for x in per_piece]
        n = self.n_sep
        return torch.cat([torch.cat(t[i:i + n], dim=1)
                          for i in range(0, len(t), n)])

    def split(self, whole, shapes):
        """The inverse of :meth:`join`: ``whole [B, S, ...]`` cut into the
        pieces, piece ``p`` of ``shapes[p] = (b, s)``."""
        out, row, n = [], 0, self.n_sep
        for i in range(0, len(shapes), n):
            col = 0
            for b, s_ in shapes[i:i + n]:
                out.append(whole[row:row + b, col:col + s_])
                col += s_
            row += shapes[i][0]
        return out

    def attend(self, qkv, cfg: LlamaConfig):
        """The attention output ``[piece][mp shard]`` from ``qkv[p][k] =
        (q, k, v)``: each piece alone, or under ``cfg.sep_axis`` each ring
        of ``n_sep`` pieces together, one ring per mp shard on its local
        heads (:func:`ring_flash_attention` or :func:`ulysses_attention`,
        GQA heads expanded first)."""
        if self.sep is None:
            return [[_attention(q, k, v, cfg) for q, k, v in row]
                    for row in qkv]
        fn = cp_attention(cfg.cp_impl)
        n = self.n_sep
        out = [[None] * len(row) for row in qkv]
        for g in range(0, len(qkv), n):
            ring = qkv[g:g + n]
            for k in range(len(ring[0])):
                qs = [r[k][0] for r in ring]
                kvs = [_expand_kv(r[k][1], r[k][2], qs[0].shape[2])
                       for r in ring]
                outs = fn(qs, [a for a, _ in kvs], [b for _, b in kvs],
                          True, cfg.use_kernels)
                for i, o in enumerate(outs):
                    out[g + i][k] = o
        return out

    def gather(self, st: ShardedTensor, local: Dict, dim_off: int = 0,
               want=None):
        """``{compute coordinate: weight}`` with every axis of ``st``'s spec
        but mp and ep gathered (the fsdp dim: ``all_gather`` over that
        axis, the gradient reduce-scattered back), from ``local``
        (coordinate -> local tensor, its dims ``dim_off`` fewer than
        ``st``'s), at ``want`` (default: every piece's mp shards)."""
        if want is None:
            want = [c for cs in self.coords for c in cs]
        fs = [(d - dim_off, spec_axes(e)) for d, e in enumerate(st.spec)
              if spec_axes(e) and spec_axes(e) not in ((self.mp,),
                                                       (self.ep,))]
        if not fs:
            return {c: local[c] for c in want}
        (dim, axes), = fs
        groups: Dict[tuple, list] = {}
        for c in want:
            groups.setdefault(self.mesh.group(c, axes)[0], []).append(c)
        out = {}
        for head, cs in groups.items():
            members = self.mesh.group(head, axes)
            if len(members) == 1:
                out[head] = local[head]
                continue
            got = gather_to([local[m] for m in members], dim,
                            [self.mesh.rank_in(c, axes) for c in cs])
            out.update(zip(cs, got))
        return out


def _sharded_layer(plan: _Plan, xs, lw: Dict, w: Dict, tables, cfg):
    """One decoder block on every piece and mp shard: ``xs[p][k]`` the
    residual stream, ``w`` the gathered projections and ``lw`` the local
    norm (and router) weights by coordinate, ``tables[device, part]`` the
    RoPE rows of a sequence part. Column-parallel q/k/v and gate/up after
    a :func:`copy_to_group` of the normed input; the attention of every
    piece (:meth:`_Plan.attend`); row-parallel ``wo`` and ``w_down``
    partial sums reduced by ``all_reduce`` over mp. Under MoE the FFN is
    :func:`_sharded_moe` over every piece at once. Returns ``(xs, aux,
    kept)``: ``aux`` the MoE load-balancing loss of each mp shard's router
    and ``kept`` the (token, choice) pairs it kept (None and 0.0 for a
    dense FFN)."""
    dt, eps, fused = cfg.dtype, cfg.rms_norm_eps, cfg.use_fused_norm
    D = cfg.head_dim
    qkv = []
    for p, (x_p, cs) in enumerate(zip(xs, plan.coords)):
        hs = copy_to_group([_rms_norm(x, lw["ln_attn"][c], eps, fused)
                            for x, c in zip(x_p, cs)])
        row = []
        for h, c in zip(hs, cs):
            cos, sin = tables[plan.mesh.devices[c], p % plan.n_sep]
            b, S = h.shape[:2]
            q, k, v = ((h @ w[n][c].to(dt)).reshape(b, S, -1, D)
                       for n in ("wq", "wk", "wv"))
            row.append((_rope(q, cos, sin, fused), _rope(k, cos, sin, fused),
                        v))
        qkv.append(row)
    out = []
    for x_p, cs, o_p in zip(xs, plan.coords, plan.attend(qkv, cfg)):
        parts = [o.reshape(*o.shape[:2], -1) @ w["wo"][c].to(dt)
                 for o, c in zip(o_p, cs)]
        x_p = [x + y for x, y in zip(x_p, all_reduce_sum(parts))]
        if cfg.moe_num_experts:
            out.append(x_p)
            continue
        hs = copy_to_group([_rms_norm(x, lw["ln_mlp"][c], eps, fused)
                            for x, c in zip(x_p, cs)])
        parts = [(F.silu(h @ w["w_gate"][c].to(dt)) * (h @ w["w_up"][c].to(dt)))
                 @ w["w_down"][c].to(dt) for h, c in zip(hs, cs)]
        out.append([x + y for x, y in zip(x_p, all_reduce_sum(parts))])
    if not cfg.moe_num_experts:
        return out, None, 0.0
    hn = [[_rms_norm(x, lw["ln_mlp"][c], eps, fused) for x, c in zip(x_p, cs)]
          for x_p, cs in zip(out, plan.coords)]
    ys, aux, kept = _sharded_moe(plan, hn, lw["moe_gate"], w, cfg)
    return [[x + y for x, y in zip(x_p, y_p)]
            for x_p, y_p in zip(out, ys)], aux, kept


def _expert_coords(plan: _Plan):
    """``[piece][ep shard][mp shard]``: where each piece's slice of the
    dispatched slots runs each ep shard's experts — the piece's
    coordinate with the ep axis set to the shard."""
    mesh = plan.mesh
    d = mesh.axis_names.index(plan.ep) if plan.ep else None
    n_ep = mesh.shape[plan.ep] if plan.ep else 1

    def at(c, j):
        if d is None:
            return c
        c = list(c)
        c[d] = j
        return tuple(c)

    return [[[at(c, j) for c in cs] for j in range(n_ep)]
            for cs in plan.coords]


def _sharded_moe(plan: _Plan, hn, gate: Dict, w: Dict, cfg: LlamaConfig):
    """The MoE FFN of every piece at once, ``hn[p][k]`` the normed input of
    piece ``p`` on mp shard ``k``; returns ``(ys, aux, kept)``:
    ``ys[p][k]`` the FFN output, ``aux[k]`` shard ``k``'s load-balancing
    loss, ``kept`` the (token, choice) pairs the router kept (every
    shard's router keeps the same).

    The router runs over the GLOBAL batch, as JAX's sharded step routes
    the logical ``[B, S]``: each piece's ``[b, s, Ex]`` fp32 logits are
    joined in the batch's order (:meth:`_Plan.join`), routed once with the
    capacity of all ``T = B * S`` tokens (queue positions over the global
    token order, the aux loss global), and the dispatch and combine cut
    back into the pieces. Each piece contracts its tokens into the
    ``[Ex, C, M]`` slots (each slot holds one token, so the sum over the
    pieces is exact); ep shard ``j`` runs only its experts' SwiGLU, on
    the slots split over the pieces (the piece's coordinate with ep =
    ``j``, its dp replica of the experts), and the outputs come back to
    every piece for the combine: the all-to-all GSPMD inserts in JAX.

    Under mp, each shard routes its own copy of the input (the router is
    replicated, so that path skips :func:`copy_to_group`), the experts'
    intermediate dim is column- and row-parallel as the dense FFN's, and
    their partial outputs are summed over mp by ``all_reduce``."""
    mesh, dt = plan.mesh, cfg.dtype
    Ex = cfg.moe_num_experts
    K = len(plan.coords[0])
    shapes = [tuple(h[0].shape[:2]) for h in hn]
    M = hn[0][0].shape[-1]
    B = sum(b for b, _ in shapes[::plan.n_sep])
    S = hn[0][0].shape[1] * plan.n_sep
    cap = _capacity(B * S, cfg)
    ex = _expert_coords(plan)
    n_ep = len(ex[0])
    blk = Ex // n_ep
    hx = [copy_to_group(h_p) for h_p in hn]
    q, rem = divmod(cap, len(hn))           # the slots each piece runs
    spans = [(p * q + min(p, rem), (p + 1) * q + min(p + 1, rem))
             for p in range(len(hn))]
    einp, combs, auxes = [], [], []
    for k in range(K):
        lead = mesh.devices[plan.coords[0][k]]
        logits = [h[k].to(torch.float32) @ gate[cs[k]].to(torch.float32)
                  for h, cs in zip(hn, plan.coords)]
        combine, dispatch, aux = gshard_routing(
            plan.join(logits, lead).reshape(-1, Ex), cfg.moe_top_k, cap)
        if k == 0:
            kept = dispatch.sum()
        auxes.append(aux)
        cut = [plan.split(t.reshape(B, S, Ex, cap), shapes)
               for t in (combine, dispatch)]
        combs.append(cut[0])
        acc = None
        for h_p, d_p, cs in zip(hx, cut[1], plan.coords):
            dev = mesh.devices[cs[k]]
            e = torch.einsum("tec,tm->ecm", d_p.reshape(-1, Ex, cap).to(dev)
                             .to(dt), h_p[k].reshape(-1, M)).to(lead)
            acc = e if acc is None else acc + e
        einp.append(acc)
    outs = [[[] for _ in range(K)] for _ in range(n_ep)]   # [j][k]: chunks
    for p, (lo, hi) in enumerate(spans):
        if lo == hi:
            continue
        for j in range(n_ep):
            parts = []
            for k, c in enumerate(ex[p][j]):
                x = einp[k][j * blk:(j + 1) * blk, lo:hi].to(mesh.devices[c])
                parts.append(_swiglu(x, w["w_gate"][c], w["w_up"][c],
                                     w["w_down"][c], dt))
            for k, o in enumerate(all_reduce_sum(parts)):
                outs[j][k].append(o.to(mesh.devices[plan.coords[0][k]]))
    ys = [[None] * K for _ in hn]
    for k in range(K):
        eout = torch.cat([torch.cat(outs[j][k], dim=1) for j in range(n_ep)])
        for p, (cs, comb) in enumerate(zip(plan.coords, combs[k])):
            dev = mesh.devices[cs[k]]
            b, s_ = shapes[p]
            ys[p][k] = torch.einsum(
                "tec,ecm->tm", comb.reshape(-1, Ex, cap).to(dev).to(dt),
                eout.to(dev)).reshape(b, s_, M)
    return ys, auxes, kept


def _sharded_trunk(params: Dict, input_ids, cfg: LlamaConfig,
                   segment_ids=None, position_ids=None):
    """The sharded forward up to the LM head: ``(plan, hidden, heads,
    aux, kept)`` with ``hidden[p][k]`` the final-norm hidden states of
    piece ``p`` on mp shard ``k``, ``heads[c]`` that shard's ``[E, V /
    mp]`` head and, under MoE, ``aux[k]`` the load-balancing loss of mp
    shard ``k``'s routers, the mean over the layers (None for a dense
    model), and ``kept`` each layer's kept (token, choice) pairs (0.0 for
    a dense layer).

    Every piece of the batch runs, for each mp shard, on that shard's
    device, and one autograd graph spans the placement:

    * ``embed`` is vocab-parallel: each shard looks its vocab range up (0
      elsewhere) and ``all_reduce`` sums the shards, exactly (one term is
      non-zero); an id outside ``[-V, V)`` embeds as NaN, as in
      :func:`_embed`;
    * a weight sharded over the fsdp axis is gathered before each use
      (``all_gather``) and its gradient comes back to each shard as its
      slice summed over the pieces (``reduce_scatter``);
    * each layer (:func:`_sharded_layer`) runs Megatron's column- and
      row-parallel attention and FFN at the local head counts, through
      the flash kernels with ``use_kernels`` and the fused RMSNorm and
      RoPE with ``use_fused_norm``; ``cfg.remat`` checkpoints it whole
      (every piece and shard at once, its gathers inside, so backward
      gathers the weights again, as ZeRO-3 does);
    * under ``cfg.sep_axis`` a piece holds one part of the sequence: its
      RoPE rows are those of its global positions, and the pieces of one
      ring attend together (:meth:`_Plan.attend`). Labels come shifted,
      so no piece needs its neighbour's tokens;
    * under MoE, each layer's FFN routes the global batch once and runs
      each ep shard's experts on its own entries (:func:`_sharded_moe`).

    Every reduction runs in a fixed rank order, so a run repeats bit for
    bit. Packed batches (``segment_ids``, ``position_ids``) are not ported
    under sharding."""
    if cfg.sep_axis is not None:
        _refuse_packed_sep(segment_ids)
    if cfg.remat and cfg.remat_policy not in (None, "nothing"):
        raise NotImplementedError(
            f"remat_policy={cfg.remat_policy!r} under sharding is not ported "
            "yet (ROADMAP.md section A, item 10d's rest); full remat "
            "(remat_policy=None) is")
    if segment_ids is not None or position_ids is not None:
        raise NotImplementedError(
            "segment_ids / position_ids (packed batches) under sharding are "
            "not ported yet (ROADMAP.md section A, item 10d's rest)")
    plan = _Plan(params, input_ids, cfg, "input_ids")
    mesh, dt = plan.mesh, cfg.dtype
    if plan.sep is not None and cfg.cp_impl == "ulysses" and plan.mp:
        local = cfg.num_attention_heads // mesh.shape[plan.mp]
        if local % plan.n_sep:
            raise NotImplementedError(
                f"Ulysses attention on {local} heads a model-parallel "
                f"shard does not split over sep degree {plan.n_sep}; "
                "gathering the heads over mp first is not ported yet "
                "(ROADMAP.md section A, item 5a's rest); cp_impl='ring' "
                "runs")
    emb = params["embed"]
    embed = plan.gather(emb, emb.locals)
    ids = plan.pieces(input_ids, "input_ids")
    V = emb.shape[0]
    xs = []
    for ids_p, cs in zip(ids, plan.coords):
        es, oks = [], []
        for k, (i, c) in enumerate(zip(ids_p, cs)):
            i = i.long()
            ok = (i >= -V) & (i < V)
            e_k = embed[c]
            lo = k * e_k.shape[0]
            loc = torch.where(i < 0, i + V, i) - lo
            mine = ok & (loc >= 0) & (loc < e_k.shape[0])
            es.append(e_k[loc.clamp(0, e_k.shape[0] - 1)].to(dt)
                      .masked_fill(~mine[..., None], 0))
            oks.append(ok)
        xs.append([x.masked_fill(~ok[..., None], float("nan"))
                   for x, ok in zip(all_reduce_sum(es), oks)])
    S, parts = xs[0][0].shape[1], plan.n_sep
    tables = {}
    for d in set(mesh.devices.flat):
        cos, sin = rope_cos_sin(S * parts, cfg.head_dim, cfg.rope_theta,
                                device=d)
        for r in range(parts):
            tables[d, r] = (cos[r * S:(r + 1) * S], sin[r * S:(r + 1) * S])
    layers = params["layers"]
    # unbind once, not one index per layer (see forward)
    unbound = {n: {c: t.unbind(0) for c, t in st.locals.items()}
               for n, st in layers.items()}
    moe = cfg.moe_num_experts > 0
    ffn = ("w_gate", "w_up", "w_down")
    at = [c for per in _expert_coords(plan) for cs in per for c in cs]
    auxes, keeps = [], []
    for l in range(cfg.num_hidden_layers):
        local = {n: {c: ts[l] for c, ts in u.items()}
                 for n, u in unbound.items()}

        def layer(xs, local=local):
            lw = {n: local[n] for n in ("ln_attn", "ln_mlp", "moe_gate")
                  if n in local}
            w = {n: plan.gather(layers[n], local[n], 1,
                                at if moe and n in ffn else None)
                 for n in ("wq", "wk", "wv", "wo") + ffn}
            return _sharded_layer(plan, xs, lw, w, tables, cfg)

        xs, aux, kept = (checkpoint(layer, xs, use_reentrant=False)
                         if cfg.remat else layer(xs))
        auxes.append(aux)
        keeps.append(kept)
    ln_f = params["ln_f"]
    hidden = [copy_to_group([_rms_norm(x, ln_f.local(c), cfg.rms_norm_eps,
                                       cfg.use_fused_norm)
                             for x, c in zip(x_p, cs)])
              for x_p, cs in zip(xs, plan.coords)]
    if cfg.tie_word_embeddings:
        heads = {c: e.T for c, e in embed.items()}
    else:
        heads = plan.gather(params["lm_head"], params["lm_head"].locals)
    aux = ([torch.stack([a[k].to(auxes[0][k].device) for a in auxes]).mean()
            for k in range(len(auxes[0]))] if moe else None)
    return plan, hidden, heads, aux, keeps


def _vocab_parallel_ce(hs, lbl, heads, dt):
    """(per-shard summed CE, valid-token count) of one token chunk whose
    logits are split over the mp shards: ``hs[k]`` ``[T, E]`` and
    ``heads[k]`` ``[E, V / mp]`` on shard ``k``'s device. The logsumexp
    runs across the shards (their max, then the sum of exps, both reduced
    in rank order) and the target logit comes from the shard that holds
    it; every shard ends with the same per-token losses."""
    logits = [(h @ w.to(dt)).to(torch.float32) for h, w in zip(hs, heads)]
    m = reduce_ranks([lg.detach().amax(-1) for lg in logits], ReduceOp.MAX)
    se = all_reduce_sum([torch.exp(lg - mk[..., None]).sum(-1)
                         for lg, mk in zip(logits, m)])
    tgts = []
    for k, lg in enumerate(logits):
        loc = lbl.to(lg.device) - k * lg.shape[-1]
        mine = (loc >= 0) & (loc < lg.shape[-1])
        tgts.append(lg.gather(-1, loc.clamp(0, lg.shape[-1] - 1)[..., None])
                    [..., 0].masked_fill(~mine, 0.0))
    valid = lbl >= 0
    sums = [torch.where(valid.to(s.device), torch.log(s) + mk - t, 0.0).sum()
            for s, mk, t in zip(se, m, all_reduce_sum(tgts))]
    return sums, valid.sum()


def _sharded_loss(params: Dict, input_ids, labels, cfg: LlamaConfig,
                  segment_ids=None, position_ids=None):
    """:func:`loss_fn` of a sharded tree: the global mean, each piece's
    summed token losses over the global count of labelled tokens.

    Each mp shard holds the same per-token losses; the value returned is
    shard 0's, and the graph behind it is the sum over the shards (each
    shard's copy seeded with 1, as every rank of a tensor-parallel group
    backpropagates its own copy), which the identity adjoint of
    ``all_reduce`` and :func:`copy_to_group` turn into the gradient of one
    copy. MoE adds ``moe_aux_weight`` x the routers' loss the same way:
    shard 0's value, every shard's copy in the graph."""
    plan, hidden, heads, aux, _ = _sharded_trunk(params, input_ids, cfg,
                                                 segment_ids, position_ids)
    lbls = plan.pieces(labels, "labels")
    lead = plan.mesh.devices.flat[0]
    C = cfg.ce_chunks
    T = sum(l_p[0].numel() for l_p in lbls)
    if C > 1 and T % C:
        raise ValueError(f"tokens {T} not divisible by ce_chunks {C}")
    tot, rep, cnt = 0.0, 0.0, 0
    for hs, l_p, cs in zip(hidden, lbls, plan.coords):
        E = hs[0].shape[-1]
        hs = [h.reshape(-1, E) for h in hs]
        lb = l_p[0].reshape(-1).long()
        w = [heads[c] for c in cs]
        q, r = divmod(lb.numel(), C)
        ends = [(c + 1) * q + min(c + 1, r) for c in range(C)]
        for a, b in zip([0] + ends[:-1], ends):
            if C == 1:
                sums, n = _vocab_parallel_ce(hs, lb, w, cfg.dtype)
            elif b > a:
                sums, n = checkpoint(_vocab_parallel_ce,
                                     [h[a:b] for h in hs], lb[a:b], w,
                                     cfg.dtype, use_reentrant=False)
            else:
                continue
            for s_ in sums:
                tot = tot + s_.to(lead)
            rep = rep + sums[0].to(lead)
            cnt = cnt + n.to(lead)
    count = cnt.clamp(min=1)
    full, rep = tot / count, rep / count
    if aux is not None:
        w = cfg.moe_aux_weight
        full = full + w * sum(a.to(lead) for a in aux)
        rep = rep + w * aux[0].to(lead)
    return rep.detach() + (full - full.detach())


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
    """Zero moments in ``opt_dtype`` and an int32 step counter. The moments
    of a sharded tree are laid out as the params are (ZeRO: each
    coordinate holds its own shards' moments); the counter sits on the
    mesh's first device."""
    def zeros(p):
        if isinstance(p, ShardedTensor):
            return p.map_locals(zeros)
        return torch.zeros(p.shape, dtype=opt_dtype, device=p.device)
    first = _leaves(params)[0]
    dev = first.lead if isinstance(first, ShardedTensor) else first.device
    return {"m": _tree_map(zeros, params), "v": _tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


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


def _named(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k in tree for x in _named(tree[k], f"{prefix}{k}.")]
    return [(prefix[:-1], tree)]


def _sharded_grads(params: Dict, input_ids, labels, cfg: LlamaConfig,
                   grad_dtype=None):
    """``(loss, grads)`` of a sharded tree (:func:`_replica_grads` of
    :func:`loss_fn`, the mp axis that of ``embed``'s spec)."""
    return _replica_grads(
        params, lambda: loss_fn(params, input_ids, labels, cfg),
        params["embed"].spec[0], grad_dtype)


def _replica_grads(params: Dict, loss_of, mp: Optional[str],
                   grad_dtype=None):
    """``(loss, grads)`` of a tree of :class:`ShardedTensor` leaves, the
    loss from ``loss_of()``: ``grads`` maps each leaf's name to
    ``{coordinate: gradient}``, the gradient of the slice that coordinate
    holds. A slice's gradient is the sum, in mesh order on its first
    holder's device, of what its replicas received: every piece that used
    it contributes (dp, and the sharding or sep axis when the batch is
    split over it), except that a leaf the ``mp`` axis does not shard
    takes mp shard 0's alone, since every mp shard computed that whole
    gradient. Every holder of the slice gets that one sum."""
    named = _named(params)
    locs = [(n, c, t) for n, st in named for c, t in st.locals.items()]
    for _, _, t in locs:
        t.requires_grad_(True)
    loss = loss_of()
    got = torch.autograd.grad(loss, [t for _, _, t in locs],
                              allow_unused=True)
    raw: Dict[str, Dict] = {}
    for (n, c, _), g in zip(locs, got):
        raw.setdefault(n, {})[c] = g
    grads = {}
    for n, st in named:
        mesh = st.mesh
        mp_d = (mesh.axis_names.index(mp)
                if mp is not None and mp not in
                {a for e in st.spec for a in spec_axes(e)} else None)
        holders: Dict[tuple, list] = {}
        for c in mesh.coords():
            holders.setdefault(st.index(c), []).append(c)
        out = {}
        for cs in holders.values():
            acc = None
            for c in cs:
                g = raw[n][c]
                if g is None or (mp_d is not None and c[mp_d] != 0):
                    continue
                g = g.to(mesh.devices[cs[0]])
                acc = g if acc is None else acc + g
            if acc is None:
                acc = torch.zeros_like(st.local(cs[0]))
            if grad_dtype is not None:
                acc = acc.to(grad_dtype)
            for c in cs:
                out[c] = acc.to(mesh.devices[c])
        grads[n] = out
    return loss.detach(), grads


def _sharded_adamw(params: Dict, grads: Dict, opt_state: Dict, skip, kw):
    """One AdamW step on every mesh coordinate: :func:`_adamw_apply` on the
    coordinate's params, moments and slice gradients (the step count and
    ``skip`` copied to its device). Returns ``(params, opt_state)`` with
    the first coordinate's new step count."""
    named = _named(params)
    ms, vs = dict(_named(opt_state["m"])), dict(_named(opt_state["v"]))
    mesh = named[0][1].mesh
    step = None
    for c in mesh.coords():
        dev = mesh.devices[c]
        p = {n: st.local(c) for n, st in named}
        g = {n: grads[n][c] for n, _ in named}
        st_c = {"m": {n: ms[n].local(c) for n, _ in named},
                "v": {n: vs[n].local(c) for n, _ in named},
                "step": opt_state["step"].to(dev)}
        _, new = _adamw_apply(p, g, st_c, skip=None if skip is None
                              else skip.to(dev), **kw)
        if step is None:
            step = new["step"]
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

    The user's view of a sharded step is the JAX one: ``step(ps,
    init_opt(ps), ids, labels)`` with ``ps`` from :func:`shard_params` and
    the batch a :class:`ShardedTensor` by :func:`batch_spec` (a plain
    tensor is split by ``batch_spec(("dp",))``). The moments are laid out
    as the params are; the gradient of each slice is summed over its
    replicas in a fixed order (:func:`_sharded_grads`) and the same sum
    updates every replica, each through :func:`_adamw_apply` on its own
    ``m`` and ``v``, so dp replicas stay bit-equal. The sentinel's verdict
    is taken on the mesh's first device and gates every coordinate.
    """

    def init_opt_state(params):
        return _adamw_init(params, opt_dtype)

    def loss_and_grads(params, input_ids, labels):
        if is_sharded(params):
            return _sharded_grads(params, input_ids, labels, cfg, grad_dtype)
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
        kw = dict(lr=lr, beta1=beta1, beta2=beta2, eps=eps,
                  weight_decay=weight_decay, opt_dtype=opt_dtype)
        with torch.no_grad():
            if is_sharded(params):
                return _sharded_adamw(params, grads, opt_state, skip, kw)
            return _adamw_apply(params, grads, opt_state, skip=skip, **kw)

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


# ---------------------------------------------------------------------------
# the pipelined train step: dp x pp over a mesh, one controller
# ---------------------------------------------------------------------------

def to_pp_layout(params: Dict, num_stages: int,
                 circular_repeats: int = 1) -> Dict:
    """The stacked ``[L, ...]`` layer leaves reshaped to pipeline layout
    ``[V, S, bpc, ...]`` (chunk ``c = v*S + s`` on stage ``s``, lap ``v``;
    ``bpc`` blocks a chunk), the other leaves as they are (JAX's
    ``to_pp_layout``). Lay the result out over the mesh by
    :func:`pp_param_specs` (``shard_tree(pp, mesh, pp_param_specs(cfg))``),
    so that block weights live only on their stage's entries."""
    S, V = num_stages, circular_repeats
    out = dict(params)
    out["layers"] = {
        k: p.reshape((V, S, p.shape[0] // (S * V)) + tuple(p.shape[1:]))
        for k, p in params["layers"].items()}
    return out


def from_pp_layout(params: Dict) -> Dict:
    """The inverse of :func:`to_pp_layout` (stacked ``[L, ...]`` layer
    leaves); each :class:`ShardedTensor` leaf is assembled on its mesh's
    first device first, so a laid-out tree comes back as a serial one."""
    def whole(t):
        return assemble(t) if isinstance(t, ShardedTensor) else t
    out = {k: whole(v) for k, v in params.items() if k != "layers"}
    out["layers"] = {k: whole(p).reshape((-1,) + tuple(p.shape[3:]))
                     for k, p in params["layers"].items()}
    return out


def pp_param_specs(cfg: LlamaConfig, pp_axis: str = "pp",
                   ep_axis: Optional[str] = None) -> Dict:
    """JAX's ``pp_param_specs`` as plain tuples for pp-layout params:
    blocks cut over ``pp_axis`` on their stage dim, ``embed`` and
    ``lm_head`` vocab-sharded over the same axis (the first and last
    stages' work is tensor-parallel over the pp ranks), ``ln_f`` whole.
    MoE expert weights ``[V, S, bpc, Ex, ...]`` name ``ep_axis`` on the
    expert dim (E/ep experts an entry; :func:`make_pp_train_step` runs
    each shard's experts on its entry)."""
    layer_keys = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
                  "ln_attn", "ln_mlp")
    specs = {
        "embed": (pp_axis, None),
        "layers": {k: (None, pp_axis) for k in layer_keys},
        "ln_f": (None,),
    }
    if cfg.moe_num_experts:
        for k in ("w_gate", "w_up", "w_down"):
            specs["layers"][k] = (None, pp_axis, None, ep_axis)
        specs["layers"]["moe_gate"] = (None, pp_axis)
    if not cfg.tie_word_embeddings:
        specs["lm_head"] = (None, pp_axis)
    return specs


def _blocks(leaf):
    """A chunk leaf ``[bpc, ...]`` (or a tuple of ep shards of one) as its
    ``bpc`` blocks."""
    if isinstance(leaf, tuple):
        return list(zip(*(t.unbind(0) for t in leaf)))
    return leaf.unbind(0)


def _pp_chunk(cfg: LlamaConfig, tables: Dict, names):
    """One chunk's blocks in order on ``h`` (``cp`` leaves ``[bpc,
    ...]``, expert leaves a tuple of ep shards under pp x ep): ``h``, or
    ``(h, the blocks' summed aux)`` under MoE."""
    def chunk(cp, h):
        cos, sin = tables[h.device]
        auxes = []
        for ws in zip(*(_blocks(cp[n]) for n in names)):
            h, aux, _ = decoder_layer(dict(zip(names, ws)), h, cos, sin,
                                      cfg)
            auxes.append(aux)
        if cfg.moe_num_experts:
            return h, torch.stack(auxes).sum()
        return h
    return chunk


def _pp_rings(mesh, pp_axis: str = "pp", dp_axis: Optional[str] = "dp"):
    """The pipelined step's rings: for each coordinate of ``dp_axis`` (in
    mesh order; one ring without it), the pp coordinates of its stages,
    every other axis at 0."""
    dpn = dp_axis if (dp_axis and dp_axis in mesh.axis_names) else None
    base = (0,) * len(mesh.axis_names)
    return [mesh.group(c, (pp_axis,))
            for c in mesh.group(base, (dpn,) if dpn else ())]


def _stage_leaf(st: ShardedTensor, c):
    """A pp-layout leaf's chunks on stage coordinate ``c`` (``[V, bpc,
    ...]``), or, for expert weights split over an ep axis (their spec's
    expert dim), the tuple of the ep shards at ``c``'s other
    coordinates."""
    ep = spec_axes(st.spec[3]) if len(st.spec) > 3 else ()
    if not ep:
        return st.local(c).squeeze(1)
    return tuple(st.local(e).squeeze(1) for e in st.mesh.group(c, ep))


def _pp_loss(params: Dict, input_ids, labels, cfg: LlamaConfig, rings,
             M: int, V: int):
    """The pipelined step's loss: for each dp rank's ring of pp
    coordinates (``rings``), its rows of every micro-batch through the
    vocab-parallel embedding (each stage looks its vocab range up, 0
    elsewhere, the parts summed on stage 0), the ring schedule over the
    decoder blocks (``distributed.pipeline.ring_schedule``; ``cfg.remat``
    checkpoints each chunk application whole, as the JAX step does), the
    final norm on the last stage, and the vocab-parallel head and
    cross-entropy over the stages (:func:`_vocab_parallel_ce`); the global
    mean over labelled tokens (the sum over the ranks' copies in the
    graph, rank 0's value reported, as :func:`_sharded_loss` does). MoE:
    plus ``moe_aux_weight`` x the aux summed over every (layer,
    micro-batch) application / ``L * M``, averaged over dp; each
    micro-batch routes alone, as JAX's pp region does. Expert leaves laid
    out over an ep axis reach each stage as the tuple of its ep shards
    (its dp replica's), so every shard's experts run on their entry
    (:func:`_experts`)."""
    emb = params["embed"]
    mesh, dt = emb.mesh, cfg.dtype
    lead = mesh.devices.flat[0]
    ids, lbl = _whole(input_ids, lead).long(), _whole(labels, lead).long()
    B = ids.shape[0]
    if B % M:
        raise ValueError(f"batch {B} not divisible by micro_batches {M}")
    if (B // M) % len(rings):
        raise ValueError(f"micro-batch {B // M} rows not divisible by the "
                         f"dp degree {len(rings)}")
    ids_d = ids.reshape(M, B // M, -1).chunk(len(rings), dim=1)
    lbl_d = lbl.reshape(M, B // M, -1).chunk(len(rings), dim=1)
    names = list(params["layers"])
    tot, rep, cnt, aux = 0.0, 0.0, 0, 0.0
    for cs, i_d, l_d in zip(rings, ids_d, lbl_d):
        devs = [mesh.devices[c] for c in cs]
        embed = [emb.local(c) for c in cs]
        Vs = embed[0].shape[0]
        x = None
        for s, (e_s, d) in enumerate(zip(embed, devs)):
            idx = i_d.to(d) - s * Vs
            ok = (idx >= 0) & (idx < Vs)
            part = e_s[idx.clamp(0, Vs - 1)].masked_fill(~ok[..., None], 0)
            x = part.to(devs[0]) if x is None else x + part.to(devs[0])
        x = x.to(dt)                                         # [M, mb, T, E]
        tables = {d: rope_cos_sin(x.shape[2], cfg.head_dim, cfg.rope_theta,
                                  device=d) for d in set(devs)}
        chunk = _pp_chunk(cfg, tables, names)
        fn = ((lambda p, h: checkpoint(chunk, p, h, use_reentrant=False))
              if cfg.remat else chunk)
        local = [{n: _stage_leaf(params["layers"][n], c) for n in names}
                 for c in cs]
        res = ring_schedule(fn, local, x, devices=devs, circular_repeats=V,
                            with_aux=bool(cfg.moe_num_experts))
        outs, aux_d = res if cfg.moe_num_experts else (res, None)
        h = _rms_norm(outs, params["ln_f"].local(cs[-1]), cfg.rms_norm_eps,
                      cfg.use_fused_norm)
        h = h.reshape(-1, h.shape[-1])
        heads = ([e.T for e in embed] if cfg.tie_word_embeddings
                 else [params["lm_head"].local(c) for c in cs])
        sums, n = _vocab_parallel_ce([h.to(d) for d in devs],
                                     l_d.reshape(-1), heads, dt)
        for s_ in sums:
            tot = tot + s_.to(lead)
        rep = rep + sums[0].to(lead)
        cnt = cnt + n.to(lead)
        if aux_d is not None:
            aux = aux + aux_d.to(lead)
    count = cnt.clamp(min=1)
    full = tot / count
    loss = (rep / count).detach() + (full - full.detach())
    if cfg.moe_num_experts:
        L = cfg.num_hidden_layers
        loss = loss + cfg.moe_aux_weight * (aux / (L * M) / len(rings))
    return loss


def make_pp_train_step(cfg: LlamaConfig, mesh, *, micro_batches: int,
                       pp_axis: str = "pp", dp_axis: Optional[str] = "dp",
                       circular_repeats: int = 1, lr: float = 3e-4,
                       beta1=0.9, beta2=0.95, eps=1e-8, weight_decay=0.0,
                       opt_dtype=torch.float32):
    """Pipeline-parallel LLaMA training, JAX's ``make_pp_train_step`` over
    a placement: returns ``(init_opt_state, train_step)`` with
    ``train_step(params, opt_state, ids [B, T], labels) -> (params,
    opt_state, loss)``, ``B`` split into ``micro_batches`` and each
    micro-batch's rows over the dp ranks.

    ``params`` is a pp-layout tree (:func:`to_pp_layout`) laid out over
    ``mesh`` by :func:`pp_param_specs`, so block weights live only on
    their stage's entries. The forward is :func:`_pp_loss`; the gradient
    of each slice is summed over its dp replicas in mesh order and the
    same sum updates every replica through AdamW (fp32 moment arithmetic,
    in place), so the replicas stay bit-equal. The layer count must split
    into ``stages * circular_repeats`` chunks and the vocab over the
    stages (the JAX errors); ``circular_repeats > 1`` needs
    ``micro_batches >= stages``. Under MoE the expert weights may be laid
    out over an ep axis (``pp_param_specs(cfg, pp_axis, "ep")``): pp x ep,
    each ep shard's experts running on its entry."""
    S = int(mesh.shape[pp_axis])
    V = int(circular_repeats)
    M = int(micro_batches)
    L, Vo = cfg.num_hidden_layers, cfg.vocab_size
    if L % (S * V):
        raise ValueError(f"num_hidden_layers {L} not divisible by "
                         f"stages*circular_repeats = {S}*{V}")
    if Vo % S:
        raise ValueError(f"vocab_size {Vo} not divisible by pp degree {S}")
    rings = _pp_rings(mesh, pp_axis, dp_axis)
    kw = dict(lr=lr, beta1=beta1, beta2=beta2, eps=eps,
              weight_decay=weight_decay, opt_dtype=opt_dtype)

    def init_opt_state(params):
        return _adamw_init(params, opt_dtype)

    def train_step(params, opt_state, input_ids, labels):
        if not is_sharded(params):
            raise ValueError(
                "make_pp_train_step: params must be a pp-layout tree laid "
                "out over the mesh (to_pp_layout, then shard_tree by "
                "pp_param_specs)")
        loss, grads = _replica_grads(
            params, lambda: _pp_loss(params, input_ids, labels, cfg, rings,
                                     M, V), None)
        with torch.no_grad():
            params, opt_state = _sharded_adamw(params, grads, opt_state,
                                               None, kw)
        return params, opt_state, loss

    return init_opt_state, train_step

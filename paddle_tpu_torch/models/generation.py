"""Generation entry points — counterpart of
``paddle_tpu/models/generation.py``.

Ported here: ``GenerationConfig``; the dense-cache tier (:func:`init_cache`,
:func:`left_align`, :func:`prefill`, :func:`decode_step`,
:func:`make_generate_fn`, :func:`generate` and the streaming
:class:`DecodeSession`); the paged block pool (:func:`init_paged_pool`,
:func:`paged_pool_block_bytes` with its tensor-parallel arithmetic and
:func:`validate_tp`), the KV store / gather helpers and the
paged forward entry points the serving engine drives —
:func:`paged_prefill`, :func:`paged_prefill_chunk`,
:func:`paged_decode_step` and :func:`paged_mixed_step` (the last over
``_paged_multiquery_forward``), the speculative verify step
:func:`paged_spec_step` (each returns the JAX triple ``(logits, pool,
dropped_tokens)``: the tokens an MoE FFN dropped at capacity, summed over
the layers, ``0.0`` for a dense model; each takes the multi-adapter LoRA
operand ``lora={"ids": [B] slots, "layers": adapter pool}``, see
:mod:`paddle_tpu_torch.models.lora`; each serves tensor parallelism when
handed the list pool of ``init_paged_pool(devices=)`` and params from
:func:`~paddle_tpu_torch.models.llama.shard_serving_params`), and the
samplers: :func:`seed_key`, :func:`validate_sampling`, the per-row
serving sampler :func:`sample_tokens` and the static-knob :func:`_sample`
of the dense tier, whose draws equal ``jax.random``'s
(:mod:`paddle_tpu_torch.prng`). As in the JAX package, every norm goes
through ``_rms_norm(..., cfg.use_fused_norm)`` (the fused kernel when the
flag is set), every projection through ``_mm`` (the int8 kernel under
int8 weights) and RoPE always takes the plain route (``_rope(...,
False)``).

Differences from the JAX package, all deliberate:

* ``lax.scan`` over layers is a Python loop over the stacked ``[L, ...]``
  tensors.
* The pool and the dense cache are updated IN PLACE: every entry point
  scatters the new K/V into the tensors of the dict it was handed and
  returns that same dict. JAX returns a new pool (buffer donation makes it
  in place on device); here the in-place write saves one copy per
  dispatch. Callers that need the old pool pass a clone.
* ``generate``'s ``lax.while_loop`` is a host loop with the same early
  exit once every row has hit EOS: with ``eos_token_id`` set, the host
  reads the done mask each step (one device sync a token); without it
  nothing is read until the end. The per-step keys of the
  ``jax.random.split`` chain are folded on the host up front.
* The LoRA factors of a dispatch are gathered (and cast) once for all
  layers (:func:`~paddle_tpu_torch.models.lora.gather_adapters`), not
  once per layer: the same values, 16 launches instead of ``16 L``.
* Serving tensor parallelism is one controller over a placement, not
  ``shard_map``: per layer the pre-norm runs once on the lead device,
  then each shard runs its q/k/v columns, RoPE, the K/V store into its
  pool shard and attention on its own device, the heads are
  concatenated back onto the lead device in shard order (the
  reference's tiled ``all_gather``: exact, no sum), and ``wo``, the FFN
  and the head run once. A dict pool is one shard and takes exactly the
  single-device path.
* Out-of-vocabulary token ids follow ``jnp.take``'s fill semantics (ids
  in ``[-V, V)`` wrap like Python indices, anything else embeds as a NaN
  row) through a clamped gather plus a select, so a poisoned id never
  becomes an out-of-range device index (a device-side assert on CUDA).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import numpy as np
import torch

from .. import prng
from ..device import resolve_device
from ..distributed.sharding import shard_dim_spec
from ..kernels.paged_attention import paged_attention
from ..kernels.rope import rope_cos_sin
from .llama import (_SERVING_TP_SHARDED, KV_QUANT_MODES, LlamaConfig,
                    _embed, _ffn_tail, _masked_sdpa, _mm, _rms_norm, _rope,
                    validate_quant_mode)
from .lora import gather_adapters, gathered_delta

__all__ = ["GenerationConfig", "init_cache", "left_align", "prefill",
           "decode_step", "make_generate_fn", "generate", "DecodeSession",
           "init_paged_pool", "paged_pool_block_bytes",
           "paged_prefill", "paged_prefill_chunk", "paged_decode_step",
           "paged_mixed_step", "paged_spec_step", "seed_key",
           "validate_sampling", "validate_tp", "sample_tokens"]


@dataclasses.dataclass
class GenerationConfig:
    """Sampling knobs (the one struct every decode tier resolves)."""

    max_new_tokens: int = 64
    temperature: float = 0.0
    top_k: Optional[int] = None
    top_p: Optional[float] = None
    eos_token_id: Optional[int] = None
    pad_token_id: int = 0
    seed: int = 0

    # knobs for which None is a VALUE (disable), not the unset spelling
    _NONEABLE = frozenset({"top_k", "top_p", "eos_token_id"})

    @classmethod
    def resolve(cls, generation_config: Optional["GenerationConfig"] = None,
                **overrides) -> "GenerationConfig":
        """Merge a kwargs surface onto an optional base config. The string
        ``"unset"`` always means "not given"; for ``top_k``/``top_p``/
        ``eos_token_id`` ``None`` is a real override (disable), for every
        other field ``None`` means "not given"."""
        base = generation_config if generation_config is not None else cls()
        updates = {k: v for k, v in overrides.items()
                   if not (isinstance(v, str) and v == "unset")
                   and not (v is None and k not in cls._NONEABLE)}
        return dataclasses.replace(base, **updates) if updates else base


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------

def _sample(logits, key, temperature: float, top_k: Optional[int],
            top_p: Optional[float]):
    """Greedy when ``temperature == 0``; else temperature/top-k/top-p
    sampling with static knobs, every row drawn with the ONE raw key
    ``key [2]`` over the whole ``[B, V]`` block: the dense tier's
    sampler (the serving engine samples through ``sample_tokens``)."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    # a device tensor, not a Python scalar: CUDA divides by a host scalar
    # as a multiply by its reciprocal, which can move the last bit
    logits = logits / torch.full((), temperature, dtype=logits.dtype,
                                 device=logits.device)
    if top_k is not None:
        top_k = min(top_k, logits.shape[-1])
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, -math.inf, logits)
    if top_p is not None:
        srt = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(srt, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # keep the smallest prefix with cumulative mass >= top_p (the
        # token that crosses the threshold stays in)
        keep = cum - probs < top_p
        cutoff = torch.where(keep, srt, math.inf).amin(dim=-1, keepdim=True)
        logits = torch.where(logits < cutoff, -math.inf, logits)
    return prng.categorical(key.to(logits.device), logits)


def seed_key(seed: int) -> torch.Tensor:
    """The raw PRNG base key of one seed, ``[seed >> 32, seed &
    0xffffffff]`` as an int64 CPU tensor of uint32 values — host
    arithmetic, no dispatch. The key of sample index ``t`` is
    ``prng.fold_in(seed_key(seed), t)``, a pure function of ``(seed,
    t)``: what keeps a sampled stream the same across preemption and
    speculative verify."""
    s = int(seed)
    return torch.tensor([(s >> 32) & 0xFFFFFFFF, s & 0xFFFFFFFF],
                        dtype=torch.int64)


def validate_sampling(g: "GenerationConfig") -> None:
    """Reject the sampling knobs a serving submit does not support, naming
    the supported surface."""
    ok = True
    t = g.temperature
    if t is None or not math.isfinite(float(t)) or float(t) < 0:
        ok = False
    if g.top_k is not None and int(g.top_k) < 1:
        ok = False
    if g.top_p is not None and not (0.0 < float(g.top_p) <= 1.0):
        ok = False
    if not ok:
        raise ValueError(
            f"unsupported sampling config (temperature={g.temperature!r}, "
            f"top_k={g.top_k!r}, top_p={g.top_p!r}); supported knobs: "
            f"temperature >= 0 (0 = greedy argmax), top_k >= 1 or None "
            f"(disabled), top_p in (0, 1] or None (disabled), integer "
            f"seed")


def sample_tokens(logits, keys, temperature, top_k, top_p):
    """Per-row sampling with tensor knobs — the serving tier's sampler.

    ``logits [B, V]`` fp32; ``keys [B, 2]`` int64 raw keys, already folded
    to each row's sample index; ``temperature [B]`` fp32; ``top_k [B]``
    int (0 disables); ``top_p [B]`` fp32 (1.0 disables and keeps every
    token). Everything runs on ``logits``'s device. Rows with
    ``temperature == 0`` return ``argmax(logits)`` through a ``where``,
    the same bits as the greedy path. Top-k is a VALUE threshold at the
    k-th sorted value (ties at rank k survive); top-p then runs over the
    top-k survivors and keeps the smallest prefix of the sorted
    distribution whose mass reaches ``p`` (the crossing token stays in).
    Returns int32 ``[B]``."""
    dev = logits.device
    temperature = temperature.to(dev)
    V = logits.shape[-1]
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    # greedy rows run the sampling math on a safe temperature and are
    # overridden by the final where
    t = torch.clamp(temperature, min=1e-6)[:, None]
    scaled = logits.float() / t
    srt = torch.sort(scaled, dim=-1, descending=True).values
    top_k = top_k.to(dev)
    k = torch.where(top_k > 0, torch.clamp(top_k, max=V),
                    torch.full_like(top_k, V))
    kth = torch.gather(srt, -1, (k - 1).long()[:, None])
    masked = torch.where(scaled < kth, -math.inf, scaled)
    srt = torch.where(srt >= kth, srt, -math.inf)
    probs = torch.softmax(srt, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    p = torch.clamp(top_p.to(dev), 0.0, 1.0)[:, None]
    keep = cum - probs < p
    cutoff = torch.where(keep, srt, math.inf).amin(dim=-1, keepdim=True)
    masked = torch.where(masked < cutoff, -math.inf, masked)
    sampled = prng.categorical(keys.to(dev), masked)
    return torch.where(temperature <= 0.0, greedy, sampled.to(torch.int32))


# ---------------------------------------------------------------------------
# shared pieces
# ---------------------------------------------------------------------------

def _layer(params: Dict, l: int) -> Dict:
    """Layer ``l``'s un-stacked weights (views; a tuple of the shards'
    views for a tensor-parallel leaf)."""
    return {name: (tuple(t[l] for t in w) if isinstance(w, tuple) else w[l])
            for name, w in params["layers"].items()}


def _pool_shards(pool) -> list:
    """The shard dicts of a pool operand: a dict is one shard, a list the
    tensor-parallel pool of :func:`init_paged_pool`."""
    return [pool] if isinstance(pool, dict) else list(pool)


def _pool_layer(pool: Dict, l: int) -> Dict:
    """Layer ``l``'s pool slice (views: writes land in ``pool``)."""
    return {name: a[l] for name, a in pool.items()}


def _lm_head(params: Dict, cfg: LlamaConfig, x):
    """Final norm + LM head on the last-position hidden ``x [B, 1, E]`` ->
    fp32 logits ``[B, V]``."""
    return _lm_head_all(params, cfg, x)[:, 0]


def _lm_head_all(params: Dict, cfg: LlamaConfig, x):
    """Final norm + LM head over every position of ``x [B, T, E]`` -> fp32
    logits ``[B, T, V]``."""
    x = _rms_norm(x, params["ln_f"], cfg.rms_norm_eps, cfg.use_fused_norm)
    if cfg.tie_word_embeddings:
        logits = x @ params["embed"].T.to(cfg.dtype)
    else:
        logits = _mm(x, params, "lm_head", cfg.dtype)
    return logits.to(torch.float32)


def _row_tables(cfg: LlamaConfig, pos):
    """Per-row RoPE tables for positions ``pos [B, T]`` -> cos/sin
    ``[B, T, D]``."""
    return rope_cos_sin(pos.shape[1], cfg.head_dim, cfg.rope_theta,
                        position_ids=pos)


def _local_heads(cfg: LlamaConfig, pool: Dict):
    """(query heads, kv heads) of one pool shard: ``Hk/tp`` kv heads, and
    as many query heads as the GQA group size ``G = H / Hk`` (shard
    invariant) gives."""
    Hk = pool["k"].shape[3]
    return Hk * (cfg.num_attention_heads // cfg.kv_heads), Hk


def _merge_heads(o, device=None):
    """Flatten the attention output ``[B, T, h, D] -> [B, T, h*D]`` for the
    output projection. A list is the tensor-parallel shards' outputs, each
    its slice of the heads: they are concatenated on the heads axis onto
    ``device`` in shard order (the reference's tiled all_gather) — an
    exact concatenation, never a sum, so ``wo`` and everything after it
    compute the single-device engine's values bit for bit."""
    if isinstance(o, list):
        o = torch.cat([t.to(device, non_blocking=True) for t in o], dim=2)
    B, T = o.shape[:2]
    return o.reshape(B, T, o.shape[2] * o.shape[3])


# ---------------------------------------------------------------------------
# the paged block pool
# ---------------------------------------------------------------------------

def init_paged_pool(cfg: LlamaConfig, num_blocks: int, block_size: int,
                    dtype=None, kv_quant=None, device=None,
                    devices=None):
    """Physical KV block pool ``{"k","v": [L, num_blocks, block_size, Hk,
    D]}`` shared by every sequence of a serving engine; block 0 is the
    NULL block (the scatter target of masked lanes, never allocated).
    ``kv_quant="int8"`` stores K/V as int8 with per-token-per-head fp32
    scales alongside (``"k_scale"``/``"v_scale" [L, N, bs, Hk]``).

    ``devices`` (a tensor-parallel placement,
    :func:`~paddle_tpu_torch.distributed.topology.tp_devices`) returns
    instead a LIST of ``tp`` pool dicts, shard ``s`` allocated on
    ``devices[s]`` with leaves ``[L, N, bs, Hk/tp, D]`` (scales ``[L, N,
    bs, Hk/tp]``) holding kv heads ``[s Hk/tp, (s+1) Hk/tp)``. Block ids
    stay global: every shard holds its heads of every block. An
    indivisible head count raises the structured error naming the
    leaf."""
    validate_quant_mode(kv_quant, KV_QUANT_MODES, "kv_quant")
    dt = dtype if dtype is not None else cfg.dtype
    shape = (cfg.num_hidden_layers, num_blocks, block_size, cfg.kv_heads,
             cfg.head_dim)
    leaves = ({"k": (shape, torch.int8), "v": (shape, torch.int8),
               "k_scale": (shape[:-1], torch.float32),
               "v_scale": (shape[:-1], torch.float32)}
              if kv_quant == "int8" else
              {"k": (shape, dt), "v": (shape, dt)})
    if devices is None:
        dev = resolve_device(device)
        return {n: torch.zeros(sh, dtype=t, device=dev)
                for n, (sh, t) in leaves.items()}
    tp = len(devices)
    for n, (sh, _) in leaves.items():
        shard_dim_spec(sh, tp, "tp", dim=3, name=f"paged_pool.{n}")
    return [{n: torch.zeros(sh[:3] + (sh[3] // tp,) + sh[4:], dtype=t,
                            device=dev)
             for n, (sh, t) in leaves.items()}
            for dev in devices]


def validate_tp(cfg: LlamaConfig, tp: int) -> None:
    """Check a tensor-parallel degree against a model config: the paged
    pool shards its kv-heads axis, so ``tp`` must be >= 1 and divide
    ``num_kv_heads`` (``ValueError`` naming the supported degrees)."""
    tp = int(tp)
    if tp < 1:
        raise ValueError(f"tensor-parallel degree must be >= 1 (1 = the "
                         f"single-device engine), got tp={tp}")
    if tp == 1:
        return
    Hk = cfg.kv_heads
    if Hk % tp:
        divisors = [d for d in range(1, Hk + 1) if Hk % d == 0]
        raise ValueError(
            f"tensor-parallel degree tp={tp} does not divide the model's "
            f"num_kv_heads={Hk} (the paged KV pool shards its kv-heads "
            f"axis); supported degrees for this config: {divisors}")


def paged_pool_block_bytes(cfg: LlamaConfig, block_size: int, dtype=None,
                           kv_quant=None, tp: int = 1) -> int:
    """Bytes ONE physical block costs across all layers (K + V + scales);
    with ``tp > 1`` the cost on each device of a pool whose kv heads are
    split ``tp`` ways."""
    validate_tp(cfg, tp)
    L, bs = cfg.num_hidden_layers, int(block_size)
    Hk, D = cfg.kv_heads // int(tp), cfg.head_dim
    if kv_quant == "int8":
        return L * bs * Hk * (2 * D * 1 + 2 * 4)
    dt = dtype if dtype is not None else cfg.dtype
    return L * bs * Hk * 2 * D * torch.empty((), dtype=dt).element_size()


def _kv_quantize(x):
    """Symmetric per-token-per-head int8: ``x [..., Hk, D]`` -> ``(q int8
    [..., Hk, D], scale fp32 [..., Hk])`` with ``x ~= q * scale``.
    Non-finite inputs yield NaN scales, so poison is never laundered."""
    xf = x.to(torch.float32)
    amax = xf.abs().amax(dim=-1)
    scale = torch.maximum(amax, amax.new_tensor(1e-8)) / 127.0
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def _write_src(cfg: LlamaConfig, phys, off, bs: int):
    """Under MoE, for each row of a dispatch's K/V write list (``phys``,
    ``off`` flattened), the row whose values it stores: the LAST row that
    writes the same pool cell, the value XLA's CPU scatter keeps. ``None``
    for a dense model.

    Inactive slots and padding positions all write into the null block,
    so several rows can write one cell, and a CUDA ``index_put_`` keeps an
    unspecified one of them. Under MoE that value reaches real rows:
    inactive and padding rows attend the null block, and their hidden
    states take places in the experts' capacity queues, which decide what
    real tokens drop. With every duplicate storing the last row's value
    the pool is a function of the inputs. In a dense model no real row
    reads the null block, so its write stays as it is."""
    if not cfg.moe_num_experts:
        return None
    key = (phys.long() * bs + off.long()).reshape(-1)
    n = key.numel()
    skey, order = torch.sort(key, stable=True)
    pos = torch.arange(n, device=key.device)
    # each sorted position's group end: the stable sort puts a cell's
    # last writer at the end of its group
    end = torch.where(torch.cat([skey[1:] != skey[:-1],
                                 skey.new_ones(1, dtype=torch.bool)]),
                      pos, n)
    end = end.flip(0).cummin(0).values.flip(0)
    src = torch.empty_like(order)
    src[order] = order[end]
    return src


def _kv_store(p: Dict, phys, off, k, v, src=None):
    """Scatter ``k``/``v [..., Hk, D]`` into one layer's pool slice at
    ``(phys, off)`` in place (quantizing for int8 pools); ``src`` (from
    :func:`_write_src`) makes each row store its cell's last writer's
    values. Returns the ATTEND view of the row's own new entries — what
    later reads of it observe: the values themselves for fp pools, the
    int8 round trip for quantized ones."""
    phys, off = phys.long(), off.long()
    if "k_scale" in p:
        qk, sk = _kv_quantize(k)
        qv, sv = _kv_quantize(v)
        vals = {"k": qk, "v": qv, "k_scale": sk, "v_scale": sv}
        view = (qk.to(torch.float32) * sk[..., None],
                qv.to(torch.float32) * sv[..., None])
    else:
        vals = {"k": k.to(p["k"].dtype), "v": v.to(p["v"].dtype)}
        view = (k, v)
    for name, t in vals.items():
        if src is not None:
            t = t.flatten(0, phys.dim() - 1)[src].reshape(t.shape)
        p[name][phys, off] = t
    return view


def _kv_gather(p: Dict, block_tables, B: int, C: int, Hk: int, D: int):
    """Gather one layer's pool through the block tables into logical order
    ``[B, C, Hk, D]``, dequantizing int8 pools after the gather — the
    gather path (``_masked_sdpa`` consumes the result)."""
    tbl = block_tables.long()
    kk = p["k"][tbl].reshape(B, C, Hk, D)
    vv = p["v"][tbl].reshape(B, C, Hk, D)
    if "k_scale" in p:
        ks = p["k_scale"][tbl].reshape(B, C, Hk)
        vs = p["v_scale"][tbl].reshape(B, C, Hk)
        kk = kk.to(torch.float32) * ks[..., None]
        vv = vv.to(torch.float32) * vs[..., None]
    return kk, vv


def _qkv(lp: Dict, h, cfg: LlamaConfig, B: int, T: int, H: int, Hk: int,
         ll: Optional[Dict] = None):
    """Pre-norm + the three projections, reshaped to heads
    (:func:`_project`)."""
    hh = _rms_norm(h, lp["ln_attn"], cfg.rms_norm_eps, cfg.use_fused_norm)
    return _project(lp, hh, cfg, B, T, H, Hk, ll)


def _project(lp: Dict, hh, cfg: LlamaConfig, B: int, T: int, H: int,
             Hk: int, ll: Optional[Dict] = None):
    """The q/k/v projections of the normed input ``hh``, reshaped to ``H``
    query and ``Hk`` kv heads (a shard's under tensor parallelism: ``lp``
    then holds its columns). ``ll`` (one layer of :func:`_lora_factors`)
    adds each row's adapter delta on ``hh`` before the reshape."""
    dt, D = cfg.dtype, cfg.head_dim
    q = _mm(hh, lp, "wq", dt)
    k = _mm(hh, lp, "wk", dt)
    v = _mm(hh, lp, "wv", dt)
    if ll is not None:
        q = q + gathered_delta(hh, ll["qA"], ll["qB"])
        k = k + gathered_delta(hh, ll["kA"], ll["kB"])
        v = v + gathered_delta(hh, ll["vA"], ll["vB"])
    return (q.reshape(B, T, H, D), k.reshape(B, T, Hk, D),
            v.reshape(B, T, Hk, D))


def _attn_out(lp: Dict, h, o, cfg: LlamaConfig, ll: Optional[Dict] = None):
    """Residual add of the output projection (plus each row's adapter
    delta on the merged heads when ``ll`` is given), then the FFN half:
    ``(block output, kept)``, ``kept`` the (token, choice) pairs the MoE
    FFN took (``0.0`` for a dense FFN). ``o`` may be the list of the
    tensor-parallel shards' outputs (:func:`_merge_heads`)."""
    dt = cfg.dtype
    m = _merge_heads(o, h.device).to(dt)
    d = _mm(m, lp, "wo", dt)
    if ll is not None:
        d = d + gathered_delta(m, ll["oA"], ll["oB"])
    out, _, kept = _ffn_tail(lp, h + d, cfg)
    return out, kept


def _lora_factors(cfg: LlamaConfig, lora: Optional[Dict]):
    """The multi-adapter operand ``{"ids": [B] pool slots, "layers":
    stacked adapter pool}`` gathered at the rows' slots and cast to the
    compute dtype, once per dispatch (``[L, B, ...]`` per leaf; a tuple
    of shards for the sharded ``qB``/``kB``/``vB``); ``None`` without
    LoRA, which leaves the computation exactly the LoRA-less one."""
    if lora is None:
        return None
    return gather_adapters(lora["layers"], lora["ids"], cfg.dtype)


def _lora_layer(factors: Optional[Dict], l: int) -> Optional[Dict]:
    """Layer ``l``'s gathered factors (views; a tuple of the shards' views
    for a tensor-parallel leaf), or ``None``."""
    if factors is None:
        return None
    return {name: (tuple(x[l] for x in t) if isinstance(t, tuple) else t[l])
            for name, t in factors.items()}


# the factors a shard's q/k/v projections read
_QKV_FACTORS = ("qA", "qB", "kA", "kB", "vA", "vB")


class _Shard:
    """One shard of a paged dispatch: its pool dict, the dispatch's
    operands on its device (``ops``: tensors by name, ``None`` kept) and
    its gathered LoRA factors for the q/k/v projections."""

    __slots__ = ("pool", "ops", "lora")

    def __init__(self, pool, ops, lora):
        self.pool, self.ops, self.lora = pool, ops, lora


def _shards(params: Dict, pool, lf: Optional[Dict], **ops):
    """The shards of the pool operand of a paged entry point: a dict is
    ONE shard and passes through untouched (every operand, the LoRA
    factors included, as given: the single-device path), a list is the
    tensor-parallel pool of :func:`init_paged_pool` — each shard gets the
    dispatch's operands moved once to its device (a no-op when it shares
    the lead device) and its slice of the q/k/v factors. The params must
    be sharded over as many devices as the pool
    (:func:`~paddle_tpu_torch.models.llama.shard_serving_params`)."""
    wq = params["layers"]["wq"]
    ways = len(wq) if isinstance(wq, tuple) else None
    if ways != (None if isinstance(pool, dict) else len(pool)):
        raise ValueError(
            f"a pool of {len(_pool_shards(pool))} shard(s) needs params "
            f"sharded as many ways (shard_serving_params; one shard: "
            f"unsharded), got {ways or 'unsharded'}")
    if isinstance(pool, dict):
        return [_Shard(pool, ops, lf)]
    out, moved = [], {}
    for s, p in enumerate(pool):
        dev = p["k"].device
        if dev not in moved:
            moved[dev] = {k: (v.to(dev, non_blocking=True)
                              if torch.is_tensor(v) else v)
                          for k, v in ops.items()}
        lora = None
        if lf is not None:
            lora = {n: (lf[n][s] if isinstance(lf[n], tuple)
                        else lf[n].to(dev, non_blocking=True))
                    for n in _QKV_FACTORS}
        out.append(_Shard(p, moved[dev], lora))
    return out


def _shard_layer(lp: Dict, s: int, sharded: bool) -> Dict:
    """Shard ``s``'s columns of layer ``lp``'s q/k/v projections (``lp``
    itself on the single-device path)."""
    if not sharded:
        return lp
    return {n: lp[n][s] for n in _SERVING_TP_SHARDED if n in lp}


def _attention(lp: Dict, x, cfg: LlamaConfig, shards, l: int, T: int,
               attend):
    """The attention half of paged layer ``l`` on ``x [B, T, E]``: the
    pre-norm once, on the lead device; then on every shard, on its
    device, the q/k/v projections through its columns and ``attend(q, k,
    v, pz, ops)`` (RoPE, the K/V store into its pool layer ``pz`` and
    attention). Returns the attention output ``[B, T, H, D]``, or the
    list of the shards' outputs for :func:`_merge_heads`."""
    B = x.shape[0]
    hh = _rms_norm(x, lp["ln_attn"], cfg.rms_norm_eps, cfg.use_fused_norm)
    sharded = isinstance(lp["wq"], tuple)
    outs = []
    for s, sh in enumerate(shards):
        H, Hk = _local_heads(cfg, sh.pool)
        h = hh.to(sh.pool["k"].device, non_blocking=True)
        q, k, v = _project(_shard_layer(lp, s, sharded), h, cfg, B, T, H,
                           Hk, _lora_layer(sh.lora, l))
        outs.append(attend(q, k, v, _pool_layer(sh.pool, l), sh.ops))
    return outs if sharded else outs[0]


def _dropped(cfg: LlamaConfig, T: int, kept):
    """The (token, choice) pairs a dispatch of ``T`` tokens dropped at
    capacity over its layers: ``L * T * top_k`` less the layers' ``kept``
    counts, subtracted once (each count is a whole number, exact in fp32,
    so this equals JAX's sum of per-layer drops). ``0.0`` for a dense
    model."""
    if not cfg.moe_num_experts:
        return 0.0
    return float(len(kept) * T * cfg.moe_top_k) - torch.stack(kept).sum()


# ---------------------------------------------------------------------------
# paged entry points
# ---------------------------------------------------------------------------

def paged_prefill(params: Dict, cfg: LlamaConfig, ids, prompt_lens,
                  block_tables, pool: Dict, active, lora=None):
    """Prefill a BATCH of admitted sequences into the paged pool.

    ``ids [B, Sb]`` right-padded; ``prompt_lens [B]``; ``block_tables
    [B, W]``; ``active [B]`` bool (inactive pad rows and pad positions
    scatter into the null block). On int8 pools the attention reads the
    quantized round trip of this batch's K/V, exactly what later dispatches
    gather back. ``lora`` (optional) is the multi-adapter operand
    ``{"ids": [B] adapter slots, "layers": stacked adapter pool}``.
    Returns (next-token logits ``[B, V]`` read at each row's ``prompt_len
    - 1``, pool, dropped tokens)."""
    B, Sb = ids.shape
    D = cfg.head_dim
    bs = _pool_shards(pool)[0]["k"].shape[2]
    W = block_tables.shape[1]
    dev = ids.device
    cos, sin = rope_cos_sin(Sb, D, cfg.rope_theta, device=dev)
    j = torch.arange(Sb, device=dev)
    valid = (j[None, :] < prompt_lens[:, None]) & active[:, None]   # [B, Sb]
    phys = torch.where(valid, block_tables[:, torch.clamp(j // bs, max=W - 1)],
                       torch.zeros((), dtype=block_tables.dtype, device=dev))
    off = (j % bs).expand(B, Sb)
    kv_mask = (j[None, :] <= j[:, None])[None].expand(B, Sb, Sb)

    x = _embed(params, ids, cfg.dtype)
    lf = _lora_factors(cfg, lora)
    shards = _shards(params, pool, lf, cos=cos, sin=sin, phys=phys, off=off,
                     src=_write_src(cfg, phys, off, bs), mask=kv_mask)

    def attend(q, k, v, pz, o):
        q = _rope(q, o["cos"], o["sin"], False)
        k = _rope(k, o["cos"], o["sin"], False)
        ka, va = _kv_store(pz, o["phys"], o["off"], k, v, o["src"])
        return _masked_sdpa(q, ka, va, o["mask"])

    kept = []
    for l in range(cfg.num_hidden_layers):
        lp = _layer(params, l)
        o = _attention(lp, x, cfg, shards, l, Sb, attend)
        x, n = _attn_out(lp, x, o, cfg, _lora_layer(lf, l))
        kept.append(n)
    idx = torch.clamp(prompt_lens.long() - 1, min=0)
    last = x[torch.arange(B, device=dev), idx][:, None]       # [B, 1, E]
    return (_lm_head(params, cfg, last), pool,
            _dropped(cfg, B * Sb, kept))


def paged_prefill_chunk(params: Dict, cfg: LlamaConfig, ids, start,
                        chunk_len, block_tables, pool: Dict, lora=None):
    """Prefill-from-offset: one sequence's chunk ``ids [1, Sb]`` (real
    length ``chunk_len``) at positions ``[start, start + chunk_len)``
    against the pool — the entry point behind chunked prefill and
    prefix-cache hits. Queries RoPE at their absolute positions, scatter
    their K/V, then attend the gathered pool under ``j <= start + i``.
    ``lora`` as in :func:`paged_prefill` (``ids [1]``). Returns
    (next-token logits ``[1, V]`` at position ``start + chunk_len - 1``,
    pool, dropped tokens)."""
    B, Sb = ids.shape
    D = cfg.head_dim
    bs = _pool_shards(pool)[0]["k"].shape[2]
    W = block_tables.shape[1]
    C = W * bs
    dev = ids.device
    start, chunk_len = int(start), int(chunk_len)
    j = torch.arange(Sb, device=dev)
    pos = (start + j)[None, :]                                # [1, Sb]
    cos, sin = _row_tables(cfg, pos)
    valid = j[None, :] < chunk_len
    phys = torch.where(valid,
                       block_tables[:, torch.clamp(pos[0] // bs, max=W - 1)],
                       torch.zeros((), dtype=block_tables.dtype, device=dev))
    off = pos % bs
    jg = torch.arange(C, device=dev)[None, None, :]
    kv_mask = jg <= pos[:, :, None]                           # [1, Sb, C]

    x = _embed(params, ids, cfg.dtype)
    lf = _lora_factors(cfg, lora)
    shards = _shards(params, pool, lf, cos=cos, sin=sin, phys=phys, off=off,
                     src=_write_src(cfg, phys, off, bs), tbl=block_tables,
                     mask=kv_mask)

    def attend(q, k, v, pz, o):
        q = _rope(q, o["cos"], o["sin"], False)
        k = _rope(k, o["cos"], o["sin"], False)
        _kv_store(pz, o["phys"], o["off"], k, v, o["src"])
        kk, vv = _kv_gather(pz, o["tbl"], B, C, k.shape[2], D)
        return _masked_sdpa(q, kk, vv, o["mask"])

    kept = []
    for l in range(cfg.num_hidden_layers):
        lp = _layer(params, l)
        o = _attention(lp, x, cfg, shards, l, Sb, attend)
        x, n = _attn_out(lp, x, o, cfg, _lora_layer(lf, l))
        kept.append(n)
    last = x[:, max(chunk_len - 1, 0)][:, None]               # [1, 1, E]
    return (_lm_head(params, cfg, last), pool,
            _dropped(cfg, B * Sb, kept))


def paged_decode_step(params: Dict, cfg: LlamaConfig, tokens, seq_lens,
                      block_tables, pool: Dict, active,
                      use_kernel: bool = False, lora=None):
    """One decode iteration over ``M`` serving slots against the pool.

    ``tokens [M]`` the last token per slot; ``seq_lens [M]`` int32 the KV
    entries already written (= the new token's position); ``block_tables
    [M, W]`` int32; ``active [M]`` bool (inactive slots scatter into the
    null block). Attention runs either through the gather path
    (``use_kernel=False``: ``_kv_gather`` + ``_masked_sdpa``) or through
    ``kernels.paged_attention`` (``use_kernel=True``: the CUDA kernel on a
    card — no gather is built). ``lora`` as in :func:`paged_prefill`.
    Returns (logits ``[M, V]``, pool, dropped tokens)."""
    M = tokens.shape[0]
    D = cfg.head_dim
    bs = _pool_shards(pool)[0]["k"].shape[2]
    W = block_tables.shape[1]
    C = W * bs
    dev = tokens.device
    cos, sin = _row_tables(cfg, seq_lens[:, None])           # [M, 1, D]
    widx = torch.clamp(seq_lens.long() // bs, max=W - 1)
    phys = torch.where(active, block_tables.gather(1, widx[:, None])[:, 0],
                       torch.zeros((), dtype=block_tables.dtype, device=dev))
    off = seq_lens % bs
    jj = torch.arange(C, device=dev)[None, :]
    kv_mask = (jj <= seq_lens[:, None])[:, None, :]          # [M, 1, C]

    x = _embed(params, tokens[:, None], cfg.dtype)
    lf = _lora_factors(cfg, lora)
    shards = _shards(params, pool, lf, cos=cos, sin=sin, phys=phys, off=off,
                     src=_write_src(cfg, phys, off, bs), tbl=block_tables,
                     sl=seq_lens, mask=kv_mask)

    def attend(q, k, v, pz, o):
        q = _rope(q, o["cos"], o["sin"], False)
        k = _rope(k, o["cos"], o["sin"], False)
        _kv_store(pz, o["phys"], o["off"], k[:, 0], v[:, 0], o["src"])
        if use_kernel:
            return paged_attention(q[:, 0].contiguous(), pz["k"], pz["v"],
                                   o["tbl"], o["sl"],
                                   k_scale=pz.get("k_scale"),
                                   v_scale=pz.get("v_scale"))[:, None]
        kk, vv = _kv_gather(pz, o["tbl"], M, C, k.shape[2], D)
        return _masked_sdpa(q, kk, vv, o["mask"])

    kept = []
    for l in range(cfg.num_hidden_layers):
        lp = _layer(params, l)
        o = _attention(lp, x, cfg, shards, l, 1, attend)
        x, n = _attn_out(lp, x, o, cfg, _lora_layer(lf, l))
        kept.append(n)
    return _lm_head(params, cfg, x), pool, _dropped(cfg, M, kept)


def paged_mixed_step(params: Dict, cfg: LlamaConfig, tokens, starts,
                     q_lens, block_tables, pool: Dict, active,
                     use_kernel: bool = False, lora=None):
    """ONE mixed prefill+decode iteration over ``M`` slots: row ``m`` of
    ``tokens [M, Q]`` holds ``q_lens[m]`` real tokens written from
    position ``starts[m]`` — a decode slot is the ``q_len == 1`` case, a
    prefill chunk a ``q_len == n`` row attending ``j <= start + q``. The
    ``draft_lens = q_lens - 1`` case of :func:`_paged_multiquery_forward`.
    Returns ``(logits [M, V], pool, dropped tokens)`` — logits after each
    row's LAST real token."""
    draft_lens = torch.clamp(q_lens - 1, min=0)
    x, pool, drops = _paged_multiquery_forward(params, cfg, tokens, starts,
                                               draft_lens, block_tables,
                                               pool, active, use_kernel,
                                               lora)
    M = tokens.shape[0]
    last = x[torch.arange(M, device=x.device), draft_lens.long()][:, None]
    return _lm_head(params, cfg, last), pool, drops


def paged_spec_step(params: Dict, cfg: LlamaConfig, tokens, seq_lens,
                    draft_lens, block_tables, pool: Dict, active,
                    use_kernel: bool = False, lora=None):
    """Speculative VERIFY over ``M`` slots: one multi-query decode
    iteration per slot against the pool. Row ``m`` of ``tokens [M, Q]``
    is the slot's last token followed by ``draft_lens[m] <= Q - 1``
    drafts (pad lanes repeat a real token); ``seq_lens [M]`` are the KV
    entries already committed. K/V are written for positions ``seq_lens +
    q``, ``q <= draft_lens``, and ``logits[m, q]`` is the next-token
    distribution after ``tokens[m, :q+1]`` — query ``q`` attends ``j <=
    seq_lens + min(q, draft_lens)``, what the sequential step at that
    position sees. The engine rolls rejected drafts back on the host.
    ``use_kernel`` runs the paged-attention kernel's multi-query entry
    point. Returns (logits ``[M, Q, V]``, pool, dropped tokens)."""
    x, pool, drops = _paged_multiquery_forward(params, cfg, tokens,
                                               seq_lens, draft_lens,
                                               block_tables, pool, active,
                                               use_kernel, lora)
    return _lm_head_all(params, cfg, x), pool, drops


def _paged_multiquery_forward(params: Dict, cfg: LlamaConfig, tokens,
                              seq_lens, draft_lens, block_tables,
                              pool: Dict, active, use_kernel: bool,
                              lora=None):
    """Embed ``tokens [M, Q]``, write K/V for every valid query position
    ``seq_lens + q`` (``q <= draft_lens``), attend ``j <= seq_lens +
    min(q, draft_lens)``, and return the hidden states ``[M, Q, E]``, the
    pool and the MoE drops. ``use_kernel`` runs the kernel's multi-query
    entry point."""
    M, Q = tokens.shape
    D = cfg.head_dim
    bs = _pool_shards(pool)[0]["k"].shape[2]
    W = block_tables.shape[1]
    C = W * bs
    dev = tokens.device
    qi = torch.arange(Q, device=dev)
    pos = seq_lens[:, None] + qi[None, :]                    # [M, Q]
    cos, sin = _row_tables(cfg, pos)
    valid_q = (qi[None, :] <= draft_lens[:, None]) & active[:, None]
    widx = torch.clamp(pos.long() // bs, max=W - 1)
    phys = torch.where(valid_q, block_tables.gather(1, widx),
                       torch.zeros((), dtype=block_tables.dtype, device=dev))
    off = pos % bs
    jj = torch.arange(C, device=dev)[None, None, :]
    qcap = torch.minimum(qi[None, :], draft_lens[:, None])   # [M, Q]
    kv_mask = jj <= (seq_lens[:, None] + qcap)[:, :, None]  # [M, Q, C]

    x = _embed(params, tokens, cfg.dtype)
    lf = _lora_factors(cfg, lora)
    shards = _shards(params, pool, lf, cos=cos, sin=sin, phys=phys, off=off,
                     src=_write_src(cfg, phys, off, bs), tbl=block_tables,
                     sl=seq_lens, dl=draft_lens, mask=kv_mask)

    def attend(q, k, v, pz, o):
        q = _rope(q, o["cos"], o["sin"], False)
        k = _rope(k, o["cos"], o["sin"], False)
        _kv_store(pz, o["phys"], o["off"], k, v, o["src"])
        if use_kernel:
            return paged_attention(q.contiguous(), pz["k"], pz["v"],
                                   o["tbl"], o["sl"], draft_lens=o["dl"],
                                   k_scale=pz.get("k_scale"),
                                   v_scale=pz.get("v_scale"))
        kk, vv = _kv_gather(pz, o["tbl"], M, C, k.shape[2], D)
        return _masked_sdpa(q, kk, vv, o["mask"])

    kept = []
    for l in range(cfg.num_hidden_layers):
        lp = _layer(params, l)
        o = _attention(lp, x, cfg, shards, l, Q, attend)
        x, n = _attn_out(lp, x, o, cfg, _lora_layer(lf, l))
        kept.append(n)
    return x, pool, _dropped(cfg, M * Q, kept)


# ---------------------------------------------------------------------------
# the dense-cache tier: prefill + decode over a [L, B, C, Hk, D] cache
# ---------------------------------------------------------------------------

def _on(x, device, dtype=None) -> torch.Tensor:
    """``x`` (a tensor, numpy array or list) as a tensor on ``device``."""
    t = x if torch.is_tensor(x) else torch.from_numpy(np.array(x))
    return t.to(device=device, dtype=dtype)


def init_cache(cfg: LlamaConfig, batch: int, capacity: int, dtype=None,
               device=None) -> Dict:
    """Stacked KV cache ``{"k","v": [L, B, C, Hk, D]}`` (static capacity)
    on ``device`` (the card unless ``"cpu"`` is asked for)."""
    dev = resolve_device(device)
    dt = dtype if dtype is not None else cfg.dtype
    shape = (cfg.num_hidden_layers, batch, capacity, cfg.kv_heads,
             cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dt, device=dev),
            "v": torch.zeros(shape, dtype=dt, device=dev)}


def _cached_layer(lp: Dict, x, ck, cv, cos, sin, kv_mask, write_idx: int,
                  cfg: LlamaConfig):
    """One decoder block attending against one layer's cache ``ck``/``cv
    [B, C, Hk, D]``: the new K/V rows of ``x [B, T, E]`` are written in
    place at cache positions ``[write_idx, write_idx + T)``, then every
    query attends the cache under ``kv_mask [B, T, C]``. Returns ``(block
    output, kept)`` (:func:`_attn_out`)."""
    B, T, _ = x.shape
    q, k, v = _qkv(lp, x, cfg, B, T, cfg.num_attention_heads, cfg.kv_heads)
    q = _rope(q, cos, sin, False)
    k = _rope(k, cos, sin, False)
    ck[:, write_idx:write_idx + T] = k.to(ck.dtype)
    cv[:, write_idx:write_idx + T] = v.to(cv.dtype)
    return _attn_out(lp, x, _masked_sdpa(q, ck, cv, kv_mask), cfg)


def _fwd_cached(params: Dict, cfg: LlamaConfig, ids, cache: Dict, cos, sin,
                kv_mask, write_idx: int):
    """Embed ``ids [B, T]``, run every layer against the cache, return
    (last-position logits ``[B, V]``, the cache, dropped tokens)."""
    x = _embed(params, ids, cfg.dtype)
    kept = []
    for l in range(cfg.num_hidden_layers):
        x, n = _cached_layer(_layer(params, l), x, cache["k"][l],
                             cache["v"][l], cos, sin, kv_mask, write_idx,
                             cfg)
        kept.append(n)
    return (_lm_head(params, cfg, x[:, -1:]), cache,
            _dropped(cfg, ids.numel(), kept))


def left_align(ids, prompt_lens, pad_token_id: int = 0):
    """Right-padded rows -> left-padded (row b's tokens end at index
    ``S - 1``), pad positions filled with ``pad_token_id``."""
    B, S = ids.shape
    j = torch.arange(S, device=ids.device)[None, :]
    shift = (S - prompt_lens.long())[:, None]
    out = torch.gather(ids, 1, (j - shift) % S)
    return torch.where(j >= shift, out,
                       torch.full((), pad_token_id, dtype=ids.dtype,
                                  device=ids.device))


def prefill(params: Dict, cfg: LlamaConfig, ids, prompt_lens, cache: Dict,
            left_padded: bool = False):
    """Run the prompt through the model, filling cache positions ``[0,
    S)``. ``ids [B, S]`` is right-padded ragged unless ``left_padded``;
    rows are left-aligned so every row's last prompt token sits at index
    ``S - 1``. Returns (next-token logits ``[B, V]``, cache, dropped
    tokens: the MoE capacity drops, ``0.0`` for a dense model)."""
    if not left_padded:
        ids = left_align(ids, prompt_lens)
    B, S = ids.shape
    C = cache["k"].shape[2]
    dev = ids.device
    j = torch.arange(S, device=dev)[None, :]
    shift = (S - prompt_lens.long())[:, None]                # [B, 1] pad
    valid = j >= shift                                       # [B, S]
    cos, sin = _row_tables(cfg, torch.clamp(j - shift, min=0))
    causal = (torch.arange(C, device=dev)[None, :]
              <= torch.arange(S, device=dev)[:, None])       # [S, C]
    valid_k = torch.nn.functional.pad(valid, (0, C - S))     # [B, C]
    kv_mask = causal[None] & valid_k[:, None, :]
    return _fwd_cached(params, cfg, ids, cache, cos, sin, kv_mask, 0)


def decode_step(params: Dict, cfg: LlamaConfig, token, t: int, prompt_lens,
                prompt_pad: int, cache: Dict):
    """One decode step: ``token [B]`` at step ``t`` (0-based), writing
    cache position ``prompt_pad + t`` (``prompt_pad = S``, the
    left-padded prompt length). Returns (logits ``[B, V]``, cache, dropped
    tokens)."""
    t, prompt_pad = int(t), int(prompt_pad)
    C = cache["k"].shape[2]
    dev = token.device
    plens = prompt_lens.long()
    cos, sin = _row_tables(cfg, (plens + t)[:, None])        # [B, 1, D]
    j = torch.arange(C, device=dev)[None, :]
    valid_prompt = (j >= (prompt_pad - plens)[:, None]) & (j < prompt_pad)
    appended = (j >= prompt_pad) & (j <= prompt_pad + t)
    kv_mask = (valid_prompt | appended)[:, None, :]          # [B, 1, C]
    return _fwd_cached(params, cfg, token[:, None], cache, cos, sin,
                       kv_mask, prompt_pad + t)


def _sample_keys(key, n: int):
    """The sub-keys of the first ``n`` draws of the JAX tier's key chain
    ``key, sub = split(key)``: ``[n, 2]`` int64 on ``key``'s device."""
    subs = []
    for _ in range(n):
        key, sub = prng.split(key)
        subs.append(sub)
    return torch.stack(subs)


def make_generate_fn(cfg: LlamaConfig, *, max_new_tokens: int,
                     temperature: float = 0.0, top_k: Optional[int] = None,
                     top_p: Optional[float] = None,
                     eos_token_id: Optional[int] = None,
                     pad_token_id: int = 0, return_drops: bool = False):
    """Build ``gen(params, ids [B, S], prompt_lens [B], key [2]) -> tokens
    [B, max_new_tokens]`` on the device of ``ids``.

    ``ids`` may be right-padded; rows are left-aligned internally. Rows
    finish at ``eos_token_id`` (emitted) and emit ``pad_token_id``
    thereafter; once every row has finished the loop exits, the output
    already holding ``pad_token_id`` where the skipped steps would have
    written it."""

    def gen(params, ids, prompt_lens, key):
        B, S = ids.shape
        dev = ids.device
        ids_l = left_align(ids, prompt_lens, pad_token_id)
        cache = init_cache(cfg, B, S + max_new_tokens, device=dev)
        logits, cache, drops = prefill(params, cfg, ids_l, prompt_lens,
                                       cache, left_padded=True)
        subs = (_sample_keys(key.cpu(), max_new_tokens).to(dev)
                if temperature != 0.0 else [None] * max_new_tokens)
        tok = _sample(logits, subs[0], temperature, top_k,
                      top_p).to(ids.dtype)
        out = torch.full((B, max_new_tokens), pad_token_id, dtype=ids.dtype,
                         device=dev)
        out[:, 0] = tok
        done = None if eos_token_id is None else tok == eos_token_id
        pad = torch.full((), pad_token_id, dtype=ids.dtype, device=dev)
        for t in range(max_new_tokens - 1):
            if done is not None and bool(done.all()):
                break                        # every row hit EOS
            logits, cache, d = decode_step(params, cfg, tok, t, prompt_lens,
                                           S, cache)
            nxt = _sample(logits, subs[t + 1], temperature, top_k,
                          top_p).to(ids.dtype)
            if done is not None:
                nxt = torch.where(done, pad, nxt)
                done = done | (nxt == eos_token_id)
            out[:, t + 1] = nxt
            drops = drops + d
            tok = nxt
        if return_drops:
            return out, drops
        return out

    return gen


def generate(params: Dict, ids, cfg: LlamaConfig, *, max_new_tokens: int,
             prompt_lens=None, temperature: float = 0.0,
             top_k: Optional[int] = None, top_p: Optional[float] = None,
             eos_token_id: Optional[int] = None, pad_token_id: int = 0,
             seed: Optional[int] = None, key=None):
    """Fixed-batch decode on the device of ``params`` — the dense-cache
    tier: every row holds a ``[B, S + max_new_tokens]`` KV cache for its
    whole lifetime and the batch retires together. Greedy outputs equal
    the serving engine's (its parity oracle). ``ids`` (numpy or a tensor)
    is taken as int32, as the JAX package takes it. Sampling draws with
    the key of ``seed`` (default ``GenerationConfig.seed``: 0), or the raw
    ``key [2]`` when given. Returns int32 tokens ``[B, max_new_tokens]``."""
    dev = params["embed"].device
    ids = _on(ids, dev, torch.int32)
    B, S = ids.shape
    prompt_lens = (torch.full((B,), S, dtype=torch.int32, device=dev)
                   if prompt_lens is None
                   else _on(prompt_lens, dev, torch.int32))
    if key is None:
        key = seed_key(int(seed) if seed is not None
                       else GenerationConfig.seed)
    fn = make_generate_fn(cfg, max_new_tokens=max_new_tokens,
                          temperature=temperature, top_k=top_k, top_p=top_p,
                          eos_token_id=eos_token_id,
                          pad_token_id=pad_token_id)
    return fn(params, ids, prompt_lens, _on(key, "cpu", torch.int64))


class DecodeSession:
    """Token-at-a-time decoding for streaming callers over the dense cache
    (updated in place between calls, where the JAX package donates it)::

        sess = DecodeSession(params, cfg, capacity=512)
        logits = sess.prefill(ids, prompt_lens)   # fills the cache
        for _ in range(n):
            tok = logits.argmax(-1)
            logits = sess.step(tok)
    """

    def __init__(self, params: Dict, cfg: LlamaConfig, capacity: int):
        self.params, self.cfg, self.capacity = params, cfg, capacity
        self.device = params["embed"].device
        self._cache = None
        self._t = 0
        self._dropped = None

    def prefill(self, ids, prompt_lens=None):
        ids = _on(ids, self.device, torch.int32)
        B, S = ids.shape
        if S > self.capacity:
            raise ValueError(f"prompt {S} exceeds capacity {self.capacity}")
        self._plens = (
            torch.full((B,), S, dtype=torch.int32, device=self.device)
            if prompt_lens is None
            else _on(prompt_lens, self.device, torch.int32))
        self._ppad = S
        self._t = 0
        cache = init_cache(self.cfg, B, self.capacity, device=self.device)
        logits, self._cache, self._dropped = prefill(
            self.params, self.cfg, ids, self._plens, cache)
        return logits

    def step(self, token):
        if self._cache is None:
            raise RuntimeError("call prefill() first")
        if self._ppad + self._t >= self.capacity:
            raise RuntimeError(f"capacity {self.capacity} exhausted")
        token = _on(token, self.device)
        logits, self._cache, drops = decode_step(
            self.params, self.cfg, token, self._t, self._plens, self._ppad,
            self._cache)
        self._dropped = self._dropped + drops
        self._t += 1
        return logits

    @property
    def dropped_tokens(self) -> float:
        """Cumulative MoE capacity-drop count of this session (0.0 for a
        dense model; nonzero means decode may part from the full-forward
        oracle)."""
        return float(self._dropped) if self._dropped is not None else 0.0

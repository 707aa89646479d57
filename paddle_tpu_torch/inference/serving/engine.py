"""Continuous-batching serving engine over the paged KV cache.

Counterpart of ``paddle_tpu/inference/serving/engine.py`` (``ServingConfig``
and ``ServingEngine``). The host logic — admission, batched bucketed
prefill, chunked prefill, prefix caching, on-demand block allocation with
preemption, mixed prefill+decode batching, seeded per-request sampling,
n-gram speculative decoding with host-side rollback, deadlines and
cancellation, multi-adapter LoRA serving (an adapter pool with an LRU
host registry, pinned by running requests through an admission gate,
adapter-namespaced prefix caching) — follows the JAX engine step for
step, so both engines issue the same dispatches for the same trace (the
parity tests compare their token streams and dispatch counters).

What differs is the device side. PyTorch runs eagerly, so there are no
compiled programs to share: each dispatch calls the paged entry points of
:mod:`paddle_tpu_torch.models.generation` directly, and the decode burst —
a ``lax.while_loop`` with a device-scalar bound in the JAX engine — is a
host loop of :func:`~paddle_tpu_torch.models.generation.paged_decode_step`
with the same ``limit`` and the same exit once no row is live. On a card
the paged-attention CUDA kernel runs every decode and mixed dispatch
(``paged_kernel="auto"``), the speculative verify included, and
``quantize="int8"`` routes every projection through the weight-only int8
kernel.

Sampling: token ``t`` of a request is drawn with the key
``fold_in(seed_key(seed), t)``. The keys of a dispatch are a pure function
of ``(seed, t)``, so the host folds them (CPU tensors, microseconds) and
only the ``[rows, V]`` random bits are drawn on the engine's device. A
dispatch whose rows are all greedy (decided on the host from the slot
table) takes the literal argmax and never runs the sampler.

Robustness: the host offload tier (``ServingConfig.offload``) swaps
evicted prefix-cache blocks to pinned host RAM and restores them on the
next hit; ``journal=`` feeds a :class:`~.journal.RequestJournal` (submit
records, delivered-token cursors, terminal transitions, one flush a
step); :meth:`ServingEngine.resubmit` re-queues a request with the tokens
it already delivered, the supervisor's recovery path; every step ticks
the global hang watchdog and marks its ``serving.step`` /
``serving.prefill`` / ``serving.decode`` sections. ``embed_model=
(BertConfig, params)`` serves prefill-only embedding requests through
:func:`~paddle_tpu_torch.models.bert.bert_encode`.

Live KV migration: :meth:`ServingEngine.serialize_request` snapshots a
live request with its committed KV blocks copied to host tensors, and
:meth:`ServingEngine.adopt` seats it on another engine mid-stream with no
recompute; :meth:`ServingEngine.export_chain` / :meth:`graft_chain` move
a cached prefix chain between engines, each block's leaves checksummed
with :func:`~.offload.block_crc` over their raw bytes (a bf16 block has
no numpy form, so the bytes travel as CPU tensors). The fleet router
(:mod:`.router`) drives both.

Tensor parallelism (``ServingConfig.tp``): one controller over a
placement of ``tp`` devices (``device=`` a list, or a single device that
:func:`~paddle_tpu_torch.distributed.topology.tp_devices` expands), as
the reference is one host program over a ``"tp"`` mesh. The QKV
projections and the paged KV pool are cut on their heads axis, one shard
a device; each dispatch runs every shard's projections, K/V store and
attention on its device and merges the heads by an exact concatenation
onto the lead device (``device[0]``), where ``wo``, the FFN, the head,
the sampler, the embeddings endpoint and every host structure
(scheduler, block manager, prefix cache, tables) stay one copy. Shards
may share a card. Host consumers of KV bytes see blocks in the global
layout (:class:`~.paged_cache.PagedKVCache` block I/O).

API::

    engine = ServingEngine(params, model_cfg, ServingConfig(max_slots=8))
    rid = engine.submit(prompt_ids, max_new_tokens=64)
    while engine.pending:
        for rid, toks in engine.step().items(): ...
    # or: outs = engine.run(prompts, max_new_tokens=64)
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ... import prng
from ...device import resolve_paged_kernel
from ...distributed.topology import tp_devices
from ...flags import flag
from ...health import watchdog as _watchdog
from ...models import generation as G
from ...models.bert import bert_encode
from ...models.llama import (KV_QUANT_MODES, QUANTIZE_MODES,
                             ensure_quantized, serving_placement,
                             shard_serving_params, validate_quant_mode)
from ...models.lora import AdapterPool
from .offload import block_crc as _block_crc
from .paged_cache import PagedKVCache
from .policies import resolve_policy
from .scheduler import (CANCELLED, DEFAULT_TENANT, SHED, TIMED_OUT, Request,
                        Scheduler, ServingQueueFull)

__all__ = ["ServingConfig", "ServingEngine", "ServingQueueFull",
           "AdoptError", "HEALTH_SNAPSHOT_KEYS", "SUPERVISOR_SNAPSHOT_KEYS"]

_UNSET = "unset"

# the keys of health_snapshot(): the engine serves every one except
# SUPERVISOR_SNAPSHOT_KEYS, which EngineSupervisor layers on top
HEALTH_SNAPSHOT_KEYS = (
    "ok", "accepting", "policy", "queued", "queue_limit", "live_slots",
    "max_slots", "free_blocks", "usable_blocks", "kv_pool_bytes",
    "tp_degree", "kv_pool_shard_bytes", "kv_quant", "paged_kernel",
    "spec_decode", "retry_after_s", "counters", "dispatch_latency",
    "offload", "lora", "watchdog", "tenants", "supervisor", "autoscale")
SUPERVISOR_SNAPSHOT_KEYS = ("supervisor", "autoscale")

class AdoptError(RuntimeError):
    """A migration target refused a serialized request (pool full, no free
    slot, KV-layout mismatch, over-long chain, unregistered adapter). The
    caller falls back to the resubmit path — recompute instead of
    transfer, outputs still bit-identical."""


def _host_copy(t: torch.Tensor) -> torch.Tensor:
    """A host tensor that owns its bytes (never a view of a buffer another
    owner may overwrite later)."""
    return t.detach().to("cpu", copy=True).contiguous()


# weights the engine casts once to the activation dtype (every use casts
# them to it anyway, so the result is the same and no dispatch pays the
# cast again)
_MATMUL_WEIGHTS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


@dataclasses.dataclass
class ServingConfig:
    """Engine shape/capacity knobs. ``None`` fields resolve from the
    ``FLAGS_serving_*`` registry at construction. The feature knobs use
    the ``"unset"`` sentinel: left unset they resolve from their flag; an
    EXPLICIT ``None`` (or ``False``/``0``) disables the feature."""

    block_size: Optional[int] = None
    max_slots: Optional[int] = None
    max_model_len: Optional[int] = None
    queue_depth: Optional[int] = None
    decode_chunk: Optional[int] = None
    num_blocks: int = 0              # 0 = auto (max_slots full sequences)
    quantize: Optional[str] = None   # "int8" -> weight-only int8 kernel
    cache_dtype: Any = None          # None -> model activation dtype
    kv_quant: Any = _UNSET           # "int8" -> int8 KV pool + scales
    paged_kernel: Any = _UNSET       # "auto" (kernel on a card) / on / off
    prefix_cache: Any = _UNSET       # bool; None/False = off
    prefill_chunk: Any = _UNSET      # tokens per chunk; None/0 = whole
    preempt: Any = _UNSET            # bool; None/False = reservation
    mixed_batch: Any = _UNSET        # bool; None/False = two-phase path
    policy: Any = None               # AdmissionPolicy or a name
    tenant_cache_quota: Any = _UNSET  # blocks per tenant; None/0 = off
    spec_decode: Any = _UNSET        # drafts per verify; None/0 = off
    spec_ngram: Any = _UNSET         # n-gram the drafter matches
    lora_rank: Optional[int] = None  # adapter rank r (fixed pool-wide)
    lora_slots: Optional[int] = None  # device adapter-pool slots on top of
    #                                   the zeroed base slot 0; 0 = off
    lora_pool: Optional[int] = None  # host-registry capacity (>= slots)
    offload: Any = _UNSET            # bool; evicted registered blocks swap
    #                                  to a bounded pinned host pool
    #                                  instead of dying
    offload_blocks: Any = _UNSET     # host-tier capacity bound in blocks
    tp: Optional[int] = None         # tensor-parallel degree: the QKV
    #                                  projections and the paged pool
    #                                  split their heads over this many
    #                                  placement devices; None ->
    #                                  FLAGS_serving_tp (1 = one device)

    def __post_init__(self):
        if self.tp is None:
            self.tp = int(flag("FLAGS_serving_tp"))
        self.tp = int(self.tp)
        if self.tp < 1:
            raise ValueError(f"tensor-parallel degree must be >= 1 (1 = "
                             f"the single-device engine), got tp={self.tp}")
        for f, name in (("block_size", "FLAGS_serving_block_size"),
                        ("max_slots", "FLAGS_serving_max_slots"),
                        ("max_model_len", "FLAGS_serving_max_model_len"),
                        ("queue_depth", "FLAGS_serving_queue_depth"),
                        ("decode_chunk", "FLAGS_serving_decode_chunk"),
                        ("lora_rank", "FLAGS_serving_lora_rank"),
                        ("lora_slots", "FLAGS_serving_lora_slots"),
                        ("lora_pool", "FLAGS_serving_lora_pool")):
            if getattr(self, f) is None:
                setattr(self, f, int(flag(name)))
        self.lora_rank = int(self.lora_rank)
        self.lora_slots = int(self.lora_slots)
        self.lora_pool = int(self.lora_pool)
        if self.lora_slots < 0:
            raise ValueError(f"lora_slots must be >= 0 (0 = multi-adapter "
                             f"serving off), got {self.lora_slots}")
        if self.lora_slots and self.lora_pool < self.lora_slots:
            raise ValueError(
                f"lora_pool ({self.lora_pool}) must be >= lora_slots "
                f"({self.lora_slots}): the host registry backs every "
                f"device-resident adapter (FLAGS_serving_lora_pool / "
                f"FLAGS_serving_lora_slots)")
        for f in ("prefix_cache", "preempt", "mixed_batch"):
            if getattr(self, f) == _UNSET:
                setattr(self, f, bool(flag(f"FLAGS_serving_{f}")))
            else:
                setattr(self, f, bool(getattr(self, f)))
        if self.prefill_chunk == _UNSET:
            self.prefill_chunk = int(flag("FLAGS_serving_prefill_chunk"))
        self.prefill_chunk = (int(self.prefill_chunk)
                              if self.prefill_chunk else None)
        if self.prefill_chunk is not None and self.prefill_chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1 or None/0 "
                             f"(got {self.prefill_chunk})")
        if self.spec_decode == _UNSET:
            self.spec_decode = int(flag("FLAGS_serving_spec_decode"))
        self.spec_decode = int(self.spec_decode) if self.spec_decode else 0
        if self.spec_decode < 0:
            raise ValueError(f"spec_decode must be >= 0 (draft tokens per "
                             f"verify; 0 = off), got {self.spec_decode}")
        if self.spec_ngram in (_UNSET, None):
            self.spec_ngram = int(flag("FLAGS_serving_spec_ngram"))
        self.spec_ngram = int(self.spec_ngram)
        if self.spec_ngram < 1:
            raise ValueError(f"spec_ngram must be >= 1, "
                             f"got {self.spec_ngram}")
        if self.tenant_cache_quota == _UNSET:
            self.tenant_cache_quota = int(
                flag("FLAGS_serving_tenant_cache_quota"))
        self.tenant_cache_quota = (int(self.tenant_cache_quota)
                                   if self.tenant_cache_quota else None)
        if self.offload == _UNSET:
            self.offload = bool(flag("FLAGS_serving_offload"))
        else:
            self.offload = bool(self.offload)
        if self.offload_blocks == _UNSET:
            self.offload_blocks = int(flag("FLAGS_serving_offload_blocks"))
        self.offload_blocks = (int(self.offload_blocks)
                               if self.offload_blocks else 0)
        if self.policy is None:
            self.policy = str(flag("FLAGS_serving_policy"))
        validate_quant_mode(self.quantize, QUANTIZE_MODES)
        if self.kv_quant == _UNSET:
            self.kv_quant = str(flag("FLAGS_serving_kv_quant"))
        self.kv_quant = self.kv_quant or None      # ""/False -> fp pool
        validate_quant_mode(self.kv_quant, KV_QUANT_MODES, "kv_quant")
        if self.paged_kernel == _UNSET:
            self.paged_kernel = str(flag("FLAGS_serving_paged_kernel"))
        # validate now (structured error on bad knobs); the engine resolves
        # "auto" against its device
        resolve_paged_kernel(self.paged_kernel, torch.device("cpu"))


class ServingEngine:
    """Continuous-batching decode service over a causal-LM parameter dict,
    on ``device`` (CUDA unless ``device="cpu"``; at ``tp > 1`` a placement,
    see :func:`~paddle_tpu_torch.distributed.topology.tp_devices`, whose
    entry 0 is the lead device ``self.device``).

    ``journal`` is an optional :class:`~.journal.RequestJournal` this
    engine feeds under its own lock; ``embed_model`` an optional
    ``(BertConfig, params)`` encoder serving :meth:`submit_embedding`.
    Both sets of params are moved/cast once here; handing an engine
    another engine's ``prepared_params`` makes every cast a no-op (the
    supervisor's rebuild, and every replica of a router fleet)."""

    # fault-injection hook: when set, the NEXT export_chain() flips one
    # byte of its payload AFTER stamping the checksums, so the receiving
    # graft_chain() must detect the mismatch and degrade to recompute.
    # Class-level default; injectors set it per instance and the export
    # consumes it.
    _corrupt_next_export = False

    def __init__(self, params, model_config,
                 serving_config: Optional[ServingConfig] = None,
                 gen_config: Optional[G.GenerationConfig] = None,
                 device=None, journal=None, embed_model=None):
        self.config = serving_config or ServingConfig()
        # tensor parallelism: the degree must divide the kv heads, then the
        # placement; shard s of the projections and the pool lives on
        # devices[s], everything replicated on devices[0]
        G.validate_tp(model_config, self.config.tp)
        self.devices = tp_devices(self.config.tp, device)
        self.device = self.devices[0]
        self._gen = gen_config or G.GenerationConfig()
        self._cfg = model_config
        self._params = self._prepare_params(params)
        # durable serving: a RequestJournal fed under the engine lock —
        # submit records, per-step delivered-token cursors, terminal
        # transitions — with ONE flush per step. None = durability off.
        self.journal = journal
        self._jlive: Dict[int, int] = {}   # rid -> owned journal jid
        # embeddings endpoint: an optional (BertConfig, params) encoder
        # serving prefill-only requests (kind "embed")
        if embed_model is not None:
            ecfg, eparams = embed_model
            self._embed_cfg = ecfg
            self._embed_params = self._move(eparams)
        else:
            self._embed_cfg = self._embed_params = None
        self.cache = PagedKVCache(model_config, self.config.max_slots,
                                  self.config.max_model_len,
                                  self.config.block_size,
                                  self.config.num_blocks,
                                  dtype=self.config.cache_dtype,
                                  prefix_cache=self.config.prefix_cache,
                                  tenant_quota=self.config.tenant_cache_quota,
                                  kv_quant=self.config.kv_quant,
                                  device=self.device,
                                  devices=self.devices,
                                  offload=self.config.offload,
                                  offload_blocks=self.config.offload_blocks)
        self._policy = resolve_policy(
            self.config.policy,
            ttft_slo_s=float(flag("FLAGS_serving_ttft_slo_s")))
        self._sched = Scheduler(self.cache, self.config.max_slots,
                                self.config.queue_depth,
                                preempt=self.config.preempt,
                                policy=self._policy)
        self._use_kernel = resolve_paged_kernel(self.config.paged_kernel,
                                                self.device)
        M = self.config.max_slots
        self._tokens = np.zeros((M,), np.int32)
        self._seq_lens = np.zeros((M,), np.int32)
        self._steps_left = np.zeros((M,), np.int32)
        self._done = np.ones((M,), bool)          # empty slots are inactive
        self._eos = np.full((M,), -1, np.int32)
        # per-slot sampling knobs and each request's base key (int64
        # holding uint32 values); the index a token is drawn at (fold_in's
        # datum) is the count of tokens its request already holds
        self._temp = np.zeros((M,), np.float32)
        self._topk = np.zeros((M,), np.int32)     # 0 = disabled
        self._topp = np.ones((M,), np.float32)    # 1.0 = disabled
        self._keys = np.zeros((M, 2), np.int64)
        self._spec_k = int(self.config.spec_decode)
        self._spec_n = int(self.config.spec_ngram)
        # multi-adapter LoRA: the device adapter pool, the per-slot
        # adapter-row operand of every dispatch (0 = the zeroed base
        # adapter) and the rid -> adapter pins the admission gate keeps
        # (held across preemption, released at a terminal state)
        self._lora = (AdapterPool(model_config, self.config.lora_rank,
                                  self.config.lora_slots,
                                  self.config.lora_pool, devices=self.devices)
                      if self.config.lora_slots else None)
        self._adapters = np.zeros((M,), np.int32)
        self._lora_pinned: Dict[int, str] = {}
        # every mutation and snapshot read runs under this lock; reentrant
        # because stream()'s GeneratorExit path cancels from inside a step
        self._lock = threading.RLock()
        self._out_width = int(self.config.max_model_len)
        self._stats = {"chunks": 0, "steps": 0, "prefill_dispatches": 0,
                       "decode_dispatches": 0, "mixed_dispatches": 0,
                       "spec_dispatches": 0, "spec_steps": 0,
                       "decode_iters": 0, "embeds": 0}
        self._dispatch_s = {"prefill": 0.0, "decode": 0.0, "mixed": 0.0,
                            "spec": 0.0}
        # bounded recent windows of dispatch wall time per kind, behind
        # the p50/p99 rows of stats() and health_snapshot()
        self._dispatch_ms = {k: collections.deque(maxlen=512)
                             for k in self._dispatch_s}
        self._prefill_buckets: set = set()

    def _move(self, tree) -> Dict:
        """A (nested dict) tree of tensors on the engine's device (a no-op
        for tensors already there)."""
        return {k: self._move(v) if isinstance(v, dict)
                else v.to(self.device) for k, v in tree.items()}

    @property
    def prepared_params(self) -> Dict:
        """The params as this engine holds them (on its device, quantized,
        cast and, at ``tp > 1``, sharded over its placement): a rebuilt
        engine or a twin replica given these allocates nothing new."""
        return self._params

    def _prepare_params(self, params) -> Dict:
        """Params on the engine's device, weight-only quantized when the
        config asks, fp matmul weights and the embedding cast once to the
        activation dtype; at ``tp > 1`` then sharded over the placement
        (:func:`~paddle_tpu_torch.models.llama.shard_serving_params`).
        Params already sharded (another engine's ``prepared_params``) are
        taken as they are when their placement is this engine's: no
        re-shard, no second copy."""
        placement = serving_placement(params)
        if placement is not None:
            if placement != self.devices:
                raise ValueError(
                    f"params sharded over {[str(d) for d in placement]} "
                    f"cannot serve an engine placed on "
                    f"{[str(d) for d in self.devices]} (tp="
                    f"{self.config.tp}); pass the unsharded params")
            if self.config.quantize == "int8" and \
                    "wq_s" not in params["layers"]:
                raise ValueError("params were sharded before quantize="
                                 "'int8'; pass the unsharded params")
            return params
        dt = self._cfg.dtype
        p = ensure_quantized(self._move(params), self.config.quantize)
        p = dict(p)
        layers = dict(p["layers"])
        for name in _MATMUL_WEIGHTS:
            if name in layers and layers[name].is_floating_point():
                layers[name] = layers[name].to(dt)
        p["layers"] = layers
        p["embed"] = p["embed"].to(dt)
        if "lm_head" in p and p["lm_head"].is_floating_point():
            p["lm_head"] = p["lm_head"].to(dt)
        if self.config.tp > 1:
            p = shard_serving_params(p, self.devices)
        return p

    def _t(self, a) -> torch.Tensor:
        """A host array as a tensor on the engine's device."""
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    @staticmethod
    def _bucket(n: int) -> int:
        b = 8
        while b < n:
            b *= 2
        return b

    def _lora_operand(self, ids) -> Optional[Dict[str, Any]]:
        """The LoRA operand of a dispatch: per-row adapter pool slots and
        the stacked pool, or None with multi-adapter serving off."""
        if self._lora is None:
            return None
        return {"ids": self._t(np.asarray(ids, np.int32)),
                "layers": self._lora.layers}

    def _record_dispatch(self, kind: str, t0: float) -> None:
        """Count + time ONE device dispatch by kind (``chunks`` is the
        all-kinds total). Every dispatch ends in a device-to-host read of
        its tokens, so the host clock spans the device work."""
        dt = time.time() - t0
        self._stats["chunks"] += 1
        self._stats[kind + "_dispatches"] += 1
        self._dispatch_s[kind] += dt
        self._dispatch_ms[kind].append(dt * 1e3)

    def _dispatch_latency(self) -> Dict[str, Dict[str, Any]]:
        """p50/p99 dispatch wall time per kind over the recent window."""
        out: Dict[str, Dict[str, Any]] = {}
        for kind, window in self._dispatch_ms.items():
            n = int(self._stats.get(kind + "_dispatches", 0))
            if window:
                xs = np.asarray(window, np.float64)
                out[kind] = {
                    "count": n,
                    "p50_ms": round(float(np.percentile(xs, 50)), 3),
                    "p99_ms": round(float(np.percentile(xs, 99)), 3)}
            else:
                out[kind] = {"count": n, "p50_ms": None, "p99_ms": None}
        return out

    # ---- request lifecycle ------------------------------------------------

    def submit(self, prompt, max_new_tokens: Optional[int] = None,
               eos_token_id: Optional[int] = "unset",
               timeout_s: Optional[float] = None,
               deadline_s: Optional[float] = None,
               tenant: Optional[str] = None, priority: int = 0,
               temperature: Any = "unset", top_k: Any = "unset",
               top_p: Any = "unset", seed: Any = "unset",
               adapter_id: Optional[str] = None) -> int:
        """Queue one prompt; returns the request id. ``eos_token_id``
        defaults to the engine's GenerationConfig (``None`` disables EOS).
        ``timeout_s`` / ``deadline_s`` bound the request's wall time
        (queued expiry sheds it, running expiry times it out); ``tenant``
        and ``priority`` feed the admission policy. The sampling knobs
        resolve through the engine's GenerationConfig (``None`` disables
        ``top_k``/``top_p``): ``temperature`` 0 is the greedy argmax;
        above 0 the stream is drawn with keys derived from ``seed``, the
        same for the same ``(request, seed)``. Unsupported knobs raise
        ``ValueError``. ``adapter_id`` selects a registered LoRA adapter
        (None = base traffic through the zeroed slot 0); admission pins it
        device-resident for the request's whole lifetime, preemption
        included. Raises :class:`ServingQueueFull` when the bounded queue
        is full."""
        deadline = deadline_s
        if timeout_s is not None:
            t = time.time() + float(timeout_s)
            deadline = t if deadline is None else min(deadline, t)
        req = self._make_request(prompt, max_new_tokens, eos_token_id,
                                 tenant, priority, deadline,
                                 temperature=temperature, top_k=top_k,
                                 top_p=top_p, seed=seed,
                                 adapter_id=adapter_id)
        with self._lock:
            rid = self._sched.submit(req)
            self._journal_submit(req)
            return rid

    def _make_request(self, prompt, max_new_tokens, eos_token_id, tenant,
                      priority, deadline, tokens: Sequence[int] = (),
                      temperature: Any = "unset", top_k: Any = "unset",
                      top_p: Any = "unset", seed: Any = "unset",
                      adapter_id: Optional[str] = None) -> Request:
        """One Request from user-facing arguments — the single place
        submit() and resubmit() resolve the GenerationConfig defaults, the
        "unset" sentinels and the tenant key, so fresh and recovered
        requests can never diverge in defaults."""
        g = G.GenerationConfig.resolve(
            self._gen, max_new_tokens=max_new_tokens,
            eos_token_id=eos_token_id, temperature=temperature,
            top_k=top_k, top_p=top_p, seed=seed)
        G.validate_sampling(g)
        req = Request(
            rid=-1, prompt=np.asarray(prompt, np.int32).reshape(-1),
            max_new_tokens=int(g.max_new_tokens),
            eos_token_id=g.eos_token_id,
            temperature=float(g.temperature),
            top_k=int(g.top_k) if g.top_k is not None else None,
            top_p=float(g.top_p) if g.top_p is not None else None,
            seed=int(g.seed),
            tenant=str(tenant) if tenant is not None else DEFAULT_TENANT,
            priority=int(priority),
            deadline=float(deadline) if deadline is not None else None)
        req.tokens = [int(t) for t in tokens]
        if req.tokens and req.eos_token_id is not None and \
                req.tokens[-1] == req.eos_token_id:
            req.eos_seen = True
        if req.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if req.prompt_len < 1:
            raise ValueError("prompt must contain at least one token")
        if adapter_id is not None:
            if self._lora is None:
                raise ValueError(
                    "adapter_id requires multi-adapter serving: set "
                    "ServingConfig.lora_slots / FLAGS_serving_lora_slots "
                    "> 0")
            if not self._lora.is_registered(adapter_id):
                raise ValueError(
                    f"adapter {adapter_id!r} is not registered on this "
                    f"engine (register_adapter() first; registered: "
                    f"{self._lora.registered()})")
            req.adapter_id = str(adapter_id)
        return req

    def resubmit(self, prompt, tokens: Sequence[int] = (),
                 max_new_tokens: Optional[int] = None,
                 eos_token_id: Optional[int] = "unset",
                 deadline: Optional[float] = None,
                 tenant: Optional[str] = None, priority: int = 0,
                 temperature: Any = "unset", top_k: Any = "unset",
                 top_p: Any = "unset", seed: Any = "unset",
                 jid: Optional[int] = None,
                 adapter_id: Optional[str] = None) -> int:
        """Re-queue a request recovered from a torn-down engine with the
        tokens it had already emitted — the supervisor's restart path.
        Rides the preemption-recompute machinery: prefill recomputes KV
        for ``prompt + tokens[:-1]`` and decode resumes from the last
        token, so the stream equals an uninterrupted run (token ``t`` is
        drawn with the key of ``(seed, t)``) and no delivered token is
        re-emitted. ``deadline`` is ABSOLUTE. Bypasses the queue-depth
        shed (the work was accepted once already). ``jid`` re-attaches
        the request to a live journal record (no duplicate submit event);
        an unknown or terminal jid falls back to a fresh record seeded
        with the delivered tokens."""
        req = self._make_request(prompt, max_new_tokens, eos_token_id,
                                 tenant, priority, deadline, tokens=tokens,
                                 temperature=temperature, top_k=top_k,
                                 top_p=top_p, seed=seed,
                                 adapter_id=adapter_id)
        if req.finished:
            raise ValueError(
                f"request is already finished ({len(req.tokens)} tokens of "
                f"{req.max_new_tokens}); record it, don't resubmit it")
        with self._lock:
            rid = self._sched.submit(req, enforce_bound=False)
            self._journal_submit(req, jid)
            return rid

    # ---- durable journal hooks ---------------------------------------------

    def _journal_submit(self, req: Request,
                        jid: Optional[int] = None) -> None:
        """Attach a just-queued request to the journal: resume a live
        record named by ``jid``, else append a fresh submit event with the
        RESOLVED record. Caller holds the engine lock."""
        if self.journal is None:
            return
        if jid is not None and jid >= 0 \
                and self.journal.resume(jid, req.tokens):
            req.jid = jid
        else:
            req.jid = self.journal.log_submit(
                prompt=req.prompt, max_new_tokens=req.max_new_tokens,
                eos_token_id=req.eos_token_id,
                temperature=req.temperature, top_k=req.top_k,
                top_p=req.top_p, seed=req.seed, tenant=req.tenant,
                priority=req.priority, deadline=req.deadline,
                tokens=req.tokens, adapter_id=req.adapter_id)
        self._jlive[req.rid] = req.jid

    def _journal_end(self, req: Request) -> None:
        """Journal a terminal transition the moment it happens (a
        disowned request, jid -1, logs nothing). Caller holds the lock."""
        self._jlive.pop(req.rid, None)
        if self.journal is not None and req.jid >= 0:
            self.journal.log_terminal(req.jid, req.state)

    def _journal_step(self, emitted: Dict[int, List[int]]) -> None:
        """The per-step journal hook, run under the engine lock right after
        ``_step``: log every delivered-token cursor advance and the
        terminal transitions the retire sweep made, then flush — one fsync
        a step under the default policy, at the boundary where the tokens
        become visible to the caller."""
        if self.journal is None:
            return
        for rid, toks in emitted.items():
            jid = self._jlive.get(rid)
            if jid is not None and toks:
                self.journal.log_tokens(jid, toks)
        fin = self._sched.finished
        for rid in [r for r in self._jlive if r in fin]:
            req = fin[rid]
            self._jlive.pop(rid, None)
            if req.jid >= 0:
                self.journal.log_terminal(req.jid, req.state)
        self.journal.flush()

    def _journal_flush(self) -> None:
        if self.journal is not None:
            self.journal.flush()

    def journal_disown(self, rid: int) -> None:
        """Detach a live request from its journal record WITHOUT ending it
        (a deliberate move cancels its vacated copy, and that cancel must
        not mark the still-live logical request terminal)."""
        with self._lock:
            self._jlive.pop(rid, None)
            req = self._sched.find(rid)
            if req is not None:
                req.jid = -1

    def journal_own(self, rid: int, jid: int, tokens) -> bool:
        """Attach a live request to journal record ``jid``, rebasing the
        record's delivered cursor to ``tokens``. False when the record is
        unknown or terminal, or the rid is not live."""
        with self._lock:
            if self.journal is None:
                return False
            req = self._sched.find(rid)
            if req is None or not self.journal.resume(jid, tokens):
                return False
            req.jid = int(jid)
            self._jlive[rid] = req.jid
            return True

    # ---- embeddings endpoint -----------------------------------------------

    def submit_embedding(self, prompt, timeout_s: Optional[float] = None,
                         deadline_s: Optional[float] = None,
                         tenant: Optional[str] = None,
                         priority: int = 0) -> int:
        """Queue one prefill-only EMBEDDING request: it rides the bounded
        admission queue, runs through the attached encoder in the next
        step's batched bucketed dispatch, and retires there with the
        pooled hidden states readable via :meth:`embedding`. Embeds hold
        no decode slot and no KV block and are NOT journaled."""
        if self._embed_params is None:
            raise ValueError(
                "no embedding model attached: construct the engine with "
                "embed_model=(BertConfig, params) to serve embeddings")
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.shape[0] < 1:
            raise ValueError("prompt must contain at least one token")
        if prompt.shape[0] > self._embed_cfg.max_position_embeddings:
            raise ValueError(
                f"embedding prompt has {prompt.shape[0]} tokens > the "
                f"encoder's max_position_embeddings "
                f"{self._embed_cfg.max_position_embeddings}")
        deadline = deadline_s
        if timeout_s is not None:
            t = time.time() + float(timeout_s)
            deadline = t if deadline is None else min(deadline, t)
        req = Request(
            rid=-1, prompt=prompt, max_new_tokens=1,
            tenant=str(tenant) if tenant is not None else DEFAULT_TENANT,
            priority=int(priority),
            deadline=float(deadline) if deadline is not None else None,
            kind="embed")
        with self._lock:
            return self._sched.submit(req)

    def embedding(self, rid: int) -> np.ndarray:
        """The pooled ``[hidden_size]`` fp32 embedding of a finished embed
        request (KeyError while still queued)."""
        with self._lock:
            return self._sched.finished[rid].embedding

    # ---- live KV migration -----------------------------------------------

    def kv_shape_key(self) -> tuple:
        """The KV-layout signature two engines must share for a block
        chain to transfer byte for byte: block size, quantization mode,
        TP degree and every pool leaf's per-block shape and dtype (the
        block axis itself left out, so pools of different sizes
        interoperate; the int8 scale leaves included), dtypes spelled as
        the reference spells them. :meth:`adopt` and :meth:`graft_chain`
        refuse a mismatched payload."""
        return (int(self.config.block_size), str(self.config.kv_quant),
                int(self.config.tp),
                tuple(sorted((name, str(dt).replace("torch.", ""),
                              tuple(int(s) for i, s in enumerate(shape)
                                    if i != 1))
                             for name, (dt, shape)
                             in self.cache.leaf_shapes().items())))

    def serialize_request(self, rid: int) -> Optional[Dict[str, Any]]:
        """Snapshot one live request for adoption by another engine: the
        resolved record (prompt, delivered tokens, sampling knobs, tenant
        / priority / deadline, journal id, adapter) plus — for a request
        holding a slot — the blocks with committed KV entries, gathered
        per pool leaf into host tensors (``[L, blocks, ...]``; the copy
        completes before this returns). None for unknown, terminal or
        finished requests (their work is done; moving it would deliver it
        twice). Queued and requeued requests serialize with ``kv: None``:
        they hold no KV, so adoption is a plain resubmit of the record."""
        with self._lock:
            req = self._sched.find(rid)
            if req is None or req.terminal or req.finished:
                return None
            payload: Dict[str, Any] = {
                "prompt": np.array(req.prompt, np.int32),
                "tokens": list(req.tokens),
                "max_new_tokens": req.max_new_tokens,
                "eos_token_id": req.eos_token_id,
                "temperature": req.temperature,
                "top_k": req.top_k, "top_p": req.top_p, "seed": req.seed,
                "tenant": req.tenant, "priority": req.priority,
                "deadline": req.deadline,
                "jid": req.jid,
                "adapter_id": req.adapter_id,
                "kv": None,
            }
            if req.slot is None or not req.blocks:
                return payload
            if req.prefilling:
                entries = int(req.num_computed)
            else:
                entries = int(self._seq_lens[req.slot])
            bs = self.config.block_size
            nd = min(-(-entries // bs), len(req.blocks)) if entries else 0
            data = self.cache.read_blocks(req.blocks[:nd]) if nd else None
            payload["kv"] = {
                "entries": entries,
                "prefilling": bool(req.prefilling),
                "data_blocks": nd,
                "total_blocks": len(req.blocks),
                "data": data,
                "shape_key": self.kv_shape_key(),
            }
            return payload

    def adopt(self, payload: Dict[str, Any]) -> int:
        """Adopt a request serialized on another engine, KV included:
        allocate the chain, write the committed blocks into the pool in
        place, pin the adapter, seat the request directly in a RUNNING
        slot (mid-chunked-prefill resumes at its chunk offset; decoding
        resumes from its last token, drawing the next at the same PRNG
        index, so the stream stays bit-identical) and re-register the
        chain's prefix keys. Raises :class:`AdoptError` when the blocks
        cannot land here — no free slot, pool full, layout mismatch,
        unregistered adapter — and the caller falls back to the resubmit
        path. A ``kv: None`` payload is queued as a resubmit."""
        with self._lock:
            aid = payload.get("adapter_id")
            if aid is not None and (self._lora is None
                                    or not self._lora.is_registered(aid)):
                raise AdoptError(
                    f"adapter {aid!r} is not registered on this replica; "
                    f"falling back to resubmit")
            req = self._make_request(
                payload["prompt"], payload["max_new_tokens"],
                payload["eos_token_id"], payload["tenant"],
                payload["priority"], payload["deadline"],
                tokens=payload["tokens"],
                temperature=payload["temperature"],
                top_k=payload["top_k"], top_p=payload["top_p"],
                seed=payload["seed"], adapter_id=aid)
            if req.finished:
                raise AdoptError("request already finished; record it, "
                                 "don't migrate it")
            kv = payload.get("kv")
            if kv is None:
                rid = self._sched.submit(req, enforce_bound=False)
                self._journal_submit(req, payload.get("jid"))
                return rid
            if tuple(kv["shape_key"]) != self.kv_shape_key():
                raise AdoptError("KV layout mismatch (block size / "
                                 "kv_quant / TP shape differ); falling "
                                 "back to resubmit")
            if req.kv_tokens > self.cache.max_model_len:
                raise AdoptError("chain exceeds this engine's "
                                 "max_model_len")
            free = [m for m, r in enumerate(self._sched.slots) if r is None]
            if not free:
                raise AdoptError("no free decode slot")
            total = int(kv["total_blocks"])
            if total > self.cache.blocks_per_seq:
                raise AdoptError("chain longer than the block table")
            if not self.cache.manager.can_alloc(total):
                raise AdoptError("pool full")
            blocks = self.cache.manager.alloc(total)
            nd = int(kv["data_blocks"])
            try:
                if nd:
                    self.cache.write_blocks(blocks[:nd], kv["data"])
            except Exception as e:
                self.cache.manager.free(blocks)
                raise AdoptError(f"KV restore failed: {e}") from e
            if req.adapter_id is not None:
                # pin the adapter resident BEFORE seating: a fully pinned
                # pool refuses the migration (recompute elsewhere beats
                # evicting someone's in-flight weights)
                aslot = self._lora.acquire(req.adapter_id)
                if aslot is None:
                    self.cache.manager.free(blocks)
                    raise AdoptError(
                        f"adapter pool fully pinned; cannot seat adapter "
                        f"{req.adapter_id!r} — falling back to resubmit")
                req.adapter_slot = aslot
            slot = free[0]
            self._clear_slot(slot)
            self._sched.adopt_running(req, slot, blocks)
            if req.adapter_id is not None:
                self._lora_pinned[req.rid] = req.adapter_id
            self.cache.assign(slot, blocks)
            entries = int(kv["entries"])
            if kv["prefilling"]:
                # resume the chunked prefill at its chunk offset: the
                # next step's prefill pass picks the slot up
                req.prefill_ids = req.build_prefill_ids()
                req.num_computed = entries
            else:
                req.prefill_ids = None
                self._start_decode(req)
            # the chained content keys are a pure function of the token
            # ids, so the adopted blocks register under the origin's keys
            req.reg_state = self.cache.register_prefix(
                req.build_prefill_ids(), blocks, entries,
                tenant=req.tenant, namespace=req.adapter_id)
            self._journal_submit(req, payload.get("jid"))
            return req.rid

    # ---- fleet-wide cache pulls --------------------------------------------

    def export_chain(self, chain) -> Optional[Dict[str, Any]]:
        """Serialize the longest CONTIGUOUS prefix of ``chain`` — ``(key,
        tokens)`` pairs in :func:`~.paged_cache.prefix_block_chain` order
        — that this engine holds: device blocks copy to host through
        :meth:`PagedKVCache.read_block`, host-tier blocks come from a
        verified :meth:`HostOffloadTier.peek` and are COPIED (the tier's
        buffers stay the tier's). Each block's leaves carry a CRC32 of
        their raw bytes, so :meth:`graft_chain` detects corruption in
        flight and degrades to recompute. Refcounts, registrations and
        tier entries here are untouched. None when not even the first key
        resolves (a stale directory entry)."""
        with self._lock:
            blocks: List[Dict[str, Any]] = []
            for key, toks in chain:
                toks = tuple(int(t) for t in toks)
                data = None
                b = self.cache.manager.lookup(key, toks)
                if b is not None:
                    data = self.cache.read_block(b).wait()
                elif self.cache.offload is not None:
                    hit = self.cache.offload.peek(key, toks)
                    if hit is not None:
                        data = {name: _host_copy(t)
                                for name, t in hit.items()}
                if data is None:
                    break                 # contiguity ends at first miss
                blocks.append({"key": int(key), "tokens": toks,
                               "data": data,
                               "crc": {n: _block_crc(a)
                                       for n, a in data.items()}})
            if not blocks:
                return None
            if self._corrupt_next_export:
                # fault drill: flip one raw byte AFTER the checksums
                self._corrupt_next_export = False
                leaf = sorted(blocks[0]["data"])[0]
                t = _host_copy(blocks[0]["data"][leaf])
                t.reshape(-1).view(torch.uint8)[0] ^= 0xFF
                blocks[0]["data"][leaf] = t
            return {"blocks": blocks, "shape_key": self.kv_shape_key()}

    def graft_chain(self, payload: Dict[str, Any]) -> Dict[str, int]:
        """Graft an exported chain into this engine's prefix cache: verify
        each block's checksums, allocate a block, write the bytes and
        register the chain key, then release it refcount-0 to the
        evictable list like a locally computed cached block, where the
        next ``admit()`` hits it. Walks in chain order: an already-present
        key is skipped (first writer won here); the walk STOPS at the
        first checksum mismatch (the rest of the chain is downstream of
        corrupt KV) or when the pool runs dry. Returns ``{"grafted",
        "present", "corrupt"}``."""
        counts = {"grafted": 0, "present": 0, "corrupt": 0}
        if payload is None:
            return counts
        with self._lock:
            if tuple(payload["shape_key"]) != self.kv_shape_key():
                raise AdoptError("KV layout mismatch (block size / "
                                 "kv_quant / TP shape differ); pull "
                                 "falls back to recompute")
            for ent in payload["blocks"]:
                key, toks = int(ent["key"]), tuple(ent["tokens"])
                if self.cache.manager._hash2block.get(key) is not None:
                    counts["present"] += 1
                    continue              # first writer won locally
                if any(_block_crc(a) != ent["crc"][n]
                       for n, a in ent["data"].items()):
                    counts["corrupt"] += 1
                    break
                if not self.cache.manager.can_alloc(1):
                    break                 # pool pressure: partial graft
                [b] = self.cache.manager.alloc(1)
                self.cache.write_block(b, ent["data"])
                self.cache.manager.register(key, b, toks)
                # release to the evictable list: cached, shareable and
                # reclaimable under pressure — never a leak at quiesce
                self.cache.manager.free([b])
                counts["grafted"] += 1
            return counts

    # ---- multi-adapter LoRA ------------------------------------------------

    def register_adapter(self, name: str, adapter_params) -> None:
        """Accept one LoRA adapter (host-side checksummed copy; its rank
        must be ``lora_rank``) so requests may select it via
        ``submit(adapter_id=name)``. Re-registering an unpinned adapter
        replaces its weights; a pinned one refuses."""
        with self._lock:
            if self._lora is None:
                raise ValueError(
                    "multi-adapter serving is off: set ServingConfig."
                    "lora_slots / FLAGS_serving_lora_slots > 0")
            self._lora.register(name, adapter_params)

    def adapter_registered(self, name: str) -> bool:
        with self._lock:
            return self._lora is not None and \
                self._lora.is_registered(name)

    def adapter_resident(self, name: str) -> bool:
        """Whether ``name`` is loaded in the device pool right now."""
        with self._lock:
            return self._lora is not None and \
                self._lora.slot_of(name) is not None

    def adapter_partition(self) -> Optional[Dict[str, Any]]:
        """A consistent view of the adapter pool under the engine lock:
        registered, resident, evicted, pinned, and each running adapter
        request's (adapter, slot). None with multi-adapter serving off."""
        with self._lock:
            if self._lora is None:
                return None
            running = {r.rid: (r.adapter_id, int(r.adapter_slot))
                       for r in self._sched.live
                       if r.adapter_id is not None}
            return {"registered": self._lora.registered(),
                    "resident": self._lora.resident(),
                    "evicted": self._lora.evicted(),
                    "pinned": self._lora.pinned(),
                    "running": running}

    def _lora_gate(self, req: Request) -> bool:
        """The scheduler's admission gate: pin the pick's adapter resident
        (loading it over the LRU unpinned victim when cold) and stamp its
        pool slot on the request. False (skip this pick) when every slot
        is pinned by other running requests. Idempotent per request: a
        pick that pinned but then waited for blocks, or was preempted,
        keeps its pin and slot."""
        if req.adapter_id is None:
            req.adapter_slot = 0
            return True
        if req.rid in self._lora_pinned:
            return True
        slot = self._lora.acquire(req.adapter_id)
        if slot is None:
            return False
        self._lora_pinned[req.rid] = req.adapter_id
        req.adapter_slot = slot
        return True

    def _lora_release(self, req: Request) -> None:
        """Drop a terminal request's adapter pin (the adapter stays
        resident until the LRU needs its slot)."""
        if self._lora is None:
            return
        name = self._lora_pinned.pop(req.rid, None)
        if name is not None:
            self._lora.release(name)

    def _lora_sweep(self) -> None:
        """Release the pins of requests the retire sweep finished."""
        if self._lora is None or not self._lora_pinned:
            return
        fin = self._sched.finished
        for rid in [r for r in self._lora_pinned if r in fin]:
            self._lora.release(self._lora_pinned.pop(rid))

    def cancel(self, rid: int) -> bool:
        """Cancel a queued or running request, freeing its KV blocks at
        once. True when it was live and is now ``cancelled``; False when
        it already reached a terminal state (idempotent)."""
        with self._lock:
            req = self._sched.find(rid)
            if req is None or self._retire_if_finished(req):
                return False
            self._terminate(req, CANCELLED)
            self._journal_flush()
            return True

    def cancel_all(self) -> int:
        """Cancel every queued and running request; returns how many."""
        with self._lock:
            n = 0
            for req in list(self._sched.queue) + self._sched.live:
                if self._retire_if_finished(req):
                    continue
                self._terminate(req, CANCELLED)
                n += 1
            if n:
                self._journal_flush()
            return n

    def _retire_if_finished(self, req: Request) -> bool:
        """A request can sit FINISHED in its slot until the next retire
        sweep; a cancel or deadline racing that sweep retires it as the
        completed work it is."""
        if req.slot is None or not req.finished:
            return False
        m = req.slot
        self._sched.finish(req)
        self._clear_slot(m)
        self._lora_release(req)
        self._journal_end(req)
        return True

    def _clear_slot(self, m: int) -> None:
        self._tokens[m] = 0
        self._seq_lens[m] = 0
        self._steps_left[m] = 0
        self._done[m] = True
        self._eos[m] = -1
        self._temp[m] = 0.0
        self._topk[m] = 0
        self._topp[m] = 1.0
        self._keys[m] = 0
        self._adapters[m] = 0

    def _terminate(self, req: Request, state: str) -> None:
        m = req.slot
        self._sched.terminate(req, state)
        if m is not None:
            self._clear_slot(m)
        self._lora_release(req)
        self._journal_end(req)

    def _expire_deadlines(self, now: float) -> None:
        """Queued requests past their deadline are SHED (TIMED_OUT when
        they already ran); running ones TIME OUT mid-flight."""
        if not self._sched.deadline_requests:
            return
        for req in [r for r in self._sched.queue
                    if r.deadline is not None and r.deadline < now]:
            self._terminate(req,
                            SHED if not (req.preemptions or req.tokens)
                            else TIMED_OUT)
        for req in [r for r in self._sched.live
                    if r.deadline is not None and r.deadline < now
                    and not r.finished]:
            self._terminate(req, TIMED_OUT)

    def _chain_ids(self, req: Request, start: int, stop: int) -> np.ndarray:
        """Token ids backing the KV entries ``[start, stop)`` of a running
        request (prompt, then generated tokens)."""
        pl = len(req.prompt)
        if stop <= pl:
            return req.prompt[start:stop]
        gen = np.asarray(req.tokens[max(0, start - pl):stop - pl], np.int32)
        if start >= pl:
            return gen
        return np.concatenate([req.prompt[start:], gen])

    def _start_decode(self, req: Request) -> None:
        """Move a request whose prefill just completed into the decode slot
        arrays (fresh requests carry their first token already; readmitted
        ones resume from their last token, and draw the next at index
        ``len(req.tokens)`` as every decoding request does)."""
        m = req.slot
        self._tokens[m] = req.tokens[-1]
        self._seq_lens[m] = req.prompt_len + len(req.tokens) - 1
        self._steps_left[m] = req.max_new_tokens - len(req.tokens)
        self._done[m] = False
        self._eos[m] = -1 if req.eos_token_id is None else req.eos_token_id
        (self._keys[m], self._temp[m], self._topk[m],
         self._topp[m]) = self._knobs(req)
        self._adapters[m] = req.adapter_slot

    @staticmethod
    def _knobs(req: Request):
        """A request's slot-table sampling values: (base key, temperature,
        top_k with 0 = off, top_p with 1.0 = off)."""
        return (G.seed_key(req.seed).numpy(), req.temperature,
                req.top_k if req.top_k is not None else 0,
                req.top_p if req.top_p is not None else 1.0)

    def _emit_first(self, req: Request, tok0: int, now: float,
                    emitted: Dict[int, List[int]]) -> None:
        req.first_token_t = now
        req.tokens.append(tok0)
        emitted.setdefault(req.rid, []).append(tok0)
        if req.eos_token_id is not None and tok0 == req.eos_token_id:
            req.eos_seen = True
        if req.finished:
            self._sched.finish(req)
        else:
            self._start_decode(req)

    def _register_decoded(self, req: Request) -> None:
        """Register the prefix blocks a decode commit just filled (the
        chain build is skipped unless a block actually filled)."""
        bs = self.config.block_size
        sl = int(self._seq_lens[req.slot])
        base = req.reg_state[0] * bs
        if self.config.prefix_cache and sl // bs > req.reg_state[0]:
            req.reg_state = self.cache.register_prefix(
                self._chain_ids(req, base, sl), req.blocks, sl,
                req.reg_state, base=base, tenant=req.tenant,
                namespace=req.adapter_id)

    # ---- prefill ----------------------------------------------------------

    def _admit(self, emitted: Dict[int, List[int]]) -> None:
        """Admit what fits, then run the BATCHED bucketed prefill over the
        cold short prompts (one dispatch per power-of-2 length bucket,
        batch padded to the power-of-2 bucket of the group); prefix hits,
        long prompts and readmissions advance through the chunk path."""
        self._admit_embeds()
        gate = self._lora_gate if self._lora is not None else None
        admitted: List[Request] = []
        while (req := self._sched.next_admission(gate=gate)) is not None:
            admitted.append(req)
        if not admitted:
            return
        chunk = self.config.prefill_chunk
        fast = [r for r in admitted
                if r.num_computed == 0 and not r.tokens
                and (chunk is None or r.prompt_len <= chunk)]
        M = self.config.max_slots
        by_bucket: Dict[int, List[Request]] = {}
        for req in fast:
            by_bucket.setdefault(self._bucket(req.prompt_len), []).append(req)
        for Sb, group in sorted(by_bucket.items()):
            self._prefill_buckets.add(Sb)
            Bb = 1
            while Bb < len(group):
                Bb *= 2
            Bb = min(Bb, M)
            ids = np.zeros((Bb, Sb), np.int32)
            plens = np.ones((Bb,), np.int32)      # pad rows: harmless len 1
            tables = np.zeros((Bb, self.cache.blocks_per_seq), np.int32)
            act = np.zeros((Bb,), bool)
            aids = np.zeros((Bb,), np.int32)      # pad rows: base adapter
            for r, req in enumerate(group):
                ids[r, :req.prompt_len] = req.prompt
                plens[r] = req.prompt_len
                tables[r] = self.cache.tables[req.slot]
                act[r] = True
                aids[r] = req.adapter_slot
            t0 = time.time()
            with _watchdog.section("serving.prefill"):
                logits, self.cache.pool, _ = G.paged_prefill(
                    self._params, self._cfg, self._t(ids), self._t(plens),
                    self._t(tables), self.cache.pool, self._t(act),
                    lora=self._lora_operand(aids))
                first = self._first_tokens(logits, group, Bb)
            self._record_dispatch("prefill", t0)
            now = time.time()
            for r, req in enumerate(group):
                req.num_computed = req.prompt_len
                req.reg_state = self.cache.register_prefix(
                    req.prompt, req.blocks, req.prompt_len, req.reg_state,
                    tenant=req.tenant, namespace=req.adapter_id)
                self._emit_first(req, int(first[r]), now, emitted)

    def _admit_embeds(self) -> None:
        """Drain every queued embedding request through the batched
        encoder: one :func:`bert_encode` dispatch per power-of-2 ``(batch,
        length)`` bucket, the batched-prefill shape discipline. The whole
        batch admits, encodes and FINISHES inside this locked step."""
        if self._embed_params is None:
            return
        group = self._sched.admit_embeds()
        if not group:
            return
        by_bucket: Dict[int, List[Request]] = {}
        for req in group:
            by_bucket.setdefault(self._bucket(req.prompt_len),
                                 []).append(req)
        for Sb, grp in sorted(by_bucket.items()):
            Bb = 1
            while Bb < len(grp):
                Bb *= 2
            ids = np.zeros((Bb, Sb), np.int32)
            lens = np.zeros((Bb,), np.int32)      # pad rows: length 0
            for r, req in enumerate(grp):
                ids[r, :req.prompt_len] = req.prompt
                lens[r] = req.prompt_len
            t0 = time.time()
            with _watchdog.section("serving.prefill"):
                pooled = bert_encode(self._embed_params, self._embed_cfg,
                                     self._t(ids), self._t(lens)
                                     ).cpu().numpy()
            self._record_dispatch("prefill", t0)
            now = time.time()
            for r, req in enumerate(grp):
                req.embedding = pooled[r]
                req.first_token_t = now
                self._stats["embeds"] += 1
                self._sched.finish(req)

    @staticmethod
    def _argmax(logits: torch.Tensor) -> np.ndarray:
        """Greedy tokens on the host (first index among ties, as
        ``np.argmax`` and ``jnp.argmax``)."""
        return logits.argmax(dim=-1).to(torch.int32).cpu().numpy()

    def _sample_index(self, decoding: List[Request]) -> np.ndarray:
        """``[M]`` sample indices of the next token: ``len(req.tokens)``
        on each decoding request's slot, 0 elsewhere."""
        idx = np.zeros((self.config.max_slots,), np.int64)
        for req in decoding:
            idx[req.slot] = len(req.tokens)
        return idx

    @staticmethod
    def _row_keys(keys: np.ndarray, idx: np.ndarray) -> torch.Tensor:
        """Per-row PRNG keys folded to their sample indices, on the host:
        ``keys [M, 2]`` base keys, ``idx [M]`` or ``[M, Q]`` indices ->
        ``[M, 2]`` or ``[M, Q, 2]`` int64 CPU keys."""
        k = torch.from_numpy(keys)
        idx = torch.from_numpy(np.asarray(idx, np.int64))
        return prng.fold_in(k if idx.dim() == 1 else k[:, None], idx)

    def _sample(self, logits: torch.Tensor, keys: torch.Tensor, temp,
                topk, topp) -> np.ndarray:
        """Tokens of ``logits [B, V]`` on the host through the per-row
        sampler (``keys [B, 2]`` already folded to each row's index)."""
        return G.sample_tokens(
            logits, keys, self._t(np.asarray(temp, np.float32)),
            self._t(np.asarray(topk, np.int32)),
            self._t(np.asarray(topp, np.float32))).cpu().numpy()

    def _first_tokens(self, logits: torch.Tensor, group: List[Request],
                      Bb: int) -> np.ndarray:
        """Each admitted request's FIRST token (sample index 0) from its
        prefill logits: the literal argmax for an all-greedy wave, else
        the per-row sampler (greedy rows inside it still argmax)."""
        if all(r.temperature == 0.0 for r in group):
            return self._argmax(logits)
        keys = np.zeros((Bb, 2), np.int64)
        temp = np.zeros((Bb,), np.float32)
        topk = np.zeros((Bb,), np.int32)
        topp = np.ones((Bb,), np.float32)
        for r, req in enumerate(group):
            keys[r], temp[r], topk[r], topp[r] = self._knobs(req)
        return self._sample(logits, self._row_keys(keys, np.zeros(Bb)),
                            temp, topk, topp)

    def _advance_prefills(self, emitted: Dict[int, List[int]]) -> None:
        """The two-phase path: one B=1 prefill chunk per mid-prefill slot,
        before the decode dispatch."""
        chunk = self.config.prefill_chunk
        for req in [r for r in self._sched.live if r.prefilling]:
            total = len(req.prefill_ids)
            n = total - req.num_computed
            if chunk is not None:
                n = min(n, chunk)
            Sb = self._bucket(n)
            ids = np.zeros((1, Sb), np.int32)
            ids[0, :n] = req.prefill_ids[req.num_computed:
                                         req.num_computed + n]
            t0 = time.time()
            with _watchdog.section("serving.prefill"):
                logits, self.cache.pool, _ = G.paged_prefill_chunk(
                    self._params, self._cfg, self._t(ids), req.num_computed,
                    n, self._t(self.cache.tables[req.slot][None]),
                    self.cache.pool,
                    lora=self._lora_operand([req.adapter_slot]))
            self._record_dispatch("prefill", t0)
            req.num_computed += n
            req.reg_state = self.cache.register_prefix(
                req.prefill_ids, req.blocks, req.num_computed,
                req.reg_state, tenant=req.tenant, namespace=req.adapter_id)
            if req.prefilling:
                continue                          # more chunks to go
            if req.tokens:                        # readmission: resume
                self._start_decode(req)
            else:
                tok0 = int(self._first_tokens(logits, [req], 1)[0])
                self._emit_first(req, tok0, time.time(), emitted)

    # ---- decode dispatch sizing -------------------------------------------

    def _limit(self, decoding, max_iters: Optional[int]) -> int:
        """Iterations for the next decode dispatch: to the FIRST budget
        retirement while work waits, the whole tail otherwise; capped at
        ``decode_chunk`` while a prompt is mid-prefill, a row can retire
        early on EOS, or the caller streams."""
        sl = [int(self._steps_left[r.slot]) for r in decoding]
        prefilling = any(r.prefilling for r in self._sched.live)
        waiting = bool(self._sched.queue) or prefilling
        n = min(sl) if waiting else max(sl)
        if prefilling or (max_iters is None and
                          any(r.eos_token_id is not None
                              for r in decoding)):
            max_iters = min(max_iters or self.config.decode_chunk,
                            self.config.decode_chunk)
        if max_iters is not None:
            n = min(n, int(max_iters))
        return max(1, min(n, self._out_width))

    def _ensure_blocks(self, want: int) -> int:
        """Make the pool cover ``want`` decode iterations for every
        decoding slot; returns the feasible iteration count, preempting the
        newest-admitted request whenever even one iteration does not fit
        (a sole survivor that still cannot get a block is truncated)."""
        bf = self.cache.manager.blocks_for

        while True:
            decoding = self._sched.decoding
            if not decoding:
                return 0

            def need(k: int) -> int:
                tot = 0
                for r in decoding:
                    e = int(self._seq_lens[r.slot]) + \
                        min(k, int(self._steps_left[r.slot]))
                    tot += max(0, bf(e) - len(r.blocks))
                return tot

            avail = self.cache.free_blocks
            if need(1) <= avail:
                lo, hi = 1, max(1, want)
                while lo < hi:                    # largest feasible k
                    mid = (lo + hi + 1) // 2
                    if need(mid) <= avail:
                        lo = mid
                    else:
                        hi = mid - 1
                for r in decoding:
                    e = int(self._seq_lens[r.slot]) + \
                        min(lo, int(self._steps_left[r.slot]))
                    if self.cache.extend(r.slot, r.blocks, e) is None:
                        break                     # raced an estimate; retry
                else:
                    return lo
                continue
            if not self._relieve_pressure(decoding):
                return 0

    def _relieve_pressure(self, decoding: List[Request]) -> bool:
        """Preempt the newest-admitted live request and return True, or —
        with nothing left to preempt — truncate the sole survivor and
        return False."""
        victim = self._sched.preempt_victim()
        if victim is not None:
            self._preempt(victim)
            return True
        r = decoding[0]
        r.oom_truncated = True
        self._sched.oom_truncated += 1
        self._done[r.slot] = True
        return False

    def _preempt(self, req: Request) -> None:
        m = req.slot
        self._sched.preempt(req)
        self._clear_slot(m)

    # ---- speculative decoding ---------------------------------------------

    def _ctx_at(self, req: Request, i: int) -> int:
        """Token backing context position ``i`` (prompt, then generated)."""
        pl = req.prompt_len
        return int(req.prompt[i]) if i < pl else int(req.tokens[i - pl])

    def _draft_tokens(self, req: Request) -> List[int]:
        """n-gram prompt-lookup drafting: when the last ``spec_ngram``
        tokens of the request's context reoccur earlier, propose the
        continuation of the most recent PRIOR occurrence, preferring one
        with a full ``spec_decode`` window of continuation. At most
        ``steps_left - 1`` tokens (the verify emits ``accepted + 1``).
        An incremental n-gram presence index makes a miss cost O(ngram);
        the O(context) scan runs only when a draft will be proposed.
        Returns [] when nothing matches."""
        k = min(self._spec_k, int(self._steps_left[req.slot]) - 1)
        if k < 1:
            return []
        n = self._spec_n
        L = req.prompt_len + len(req.tokens)
        if L <= n:
            return []
        st = req.spec_index
        if st is None:
            st = req.spec_index = {"end": n - 1, "seen": set()}
        # index every n-gram ENDING at positions (end, L-1]
        for e in range(st["end"] + 1, L):
            st["seen"].add(tuple(self._ctx_at(req, e - n + j)
                                 for j in range(n)))
        st["end"] = L - 1
        tail = tuple(self._ctx_at(req, L - n + j) for j in range(n))
        if tail not in st["seen"]:
            return []
        ctx = np.concatenate([req.prompt, np.asarray(req.tokens, np.int32)])
        win = np.lib.stride_tricks.sliding_window_view(ctx[:-1], n)
        hits = np.nonzero((win == ctx[-n:]).all(axis=1))[0]
        # the most recent occurrence with k tokens of continuation inside
        # the context, else the most recent one at all
        full = hits[hits + n + k <= len(ctx)]
        j = int(full[-1]) if full.size else int(hits[-1])
        return [int(t) for t in ctx[j + n:j + n + k]]

    def _ensure_blocks_spec(self, drafts: Dict[int, List[int]]
                            ) -> List[Request]:
        """Blocks for one verify: every decoding slot needs ``seq_len +
        draft_len + 1`` KV entries. When the pool cannot cover the drafts
        they are DROPPED (the step falls through to the decode loop)
        before any preemption; then the shared preempt/truncate ladder.
        Returns the decoding set (empty = nothing to do)."""
        bf = self.cache.manager.blocks_for

        while True:
            decoding = self._sched.decoding
            if not decoding:
                return []

            def need(with_drafts: bool) -> int:
                tot = 0
                for r in decoding:
                    dl = len(drafts.get(r.rid, ())) if with_drafts else 0
                    e = int(self._seq_lens[r.slot]) + dl + 1
                    tot += max(0, bf(e) - len(r.blocks))
                return tot

            avail = self.cache.free_blocks
            if need(True) <= avail:
                with_drafts = True
            elif need(False) <= avail:
                with_drafts = False
                drafts.clear()         # pool-pressure fallback: no drafts
            elif self._relieve_pressure(decoding):
                continue
            else:
                return []
            for r in decoding:
                dl = len(drafts.get(r.rid, ())) if with_drafts else 0
                e = int(self._seq_lens[r.slot]) + dl + 1
                if self.cache.extend(r.slot, r.blocks, e) is None:
                    break                     # raced an estimate; retry
            else:
                return decoding

    def _rollback_blocks(self, req: Request) -> None:
        """Free the blocks past ``blocks_for(seq_len)`` that a verify's
        rejected tail left behind (never a registered one: registration
        stops at the last committed full block). Stale entries inside the
        kept tail block are overwritten by the next write at ``seq_len``
        or hidden by the ``j <= seq_len`` mask."""
        keep = self.cache.manager.blocks_for(int(self._seq_lens[req.slot]))
        tail = req.blocks[keep:]
        if not tail:
            return
        self.cache.manager.free(tail)
        del req.blocks[keep:]
        self.cache.tables[req.slot, keep:] = 0

    def _spec_dispatch(self, decoding: List[Request],
                       drafts: Dict[int, List[int]],
                       emitted: Dict[int, List[int]]) -> None:
        """One speculative verify: the ``[M, Q]`` token matrix (last token
        + drafts, pad lanes repeat the last token) through
        ``paged_spec_step``; position ``q`` of a row is drawn with the key
        of index ``len(req.tokens) + q``. Commits ``accepted + 1`` tokens per
        slot (EOS truncates), registers filled prefix blocks and rolls the
        rejected tail's blocks back."""
        Q = self._spec_k + 1
        M = self.config.max_slots
        toks = np.zeros((M, Q), np.int32)
        dl = np.zeros((M,), np.int32)
        for req in decoding:
            m = req.slot
            d = drafts.get(req.rid, [])
            toks[m, 0] = self._tokens[m]
            toks[m, 1:1 + len(d)] = d
            toks[m, 1 + len(d):] = self._tokens[m]   # pad: a real token
            dl[m] = len(d)
        active = (~self._done) & (self._steps_left > 0)
        t0 = time.time()
        with _watchdog.section("serving.decode"):
            logits, self.cache.pool, _ = G.paged_spec_step(
                self._params, self._cfg, self._t(toks),
                self._t(self._seq_lens), self._t(dl),
                self._t(self.cache.tables), self.cache.pool,
                self._t(active), use_kernel=self._use_kernel,
                lora=self._lora_operand(self._adapters))
            V = logits.shape[-1]
            if (self._temp[active] > 0).any():
                idx = self._sample_index(decoding)[:, None] + np.arange(Q)
                keys = self._row_keys(self._keys, idx)
                cand = self._sample(logits.reshape(M * Q, V),
                                    keys.reshape(M * Q, 2),
                                    np.repeat(self._temp, Q),
                                    np.repeat(self._topk, Q),
                                    np.repeat(self._topp, Q)).reshape(M, Q)
            else:
                cand = self._argmax(logits)
        self._record_dispatch("spec", t0)
        # accepted = the leading run of drafts the chain reproduces
        # (cand[q] is the token after tokens[:q+1], checked against draft
        # tokens[q+1])
        ok = (cand[:, :-1] == toks[:, 1:]) & \
            (np.arange(Q - 1)[None, :] < dl[:, None])
        acc = np.cumprod(ok, axis=1).sum(axis=1)
        for req in decoding:
            m = req.slot
            if self._done[m] or self._steps_left[m] <= 0:
                continue
            got = [int(t) for t in cand[m, :int(acc[m]) + 1]]
            eos = req.eos_token_id
            if eos is not None and eos in got:
                got = got[:got.index(eos) + 1]
                self._done[m] = True
                req.eos_seen = True
            e = len(got)
            req.tokens.extend(got)
            emitted.setdefault(req.rid, []).extend(got)
            req.spec_drafted += int(dl[m])
            req.spec_accepted += e - 1
            self._sched.spec_drafted += int(dl[m])
            self._sched.spec_accepted += e - 1
            self._tokens[m] = got[-1]
            self._seq_lens[m] += e
            self._steps_left[m] -= e
            self._register_decoded(req)
            if not req.finished:
                self._rollback_blocks(req)
        self._stats["spec_steps"] += 1

    # ---- dispatches ---------------------------------------------------------

    def _decode_burst(self, limit: int):
        """Up to ``limit`` decode iterations over every slot, stopping once
        no row is live — the JAX engine's ``lax.while_loop`` as a host
        loop. Returns (tokens, seq_lens, steps_left, done, out[M, limit])."""
        tokens = self._tokens.copy()
        seq_lens = self._seq_lens.copy()
        steps_left = self._steps_left.copy()
        done = self._done.copy()
        out = np.zeros((self.config.max_slots, limit), np.int32)
        tables = self._t(self.cache.tables)
        lora = self._lora_operand(self._adapters)
        # a row live at iteration i was live at every earlier one, so its
        # sample index there is len(req.tokens) + i: fold every iteration's
        # keys at once, and only when a live row samples
        active = (~done) & (steps_left > 0)
        sampled = bool((self._temp[active] > 0).any())
        if sampled:
            keys = self._row_keys(self._keys,
                                  self._sample_index(self._sched.decoding)
                                  [:, None] + np.arange(limit)
                                  ).to(self.device)
            knobs = (self._t(self._temp), self._t(self._topk),
                     self._t(self._topp))
        i = 0
        while i < limit:
            active = (~done) & (steps_left > 0)
            if not active.any():
                break
            logits, self.cache.pool, _ = G.paged_decode_step(
                self._params, self._cfg, self._t(tokens), self._t(seq_lens),
                tables, self.cache.pool, self._t(active),
                use_kernel=self._use_kernel, lora=lora)
            nxt = (G.sample_tokens(logits, keys[:, i], *knobs).cpu().numpy()
                   if sampled else self._argmax(logits))
            nxt = np.where(active, nxt, tokens)
            done = done | (active & (nxt == self._eos))
            seq_lens = seq_lens + active
            steps_left = steps_left - active.astype(np.int32)
            out[:, i] = nxt
            tokens = nxt
            i += 1
        self._stats["decode_iters"] += i
        return tokens, seq_lens, steps_left, done, out

    def _mixed_dispatch(self, prefills: List[Request],
                        include_decode: bool,
                        emitted: Dict[int, List[int]]) -> None:
        """ONE mixed prefill+decode dispatch: every mid-prefill slot adds
        its next chunk as a ``q_len > 1`` row, every decoding slot a
        ``q_len == 1`` row that takes its next token. A chunk that
        completes its prompt yields the first token in this dispatch."""
        chunk = self.config.prefill_chunk
        M = self.config.max_slots
        decode_rows = [r for r in self._sched.decoding
                       if include_decode and not self._done[r.slot]
                       and self._steps_left[r.slot] > 0]
        plan: List[Tuple[Request, int]] = []
        qmax = 1
        for req in prefills:
            n = len(req.prefill_ids) - req.num_computed
            if chunk is not None:
                n = min(n, chunk)
            plan.append((req, n))
            qmax = max(qmax, n)
        Q = self._bucket(qmax)
        toks = np.zeros((M, Q), np.int32)
        starts = np.zeros((M,), np.int32)
        qlens = np.ones((M,), np.int32)           # pad rows: harmless q=1
        active = np.zeros((M,), bool)
        keys = np.zeros((M, 2), np.int64)
        sidx = np.zeros((M,), np.int32)
        temp = np.zeros((M,), np.float32)
        topk = np.zeros((M,), np.int32)
        topp = np.ones((M,), np.float32)
        adapters = self._adapters.copy()
        for r in decode_rows:
            m = r.slot
            toks[m, :] = self._tokens[m]          # pad lanes: a real token
            starts[m] = self._seq_lens[m]
            active[m] = True
            keys[m] = self._keys[m]
            sidx[m] = len(r.tokens)
            temp[m] = self._temp[m]
            topk[m] = self._topk[m]
            topp[m] = self._topp[m]
        for req, n in plan:
            m = req.slot
            ids = req.prefill_ids[req.num_computed:req.num_computed + n]
            toks[m, :n] = ids
            toks[m, n:] = ids[-1]                 # pad lanes: a real token
            starts[m] = req.num_computed
            qlens[m] = n
            active[m] = True
            # a completing chunk's token IS the prompt's first token: the
            # same (seed, index 0) key _first_tokens uses
            keys[m], temp[m], topk[m], topp[m] = self._knobs(req)
            adapters[m] = req.adapter_slot
        t0 = time.time()
        with _watchdog.section("serving.decode"):
            logits, self.cache.pool, _ = G.paged_mixed_step(
                self._params, self._cfg, self._t(toks), self._t(starts),
                self._t(qlens), self._t(self.cache.tables), self.cache.pool,
                self._t(active), use_kernel=self._use_kernel,
                lora=self._lora_operand(adapters))
            nxt = (self._sample(logits, self._row_keys(keys, sidx), temp,
                                topk, topp)
                   if (temp > 0).any() else self._argmax(logits))
        self._record_dispatch("mixed", t0)
        now = time.time()
        for req, n in plan:                       # prefill rows first
            m = req.slot
            req.num_computed += n
            req.reg_state = self.cache.register_prefix(
                req.prefill_ids, req.blocks, req.num_computed,
                req.reg_state, tenant=req.tenant, namespace=req.adapter_id)
            if req.prefilling:
                continue
            if req.tokens:                        # readmission: resume
                self._start_decode(req)
            else:
                self._emit_first(req, int(nxt[m]), now, emitted)
        for req in decode_rows:                   # one decode iteration
            m = req.slot
            t = int(nxt[m])
            req.tokens.append(t)
            emitted.setdefault(req.rid, []).append(t)
            self._tokens[m] = t
            self._seq_lens[m] += 1
            self._steps_left[m] -= 1
            if req.eos_token_id is not None and t == req.eos_token_id:
                self._done[m] = True
                req.eos_seen = True
            self._register_decoded(req)

    # ---- the scheduler iteration ------------------------------------------

    def step(self, max_iters: Optional[int] = None) -> Dict[int, List[int]]:
        """One scheduler iteration: expire deadlines -> retire -> admit
        (+ batched prefill) -> [two-phase: advance chunked prefills] ->
        one speculative verify when any decoding slot drafts, else one
        mixed dispatch while a prompt is mid-prefill (mixed batching),
        else extend/preempt for blocks and one decode burst of up to
        ``_limit()`` iterations (``max_iters`` caps it). Returns
        ``{rid: [tokens emitted]}``. Each step ticks the global hang
        watchdog and marks the ``serving.step`` / ``serving.prefill`` /
        ``serving.decode`` sections, so a frozen dispatch is named in the
        hang diagnosis."""
        _watchdog.touch()
        with self._lock, _watchdog.section("serving.step"):
            emitted = self._step(max_iters)
            self._lora_sweep()
            self._journal_step(emitted)
            return emitted

    def _step(self, max_iters: Optional[int]) -> Dict[int, List[int]]:
        emitted: Dict[int, List[int]] = {}
        self._expire_deadlines(time.time())
        self._sched.retire_finished()
        self._admit(emitted)
        if not self.config.mixed_batch:
            self._advance_prefills(emitted)
        k = 0
        decoding = self._sched.decoding
        if decoding and self._spec_k:
            # any draft -> ONE verify dispatch this step; none (or drafts
            # dropped under pool pressure) falls through to mixed/decode,
            # which batch far more cheaply than an all-pad verify
            drafts = {r.rid: self._draft_tokens(r) for r in decoding}
            if any(drafts.values()):
                decoding = self._ensure_blocks_spec(drafts)
                if decoding and any(drafts.values()):
                    self._spec_dispatch(decoding, drafts, emitted)
                    self._sched.retire_finished()
                    self._stats["steps"] += 1
                    return emitted
            decoding = self._sched.decoding
        if self.config.mixed_batch and \
                any(r.prefilling for r in self._sched.live):
            kd = self._ensure_blocks(1) if decoding else 0
            prefills = [r for r in self._sched.live if r.prefilling]
            if prefills:
                self._mixed_dispatch(prefills, kd >= 1, emitted)
                self._sched.retire_finished()
                self._stats["steps"] += 1
                return emitted
            decoding = self._sched.decoding
        if decoding:
            want = self._limit(decoding, max_iters)
            k = self._ensure_blocks(want)
            decoding = self._sched.decoding       # preemption may shrink it
            if decoding and k >= 1:
                k = min(k, self._limit(decoding, max_iters))
        if decoding and k >= 1:
            before = self._steps_left.copy()
            t0 = time.time()
            with _watchdog.section("serving.decode"):
                (self._tokens, self._seq_lens, self._steps_left, self._done,
                 toks) = self._decode_burst(k)
            self._record_dispatch("decode", t0)
            for req in decoding:
                m = req.slot
                n = int(before[m] - self._steps_left[m])
                if n <= 0:
                    continue
                got = toks[m, :n].tolist()
                req.tokens.extend(got)
                if bool(self._done[m]):
                    req.eos_seen = True
                emitted.setdefault(req.rid, []).extend(got)
                self._register_decoded(req)
            self._sched.retire_finished()
        self._stats["steps"] += 1
        return emitted

    def stream(self) -> Iterator[Tuple[int, int]]:
        """Drain the engine, yielding ``(rid, token)`` events in emission
        order, dispatches capped at ``decode_chunk``. Closing the
        generator cancels every request still queued or running."""
        try:
            while self.pending:
                for rid, toks in sorted(
                        self.step(self.config.decode_chunk).items()):
                    for t in toks:
                        yield rid, int(t)
        except GeneratorExit:
            self.cancel_all()
            raise

    def run(self, prompts: Sequence, max_new_tokens=None,
            eos_token_id="unset") -> List[np.ndarray]:
        """Submit every prompt, drain, return outputs in submission order.
        ``max_new_tokens`` may be one int or a per-prompt sequence."""
        n = len(prompts)
        mnt = ([max_new_tokens] * n
               if max_new_tokens is None or np.isscalar(max_new_tokens)
               else list(max_new_tokens))
        if len(mnt) != n:
            raise ValueError(f"max_new_tokens has {len(mnt)} entries for "
                             f"{n} prompts")
        rids = [self.submit(p, max_new_tokens=m, eos_token_id=eos_token_id)
                for p, m in zip(prompts, mnt)]
        while self.pending:
            self.step()
        return [self._sched.result(r) for r in rids]

    # ---- introspection ----------------------------------------------------

    @property
    def pending(self) -> bool:
        return self._sched.pending

    def depth(self) -> int:
        """Queued + live request count under the engine lock — the load
        signal a router compares."""
        with self._lock:
            return self._sched.depth

    def request(self, rid: int) -> Request:
        """The finished request record (tokens, timestamps, counters)."""
        with self._lock:
            return self._sched.finished[rid]

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return self._stats_locked()

    def _stats_locked(self) -> Dict[str, Any]:
        s = self._sched
        tier = self.cache.offload
        return {**self._stats,
                "dispatch_s": dict(self._dispatch_s),
                "dispatch_latency": self._dispatch_latency(),
                "prefill_buckets": len(self._prefill_buckets),
                "admitted": s.admitted, "retired": s.retired,
                "cancelled": s.cancelled, "timed_out": s.timed_out,
                "shed": s.shed, "queued": len(s.queue),
                "live_slots": len(s.live),
                "max_slots": self.config.max_slots,
                "policy": self._policy.name,
                "free_blocks": self.cache.free_blocks,
                "blocks_in_use": self.cache.manager.blocks_in_use,
                "prefix_hit_tokens": s.prefix_hit_tokens,
                "preemptions": s.preemptions,
                "recomputed_tokens": s.recomputed_tokens,
                "oom_truncated": s.oom_truncated,
                "cached_blocks": self.cache.manager.cached_blocks,
                "evictions": self.cache.manager.evictions,
                "usable_blocks": self.cache.manager.num_blocks - 1,
                "kv_quant": self.config.kv_quant,
                "paged_kernel": self._use_kernel,
                "spec_decode": self.config.spec_decode,
                "spec_drafted": s.spec_drafted,
                "spec_accepted": s.spec_accepted,
                "tp_degree": self.config.tp,
                "kv_pool_bytes": self.cache.kv_bytes(),
                "kv_pool_shard_bytes": self.cache.kv_bytes(per_shard=True),
                "offload": tier.stats() if tier is not None else None,
                "lora": (self._lora.stats()
                         if self._lora is not None else None),
                "device": str(self.device)}

    def health_snapshot(self) -> Dict[str, Any]:
        """One JSON-serializable health/ops record: readiness, capacity
        headroom, lifecycle/shed counters, the offload tier, the adapter
        pool, hang-watchdog state and per-tenant breakdowns — the keys of
        the reference's payload (:data:`HEALTH_SNAPSHOT_KEYS` minus
        :data:`SUPERVISOR_SNAPSHOT_KEYS`). ``ok`` goes False only when the
        installed hang watchdog has fired. Built under the engine lock."""
        with self._lock:
            return self._health_snapshot_locked()

    def block_partition(self) -> Dict[str, int]:
        """A consistent view of the pool partition under the engine lock:
        free + evictable + in_use == usable. With the offload tier,
        ``host`` / ``host_capacity`` report its side (a key is
        device-resident XOR host-resident)."""
        with self._lock:
            bm = self.cache.manager
            tier = self.cache.offload
            return {"free": len(bm._free),
                    "evictable": len(bm._evictable),
                    "in_use": bm.blocks_in_use,
                    "usable": bm.num_blocks - 1,
                    "host": tier.blocks if tier is not None else 0,
                    "host_capacity": tier.capacity
                    if tier is not None else 0}

    def _health_snapshot_locked(self) -> Dict[str, Any]:
        sched = self._sched
        wd = _watchdog.current()

        def pct(xs, q):
            return (round(float(np.percentile(np.asarray(xs), q)), 4)
                    if xs else None)

        occupancy = sched.by_tenant()
        tenants = {}
        for name, t in sched.tenants.items():
            ttfts = list(t["ttfts"])
            tpots = list(t["tpots"])
            tenants[name] = {
                "queued": occupancy[name]["queued"],
                "live": occupancy[name]["live"],
                "submitted": t["submitted"], "admitted": t["admitted"],
                "retired": t["retired"], "cancelled": t["cancelled"],
                "timed_out": t["timed_out"], "shed": t["shed"],
                "service_tokens": t["service_tokens"],
                "cached_blocks": self.cache.manager.tenant_cached(name),
                "ttft_p50_s": pct(ttfts, 50), "ttft_p99_s": pct(ttfts, 99),
                "tpot_p50_s": pct(tpots, 50), "tpot_p99_s": pct(tpots, 99),
            }
        tier = self.cache.offload
        return {
            "ok": wd is None or not wd.fired.is_set(),
            "accepting": len(sched.queue) < sched.queue_depth,
            "policy": self._policy.name,
            "queued": len(sched.queue),
            "queue_limit": sched.queue_depth,
            "live_slots": len(sched.live),
            "max_slots": self.config.max_slots,
            "free_blocks": self.cache.free_blocks,
            "usable_blocks": self.cache.manager.num_blocks - 1,
            "kv_pool_bytes": self.cache.kv_bytes(),
            "tp_degree": self.config.tp,
            "kv_pool_shard_bytes": self.cache.kv_bytes(per_shard=True),
            "kv_quant": self.config.kv_quant,
            "paged_kernel": self._use_kernel,
            "spec_decode": self.config.spec_decode,
            "retry_after_s": sched.retry_after_s(),
            "counters": {
                "admitted": sched.admitted, "retired": sched.retired,
                "cancelled": sched.cancelled, "timed_out": sched.timed_out,
                "shed": sched.shed, "preemptions": sched.preemptions,
                "oom_truncated": sched.oom_truncated,
                "prefix_hit_tokens": sched.prefix_hit_tokens,
                "evictions": self.cache.manager.evictions,
            },
            "dispatch_latency": self._dispatch_latency(),
            "offload": {
                "enabled": tier is not None,
                **(tier.stats() if tier is not None else
                   {"capacity": 0, "blocks": 0, "swap_outs": 0,
                    "swap_ins": 0, "tier_hits": 0, "tier_misses": 0,
                    "corrupt_drops": 0, "tier_evictions": 0}),
            },
            "lora": {
                "enabled": self._lora is not None,
                **(self._lora.snapshot() if self._lora is not None else
                   {"rank": 0, "slots": 0, "resident": [],
                    "adapters_registered": 0, "adapters_resident": 0,
                    "adapter_loads": 0, "adapter_evictions": 0,
                    "adapter_pins": 0}),
            },
            "watchdog": {
                "installed": wd is not None,
                "fired": bool(wd.fired.is_set()) if wd is not None else False,
                "timeout_s": wd.timeout if wd is not None else None,
            },
            "tenants": tenants,
        }

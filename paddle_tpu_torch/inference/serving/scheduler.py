"""Continuous-batching scheduler — iteration-level request lifecycle.

Counterpart of ``paddle_tpu/inference/serving/scheduler.py`` (``Request``,
``Scheduler``, ``ServingQueueFull``), pure host logic: a policy-ordered
admission queue feeding a fixed table of ``max_slots`` decode slots. Every
engine step (1) RETIRES finished slots, returning their KV blocks, (2)
ADMITS queued requests while the block pool covers their prompt, and (3)
hands the engine the live slots for its dispatch. When the pool runs dry
the engine PREEMPTS the newest-admitted running sequence (its blocks
return, its tokens are kept, it re-queues at the FRONT for recompute); the
oldest is never preempted, so at least one request always progresses.

Every request ends in exactly one terminal state: ``finished`` (EOS /
budget / oom-truncated), ``cancelled``, ``timed_out`` (deadline passed
after it started) or ``shed`` (deadline passed while queued, or the
bounded queue refused the submit). Terminal transitions release every
block the request held.

Embedding requests (``kind == "embed"``) ride the same bounded queue but
need no decode slot and no KV block: :meth:`Scheduler.admit_embeds` pops
them all for the engine's batched encoder dispatch, which finishes them
inside the same step.

:meth:`Scheduler.adopt_running` seats a live-migrated request straight
into a slot, with the whole submit+admit bookkeeping done in one step.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np

from ...flags import flag
from .policies import AdmissionPolicy, FIFOPolicy

__all__ = ["Request", "Scheduler", "ServingQueueFull",
           "QUEUED", "RUNNING", "FINISHED", "CANCELLED", "TIMED_OUT",
           "SHED", "TERMINAL_STATES", "completes_by_tokens"]


def completes_by_tokens(tokens, max_new_tokens: int,
                        eos_token_id: Optional[int]) -> bool:
    """Whether an already-delivered token list alone completes a request
    (budget spent, or EOS delivered last) — the one completion test the
    supervisor's and the journal's recovery records share."""
    if len(tokens) >= max_new_tokens:
        return True
    return (eos_token_id is not None and bool(tokens)
            and tokens[-1] == eos_token_id)


QUEUED = "queued"
RUNNING = "running"
FINISHED = "finished"
CANCELLED = "cancelled"
TIMED_OUT = "timed_out"
SHED = "shed"
TERMINAL_STATES = frozenset({FINISHED, CANCELLED, TIMED_OUT, SHED})

DEFAULT_TENANT = "default"


class ServingQueueFull(RuntimeError):
    """submit() beyond the admission queue's depth bound — the engine is
    LOAD SHEDDING. Carries ``queue_depth`` (queued at refusal),
    ``live_slots`` and ``retry_after_s`` (one estimated retirement
    interval; the ``FLAGS_serving_retry_after_s`` default before two
    retirements have been observed)."""

    def __init__(self, message: str, queue_depth: Optional[int] = None,
                 live_slots: Optional[int] = None,
                 retry_after_s: Optional[float] = None):
        super().__init__(message)
        self.queue_depth = queue_depth
        self.live_slots = live_slots
        self.retry_after_s = retry_after_s


@dataclasses.dataclass
class Request:
    """One generation request and its serving-side record."""

    rid: int
    prompt: np.ndarray                 # [S] int32
    max_new_tokens: int
    eos_token_id: Optional[int] = None
    # sampling knobs, resolved at submit: temperature 0 = greedy argmax;
    # top_k/top_p None = disabled. Token t is drawn with the key
    # fold_in(seed_key(seed), t), so a stream is a function of (request,
    # seed) across preemption and speculative verify
    temperature: float = 0.0
    top_k: Optional[int] = None
    top_p: Optional[float] = None
    seed: int = 0
    tenant: str = DEFAULT_TENANT
    priority: int = 0
    deadline: Optional[float] = None   # absolute time.time()
    state: str = QUEUED
    submit_t: float = 0.0
    first_token_t: Optional[float] = None
    finish_t: Optional[float] = None
    tokens: List[int] = dataclasses.field(default_factory=list)
    eos_seen: bool = False
    blocks: Optional[List[int]] = None
    slot: Optional[int] = None
    # prefill progress: KV entries mapped-or-written so far (cache hits
    # count); the slot joins decode when it reaches len(prefill_ids)
    num_computed: int = 0
    prefill_ids: Optional[np.ndarray] = None
    admit_seq: int = -1                # admission order (newest = victim)
    # incremental prefix-registration cursor (PagedKVCache.register_prefix)
    reg_state: Tuple[int, Optional[int]] = (0, None)
    prefix_hit_tokens: int = 0
    preemptions: int = 0
    recomputed_tokens: int = 0
    spec_drafted: int = 0              # draft tokens verified for this
    spec_accepted: int = 0             # ... and how many were emitted
    # the prompt-lookup drafter's incremental n-gram presence index
    # (engine-owned): {"end": last position indexed, "seen": n-grams
    # ending there or before}; survives preemption (the context it
    # indexes never shrinks)
    spec_index: Optional[Dict] = None
    computed_hwm: int = 0              # most KV entries ever written
    oom_truncated: bool = False        # pool exhausted, retired early
    # multi-adapter LoRA: the adapter this request decodes under (None =
    # base traffic) and the device pool slot the engine's admission gate
    # pinned for it (0 = the zeroed base adapter). The pin, and with it
    # the slot, survives preemption: it is released only at a terminal
    # state
    adapter_id: Optional[str] = None
    adapter_slot: int = 0
    # the journal record this request owns (-1 = unjournaled or disowned)
    jid: int = -1
    # "embed" requests are prefill-only: they retire at encoder completion
    # with the pooled hidden states in ``embedding`` and never hold a
    # decode slot or a KV block (Scheduler.admit_embeds)
    kind: str = "generate"
    embedding: Optional[np.ndarray] = None

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])

    @property
    def kv_tokens(self) -> int:
        """Worst-case KV entries: the prompt plus every generated token's
        KV except the last sampled token's."""
        return self.prompt_len + self.max_new_tokens - 1

    @property
    def remaining(self) -> int:
        return self.max_new_tokens - len(self.tokens)

    @property
    def finished(self) -> bool:
        if self.kind == "embed":
            return self.embedding is not None
        return self.eos_seen or self.remaining <= 0 or self.oom_truncated

    @property
    def terminal(self) -> bool:
        return self.state in TERMINAL_STATES

    @property
    def prefilling(self) -> bool:
        return self.prefill_ids is not None and \
            self.num_computed < len(self.prefill_ids)

    def build_prefill_ids(self) -> np.ndarray:
        """The token ids prefill must compute KV for: the prompt, plus —
        after a preemption — every generated token but the last."""
        if self.tokens:
            return np.concatenate(
                [self.prompt, np.asarray(self.tokens[:-1], np.int32)])
        return self.prompt

    @property
    def ttft_s(self) -> Optional[float]:
        if self.first_token_t is None:
            return None
        return self.first_token_t - self.submit_t

    @property
    def tok_latency_s(self) -> Optional[float]:
        """Mean decode latency per token after the first (TPOT sample)."""
        if self.finish_t is None or self.first_token_t is None \
                or len(self.tokens) < 2:
            return None
        return (self.finish_t - self.first_token_t) / (len(self.tokens) - 1)

    def output(self) -> np.ndarray:
        return np.asarray(self.tokens, np.int32)


class Scheduler:
    """Policy-ordered admission queue + slot table over a
    :class:`~.paged_cache.PagedKVCache`. ``preempt=True`` is the on-demand
    mode; ``preempt=False`` reserves each request's worst case at
    admission."""

    MAX_TENANTS = 256
    _OVERFLOW_TENANT = "_overflow"
    TTFT_SAMPLES = 128

    def __init__(self, cache, max_slots: int, queue_depth: int,
                 preempt: bool = True,
                 policy: Optional[AdmissionPolicy] = None):
        self.cache = cache
        self.max_slots = int(max_slots)
        self.queue_depth = int(queue_depth)
        self.preempt_enabled = bool(preempt)
        self.policy = policy if policy is not None else FIFOPolicy()
        self.queue: Deque[Request] = deque()
        self.slots: List[Optional[Request]] = [None] * max_slots
        # bounded finished-record retention (oldest evicted first)
        self.finished: Dict[int, Request] = {}
        self.keep_finished = self.queue_depth + 2 * self.max_slots
        self._next_rid = 0
        self._admit_seq = 0
        self.admitted = 0
        self.retired = 0
        self.preemptions = 0
        self.prefix_hit_tokens = 0
        self.recomputed_tokens = 0
        self.oom_truncated = 0
        # speculative decoding: drafts verified vs drafts emitted
        self.spec_drafted = 0
        self.spec_accepted = 0
        self.cancelled = 0
        self.timed_out = 0
        self.shed = 0
        # live requests carrying a deadline (the engine skips the expiry
        # sweep while this is 0)
        self.deadline_requests = 0
        self._finish_times: Deque[float] = deque(maxlen=16)
        self.default_retry_after_s = float(
            flag("FLAGS_serving_retry_after_s", 1.0))
        self.tenants: Dict[str, Dict] = {}
        # absolute time an active drain completes (stamped by the
        # supervisor): while in the future, retry_after_s() reports the
        # remainder of the drain window
        self.drain_deadline: Optional[float] = None

    # ---- per-tenant accounting ---------------------------------------------

    def tenant(self, name: str) -> Dict:
        """The (lazily created) stats record for one tenant key."""
        d = self.tenants.get(name)
        if d is None:
            if len(self.tenants) >= self.MAX_TENANTS and \
                    name != self._OVERFLOW_TENANT:
                return self.tenant(self._OVERFLOW_TENANT)
            d = self.tenants[name] = {
                "submitted": 0, "admitted": 0, "retired": 0,
                "cancelled": 0, "timed_out": 0, "shed": 0,
                "service_tokens": 0,
                "ttfts": deque(maxlen=self.TTFT_SAMPLES),
                "tpots": deque(maxlen=self.TTFT_SAMPLES),
            }
        return d

    @property
    def prefill_queue_depth(self) -> int:
        """Requests still ahead of their first token: queued plus live
        slots mid-prefill."""
        return len(self.queue) + sum(1 for r in self.live if r.prefilling)

    def retry_after_s(self) -> float:
        """Suggested backoff when shedding: the mean interval between
        recent retirements scaled by the prefill backlog, or the
        conservative flag default before two retirements exist. During
        an active drain it is the drain deadline's remainder: this replica
        is leaving."""
        if self.drain_deadline is not None:
            remaining = self.drain_deadline - time.time()
            if remaining > 0:
                return round(remaining, 3)
        if len(self._finish_times) < 2:
            return self.default_retry_after_s
        span = self._finish_times[-1] - self._finish_times[0]
        if span <= 0:
            return 0.001
        est = span / (len(self._finish_times) - 1)
        return round(est * max(1, self.prefill_queue_depth), 3)

    # ---- lifecycle --------------------------------------------------------

    def submit(self, req: Request, enforce_bound: bool = True) -> int:
        """Queue one request, shedding past ``queue_depth`` and refusing
        requests the pool can never hold. ``enforce_bound=False`` bypasses
        the shed: the crash-recovery resubmission, whose requests were all
        accepted once already. Embedding requests hold no KV block, so
        pool geometry never rejects them."""
        if enforce_bound and len(self.queue) >= self.queue_depth:
            self.shed += 1
            self.tenant(req.tenant)["shed"] += 1
            ra = self.retry_after_s()
            raise ServingQueueFull(
                f"admission queue full ({self.queue_depth}): request shed; "
                f"retry in ~{ra}s; drain with step()/stream() or raise "
                f"FLAGS_serving_queue_depth",
                queue_depth=len(self.queue), live_slots=len(self.live),
                retry_after_s=ra)
        if req.kind != "embed":
            if req.kv_tokens > self.cache.max_model_len:
                raise ValueError(
                    f"request needs {req.kv_tokens} KV entries "
                    f"(prompt {req.prompt_len} + {req.max_new_tokens} new) "
                    f"> max_model_len {self.cache.max_model_len}")
            usable = self.cache.manager.num_blocks - 1  # block 0 is null
            if self.preempt_enabled:
                n = self.cache.manager.blocks_for(req.prompt_len)
                what = f"prompt ({req.prompt_len} tokens)"
            else:
                n = self.cache.manager.blocks_for(req.kv_tokens)
                what = f"worst case ({req.kv_tokens} KV entries)"
            if n > usable:
                raise ValueError(
                    f"request {what} needs {n} KV blocks but the pool only "
                    f"has {usable} usable blocks (num_blocks="
                    f"{self.cache.manager.num_blocks} incl. the null block); "
                    f"admitting it would wait forever")
        req.rid = self._next_rid
        self._next_rid += 1
        req.submit_t = time.time()
        req.state = QUEUED
        if req.deadline is not None:
            self.deadline_requests += 1
        self.tenant(req.tenant)["submitted"] += 1
        self.queue.append(req)
        return req.rid

    def next_admission(self, gate=None) -> Optional[Request]:
        """Pop the policy's pick into a free slot if its blocks fit; None
        when nothing can be admitted this iteration. A preempted request
        re-queued at the front outranks the policy; when the pick's blocks
        do not fit, admission waits (head-of-line per the policy).

        ``gate`` is the engine's adapter-pool hook: called with the pick
        before any block is allocated, False when its adapter has no free
        pool slot right now. A gated-out pick is skipped for this
        iteration only (the policy re-selects among the rest, so one
        starved adapter never blocks base traffic or other adapters) and
        stays queued."""
        candidates = [r for r in self.queue if r.kind != "embed"]
        while candidates:
            if not [m for m, r in enumerate(self.slots) if r is None]:
                return None
            if candidates[0] is self.queue[0] and self.queue[0].preemptions:
                req = candidates[0]
            else:
                req = self.policy.select(candidates, self, time.time())
            if gate is None or gate(req):
                break
            candidates.remove(req)
        else:
            return None
        free = [m for m, r in enumerate(self.slots) if r is None]
        ids = req.build_prefill_ids()
        res = self.cache.admit(
            ids, reserve_kv=None if self.preempt_enabled else req.kv_tokens,
            namespace=req.adapter_id)
        if res is None:
            return None                       # the pick waits for blocks
        blocks, hit, reg_state = res
        self.queue.remove(req)
        slot = free[0]
        req.blocks, req.slot = blocks, slot
        req.prefill_ids = ids
        req.num_computed = hit
        req.reg_state = reg_state
        req.prefix_hit_tokens += hit
        self.prefix_hit_tokens += hit
        if req.preemptions:
            rec = max(0, min(req.computed_hwm, len(ids)) - hit)
            req.recomputed_tokens += rec
            self.recomputed_tokens += rec
        req.admit_seq = self._admit_seq
        self._admit_seq += 1
        req.state = RUNNING
        self.cache.assign(slot, blocks)
        self.slots[slot] = req
        self.admitted += 1
        t = self.tenant(req.tenant)
        t["admitted"] += 1
        t["service_tokens"] += req.prompt_len     # prefill work charged now
        return req

    def preempt(self, req: Request) -> None:
        """Free a RUNNING request's blocks and re-queue it at the FRONT for
        recompute-on-readmission (tokens kept)."""
        done = (req.num_computed if req.prefilling
                else req.prompt_len + max(len(req.tokens) - 1, 0))
        req.computed_hwm = max(req.computed_hwm, done)
        self.cache.release(req.slot, req.blocks)
        self.slots[req.slot] = None
        req.blocks, req.slot = None, None
        req.num_computed = 0
        req.prefill_ids = None
        req.reg_state = (0, None)
        req.preemptions += 1
        self.preemptions += 1
        req.state = QUEUED
        self.queue.appendleft(req)

    def adopt_running(self, req: Request, slot: int,
                      blocks: List[int]) -> int:
        """Seat a MIGRATED request directly into a slot, bypassing the
        queue: its KV chain arrived with it, so there is no prefill to
        schedule and no admission to wait for. The engine has already
        allocated ``blocks`` and written the chain; this stamps the whole
        submit+admit bookkeeping (rid, timestamps, counters, tenant
        accounting) in one step, so the auditor's closure checks hold as
        if the request had been submitted and admitted here."""
        if self.slots[slot] is not None:
            raise RuntimeError(f"adopt into occupied slot {slot}")
        req.rid = self._next_rid
        self._next_rid += 1
        req.submit_t = time.time()
        if req.deadline is not None:
            self.deadline_requests += 1
        t = self.tenant(req.tenant)
        t["submitted"] += 1
        req.blocks, req.slot = blocks, slot
        req.admit_seq = self._admit_seq
        self._admit_seq += 1
        req.state = RUNNING
        self.slots[slot] = req
        self.admitted += 1
        t["admitted"] += 1
        t["service_tokens"] += req.prompt_len
        return req.rid

    def admit_embeds(self) -> List[Request]:
        """Pop EVERY queued embedding request for the engine's batched
        encoder dispatch. Embeds need no decode slot and no KV block, so
        admission is unconditional; the engine completes the whole batch
        (encoder forward, pooled output, :meth:`finish`) inside the same
        locked step. Stamps the admit bookkeeping as for generate
        traffic."""
        out = [r for r in self.queue if r.kind == "embed"]
        for req in out:
            self.queue.remove(req)
            req.admit_seq = self._admit_seq
            self._admit_seq += 1
            req.state = RUNNING
            self.admitted += 1
            t = self.tenant(req.tenant)
            t["admitted"] += 1
            t["service_tokens"] += req.prompt_len
        return out

    def preempt_victim(self) -> Optional[Request]:
        """The newest-admitted live request — unless it is the only one."""
        live = [r for r in self.slots if r is not None]
        if len(live) < 2:
            return None
        return max(live, key=lambda r: r.admit_seq)

    def finish(self, req: Request) -> None:
        """Mark finished + free its KV back to the pool."""
        self._release(req)
        req.state = FINISHED
        self._record(req)
        self.retired += 1
        self._finish_times.append(req.finish_t)
        t = self.tenant(req.tenant)
        t["retired"] += 1
        t["service_tokens"] += len(req.tokens)    # decode work charged here
        if req.ttft_s is not None:
            t["ttfts"].append(req.ttft_s)
        if req.tok_latency_s is not None:
            t["tpots"].append(req.tok_latency_s)

    def terminate(self, req: Request, state: str) -> None:
        """Force a queued or running request into CANCELLED, TIMED_OUT or
        SHED, freeing its blocks and recording its partial output."""
        if state not in TERMINAL_STATES or state == FINISHED:
            raise ValueError(f"not a forced terminal state: {state!r}")
        if req.slot is None and req in self.queue:
            self.queue.remove(req)
        self._release(req)
        req.state = state
        self._record(req)
        counter = {CANCELLED: "cancelled", TIMED_OUT: "timed_out",
                   SHED: "shed"}[state]
        setattr(self, counter, getattr(self, counter) + 1)
        t = self.tenant(req.tenant)
        t[counter] += 1
        t["service_tokens"] += len(req.tokens)
        if req.tok_latency_s is not None:
            t["tpots"].append(req.tok_latency_s)

    def _release(self, req: Request) -> None:
        req.finish_t = time.time()
        if req.blocks is not None:
            self.cache.release(req.slot, req.blocks)
            self.slots[req.slot] = None
            req.blocks = None
        req.slot = None
        if req.deadline is not None:
            self.deadline_requests -= 1

    def _record(self, req: Request) -> None:
        self.finished[req.rid] = req
        while len(self.finished) > self.keep_finished:
            del self.finished[next(iter(self.finished))]

    def find(self, rid: int) -> Optional[Request]:
        """The queued or running request with this id (None when unknown
        or already terminal)."""
        for r in self.queue:
            if r.rid == rid:
                return r
        for r in self.slots:
            if r is not None and r.rid == rid:
                return r
        return None

    def retire_finished(self) -> List[Request]:
        done = [r for r in self.slots if r is not None and r.finished]
        for r in done:
            self.finish(r)
        return done

    # ---- introspection ----------------------------------------------------

    @property
    def live(self) -> List[Request]:
        return [r for r in self.slots if r is not None]

    @property
    def decoding(self) -> List[Request]:
        """Live requests past prefill (the decode dispatch's active set)."""
        return [r for r in self.slots if r is not None and not r.prefilling]

    @property
    def pending(self) -> bool:
        return bool(self.queue) or any(r is not None for r in self.slots)

    @property
    def depth(self) -> int:
        """Outstanding work — queued plus live requests (the load signal a
        router compares)."""
        return len(self.queue) + sum(r is not None for r in self.slots)

    def by_tenant(self) -> Dict[str, Dict[str, int]]:
        """Queued/live request counts per tenant row — tenants past
        ``MAX_TENANTS`` fold into the overflow row exactly as
        :meth:`tenant` folded their counters at submit."""
        def tkey(name: str) -> str:
            return name if name in self.tenants else self._OVERFLOW_TENANT

        out = {name: {"queued": 0, "live": 0} for name in self.tenants}
        for r in self.queue:
            out[tkey(r.tenant)]["queued"] += 1
        for r in self.slots:
            if r is not None:
                out[tkey(r.tenant)]["live"] += 1
        return out

    def result(self, rid: int) -> np.ndarray:
        return self.finished[rid].output()

#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``paddle_tpu_torch``) end to end on one card.

Run from the repository root on a machine with one CUDA device::

    python3 chip_smoke.py

Phases (each fails the run on any error; none catches and carries on):

1. Environment: torch / CUDA versions and the card's name and power limit.
2. Build: compile every kernel of ``paddle_tpu_torch/csrc`` (one ``nvcc``
   per source, all at once).
3. Serving kernel checks: paged attention and the int8 matmul against
   their plain PyTorch versions at the shapes the serving path gives them,
   with kernel, plain and library-call times and the least time the card
   could take (bound); each case names the route its plan took (and its
   splits). The matmul is held to 1e-2 x max|ref| and to phase 7's
   norm-relative rule (a dropped K tile can pass a max-abs rule). Three of
   the attention cases are the speculative verify's shape (Q = 5,
   draft_lens taking every value 0..4): bf16 and int8 pools at 16/16
   heads (the split route) and GQA 32/8 (the multi-query route).
4. Serving engine at full width (the 12-layer, hidden-2048 LLaMA the
   repository's TPU benchmark serves; random weights from a seed), bf16,
   default ServingConfig: ~24 greedy requests, half sharing a 64-token
   prefix, one ~600-token prompt that chunks through mixed dispatches.
5. The same trace with ``quantize="int8"`` and ``kv_quant="int8"``.
6. Parity at fp32 on a shortened trace: the kernel engine against the
   ``paged_kernel="off"`` (gather) engine, token streams equal.
7. Flash-attention kernel checks at bf16 on four cases (the training
   step's B 8 x S 2048 x 16 heads x D 128 causal; GQA 32/8 heads; 4
   packed segments per row; causal with Sq 1024 < Sk 2048): the public
   ``flash_attention_with_lse`` and its gradient against the plain
   forward and backward (norm-relative error over the whole tensor and
   per row), dq and dk/dv each the same bits on two runs, the route one
   dq launch took by the C launcher's counts (``wgmma``: the bf16
   kernel; ``fma``: the fp32 one; every case here must take ``wgmma``),
   then the forward, backward dq and backward dk/dv kernels timed alone
   beside their plain versions, ``scaled_dot_product_attention`` and the
   bound, with the TFLOP/s each reached and its share of the bound.
8. Training at full width, bf16: the same model with ``use_kernels`` and
   full remat, B 8 x S 2048, AdamW at lr 1e-4: one warm-up step, then
   timed steps (step time, tokens/s, MFU, peak memory, launches per step)
   and one profiled step (device busy share, top kernels, and the device
   ms of each port kernel, ``flash_bwd_dq`` among them).
9. Training parity at fp32 on the card (hidden 512, 8 heads, 4 kv heads,
   4 layers, B 2 x S 512): the flash kernels against the plain attention
   on the loss, every gradient leaf and 3 AdamW steps' losses.
10. RMSNorm and RoPE kernel checks at the training step's shapes: the
    public ``rms_norm`` Function and its gradient at n = 8 x 2048 rows of
    2048 (bf16 x with an fp32 weight, and all fp32), its forward at the
    decode shape (8 rows, bf16), ``apply_rope`` and its gradient on q
    [8, 2048, 16, 128] and a GQA k [2, 2048, 8, 128] (bf16, fp32 tables),
    each against its plain version (bf16 within one bf16 step, fp32
    ``out``/``dx`` within 1e-5 x max|ref|, ``dw`` within 1e-4 x max|dw|,
    ``dw`` the same bits on two runs), then timed beside the plain version,
    ``torch.nn.functional.rms_norm`` and the bound, and beside PyTorch
    calls that move the same bytes: ``x.clone()`` for each forward and
    RoPE case, ``torch.add(x, g, out=buf)`` for each backward. Each
    RMSNorm forward and backward prints the route its launch took by the
    wrapper's counts (``registers`` or ``two_pass``), which must be its
    plan's; the forward at (a) and (c) and the backward at (a) and (b)
    must take ``registers``. Beside each of those, the two-pass kernel is
    held to the plain version and timed on the same input (and the
    backward on each other split of the row that its registers allow).
11. Phase 8 with ``use_fused_norm=True``: every norm through the RMSNorm
    kernels and the q/k RoPE through the RoPE kernel; the same metrics
    (``rms_norm_fwd`` and ``rms_norm_bwd`` device ms among them, each
    summed over its routes' kernels), printed beside phase 8's.
12. Parity at fp32 with ``use_fused_norm`` on against off: phase 9's
    training config (loss, every gradient leaf, 3 AdamW steps' losses)
    and phase 6's serving model (one ``paged_prefill`` plus one
    ``paged_decode_step``, logits within 1e-3; the fused run must launch
    the RMSNorm forward kernel).
13. Sampled serving at full width, bf16: phase 4's model and trace with
    every request at temperature 0.8, top_k 50, top_p 0.95, seed i.
    Every request ends with its ``max_new_tokens``, no block leaks, a
    second drain on a fresh engine repeats every stream, and at most half
    the streams equal phase 4's greedy ones; greedy and sampled drains run
    in turns (greedy, sampled, sampled, greedy). Then the sampler alone at
    [8, 32000] and [40, 32000] beside the ``argmax`` it replaces (its
    kernels' device time and its CUDA-event and wall time), and a
    profiled sampled drain of phase 4's 8-request profiling trace.
14. Speculative serving at full width, bf16, ``spec_decode=4,
    spec_ngram=2``: 24 prompts, half a random segment repeated 2-3 times
    whose first token is the model's own next token after the prompt
    (``quoting_prompts``), half a random base plus the model's own greedy
    stream; outputs of 32-64, stepped at ``decode_chunk`` iterations (a
    streaming client), beside the same trace with speculation off. At
    least one verify fires, the multi-query kernel launches at least 12
    times per verify (one per layer), every request completes, no block
    leaks; acceptance and the share of equal streams are reported. Where
    a stream parts between spec on and off, the fp32 logit gap of the two
    tokens at the first difference must lie within twice the bf16
    rounding of that row's logits. A drain of 8 of its requests is
    profiled.
15. Parity at fp32 on phase 6's model: sampled streams equal between the
    kernel and gather engines on phase 6's trace; on eight self-quoting
    prompts, speculation on and off give equal streams, greedy (with at
    least one verify and one accepted draft) and sampled; then the
    sampled verify again with drafts that replay the spec-off stream,
    which must verify, accept every draft and give the same streams.
16. Remat policies on phase 8's step (bf16, ``use_kernels``, B 8 x S
    2048, 12 layers, lr 1e-4): each of the nine ``remat_policy`` values
    (``None``, ``"nothing"`` and the seven names) from the same
    parameters, one warm-up step and 2 timed ones (step ms, peak memory,
    launches and dense GEMMs per step by weight name, counted by
    wrapping ``llama._mm``). The flash forwards a step must be 24 (12
    under the three ``save_flash*``) and the q/k/v projections as the
    JAX policy schedules them (12 each under ``save_flash``); every
    policy's loss after one update within 1e-3 relative of full
    remat's (bit equality reported); then full remat and ``save_flash``
    timed in turns (None, save_flash, save_flash, None); then at fp32 on
    phase 9's config every policy's gradient leaves within 1e-6 x
    max|g| of full remat's. Last, phase 11's step (``use_fused_norm``)
    under ``save_flash``: phase 8's metrics and a profiled step, with
    12 flash forwards, 49 / 25 RMSNorm and 24 / 24 RoPE launches a step.
17. The JAX package's tuned training step (``bench.py``'s
    ``bench_tuned`` row: ``save_flash``, ``ce_chunks=16``, bf16 moments
    and gradients) beside the same step with ``sentinel=True``: one
    clean step of each from the same parameters must give the same loss
    bits; then interleaved blocks of 2 steps, 4 rounds, the least time
    a step of each (``bench.py``'s estimator), MFU and the sentinel's
    overhead; one profiled unguarded step; then NaN-poisoned parameters:
    the guarded step must report bad, keep the step count and leave
    every moment finite.
18. MoE serving: phase 4's model, config and trace with 8 experts,
    top-2, capacity factor 1.25 (bf16, random weights from the seed):
    every request completes, no block leaks, 12 paged-attention
    launches per decode iteration and per mixed dispatch; tokens/s,
    TTFT and ms per decode iteration; the drop counts of one direct
    ``paged_prefill`` and ``paged_decode_step``. Then at fp32 on phase
    6's trace: one decode dispatch's logits, kernel against gather,
    within 1e-3, and the kernel and gather engines' greedy and sampled
    streams equal, at capacity factors 1.25 (drops) and 4 (capacity =
    T, nothing drops).
19. MoE training: phase 8's width and batch with 8 experts, top-2, 4
    layers (full remat): phase 8's metrics, falling finite losses and
    the derived flash launches; then phase 9's fp32 parity (flash
    kernels against the plain attention) with 4 experts.
20. Multi-adapter LoRA serving at full width, bf16: phase 4's model and
    trace through an engine with ``lora_rank=16, lora_slots=4,
    lora_pool=8`` and 8 registered adapters (``lora_init_params(cfg, 16,
    seed=i)``), every third request base and the rest cycling over the
    adapters, in turns with phase 4's LoRA-less engine (A, LoRA, LoRA,
    A): tokens/s, TTFT p50 and max, ms per decode iteration. Every
    request completes, no block leaks, no pin is left, at least 8 loads
    and 4 evictions, 12 paged-attention launches per decode iteration
    and per mixed dispatch. Base traffic through a LoRA engine holding
    the 8 adapters gives phase 4's streams and, with ``quantize="int8",
    kv_quant="int8"``, phase 5's, bit for bit (the int8 run must launch
    the int8 matmul). One decode iteration (8 rows) without and with the
    LoRA operand: kernel launches and device ms from the profiler, and
    one layer's four deltas timed alone; a profiled drain of 8 requests.
21. LoRA parity at fp32 on phase 6's model and trace, five adapters on
    two slots: a mixed wave (base, a1, a2, a1, a4, a5) where each stream
    equals its oracle (the LoRA-less engine on the base weights or on
    ``merge_lora(params, adapter)``, the request alone) or parts from it
    where the fp32 logits of the two tokens lie within 1e-4 x max|logit|
    of that row; at least one adapter stream differs from base; the
    kernel and gather engines give equal streams, greedy and sampled; an
    adapter's stream after eviction and reload equals its first, with
    every pool leaf's storage unchanged.
22. The dense tier: ``generate`` at full width, bf16, B 8 with prompts
    of 64-128 and 64 new tokens, in turns without and with an EOS id
    that never fires (the cost of the per-token read of the done mask);
    ``GenerationPredictor(quantize="int8")`` launching
    ``weight_only_matmul`` 85 times a forward (12 layers x 7 projections
    and the LM head); then at fp32 on phase 6's model and trace:
    ``generate`` equals the serving engine, ``DecodeSession``'s argmax
    stream equals ``generate``, and a sampled ``generate`` repeats with
    its seed.
23. The host KV offload tier (cell O), A's model at bf16: a churn wave of
    16 families x 2 requests (a 256-token family prefix, a 16-token tail,
    16 new tokens) through a 200-block pool, then a revisit wave of one
    request a family (a fresh tail), tier on and off in turns (off, on,
    on, off; 512 host blocks): revisit TTFT p50 and max, prefill tokens
    computed, the swap counters, the host ms of the revisit's admissions
    and of the tier's verified takes. With the tier on the revisit must
    recompute no prefix token and launch paged attention, every request
    completes, no block leaks, device and host keys are disjoint. Then
    the swap cost a block over 64 blocks (D2H into pinned buffers, H2D
    back: CUDA-event and host ms, GB/s against PCIe's bound, the host's
    CRC32 of a block); then at fp32 on C's model tier-on streams equal
    tier-off, with an fp pool and with ``kv_quant="int8",
    quantize="int8"`` (which must launch the int8 matmul), and a
    corrupted host block drops once and changes no stream.
24. The journal, the supervisor and the hang watchdog (cell Q): phase
    4's trace through ``EngineSupervisor`` with a journal, in turns
    without and with a crash injected at decode iteration 10 (tokens/s,
    recovery ms, recovered tokens, journal bytes a token; with the crash
    ``restarts`` 1, device memory after the rebuild within one KV pool of
    before, the weights not re-cast); every request completes with its
    budget, no delivered token repeats, no block leaks; the journal's
    work a step replayed under the ``step``, ``always`` and ``off``
    policies. At fp32 on C's model and trace (half the requests seeded,
    stepped 2 decode iterations at a time): a crash recovers to the
    uninterrupted streams; a journal abandoned after 4 steps (kill -9)
    recovers through ``EngineSupervisor.recover`` delivering each stream
    exactly once; a restart budget of 0 flips the supervisor to broken
    with partials readable; ``drain(deadline_s=0.5)`` ends holding no
    block; the watchdog (0.5 s) fires over a ~2 s ``torch.cuda._sleep``
    behind a blocked ``synchronize()`` inside ``serving.decode``, before
    the wait returns, and the supervisor recovers to the same streams.
25. Embeddings (cell P): BERT-base (``BertConfig()``, fp32, seed 0) in
    one engine with A's model: 64 passages of 16-512 tokens arriving 4 a
    step beside phase 4's 24 generate requests, in turns without and
    with them (off, on, on, off): embeds/s, embed latency p50 and max,
    A's tokens/s and TTFT p50. Every embedding within 1e-4 x max|ref| of
    ``bert_encode`` of the passage alone; the pool's free blocks the same
    before and after; paged attention launched for the generate traffic.
26. The serving fleet (cell R): A's model at bf16 behind
    ``ServingRouter`` with live migration, built as one replica plus two
    spawns (device memory after each: 3 replicas within 2 KV pools + 5 %
    of 1, the weights held once). Phase 4's trace in turns through one
    ``EngineSupervisor`` and through the 3-replica fleet (supervisor,
    fleet, fleet, supervisor): tokens/s, TTFT p50 and max (submit to
    first delivered token, host clock), the router's host ms a submit
    and a step beyond its replicas' own steps, placements, sticky and
    directory hits; the auditor clean after every step and at quiesce,
    12 paged-attention launches a decode iteration fleet-wide. Then a
    replica killed at its decode iteration 10 (failovers, failed 0, no
    delivered token repeated, failover tokens, ms from the kill to a
    failed-over request's first token after it); a rolling restart under
    the trace (3 rebuilds, failed 0, memory within one pool); half the
    trace with the busiest replica drained after 10 decode iterations
    (migrations, no fallback, no recomputed token, memory within one
    pool of the 2-replica level; per migrated request blocks, MB,
    ``serialize_request`` and ``adopt`` ms, GB/s against PCIe's bound).
27. Fleet cache pulls and disaggregated prefill (cell S), A's model at
    bf16. Two replicas, 16 families of a 256-token prefix: a placement
    wave pinned to replica 0, then a sharing wave (fresh 16-token tails)
    pinned to replica 1, ``fleet_cache`` off and on in turns (off, on,
    on, off): the sharing wave's TTFT p50 and max, pulls, pulled blocks
    (256 with the cache on, no fallback, no prefix token recomputed),
    export and graft ms a block and the host CRC32's share of each;
    then one more family with replica 0's
    next export corrupted: exactly one more pull fallback, its stream
    equal to the cache-off turns'. Then phase 4's trace plus 8 prompts of
    512-1024 tokens from 16 streaming clients (one decode iteration a
    step), ``RouterConfig(replicas=2, prefill_replicas=1,
    prefill_len_threshold=256)`` in turns with 3 unified replicas:
    tokens/s, TTFT, the short requests' time per output token p50 and
    p99; the split fleet routes the long prompts to prefill and hands
    them off with no fallback and no recomputed token.
28. fp32 fleet parity on C's model and trace (half the requests seeded,
    stepped 2 decode iterations at a time): the single engine's streams
    from a 3-replica fleet, a replica kill, a crash loop that opens the
    breaker and evacuates, a slow replica under hedging (hedges, wins
    and cancelled copies 1 each), a flaky probe (the breaker opens, then
    closes after a half-open probe), a rolling restart with deadline 0,
    a drain with migration, a pinned pull, a prefill handoff, a
    journaled fleet cold-started after its journal was abandoned (each
    stream delivered once) and two adapters through a replica kill
    (the same adapters re-pinned). Then with ``quantize="int8",
    kv_quant="int8"``: a drain whose migrations carry k, v and their
    scales, and a pinned pull, each equal to the unmigrated int8 engine;
    the int8 matmul launches.

Then the kernels JSON line, the card line and the result line. Phases 4
and 5 each serve one short warm-up request first (first-call set-up stays
out of the numbers). Kernel launch counters are set to 0 just before each
main-path run and read just after it: paged attention must have launched
on both entry points in phase 4, the int8 matmul and the int8-pool
attention in phase 5, both attention entry points in phase 13. Every
timed training step must launch exactly
what ``expected_launches`` derives: in phase 8 the flash kernels (24
forward, 12 dq, 12 dk/dv per step: the forward runs again in each
layer's recompute) and nothing else; in phase 11 also 49 RMSNorm
forwards (2 per layer, twice, plus the final norm), 25 RMSNorm
backwards, 48 RoPE forwards (q and k, twice) and 24 RoPE backwards. The
kernels line reports the serving launches of phases 4, 5, 13, 14
(speculation on), 20 (the LoRA drain and both base-traffic runs), 23
(the bf16 revisit and the fp32 int8 tier run), 24 (the bf16 crash run),
25 (the generate traffic beside the embeds), 26 (the first fleet turn),
27 (the first sharing wave with the fleet cache on) and 28 (the int8
drain with migration) together,
the flash launches of phase 8 and the RMSNorm and RoPE launches of
phase 11 (RoPE: forward and backward together).
Exits non-zero, printing no result, without a CUDA device or outside a
checkout of the repository.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12              # H100 SXM HBM3
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12}   # dense, tensor-core bf16;
#                                                fp32 outside the tensor cores
SEED = 0


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def log(*a):
    print(*a, flush=True)


_FLUSH = []


def cuda_ms(fn, iters=10, warmup=2):
    """Mean device time of one call of ``fn`` over ``iters`` calls, each
    timed with CUDA events after a write of 64 MB has evicted the 50 MB
    L2 cache: the engine finds weights and KV cold, since a step walks
    far more than fits there. A spin of about a millisecond on the card
    goes first, so the card is still busy while the host enqueues the
    call and the events time the device work alone."""
    import torch
    if not _FLUSH:
        _FLUSH.append(torch.empty(64 << 20, dtype=torch.uint8, device="cuda"))
    for _ in range(warmup):
        fn()
    events = []
    for _ in range(iters):
        torch.cuda._sleep(2_000_000)
        _FLUSH[0].zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        events.append((a, b))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in events) / iters


_COUNTS = (("paged_attention", "launches"),
           ("paged_attention", "launches_multiquery"),
           ("paged_attention", "launches_int8"),
           ("weight_only_matmul", "launches"),
           ("flash_attention", "launches"),
           ("flash_attention", "launches_bwd_dq"),
           ("flash_attention", "launches_bwd_dkv"),
           ("rms_norm", "launches"),
           ("rms_norm", "launches_bwd"),
           ("apply_rope", "launches"),
           ("apply_rope", "launches_bwd"))


def _count_owners():
    from paddle_tpu_torch.kernels.flash_attention import flash_attention
    from paddle_tpu_torch.kernels.paged_attention import paged_attention
    from paddle_tpu_torch.kernels.quant_matmul import weight_only_matmul
    from paddle_tpu_torch.kernels.rms_norm import rms_norm
    from paddle_tpu_torch.kernels.rope import apply_rope
    return {"paged_attention": paged_attention,
            "weight_only_matmul": weight_only_matmul,
            "flash_attention": flash_attention, "rms_norm": rms_norm,
            "apply_rope": apply_rope}


def reset_counts():
    """Every kernel wrapper's launch counts to 0."""
    owners = _count_owners()
    for name, attr in _COUNTS:
        setattr(owners[name], attr, 0)


def read_counts():
    """{name[_variant]: launches} for every kernel wrapper."""
    owners = _count_owners()
    return {name + attr[len("launches"):]: getattr(owners[name], attr)
            for name, attr in _COUNTS}


def route_taken(counts, fn):
    """The route whose launch count ``counts()`` ({route: launches}, as a
    kernel wrapper counts them) one call of ``fn`` raised; None unless
    exactly one did."""
    import torch
    before = dict(counts())
    fn()
    torch.cuda.synchronize()
    after = counts()
    moved = [r for r in after if after[r] != before[r]]
    return moved[0] if len(moved) == 1 else None


def bound(nbytes, flops, kind):
    """(least ms, what bounds it): bytes over HBM rate vs flops over peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def attention_case(name, M, H, Hk, D, bs, W, quant, Q=None, seed=0,
                   every_draft_len=False):
    """One paged-attention case against its plain version, timed beside
    SDPA and the bound. ``every_draft_len``: draft_lens cycle through
    0..Q-1 over the rows (the verify shape), else random."""
    import importlib
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.device import sm_count
    from paddle_tpu_torch.models.generation import _kv_quantize
    # the module (the package's ``paged_attention`` is the function)
    PA = importlib.import_module("paddle_tpu_torch.kernels.paged_attention")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    N = M * W + 2
    q = torch.randn((M, H, D) if Q is None else (M, Q, H, D), generator=g,
                    device=dev).to(torch.bfloat16)
    kf = torch.randn((N, bs, Hk, D), generator=g, device=dev)
    vf = torch.randn((N, bs, Hk, D), generator=g, device=dev)
    for t in (kf, vf):               # poison: the null block, a freed block
        t[0] = float("nan")
        t[N - 1] = float("nan")
    rng = np.random.default_rng(seed)
    tbl = torch.from_numpy(rng.permutation(np.arange(1, N - 1))[:M * W]
                           .reshape(M, W).astype(np.int32)).to(dev)
    qspan = 1 if Q is None else Q
    sl_np = rng.integers(0, W * bs - qspan + 1, size=M).astype(np.int32)
    if Q is None:
        dl_np = None
    elif every_draft_len:
        dl_np = (np.arange(M) % Q).astype(np.int32)
    else:
        dl_np = rng.integers(0, Q, size=M).astype(np.int32)
    sl = torch.from_numpy(sl_np).to(dev)
    dl = None if dl_np is None else torch.from_numpy(dl_np).to(dev)
    if quant:
        k, ks = _kv_quantize(kf)
        v, vs = _kv_quantize(vf)
        extra = dict(k_scale=ks, v_scale=vs)
    else:
        k, v, extra = kf.to(torch.bfloat16), vf.to(torch.bfloat16), {}
    del kf, vf

    def kern():
        return PA.paged_attention(q, k, v, tbl, sl, draft_lens=dl, **extra)

    route, splits, _ = PA._plan(M, (Q or 1) * (H // Hk), Hk, W * bs, True,
                                sm_count(dev))

    def plain():
        return PA.paged_attention_plain(q, k, v, tbl, sl, draft_lens=dl,
                                        **extra)

    out = kern()
    torch.cuda.synchronize()
    ref = plain()
    torch.cuda.synchronize()
    check(torch.isfinite(out.float()).all().item(),
          f"{name}: non-finite output (poison leaked)")
    err = (out.float() - ref.float()).abs().max().item()
    scale = max(1.0, ref.float().abs().max().item())
    # both reduce in fp32 in another order; a bf16 output rounds once more
    tol = (2e-2 if out.dtype == torch.bfloat16 else 1e-4) * scale
    check(err <= tol, f"{name}: kernel vs plain max error {err} > {tol}")

    # the library yardstick: SDPA over the pre-gathered, finite KV
    C = W * bs
    kk = torch.nan_to_num(
        (k[tbl.long()].float() * (extra["k_scale"][tbl.long()][..., None]
                                  if quant else 1.0)).reshape(M, C, Hk, D))
    vv = torch.nan_to_num(
        (v[tbl.long()].float() * (extra["v_scale"][tbl.long()][..., None]
                                  if quant else 1.0)).reshape(M, C, Hk, D))
    G = H // Hk
    kk = kk.to(torch.bfloat16).repeat_interleave(G, 2).transpose(1, 2)
    vv = vv.to(torch.bfloat16).repeat_interleave(G, 2).transpose(1, 2)
    qs = (q[:, None] if Q is None else q).transpose(1, 2)      # [M,H,Q,D]
    qn = qs.shape[2]
    j = torch.arange(C, device=dev)
    hi = sl.long()[:, None] + torch.minimum(
        torch.arange(qn, device=dev)[None],
        (dl.long() if dl is not None else torch.zeros_like(sl).long())[:,
                                                                      None])
    mask = (j[None, None] <= hi[:, :, None])[:, None]         # [M,1,Q,C]

    def library():
        return F.scaled_dot_product_attention(qs, kk, vv, attn_mask=mask)

    iters = 3 if Q is not None and Q > 8 else 10
    ms = cuda_ms(kern, iters=20)
    plain_ms = cuda_ms(plain, iters=iters)
    library_ms = cuda_ms(library, iters=iters)
    # bound: what THIS data needs — each slot's window of K/V (+ scales),
    # q, the tables it reads, the output; 4*D flops per (row, key, head)
    dls = dl_np if dl_np is not None else np.zeros(M, np.int64)
    window = np.minimum(sl_np.astype(np.int64) + dls + 1, W * bs)
    kv_item = 1 if quant else 2
    nbytes = (q.numel() * 2 + out.numel() * out.element_size()
              + int(window.sum()) * Hk * D * kv_item * 2
              + (int(window.sum()) * Hk * 4 * 2 if quant else 0)
              + int(np.ceil(window / bs).sum()) * 4 + M * 4 * 2)
    keys = sum(int(sl_np[m]) + min(i, int(dls[m])) + 1
               for m in range(M) for i in range(qn))
    flops = keys * H * 4 * D
    b_ms, b_by = bound(nbytes, flops, "bf16")
    route = ("fma", "multi-query", "split")[route]
    row = {"case": name, "route": route, "splits": splits,
           "max_abs_err": err, "tol": tol, "ms": ms, "plain_ms": plain_ms,
           "library_ms": library_ms, "bound_ms": b_ms, "bound_by": b_by}
    log(f"  {name} [{route}, {splits} split(s)]: max_abs_err {err:.3g} (tol "
        f"{tol:.3g})  kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  sdpa "
        f"{library_ms:.4f} ms  bound {b_ms:.4f} ms ({b_by})")
    return row


def matmul_case(M, K, N, seed=0):
    import torch
    from paddle_tpu_torch.device import sm_count
    from paddle_tpu_torch.kernels import quant_matmul as QM
    from paddle_tpu_torch.kernels.quant_matmul import (
        quantize_weights, weight_only_matmul, weight_only_matmul_plain)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((M, K), generator=g, device=dev).to(torch.bfloat16)
    wq, s = quantize_weights(torch.randn((K, N), generator=g, device=dev)
                             / K ** 0.5)
    w_deq = (wq.float() * s[None]).to(torch.bfloat16)

    def kern():
        return weight_only_matmul(x, wq, s, out_dtype=torch.bfloat16)

    def plain():
        return weight_only_matmul_plain(x, wq, s, out_dtype=torch.bfloat16)

    out = kern()
    torch.cuda.synchronize()
    ref = plain()
    err = (out.float() - ref.float()).abs().max().item()
    # the kernel scales after an fp32 sum; the plain version multiplies by
    # a bf16-rounded dequantized weight: they differ by bf16 rounding
    tol = 1e-2 * ref.float().abs().max().item()
    check(err <= tol, f"matmul {M}x{K}x{N}: max error {err} > {tol}")
    # and the flash rule: a dropped K tile can pass a max-abs rule
    fro, rel_row = rel_errors(out, ref)
    check(fro <= BF16_FRO and rel_row <= BF16_ROW,
          f"matmul {M}x{K}x{N}: rel_fro {fro:.3g} (limit {BF16_FRO}), "
          f"rel_row {rel_row:.3g} (limit {BF16_ROW})")
    route, splits, _ = QM._plan(M, K, N, False, sm_count(dev))
    route = ("fp32", "tc16", "tc64", "tc128")[route]
    iters = 5 if M > 16 else 20
    ms = cuda_ms(kern, iters=iters)
    plain_ms = cuda_ms(plain, iters=iters)
    library_ms = cuda_ms(lambda: torch.matmul(x, w_deq), iters=iters)
    nbytes = M * K * 2 + K * N + N * 4 + M * N * 2
    b_ms, b_by = bound(nbytes, 2.0 * M * N * K, "bf16")
    name = f"M={M} K={K} N={N}"
    log(f"  {name} [{route}, {splits} split(s)]: max_abs_err {err:.3g} "
        f"(tol {tol:.3g}) rel_fro {fro:.3g} rel_row {rel_row:.3g}  kernel "
        f"{ms:.4f} ms  plain {plain_ms:.4f} ms  matmul {library_ms:.4f} ms  "
        f"bound {b_ms:.4f} ms ({b_by})")
    return {"case": name, "route": route, "splits": splits,
            "max_abs_err": err, "tol": tol, "rel_fro": fro,
            "rel_row": rel_row, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": b_ms, "bound_by": b_by}


def summarize(name, source, replaces, rows, launches):
    """One kernels-line entry: times summed over the checked shapes
    (``library_ms`` null where no single PyTorch call computes it)."""
    by = {}
    for r in rows:
        by[r["bound_by"]] = by.get(r["bound_by"], 0.0) + r["bound_ms"]
    lib = [r["library_ms"] for r in rows]
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": sum(r["ms"] for r in rows),
            "plain_ms": sum(r["plain_ms"] for r in rows),
            "bound_ms": sum(r["bound_ms"] for r in rows),
            "bound_by": max(by, key=by.get),
            "library_ms": None if None in lib else sum(lib),
            "cases": rows}


# ---------------------------------------------------------------------------
# phase 7: the flash-attention kernels against their plain versions
# ---------------------------------------------------------------------------

FLASH_KERNELS = (("fwd", "flash_attention_fwd", ":67"),
                 ("dq", "flash_attention_bwd_dq", ":204"),
                 ("dkv", "flash_attention_bwd_dkv", ":259"))


def packed_ids(rng, B, S, n):
    """[B, S] int32 ids of ``n`` packed segments per row (random cuts)."""
    cuts = np.sort(np.stack([rng.choice(np.arange(1, S), n - 1,
                                        replace=False) for _ in range(B)]),
                   axis=1)
    return (np.arange(S)[None, :, None] >= cuts[:, None, :]).sum(-1) \
        .astype(np.int32)


# bf16 limits of rel_errors: measured readings (PERF.md) sit below a third
# of them; one key tile dropped from the long rows, or the causal diagonal
# moved by one, reads above them (case (a) checks that on every run)
BF16_FRO, BF16_ROW = 1e-2, 3e-2


def rel_errors(got, want):
    """(||got - want||_F / ||want||_F, the worst row's ||got_r - want_r|| /
    max(||want_r||, 0.1 * the RMS row norm)), a row being one vector of
    the last dim. The floor keeps rows whose exact value is ~0 (row 0's
    dq under causal: dS = p (dp - delta) cancels) from reading as 1."""
    import torch
    g = got.float().reshape(-1, got.shape[-1])
    w = want.float().reshape(-1, want.shape[-1])
    d = g - w
    rows = w.norm(dim=1)
    floor = 0.1 * w.norm() / rows.numel() ** 0.5
    return ((d.norm() / w.norm()).item(),
            (d.norm(dim=1) / torch.clamp(rows, min=floor)).max().item())


def visible(Sq, Sk, causal, seg, device):
    """[B|1, 1, Sq, Sk] bool: query i sees key j (causal bottom-right
    aligned; within its packed segment)."""
    import torch
    i = torch.arange(Sq, device=device)[:, None]
    j = torch.arange(Sk, device=device)[None, :]
    mask = (j <= i + (Sk - Sq)) if causal else torch.ones(
        (Sq, Sk), dtype=torch.bool, device=device)
    mask = mask[None]
    if seg is not None:
        mask = mask & (seg[:, :, None] == seg[:, None, :])
    return mask[:, None]


def masked_out(q, k, v, mask, scale):
    """Plain MHA forward under an arbitrary ``mask`` (the probe's mutants)."""
    import torch
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    p = torch.softmax(s.masked_fill(~mask, -1e30), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


def flash_case(name, B, Sq, Sk, H, Hk, D, causal, n_segs=0, seed=0,
               probe=False):
    """One bf16 case: the public ``flash_attention_with_lse`` (its
    autograd Function, forward and ``torch.autograd.grad``) against the
    plain forward and backward on out, lse, dq, dk and dv; then each
    kernel timed alone through its launcher beside its plain version and
    SDPA. ``probe``: also show that the rule rejects a forward that drops
    one key tile from the long rows and one whose causal diagonal is off
    by one. Returns {"fwd"|"dq"|"dkv": row}, rows as attention_case gives
    them."""
    import importlib
    import torch
    import torch.nn.functional as F
    # the module (the package's ``flash_attention`` attribute is the
    # function it exports)
    FA = importlib.import_module("paddle_tpu_torch.kernels.flash_attention")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, do = (torch.randn(shape, generator=g, device=dev)
                   .to(torch.bfloat16)
                   for shape in ((B, Sq, H, D), (B, Sk, Hk, D),
                                 (B, Sk, Hk, D), (B, Sq, H, D)))
    seg = None
    if n_segs:
        seg = torch.from_numpy(packed_ids(np.random.default_rng(seed), B,
                                          Sq, n_segs)).to(dev)
    scale = 1.0 / D ** 0.5
    mask = visible(Sq, Sk, causal, seg, dev)                  # [B|1,1,Sq,Sk]
    pairs = int(mask.sum().item()) * H * (B if mask.shape[0] == 1 else 1)

    qg, kg, vg = (t.detach().requires_grad_(True) for t in (q, k, v))
    out, lse = FA.flash_attention_with_lse(qg, kg, vg, causal=causal,
                                           segment_ids=seg)
    dq, dk, dv = torch.autograd.grad(out, (qg, kg, vg), do)
    out = out.detach()
    torch.cuda.synchronize()
    check(out.dtype == dq.dtype == dk.dtype == dv.dtype == torch.bfloat16
          and lse.dtype == torch.float32, f"{name}: output dtypes "
          f"{out.dtype} {lse.dtype} {dq.dtype} {dk.dtype} {dv.dtype}")
    ref_out, ref_lse = FA.flash_attention_fwd_plain(q, k, v, seg, seg, scale,
                                                    causal)
    # the backward's inputs are the Function's saved out and lse: delta =
    # rowsum(dO * O) comes from the bf16-rounded out, and in short causal
    # rows dq moves with that rounding by more than the kernels' own
    # error (the plain backward on its own out as much), so the plain
    # backward gets the same saved tensors
    ref = dict(zip(("dq", "dk", "dv"), FA.flash_attention_bwd_plain(
        q, k, v, seg, seg, out, lse, do, scale, causal)))

    # bf16 outputs round once more than their fp32 reference; the
    # tensor-core products round p and ds to bf16 first
    errs = {}
    for which, got, want in (("fwd", out, ref_out), ("dq", dq, ref["dq"]),
                             ("dk", dk, ref["dk"]), ("dv", dv, ref["dv"])):
        check(torch.isfinite(got.float()).all().item(),
              f"{name} {which}: non-finite output")
        fro, row = rel_errors(got, want)
        errs[which] = {"max_abs_err": (got.float() - want.float()).abs()
                       .max().item(), "rel_fro": fro, "rel_row": row}
        check(fro <= BF16_FRO and row <= BF16_ROW,
              f"{name} {which}: kernel vs plain rel_fro {fro:.3g} (limit "
              f"{BF16_FRO}), rel_row {row:.3g} (limit {BF16_ROW})")
    lse_err = (lse - ref_lse).abs().max().item()
    check(lse_err <= 1e-3, f"{name}: lse max error {lse_err} > 1e-3")
    log(f"  {name}: lse max_abs_err {lse_err:.3g}, visible pairs {pairs}; "
        + "; ".join(f"{w} rel_fro {e['rel_fro']:.3g} rel_row "
                    f"{e['rel_row']:.3g}" for w, e in errs.items()))
    if probe:
        i = torch.arange(Sq, device=dev)[:, None]
        j = torch.arange(Sk, device=dev)[None, :]
        mutants = {"one key tile dropped from rows >= 1024":
                   mask & ~((i >= 1024) & (j >= 512) & (j < 544)),
                   "causal diagonal off by one": j <= i + 1}
        for what, m in mutants.items():
            fro, row = rel_errors(masked_out(q, k, v, m, scale), ref_out)
            log(f"  probe, {what}: rel_fro {fro:.3g} rel_row {row:.3g}")
            check(fro > BF16_FRO or row > BF16_ROW,
                  f"the bf16 rule would pass a forward with {what}")
    del ref_out, ref_lse, ref, qg, kg, vg

    # the library yardstick: SDPA, timed, never called by the port
    qs, ks, vs = (t.transpose(1, 2).detach().requires_grad_(True)
                  for t in (q, k, v))
    sdpa_kw = {"enable_gqa": Hk != H}
    if causal and Sq == Sk and seg is None:
        sdpa_kw["is_causal"] = True
    elif causal or seg is not None:
        sdpa_kw["attn_mask"] = mask
    lib_out = F.scaled_dot_product_attention(qs, ks, vs, **sdpa_kw)
    dos = do.transpose(1, 2)

    def lib_bwd():
        return torch.autograd.grad(lib_out, (qs, ks, vs), dos,
                                   retain_graph=True)

    # each kernel alone, through its launcher (the Function's own calls)
    saved = (q, k, v, seg, seg, out, lse, do, scale, causal)
    ops = FA._bwd_operands(q, k, v, seg, seg, out, lse, do)
    heavy = Sq * Sk * H * B > 2 ** 28
    it_plain = 3 if heavy else 5
    times = {
        "fwd": (cuda_ms(lambda: FA._fwd_cuda(q, k, v, seg, seg, scale,
                                             causal)),
                cuda_ms(lambda: FA.flash_attention_fwd_plain(
                    q, k, v, seg, seg, scale, causal), iters=it_plain),
                cuda_ms(lambda: F.scaled_dot_product_attention(
                    qs, ks, vs, **sdpa_kw))),
        "dq": (cuda_ms(lambda: FA._dq_cuda(ops, scale, causal)),
               cuda_ms(lambda: FA.flash_attention_bwd_dq_plain(*saved),
                       iters=it_plain),
               None),
        "dkv": (cuda_ms(lambda: FA._dkv_cuda(ops, scale, causal)),
                cuda_ms(lambda: FA.flash_attention_bwd_dkv_plain(*saved),
                        iters=it_plain),
                None),
    }
    # SDPA's backward computes dq, dk and dv in one call: its time stands
    # beside both backward kernels
    lib_bwd_ms = cuda_ms(lib_bwd)
    # bytes each kernel must move: every input read once, every output
    # written once. The backward kernels read lse and delta = rowsum(dO *
    # O) ([B, H, Sq] fp32 each), not o.
    item = q.element_size()
    qkv = (q.numel() + k.numel() + v.numel()) * item
    segs = 0 if seg is None else 2 * seg.numel() * 4
    stats = lse.numel() * 4
    flops = {"fwd": 4, "dq": 6, "dkv": 8}
    nbytes = {"fwd": qkv + segs + out.numel() * item + stats,
              "dq": qkv + segs + do.numel() * item + 2 * stats
              + q.numel() * item,
              "dkv": qkv + segs + do.numel() * item + 2 * stats
              + (k.numel() + v.numel()) * item}
    errs["dkv"] = {key: max(errs["dk"][key], errs["dv"][key])
                   for key in errs["dk"]}
    # dk/dv sum the GQA group in registers in a fixed order, and each dq
    # block owns its rows: the same bits on two runs
    dkv1, dkv2 = FA._dkv_cuda(ops, scale, causal), FA._dkv_cuda(ops, scale,
                                                                 causal)
    check(all(torch.equal(a, b) for a, b in zip(dkv1, dkv2)),
          f"{name}: dk/dv differ between two runs")
    check(torch.equal(FA._dq_cuda(ops, scale, causal),
                      FA._dq_cuda(ops, scale, causal)),
          f"{name}: dq differs between two runs")
    del dkv1, dkv2
    dq_route = route_taken(lambda: FA.flash_attention
                           .launches_bwd_dq_by_route,
                           lambda: FA._dq_cuda(ops, scale, causal))
    log(f"  {name}: dq route {dq_route}")
    check(dq_route == "wgmma", f"{name}: bf16 dq took route {dq_route}, "
          f"not wgmma")
    rows = {}
    for which, _, _ in FLASH_KERNELS:
        ms, plain_ms, lib_ms = times[which]
        if lib_ms is None:
            lib_ms = lib_bwd_ms
        work = flops[which] * D * pairs
        b_ms, b_by = bound(nbytes[which], work, "bf16")
        rows[which] = {"case": name, **errs[which], "ms": ms,
                       **({"route": dq_route} if which == "dq" else {}),
                       "plain_ms": plain_ms, "library_ms": lib_ms,
                       "bound_ms": b_ms, "bound_by": b_by,
                       "tflops": work / ms / 1e9,
                       "bound_share": b_ms / ms, "visible_pairs": pairs}
        log(f"  {name} {which}: rel_fro {errs[which]['rel_fro']:.3g}  "
            f"kernel {ms:.4f} ms ({work / ms / 1e9:.1f} TFLOP/s, "
            f"{100 * b_ms / ms:.1f} % of bound)  plain {plain_ms:.4f} ms  "
            f"sdpa {'bwd ' if which != 'fwd' else ''}{lib_ms:.4f} ms  bound "
            f"{b_ms:.4f} ms ({b_by})")
    log(f"  {name}: dq and dk/dv each the same bits on two runs")
    return rows


# ---------------------------------------------------------------------------
# phase 10: the RMSNorm and RoPE kernels against their plain versions
# ---------------------------------------------------------------------------

def bf16_steps(got, ref):
    """The largest |got - ref| in bf16 steps of the reference (2**-7 of
    it), the step taken at the larger of |ref| and 1e-3 of ref's RMS: where
    a value cancels to ~0 (dx = rstd * (wg - xhat * m)) the two fp32
    reduction orders differ by ~1e-7 of the terms, many steps of the tiny
    result. <= 1 is "within one bf16 step"."""
    import torch
    g, r = got.float(), ref.float()
    floor = 1e-3 * r.pow(2).mean().sqrt()
    return ((g - r).abs() / (2.0 ** -7 * torch.clamp(r.abs(), min=floor))) \
        .max().item()


def hold(name, got, ref, fp32_rel):
    """Hold one output to its plain version: bf16 within one bf16 step,
    fp32 within ``fp32_rel`` x max|ref|. Returns the max abs error."""
    import torch
    check(torch.isfinite(got.float()).all().item(), f"{name}: non-finite")
    err = (got.float() - ref.float()).abs().max().item()
    if got.dtype == torch.bfloat16:
        steps = bf16_steps(got, ref)
        check(steps <= 1, f"{name}: {steps:.3g} bf16 steps from plain")
    else:
        lim = fp32_rel * ref.float().abs().max().item()
        check(err <= lim, f"{name}: max error {err} > {lim}")
    return err


def norm_case(name, n, d, x_dtype, w_dtype, backward, seed):
    """One RMSNorm case: the public ``rms_norm`` Function (and its
    gradient) against the plain forward (and backward), the forward's
    route, then the kernels timed alone beside the plain versions and
    ``torch.nn.functional.rms_norm`` (its autograd backward for the
    backward; the weight cast to x's dtype first, which that call needs).
    Where the plan takes the register route, the two-pass kernel is held
    to the plain forward on the same input and timed beside it. Returns
    {"fwd": row[, "bwd": row]}."""
    import importlib
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.device import sm_count
    RN = importlib.import_module("paddle_tpu_torch.kernels.rms_norm")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((n, d), generator=gen, device=dev).to(x_dtype)
    w = (1 + 0.1 * torch.randn(d, generator=gen, device=dev)).to(w_dtype)
    gout = torch.randn((n, d), generator=gen, device=dev).to(x_dtype)
    eps = 1e-6
    xx, ww = (t.clone().requires_grad_(backward) for t in (x, w))
    out = RN.rms_norm(xx, ww, eps)
    ref_out, rstd = RN.rms_norm_fwd_plain(x, w, eps)
    errs = {"fwd": hold(f"{name} out", out, ref_out, 1e-5)}
    if backward:
        out.backward(gout)
        ref_dx, ref_dw = RN.rms_norm_bwd_plain(x, w, rstd, gout)
        errs["bwd"] = max(hold(f"{name} dx", xx.grad, ref_dx, 1e-5),
                          hold(f"{name} dw", ww.grad, ref_dw, 1e-4))
        check(torch.equal(RN._bwd_cuda(x, w, rstd, gout)[1],
                          RN._bwd_cuda(x, w, rstd, gout)[1]),
              f"{name}: dw differs between two runs")
    torch.cuda.synchronize()
    wl = w.to(x_dtype)
    xl, wlg = (t.detach().requires_grad_(True) for t in (x, wl))
    lib_out = F.rms_norm(xl, (d,), wlg, eps)
    route = route_taken(lambda: RN.rms_norm.launches_by_route,
                        lambda: RN._fwd_cuda(x, w, eps))
    plan = RN._fwd_plan(n, d, x_dtype, True, sm_count(dev))
    check(route == plan.route, f"{name}: forward took route {route}, its "
          f"plan {plan}")
    log(f"  {name} fwd: route {route} {plan}")
    if backward:
        bwd_route = route_taken(lambda: RN.rms_norm.launches_bwd_by_route,
                                lambda: RN._bwd_cuda(x, w, rstd, gout))
        bwd_plan = RN._bwd_plan(n, d, x_dtype, True, sm_count(dev))
        check(bwd_route == bwd_plan.route, f"{name}: backward took route "
              f"{bwd_route}, its plan {bwd_plan}")
        log(f"  {name} bwd: route {bwd_route} {bwd_plan}")
    ix, iw = x.element_size(), w.element_size()
    # bytes: every input read once, every output written once; operations:
    # fp32, 4 per element forward (x*x, its sum, *rstd, *w), 9 backward
    work = {"fwd": (2 * n * d * ix + d * iw + n * 4, 4 * n * d,
                    lambda: RN._fwd_cuda(x, w, eps),
                    lambda: RN.rms_norm_fwd_plain(x, w, eps),
                    lambda: F.rms_norm(x, (d,), wl, eps)),
            "bwd": (3 * n * d * ix + n * 4 + 2 * d * iw, 9 * n * d,
                    lambda: RN._bwd_cuda(x, w, rstd, gout),
                    lambda: RN.rms_norm_bwd_plain(x, w, rstd, gout),
                    lambda: torch.autograd.grad(lib_out, (xl, wlg), gout,
                                                retain_graph=True))}
    rows = {}
    for which in errs:
        nbytes, flops, kern, plain, lib = work[which]
        b_ms, b_by = bound(nbytes, flops, "fp32")
        rows[which] = {"case": name, "max_abs_err": errs[which],
                       "ms": cuda_ms(kern), "plain_ms": cuda_ms(plain),
                       "library_ms": cuda_ms(lib), "bound_ms": b_ms,
                       "bound_by": b_by}
        r = rows[which]
        log(f"  {name} {which}: max_abs_err {r['max_abs_err']:.3g}  kernel "
            f"{r['ms']:.4f} ms  plain {r['plain_ms']:.4f} ms  F.rms_norm "
            f"{r['library_ms']:.4f} ms  bound {b_ms:.4f} ms ({b_by})")
    rows["fwd"]["route"] = route
    # practical floors beside the bounds, PyTorch calls that move the same
    # bytes: a copy of x (x read, out written) for the forward, x + g into
    # a buffer (x and g read, dx written) for the backward
    rows["fwd"]["copy_ms"] = cuda_ms(lambda: x.clone())
    log(f"  {name} fwd: x.clone() {rows['fwd']['copy_ms']:.4f} ms")
    if backward:
        buf = torch.empty_like(x)
        rows["bwd"]["route"] = bwd_route
        rows["bwd"]["add_ms"] = cuda_ms(lambda: torch.add(x, gout, out=buf))
        log(f"  {name} bwd: torch.add(x, g, out=buf) "
            f"{rows['bwd']['add_ms']:.4f} ms")
        if bwd_route == "registers":
            bwd_alts(name, rows["bwd"], x, w, rstd, gout, ref_dx, ref_dw,
                     bwd_plan)
    # both forward routes' rstd, and the two-pass kernel (the route of
    # other row lengths and alignments) on this input, held and timed
    alts = {route: None}
    if route == "registers":
        alts["two_pass"] = RN._FwdPlan("two_pass", vec=True)
    for alt_route, alt in alts.items():
        got, got_rstd = RN._fwd_cuda(x, w, eps, alt)
        hold(f"{name} {alt_route} out", got, ref_out, 1e-5)
        hold(f"{name} {alt_route} rstd", got_rstd, rstd, 1e-5)
    if route == "registers":
        rows["fwd"]["two_pass_ms"] = cuda_ms(
            lambda: RN._fwd_cuda(x, w, eps, alts["two_pass"]))
        log(f"  {name} fwd: two-pass kernel {rows['fwd']['two_pass_ms']:.4f}"
            f" ms, held to plain")
    return rows


def bwd_alts(name, row, x, w, rstd, gout, ref_dx, ref_dw, plan):
    """Beside a backward on the register route: the two-pass kernel (the
    route of other row lengths and alignments) and the register route on
    each other split of the row its registers allow, each held to the
    plain backward and timed on the same input."""
    import importlib
    RN = importlib.import_module("paddle_tpu_torch.kernels.rms_norm")
    v = 16 // x.element_size()
    steps = plan.vpl * plan.wpr
    alts = {"two_pass": RN._BwdPlan("two_pass", vec=True)}
    for wpr in (1, 2, 4, 8):
        vpl = steps // wpr
        if steps % wpr == 0 and vpl * (8 + 2 * v) <= max(RN._BWD_REGS) \
                and wpr != plan.wpr:
            alts[f"registers {vpl}x{wpr}"] = RN._BwdPlan("registers", vpl=vpl,
                                                         wpr=wpr)
    row["alt_ms"] = {}
    for label, alt in alts.items():
        dx, dw = RN._bwd_cuda(x, w, rstd, gout, alt)
        hold(f"{name} {label} dx", dx, ref_dx, 1e-5)
        hold(f"{name} {label} dw", dw, ref_dw, 1e-4)
        row["alt_ms"][label] = cuda_ms(
            lambda: RN._bwd_cuda(x, w, rstd, gout, alt))
        log(f"  {name} bwd: {label} (vectors x warps a row) "
            f"{row['alt_ms'][label]:.4f} ms, held to plain")
    row["two_pass_ms"] = row["alt_ms"]["two_pass"]


def rope_case(name, B, S, H, D, seed):
    """One bf16 RoPE case: the public ``apply_rope`` Function and its
    gradient against the plain rotation by theta and by -theta, then the
    kernel timed alone in both directions beside the plain version. No
    single PyTorch call applies rotate-half RoPE: no library time."""
    import importlib
    import torch
    RP = importlib.import_module("paddle_tpu_torch.kernels.rope")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    x, gout = (torch.randn((B, S, H, D), generator=gen, device=dev)
               .to(torch.bfloat16) for _ in range(2))
    cos, sin = RP.rope_cos_sin(S, D, device=dev)
    neg = -sin
    xx = x.clone().requires_grad_(True)
    out = RP.apply_rope(xx, cos, sin)
    out.backward(gout)
    torch.cuda.synchronize()
    errs = {"fwd": hold(f"{name} out", out, RP.apply_rope_plain(x, cos, sin),
                        1e-5),
            "bwd": hold(f"{name} dx", xx.grad,
                        RP.apply_rope_plain(gout, cos, neg), 1e-5)}
    # bytes: x read, out written, the two fp32 tables read; 3 fp32
    # operations per element
    nbytes = 2 * x.numel() * x.element_size() + 2 * S * D * 4
    b_ms, b_by = bound(nbytes, 3 * x.numel(), "fp32")
    work = {"fwd": (lambda: RP._rope_cuda(x, cos, sin, 1.0),
                    lambda: RP.apply_rope_plain(x, cos, sin)),
            "bwd": (lambda: RP._rope_cuda(gout, cos, sin, -1.0),
                    lambda: RP.apply_rope_plain(gout, cos, neg))}
    rows = []
    for which, (kern, plain) in work.items():
        r = {"case": f"{name} {which}", "max_abs_err": errs[which],
             "ms": cuda_ms(kern), "plain_ms": cuda_ms(plain),
             "library_ms": None, "bound_ms": b_ms, "bound_by": b_by}
        log(f"  {r['case']}: max_abs_err {r['max_abs_err']:.3g}  kernel "
            f"{r['ms']:.4f} ms  plain {r['plain_ms']:.4f} ms  bound "
            f"{b_ms:.4f} ms ({b_by})")
        rows.append(r)
    # a practical floor: PyTorch's copy of x, the bytes of x read and out
    # written (the tables are small beside them)
    copy_ms = cuda_ms(lambda: x.clone())
    for r in rows:
        r["copy_ms"] = copy_ms
    log(f"  {name}: x.clone() {copy_ms:.4f} ms")
    return rows


# ---------------------------------------------------------------------------
# phases 8-9 and 11-12: the training step
# ---------------------------------------------------------------------------

PEAK_BF16 = PEAK_FLOPS["bf16"]


def train_flops_per_step(cfg, batch, seq):
    """``bench.py:_train_flops_per_step``: 6 N per token plus the causal
    attention term 6 L E S."""
    from paddle_tpu_torch.models.llama import num_params
    return batch * seq * (6 * num_params(cfg)
                          + 6 * cfg.num_hidden_layers * cfg.hidden_size * seq)


# the port's kernels by the names the profiler prints (paged attention, the
# int8 matmul, dq and the RMSNorm forward and backward: every route's
# kernels summed)
PORT_KERNELS = ("paged_attention", "weight_only_matmul",
                "flash_fwd_kernel", "flash_bwd_dq",
                "flash_bwd_dkv_kernel", "rms_norm_fwd",
                "rms_norm_bwd", "rms_norm_dw_kernel", "rope_kernel")


def profile_device(run, label, top=6):
    """Run ``run()`` under ``torch.profiler``: the wall time, the device
    time of every kernel (CUPTI) and its share of the wall time, the time
    of PyTorch's elementwise kernels and of each of the port's kernels,
    the kernels that took the most device time, and the host ops that
    took the most self CPU time (ms and calls; the profiler's own cost
    included)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3
    kernels = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            name = e.key
            for short in PORT_KERNELS:
                if short in name:
                    name = short
            # summed by the printed (60-character) name: instantiations of
            # one PyTorch kernel template share it
            name = name[:60]
            kernels[name] = kernels.get(name, 0.0) + e.self_device_time_total
    host = sorted(((e.key, e.self_cpu_time_total / 1e3, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CPU),
                  key=lambda r: -r[1])[:top]
    busy_ms = sum(kernels.values()) / 1e3
    # PyTorch's own elementwise kernels (casts, norms and RoPE on the plain
    # route, SiLU, AdamW's passes, the CE), summed
    elementwise_ms = sum(v for k, v in kernels.items()
                         if "elementwise_kernel" in k) / 1e3
    out = {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
           "device_busy_share": busy_ms / wall_ms,
           "elementwise_ms": elementwise_ms,
           "port_kernels_ms": {k: kernels[k] / 1e3 for k in PORT_KERNELS
                               if k in kernels},
           "top_kernels_ms": {k: v / 1e3 for k, v in sorted(
               kernels.items(), key=lambda kv: -kv[1])[:top]},
           "top_host_ops_ms_calls": {k: [ms, n] for k, ms, n in host}}
    if busy_ms == 0:
        out = {"wall_ms": wall_ms, "device_busy_ms": "not measured "
               "(the profiler saw no device events)"}
    log(f"  profiled {label}: {json.dumps(out)}")
    return out


def train_config(dtype, **kw):
    """The phase 4 model (``bench.py:_presets("tpu")``, lines 68-74) as
    the repository's TPU training benchmark runs it: flash kernels, full
    remat, fp32 params."""
    from paddle_tpu_torch.models.llama import LlamaConfig
    import torch
    base = dict(vocab_size=32000, hidden_size=2048, intermediate_size=5504,
                num_hidden_layers=12, num_attention_heads=16,
                num_key_value_heads=16, max_position_embeddings=2048,
                use_kernels=True, remat=True, dtype=dtype,
                param_dtype=torch.float32)
    base.update(kw)
    return LlamaConfig(**base)


def expected_launches(cfg):
    """Kernel launches per training step. Full non-reentrant remat: every
    layer's forward runs twice (the forward, then its recompute just
    before its backward), the final norm once, each backward once. Under
    ``"save_flash"`` the flash forward and the q/k RoPE run once (their
    outputs are kept); the backward still runs both of a layer's norms
    again (the attention norm for the projections' gradients, the MLP
    norm in the tail's recompute)."""
    L = cfg.num_hidden_layers
    once = cfg.remat_policy == "save_flash"
    want = {"flash_attention": (1 if once else 2) * L,
            "flash_attention_bwd_dq": L, "flash_attention_bwd_dkv": L}
    if cfg.use_fused_norm:
        want.update({"rms_norm": 2 * (2 * L) + 1, "rms_norm_bwd": 2 * L + 1,
                     "apply_rope": (1 if once else 2) * (2 * L),
                     "apply_rope_bwd": 2 * L})
    return want


def train_phase(steps=4, batch=8, seq=2048, **cfg_kw):
    """Phases 8 and 11: one warm-up step, ``steps`` timed steps with the
    launch counters set to 0 just before them, one profiled step."""
    import torch
    from paddle_tpu_torch.models.llama import init_params, make_train_step
    cfg = train_config(torch.bfloat16, **cfg_kw)
    params = init_params(cfg, seed=SEED, device="cuda")
    init_opt, step = make_train_step(cfg, lr=1e-4)
    opt = init_opt(params)
    ids = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (batch, seq))).cuda()
    params, opt, loss = step(params, opt, ids, ids)
    losses = [loss.item()]
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    times = []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.time()
        params, opt, loss = step(params, opt, ids, ids)
        losses.append(loss.item())
        times.append(time.time() - t0)
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    step_s = float(np.median(times))
    flops = train_flops_per_step(cfg, batch, seq)
    per_step = {k: v / steps for k, v in counts.items() if v}
    m = {"step_ms": step_s * 1e3, "step_ms_each": [t * 1e3 for t in times],
         "tokens_per_s": batch * seq / step_s,
         "mfu": flops / step_s / PEAK_BF16, "flops_per_step": flops,
         "max_memory_allocated_gb": peak / 2 ** 30, "losses": losses,
         "launches_per_step": per_step}
    log(f"  {json.dumps(m)}")
    check(all(np.isfinite(losses)), f"non-finite loss {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    want = expected_launches(cfg)
    check(per_step == want, f"launches per step {per_step}, expected {want}")
    prof = profile_device(lambda: step(params, opt, ids, ids),
                          "training step", top=10)
    m["profile"] = prof
    port = prof.get("port_kernels_ms", {})
    log(f"  device ms in the profiled step: flash_bwd_dq "
        f"{port.get('flash_bwd_dq')}, rms_norm_fwd "
        f"{port.get('rms_norm_fwd')}, rms_norm_bwd "
        f"{port.get('rms_norm_bwd')}, rms_norm_dw_kernel "
        f"{port.get('rms_norm_dw_kernel')}")
    return m, counts


def parity_phase(knob, **kw):
    """Phases 9, 12 and 19: fp32, the path with ``knob`` (``use_kernels``:
    the flash kernels; ``use_fused_norm``: the fused norm and RoPE
    kernels) on against the same path with it off; ``kw`` changes the
    config further (phase 19: MoE)."""
    import torch
    from paddle_tpu_torch.models.llama import (_leaves, init_params,
                                               loss_fn, make_train_step)
    cfg = {use: train_config(torch.float32, hidden_size=512,
                             intermediate_size=1376, num_hidden_layers=4,
                             num_attention_heads=8, num_key_value_heads=4,
                             **{knob: use}, **kw)
           for use in (True, False)}
    ids = torch.from_numpy(np.random.default_rng(1).integers(
        0, 32000, (2, 512))).cuda()
    res = {}
    reset_counts()
    for use in (True, False):
        params = init_params(cfg[use], seed=SEED + 2, device="cuda")
        leaves = _leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        loss = loss_fn(params, ids, ids, cfg[use])
        grads = torch.autograd.grad(loss, leaves)
        init_opt, step = make_train_step(cfg[use], lr=1e-3)
        opt = init_opt(params)
        traj = []
        for _ in range(3):
            params, opt, l_ = step(params, opt, ids, ids)
            traj.append(l_.item())
        res[use] = (loss.item(), grads, traj)
    (lk, gk, tk), (lp, gp, tp) = res[True], res[False]
    rel = abs(lk - lp) / abs(lp)
    worst = max(((a - b).abs().max() / b.abs().max()).item()
                for a, b in zip(gk, gp))
    traj_rel = max(abs(a - b) / abs(b) for a, b in zip(tk, tp))
    log(f"  {knob} on/off: loss {lk:.8f} / {lp:.8f} (rel {rel:.3g}); worst "
        f"gradient leaf max|diff|/max|g| {worst:.3g}; 3-step losses "
        f"{tk} / {tp} (max rel {traj_rel:.3g})")
    check(rel <= 1e-5, f"fp32 loss {knob} on vs off rel {rel}")
    check(worst <= 1e-4, f"fp32 gradient {knob} on vs off {worst}")
    check(traj_rel <= 1e-4, f"fp32 3-step losses rel {traj_rel}")
    return {"loss_rel": rel, "grad_worst": worst, "traj_rel": traj_rel,
            "launches": read_counts()}


# ---------------------------------------------------------------------------
# phases 4-6: the serving engine
# ---------------------------------------------------------------------------

def model_config(dtype, **kw):
    """``bench.py:_presets("tpu")`` (lines 68-74): the model the repo's
    own TPU benchmark serves."""
    from paddle_tpu_torch.models.llama import LlamaConfig
    import torch
    return LlamaConfig(vocab_size=32000, hidden_size=2048,
                       intermediate_size=5504, num_hidden_layers=12,
                       num_attention_heads=16, num_key_value_heads=16,
                       max_position_embeddings=2048, dtype=dtype,
                       param_dtype=torch.float32, **kw)


def first_dispatch(params, cfg, prompts, B=4, W=16):
    """One batched ``paged_prefill`` of the first ``B`` prompts (cut to 120
    tokens) into a fresh pool: (logits, pool, greedy tokens, the decode
    operands ``(seq_lens, tables, active)``, the MoE drop count)."""
    import torch
    from paddle_tpu_torch.models import generation as G
    pool = G.init_paged_pool(cfg, 1 + B * W, 16, device="cuda")
    ids = np.zeros((B, 128), np.int32)
    plens = np.array([len(p[:120]) for p in prompts[:B]], np.int32)
    for b in range(B):
        ids[b, :plens[b]] = prompts[b][:120]
    tbl = torch.arange(1, 1 + B * W, dtype=torch.int32,
                       device="cuda").reshape(B, W)
    act = torch.ones(B, dtype=torch.bool, device="cuda")
    sl = torch.from_numpy(plens).cuda()
    logits, pool, drops = G.paged_prefill(params, cfg,
                                          torch.from_numpy(ids).cuda(), sl,
                                          tbl, pool, act)
    return (logits, pool, logits.argmax(-1).to(torch.int32), (sl, tbl, act),
            drops)


def make_trace(n, vocab, seed, long_len=600, lens=(32, 200), outs=(16, 64)):
    """``n`` greedy requests: half share a 64-token prefix, prompt lengths
    in ``lens``, one ``long_len``-token prompt, outputs in ``outs``."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab, size=64)
    prompts, news = [], []
    for i in range(n):
        L = int(rng.integers(lens[0], lens[1] + 1))
        if i == n // 3:
            L = long_len
        body = rng.integers(0, vocab, size=L)
        if i % 2 == 0 and L > 64:
            body[:64] = prefix
        prompts.append(body.astype(np.int32))
        news.append(int(rng.integers(outs[0], outs[1] + 1)))
    return prompts, news


_DRIVE_COUNTERS = ("prefill_dispatches", "decode_dispatches",
                   "mixed_dispatches", "spec_dispatches", "decode_iters",
                   "chunks", "steps", "prefix_hit_tokens", "preemptions",
                   "spec_drafted", "spec_accepted")


def drive(engine, prompts, news, knobs=None, max_iters=None):
    """Submit the whole trace (request i with the submit arguments
    ``knobs[i]``: sampling knobs and seed), drain it with
    ``step(max_iters)``, return (outputs, metrics). The counters and
    dispatch times are this drain's alone (the engine may have served a
    warm-up before)."""
    import torch
    knobs = knobs or [{}] * len(prompts)
    st0 = engine.stats()
    torch.cuda.synchronize()
    t0 = time.time()
    rids = [engine.submit(p, max_new_tokens=m, eos_token_id=None, **k)
            for p, m, k in zip(prompts, news, knobs)]
    while engine.pending:
        engine.step(max_iters)
    torch.cuda.synchronize()
    wall = time.time() - t0
    reqs = [engine.request(r) for r in rids]
    for r, m in zip(reqs, news):
        check(r.state == "finished" and len(r.tokens) == m,
              f"request {r.rid} ended {r.state} with {len(r.tokens)}/{m}")
    st = engine.stats()
    check(st["blocks_in_use"] == 0, f"{st['blocks_in_use']} blocks leaked")
    d = {k: st[k] - st0[k] for k in _DRIVE_COUNTERS}
    secs = {k: st["dispatch_s"][k] - st0["dispatch_s"][k]
            for k in st["dispatch_s"]}
    gen = sum(len(r.tokens) for r in reqs)
    ttft = [r.ttft_s for r in reqs]
    metrics = {"wall_s": wall, "tokens": gen, "tok_s": gen / wall,
               "ttft_p50_s": float(np.percentile(ttft, 50)),
               "ttft_p99_s": float(np.percentile(ttft, 99)),
               "ttft_max_s": float(max(ttft)),
               "ms_per_decode_step": (secs["decode"] * 1e3
                                      / max(1, d["decode_iters"])),
               "ms_per_mixed_dispatch": (secs["mixed"] * 1e3
                                         / max(1, d["mixed_dispatches"])),
               "ms_per_spec_dispatch": (secs["spec"] * 1e3
                                        / max(1, d["spec_dispatches"])),
               "acceptance": d["spec_accepted"] / max(1, d["spec_drafted"]),
               **d}
    return [np.asarray(r.tokens) for r in reqs], metrics


def profile_drain(engine, prompts, news, knobs=None, max_iters=None):
    """Drain a short trace under ``torch.profiler`` (``profile_device``),
    with ``drive``'s ``knobs`` and ``max_iters``."""
    for p, m, k in zip(prompts, news, knobs or [{}] * len(prompts)):
        engine.submit(p, max_new_tokens=m, eos_token_id=None, **k)

    def drain():
        while engine.pending:
            engine.step(max_iters)

    return profile_device(drain, f"drain of {len(prompts)} requests")


# ---------------------------------------------------------------------------
# phases 13-15: sampled and speculative serving
# ---------------------------------------------------------------------------

SAMPLED = dict(temperature=0.8, top_k=50, top_p=0.95)


def sampled_knobs(n):
    """Request i samples with ``SAMPLED`` and ``seed=i``."""
    return [dict(SAMPLED, seed=i) for i in range(n)]


def sampler_case(B, V, seed):
    """The per-row sampler at ``[B, V]`` (phase 13's knobs, keys folded
    on the host beforehand) beside the greedy ``argmax`` it replaces, per
    call: CUDA-event ms (``cuda_ms``; the sampler's ~200 launches outlast
    the spin before it, so this includes the host's enqueue), the
    host's wall ms (enqueue to synchronize, what a decode iteration waits
    for), and the device time of its kernels alone (CUPTI, summed over 20
    profiled calls)."""
    import torch
    from paddle_tpu_torch import prng
    from paddle_tpu_torch.models import generation as G
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    lg = torch.randn((B, V), generator=g, device=dev) * 2
    keys = prng.fold_in(torch.stack([G.seed_key(i) for i in range(B)]),
                        5).to(dev)
    temp = torch.full((B,), SAMPLED["temperature"], device=dev)
    topk = torch.full((B,), SAMPLED["top_k"], dtype=torch.int32, device=dev)
    topp = torch.full((B,), SAMPLED["top_p"], device=dev)

    def sample():
        return G.sample_tokens(lg, keys, temp, topk, topp)

    def argmax():
        return torch.argmax(lg, dim=-1)

    row = {"rows": B, "vocab": V,
           "sample_event_ms": cuda_ms(sample, iters=20),
           "argmax_event_ms": cuda_ms(argmax, iters=20)}
    for name, fn in (("sample_wall_ms", sample), ("argmax_wall_ms", argmax)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            fn().cpu()
        row[name] = (time.perf_counter() - t0) * 1e3 / 20
    for name, fn in (("sample_kernel_ms", sample), ("argmax_kernel_ms",
                                                    argmax)):
        prof = profile_device(lambda: [fn() for _ in range(20)],
                              f"20 calls of {name[:-10]} [{B}, {V}]", top=3)
        row[name] = prof["device_busy_ms"] / 20
    log(f"  sampler [{B}, {V}] per call: kernels {row['sample_kernel_ms']:.4f}"
        f" ms, CUDA events (host enqueue included) "
        f"{row['sample_event_ms']:.4f} ms, wall {row['sample_wall_ms']:.4f}"
        f" ms; argmax kernels {row['argmax_kernel_ms']:.4f} ms, events "
        f"{row['argmax_event_ms']:.4f} ms, wall {row['argmax_wall_ms']:.4f}"
        f" ms")
    return row


def quoting_prompts(new_engine, vocab, seed, n, tries=8):
    """``n`` prompts, each a random 24-96-token segment repeated 2-3 times
    (a prompt that quotes itself, the traffic prompt-lookup decoding
    serves), whose segment starts with the model's greedy next token
    after the whole prompt: the model's first token continues the quote,
    so with ``spec_ngram`` 2 the drafter proposes at the first decode step
    (random weights do not copy by themselves). Found by a fixed-point
    search: set the segment's first token to the greedy next token of the
    prompt and ask again (``new_engine()``: a fresh engine, speculation
    off), until it stays or ``tries`` run out. Returns (prompts, how many
    reached their fixed point)."""
    rng = np.random.default_rng(seed)
    segs = [rng.integers(0, vocab, size=int(rng.integers(24, 97)))
            for _ in range(n)]
    reps = [int(rng.integers(2, 4)) for _ in range(n)]
    fixed = [False] * n
    for _ in range(tries):
        prompts = [np.tile(sg, r).astype(np.int32)
                   for sg, r in zip(segs, reps)]
        firsts = new_engine().run(prompts, max_new_tokens=1,
                                  eos_token_id=None)
        fixed = [int(sg[0]) == int(f[0]) for sg, f in zip(segs, firsts)]
        if all(fixed):
            break
        for sg, f in zip(segs, firsts):
            sg[0] = int(f[0])
    return prompts, sum(fixed)


def spec_trace(params, cfg, vocab, seed, n=24):
    """Phase 14's trace: half self-quoting prompts (``quoting_prompts``),
    half self-continuation prompts (a random 16-32-token base plus the
    model's own greedy stream of 32 tokens, computed first with
    speculation off), interleaved; outputs of 32-64 tokens."""
    from paddle_tpu_torch.inference.serving import (ServingConfig,
                                                    ServingEngine)

    def new_engine():
        return ServingEngine(params, cfg, ServingConfig(), device="cuda")

    rng = np.random.default_rng(seed)
    quoting, fixed = quoting_prompts(new_engine, vocab, seed + 1, n // 2)
    bases = [rng.integers(0, vocab, size=int(rng.integers(16, 33)))
             .astype(np.int32) for _ in range(n - n // 2)]
    streams = new_engine().run(bases, max_new_tokens=32, eos_token_id=None)
    cont = [np.concatenate([b, s]).astype(np.int32)
            for b, s in zip(bases, streams)]
    prompts = [p for pair in zip(quoting, cont) for p in pair]
    news = [int(rng.integers(32, 65)) for _ in prompts]
    log(f"  trace: {len(quoting)} self-quoting prompts ({fixed} at their "
        f"fixed point), {len(cont)} self-continuation prompts, prompt "
        f"lengths {min(map(len, prompts))}-{max(map(len, prompts))}, "
        f"outputs {min(news)}-{max(news)}")
    return prompts, news


def sampled_phase(params, cfg, prompts, news, greedy):
    """Phase 13: phase 4's trace drained greedy, sampled, sampled, greedy,
    each on a fresh engine after phase 4's warm-up request, then a
    profiled sampled drain of phase 4's profiling trace. Returns (the
    first sampled drain's metrics, with every drain's tokens/s and ms per
    decode iteration in turn, the sampler's times and the profile; its
    launches)."""
    import torch
    from paddle_tpu_torch.inference.serving import (ServingConfig,
                                                    ServingEngine)
    knobs = sampled_knobs(len(prompts))
    sampled, turns = [], []
    for kind in ("greedy", "sampled", "sampled", "greedy"):
        engine = ServingEngine(params, cfg, ServingConfig(), device="cuda")
        engine.run([prompts[0][:40]], max_new_tokens=4, eos_token_id=None)
        reset_counts()
        out, m = drive(engine, prompts, news,
                       knobs if kind == "sampled" else None)
        turns.append([kind, m["tok_s"], m["ms_per_decode_step"],
                      m["ms_per_mixed_dispatch"]])
        if kind == "sampled":
            if not sampled:
                counts, metrics = read_counts(), m
            sampled.append(out)
        del engine
        torch.cuda.empty_cache()
    check(counts["paged_attention"] - counts["paged_attention_multiquery"] > 0
          and counts["paged_attention_multiquery"] > 0,
          f"sampled drain launches {counts}")
    for i, (a, b) in enumerate(zip(*sampled)):
        check(np.array_equal(a, b), f"request {i}: sampled stream {a} "
              f"not repeated on a fresh engine ({b})")
    same = sum(np.array_equal(a, b) for a, b in zip(sampled[0], greedy))
    check(same <= len(prompts) // 2,
          f"{same} of {len(prompts)} sampled streams equal the greedy ones")
    log(f"  {json.dumps(metrics)}")
    log(f"  launches: {json.dumps(counts)}")
    log(f"  streams repeated on a fresh engine; {same} of {len(prompts)} "
        f"equal to phase 4's greedy streams")
    log("  in turns [kind, tok/s, ms per decode iteration, ms per mixed "
        f"dispatch]: {json.dumps(turns)}")
    metrics["turns"] = turns
    metrics["sampler"] = [sampler_case(8, cfg.vocab_size, 51),
                          sampler_case(40, cfg.vocab_size, 52)]
    engine = ServingEngine(params, cfg, ServingConfig(), device="cuda")
    engine.run([prompts[0][:40]], max_new_tokens=4, eos_token_id=None)
    fresh = make_trace(8, cfg.vocab_size, SEED + 2)
    metrics["profile"] = profile_drain(engine, *fresh,
                                       knobs=sampled_knobs(8))
    del engine
    torch.cuda.empty_cache()
    return metrics, counts


def divergence_margins(params, cfg, prompts, off, on):
    """Where bf16 streams with speculation on and off part: for each such
    stream, the first position j where they differ, the two tokens a
    (off) and b (on), and at their shared context (prompt + off[:j]) the
    plain bf16 forward's last logits beside an fp32 forward's on the same
    bf16-rounded weights. eps = max |l16 - l32| over that row is what
    bf16 rounding moves a logit there; two routes that each round within
    eps can pick a over b and b over a only if |l32[a] - l32[b]| <= 2 eps.
    A larger gap fails the run: it is a fault of the verify or decode
    route, not rounding. Returns [j, a, b, l32[a] - l32[b], eps, the bf16
    top-2 gap] per diverging stream."""
    import dataclasses
    import torch
    from paddle_tpu_torch.models.llama import forward
    c16 = dataclasses.replace(cfg, use_kernels=False, use_fused_norm=False)
    c32 = dataclasses.replace(c16, dtype=torch.float32)

    def rounded(t):
        if isinstance(t, dict):
            return {k: rounded(v) for k, v in t.items()}
        return t.to(torch.bfloat16).to(torch.float32)

    p32 = rounded(params)
    rows = []
    for p, a_s, b_s in zip(prompts, off, on):
        if np.array_equal(a_s, b_s):
            continue
        j = int(np.argmax(a_s != b_s))
        ctx = torch.from_numpy(np.concatenate([p, a_s[:j]]).astype(np.int64)
                               )[None].cuda()
        with torch.no_grad():
            l16 = forward(params, ctx, c16)[0, -1].float()
            l32 = forward(p32, ctx, c32)[0, -1].float()
        a, b = int(a_s[j]), int(b_s[j])
        top2 = torch.topk(l16, 2).values
        rows.append([j, a, b, float(l32[a] - l32[b]),
                     float((l16 - l32).abs().max()),
                     float(top2[0] - top2[1])])
    del p32
    torch.cuda.empty_cache()
    log("  diverging streams [first position, token off, token on, fp32 "
        f"logit gap off - on, bf16 rounding eps, bf16 top-2 gap]: "
        f"{json.dumps(rows)}")
    for j, a, b, gap, eps, _ in rows:
        check(abs(gap) <= 2 * eps, f"spec on/off part at position {j} "
              f"({a} vs {b}) with fp32 logit gap {gap} > 2 x bf16 eps {eps}")
    return rows


def spec_phase(params, cfg):
    """Phase 14: ``spec_trace`` with speculation off, then on, each on a
    fresh engine after one warm-up request, stepped at ``decode_chunk``
    iterations; every stream where the two part is held to bf16 rounding
    (``divergence_margins``). Returns ({0: metrics, 4: metrics,
    "equal_streams": n, "divergences": rows}, the speculative drain's
    launches)."""
    import torch
    from paddle_tpu_torch.inference.serving import (ServingConfig,
                                                    ServingEngine)
    prompts, news = spec_trace(params, cfg, cfg.vocab_size, SEED + 14)
    cadence = ServingConfig().decode_chunk      # a streaming client's steps
    metrics, outs = {}, {}
    for spec in (0, 4):
        engine = ServingEngine(params, cfg, ServingConfig(
            spec_decode=spec, spec_ngram=2), device="cuda")
        engine.run([prompts[0][:40]], max_new_tokens=4, eos_token_id=None)
        reset_counts()
        outs[spec], metrics[spec] = drive(engine, prompts, news,
                                          max_iters=cadence)
        metrics[spec]["launches"] = read_counts()
        del engine
        torch.cuda.empty_cache()
    counts = metrics[4]["launches"]
    check(metrics[4]["spec_dispatches"] > 0, "no verify dispatch fired")
    check(counts["paged_attention_multiquery"]
          >= cfg.num_hidden_layers * metrics[4]["spec_dispatches"],
          f"{counts['paged_attention_multiquery']} multi-query launches for "
          f"{metrics[4]['spec_dispatches']} verify dispatches (one a layer)")
    equal = sum(np.array_equal(a, b) for a, b in zip(outs[0], outs[4]))
    for spec in (0, 4):
        log(f"  spec_decode={spec}: {json.dumps(metrics[spec])}")
    log(f"  {equal} of {len(prompts)} streams equal between spec on and off")
    metrics["equal_streams"] = equal
    metrics["divergences"] = divergence_margins(params, cfg, prompts,
                                                outs[0], outs[4])
    engine = ServingEngine(params, cfg, ServingConfig(
        spec_decode=4, spec_ngram=2), device="cuda")
    engine.run([prompts[0][:40]], max_new_tokens=4, eos_token_id=None)
    metrics["profile"] = profile_drain(engine, prompts[:8], news[:8],
                                       max_iters=cadence)
    del engine
    torch.cuda.empty_cache()
    return metrics, counts


def sampled_spec_parity_phase(params, cfg, prompts, news):
    """Phase 15 at fp32: sampled streams equal between the kernel and
    gather engines; speculation on and off equal, greedy and sampled, on
    self-quoting prompts (the greedy run verifies and accepts at least
    once). Sampling breaks the quotes the n-gram drafter feeds on, so the
    sampled verify is also driven by a drafter that proposes the spec-off
    stream's own continuation: it must verify, accept every draft and
    give the spec-off streams, which holds only when verify position q
    draws with the key of index ``len(req.tokens) + q``."""
    import torch
    from paddle_tpu_torch.inference.serving import (ServingConfig,
                                                    ServingEngine)
    knobs = sampled_knobs(len(prompts))
    streams = {}
    for knob in ("on", "off"):
        eng = ServingEngine(params, cfg, ServingConfig(paged_kernel=knob),
                            device="cuda")
        streams[knob], _ = drive(eng, prompts, news, knobs)
        del eng
        torch.cuda.empty_cache()
    for i, (a, b) in enumerate(zip(streams["on"], streams["off"])):
        check(np.array_equal(a, b), f"request {i}: sampled kernel stream "
              f"{a} != gather stream {b}")
    log(f"  {len(prompts)} sampled fp32 streams equal between the kernel and "
        f"gather engines")
    qp, fixed = quoting_prompts(
        lambda: ServingEngine(params, cfg, ServingConfig(), device="cuda"),
        cfg.vocab_size, SEED + 15, 8)
    qn = [16] * len(qp)
    cadence = ServingConfig().decode_chunk
    for name, kn in (("greedy", None), ("sampled", sampled_knobs(len(qp)))):
        got = {}
        for spec in (0, 4):
            eng = ServingEngine(params, cfg, ServingConfig(
                spec_decode=spec, spec_ngram=2), device="cuda")
            got[spec] = drive(eng, qp, qn, kn, max_iters=cadence)
            del eng
            torch.cuda.empty_cache()
        for i, (a, b) in enumerate(zip(got[0][0], got[4][0])):
            check(np.array_equal(a, b), f"{name} request {i}: spec stream "
                  f"{b} != non-spec stream {a}")
        m = got[4][1]
        if name == "greedy":
            check(m["spec_dispatches"] > 0 and m["spec_accepted"] > 0,
                  f"fp32 greedy: {m['spec_dispatches']} verifies, "
                  f"{m['spec_accepted']} accepted")
        log(f"  {name}: {len(qp)} streams equal with spec on and off "
            f"({fixed} of {len(qp)} prompts at their fixed point); verify "
            f"dispatches {m['spec_dispatches']}, drafted "
            f"{m['spec_drafted']}, accepted {m['spec_accepted']}")
    off = {np.asarray(p, np.int32).tobytes(): s
           for p, s in zip(qp, got[0][0])}
    eng = ServingEngine(params, cfg, ServingConfig(spec_decode=4,
                                                   spec_ngram=2),
                        device="cuda")

    def oracle(req):
        k = min(4, int(eng._steps_left[req.slot]) - 1)
        t = len(req.tokens)
        stream = off[np.asarray(req.prompt, np.int32).tobytes()]
        return [int(x) for x in stream[t:t + k]] if k > 0 else []

    eng._draft_tokens = oracle
    outs, m = drive(eng, qp, qn, kn, max_iters=cadence)
    del eng
    torch.cuda.empty_cache()
    for i, (a, b) in enumerate(zip(got[0][0], outs)):
        check(np.array_equal(a, b), f"sampled request {i}: oracle-drafted "
              f"spec stream {b} != non-spec stream {a}")
    check(m["spec_dispatches"] > 0
          and m["spec_accepted"] == m["spec_drafted"] > 0,
          f"fp32 sampled, oracle drafts: {m['spec_dispatches']} verifies, "
          f"{m['spec_drafted']} drafted, {m['spec_accepted']} accepted")
    log(f"  sampled, drafts replaying the spec-off stream: {len(qp)} streams "
        f"equal; verify dispatches {m['spec_dispatches']}, drafted "
        f"{m['spec_drafted']}, accepted {m['spec_accepted']}")


# ---------------------------------------------------------------------------
# phases 16-19: remat policies, the guarded step, MoE
# ---------------------------------------------------------------------------

POLICIES = (None, "nothing", "dots", "dots_saveable", "save_attn",
            "save_qkv_attn", "save_flash", "save_flash_qk",
            "save_flash_only")
# per layer and step, read from the JAX source with use_kernels: (flash
# forwards, wq, wk, wv runs); 2 = the backward runs it again
POLICY_COUNTS = {
    None: (2, 2, 2, 2), "nothing": (2, 2, 2, 2), "dots": (2, 1, 1, 1),
    "dots_saveable": (2, 1, 1, 1), "save_attn": (2, 2, 2, 2),
    "save_qkv_attn": (2, 1, 1, 1), "save_flash": (1, 1, 1, 1),
    "save_flash_qk": (1, 1, 1, 2), "save_flash_only": (1, 2, 2, 2)}


class CountGemms:
    """Counts ``llama._mm`` calls by weight name while active: the dense
    GEMMs a training step runs, its recompute included."""

    def __enter__(self):
        from paddle_tpu_torch.models import llama
        self.llama, self.orig, self.calls = llama, llama._mm, {}
        orig, calls = self.orig, self.calls

        def counted(h, lp, name, dt):
            calls[name] = calls.get(name, 0) + 1
            return orig(h, lp, name, dt)
        llama._mm = counted
        return self

    def __exit__(self, *exc):
        self.llama._mm = self.orig


def policy_run(cfg, ids, steps=2, **step_kw):
    """From the seed's parameters: one warm-up step, then ``steps`` timed
    steps with the launch counters and the GEMM counts set to 0 just
    before them. Returns the metrics (losses: the warm-up step's first)."""
    import torch
    from paddle_tpu_torch.models.llama import init_params, make_train_step
    params = init_params(cfg, seed=SEED, device="cuda")
    init_opt, step = make_train_step(cfg, lr=1e-4, **step_kw)
    opt = init_opt(params)
    params, opt, loss = step(params, opt, ids, ids)
    losses = [loss.item()]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    times = []
    with CountGemms() as g:
        for _ in range(steps):
            torch.cuda.synchronize()
            t0 = time.time()
            params, opt, loss = step(params, opt, ids, ids)
            losses.append(loss.item())
            times.append(time.time() - t0)
    counts = read_counts()
    m = {"step_ms": float(np.median(times)) * 1e3,
         "step_ms_each": [t * 1e3 for t in times],
         "max_memory_allocated_gb": torch.cuda.max_memory_allocated()
         / 2 ** 30, "losses": losses,
         "launches_per_step": {k: v / steps for k, v in counts.items() if v},
         "gemms_per_step": {k: v / steps for k, v in g.calls.items()}}
    del params, opt
    torch.cuda.empty_cache()
    return m


def remat_phase():
    """Phase 16: the nine remat policy values on phase 8's step."""
    import torch
    from paddle_tpu_torch.models.llama import (_leaves, init_params,
                                               loss_fn)
    ids = torch.from_numpy(np.random.default_rng(0).integers(
        0, 32000, (8, 2048))).cuda()
    L = 12
    res = {}
    for pol in POLICIES:
        m = policy_run(train_config(torch.bfloat16, remat_policy=pol), ids)
        res[pol] = m
        flash, wq, wk, wv = POLICY_COUNTS[pol]
        lp, g = m["launches_per_step"], m["gemms_per_step"]
        log(f"  {pol}: step {m['step_ms']:.1f} ms, peak "
            f"{m['max_memory_allocated_gb']:.2f} GB, launches/step "
            f"{json.dumps(lp)}, GEMMs/step {json.dumps(g)}, losses "
            f"{m['losses']}")
        want = {"flash_attention": flash * L, "flash_attention_bwd_dq": L,
                "flash_attention_bwd_dkv": L}
        check(lp == want, f"{pol}: launches per step {lp}, expected {want}")
        got_qkv = (g.get("wq"), g.get("wk"), g.get("wv"))
        check(got_qkv == (wq * L, wk * L, wv * L),
              f"{pol}: q/k/v projections per step {got_qkv}")
        check(all(np.isfinite(m["losses"])), f"{pol}: losses {m['losses']}")
    base = res[None]["losses"][1]
    rels = {}
    for pol in POLICIES:
        got = res[pol]["losses"][1]
        rels[str(pol)] = [abs(got - base) / abs(base), got == base]
        check(rels[str(pol)][0] <= 1e-3,
              f"{pol}: loss after one update {got} vs full remat {base}")
    log(f"  loss after one update vs full remat (rel, bits equal): "
        f"{json.dumps(rels)}")
    turns = []
    for pol in (None, "save_flash", "save_flash", None):
        m = policy_run(train_config(torch.bfloat16, remat_policy=pol), ids)
        turns.append([str(pol), m["step_ms"], m["max_memory_allocated_gb"]])
    log(f"  in turns (policy, step ms, peak GB): {json.dumps(turns)}")
    # fp32 gradients on phase 9's config: every policy against full remat
    small = dict(hidden_size=512, intermediate_size=1376,
                 num_hidden_layers=4, num_attention_heads=8,
                 num_key_value_heads=4)
    sids = torch.from_numpy(np.random.default_rng(1).integers(
        0, 32000, (2, 512))).cuda()
    grads = {}
    for pol in POLICIES:
        cfg = train_config(torch.float32, remat_policy=pol, **small)
        params = init_params(cfg, seed=SEED + 2, device="cuda")
        leaves = _leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        grads[pol] = torch.autograd.grad(loss_fn(params, sids, sids, cfg),
                                         leaves)
    worst = {}
    for pol in POLICIES:
        worst[str(pol)] = max(((a - b).abs().max() / b.abs().max()).item()
                              for a, b in zip(grads[pol], grads[None]))
        check(worst[str(pol)] <= 1e-6,
              f"fp32 gradients {pol} vs full remat {worst[str(pol)]}")
    log(f"  fp32 worst gradient leaf max|diff|/max|g| against full remat: "
        f"{json.dumps(worst)}")
    return res, turns


def tuned_phase():
    """Phase 17: ``bench.py``'s tuned step (save_flash, ce_chunks 16, bf16
    moments and gradients) with and without the sentinel, in interleaved
    blocks, and the NaN-containment probe."""
    import torch
    from paddle_tpu_torch.health import sentinel_init, unpack_health
    from paddle_tpu_torch.models.llama import (_leaves, _tree_map,
                                               init_params, make_train_step)
    bf = torch.bfloat16
    cfg = train_config(bf, remat_policy="save_flash", ce_chunks=16)
    kw = dict(lr=1e-4, opt_dtype=bf, grad_dtype=bf)
    ids = torch.from_numpy(np.random.default_rng(0).integers(
        0, 32000, (8, 2048))).cuda()
    pa = init_params(cfg, seed=SEED, device="cuda")
    pb = _tree_map(lambda t: t.clone(), pa)
    init_opt, step = make_train_step(cfg, **kw)
    _, gstep = make_train_step(cfg, sentinel=True, **kw)
    oa, ob = init_opt(pa), init_opt(pb)
    sent = sentinel_init(device="cuda")
    pa, oa, la = step(pa, oa, ids, ids)
    pb, ob, sent, h = gstep(pb, ob, sent, ids, ids)
    loss_a = la.item()
    loss_b, bad, _ = unpack_health(h)
    same_params = all(torch.equal(x, y)
                      for x, y in zip(_leaves(pa), _leaves(pb)))
    log(f"  clean step: unguarded loss {loss_a!r}, guarded {loss_b!r} (bad "
        f"{bad}); parameters bit-equal after it: {same_params}")
    check(not bad and loss_a == loss_b,
          f"clean guarded step loss {loss_b} != unguarded {loss_a}")
    state = {"a": (pa, oa), "b": (pb, ob, sent)}

    def block(which, n):
        torch.cuda.synchronize()
        t0 = time.time()
        for _ in range(n):
            if which == "a":
                p, o = state["a"]
                p, o, out = step(p, o, ids, ids)
                state["a"] = (p, o)
            else:
                p, o, s = state["b"]
                p, o, s, out = gstep(p, o, s, ids, ids)
                state["b"] = (p, o, s)
        out.cpu()
        return (time.time() - t0) / n

    base_s = guard_s = float("inf")
    for _ in range(4):
        base_s = min(base_s, block("a", 2))
        guard_s = min(guard_s, block("b", 2))
    flops = train_flops_per_step(cfg, 8, 2048)
    overhead = 100.0 * (guard_s - base_s) / base_s
    prof = profile_device(lambda: block("a", 1), "tuned step", top=10)
    pb, ob, sent = state["b"]
    # containment: NaN-poisoned parameters (bench.py's probe)
    with torch.no_grad():
        for p in _leaves(pb):
            p.mul_(float("nan"))
    step_before = int(ob["step"])
    pb, ob, sent, h2 = gstep(pb, ob, sent, ids, ids)
    _, bad2, _ = unpack_health(h2)
    finite = all(bool(torch.isfinite(t).all())
                 for t in _leaves(ob["m"]) + _leaves(ob["v"]))
    m = {"base_step_ms": base_s * 1e3, "sentinel_step_ms": guard_s * 1e3,
         "overhead_pct": overhead, "mfu": flops / base_s / PEAK_BF16,
         "sentinel_mfu": flops / guard_s / PEAK_BF16,
         "max_memory_allocated_gb": torch.cuda.max_memory_allocated()
         / 2 ** 30, "nan_step_flagged": bad2,
         "step_count_kept": int(ob["step"]) == step_before,
         "moments_finite": finite, "profile": prof}
    log(f"  {json.dumps({k: v for k, v in m.items() if k != 'profile'})}")
    check(bad2 and int(ob["step"]) == step_before and finite,
          f"NaN step not contained: {m}")
    return m


def moe_serving_phase(prompts, news, sp, sn):
    """Phase 18: phase 4's model and trace with 8 experts, top-2, then
    fp32 kernel-vs-gather parity on phase 6's shortened trace."""
    import torch
    from paddle_tpu_torch.inference.serving import (ServingConfig,
                                                    ServingEngine)
    from paddle_tpu_torch.models import generation as G
    from paddle_tpu_torch.models.llama import init_params
    moe = dict(moe_num_experts=8, moe_top_k=2)
    cfg = model_config(torch.bfloat16, **moe)
    params = init_params(cfg, seed=SEED, device="cuda")
    engine = ServingEngine(params, cfg, ServingConfig(), device="cuda")
    engine.run([prompts[0][:40]], max_new_tokens=4, eos_token_id=None)
    reset_counts()
    _, m = drive(engine, prompts, news)
    c = read_counts()
    dec = c["paged_attention"] - c["paged_attention_multiquery"]
    log(f"  {json.dumps(m)}")
    log(f"  launches: {json.dumps(c)}")
    check(dec == 12 * m["decode_iters"],
          f"paged attention launches {dec} for {m['decode_iters']} decode "
          f"iterations")
    check(c["paged_attention_multiquery"] == 12 * m["mixed_dispatches"],
          f"multi-query launches {c['paged_attention_multiquery']} for "
          f"{m['mixed_dispatches']} mixed dispatches")
    del engine
    torch.cuda.empty_cache()
    _, pool, tok, (sl, tbl, act), pre_drops = first_dispatch(params, cfg,
                                                             prompts)
    _, _, dec_drops = G.paged_decode_step(params, cfg, tok, sl, tbl, pool,
                                          act, use_kernel=True)
    drops = {"paged_prefill": float(pre_drops),
             "paged_decode_step": float(dec_drops)}
    log(f"  dropped (token, choice) pairs of one direct call: "
        f"{json.dumps(drops)}")
    del params, pool
    torch.cuda.empty_cache()
    # fp32 parity: the kernel and gather engines give equal streams,
    # greedy and sampled, at the default capacity factor 1.25 (drops) and
    # at E / top_k = 4 (capacity = T, nothing drops). Which pairs a
    # capacity drops depends on every row of a dispatch, freed slots and
    # padding included, and those rows attend the null block they all
    # write: generation._write_src makes what it holds a function of the
    # inputs, where the card's scatter would keep an unspecified row.
    params = init_params(model_config(torch.float32, **moe), seed=SEED + 1,
                         device="cuda")
    equal = {}
    for cf in (1.25, 4.0):
        cfg32 = model_config(torch.float32, moe_capacity_factor=cf, **moe)
        _, pool, tok, (sl, tbl, act), _ = first_dispatch(params, cfg32, sp)
        lg = {use: G.paged_decode_step(
            params, cfg32, tok, sl, tbl,
            {k: v.clone() for k, v in pool.items()}, act,
            use_kernel=use)[0] for use in (True, False)}
        err = (lg[True] - lg[False]).abs().max().item()
        log(f"  fp32 MoE, capacity factor {cf}: first decode dispatch "
            f"logits, kernel vs gather: max abs err {err:.3g}")
        check(err <= 1e-3, f"fp32 MoE logit error {err} at capacity "
              f"factor {cf}")
        del pool
        for kind, knobs in (("greedy", None),
                            ("sampled", sampled_knobs(len(sp)))):
            streams = {}
            for knob in ("on", "off"):
                eng = ServingEngine(params, cfg32,
                                    ServingConfig(paged_kernel=knob),
                                    device="cuda")
                streams[knob], _ = drive(eng, sp, sn, knobs)
                del eng
            same = [bool(np.array_equal(a, b))
                    for a, b in zip(streams["on"], streams["off"])]
            equal[f"{kind} cf {cf}"] = f"{sum(same)} of {len(same)}"
            for i, ok in enumerate(same):
                check(ok, f"MoE fp32 {kind} request {i} at capacity factor "
                      f"{cf}: kernel stream {streams['on'][i]} != gather "
                      f"stream {streams['off'][i]}")
    log(f"  fp32 MoE streams equal between the kernel and gather engines: "
        f"{json.dumps(equal)}")
    del params
    torch.cuda.empty_cache()
    return m, c, drops

# ---------------------------------------------------------------------------
# phases 20-22: multi-adapter LoRA serving and the dense generation tier
# ---------------------------------------------------------------------------

LORA_RANK = 16


def adapter_ids(n, names):
    """Request i: base when ``i % 3 == 0``, else the next of ``names`` in
    turn."""
    out, k = [], 0
    for i in range(n):
        if i % 3 == 0:
            out.append(None)
        else:
            out.append(names[k % len(names)])
            k += 1
    return out


def lora_engine(params, cfg, adapters, slots, pool=8, **kw):
    """A LoRA serving engine on the card with ``adapters`` registered."""
    from paddle_tpu_torch.inference.serving import (ServingConfig,
                                                    ServingEngine)
    eng = ServingEngine(params, cfg, ServingConfig(
        lora_rank=LORA_RANK, lora_slots=slots, lora_pool=pool, **kw),
        device="cuda")
    for name, ap in adapters.items():
        eng.register_adapter(name, ap)
    return eng


def kernel_window(run, iters):
    """Kernel launches and device ms per call of ``run`` over ``iters``
    calls under ``torch.profiler``, with the device ms by kernel name;
    None where the profiler saw no device event."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            run()
        torch.cuda.synchronize()
    by, n = {}, 0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            by[e.key[:60]] = by.get(e.key[:60], 0.0) + \
                e.self_device_time_total / 1e3 / iters
            n += e.count
    if not n:
        return None
    return {"launches": n / iters, "device_ms": sum(by.values()),
            "by_kernel": by}


def lora_decode_windows(params, cfg, prompts, adapters):
    """One decode iteration at the engine's shape (8 rows, phase 4's
    first prompts) without and with a LoRA operand (rows on slots 0-4 of
    a 4-slot pool): kernel launches and device ms per iteration from 10
    profiled iterations each, what the operand added by kernel, and the
    four deltas of one layer (q, k, v, o at [8, 1, 2048], rank 16) timed
    alone with CUDA events."""
    import torch
    from paddle_tpu_torch.models import generation as G
    from paddle_tpu_torch.models.lora import (AdapterPool, gather_adapters,
                                              gathered_delta)
    ap = AdapterPool(cfg, LORA_RANK, 4, 8, device="cuda")
    for name in list(adapters)[:4]:
        ap.register(name, adapters[name])
        ap.acquire(name)
    _, pool, tok, (sl, tbl, act), _ = first_dispatch(params, cfg, prompts,
                                                     B=8)
    ids = torch.tensor([0, 1, 2, 3, 4, 0, 1, 2], dtype=torch.int32,
                       device="cuda")
    out = {}
    for kind, op in (("base", None),
                     ("lora", {"ids": ids, "layers": ap.layers})):
        def step(op=op):
            G.paged_decode_step(params, cfg, tok, sl, tbl, pool, act,
                                use_kernel=True, lora=op)
        step()
        out[kind] = kernel_window(step, 10)
    g = gather_adapters(ap.layers, ids, cfg.dtype)
    x = torch.randn((8, 1, cfg.hidden_size), device="cuda").to(cfg.dtype)

    def deltas():
        for a, b in (("qA", "qB"), ("kA", "kB"), ("vA", "vB"), ("oA", "oB")):
            gathered_delta(x, g[a][0], g[b][0])

    row = {"lora_deltas_one_layer_event_ms": cuda_ms(deltas, iters=20)}
    if out["base"] and out["lora"]:
        added = {k: v - out["base"]["by_kernel"].get(k, 0.0)
                 for k, v in out["lora"]["by_kernel"].items()}
        row.update({
            "launches_per_decode_iteration_base_lora": [
                out["base"]["launches"], out["lora"]["launches"]],
            "device_ms_per_decode_iteration_base_lora": [
                out["base"]["device_ms"], out["lora"]["device_ms"]],
            "lora_added_device_ms_by_kernel": dict(sorted(
                added.items(), key=lambda kv: -kv[1])[:6])})
    else:
        row["launches_per_decode_iteration_base_lora"] = (
            "not measured (the profiler saw no device events)")
    log(f"  one decode iteration, 8 rows, without / with the LoRA operand: "
        f"{json.dumps(row)}")
    del pool, ap
    torch.cuda.empty_cache()
    return row


def lora_serving_phase(prompts, news, greedy4, greedy5):
    """Phase 20: phase 4's model and trace through a LoRA engine (rank 16,
    4 slots, 8 registered adapters; every third request base, the rest
    cycling over the adapters), in turns with phase 4's LoRA-less engine;
    base traffic through a LoRA engine against phases 4 and 5; the decode
    iteration's launches; a profiled drain."""
    import torch
    from paddle_tpu_torch.inference.serving import (ServingConfig,
                                                    ServingEngine)
    from paddle_tpu_torch.models.llama import init_params
    from paddle_tpu_torch.models.lora import lora_init_params
    cfg = model_config(torch.bfloat16)
    params = init_params(cfg, seed=SEED, device="cuda")
    names = [f"a{i}" for i in range(1, 9)]
    adapters = {n: lora_init_params(cfg, LORA_RANK, seed=i)
                for i, n in enumerate(names, 1)}
    knobs = [{"adapter_id": a} for a in adapter_ids(len(prompts), names)]
    warm = prompts[0][:40]

    def fresh(lora, **kw):
        eng = (lora_engine(params, cfg, adapters, 4, **kw) if lora else
               ServingEngine(params, cfg, ServingConfig(**kw),
                             device="cuda"))
        eng.run([warm], max_new_tokens=4, eos_token_id=None)
        return eng

    turns, main = [], None
    for kind in ("A", "LoRA", "LoRA", "A"):
        eng = fresh(kind == "LoRA")
        reset_counts()
        _, m = drive(eng, prompts, news, knobs if kind == "LoRA" else None)
        c = read_counts()
        turns.append({"run": kind, "tok_s": m["tok_s"],
                      "ttft_p50_s": m["ttft_p50_s"],
                      "ttft_max_s": m["ttft_max_s"],
                      "ms_per_decode_step": m["ms_per_decode_step"]})
        if kind == "LoRA" and main is None:
            st = eng.stats()["lora"]
            dec = c["paged_attention"] - c["paged_attention_multiquery"]
            main = (m, c, st)
            log(f"  LoRA drain: {json.dumps(m)}")
            log(f"  launches: {json.dumps(c)}; adapter pool: "
                f"{json.dumps(st)}")
            check(st["adapter_pins"] == 0, f"{st['adapter_pins']} adapter "
                  f"pins left after the drain")
            check(st["adapter_loads"] >= 8 and st["adapter_evictions"] >= 4,
                  f"adapter pool churn {st}")
            check(dec == 12 * m["decode_iters"],
                  f"paged attention launches {dec} for {m['decode_iters']} "
                  f"decode iterations")
            check(c["paged_attention_multiquery"] == 12 * m[
                "mixed_dispatches"], f"multi-query launches "
                  f"{c['paged_attention_multiquery']} for "
                  f"{m['mixed_dispatches']} mixed dispatches")
        del eng
        torch.cuda.empty_cache()
    log(f"  in turns (A, LoRA, LoRA, A): {json.dumps(turns)}")
    launches = main[1]
    # base traffic through a LoRA engine holding all 8 adapters equals the
    # LoRA-less engine's streams, bf16 (phase 4) and int8 (phase 5)
    for label, want, kw in (("bf16", greedy4, {}),
                            ("int8", greedy5, dict(quantize="int8",
                                                   kv_quant="int8"))):
        eng = fresh(True, **kw)
        reset_counts()
        got, _ = drive(eng, prompts, news)
        c = read_counts()
        same = sum(np.array_equal(a, b) for a, b in zip(got, want))
        log(f"  base traffic through the LoRA engine, {label}: {same} of "
            f"{len(want)} streams equal to the LoRA-less engine's; "
            f"launches {json.dumps(c)}")
        for i, (a, b) in enumerate(zip(got, want)):
            check(np.array_equal(a, b), f"{label} base request {i} through "
                  f"the LoRA engine: {a} != {b}")
        if label == "int8":
            check(c["weight_only_matmul"] > 0 and c["paged_attention_int8"]
                  > 0, f"int8 LoRA engine launches {c}")
        launches = {k: launches[k] + c[k] for k in launches}
        del eng
        torch.cuda.empty_cache()
    window = lora_decode_windows(params, cfg, prompts, adapters)
    eng = fresh(True)
    fresh8 = make_trace(8, cfg.vocab_size, SEED + 2)
    prof = profile_drain(eng, *fresh8, knobs=[
        {"adapter_id": a} for a in adapter_ids(8, names)])
    del eng, params
    torch.cuda.empty_cache()
    return {"metrics": main[0], "turns": turns, "pool": main[2],
            "window": window, "profile": prof}, launches


def stream_gap(params, cfg, prompt, stream, j, a, b):
    """|l[a] - l[b]| over max|l| of the fp32 full forward's last logits at
    ``prompt + stream[:j]``."""
    import torch
    from paddle_tpu_torch.models.llama import forward
    ctx = torch.from_numpy(np.concatenate([prompt, stream[:j]]).astype(
        np.int64))[None].cuda()
    with torch.no_grad():
        lg = forward(params, ctx, cfg)[0, -1].float()
    return float((lg[a] - lg[b]).abs() / lg.abs().max())


def lora_parity_phase(sp, sn):
    """Phase 21: fp32, phase 6's model and trace, five adapters on two
    slots."""
    import torch
    from paddle_tpu_torch.inference.serving import (ServingConfig,
                                                    ServingEngine)
    from paddle_tpu_torch.models.llama import init_params
    from paddle_tpu_torch.models.lora import lora_init_params, merge_lora
    cfg32 = model_config(torch.float32)
    params = init_params(cfg32, seed=SEED + 1, device="cuda")
    adapters = {f"a{i}": lora_init_params(cfg32, LORA_RANK, seed=100 + i)
                for i in range(1, 6)}
    ids = [None, "a1", "a2", "a1", "a4", "a5"][:len(sp)]
    knobs = [{"adapter_id": a} for a in ids]
    sampled = [dict(k, **SAMPLED, seed=i) for i, k in enumerate(knobs)]
    streams = {}
    for knob in ("on", "off"):
        eng = lora_engine(params, cfg32, adapters, 2, paged_kernel=knob)
        streams[knob], _ = drive(eng, sp, sn, knobs)
        streams[knob + " sampled"], _ = drive(eng, sp, sn, sampled)
        check(eng.stats()["lora"]["adapter_pins"] == 0, "pins left")
        del eng
    # (c) the kernel and gather engines agree, greedy and sampled
    for kind in ("", " sampled"):
        for i, (a, b) in enumerate(zip(streams["on" + kind],
                                       streams["off" + kind])):
            check(np.array_equal(a, b), f"LoRA{kind} request {i}: kernel "
                  f"stream {a} != gather stream {b}")
    # (a) each request against its own oracle: the LoRA-less engine on the
    # base or the merged weights, the request alone
    gaps, equal, base_streams = [], 0, {}
    for name in [None] + sorted({a for a in ids if a is not None}):
        p = params if name is None else merge_lora(params, adapters[name])
        eng = ServingEngine(p, cfg32, ServingConfig(), device="cuda")
        for i, a in enumerate(ids):
            if name is None:
                base_streams[i] = eng.run([sp[i]], max_new_tokens=sn[i],
                                          eos_token_id=None)[0]
            if a != name:
                continue
            want = (base_streams[i] if name is None else
                    eng.run([sp[i]], max_new_tokens=sn[i],
                            eos_token_id=None)[0])
            got = streams["on"][i]
            if np.array_equal(got, want):
                equal += 1
                continue
            j = int(np.argmax(got != want))
            gap = stream_gap(p, cfg32, sp[i], want, j, int(want[j]),
                             int(got[j]))
            gaps.append([i, name, j, int(want[j]), int(got[j]), gap])
            check(gap <= 1e-4, f"request {i} ({name}) parts from its "
                  f"oracle at {j} with fp32 logit gap {gap} x max|logit| "
                  f"> 1e-4")
        del eng, p
        torch.cuda.empty_cache()
    log(f"  mixed wave: {equal} of {len(ids)} streams equal to their "
        f"oracles; partings [request, adapter, position, oracle token, "
        f"token, fp32 gap / max|logit|]: {json.dumps(gaps)}")
    # (b) the adapters move the streams
    moved = sum(not np.array_equal(streams["on"][i], base_streams[i])
                for i, a in enumerate(ids) if a is not None)
    log(f"  {moved} of {sum(a is not None for a in ids)} adapter streams "
        f"differ from base")
    check(moved >= 1, "no adapter stream differs from base")
    # (d) eviction and reload: a1's stream again after a3, a4, a5 pushed
    # it out of the 2-slot pool, the pool's storage in place throughout
    # (no prefix cache: both a1 runs take the same dispatches)
    eng = lora_engine(params, cfg32, adapters, 2, prefix_cache=None)
    ptrs = {k: v.data_ptr() for k, v in eng._lora.layers.items()}
    first, _ = drive(eng, sp[1:2], sn[1:2], [{"adapter_id": "a1"}])
    for name in ("a3", "a4", "a5"):
        drive(eng, sp[1:2], [2], [{"adapter_id": name}])
    check("a1" in eng.adapter_partition()["evicted"], "a1 not evicted")
    again, _ = drive(eng, sp[1:2], sn[1:2], [{"adapter_id": "a1"}])
    check(np.array_equal(first[0], again[0]), f"a1 after reload "
          f"{again[0]} != before {first[0]}")
    check({k: v.data_ptr() for k, v in eng._lora.layers.items()} == ptrs,
          "the adapter pool's storage moved")
    log(f"  evict + reload: a1's stream equal, pool storage fixed, "
        f"{json.dumps(eng.stats()['lora'])}")
    del eng, params
    torch.cuda.empty_cache()


def dense_phase(sp, sn):
    """Phase 22: the dense tier. ``generate`` at full width, bf16 (B 8,
    prompts 64-128, 64 new tokens, greedy): tokens/s and the cost of the
    per-token done read, in turns; the int8 predictor's matmul launches;
    then fp32 parity on phase 6's model and trace."""
    import torch
    from paddle_tpu_torch.inference import (GenerationConfig,
                                            GenerationPredictor)
    from paddle_tpu_torch.inference.serving import (ServingConfig,
                                                    ServingEngine)
    from paddle_tpu_torch.models import generation as G
    from paddle_tpu_torch.models.llama import init_params
    cfg = model_config(torch.bfloat16)
    params = init_params(cfg, seed=SEED, device="cuda")
    rng = np.random.default_rng(SEED + 22)
    B, S, N = 8, 128, 64
    lens = rng.integers(64, S + 1, B).astype(np.int32)
    ids = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    G.generate(params, ids, cfg, max_new_tokens=2, prompt_lens=lens)
    runs, outs = [], {}
    # eos None: the loop reads nothing back until the end; eos = vocab
    # size (an id the model never emits): one read of the done mask a
    # step. ABBA twice
    for eos in (None, cfg.vocab_size, cfg.vocab_size, None) * 2:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = G.generate(params, ids, cfg, max_new_tokens=N,
                         prompt_lens=lens, eos_token_id=eos)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        runs.append({"eos": eos, "wall_s": wall, "tok_s": B * N / wall})
        outs.setdefault(eos, out.cpu().numpy())
    o = outs[None]
    check(o.shape == (B, N) and (o >= 0).all() and (o < cfg.vocab_size).all(),
          f"generate output {o.shape}")
    check(np.array_equal(o, outs[cfg.vocab_size]),
          "generate streams differ with an EOS that never fires")
    walls = {e: [r["wall_s"] for r in runs if r["eos"] == e]
             for e in (None, cfg.vocab_size)}
    sync_ms = (np.mean(walls[cfg.vocab_size]) - np.mean(walls[None])) \
        * 1e3 / (N - 1)
    spread_ms = max(max(w) - min(w) for w in walls.values()) * 1e3 / (N - 1)
    log(f"  generate B {B}, prompts {lens.min()}-{lens.max()}, {N} new "
        f"tokens, bf16, in turns: {json.dumps(runs)}; the done read costs "
        f"{sync_ms:.4f} ms a token (mean of 4 against 4; the runs of one "
        f"kind spread by {spread_ms:.4f} ms a token)")
    pred = GenerationPredictor(params, cfg, GenerationConfig(
        max_new_tokens=8), quantize="int8")
    pred.generate(ids, prompt_lens=lens)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    q = pred.generate(ids, prompt_lens=lens)
    int8_s = time.perf_counter() - t0
    c = read_counts()
    log(f"  int8 predictor, 8 new tokens: {B * 8 / int8_s:.1f} tok/s; "
        f"launches {json.dumps(c)}")
    check(q.shape == (B, 8), f"int8 predictor output {q.shape}")
    check(c["weight_only_matmul"] == 85 * 8, f"weight_only_matmul "
          f"launches {c['weight_only_matmul']} for a prefill and 7 decode "
          f"steps (85 each)")
    del pred, params
    torch.cuda.empty_cache()
    # fp32: generate equals the serving engine and DecodeSession; a
    # sampled generate repeats with its seed
    cfg32 = model_config(torch.float32)
    params = init_params(cfg32, seed=SEED + 1, device="cuda")
    Sx = max(len(p) for p in sp)
    ids32 = np.zeros((len(sp), Sx), np.int32)
    for i, p in enumerate(sp):
        ids32[i, :len(p)] = p
    plens = np.array([len(p) for p in sp], np.int32)
    n = max(sn)
    dense = G.generate(params, ids32, cfg32, max_new_tokens=n,
                       prompt_lens=plens).cpu().numpy()
    eng = ServingEngine(params, cfg32, ServingConfig(), device="cuda")
    served = eng.run(sp, max_new_tokens=sn, eos_token_id=None)
    del eng
    for i, s in enumerate(served):
        if not np.array_equal(s, dense[i, :sn[i]]):
            j = int(np.argmax(s != dense[i, :sn[i]]))
            gap = stream_gap(params, cfg32, sp[i], dense[i], j,
                             int(dense[i, j]), int(s[j]))
            check(False, f"request {i}: engine {s} != generate "
                  f"{dense[i, :sn[i]]} (fp32 gap {gap} x max|logit|)")
    sess = G.DecodeSession(params, cfg32, capacity=Sx + n)
    logits = sess.prefill(ids32, plens)
    toks = []
    for t in range(n):
        tok = logits.argmax(-1).to(torch.int32)
        toks.append(tok)
        if t < n - 1:
            logits = sess.step(tok)
    sess_out = torch.stack(toks, 1).cpu().numpy()
    check(np.array_equal(sess_out, dense), "DecodeSession != generate")
    kw = dict(max_new_tokens=n, prompt_lens=plens, seed=7, **SAMPLED)
    s1 = G.generate(params, ids32, cfg32, **kw).cpu().numpy()
    s2 = G.generate(params, ids32, cfg32, **kw).cpu().numpy()
    check(np.array_equal(s1, s2), "sampled generate does not repeat")
    log(f"  fp32: generate == serving engine ({len(sp)} requests), "
        f"DecodeSession == generate, sampled generate repeats with its seed "
        f"({int((s1 != dense).any(axis=1).sum())} of {len(sp)} rows differ "
        f"from greedy)")
    del params, sess
    torch.cuda.empty_cache()
    return {"runs": runs, "sync_ms_per_token": sync_ms,
            "sync_spread_ms": spread_ms, "int8_tok_s": B * 8 / int8_s}


# ---------------------------------------------------------------------------
# phases 23-25: the host offload tier, the supervisor and journal, the
# embeddings endpoint
# ---------------------------------------------------------------------------

PCIE_BYTES_PER_S = 64e9        # PCIe Gen5 x16, one direction, the H100's
#                                host link


def family_trace(vocab, seed, fams=16, per=2, pre=256, tail=16):
    """The churn wave (``fams`` families x ``per`` requests, each a
    ``pre``-token family prefix and its own ``tail``-token tail) and the
    revisit wave (one request a family, a fresh tail on the same
    prefix)."""
    rng = np.random.default_rng(seed)
    prefixes = [rng.integers(0, vocab, pre).astype(np.int32)
                for _ in range(fams)]

    def wave(k):
        return [np.concatenate([p, rng.integers(0, vocab, tail)
                                .astype(np.int32)])
                for p in prefixes for _ in range(k)]

    return wave(per), wave(1)


def tier_engine(params, cfg, on, **kw):
    """Cell O's engine: a 200-block pool (8 live sequences plus headroom,
    so the churn evicts most chains), the tier at 512 blocks when on."""
    from paddle_tpu_torch.inference.serving import (ServingConfig,
                                                    ServingEngine)
    return ServingEngine(params, cfg, ServingConfig(
        num_blocks=200, prefix_cache=True, offload=on, offload_blocks=512,
        **kw), device="cuda")


def churn_revisit(eng, churn, revisit, new=16, between=None):
    """Drain the churn wave, then the revisit wave (timed, launches
    counted); returns (revisit streams, metrics, launches)."""
    import torch
    drive(eng, churn, [new] * len(churn))
    if between is not None:
        between(eng)
    st0 = eng.stats()
    # host time of the revisit's admissions, and of the tier's verified
    # takes inside them (the CRC check of every restored block)
    spent = {"admit_ms": 0.0, "take_ms": 0.0}
    owners = [(eng.cache, "admit", "admit_ms")]
    if eng.cache.offload is not None:
        owners.append((eng.cache.offload, "take", "take_ms"))
    for obj, name, key in owners:
        def timed(*a, _real=getattr(obj, name), _key=key, **kw):
            t = time.time()
            try:
                return _real(*a, **kw)
            finally:
                spent[_key] += (time.time() - t) * 1e3
        setattr(obj, name, timed)
    reset_counts()
    outs, m = drive(eng, revisit, [new] * len(revisit))
    c = read_counts()
    for obj, name, _ in owners:
        delattr(obj, name)
    m.update(spent)
    st = eng.stats()
    hit = st["prefix_hit_tokens"] - st0["prefix_hit_tokens"]
    m["prefill_tokens_computed"] = sum(len(p) for p in revisit) - hit
    m["prefix_tokens_recomputed"] = (
        sum(len(p) - 16 for p in revisit) - hit)
    m["recomputed_tokens"] = st["recomputed_tokens"] - st0[
        "recomputed_tokens"]
    m["offload"] = st["offload"]
    torch.cuda.synchronize()
    return outs, m, c


def tier_disjoint(eng):
    """The two-tier partition: device keys and host keys disjoint, and
    free + evictable + in_use == usable."""
    part = eng.block_partition()
    dev = set(eng.cache.manager._hash2block)
    host = set(eng.cache.offload.keys())
    check(not dev & host, f"{len(dev & host)} keys on device AND host")
    check(part["free"] + part["evictable"] + part["in_use"]
          == part["usable"], f"pool partition {part}")
    return part


def swap_cost(cache, n=64):
    """ms per block of the tier's swap-out (``read_block``: the D2H into
    pinned buffers) and swap-in (``write_block``: the H2D back), over
    ``n`` blocks, by CUDA events and by the host clock, with the GB/s and
    the least time PCIe could take; and the host's CRC32 of one block
    (every leaf), which a swap-out stamps and a swap-in verifies."""
    import torch
    from paddle_tpu_torch.inference.serving.offload import block_crc
    blocks = list(range(1, n + 1))
    per_block = sum(a[:, 0].numel() * a.element_size()
                    for a in cache.pool.values())
    out = {"bytes_per_block": per_block}
    for _ in range(2):                       # warm: pinned buffers cached
        caps = [cache.read_block(b) for b in blocks]
        for cap in caps:
            cap.wait()
    for what in ("d2h", "h2d"):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.time()
        a.record()
        if what == "d2h":
            caps = [cache.read_block(blk) for blk in blocks]
        else:
            for blk, cap in zip(blocks, caps):
                cache.write_block(blk, cap.data)
        b.record()
        torch.cuda.synchronize()
        wall = (time.time() - t0) * 1e3 / n
        if what == "d2h":
            for cap in caps:
                cap.wait()
        ms = a.elapsed_time(b) / n
        if what == "d2h":
            t1 = time.time()
            for cap in caps:
                for t in cap.data.values():
                    block_crc(t)
            out["crc_ms_per_block"] = (time.time() - t1) * 1e3 / n
        out[what] = {"ms_per_block": ms,
                     "wall_ms_per_block": wall,
                     "gb_s": per_block / ms / 1e6,
                     "pcie_bound_ms_per_block":
                         per_block / PCIE_BYTES_PER_S * 1e3}
    return out


def offload_phase(sp_seed=SEED + 23):
    """Phase 23 (cell O): the host offload tier on A's model at bf16, tier
    on and off in turns; the swap cost a block; then at fp32 on C's model
    tier-on streams against tier-off (fp and int8), and a corrupted host
    block. Returns (metrics, main-path launches)."""
    import torch
    from paddle_tpu_torch.models.llama import init_params
    cfg = model_config(torch.bfloat16)
    params = init_params(cfg, seed=SEED, device="cuda")
    churn, revisit = family_trace(cfg.vocab_size, sp_seed)
    turns, launches, main = [], None, None
    for on in (False, True, True, False):
        eng = tier_engine(params, cfg, on)
        eng.run([churn[0][:40]], max_new_tokens=4, eos_token_id=None)
        _, m, c = churn_revisit(eng, churn, revisit)
        dec = c["paged_attention"] - c["paged_attention_multiquery"]
        turns.append({"tier": on, "ttft_p50_s": m["ttft_p50_s"],
                      "ttft_max_s": m["ttft_max_s"], "tok_s": m["tok_s"],
                      "prefill_tokens_computed":
                          m["prefill_tokens_computed"],
                      "prefix_tokens_recomputed":
                          m["prefix_tokens_recomputed"],
                      "offload": m["offload"]})
        check(dec > 0, f"revisit decodes launched paged_attention {dec}")
        if on:
            off = m["offload"]
            check(m["prefix_tokens_recomputed"] == 0
                  and m["recomputed_tokens"] == 0,
                  f"tier on: the revisit recomputed "
                  f"{m['prefix_tokens_recomputed']} prefix tokens")
            check(off["swap_ins"] > 0 and off["tier_hits"] > 0
                  and off["corrupt_drops"] == 0, f"tier counters {off}")
            part = tier_disjoint(eng)
            if main is None:
                main = (m, part)
                launches = c
                log(f"  tier on, revisit: {json.dumps(m)}")
                log(f"  partition {json.dumps(part)}; launches "
                    f"{json.dumps(c)}")
        else:
            check(m["prefix_tokens_recomputed"] > 0,
                  "tier off: the churn evicted no chain")
        if on and len(turns) == 3:
            cost = swap_cost(eng.cache)
            log(f"  swap cost: {json.dumps(cost)}")
        del eng
        torch.cuda.empty_cache()
    log(f"  in turns (off, on, on, off): {json.dumps(turns)}")
    del params
    torch.cuda.empty_cache()

    # fp32 on C's model: the tier serves the same streams
    cfg32 = model_config(torch.float32)
    params = init_params(cfg32, seed=SEED + 1, device="cuda")
    churn, revisit = family_trace(cfg32.vocab_size, sp_seed, fams=12)
    for label, kw in (("fp", {}), ("int8", dict(kv_quant="int8",
                                                quantize="int8"))):
        got = {}
        for on in (True, False):
            eng = tier_engine(params, cfg32, on, **kw)
            got[on], m, c = churn_revisit(eng, churn, revisit)
            if on:
                check(m["offload"]["tier_hits"] > 0,
                      f"fp32 {label}: no tier hit {m['offload']}")
                tier_disjoint(eng)
                if label == "int8":
                    check(c["weight_only_matmul"] > 0
                          and c["paged_attention_int8"] > 0,
                          f"fp32 int8 tier run launches {c}")
                    launches = {k: launches[k] + c[k] for k in launches}
            del eng
            torch.cuda.empty_cache()
        for i, (a, b) in enumerate(zip(got[True], got[False])):
            check(np.array_equal(a, b), f"fp32 {label} request {i}: tier on "
                  f"{a} != tier off {b}")
        log(f"  fp32 {label}: {len(got[True])} revisit streams equal with "
            f"the tier on and off")
    eng = tier_engine(params, cfg32, True)
    want, _, _ = churn_revisit(eng, churn, revisit)
    del eng
    eng = tier_engine(params, cfg32, True)
    got, m, _ = churn_revisit(eng, churn, revisit,
                              between=lambda e: e.cache.offload.corrupt_one(1))
    check(m["offload"]["corrupt_drops"] == 1,
          f"corrupt_one: {m['offload']}")
    for i, (a, b) in enumerate(zip(got, want)):
        check(np.array_equal(a, b), f"corrupt block, request {i}: {a} != {b}")
    log(f"  fp32 corrupt host block: corrupt_drops 1, streams unchanged, "
        f"prefill tokens computed {m['prefill_tokens_computed']}")
    del eng, params
    torch.cuda.empty_cache()
    return {"turns": turns, "main": main[0], "swap": cost}, launches


class _Crash(RuntimeError):
    pass


def arm_crash(sup, at_decode_iter):
    """Arm the live engine of ``sup`` to raise once from its step loop at
    the first step that starts ``at_decode_iter`` or more decode
    iterations after arming (this script's copy of the JAX package's
    ``testing/chaos.py::engine_crash``: the patch rides the engine, so the
    rebuilt engine runs clean). Returns the engine's decode-iteration
    count at which it fires."""
    eng = sup.engine
    real = eng._step
    at = eng._stats["decode_iters"] + at_decode_iter

    def crashing(max_iters=None):
        if eng._stats["decode_iters"] >= at:
            eng._step = real
            raise _Crash(f"injected engine crash at decode iteration "
                         f"{eng._stats['decode_iters']}")
        return real(max_iters)

    eng._step = crashing
    return at


def supervised_drive(sup, prompts, news, knobs=None, crash_at=None,
                     pre_steps=None, max_iters=None):
    """Submit the trace to the supervisor and step it to drain, collecting
    the tokens each step delivers. With ``crash_at`` the engine crashes
    at that decode iteration; the crashing step is timed (rebuild +
    resubmit) and device memory read just before it and just after.
    With ``pre_steps`` it stops after that many steps instead. Returns
    (srids, delivered by srid, metrics); ``metrics["per_step"]`` holds
    what each step delivered."""
    import torch
    knobs = knobs or [{}] * len(prompts)
    srids = [sup.submit(p, max_new_tokens=m, eos_token_id=None, **k)
             for p, m, k in zip(prompts, news, knobs)]
    got = {s: [] for s in srids}
    armed = crash_at is not None
    if armed:
        crash_at = arm_crash(sup, crash_at)
    m = {"per_step": []}
    torch.cuda.synchronize()
    t0 = time.time()
    steps = 0
    while sup.pending and (pre_steps is None or steps < pre_steps):
        if armed and sup.engine._stats["decode_iters"] >= crash_at:
            torch.cuda.synchronize()
            m["mem_before_gb"] = torch.cuda.memory_allocated() / 2**30
            m["pool_gb"] = sup.engine.cache.kv_bytes() / 2**30
            m["wq_ptr"] = sup.engine._params["layers"]["wq"].data_ptr()
            r0 = sup.restarts
            t1 = time.time()
            out = sup.step(max_iters)
            torch.cuda.synchronize()
            m["recovery_ms"] = (time.time() - t1) * 1e3
            m["mem_after_gb"] = torch.cuda.memory_allocated() / 2**30
            check(sup.restarts == r0 + 1 and out == {},
                  f"the crash did not restart the engine ({sup.restarts})")
            check(sup.engine._params["layers"]["wq"].data_ptr()
                  == m.pop("wq_ptr"), "the rebuild re-cast the weights")
            armed = False
        else:
            out = sup.step(max_iters)
        for s, toks in out.items():
            got[s].extend(int(t) for t in toks)
        m["per_step"].append({s: [int(t) for t in toks]
                              for s, toks in out.items()})
        steps += 1
    check(not armed, "the armed crash never fired: the trace drained first")
    torch.cuda.synchronize()
    m["wall_s"] = time.time() - t0
    m["tokens"] = sum(len(v) for v in got.values())
    m["tok_s"] = m["tokens"] / m["wall_s"]
    m["steps"] = steps
    return srids, got, m


def journal_flush_cost(jdir, per_step, policy):
    """ms a step of the journal's per-step work (one ``log_tokens`` per
    request that advanced, then the ``flush``) under ``policy``, replaying
    a recorded run's per-step deliveries into a fresh journal; fsync as
    the machine does it."""
    from paddle_tpu_torch.inference.serving import RequestJournal
    j = RequestJournal(jdir, sync=policy, snapshot_every=0)
    jids = {}
    for step in per_step:
        for s in step:
            if s not in jids:
                jids[s] = j.log_submit(prompt=[1], max_new_tokens=64,
                                       eos_token_id=None, temperature=0.0,
                                       top_k=None, top_p=None, seed=0,
                                       tenant="default", priority=0,
                                       deadline=None)
    t0 = time.time()
    for step in per_step:
        for s, toks in step.items():
            j.log_tokens(jids[s], toks)
        j.flush()
    ms = (time.time() - t0) * 1e3 / max(1, len(per_step))
    j.close()
    return ms


def robustness_phase(prompts, news, sp, sn, tmp):
    """Phase 24 (cell Q): A's trace through the supervisor with a journal,
    in turns without and with a crash; journal flush costs; then at fp32
    on C's model the crash and kill -9 recoveries against the
    uninterrupted run, the restart budget, a drain, and the hang watchdog
    over a blocked synchronize. Returns (metrics, main-path launches)."""
    import gc
    import os
    import torch
    from paddle_tpu_torch.health import watchdog
    from paddle_tpu_torch.inference.serving import (EngineSupervisor,
                                                    RequestJournal,
                                                    ServingConfig)
    from paddle_tpu_torch.inference.serving.supervisor import FAILED
    from paddle_tpu_torch.models.llama import init_params
    cfg = model_config(torch.bfloat16)
    params = init_params(cfg, seed=SEED, device="cuda")
    turns, launches, per_step = [], None, None
    for i, crash in enumerate((False, True, True, False)):
        gc.collect()             # the last turn's engine is gone before
        torch.cuda.empty_cache()  # this one's memory is read
        jdir = os.path.join(tmp, f"bf16-{i}")
        sup = EngineSupervisor(params, cfg, ServingConfig(),
                               journal=RequestJournal(jdir), device="cuda")
        sup.engine.run([prompts[0][:40]], max_new_tokens=4,
                       eos_token_id=None)
        reset_counts()
        srids, got, m = supervised_drive(sup, prompts, news,
                                         crash_at=10 if crash else None)
        steps = m.pop("per_step")
        c = read_counts()
        for s, n in zip(srids, news):
            rec = sup.request(s)
            check(rec.state == "finished" and len(rec.tokens) == n,
                  f"request {s} ended {rec.state} {len(rec.tokens)}/{n}")
            check(got[s] == [int(t) for t in rec.tokens],
                  f"request {s}: delivered tokens repeat or went missing")
        check(sup.block_partition()["in_use"] == 0, "blocks leaked")
        wal = os.path.getsize(os.path.join(jdir, "journal.wal"))
        m.update(restarts=sup.restarts,
                 recovered_tokens=sup.recovered_tokens,
                 journal_bytes_per_token=wal / m["tokens"])
        if crash:
            check(sup.restarts == 1, f"restarts {sup.restarts}")
            check(c["paged_attention"] > 0, f"crash run launches {c}")
            check(m["mem_after_gb"] - m["mem_before_gb"] < m["pool_gb"],
                  f"device memory {m['mem_before_gb']:.3f} -> "
                  f"{m['mem_after_gb']:.3f} GB across the recovery (one "
                  f"KV pool is {m['pool_gb']:.3f} GB)")
            if launches is None:
                launches = c
                log(f"  crash run: {json.dumps(m)}")
                log(f"  launches: {json.dumps(c)}")
        elif per_step is None:
            per_step = steps
        turns.append({"crash": crash, "tok_s": m["tok_s"],
                      "recovery_ms": m.get("recovery_ms"),
                      "recovered_tokens": m["recovered_tokens"],
                      "journal_bytes_per_token":
                          m["journal_bytes_per_token"]})
        sup.close(deadline_s=0.0)
        del sup
        torch.cuda.empty_cache()
    log(f"  in turns (no crash, crash, crash, no crash): "
        f"{json.dumps(turns)}")
    flush = {p: journal_flush_cost(os.path.join(tmp, f"flush-{p}"),
                                   per_step, p)
             for p in ("step", "always", "off")}
    log(f"  journal work a step (log_tokens + flush), ms: "
        f"{json.dumps(flush)} over {len(per_step)} steps")
    del params
    torch.cuda.empty_cache()

    # fp32 on C's model and trace: greedy and seeded streams
    cfg32 = model_config(torch.float32)
    params = init_params(cfg32, seed=SEED + 1, device="cuda")
    knobs = [dict(SAMPLED, seed=i) if i % 2 else {} for i in range(len(sp))]

    def sup32(**kw):
        return EngineSupervisor(params, cfg32, ServingConfig(),
                                device="cuda", **kw)

    # stepped 2 decode iterations at a time (a streaming client), so a
    # crash and a kill land mid-stream
    ref = sup32(journal=None)
    srids, want, _ = supervised_drive(ref, sp, sn, knobs, max_iters=2)
    want = [want[s] for s in srids]
    del ref
    sup = sup32(journal=None)
    srids, got, m = supervised_drive(sup, sp, sn, knobs, crash_at=3,
                                     max_iters=2)
    for i, s in enumerate(srids):
        check(got[s] == want[i], f"fp32 crash, request {i}: {got[s]} != "
              f"{want[i]}")
    log(f"  fp32 crash at decode iteration 3: {len(sp)} streams (half "
        f"seeded) equal the uninterrupted run; recovery "
        f"{m['recovery_ms']:.1f} ms")
    del sup
    # kill -9: the journal abandoned mid-stream, then a cold restart
    jdir = os.path.join(tmp, "kill")
    sup = sup32(journal=RequestJournal(jdir))
    srids, pre, _ = supervised_drive(sup, sp, sn, knobs, pre_steps=4,
                                     max_iters=2)
    jids = [sup.request(s).jid for s in srids]
    sup.journal.abandon()
    del sup
    rec = EngineSupervisor.recover(jdir, params, cfg32, ServingConfig(),
                                   device="cuda")
    post = {}
    while rec.pending:
        for s, toks in rec.step(2).items():
            post.setdefault(rec.request(s).jid, []).extend(
                int(t) for t in toks)
    by_jid = {rec.request(s).jid: s for s in rec._reqs}
    for i, (s, jid) in enumerate(zip(srids, jids)):
        check(pre[s] + post.get(jid, []) == want[i],
              f"kill -9, request {i}: delivered {pre[s]} + resumed "
              f"{post.get(jid)} != {want[i]}")
        check(rec.request(by_jid[jid]).state == "finished",
              f"recovered request {i} {rec.request(by_jid[jid]).state}")
    log(f"  fp32 kill -9 after 4 steps: each stream delivered exactly once "
        f"({sum(len(v) for v in pre.values())} before, "
        f"{sum(len(v) for v in post.values())} resumed); resubmitted "
        f"{rec.resubmitted}")
    check(rec.block_partition()["in_use"] == 0, "blocks leaked after kill")
    del rec
    # the restart budget at 0: broken, FAILED partials readable
    sup = sup32(journal=None, max_restarts=0)
    srids, got, _ = supervised_drive(sup, sp, sn, knobs, pre_steps=3,
                                     max_iters=2)
    arm_crash(sup, 0)
    sup.step()
    check(sup.broken and not sup.accepting, "restart budget 0: not broken")
    for s in srids:
        rec_s = sup.request(s)
        check(rec_s.state in (FAILED, "finished"), f"state {rec_s.state}")
        check([int(t) for t in sup.result(s)] == got[s],
              f"partial output of {s} unreadable")
    log(f"  restart budget 0: broken, "
        f"{sum(sup.request(s).state == FAILED for s in srids)} requests "
        f"FAILED with their partials readable")
    del sup
    # drain with a deadline ends holding zero blocks
    sup = sup32(journal=None)
    for p, n in zip(sp, sn):
        sup.submit(p, max_new_tokens=n, eos_token_id=None)
    sup.step()
    rep = sup.drain(deadline_s=0.5)
    check(rep["leaked_blocks"] == 0, f"drain report {rep}")
    log(f"  drain(deadline_s=0.5): {json.dumps(rep)}")
    del sup
    torch.cuda.empty_cache()

    # the hang watchdog over a blocked synchronize
    fired = {}

    def on_hang(diag):
        fired["t"] = time.time()
        fired["diag"] = diag

    wd = watchdog.install(0.5, on_hang=on_hang)
    try:
        sup = sup32(journal=None)
        eng = sup.engine
        real = eng._decode_burst
        spin = {}

        def stalled(*a, **kw):
            eng._decode_burst = real
            with watchdog.section("serving.decode"):
                torch.cuda._sleep(int(2.0 * 1.98e9))   # ~2 s at 1.98 GHz
                t0 = time.time()
                torch.cuda.synchronize()
                spin["sync_s"] = time.time() - t0
                spin["returned"] = time.time()
            return real(*a, **kw)

        eng._decode_burst = stalled
        srids, got, _ = supervised_drive(sup, sp, sn, knobs, max_iters=2)
        check("t" in fired and "serving.decode" in fired["diag"],
              "the watchdog did not fire naming serving.decode")
        check(fired["t"] < spin["returned"],
              "the watchdog fired only after the synchronize returned")
        check(sup.restarts == 1, f"watchdog trip: restarts {sup.restarts}")
        for i, s in enumerate(srids):
            check(got[s] == want[i], f"after the watchdog trip, request "
                  f"{i}: {got[s]} != {want[i]}")
        log(f"  watchdog: fired {spin['returned'] - fired['t']:.2f} s "
            f"before the blocked synchronize returned (it blocked "
            f"{spin['sync_s']:.2f} s), diagnosis names serving.decode; "
            f"the supervisor recovered (restarts 1), streams equal")
        del sup, eng
    finally:
        watchdog.uninstall()
    del wd, params
    torch.cuda.empty_cache()
    return {"turns": turns, "flush_ms_per_step": flush}, launches


def embeddings_phase(prompts, news):
    """Phase 25 (cell P): BERT-base embeddings interleaved with A's
    generate traffic through one engine, in turns without and with the
    embeds; embeddings against ``bert_encode`` of each request alone; the
    pool untouched by embeds. Returns (metrics, main-path launches)."""
    import torch
    from paddle_tpu_torch.inference.serving import (ServingConfig,
                                                    ServingEngine)
    from paddle_tpu_torch.models.bert import (BertConfig, bert_encode,
                                              bert_init_params)
    from paddle_tpu_torch.models.llama import init_params
    cfg = model_config(torch.bfloat16)
    params = init_params(cfg, seed=SEED, device="cuda")
    bcfg = BertConfig()
    bparams = bert_init_params(bcfg, seed=0, device="cuda")
    rng = np.random.default_rng(SEED + 25)
    passages = [rng.integers(0, bcfg.vocab_size, int(n)).astype(np.int32)
                for n in rng.integers(16, 513, 64)]
    turns, launches, rows = [], None, None
    for with_embeds in (False, True, True, False):
        eng = ServingEngine(params, cfg, ServingConfig(), device="cuda",
                            embed_model=(bcfg, bparams))
        eng.run([prompts[0][:40]], max_new_tokens=4, eos_token_id=None)
        e0 = eng.submit_embedding(passages[0][:16])
        eng.step()
        free0 = eng.stats()["free_blocks"]
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.time()
        rids = [eng.submit(p, max_new_tokens=m, eos_token_id=None)
                for p, m in zip(prompts, news)]
        erids, todo = [], list(passages) if with_embeds else []
        while eng.pending or todo:
            for p in todo[:4]:                # 4 arrivals a step
                erids.append(eng.submit_embedding(p))
            todo = todo[4:]
            eng.step()
        torch.cuda.synchronize()
        wall = time.time() - t0
        c = read_counts()
        reqs = [eng.request(r) for r in rids]
        for r, m in zip(reqs, news):
            check(r.state == "finished" and len(r.tokens) == m,
                  f"request {r.rid} ended {r.state}")
        st = eng.stats()
        check(st["blocks_in_use"] == 0 and st["free_blocks"] == free0,
              f"pool after the run: {st['blocks_in_use']} in use, free "
              f"{st['free_blocks']} (before {free0})")
        check(c["paged_attention"] > 0, f"generate launches {c}")
        gen = sum(len(r.tokens) for r in reqs)
        turn = {"embeds": with_embeds, "tok_s": gen / wall,
                "ttft_p50_s": float(np.percentile(
                    [r.ttft_s for r in reqs], 50))}
        if with_embeds:
            lat = [eng.request(e).finish_t - eng.request(e).submit_t
                   for e in erids]
            turn.update(embeds_s=len(erids) / wall,
                        embed_p50_s=float(np.percentile(lat, 50)),
                        embed_max_s=float(max(lat)))
            if rows is None:
                rows = [np.asarray(eng.embedding(e)) for e in erids]
                launches = c
        turns.append(turn)
        # an embeds-only batch on the idle engine leaves the pool alone
        free1 = eng.stats()["free_blocks"]
        ex = [eng.submit_embedding(p) for p in passages[:8]]
        eng.step()
        check(all(eng.request(e).state == "finished" for e in ex)
              and eng.stats()["free_blocks"] == free1
              and eng.stats()["blocks_in_use"] == 0,
              "embeds touched the KV pool")
        del eng
        torch.cuda.empty_cache()
    log(f"  in turns (off, on, on, off): {json.dumps(turns)}")
    worst = 0.0
    for p, row in zip(passages, rows):
        ref = bert_encode(bparams, bcfg, torch.from_numpy(p[None]),
                          torch.tensor([len(p)]))[0]
        ref = ref.cpu().numpy()
        err = float(np.abs(row - ref).max() / np.abs(ref).max())
        worst = max(worst, err)
        check(err <= 1e-4, f"embedding of a {len(p)}-token passage: "
              f"{err:.3g} x max|ref| from bert_encode alone")
    log(f"  64 embeddings within {worst:.3g} x max|ref| of bert_encode "
        f"alone (limit 1e-4)")
    del params, bparams
    torch.cuda.empty_cache()
    return {"turns": turns, "worst_rel_err": worst}, launches


# ---------------------------------------------------------------------------
# phases 26-28: the serving fleet (router, live migration, fleet cache
# pulls, disaggregated prefill)
# ---------------------------------------------------------------------------

def mem_gb():
    """Device memory the allocator holds for live tensors, GiB."""
    import torch
    torch.cuda.synchronize()
    return torch.cuda.memory_allocated() / 2**30


def release():
    """Collect what the caller just dropped (a router's or an engine's
    reference cycles) and hand its device memory back, after a
    synchronize that surfaces any asynchronous CUDA error of the work
    before (the router turns an exception in an export, adopt or graft
    into a fallback counter; a fault on the card must fail the phase)."""
    import gc
    import torch
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()


def arm_kill(router, rid, at_decode_iter=0):
    """Kill replica ``rid`` for good (this script's copy of the JAX
    package's ``testing/chaos.py::replica_kill``): its restart budget
    spent and its engine armed to crash at its ``at_decode_iter``-th
    decode iteration from now (``arm_crash``). Returns a dict whose
    ``"t"`` is set to the host time the crash fires."""
    sup = router._replicas[rid].sup
    sup.max_restarts = sup.restarts
    eng = sup.engine
    real = eng._step
    at = eng._stats["decode_iters"] + at_decode_iter
    fired = {}

    def crashing(max_iters=None):
        if eng._stats["decode_iters"] >= at:
            eng._step = real
            fired["t"] = time.time()
            raise _Crash(f"injected replica kill at decode iteration "
                         f"{eng._stats['decode_iters']}")
        return real(max_iters)

    eng._step = crashing
    if not sup.pending:
        sup.step()
    return fired


def slow_replica(router, rid, stall_steps, delay_s):
    """This script's copy of ``testing/chaos.py::slow_replica``: the
    replica's next ``stall_steps`` engine iterations sleep ``delay_s`` and
    return nothing."""
    eng = router._replicas[rid].sup.engine
    real = eng._step
    state = {"calls": 0}

    def stalled(max_iters=None):
        if state["calls"] < stall_steps:
            state["calls"] += 1
            time.sleep(delay_s)
            return {}
        return real(max_iters)

    eng._step = stalled
    return state


def flaky_probe(router, rid, fails):
    """This script's copy of ``testing/chaos.py::flaky_probe``: the
    replica's next ``fails`` health probes raise."""
    sup = router._replicas[rid].sup
    real = sup.health_snapshot
    state = {"calls": 0}

    def shim():
        if state["calls"] < fails:
            state["calls"] += 1
            raise RuntimeError("injected flaky health probe")
        return real()

    sup.health_snapshot = shim
    return state


def timed_method(obj, name, spent, key):
    """Wrap ``obj.name`` (an instance attribute from now on) so each call
    adds its host ms, ending in a synchronize, to ``spent[key]`` and
    appends its return value to ``spent[key + "_out"]``."""
    import torch
    real = getattr(obj, name)

    def timed(*a, **kw):
        torch.cuda.synchronize()
        t = time.time()
        out = real(*a, **kw)
        torch.cuda.synchronize()
        spent[key] = spent.get(key, 0.0) + (time.time() - t) * 1e3
        spent.setdefault(key + "_n", []).append((time.time() - t) * 1e3)
        spent.setdefault(key + "_out", []).append(out)
        return out

    setattr(obj, name, timed)


def client_drive(target, prompts, news, knobs=None, max_iters=None,
                 after_step=None, concurrency=None, pins=None):
    """Drive a trace through ``target`` (a router or a supervisor) as its
    clients would: submit (all at once, or keeping ``concurrency``
    requests in flight), step until drained, recording on the host clock
    when each request's first and last tokens were delivered.
    ``after_step(i)`` runs after step i (a fault, an audit) with the
    clock stopped: no time or rate here includes it. Every request must
    finish with its ``max_new_tokens``,
    its delivered tokens equal to its record (no repeat, no gap). Returns
    (ids, delivered by id, metrics)."""
    import torch
    n = len(prompts)
    knobs = knobs or [{}] * n
    pins = pins or [None] * n
    ids, want, got, t_sub, t_first, t_last = [], {}, {}, {}, {}, {}
    m = {"submit_ms": [], "step_ms": [], "steps": 0, "emits": [],
         "after_step_ms": 0.0}
    done = set()
    nxt = 0

    def clock():
        return time.time() - m["after_step_ms"] / 1e3

    def submit_more():
        nonlocal nxt
        while nxt < n and (concurrency is None
                           or len(ids) - len(done) < concurrency):
            kw = dict(knobs[nxt])
            if pins[nxt] is not None:
                kw["replica"] = pins[nxt]
            t = clock()
            i = target.submit(prompts[nxt], max_new_tokens=news[nxt],
                              eos_token_id=None, **kw)
            m["submit_ms"].append((clock() - t) * 1e3)
            ids.append(i)
            want[i], got[i], t_sub[i] = news[nxt], [], t
            nxt += 1

    torch.cuda.synchronize()
    t0 = clock()
    submit_more()
    while target.pending or nxt < n:
        t = clock()
        out = target.step(max_iters)
        now = clock()
        m["step_ms"].append((now - t) * 1e3)
        m["emits"].append((now, set(out)))
        for i, toks in out.items():
            t_first.setdefault(i, now)
            t_last[i] = now
            got[i].extend(int(x) for x in toks)
            if len(got[i]) >= want[i]:
                done.add(i)
        if after_step is not None:
            ta = time.time()
            after_step(m["steps"])
            m["after_step_ms"] += (time.time() - ta) * 1e3
        m["steps"] += 1
        check(m["steps"] < 20000, "the trace did not drain")
        submit_more()
    torch.cuda.synchronize()
    m["wall_s"] = clock() - t0
    for i in ids:
        rec = target.request(i)
        check(rec.state == "finished" and len(rec.tokens) == want[i],
              f"request {i} ended {rec.state} with "
              f"{len(rec.tokens)}/{want[i]}")
        check(got[i] == [int(x) for x in target.result(i)],
              f"request {i}: delivered tokens repeat or went missing")
    ttft = [t_first[i] - t_sub[i] for i in ids]
    tpot = [(t_last[i] - t_first[i]) / (want[i] - 1) for i in ids
            if want[i] > 1]
    m.update(tokens=sum(want.values()),
             tok_s=sum(want.values()) / m["wall_s"],
             ttft_p50_s=float(np.percentile(ttft, 50)),
             ttft_max_s=float(max(ttft)),
             tpot_p50_ms=float(np.percentile(tpot, 50)) * 1e3,
             tpot_p99_ms=float(np.percentile(tpot, 99)) * 1e3,
             ms_per_submit=float(np.mean(m["submit_ms"])),
             ms_per_step=float(np.mean(m["step_ms"])),
             t_first=t_first, t_last=t_last)
    return ids, got, m


def replica_step_ms(router):
    """Wrap every current replica's ``sup.step`` to add its host ms to the
    returned dict's ``"ms"``: the replicas' own share of a router step."""
    spent = {"ms": 0.0}
    for rep in router._replicas.values():
        def timed(*a, _real=rep.sup.step, **kw):
            t = time.time()
            try:
                return _real(*a, **kw)
            finally:
                spent["ms"] += (time.time() - t) * 1e3
        rep.sup.step = timed
    return spent


def fleet_stats(router, keys=("decode_iters", "mixed_dispatches",
                              "recomputed_tokens", "prefix_hit_tokens")):
    """{rid: engine stats subset} of every replica."""
    return {rid: {k: rep.sup.engine.stats()[k] for k in keys}
            for rid, rep in router._replicas.items()}


def fleet_delta(before, after, key):
    """Sum over replicas of a stats key's growth (a replica missing from
    ``before`` counts from 0; one gone from ``after`` counts nothing)."""
    return sum(v[key] - before.get(rid, {}).get(key, 0)
               for rid, v in after.items())


def router_counters(router):
    return dict(router.health_snapshot()["counters"])


def counter_delta(before, after):
    return {k: after[k] - before[k] for k in after}


def balanced_fleet(router):
    """Every replica's pool partition balances and holds no block."""
    for rid, part in router.block_partitions().items():
        check(part["free"] + part["evictable"] + part["in_use"]
              == part["usable"] and part["in_use"] == 0,
              f"replica {rid} pool partition {part}")


def fleet_phase(prompts, news):
    """Phase 26 (cell R): A's model through a 3-replica router with live
    migration. Weights held once; phase 4's trace in turns with one
    supervisor; a replica killed mid-trace; a rolling restart under a
    live trace; a drain that migrates its requests. Returns (metrics,
    main-path launches)."""
    import torch
    from paddle_tpu_torch.inference.serving import (EngineSupervisor,
                                                    InvariantAuditor,
                                                    RouterConfig,
                                                    ServingConfig,
                                                    ServingRouter)
    from paddle_tpu_torch.models.llama import init_params
    cfg = model_config(torch.bfloat16)
    params = init_params(cfg, seed=SEED, device="cuda")
    out = {}
    # build: one replica, then two spawns, memory read after each
    r = ServingRouter(params, cfg, ServingConfig(),
                      router_config=RouterConfig(replicas=1, max_replicas=3,
                                                 migrate=True),
                      device="cuda")
    mem = [mem_gb()]
    for _ in range(2):
        r.spawn_replica()
        mem.append(mem_gb())
    pool = r._replicas[0].sup.engine.cache.kv_bytes() / 2**30
    ptrs = {rep.sup.engine.prepared_params["layers"]["wq"].data_ptr()
            for rep in r._replicas.values()}
    out["build"] = {"mem_gb_1_2_3": mem, "pool_gb": pool}
    log(f"  memory with 1 / 2 / 3 replicas: {mem[0]:.3f} / {mem[1]:.3f} / "
        f"{mem[2]:.3f} GB (one KV pool {pool:.3f} GB); weights shared: "
        f"{len(ptrs) == 1}")
    check(len(ptrs) == 1, "replicas hold separate weight copies")
    check(mem[2] - mem[0] <= 2 * pool * 1.05,
          f"3 replicas hold {mem[2] - mem[0]:.3f} GB over 1 (limit 2 pools "
          f"+ 5 % = {2 * pool * 1.05:.3f} GB)")
    for rid in r.replicas:                   # warm-up, one short request each
        r.submit(prompts[0][:40], max_new_tokens=4, eos_token_id=None,
                 replica=rid)
    while r.pending:
        r.step()
    sup = EngineSupervisor(r._params, cfg, ServingConfig(), device="cuda")
    sup.engine.run([prompts[0][:40]], max_new_tokens=4, eos_token_id=None)
    aud = InvariantAuditor()

    def audit_step(_):
        v = aud.check(r, collect=True)
        check(v == [], f"auditor: {[str(x) for x in v]}")

    turns, launches = [], None
    for kind in ("supervisor", "fleet", "fleet", "supervisor"):
        if kind == "supervisor":
            _, _, m = client_drive(sup, prompts, news)
            turns.append({"kind": kind, "tok_s": m["tok_s"],
                          "ttft_p50_s": m["ttft_p50_s"],
                          "ttft_max_s": m["ttft_max_s"]})
            continue
        c0, s0 = router_counters(r), fleet_stats(r)
        inner = replica_step_ms(r)
        reset_counts()
        ids, got, m = client_drive(r, prompts, news, after_step=audit_step)
        c = read_counts()
        for rep in r._replicas.values():
            del rep.sup.step
        s1 = fleet_stats(r)
        dc = counter_delta(c0, router_counters(r))
        iters = fleet_delta(s0, s1, "decode_iters")
        mixed = fleet_delta(s0, s1, "mixed_dispatches")
        dec = c["paged_attention"] - c["paged_attention_multiquery"]
        check(dec == 12 * iters, f"fleet: {dec} decode launches for "
              f"{iters} decode iterations")
        check(c["paged_attention_multiquery"] == 12 * mixed,
              f"fleet: {c['paged_attention_multiquery']} multi-query "
              f"launches for {mixed} mixed dispatches")
        balanced_fleet(r)
        turns.append({"kind": kind, "tok_s": m["tok_s"],
                      "ttft_p50_s": m["ttft_p50_s"],
                      "ttft_max_s": m["ttft_max_s"],
                      "ms_per_submit": m["ms_per_submit"],
                      "ms_per_step": m["ms_per_step"],
                      "router_ms_per_step": (sum(m["step_ms"])
                                             - inner["ms"]) / m["steps"],
                      "audit_ms_per_step": m["after_step_ms"] / m["steps"],
                      "routed": dc["routed"],
                      "sticky_hits": dc["sticky_hits"],
                      "directory_hits": dc["directory_hits"],
                      "per_replica": sorted(
                          sum(1 for i in ids if r.request(i).replica == rid)
                          for rid in r.replicas)})
        if launches is None:
            launches = c
            log(f"  launches (first fleet turn): {json.dumps(c)}")
    aud.quiesce(r)
    out["turns"] = turns
    log(f"  in turns (supervisor, fleet, fleet, supervisor): "
        f"{json.dumps(turns)}")
    del sup
    release()

    # failover: replica 0 killed at its decode iteration 10 (audited at
    # the end, so the kill and the emissions share one clock)
    c0 = router_counters(r)
    fired = arm_kill(r, 0, at_decode_iter=10)
    ids, got, m = client_drive(r, prompts, news)
    audit_step(None)
    dc = counter_delta(c0, router_counters(r))
    moved = [i for i in ids if r.request(i).failovers > 0]
    check("t" in fired, "the armed kill never fired")
    check(dc["failovers"] >= 1 and dc["failed"] == 0,
          f"failover counters {dc}")
    check(r._replicas[0].sup.broken, "the killed replica is not broken")
    # the first token any failed-over request delivers after the kill
    after = [now for now, who in m["emits"]
             if now > fired["t"] and who & set(moved)]
    first_after = min(after) if after else None
    out["failover"] = {"tok_s": m["tok_s"], "failovers": dc["failovers"],
                       "failover_tokens": dc["failover_tokens"],
                       "moved_requests": len(moved),
                       "kill_to_first_token_ms":
                           None if first_after is None
                           else (first_after - fired["t"]) * 1e3}
    log(f"  replica 0 killed at decode iteration 10: "
        f"{json.dumps(out['failover'])}")
    balanced_fleet(r)

    # rolling restart under a live trace (heals the killed replica)
    c0 = router_counters(r)
    mem0 = mem_gb()

    def start_roll(i):
        audit_step(i)
        if i == 0:
            r.start_rolling_restart()

    ids, got, m = client_drive(r, prompts, news, after_step=start_roll)
    while r.rolling:
        r.step()
    dc = counter_delta(c0, router_counters(r))
    mem1 = mem_gb()
    check(dc["replica_restarts"] == 3 and dc["failed"] == 0,
          f"roll counters {dc}")
    check(abs(mem1 - mem0) <= pool, f"memory {mem0:.3f} -> {mem1:.3f} GB "
          f"across the roll (one pool {pool:.3f})")
    check(all(not rep.sup.broken for rep in r._replicas.values()),
          "a replica is still broken after the roll")
    out["roll"] = {"tok_s": m["tok_s"], "replica_restarts":
                   dc["replica_restarts"], "migrations": dc["migrations"],
                   "migration_fallbacks": dc["migration_fallbacks"],
                   "mem_gb_before_after": [mem0, mem1]}
    log(f"  rolling restart under phase 4's trace: {json.dumps(out['roll'])}")
    balanced_fleet(r)

    # live migration: drain the busiest replica after 10 decode iterations
    spent = {}
    for rep in r._replicas.values():
        timed_method(rep.sup.engine, "serialize_request", spent, "ser")
        timed_method(rep.sup.engine, "adopt", spent, "adopt")
    c0, s0 = router_counters(r), fleet_stats(r)
    state = {}

    def drain_busiest(i):
        audit_step(i)
        if "rid" in state:
            return
        s = fleet_stats(r)
        if max(s[k]["decode_iters"] - s0[k]["decode_iters"]
               for k in s) >= 10:
            busiest = max(r._replicas.values(), key=lambda rep: rep.depth())
            state["rid"] = busiest.rid
            r.drain_replica(busiest.rid)

    half = len(prompts) // 2
    ids, got, m = client_drive(r, prompts[:half], news[:half],
                               after_step=drain_busiest)
    for _ in range(3):
        r.step()
    dc = counter_delta(c0, router_counters(r))
    s1 = fleet_stats(r)
    rc = fleet_delta(s0, s1, "recomputed_tokens")
    check("rid" in state and state["rid"] not in r._replicas,
          "the drained replica was not removed")
    check(dc["migrations"] >= 1 and dc["migration_fallbacks"] == 0
          and rc == 0, f"migration: {dc}, recomputed {rc}")
    mem_after = mem_gb()
    check(mem_after <= mem[1] + pool,
          f"memory after removing a replica {mem_after:.3f} GB (2-replica "
          f"level {mem[1]:.3f}, one pool {pool:.3f})")
    per = []
    for p in spent.get("ser_out", []):
        if p is None or p["kv"] is None or p["kv"]["data"] is None:
            continue
        per.append({"blocks": p["kv"]["data_blocks"],
                    "mb": sum(t.numel() * t.element_size()
                              for t in p["kv"]["data"].values()) / 2**20})
    ser_ms = [t for t, p in zip(spent.get("ser_n", []),
                                spent.get("ser_out", []))
              if p is not None and p["kv"] is not None
              and p["kv"]["data"] is not None]
    adopt_ms = spent.get("adopt_n", [])
    for k, row in enumerate(per):
        row["serialize_ms"] = ser_ms[k] if k < len(ser_ms) else None
        row["adopt_ms"] = adopt_ms[k] if k < len(adopt_ms) else None
        nb = row["mb"] * 2**20
        row["d2h_gb_s"] = nb / row["serialize_ms"] / 1e6
        row["h2d_gb_s"] = nb / row["adopt_ms"] / 1e6 \
            if row["adopt_ms"] else None
        row["pcie_bound_ms"] = nb / PCIE_BYTES_PER_S * 1e3
    out["migration"] = {"drained": state["rid"],
                        "migrations": dc["migrations"],
                        "migration_tokens": dc["migration_tokens"],
                        "recomputed_tokens": rc, "mem_gb": mem_after,
                        "per_request": per}
    log(f"  drain of the busiest replica after 10 decode iterations: "
        f"{json.dumps(out['migration'])}")
    aud.quiesce(r)
    balanced_fleet(r)
    del r, params
    release()
    return out, launches


def share_waves(vocab, seed, fams=16, pre=256, tail=16):
    """Cell S's pull traffic: a placement wave (one request a family of a
    ``pre``-token prefix), a sharing wave (a fresh tail on each prefix)
    and one more family (placement and sharing request) for the corrupt
    export."""
    place, share = family_trace(vocab, seed, fams=fams + 1, per=1, pre=pre,
                                tail=tail)
    return place[:fams], share[:fams], place[fams], share[fams]


def pull_turn(params, cfg, on, waves, new=16):
    """One turn of the pull experiment on a fresh 2-replica fleet:
    placement pinned to replica 0, sharing pinned to replica 1 (timed),
    then the extra family with replica 0's next export corrupted.
    Returns (metrics, sharing streams, the extra family's stream,
    main-path launches)."""
    from paddle_tpu_torch.inference.serving import (InvariantAuditor,
                                                    RouterConfig,
                                                    ServingConfig,
                                                    ServingRouter)
    from paddle_tpu_torch.inference.serving.offload import block_crc
    place, share, xplace, xshare = waves
    r = ServingRouter(params, cfg, ServingConfig(prefix_cache=True),
                      router_config=RouterConfig(replicas=2,
                                                 fleet_cache=on),
                      device="cuda")
    r0, r1 = r.replicas
    warm = np.arange(7, 47, dtype=np.int32)   # shares no family's blocks
    for rid in (r0, r1):
        r.submit(warm, max_new_tokens=4, eos_token_id=None, replica=rid)
    while r.pending:
        r.step()
    client_drive(r, place, [new] * len(place), pins=[r0] * len(place))
    spent = {}
    timed_method(r._replicas[r0].sup.engine, "export_chain", spent, "exp")
    timed_method(r._replicas[r1].sup.engine, "graft_chain", spent, "graft")
    c0, s0 = router_counters(r), fleet_stats(r)
    reset_counts()
    ids, got, m = client_drive(r, share, [new] * len(share),
                               pins=[r1] * len(share))
    c = read_counts()
    dc = counter_delta(c0, router_counters(r))
    s1 = fleet_stats(r)
    hit = s1[r1]["prefix_hit_tokens"] - s0[r1]["prefix_hit_tokens"]
    payloads = [p for p in spent.get("exp_out", []) if p is not None]
    blocks = sum(len(p["blocks"]) for p in payloads)
    # the host CRC32 of a block (every leaf), which the export stamps
    # and the graft verifies: its share of both
    t = time.time()
    for p in payloads:
        for blk in p["blocks"]:
            for a in blk["data"].values():
                block_crc(a)
    crc_ms = (time.time() - t) * 1e3 / blocks if blocks else None
    turn = {"fleet_cache": on, "ttft_p50_s": m["ttft_p50_s"],
            "ttft_max_s": m["ttft_max_s"], "tok_s": m["tok_s"],
            "cache_pulls": dc["cache_pulls"],
            "pulled_blocks": dc["pulled_blocks"],
            "pull_fallbacks": dc["pull_fallbacks"],
            "prefix_tokens_recomputed": 256 * len(share) - hit,
            "export_ms_per_block": spent.get("exp", 0.0) / blocks
            if blocks else None,
            "graft_ms_per_block": spent.get("graft", 0.0) / blocks
            if blocks else None,
            "crc_ms_per_block": crc_ms}
    # the extra family: placed on replica 0, replica 0's next export
    # corrupted, its sharing request pinned to replica 1
    client_drive(r, [xplace], [new], pins=[r0])
    r._replicas[r0].sup.engine._corrupt_next_export = on
    c0 = router_counters(r)
    _, xgot, _ = client_drive(r, [xshare], [new], pins=[r1])
    turn["corrupt_pull_fallbacks"] = counter_delta(
        c0, router_counters(r))["pull_fallbacks"]
    check(InvariantAuditor().quiesce(r, collect=True) == [],
          "auditor at quiesce")
    balanced_fleet(r)
    del r
    release()
    return turn, [got[i] for i in ids], list(xgot.values())[0], c


def long_trace(vocab, seed, n=8, lens=(512, 1024), outs=(16, 64)):
    """``n`` long prompts (a long document to summarize, a RAG context)."""
    rng = np.random.default_rng(seed)
    return ([rng.integers(0, vocab, int(rng.integers(lens[0], lens[1] + 1)))
             .astype(np.int32) for _ in range(n)],
            [int(rng.integers(outs[0], outs[1] + 1)) for _ in range(n)])


def cache_phase(prompts, news):
    """Phase 27 (cell S): cross-replica chain pulls with the fleet cache
    on and off in turns, a corrupt export; then disaggregated prefill in
    turns with the unified fleet. Returns (metrics, main-path
    launches)."""
    import torch
    from paddle_tpu_torch.inference.serving import (RouterConfig,
                                                    ServingConfig,
                                                    ServingRouter)
    from paddle_tpu_torch.models.llama import init_params
    cfg = model_config(torch.bfloat16)
    params = init_params(cfg, seed=SEED, device="cuda")
    waves = share_waves(cfg.vocab_size, SEED + 27)
    turns, xs, launches = [], {}, None
    for on in (False, True, True, False):
        t, _, xstream, c = pull_turn(params, cfg, on, waves)
        xs.setdefault(on, []).append(xstream)
        if on:
            check(t["cache_pulls"] >= 16 and t["pulled_blocks"] == 256
                  and t["pull_fallbacks"] == 0
                  and t["prefix_tokens_recomputed"] == 0,
                  f"pull turn {t}")
            check(t["corrupt_pull_fallbacks"] == 1,
                  f"a corrupt export gave {t['corrupt_pull_fallbacks']} "
                  f"pull fallbacks")
            if launches is None:
                launches = c
        turns.append(t)
    check(all(x == xs[False][0] for x in xs[True] + xs[False]),
          "the corrupt pull's recomputed stream differs from the stream "
          "without the fleet cache")
    log(f"  pulls in turns (off, on, on, off): {json.dumps(turns)}")
    log(f"  a corrupt export: one pull fallback, its stream equal to the "
        f"fleet-cache-off turns'")
    # disaggregated prefill against the unified fleet, 16 clients
    lp, ln = long_trace(cfg.vocab_size, SEED + 28)
    tp, tn = [], []
    for i, (p, n) in enumerate(zip(prompts, news)):
        tp.append(p)
        tn.append(n)
        if i % 3 == 2 and lp:
            tp.append(lp.pop())
            tn.append(ln.pop())
    dis = []
    for split in (False, True, True, False):
        rc = (RouterConfig(replicas=2, prefill_replicas=1,
                           prefill_len_threshold=256) if split
              else RouterConfig(replicas=3))
        r = ServingRouter(params, cfg, ServingConfig(prefill_chunk=256),
                          router_config=rc, device="cuda")
        for rid in r.replicas:
            r.submit(prompts[0][:40], max_new_tokens=4, eos_token_id=None,
                     replica=rid)
        while r.pending:
            r.step()
        c0, s0 = router_counters(r), fleet_stats(r)
        reset_counts()
        # a streaming client: every token delivered as it is produced
        ids, got, m = client_drive(r, tp, tn, max_iters=1, concurrency=16)
        c = read_counts()
        dc = counter_delta(c0, router_counters(r))
        rc_tokens = fleet_delta(s0, fleet_stats(r), "recomputed_tokens")
        # time per output token of the short requests (the ones a long
        # prefill would stall)
        tpot = [(m["t_last"][i] - m["t_first"][i]) / (n - 1) * 1e3
                for i, p, n in zip(ids, tp, tn) if len(p) < 256 and n > 1]
        row = {"split": split, "tok_s": m["tok_s"],
               "ttft_p50_s": m["ttft_p50_s"], "ttft_max_s": m["ttft_max_s"],
               "short_tpot_p50_ms": float(np.percentile(tpot, 50)),
               "short_tpot_p99_ms": float(np.percentile(tpot, 99)),
               "prefill_routed": dc["prefill_routed"],
               "prefill_handoffs": dc["prefill_handoffs"],
               "handoff_fallbacks": dc["handoff_fallbacks"],
               "recomputed_tokens": rc_tokens}
        if split:
            check(dc["prefill_routed"] >= 8 and dc["prefill_handoffs"] >= 1
                  and dc["handoff_fallbacks"] == 0 and rc_tokens == 0,
                  f"disaggregated prefill {row}")
            check(c["paged_attention"] > 0, f"split run launches {c}")
        dis.append(row)
        balanced_fleet(r)
        del r
        release()
    log(f"  disaggregated prefill in turns (unified, split, split, "
        f"unified; 16 clients, {len(tp)} requests): {json.dumps(dis)}")
    del params
    release()
    return {"pull_turns": turns, "disagg_turns": dis}, launches


def fleet_parity_phase(sp, sn, tmp):
    """Phase 28: fp32 on C's model and trace (half the requests seeded,
    the fleet stepped 2 decode iterations at a time): every fleet path's
    streams equal the single engine's; then the migration and the pull
    at int8."""
    import os
    import torch
    from paddle_tpu_torch.inference.serving import (RequestJournal,
                                                    RouterConfig,
                                                    ServingConfig,
                                                    ServingEngine,
                                                    ServingRouter)
    from paddle_tpu_torch.models.llama import init_params
    from paddle_tpu_torch.models.lora import lora_init_params
    cfg32 = model_config(torch.float32)
    params = init_params(cfg32, seed=SEED + 1, device="cuda")
    knobs = [dict(SAMPLED, seed=i) if i % 2 else {} for i in range(len(sp))]
    done = []

    def single(sc=None, prompts=sp, news=sn, kn=knobs, adapters=None):
        eng = ServingEngine(params, cfg32, sc or ServingConfig(),
                            device="cuda")
        for name, ap in (adapters or {}).items():
            eng.register_adapter(name, ap)
        outs, _ = drive(eng, prompts, news, kn, max_iters=2)
        del eng
        release()
        return [[int(t) for t in o] for o in outs]

    def fleet(sc=None, **rc):
        return ServingRouter(params, cfg32, sc or ServingConfig(),
                             router_config=RouterConfig(**rc),
                             device="cuda")

    def run(name, r, after_step=None, prompts=sp, news=sn, kn=knobs,
            want=None, pins=None):
        ids, got, _ = client_drive(r, prompts, news, kn, max_iters=2,
                                   after_step=after_step, pins=pins)
        streams = [got[i] for i in ids]
        for k, (a, b) in enumerate(zip(streams, want)):
            check(a == b, f"fp32 {name}, request {k}: {a} != {b}")
        balanced_fleet(r)
        done.append(name)
        return ids

    want = single()
    # a 3-replica fleet; a replica killed
    r = fleet(replicas=3)
    run("3-replica fleet", r, want=want)
    del r
    release()
    r = fleet(replicas=3)
    c0 = router_counters(r)
    run("replica kill", r, want=want,
        after_step=lambda i: arm_kill(r, 0) if i == 1 else None)
    dc = counter_delta(c0, router_counters(r))
    check(dc["failovers"] >= 1 and dc["failed"] == 0, f"kill {dc}")
    del r
    release()
    # a crash loop opens the breaker and evacuates
    r = fleet(replicas=2)
    r._replicas[0].sup.max_restarts = 10

    def crash_loop(i):
        if 1 <= i <= r.config.breaker_threshold:
            arm_crash(r._replicas[0].sup, 0)

    c0 = router_counters(r)
    run("crash loop", r, want=want, after_step=crash_loop)
    dc = counter_delta(c0, router_counters(r))
    check(r._replicas[0].breaker.opens >= 1 and dc["failovers"] >= 1,
          f"crash loop: breaker {r._replicas[0].breaker.snapshot()}, {dc}")
    del r
    release()
    # a slow replica under hedging
    r = fleet(replicas=2, hedge_ttft_mult=2.0, ttft_slo_s=0.01, seed=1)
    slow_replica(r, 0, stall_steps=100, delay_s=0.01)
    c0 = router_counters(r)
    run("hedge", r, prompts=sp[:1], news=sn[:1], kn=knobs[:1],
        want=want[:1], pins=[0])
    dc = counter_delta(c0, router_counters(r))
    check(dc["hedges"] == dc["hedge_wins"] == dc["hedges_cancelled"] == 1,
          f"hedging {dc}")
    del r
    release()
    # a flaky probe: the breaker opens, then closes after a half-open probe
    r = fleet(replicas=2)
    rep0 = r._replicas[0]
    rep0.breaker.cooldown_s = 60.0
    flaky_probe(r, 0, fails=3)
    for k in range(3):
        ids = run("flaky probe", r, prompts=sp[k:k + 1], news=sn[k:k + 1],
                  kn=knobs[k:k + 1], want=want[k:k + 1])
        check(r.request(ids[0]).replica == 1, "routed to the flaky replica")
    check(rep0.breaker.state == "open", "the breaker did not open")
    rep0.breaker.cooldown_s = 0.02
    time.sleep(0.03)
    run("half-open probe", r, prompts=sp[3:4], news=sn[3:4], kn=knobs[3:4],
        want=want[3:4])
    check(rep0.breaker.state == "closed" and rep0.breaker.reclosures >= 1,
          f"breaker {rep0.breaker.snapshot()}")
    run("rejoined replica", r, prompts=sp[4:5], news=sn[4:5],
        kn=knobs[4:5], want=want[4:5], pins=[0])
    del r
    release()
    # a rolling restart with deadline 0 (the failover path)
    r = fleet(replicas=2)
    c0 = router_counters(r)
    run("roll, deadline 0", r, want=want,
        after_step=lambda i: r.start_rolling_restart(drain_deadline_s=0.0)
        if i == 0 else None)
    while r.rolling:
        r.step()
    dc = counter_delta(c0, router_counters(r))
    check(dc["replica_restarts"] == 2 and dc["failed"] == 0, f"roll {dc}")
    del r
    release()
    # a drain with migration
    r = fleet(replicas=3, migrate=True)
    c0, s0 = router_counters(r), fleet_stats(r)
    run("drain with migration", r, want=want,
        after_step=lambda i: r.drain_replica(0) if i == 0 else None)
    dc = counter_delta(c0, router_counters(r))
    rc_tokens = fleet_delta(s0, fleet_stats(r), "recomputed_tokens")
    check(dc["migrations"] >= 1 and dc["migration_fallbacks"] == 0
          and rc_tokens == 0, f"migration {dc}, recomputed {rc_tokens}")
    del r
    release()
    # a pinned pull, and a prefill handoff
    rng = np.random.default_rng(SEED + 29)
    prefix = sp[2][:64]                        # the 300-token prompt
    pp = [np.concatenate([prefix, rng.integers(0, cfg32.vocab_size, 8)
                          .astype(np.int32)]) for _ in range(2)]
    pwant = single(prompts=pp, news=[8, 8], kn=[{}, knobs[1]])
    r = fleet(replicas=2)
    run("placement", r, prompts=pp[:1], news=[8], kn=[{}], want=pwant[:1],
        pins=[0])
    c0 = router_counters(r)
    run("pinned pull", r, prompts=pp[1:], news=[8], kn=[knobs[1]],
        want=pwant[1:], pins=[1])
    dc = counter_delta(c0, router_counters(r))
    check(dc["cache_pulls"] == 1 and dc["pulled_blocks"] == 4
          and dc["pull_fallbacks"] == 0, f"pull {dc}")
    del r
    release()
    r = fleet(replicas=1, prefill_replicas=1, prefill_len_threshold=256)
    c0, s0 = router_counters(r), fleet_stats(r)
    run("prefill handoff", r, want=want)
    dc = counter_delta(c0, router_counters(r))
    rc_tokens = fleet_delta(s0, fleet_stats(r), "recomputed_tokens")
    check(dc["prefill_handoffs"] >= 1 and dc["handoff_fallbacks"] == 0
          and rc_tokens == 0, f"handoff {dc}, recomputed {rc_tokens}")
    del r
    release()
    # a journaled fleet, its journal abandoned mid-trace, a cold start
    jdir = os.path.join(tmp, "fleet-journal")
    r = ServingRouter(params, cfg32, ServingConfig(),
                      router_config=RouterConfig(replicas=2),
                      journal=RequestJournal(jdir), device="cuda")
    frids = [r.submit(p, max_new_tokens=n, eos_token_id=None, **k)
             for p, n, k in zip(sp, sn, knobs)]
    jids = [r.request(f).jid for f in frids]
    pre = {j: [] for j in jids}
    for _ in range(3):
        for f, toks in r.step(2).items():
            pre[r.request(f).jid].extend(int(t) for t in toks)
    r.journal.abandon()
    del r
    release()
    rt = ServingRouter.cold_start(jdir, params, cfg32, ServingConfig(),
                                  router_config=RouterConfig(replicas=2),
                                  device="cuda")
    steps = 0
    while rt.pending:
        for f, toks in rt.step(2).items():
            pre[rt.request(f).jid].extend(int(t) for t in toks)
        steps += 1
        check(steps < 2000, "the cold-started fleet did not drain")
    for k, j in enumerate(jids):
        check(pre[j] == want[k], f"cold start, request {k}: {pre[j]} != "
              f"{want[k]}")
    check(rt.cold_recovered >= 1, "cold start recovered nothing")
    balanced_fleet(rt)
    del rt
    release()
    done.append("cold start")
    # two adapters registered through the router; failover re-pins them
    adapters = {f"a{i}": lora_init_params(cfg32, LORA_RANK, seed=200 + i)
                for i in (1, 2)}
    lsc = ServingConfig(lora_rank=LORA_RANK, lora_slots=2, lora_pool=8)
    aids = [None, "a1", "a2", "a1", "a2", None][:len(sp)]
    akn = [dict(k, adapter_id=a) for k, a in zip(knobs, aids)]
    awant = single(lsc, kn=akn, adapters=adapters)
    r = fleet(lsc, replicas=2)
    for name, ap in adapters.items():
        r.register_adapter(name, ap)
    ids = run("adapters, replica kill", r, kn=akn, want=awant,
              after_step=lambda i: arm_kill(r, 0) if i == 1 else None)
    check(router_counters(r)["failovers"] >= 1, "no adapter failover")
    for i, a in zip(ids, aids):
        check(r.request(i).adapter_id == a, "failover changed an adapter")
    del r
    release()
    log(f"  fp32 fleet streams equal the single engine's: "
        f"{', '.join(done)}")

    # int8 (weights and KV): the migration and the pull
    isc = dict(quantize="int8", kv_quant="int8")
    iwant = single(ServingConfig(**isc))
    r = fleet(ServingConfig(**isc), replicas=3, migrate=True)
    spent = {}
    for rep in r._replicas.values():
        timed_method(rep.sup.engine, "serialize_request", spent, "ser")
    c0 = router_counters(r)
    reset_counts()
    run("int8 drain with migration", r, want=iwant,
        after_step=lambda i: r.drain_replica(0) if i == 0 else None)
    c = read_counts()
    dc = counter_delta(c0, router_counters(r))
    leaves = {n for p in spent.get("ser_out", []) if p and p["kv"]
              and p["kv"]["data"] for n in p["kv"]["data"]}
    check(dc["migrations"] >= 1 and dc["migration_fallbacks"] == 0,
          f"int8 migration {dc}")
    check(leaves == {"k", "v", "k_scale", "v_scale"},
          f"int8 payload leaves {leaves}")
    del r
    release()
    pwant8 = single(ServingConfig(**isc), prompts=pp, news=[8, 8],
                    kn=[{}, knobs[1]])
    r = fleet(ServingConfig(**isc), replicas=2)
    run("int8 placement", r, prompts=pp[:1], news=[8], kn=[{}],
        want=pwant8[:1], pins=[0])
    c0 = router_counters(r)
    run("int8 pinned pull", r, prompts=pp[1:], news=[8], kn=[knobs[1]],
        want=pwant8[1:], pins=[1])
    dc = counter_delta(c0, router_counters(r))
    check(dc["cache_pulls"] == 1 and dc["pull_fallbacks"] == 0,
          f"int8 pull {dc}")
    del r
    release()
    check(c["weight_only_matmul"] > 0 and c["paged_attention_int8"] > 0,
          f"int8 fleet launches {c}")
    log(f"  int8: the drain's migrations move k, v and their scales, the "
        f"pull grafts int8 blocks; streams equal the unmigrated int8 "
        f"engine's; launches {json.dumps(c)}")
    del params
    release()
    return {"paths": done}, c


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on "
              "a card", file=sys.stderr)
        return 2
    try:
        import paddle_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: run from a checkout of the repository ({e})",
              file=sys.stderr)
        return 2
    from paddle_tpu_torch.inference.serving import (ServingConfig,
                                                    ServingEngine)
    from paddle_tpu_torch.kernels import build
    from paddle_tpu_torch.models import generation as G
    from paddle_tpu_torch.models.llama import init_params

    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 means fp32
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.time()

    log("== phase 1: environment")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    card = smi.splitlines()[0]
    log(f"  python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"cuda {torch.version.cuda}  device {torch.cuda.get_device_name(0)}")
    log(f"  nvidia-smi: {card}")

    log("== phase 2: build")
    secs = build.build_all()
    log(f"  built {', '.join(build.SOURCES)} in {secs:.1f} s")

    log("== phase 3: kernels against their plain versions")
    att = [attention_case("decode bf16 M=8 H=16 Hk=16 D=128 bs=16 W=128",
                          8, 16, 16, 128, 16, 128, False, seed=1),
           attention_case("decode int8 M=8 H=16 Hk=16 D=128 bs=16 W=128",
                          8, 16, 16, 128, 16, 128, True, seed=2),
           attention_case("decode GQA bf16 M=8 H=32 Hk=8 D=128 bs=16 W=128",
                          8, 32, 8, 128, 16, 128, False, seed=3)]
    for Q in (1, 8, 256):
        att.append(attention_case(
            f"multi-query bf16 Q={Q} M=8 H=16 Hk=16 D=128 bs=16 W=128",
            8, 16, 16, 128, 16, 128, False, Q=Q, seed=10 + Q))
    att.append(attention_case(
        "multi-query int8 Q=256 M=8 H=16 Hk=16 D=128 bs=16 W=128",
        8, 16, 16, 128, 16, 128, True, Q=256, seed=4))
    # the speculative verify (spec_decode 4): draft_lens 0..4 on the rows
    for name, H, Hk, quant in (("bf16", 16, 16, False),
                               ("int8", 16, 16, True),
                               ("GQA bf16", 32, 8, False)):
        att.append(attention_case(
            f"verify {name} Q=5 M=8 H={H} Hk={Hk} D=128 bs=16 W=128 "
            f"draft_lens 0..4", 8, H, Hk, 128, 16, 128, quant, Q=5,
            seed=40 + H + Hk + quant, every_draft_len=True))
    mm = [matmul_case(M, K, N, seed=M + K + N)
          for M in (8, 2048)
          for K, N in ((2048, 2048), (2048, 5504), (5504, 2048),
                       (2048, 32000))]
    torch.cuda.synchronize()

    log("== phase 4: serving engine, full width, bf16")
    cfg = model_config(torch.bfloat16)
    params = init_params(cfg, seed=SEED, device="cuda")
    prompts, news = make_trace(24, cfg.vocab_size, SEED)
    engine = ServingEngine(params, cfg, ServingConfig(), device="cuda")
    st = engine.stats()
    check(st["paged_kernel"] is True, "paged kernel not resolved on")
    engine.run([prompts[0][:40]], max_new_tokens=4, eos_token_id=None)
    reset_counts()
    greedy4, m4 = drive(engine, prompts, news)
    c4 = read_counts()
    check(c4["paged_attention"] - c4["paged_attention_multiquery"] > 0,
          "decode entry point never launched")
    check(c4["paged_attention_multiquery"] > 0,
          "multi-query entry point never launched")
    check(m4["mixed_dispatches"] > 0, "no mixed dispatch")
    log(f"  {json.dumps(m4)}")
    log(f"  launches: {json.dumps(c4)}")
    fresh = make_trace(8, cfg.vocab_size, SEED + 2)
    profile_drain(engine, *fresh)
    del engine
    torch.cuda.empty_cache()

    log("== phase 5: same trace, quantize=int8 + kv_quant=int8")
    engine = ServingEngine(params, cfg, ServingConfig(
        quantize="int8", kv_quant="int8"), device="cuda")
    engine.run([prompts[0][:40]], max_new_tokens=4, eos_token_id=None)
    reset_counts()
    greedy5, m5 = drive(engine, prompts, news)
    c5 = read_counts()
    check(c5["weight_only_matmul"] > 0, "weight_only_matmul never launched")
    check(c5["paged_attention_int8"] > 0,
          "int8 paged_attention never launched")
    log(f"  {json.dumps(m5)}")
    log(f"  launches: {json.dumps(c5)}")
    profile_drain(engine, *fresh)
    launches = {k: c4[k] + c5[k] for k in c4}
    del engine, params
    torch.cuda.empty_cache()

    log("== phase 6: fp32 parity, kernel engine vs gather engine")
    cfg32 = model_config(torch.float32)
    params = init_params(cfg32, seed=SEED + 1, device="cuda")
    sp, sn = make_trace(6, cfg32.vocab_size, SEED + 1, long_len=300,
                        lens=(20, 120), outs=(8, 12))
    # first-dispatch logits: one batched prefill, then one decode step
    # through each attention path on copies of the same pool
    _, pool, tok, (sl, tbl, act), _ = first_dispatch(params, cfg32, sp)
    out = {}
    for use in (True, False):
        lg, _, _ = G.paged_decode_step(
            params, cfg32, tok, sl, tbl,
            {k: v.clone() for k, v in pool.items()}, act, use_kernel=use)
        out[use] = lg
    logit_err = (out[True] - out[False]).abs().max().item()
    log(f"  first decode dispatch logits, kernel vs gather: max abs err "
        f"{logit_err:.3g}")
    check(logit_err <= 1e-3, f"fp32 logit error {logit_err}")
    del pool
    streams = {}
    for knob in ("on", "off"):
        eng = ServingEngine(params, cfg32, ServingConfig(paged_kernel=knob),
                            device="cuda")
        streams[knob], _ = drive(eng, sp, sn)
        del eng
        torch.cuda.empty_cache()
    for i, (a, b) in enumerate(zip(streams["on"], streams["off"])):
        check(np.array_equal(a, b), f"request {i}: kernel stream {a} != "
              f"gather stream {b}")
    log(f"  {len(sp)} fp32 streams equal between the kernel and gather "
        f"engines")

    del params
    torch.cuda.empty_cache()

    log("== phase 7: flash-attention kernels against their plain versions")
    fl = [flash_case("(a) B=8 S=2048 H=Hk=16 D=128 causal", 8, 2048, 2048,
                     16, 16, 128, True, seed=21, probe=True),
          flash_case("(b) GQA B=2 S=2048 H=32 Hk=8 D=128 causal", 2, 2048,
                     2048, 32, 8, 128, True, seed=22),
          flash_case("(c) packed B=4 S=2048 H=Hk=16 D=128 causal 4 segments",
                     4, 2048, 2048, 16, 16, 128, True, n_segs=4, seed=23),
          flash_case("(d) B=8 Sq=1024 Sk=2048 H=Hk=16 D=128 causal", 8,
                     1024, 2048, 16, 16, 128, True, seed=24)]
    torch.cuda.empty_cache()

    log("== phase 8: training, full width, bf16, use_kernels + full remat")
    m8, c8 = train_phase()
    torch.cuda.empty_cache()

    log("== phase 9: fp32 training parity, flash kernels vs plain attention")
    parity_phase("use_kernels")

    log("== phase 10: RMSNorm and RoPE kernels against their plain versions")
    bf, f32 = torch.bfloat16, torch.float32
    norms = [norm_case("(a) bf16 x, fp32 w, n=16384 d=2048", 16384, 2048, bf,
                       f32, True, seed=31),
             norm_case("(b) fp32 n=16384 d=2048", 16384, 2048, f32, f32, True,
                       seed=32),
             norm_case("(c) decode bf16 x, fp32 w, n=8 d=2048", 8, 2048, bf,
                       f32, False, seed=33)]
    for i in (0, 2):
        check(norms[i]["fwd"]["route"] == "registers",
              f"RMSNorm forward case {i}: route {norms[i]['fwd']['route']}")
    for i in (0, 1):
        check(norms[i]["bwd"]["route"] == "registers",
              f"RMSNorm backward case {i}: route {norms[i]['bwd']['route']}")
    ropes = (rope_case("q bf16 [8,2048,16,128]", 8, 2048, 16, 128, seed=34)
             + rope_case("GQA k bf16 [2,2048,8,128]", 2, 2048, 8, 128,
                         seed=35))
    torch.cuda.empty_cache()

    log("== phase 11: training, full width, bf16, use_kernels + full remat "
        "+ use_fused_norm")
    m11, c11 = train_phase(use_fused_norm=True)
    p8, p11 = m8["profile"], m11["profile"]
    log(f"  phase 8 -> phase 11: step {m8['step_ms']:.1f} -> "
        f"{m11['step_ms']:.1f} ms, tokens/s {m8['tokens_per_s']:.0f} -> "
        f"{m11['tokens_per_s']:.0f}, MFU {m8['mfu']:.4f} -> "
        f"{m11['mfu']:.4f}, peak {m8['max_memory_allocated_gb']:.2f} -> "
        f"{m11['max_memory_allocated_gb']:.2f} GB, busy "
        f"{p8.get('device_busy_share')} -> {p11.get('device_busy_share')}, "
        f"PyTorch elementwise {p8.get('elementwise_ms')} -> "
        f"{p11.get('elementwise_ms')} ms")
    torch.cuda.empty_cache()

    log("== phase 12: fp32 parity, fused norm + RoPE kernels vs plain")
    par = parity_phase("use_fused_norm")
    check(par["launches"]["rms_norm_bwd"] > 0
          and par["launches"]["apply_rope_bwd"] > 0,
          f"fused training never launched its kernels: {par['launches']}")
    params = init_params(cfg32, seed=SEED + 1, device="cuda")
    serve = {}
    for fused in (True, False):
        c = model_config(torch.float32, use_fused_norm=fused)
        reset_counts()
        pre, pool, tok, (sl, tbl, act), _ = first_dispatch(params, c, sp)
        dec, _, _ = G.paged_decode_step(params, c, tok, sl, tbl, pool, act,
                                        use_kernel=True)
        serve[fused] = (pre, dec, read_counts()["rms_norm"])
        del pool
    errs = [(serve[True][i] - serve[False][i]).abs().max().item()
            for i in (0, 1)]
    log(f"  serving first-dispatch logits, fused vs plain norm: prefill max "
        f"abs err {errs[0]:.3g}, decode {errs[1]:.3g}; rms_norm forward "
        f"launches {serve[True][2]} (plain run: {serve[False][2]})")
    check(max(errs) <= 1e-3, f"fp32 serving logits fused vs plain {errs}")
    check(serve[True][2] > 0 and serve[False][2] == 0,
          f"rms_norm forward launches {serve[True][2]} / {serve[False][2]}")
    del params, serve
    torch.cuda.empty_cache()

    log("== phase 13: sampled serving, full width, bf16")
    params = init_params(cfg, seed=SEED, device="cuda")
    _, c13 = sampled_phase(params, cfg, prompts, news, greedy4)

    log("== phase 14: speculative serving, full width, bf16, spec_decode=4 "
        "spec_ngram=2")
    _, c14 = spec_phase(params, cfg)
    del params
    torch.cuda.empty_cache()

    log("== phase 15: fp32 parity, sampled and speculative")
    params = init_params(cfg32, seed=SEED + 1, device="cuda")
    sampled_spec_parity_phase(params, cfg32, sp, sn)
    del params
    torch.cuda.empty_cache()
    for c in (c13, c14):
        launches = {k: launches[k] + c[k] for k in launches}

    log("== phase 16: remat policies, full width, bf16, use_kernels, phase "
        "8's step")
    remat_phase()
    torch.cuda.empty_cache()
    log("  F (phase 11's step) with remat_policy=\"save_flash\":")
    m16, _ = train_phase(steps=2, use_fused_norm=True,
                         remat_policy="save_flash")
    log(f"  phase 11 -> F with save_flash: step {m11['step_ms']:.1f} -> "
        f"{m16['step_ms']:.1f} ms, MFU {m11['mfu']:.4f} -> "
        f"{m16['mfu']:.4f}, peak {m11['max_memory_allocated_gb']:.2f} -> "
        f"{m16['max_memory_allocated_gb']:.2f} GB (not in turns)")
    torch.cuda.empty_cache()

    log("== phase 17: the tuned step (save_flash, ce_chunks 16, bf16 moments "
        "and gradients) with and without the health sentinel")
    tuned_phase()
    torch.cuda.empty_cache()

    log("== phase 18: MoE serving, full width, bf16, 8 experts top-2")
    moe_serving_phase(prompts, news, sp, sn)

    log("== phase 19: MoE training, full width, bf16, 8 experts top-2, 4 "
        "layers")
    train_phase(steps=3, num_hidden_layers=4, moe_num_experts=8,
                moe_top_k=2)
    torch.cuda.empty_cache()
    par = parity_phase("use_kernels", moe_num_experts=4, moe_top_k=2)
    check(par["launches"]["flash_attention"] > 0,
          f"MoE parity never launched the flash kernels: {par['launches']}")

    log("== phase 20: LoRA serving, full width, bf16, rank 16, 4 slots, 8 "
        "adapters")
    _, c20 = lora_serving_phase(prompts, news, greedy4, greedy5)
    launches = {k: launches[k] + c20[k] for k in launches}

    log("== phase 21: fp32 LoRA parity, 5 adapters on 2 slots")
    lora_parity_phase(sp, sn)

    log("== phase 22: the dense tier (generate, DecodeSession, "
        "GenerationPredictor)")
    dense_phase(sp, sn)

    log("== phase 23: host KV offload tier, full width, bf16, 16 families "
        "of a 256-token prefix, tier on and off in turns")
    _, c23 = offload_phase()
    log("== phase 24: journal, supervisor, hang watchdog")
    with tempfile.TemporaryDirectory() as tmp:
        _, c24 = robustness_phase(prompts, news, sp, sn, tmp)
    log("== phase 25: BERT-base embeddings beside A's generate traffic")
    _, c25 = embeddings_phase(prompts, news)
    for c in (c23, c24, c25):
        launches = {k: launches[k] + c[k] for k in launches}

    log("== phase 26: the serving fleet (cell R), full width, bf16, 3 "
        "replicas with live migration")
    _, c26 = fleet_phase(prompts, news)
    log("== phase 27: fleet cache pulls and disaggregated prefill (cell S), "
        "full width, bf16")
    _, c27 = cache_phase(prompts, news)
    log("== phase 28: fp32 fleet parity on C's model and trace, then int8")
    with tempfile.TemporaryDirectory() as tmp:
        _, c28 = fleet_parity_phase(sp, sn, tmp)
    for c in (c26, c27, c28):
        launches = {k: launches[k] + c[k] for k in launches}

    log(f"== done in {time.time() - t_start:.1f} s")
    kernels = [
        summarize("paged_attention", "paddle_tpu_torch/csrc/paged_attention.cu",
                  "paddle_tpu/kernels/paged_attention.py:70", att,
                  launches["paged_attention"]),
        summarize("weight_only_matmul", "paddle_tpu_torch/csrc/quant_matmul.cu",
                  "paddle_tpu/kernels/quant_matmul.py:47", mm,
                  launches["weight_only_matmul"]),
    ]
    for which, name, line in FLASH_KERNELS:
        counter = {"fwd": "", "dq": "_bwd_dq", "dkv": "_bwd_dkv"}[which]
        entry = summarize(name, "paddle_tpu_torch/csrc/flash_attention.cu",
                          "paddle_tpu/kernels/flash_attention.py" + line,
                          [rows[which] for rows in fl],
                          c8["flash_attention" + counter])
        if which != "fwd":
            entry["library_note"] = ("scaled_dot_product_attention backward "
                                     "(dq, dk and dv in one call)")
        kernels.append(entry)
    csrc = "paddle_tpu_torch/csrc/"
    kernels += [
        summarize("rms_norm_fwd", csrc + "rms_norm.cu",
                  "paddle_tpu/kernels/rms_norm.py:27",
                  [r["fwd"] for r in norms], c11["rms_norm"]),
        summarize("rms_norm_bwd", csrc + "rms_norm.cu",
                  "paddle_tpu/kernels/rms_norm.py:35",
                  [r["bwd"] for r in norms if "bwd" in r],
                  c11["rms_norm_bwd"]),
        summarize("apply_rope", csrc + "rope.cu",
                  "paddle_tpu/kernels/rope.py:25", ropes,
                  c11["apply_rope"] + c11["apply_rope_bwd"]),
    ]
    kernels[-1]["launches_fwd_bwd"] = [c11["apply_rope"],
                                       c11["apply_rope_bwd"]]
    kernels[-1]["library_note"] = ("no single PyTorch call applies "
                                   "rotate-half RoPE")
    kernels[-3]["library_note"] = ("torch.nn.functional.rms_norm, the "
                                   "weight cast to x's dtype")
    kernels[-2]["library_note"] = ("the autograd backward of "
                                   "torch.nn.functional.rms_norm")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

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
   heads (the split route) and GQA 32/8 (the multi-query route). The
   matmul also runs at BERT-base's quantized linears (phase 47): (K, N) =
   (768, 768), (768, 3072), (3072, 768) at M = 4096 and the 2-class
   head's (768, 2) at M = 32.
4. Serving engine at full width (the 12-layer, hidden-2048 LLaMA the
   repository's TPU benchmark serves; random weights from a seed), bf16,
   default ServingConfig: ~24 greedy requests, half sharing a 64-token
   prefix, one ~600-token prompt that chunks through mixed dispatches.
5. The same trace with ``quantize="int8"`` and ``kv_quant="int8"``.
6. Parity at fp32 on a shortened trace: the kernel engine against the
   ``paged_kernel="off"`` (gather) engine, token streams equal.
7. Flash-attention kernel checks at bf16 on eight cases (the training
   step's B 8 x S 2048 x 16 heads x D 128 causal; GQA 32/8 heads; 4
   packed segments per row; causal with Sq 1024 < Sk 2048; one shard of
   phase 36's sharded step, B 2 x S 2048 x 8 heads; one ring block of
   phase 39, B 4 x S 512 x 16 heads, causal (f) and not (g), with a
   random cotangent of the lse beside dO, held to the plain backward
   that takes it; (h) BERT-base's attention, B 32 x S 128 x 12 heads x
   D 64, non-causal, one key tile a row): the public
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
29. The serving front end (cell T), A's model at bf16, default
    ``ServingConfig``: ``ServingServer`` over an ``EngineSupervisor``,
    serving HTTP/1.1 + SSE on ``127.0.0.1``; phase 4's trace from 16
    concurrent clients (standard-library asyncio streams, a connection a
    request) in turns with the same trace through a second supervisor's
    own step loop, 16 in flight (direct, server, server, direct):
    tokens/s, TTFT p50/p99 and TPOT p50/p99 on the client clock, the
    pump's host ms per delivered token event (its iterations less the
    backend's steps and the idle wait for a command); during the server
    turns one more client reads ``/metrics`` every 50 ms (count, ms p50
    and max). Every stream ends ``finish`` with exactly its
    ``max_new_tokens`` token events, each token once (the supervisor's
    record), 12 paged-attention launches a decode iteration and a mixed
    dispatch, the auditor clean, no block held. Then a slow client (an
    8-event buffer) is disconnected and cancelled, a client that closes
    after 2 events is cancelled, no block held; then
    ``install_signal_handlers`` and SIGTERM with 4 requests in flight:
    ``/readyz`` 503, a new ``/generate`` 503 with ``retry_after_s``,
    every in-flight request finishes with its ``max_new_tokens`` (the
    finish record; its token events a prefix of its record), the drain
    cancels nothing and leaks nothing. Then the same server over
    ``ServingServer.cold_start(journal dir, replicas=3)`` with replica 0
    killed at its decode iteration 10: the trace from 16 clients, every
    stream exact, failovers, 0 failed, the auditor clean, no block held.
    ``pump_error`` is None after every server run.
30. fp32 parity through the server on C's model and trace plus its
    first two requests (8 concurrent in-process clients, half seeded):
    the streams equal one supervisor's direct drain through the server,
    through the server with an engine crash (each token delivered once),
    and through a 3-replica router with and without crashes.
31. Workload replay (cell U), A's model at bf16: ``run_replay`` of a
    192-request ``WorkloadSpec`` (64-token family prefixes, tails of
    16-128, outputs of 8-64; diurnal arrivals, 6 tenants, 3 families, a
    quarter sampled, fixed retry backoff) through 3 replicas on the card
    with 6 chaos events and the autoscaler on, auditing throughout (a
    violation raises): every request has an outcome, 0 failed, no block
    held, ``chips == 1.0``; elapsed, req/s, goodput, TTFT and TPOT
    percentiles, the chaos and autoscale logs and ``capacity_report`` at
    the card's memory. The manifest replayed onto a fresh fleet gives
    every step-keyed field and stream again. Then 64 requests with
    ``quantize="int8", kv_quant="int8"`` (the int8 matmul launches).
32. The paged-attention kernel (decode bf16 and int8, the Q = 5 verify)
    and the int8 matmul ((K, N) = (2048, 1024) and (2048, 512), M = 8 and
    2048) at the shapes one tensor-parallel shard of A gets at tp 2 and 4
    (8 / 4 query and kv heads; N = 2048 / tp), under phase 3's rules.
33. Tensor-parallel serving on the one card (cell V), every shard on
    ``cuda:0``: A's model and trace through ``ServingEngine`` at tp 1 and
    tp 2 in turns (1, 2, 2, 1): tokens/s, TTFT, ms a decode iteration,
    the pool's bytes a shard and in all; paged attention must launch
    exactly 12 x tp times a decode iteration or mixed dispatch, and every
    bf16 stream where tp 1 and tp 2 part must part within bf16 rounding
    (phase 14's rule). B's int8 weights and pool at tp 2: the int8 matmul
    launches exactly 12 x (3 tp + 4) + 1 times a forward. Then fp32 on C's
    model and trace: the first dispatch's logits (prefill, decode through
    the kernel and the gather path) at tp 2 and 4 within 1e-4 x max|logit|
    of tp 1's on fp pools and 1e-2 on int8 pools (one quantization step:
    cuBLAS's fp32 GEMM rounds a shard's narrower projection differently,
    and the quantizer can turn that ulp into a step); tp 2 and 4 streams
    equal tp 1's, greedy and seeded, on the kernel and gather paths,
    mixed on and off, the speculative verify, LoRA, a supervisor crash
    (memory within one pool, no re-shard), a 2-replica tp-2 router with
    a kill (0 failed, the weight shards held once), the offload tier
    with a corrupt host block, and a migration between tp-2 engines; on
    int8 pools every live row of every dispatch within 1e-2 x max|logit|
    of tp 1's with the tokens teacher-forced (``lockstep``), the near ties
    and the free-running streams' equality reported.
34. Fault-tolerant training (cell W): F's step (``use_kernels``,
    ``use_fused_norm``, full remat, bf16 compute, fp32 params and AdamW
    at lr 1e-4, B 8 x S 2048, the 12-layer hidden-2048 model: a train
    state of 8.86 GB) with ``sentinel=True``, fed by the port's
    DataLoader (2 forked workers over 512 seeded rows of 2049 int32
    tokens; one row fails once and is healed by a retry, one always
    fails and is quarantined, its batch trains at B 7) through
    ``prefetch_to_device``. The free bytes of the temporary directory
    are printed first, and less than 3 x the state fails the run. Two
    warm-up and 4 timed steps (step ms, tokens/s, the consumer's wait for
    data a step); an ``AsyncCheckpointer(keep_last_k=2)`` save at step s
    (the blocking snapshot's ms, then up to 30 steps while the write is
    in flight: their mean ms against the steady steps, whether the save
    outlived them, the bytes on disk and the write's GB/s); the state set
    back to s and a second commit at s + 4; NaN in the live parameters:
    the monitor (``skip_threshold=2, max_restores=1``) must read SKIP
    then RESTORE, and ``monitor.restore`` must refill every live leaf
    bit-equal to a device clone taken at s + 4 (the AdamW step counter
    too), the next loss finite; the newest commit's ``data_0.pkl``
    bit-flipped: ``AsyncCheckpointer.restore`` must return s with every
    leaf equal to the clone at s, and its first loss must lie within the
    spread of two replays of the same step from that clone; a second bad
    streak must raise ``HealthAbortError`` with the diagnosis; a save
    under ``async_writer_fault`` must raise on ``wait()`` and the next
    save commit; exactly ``expected_launches`` a step over every step of
    the phase; then one loader epoch with a worker killed mid-epoch
    (``dead_worker``, ``worker_restarts=1``) must yield every
    non-quarantined row exactly once. The phase's seconds are printed.
35. E's config at fp32 with the kernels (hidden 512, 8 / 4 heads, 4
    layers, B 2 x S 512): 8 steps with ``save_state_dict`` at step 4,
    loaded by ``load_state_dict`` into a fresh state (every leaf equal
    bit for bit) that runs steps 5-8 again: each loss within 1e-6 x
    |loss| of the uninterrupted run's (the largest gap printed; the
    embedding's backward adds by atomics, so bit equality is not
    promised); then ``framework.io`` save and load of the same state
    onto the card (``device=None``), every leaf equal.
36. The sharded train step (cell X): F's step (phase 34's model and
    flags, no sentinel) at dp 2 x mp 2 x sharding 2 over ``["cuda:0"] *
    8``, the batch over ``("dp", "sharding")`` as
    ``examples/train_llama.py`` lays it out, beside the serial step from
    the same weights and 5 seeded batches. Params + m + v at a placement
    entry must equal what the specs give (the serial state / (mp x
    sharding) plus the replicated norms); the first 3 losses within 5e-3
    x |loss| of the serial step's; dp replicas of every leaf and moment
    bit-equal after every step; exactly ``sharded_launches`` a step (the
    serial counts x 4 pieces x 2 mp shards). Step ms and tokens/s of both
    (host clock, the last 4 steps), peak memory, a profiled sharded step.
37. E's width at fp32 with the kernels at dp 2 x mp 2 x sharding 2
    against the serial step (loss 1e-5; gradients 1e-4 x max|g|; params
    after one AdamW step at lr 1e-2 within 1e-3 where the gradient
    exceeds 1e-4 x max|g|, the rest counted; 3 losses 1e-5 x |loss|);
    the collectives on the card against the same calls on CPU tensors,
    exact; a sharded train state through ``AsyncCheckpointer`` restored
    bit-equal into a serial and a sharded state; the ZeRO gate at dp 2 x
    sharding 4. Each of phases 36 and 37 prints its seconds.
38. The pipelined train step: F's step (phase 36's model and flags)
    through ``make_pp_train_step`` at dp 2 x pp 4 over ``["cuda:0"] *
    8``, ``circular_repeats`` 3 (one block a chunk) and 4 micro-batches,
    the params laid out by ``to_pp_layout`` and ``pp_param_specs``,
    beside the serial step from the same weights and 3 seeded batches:
    params + m + v at a placement entry equal to what the specs give,
    every block weight, the embedding and the head at 1/4 an entry; the
    losses within 5e-3 x |loss| of the serial step's; dp replicas of
    every leaf and moment bit-equal after every step; exactly
    ``pp_launches`` a step (the serial counts x 4 micro-batches x 2 dp
    ranks, the final norm x 2). Step ms and tokens/s of both, peak
    memory, a profiled pipelined step.
39. Context-parallel training: F's step on unsharded params with the
    hybrid group at dp 2 x sep 4 over ``["cuda:0"] * 8`` and
    ``sep_axis="sep"``, ``cp_impl`` "ring" and "ulysses", each beside
    the serial step from the same weights and 3 seeded batches laid out
    by ``batch_spec(("dp",), "sep")``, S 2048 (512 a sequence part): the
    losses within 5e-3 x |loss| of the serial step's; exactly
    ``sep_launches`` a step (flash: the ring's 10 block calls a layer
    call, Ulysses' 4; RMSNorm and RoPE as serial). Step ms, tokens/s,
    peak memory and a profiled step of each.
40. E's width at fp32 with the kernels, the loss within 1e-5 and every
    gradient leaf within 1e-4 x max|g| of the serial step's: the
    pipelined loss at V 1 (dp 2 x pp 4) and V 2 (dp 4 x pp 2), tied and
    untied; ring and Ulysses on unsharded params and on ``shard_params``
    at dp 2 x sep 4 and sharding 2 x sep 4. Each of phases 38-40 prints
    its seconds.
41. The launched job (cell LA): ``python -m
    paddle_tpu_torch.distributed.launch --nproc_per_node 2`` on a script
    this file writes, both ranks on ``cuda:0`` joined by
    ``init_parallel_env`` into gloo's process group (the parent frees its
    cached memory first). Each rank checks every collective of the port
    (all_reduce sum / avg / max / min / prod, reduce, all_gather in both
    forms, broadcast, reduce_scatter, alltoall, scatter in both forms,
    barrier) on CUDA tensors across the processes; runs F's loss and gradient (phase 34's model and flags) on
    its half of a B 8 x S 2048 batch with exactly ``expected_launches``,
    averages the gradient with ``all_reduce(..., op=AVG)`` as one flat
    buffer of 738 M entries (timed: ms and GB/s), and rank 0 holds the
    result to the serial step on the whole batch in the same child (the
    bf16 loss within 5e-3 x |loss|); then the same at E's width in fp32
    (the loss within 1e-5, every gradient leaf within 1e-4 x max|g|).
    No child rebuilds a kernel. Each rank's peak memory is printed.
42. Elastic restarts on the card: E's width at fp32, data parallel over
    2 launched ranks on ``cuda:0`` (gradients averaged over gloo), 8
    steps, every rank saving through ``AsyncCheckpointer`` after steps 2,
    4 and 6; an unfaulted job, then a job at ``--max_restart 2
    --elastic_timeout 5`` where rank 1 is SIGKILLed after the first
    commit (round 0) and rank 0's heartbeat is stalled by
    ``stall_heartbeat`` (round 1, the launcher's ``HUNG_RC``); each next
    round resumes from the newest commit, and the final loss must equal
    the unfaulted job's within 1e-5 x |loss|. The detection latency of each fault (against the
    timeout for the stall) and each restart's wall time are printed.
43. Expert parallelism (cell EP): L (phase 4's widths, 8 experts, top-2,
    capacity factor 1.25, cut to 2 layers; ``use_kernels``,
    ``use_fused_norm``, full remat, bf16 compute, fp32 params) at dp 2 x
    ep 4 over ``["cuda:0"] * 8``, the batch B 8 x S 2048 over dp, beside
    the serial step from the same weights and 3 seeded batches. The state
    is reckoned from the specs first; each expert leaf at 1/4 of its bytes
    an entry; the router's kept counts equal the serial router's (the
    router runs over the global batch); losses within 5e-3 x |loss|; dp
    replicas bit-equal after every step; exactly ``sharded_launches`` a
    step (the serial counts x 2 pieces). Step ms, tokens/s, peak memory of
    both, and a profiled expert-parallel step.
44. E's width at fp32 with the kernels and 8 experts against the serial
    loss and gradients (loss 1e-5, every gradient leaf 1e-4 x max|g|):
    dp 2 x ep 4 through ``shard_params``, and the pipelined loss at pp 2 x
    ep 2 and dp 2 x pp 2 x ep 2 at V 2 against the serial micro-batched
    oracle (each micro-batch's dp piece routed alone, as the pp step
    routes it).
45. The eager API (``import paddle_tpu_torch as paddle``) on the card:
    (a) ``LlamaForCausalLM`` at F's configuration on ``init_params``
    seed 0, ``AdamW(1e-4)`` on B 8 x S 2048, one warm-up and two timed
    ``loss.backward(); opt.step(); opt.clear_grad()`` steps: exactly F's
    launches a step, the first loss within 5e-3 x |loss| of the
    functional ``loss_fn`` on the same params; step ms beside phase 11's,
    peak memory, and one profiled step. (b) E's width at fp32 with the kernels, the weights
    loaded by name through ``set_state_dict``: the eager loss (1e-5) and
    every ``.grad`` (1e-4 x max|g|) against ``loss_fn`` and
    ``torch.autograd.grad``, and one AdamW step (weight decay 0.01)
    against the reference formula written out (1e-6 x max|p|). (c)
    ``net.generate`` greedy at full width equal to the functional
    ``generate`` on the same params. (d) The eager kernel callers on the
    card, each against its plain path: ``F.scaled_dot_product_attention``
    at bf16 B 2 x S 2048 x 16 heads x D 128 causal, forward and backward,
    flash launches 1 / 1 / 1 and phase 7's rule (and the same call with a
    boolean mask: the plain path, no flash launch, its output under phase
    7's rule and its bf16 autograd gradients under the rule's 1e-2
    norm-relative part); ``F.rms_norm``,
    ``nn.RMSNorm`` and ``fused_rms_norm`` on 8 x 2048 rows of 2048 and
    ``fused_rotary_position_embedding`` on q and k [8, 2048, 16, 128],
    each within one bf16 step, forward and backward; ``weight_only_linear``
    at M 8 and 2048, K 2048, N 5504 within 1e-2 x max|ref|, its gradient
    with respect to x against the plain version's.
46. The eager hybrid-parallel API (``paddle_tpu_torch.distributed``),
    each part's seconds printed. (a) A Megatron-style decoder built in
    the script from the public layers (:func:`megatron`) at F's widths,
    bf16, 12 layers, at mp 2 over ``["cuda:0"] * 2``, F's weights by
    name, ``fleet.distributed_model`` and ``distributed_optimizer(AdamW)``
    on B 8 x S 2048: a warm-up step, the first loss within 5e-3 x |loss|
    of the functional ``loss_fn``, timed steps (each step's ms, the
    median, peak memory), exactly ``megatron_launches(12, 2)`` a step and
    one profiled step; at E's width in fp32 the same decoder at mp 2
    against its serial twin (loss 1e-5, every ``.grad`` 1e-4 x max|g|).
    (b) F's ``LlamaForCausalLM`` at dp 2 x sharding 2 through
    ``distributed_model`` / ``distributed_optimizer`` (``DataParallel``:
    one call on the whole batch): the first loss within 5e-3 of phase
    45's, the replicas bit-equal after a step, each optimizer state's
    locals half its leaf. (c) ``PipelineParallel.train_batch`` at pp 2, 4
    micro-batches, on (a)'s blocks at E fp32 against serial gradient
    accumulation (losses 1e-5). (d) The eager ``MoELayer`` at ep 4 against
    the replicated layer (out and gradients 1e-5 x max).
47. BERT fine-tuning through ``paddle.Model`` (cell BT):
    ``examples/finetune_bert.py``'s loop at BERT-base width
    (``BertConfig()``: vocab 30522, hidden 768, 12 layers of 12 heads,
    intermediate 3072; random weights from the seed) with
    ``prepare(AdamW(3e-4), CrossEntropyLoss(), Accuracy(),
    amp_configs="O1")`` and ``fit`` over the script's synthetic task at B
    32 x S 128: a warm-up step and 6 timed ones (step ms, samples/s, MFU
    over 989 TFLOP/s from the config's FLOPs, peak memory), one profiled
    step (busy share, launch calls). Dropout 0.1 trains through the plain
    attention. Then ``evaluate`` under ``auto_cast("O1")`` on a held-out
    split: exactly 12 flash forwards a batch (bf16, D 64, non-causal),
    ``Accuracy`` equal to a numpy recount of the logits it saw; then
    ``quantize_linears`` on the fine-tuned net and ``predict``: exactly
    74 ``weight_only_matmul`` launches a forward (6 a layer, the pooler,
    the head), each ``WeightOnlyLinear`` output within 1e-2 x max|ref| of
    its plain dequant-then-matmul and phase 3's norm-relative rule, the
    logits within 5e-2 x max|logit| of the fp model's.
48. fp32 parity of ``Model.train_batch`` on the card (flash kernels,
    exactly 4 / 4 / 4 launches: hidden 256, 4 heads of D 64, 4 layers,
    dropout 0) against the same net, weights and batches on the CPU: the
    loss within 1e-5 x |loss|, every gradient within 1e-4 x max|g|, three
    AdamW steps' losses within 1e-4 x |loss|; the O1 bf16 loss within
    5e-3 of fp32; ``GradScaler`` under ``auto_cast(dtype="float16")``
    (attention on the plain formula, no flash launch): an injected inf
    skips the step and halves the scale; a ``PyLayer`` on CUDA tensors
    against its analytic gradient (1e-6).
49. ``examples/train_recsys.py`` on the card (cell RS), not cut: vocab
    1,000,000 x 32 (128 MB fp32), 8 slots, batch 256, 20 steps, an Adam
    tower over ``SparseAdam``, ``AsyncLookup`` on the host table; a host
    table (0 device bytes) and a device table from one seed, their losses
    within 1e-6 x |loss|, a backward on the device table growing memory
    by less than half the table; step ms, the host gather ms and the
    share ``AsyncLookup`` hides. Then the 2-rank vocab-sharded job
    through the launcher (both ranks on ``cuda:0``, gloo), its looked-up
    rows and trained table within 1e-6 of the whole table in one process.

50. The captured train step (``paddle_tpu_torch.jit``: one CUDA graph a
    step). (a) Phase 45's ``LlamaForCausalLM`` at F's configuration
    through ``make_train_step(net, AdamW(1e-4), loss)``: three eager steps
    from ``init_params`` seed 0, then a fresh net from the same seed
    through the captured step on the same batches (an eager warm-up, the
    capture, a replay): each loss within 5e-3 x |loss| of the eager one
    (bit-equality printed); four timed replays (step ms beside phase 45's,
    peak memory beside phase 45's), exactly F's launches a step counted on
    the replays, one profiled replay (busy share, ``cudaGraphLaunch``
    against ``cudaLaunchKernel`` calls, each port kernel's device ms).
    (b) E's width at fp32 with the kernels: a ``to_static``
    forward-backward's loss (1e-5) and every ``.grad`` (1e-4 x max|g|)
    against eager; four AdamW steps under a ``StepDecay`` stepped between
    replays against eager (losses 1e-5, weights 1e-5 x max|p|); dropout
    masks that differ between replays; ``sentinel=True`` on a NaN batch
    (an out-of-vocab id) leaving every parameter and moment bit-unchanged,
    and the sentinel's cost a step. (c) On CUDA tensors against eager: a
    tensor ``if`` (dy2static), a ``return`` in a tensor branch
    (``backend="sot"``) and a tensor ``while_loop``. The eager fallbacks
    the reference also takes (GradScaler, ``enable_to_static(False)``,
    SOT's graph break, a nested ``to_static``) are counted and printed.
51. Cell BT through ``prepare(..., jit=True)``: phase 47's loop (BERT-base,
    B 32 x S 128, O1, AdamW 3e-4, dropout 0.1) on the captured step: step
    ms, samples/s, MFU, peak, a profiled step's busy share and launch
    calls, beside phase 47's; then dropout 0: three ``train_batch`` losses
    within 5e-3 x |loss| of the eager ``train_batch``'s from the same
    weights, the metrics equal.
52. Deployment: ``Model.save(path, training=False)`` of phase 51's
    network (fp32; ``jit.save``'s ``torch.export`` program), the network
    dropped, ``inference.create_predictor(Config(...))`` over 4 batches
    through the handles: exactly 12 flash forwards a batch, logits within
    1e-4 x max|logit| of the fp32 eval forward, a batch of 8 served by the
    same artifact; then its ``quantize_linears`` network: 74
    ``weight_only_matmul`` launches a forward, logits within 1e-4 x
    max|logit| of the eager int8 network's. The exports' seconds and the
    predictors' ms a batch beside the eager forwards'.
53. ResNet-50 training (cell RN), as ``bench.py:bench_resnet`` runs it:
    ``resnet50(num_classes=1000)`` from ``paddle.seed(0)``,
    ``Momentum(0.1, 0.9)``, ``CrossEntropyLoss``, ``make_train_step(...,
    amp=True)``, B 32 x 3 x 224 x 224, widths not cut; NCHW, then under
    ``nn.ChannelsLast`` from the same weights. Each: three eager steps,
    then a fresh net through the captured step on the same batches (the
    losses within 5e-3 x |loss|, bit-equality printed), 8 timed replays
    (step ms, images/s, peak memory, MFU over 989 TFLOP/s from the conv
    and linear shapes' multiply-adds, ~4.1 G an image forward, checked
    within 5 %), a profiled replay (busy share, launch calls against
    graph launches, the copy kernels). ChannelsLast's first loss within
    5e-3 of NCHW's. Then ``examples/train_resnet.py``'s loop: the
    ``FakeImageDataset`` through ``DataLoader(num_workers=2,
    use_shared_memory=True)`` and ``prefetch_to_device`` into the
    captured ChannelsLast step, the data wait a step beside the step time.
54. fp32 parity of vision on the card against the CPU (TF32 off):
    ResNet-18 (10 classes) at B 4 x 3 x 32 x 32 from the same weights,
    NCHW and NHWC: the loss within 1e-5 x |loss|, every gradient within
    1e-3 x max|g|, the running statistics within 1e-5; three captured
    Momentum steps (lr 1e-3, three batches of 32) in fp64, NCHW and NHWC,
    their losses and the whole state after them within 1e-10 of the
    CPU's, NHWC's losses within 1e-10 of NCHW's; the same steps in fp32,
    the first loss within 1e-5 x |loss|, every layer's forward output
    within 1e-4 x max of the fp64 run's, the losses and the ReLU inputs
    whose sign differs from fp64's printed; conv2d (groups, dilation,
    SAME and asymmetric pads at stride 2, NHWC), conv2d_transpose
    (output_padding, groups), and each pooling route (ceil_mode,
    exclusive, SAME, divisor, return_mask, adaptive, NHWC, a max pool
    over all-tie windows after a ReLU) with its gradient within 1e-5 x
    max|ref|, indices equal.
55. The PP-YOLOE detector (cell DT), as ``bench.py:bench_detect`` runs
    it: ``ppyoloe_mbv3(num_classes=80, image_size=320)`` from
    ``paddle.seed(0)``, ``Momentum(0.01, 0.9)``, ``make_train_step(...,
    amp=True)`` over ``detection_loss`` called as ``step([x], [gt_b,
    gt_l])``, B 8, the ground truth as ``bench.py:371-379`` makes it:
    eager against captured losses within 5e-3, 8 timed replays and a
    profiled one (phase 53's metrics); then
    ``examples/train_detector.py``'s inference at 64 px:
    ``multiclass_nms``, ``matrix_nms`` and ``static_nms`` on the card
    EQUAL to the same calls on the CPU from the same logits and boxes,
    each one's CUDA-event ms and launch calls a call.
    Phases 53-55 launch none of the port's kernels: each asserts every
    kernel counter is still 0 at its end.

Each phase's wall seconds print as the next phase (or the closing line)
begins.

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
27 (the first sharing wave with the fleet cache on), 28 (the int8
drain with migration), 29 (the first server turn), 31 (the bf16 and
the int8 replays) and 33 (the first tp-2 turn and the int8 tp-2 drain)
together,
and 45 (d),
the flash launches of phases 8, 34, 36, 38, 39, 41 (both ranks' F
steps), 43, 45, 46, 47 (evaluate and predict), 48 (the card's
``train_batch``), 50 (the timed replays of (a), the forward-backward
calls of (b)), 51 (the dropout-0 captured run) and 52 (both
predictors), the int8 matmul launches of phases 47 (quantized predict)
and 52 (the int8 predictor), and the RMSNorm and RoPE launches of phases
11, 34, 36, 38, 39, 41, 43, 45, 46 and 50 (RoPE: forward and backward
together; 45: the timed eager steps and the eager callers of (d); 46: the
timed steps of (a) and (b); 50: as for the flash launches).
Exits non-zero, printing no result, without a CUDA device or outside a
checkout of the repository.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12              # H100 SXM HBM3
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12}   # dense, tensor-core bf16;
#                                                fp32 outside the tensor cores
SEED = 0
# the port's main paths this script drives, in phase order
PATHS = ("serving kernels", "serving engine", "training step",
         "sampled and speculative serving", "MoE serving and training",
         "LoRA serving", "dense generation", "host offload tier",
         "supervisor and journal", "embeddings", "serving fleet",
         "serving server and replay", "tensor-parallel serving",
         "fault-tolerant training", "sharded training",
         "pipelined training", "context-parallel training",
         "launched training", "elastic restarts", "expert-parallel training",
         "eager API", "eager hybrid parallel", "BERT fine-tuning (hapi)",
         "parameter-server tables", "captured train step (jit)",
         "BERT fine-tuning (hapi, jit)", "deployment predictor",
         "ResNet-50 training (vision)", "vision parity",
         "detector training and NMS (vision)")


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


_PHASE = {}


def log(*a):
    """Print a line; a line opening a phase (``== phase n``) or the
    closing ``== main paths`` line first prints the open phase's wall
    seconds."""
    text = " ".join(str(x) for x in a)
    if text.startswith(("== phase", "== main paths")):
        if _PHASE:
            print(f"   (phase {_PHASE['n']}: "
                  f"{time.time() - _PHASE['t0']:.1f} s)", flush=True)
        if text.startswith("== phase"):
            _PHASE.update(n=text.split()[2].rstrip(":"), t0=time.time())
    print(text, flush=True)


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
               probe=False, dlse=False):
    """One bf16 case: the public ``flash_attention_with_lse`` (its
    autograd Function, forward and ``torch.autograd.grad``) against the
    plain forward and backward on out, lse, dq, dk and dv; then each
    kernel timed alone through its launcher beside its plain version and
    SDPA. ``probe``: also show that the rule rejects a forward that drops
    one key tile from the long rows and one whose causal diagonal is off
    by one. ``dlse``: a random fp32 cotangent of the lse beside ``dout``
    (a ring block's gradient: the merge weights depend on the lse), in the
    gradient, the plain backward and the timed launches (SDPA, which has
    no lse output, is timed without it). Returns {"fwd"|"dq"|"dkv": row},
    rows as attention_case gives them."""
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
    dl = (torch.randn((B, H, Sq), generator=g, device=dev) if dlse
          else None)
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
    if dlse:
        dq, dk, dv = torch.autograd.grad((out, lse), (qg, kg, vg), (do, dl))
    else:
        dq, dk, dv = torch.autograd.grad(out, (qg, kg, vg), do)
    out, lse = out.detach(), lse.detach()
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
        q, k, v, seg, seg, out, lse, do, scale, causal, dl)))

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
    saved = (q, k, v, seg, seg, out, lse, do, scale, causal, dl)
    ops = FA._bwd_operands(q, k, v, seg, seg, out, lse, do, dl)
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


def profile_sums(prof):
    """What ``prof.key_averages()`` gives for a trace, summed in one pass
    over the profiler's raw events (the full parse builds an object per
    event, most of a serving phase's seconds): ``(device, host)``,
    each ``{name: [us, count]}``; ``device`` the duration of every device
    event (kernels, copies) by name, ``host`` the self time of every
    synchronous host event by name, its host children subtracted after
    ``key_averages``' own rules: children nest by interval on their
    thread, a runtime call (``cudaLaunchKernel``) sits on the thread of
    the op that issued it, and an event that is the only child of a
    parent of its name is merged into that parent."""
    from torch.autograd import DeviceType
    from torch.autograd.profiler_util import _filter_name, _rewrite_name
    res = prof.profiler.kineto_results
    device, host, names = {}, [], {}
    issuer = {}
    for e in res.events():
        raw = e.name()
        if _filter_name(raw) or getattr(e, "is_hidden_event",
                                        lambda: False)():
            continue
        if e.is_async() or e.start_thread_id() != e.end_thread_id():
            continue
        name = names.get(raw)
        if name is None:
            name = names[raw] = _rewrite_name(raw, with_wildcard=True)
        if e.device_type() == DeviceType.CPU:
            # [name, start, end, thread, linked id, parent, children]
            host.append([name, e.start_ns(), e.end_ns(), e.start_thread_id(),
                         e.linked_correlation_id(), None, []])
            if e.linked_correlation_id() == 0:
                issuer[e.correlation_id()] = e.start_thread_id()
        else:
            d = device.setdefault(name, [0.0, 0])
            d[0] += (e.end_ns() - e.start_ns()) / 1e3
            d[1] += 1
    by_thread = {}
    for h in host:
        if h[4] > 0 and h[4] in issuer:
            h[3] = issuer[h[4]]
        by_thread.setdefault(h[3], []).append(h)
    for evs in by_thread.values():
        stack = []
        for h in sorted(evs, key=lambda h: (h[1], -h[2])):
            while stack and (h[1] >= stack[-1][2] or h[2] > stack[-1][2]):
                stack.pop()
            if stack:
                stack[-1][6].append(h)
                h[5] = stack[-1]
            stack.append(h)
    while True:
        gone = set()
        for h in host:
            up = h[5]
            if up is not None and up[0] == h[0] and len(up[6]) == 1:
                up[6] = h[6]
                for c in h[6]:
                    c[5] = up
                gone.add(id(h))
        if not gone:
            break
        host = [h for h in host if id(h) not in gone]
    sums = {}
    for h in host:
        self_ns = (h[2] - h[1]) - sum(c[2] - c[1] for c in h[6])
        t = sums.setdefault(h[0], [0.0, 0])
        t[0] += self_ns / 1e3
        t[1] += 1
    return device, sums


def profile_device(run, label, top=6):
    """Run ``run()`` under ``torch.profiler``: the wall time, the device
    time of every kernel (CUPTI) and its share of the wall time, the time
    of PyTorch's elementwise kernels and of each of the port's kernels,
    the kernels that took the most device time, and the host ops that
    took the most self CPU time (ms and calls; the profiler's own cost
    included), the kernel launch calls (``launch_calls``) and the CUDA
    graph launches (``graph_launch_calls``), and the device events that
    copy or re-lay memory (``copy_kernels``: calls by name, and
    ``copy_kernel_calls``, ``copy_ms``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3
    device, host_sums = profile_sums(prof)
    kernels = {}
    for name, (us, _) in device.items():
        for short in PORT_KERNELS:
            if short in name:
                name = short
        # summed by the printed (60-character) name: instantiations of
        # one PyTorch kernel template share it
        name = name[:60]
        kernels[name] = kernels.get(name, 0.0) + us
    host = sorted(((k, us / 1e3, n) for k, (us, n) in host_sums.items()),
                  key=lambda r: -r[1])[:top]
    busy_ms = sum(kernels.values()) / 1e3
    # PyTorch's own elementwise kernels (casts, norms and RoPE on the plain
    # route, SiLU, AdamW's passes, the CE), summed
    elementwise_ms = sum(v for k, v in kernels.items()
                         if "elementwise_kernel" in k) / 1e3
    launch_calls = sum(n for k, (_, n) in host_sums.items()
                       if k in ("cudaLaunchKernel", "cuLaunchKernelEx",
                                "cudaLaunchKernelExC"))
    graph_calls = sum(n for k, (_, n) in host_sums.items()
                      if k == "cudaGraphLaunch")
    out = {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
           "device_busy_share": busy_ms / wall_ms,
           "launch_calls": launch_calls, "graph_launch_calls": graph_calls,
           "elementwise_ms": elementwise_ms,
           "port_kernels_ms": {k: kernels[k] / 1e3 for k in PORT_KERNELS
                               if k in kernels},
           "top_kernels_ms": {k: v / 1e3 for k, v in sorted(
               kernels.items(), key=lambda kv: -kv[1])[:top]},
           "top_host_ops_ms_calls": {k: [ms, n] for k, ms, n in host}}
    moves = {k: v for k, v in device.items()
             if re.search(r"copy|memcpy|nchwToNhwc|nhwcToNchw|transpose", k,
                          re.I)}
    out["copy_kernels"] = {k[:60]: n for k, (_, n) in moves.items()}
    out["copy_kernel_calls"] = sum(n for _, n in moves.values())
    out["copy_ms"] = sum(us for us, _ in moves.values()) / 1e3
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


def first_dispatch(params, cfg, prompts, B=4, W=16, kv_quant=None,
                   devices=None):
    """One batched ``paged_prefill`` of the first ``B`` prompts (cut to 120
    tokens) into a fresh pool (``kv_quant``; a tensor-parallel pool over
    ``devices``, for params sharded over them): (logits, pool, greedy
    tokens, the decode operands ``(seq_lens, tables, active)``, the MoE
    drop count)."""
    import torch
    from paddle_tpu_torch.models import generation as G
    pool = G.init_paged_pool(cfg, 1 + B * W, 16, kv_quant=kv_quant,
                             device="cuda", devices=devices)
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
        # CUPTI at times records no kernel of a window this short (20
        # argmax calls, ~0.1 ms of device time): up to three windows, then
        # "not measured"
        for _ in range(3):
            busy = profile_device(lambda: [fn() for _ in range(20)],
                                  f"20 calls of {name[:-10]} [{B}, {V}]",
                                  top=3)["device_busy_ms"]
            if not isinstance(busy, str):
                break
        row[name] = busy / 20 if not isinstance(busy, str) \
            else "not measured"

    def ms(key):
        v = row[key]
        return v if isinstance(v, str) else f"{v:.4f} ms"
    log(f"  sampler [{B}, {V}] per call: kernels {ms('sample_kernel_ms')},"
        f" CUDA events (host enqueue included) {ms('sample_event_ms')}, "
        f"wall {ms('sample_wall_ms')}; argmax kernels "
        f"{ms('argmax_kernel_ms')}, events {ms('argmax_event_ms')}, wall "
        f"{ms('argmax_wall_ms')}")
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
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            run()
        torch.cuda.synchronize()
    by, n = {}, 0
    for name, (us, count) in profile_sums(prof)[0].items():
        by[name[:60]] = by.get(name[:60], 0.0) + us / 1e3 / iters
        n += count
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
    iterations after arming (the port's ``testing/chaos.py::
    engine_crash`` keyed to decode iterations: the patch rides the
    engine, so the rebuilt engine runs clean). Returns the engine's decode-iteration
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
            m["wq_ptr"] = weight_ptrs(sup.engine)
            r0 = sup.restarts
            t1 = time.time()
            out = sup.step(max_iters)
            torch.cuda.synchronize()
            m["recovery_ms"] = (time.time() - t1) * 1e3
            m["mem_after_gb"] = torch.cuda.memory_allocated() / 2**30
            check(sup.restarts == r0 + 1 and out == {},
                  f"the crash did not restart the engine ({sup.restarts})")
            check(weight_ptrs(sup.engine) == m.pop("wq_ptr"),
                  "the rebuild re-cast or re-sharded the weights")
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
    """Kill replica ``rid`` for good (the port's
    ``testing/chaos.py::replica_kill``, armed at a decode iteration
    rather than the next step, and timed): its restart budget
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
    from paddle_tpu_torch.testing import chaos
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
    chaos.slow_replica(r, rid=0, stall_steps=100, delay_s=0.01)
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
    chaos.flaky_probe(r, rid=0, fails=3)
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


# ---------------------------------------------------------------------------
# phases 29-31: the serving front end (ServingServer over HTTP/1.1 + SSE),
# fp32 parity through it, and the workload replay with its capacity report
# ---------------------------------------------------------------------------

async def sse_client(port, body, t_sent=None):
    """One ``POST /generate`` over a fresh connection, read to its end as
    a client would (the standard library's asyncio streams): returns the
    status, the events (or the JSON body of a refusal) and, on the client
    clock, when the request was sent and each token event arrived."""
    import asyncio
    t0 = time.time() if t_sent is None else t_sent
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    data = json.dumps(body).encode()
    writer.write(b"POST /generate HTTP/1.1\r\nHost: localhost\r\n"
                 b"Content-Type: application/json\r\nContent-Length: "
                 + str(len(data)).encode() + b"\r\n\r\n" + data)
    await writer.drain()
    status = int((await reader.readline()).split()[1])
    while (await reader.readline()) not in (b"\r\n", b"\n", b""):
        pass
    out = {"status": status, "t_sent": t0, "events": [], "t_tokens": []}
    if status != 200:
        out["body"] = json.loads(await reader.read())
    else:
        while True:
            line = await reader.readline()
            if not line:
                break
            if line.startswith(b"data: "):
                ev = json.loads(line[6:])
                out["events"].append(ev)
                if ev["type"] == "token":
                    out["t_tokens"].append(time.time())
    writer.close()
    await writer.wait_closed()
    out["tokens"] = [ev["token"] for ev in out["events"]
                     if ev["type"] == "token"]
    starts = [ev["rid"] for ev in out["events"] if ev["type"] == "start"]
    fins = [ev for ev in out["events"] if ev["type"] == "finish"]
    out["rid"] = starts[0] if starts else None
    out["finish"] = fins[0] if fins else None
    return out


async def http_get(port, path):
    """``GET path`` over a fresh connection: (status, JSON body, ms)."""
    import asyncio
    t = time.time()
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(f"GET {path} HTTP/1.1\r\nHost: localhost\r\n\r\n".encode())
    await writer.drain()
    raw = await reader.read()
    writer.close()
    await writer.wait_closed()
    head, _, body = raw.partition(b"\r\n\r\n")
    return int(head.split()[1]), json.loads(body), (time.time() - t) * 1e3


class PumpMeter:
    """Wraps a server's pump (instance attributes, removed by ``stop``):
    the pump's own host ms — each ``_pump_once`` less the backend's
    ``step`` and the idle wait for a command — and the token events it
    delivered."""

    def __init__(self, srv):
        self.srv, self.ms, self.events = srv, 0.0, 0
        self.step_ms = self.wait_ms = 0.0
        once, step = srv._pump_once, srv.sup.step
        run_cmds, deliver = srv._run_cmds, srv._deliver
        # an iteration already under way when the meter went in is not
        # counted: only steps and waits inside a metered iteration are
        inside = threading.local()

        def timed_once():
            inside.on = True
            t = time.time()
            try:
                return once()
            finally:
                self.ms += (time.time() - t) * 1e3
                inside.on = False

        def timed_step(*a, **kw):
            t = time.time()
            try:
                return step(*a, **kw)
            finally:
                if getattr(inside, "on", False):
                    self.step_ms += (time.time() - t) * 1e3

        def timed_cmds(block):
            t = time.time()
            try:
                return run_cmds(block)
            finally:
                if block and getattr(inside, "on", False):
                    self.wait_ms += (time.time() - t) * 1e3

        def counted(client, ev):
            if ev is not None and ev.get("type") == "token":
                self.events += 1
            return deliver(client, ev)

        srv._pump_once, srv.sup.step = timed_once, timed_step
        srv._run_cmds, srv._deliver = timed_cmds, counted

    def stop(self):
        for obj, name in ((self.srv, "_pump_once"), (self.srv.sup, "step"),
                          (self.srv, "_run_cmds"), (self.srv, "_deliver")):
            delattr(obj, name)
        host = self.ms - self.step_ms - self.wait_ms
        return {"pump_host_ms": host, "token_events": self.events,
                "pump_ms_per_event": host / max(1, self.events)}


async def server_turn(srv, prompts, news, concurrency=16, scrape=False):
    """Phase 4's trace from ``concurrency`` SSE clients over TCP, each
    request on its own connection. Every stream must end ``finish`` with
    exactly its ``max_new_tokens`` token events, each token once (the
    backend's record). With ``scrape``, one more client reads
    ``/metrics`` every 50 ms. Returns the client-clock metrics."""
    import asyncio
    sem = asyncio.Semaphore(concurrency)
    done = asyncio.Event()

    async def one(i):
        async with sem:
            return await sse_client(srv.port, {
                "prompt": [int(t) for t in prompts[i]],
                "max_new_tokens": int(news[i]), "eos_token_id": None})

    async def scraper():
        ms = []
        while not done.is_set():
            st, _, t = await http_get(srv.port, "/metrics")
            check(st == 200, f"/metrics answered {st}")
            ms.append(t)
            await asyncio.sleep(0.05)
        return ms

    scrape_task = asyncio.ensure_future(scraper()) if scrape else None
    t0 = time.time()
    outs = await asyncio.gather(*(one(i) for i in range(len(prompts))))
    wall = time.time() - t0
    done.set()
    scrapes = await scrape_task if scrape_task is not None else []
    for i, o in enumerate(outs):
        check(o["status"] == 200 and o["finish"] is not None
              and o["finish"]["state"] == "finished"
              and o["finish"]["tokens"] == news[i]
              and len(o["tokens"]) == news[i],
              f"client {i}: status {o['status']}, finish {o['finish']}, "
              f"{len(o['tokens'])}/{news[i]} token events")
        check(o["tokens"] == [int(t) for t in srv.sup.result(o["rid"])],
              f"client {i}: streamed tokens repeat or went missing")
    ttft = [o["t_tokens"][0] - o["t_sent"] for o in outs]
    tpot = [(o["t_tokens"][-1] - o["t_tokens"][0]) / (len(o["tokens"]) - 1)
            for o in outs if len(o["tokens"]) > 1]
    m = {"tok_s": sum(news) / wall, "wall_s": wall,
         "ttft_p50_s": float(np.percentile(ttft, 50)),
         "ttft_p99_s": float(np.percentile(ttft, 99)),
         "tpot_p50_ms": float(np.percentile(tpot, 50)) * 1e3,
         "tpot_p99_ms": float(np.percentile(tpot, 99)) * 1e3}
    if scrape:
        m.update(scrapes=len(scrapes),
                 scrape_ms_p50=float(np.percentile(scrapes, 50)),
                 scrape_ms_max=float(max(scrapes)))
    return m, outs


def frontend_phase(prompts, news, tmp, cfg=None, dev="cuda"):
    """Phase 29 (cell T): A's model behind ``ServingServer`` over HTTP/1.1
    + SSE. Phase 4's trace from 16 clients in turns with the supervisor's
    own step loop (direct, server, server, direct), ``/metrics`` scraped
    every 50 ms during the server turns; a slow client, a disconnect and a
    SIGTERM drain; then the server over a cold-started 3-replica fleet with
    a replica killed at decode iteration 10. Returns (metrics, main-path
    launches)."""
    import asyncio
    import os
    import signal
    import torch
    from paddle_tpu_torch.inference.serving import (EngineSupervisor,
                                                    InvariantAuditor,
                                                    ServingConfig,
                                                    ServingServer)
    from paddle_tpu_torch.models.llama import init_params
    from paddle_tpu_torch.testing import chaos
    cfg = cfg or model_config(torch.bfloat16)
    params = init_params(cfg, seed=SEED, device=dev)
    sup = EngineSupervisor(params, cfg, ServingConfig(), device=dev)
    direct = EngineSupervisor(sup._params, cfg, ServingConfig(), device=dev)
    for s in (sup, direct):                  # warm-up, one short request
        s.run([prompts[0][:40]], max_new_tokens=4, eos_token_id=None)
    srv = ServingServer(sup)
    out = {"turns": []}
    state = {}

    async def main():
        async with srv.running(host="127.0.0.1", port=0):
            for kind in ("direct", "server", "server", "direct"):
                if kind == "direct":
                    _, _, m = client_drive(direct, prompts, news,
                                           concurrency=16)
                    out["turns"].append({
                        "kind": kind, "tok_s": m["tok_s"],
                        "ttft_p50_s": m["ttft_p50_s"],
                        "ttft_max_s": m["ttft_max_s"],
                        "tpot_p50_ms": m["tpot_p50_ms"],
                        "tpot_p99_ms": m["tpot_p99_ms"]})
                    continue
                s0 = sup.engine.stats()
                meter = PumpMeter(srv)
                first = "launches" not in state
                if first:
                    reset_counts()
                m, _ = await server_turn(srv, prompts, news, scrape=True)
                if first:
                    state["launches"] = read_counts()
                m.update(meter.stop())
                s1 = sup.engine.stats()
                if first:
                    c = state["launches"]
                    iters = s1["decode_iters"] - s0["decode_iters"]
                    mixed = s1["mixed_dispatches"] - s0["mixed_dispatches"]
                    dec = c["paged_attention"] - c["paged_attention_multiquery"]
                    check(dec == 12 * iters, f"server: {dec} decode launches "
                          f"for {iters} decode iterations")
                    check(c["paged_attention_multiquery"] == 12 * mixed,
                          f"server: {c['paged_attention_multiquery']} "
                          f"multi-query launches for {mixed} mixed "
                          f"dispatches")
                    m["decode_iters"], m["mixed_dispatches"] = iters, mixed
                InvariantAuditor().check(sup)
                out["turns"].append({"kind": kind, **m})
            check(sup.block_partition()["in_use"] == 0,
                  f"blocks held after the turns: {sup.block_partition()}")

            # a slow client (8-event buffer) is dropped and cancelled
            c0 = sup.engine.stats()["cancelled"]
            srv.client_queue = 8
            slow = await chaos.slow_client(srv, prompts[1], read_events=1,
                                           max_new_tokens=64,
                                           eos_token_id=None)
            srv.client_queue = 64
            # a client that disconnects after 2 events is cancelled
            cut = await chaos.disconnect_mid_stream(
                srv, prompts[2], events=2, max_new_tokens=64,
                eos_token_id=None)
            t = time.time()
            while sup.pending and time.time() - t < 30:
                await asyncio.sleep(0.01)
            check(slow["dropped"] and slow["disconnected"],
                  f"slow client not disconnected: {slow}")
            check(cut["events"] == 2, f"disconnect: {cut}")
            for rid in (slow["rid"], cut["rid"]):
                check(sup.request(rid).state == "cancelled",
                      f"request {rid} ended {sup.request(rid).state}")
            check(sup.engine.stats()["cancelled"] - c0 == 2,
                  "the slow client and the disconnect were not cancelled")
            check(sup.block_partition()["in_use"] == 0,
                  f"blocks held after the faults: {sup.block_partition()}")
            out["faults"] = {"slow_client": slow, "disconnect": cut}

            # SIGTERM: in-flight requests finish, admissions get 503
            check(srv.install_signal_handlers(),
                  "SIGTERM handler not installed on the loop")
            tasks = [asyncio.ensure_future(sse_client(srv.port, {
                "prompt": [int(t) for t in prompts[i]],
                "max_new_tokens": int(news[i]), "eos_token_id": None}))
                for i in range(4)]
            t = time.time()
            while len([r for r in list(sup._reqs.values()) if r.tokens
                       and not r.terminal]) < 4 and time.time() - t < 60:
                await asyncio.sleep(0.005)
            started = [r.srid for r in list(sup._reqs.values())
                       if r.tokens and not r.terminal]
            os.kill(os.getpid(), signal.SIGTERM)
            t = time.time()
            while True:
                st_r, ready, _ = await http_get(srv.port, "/readyz")
                if st_r == 503 or time.time() - t > 10:
                    break
            refused = await sse_client(srv.port, {
                "prompt": [int(t) for t in prompts[5]],
                "max_new_tokens": 4, "eos_token_id": None})
            fins = await asyncio.gather(*tasks)
            check(st_r == 503 and ready["draining"],
                  f"/readyz during the drain: {st_r} {ready}")
            check(refused["status"] == 503
                  and refused["body"]["reason"] == "draining"
                  and refused["body"]["retry_after_s"] > 0,
                  f"/generate during the drain: {refused}")
            for i, f in enumerate(fins):
                want = [int(x) for x in sup.result(f["rid"])]
                check(f["finish"] is not None
                      and f["finish"]["state"] == "finished"
                      and f["finish"]["tokens"] == news[i] == len(want)
                      and f["tokens"] == want[:len(f["tokens"])],
                      f"in-flight client {i} across the drain: "
                      f"{f['finish']}, {len(f['tokens'])} token events")
            rep = srv.drain_report
            check(rep is not None and rep["cancelled"] == 0
                  and rep["leaked_blocks"] == 0, f"drain report {rep}")
            out["sigterm"] = {
                "in_flight": len(started), "drain_report": rep,
                "readyz": st_r, "refused": refused["body"],
                "token_events_in_flight": [len(f["tokens"]) for f in fins],
                "tokens_in_flight": [f["finish"]["tokens"] for f in fins]}
        check(srv.pump_error is None, f"pump error {srv.pump_error!r}")

    asyncio.run(main())
    log(f"  in turns (direct, server, server, direct): "
        f"{json.dumps(out['turns'])}")
    log(f"  slow client / disconnect: {json.dumps(out['faults'])}")
    log(f"  SIGTERM drain: {json.dumps(out['sigterm'])}")
    launches = state["launches"]
    log(f"  launches (first server turn): {json.dumps(launches)}")
    InvariantAuditor().quiesce(sup)
    del srv, sup, direct
    release()

    # the same server over a cold-started 3-replica fleet, a replica killed
    jdir = os.path.join(tmp, "frontend-journal")
    srv = ServingServer.cold_start(jdir, params, cfg, ServingConfig(),
                                   replicas=3, device=dev)
    r = srv.sup
    for rid in r.replicas:                   # warm-up, one short request each
        r.submit(prompts[0][:40], max_new_tokens=4, eos_token_id=None,
                 replica=rid)
    while r.pending:
        r.step()
    c0 = router_counters(r)
    fired = arm_kill(r, 0, at_decode_iter=10)

    async def fleet_main():
        async with srv.running(host="127.0.0.1", port=0):
            m, _ = await server_turn(srv, prompts, news)
            InvariantAuditor().check(r)
        check(srv.pump_error is None, f"pump error {srv.pump_error!r}")
        return m

    m = asyncio.run(fleet_main())
    dc = counter_delta(c0, router_counters(r))
    check("t" in fired and r._replicas[0].sup.broken,
          "the armed replica kill never fired")
    check(dc["failovers"] >= 1 and dc["failed"] == 0, f"fleet counters {dc}")
    InvariantAuditor().quiesce(r)
    balanced_fleet(r)
    out["fleet"] = {**m, "failovers": dc["failovers"],
                    "failover_tokens": dc["failover_tokens"],
                    "failed": dc["failed"]}
    log(f"  cold-started 3-replica fleet, replica 0 killed at decode "
        f"iteration 10: {json.dumps(out['fleet'])}")
    del srv, r, params
    release()
    return out, launches


def server_parity_phase(sp, sn, cfg=None, dev="cuda"):
    """Phase 30: fp32 on C's model, C's trace plus its first two requests
    again (8 concurrent in-process clients, half the requests seeded):
    the server's streams equal the supervisor's direct drain, through an
    engine crash too (each token delivered once), and through a 3-replica
    router with and without a crash."""
    import asyncio
    import torch
    from paddle_tpu_torch.inference.serving import (EngineSupervisor,
                                                    RouterConfig,
                                                    ServingConfig,
                                                    ServingRouter,
                                                    ServingServer)
    from paddle_tpu_torch.models.llama import init_params
    cfg32 = cfg or model_config(torch.float32)
    params = init_params(cfg32, seed=SEED + 1, device=dev)
    prompts, news = list(sp) + list(sp[:2]), list(sn) + list(sn[:2])
    knobs = [dict(SAMPLED, seed=i) if i % 2 else {}
             for i in range(len(prompts))]
    sup = EngineSupervisor(params, cfg32, ServingConfig(), device=dev)
    ids, got, _ = client_drive(sup, prompts, news, knobs)
    want = [got[i] for i in ids]
    del sup
    release()
    done = []

    def serve(name, backend, crashed=None):
        srv = ServingServer(backend)

        async def one(i):
            toks, kinds, fin = [], [], None
            async for ev in srv.agenerate(prompts[i], max_new_tokens=news[i],
                                          eos_token_id=None, **knobs[i]):
                kinds.append(ev["type"])
                if ev["type"] == "token":
                    toks.append(ev["token"])
                elif ev["type"] == "finish":
                    fin = ev
            return toks, kinds, fin

        async def main():
            async with srv.running():
                return await asyncio.gather(*(one(i)
                                              for i in range(len(prompts))))

        outs = asyncio.run(main())
        check(srv.pump_error is None, f"{name}: pump error "
              f"{srv.pump_error!r}")
        for i, (toks, kinds, fin) in enumerate(outs):
            check(toks == want[i], f"fp32 {name}, request {i}: {toks} != "
                  f"{want[i]}")
            check(kinds == ["start"] + ["token"] * news[i] + ["finish"]
                  and fin["tokens"] == news[i],
                  f"fp32 {name}, request {i}: events {kinds}")
        if crashed is not None:
            n = sum(sup.restarts for sup in crashed)
            check(n >= 1, f"{name}: the armed crash never fired")
        done.append(name)

    serve("server", EngineSupervisor(params, cfg32, ServingConfig(),
                                     device=dev))
    release()
    sup = EngineSupervisor(params, cfg32, ServingConfig(), device=dev)
    arm_crash(sup, 3)
    serve("server, engine crash", sup, crashed=[sup])
    del sup
    release()
    r = ServingRouter(params, cfg32, ServingConfig(),
                      router_config=RouterConfig(replicas=3), device=dev)
    serve("server over 3 replicas", r)
    balanced_fleet(r)
    del r
    release()
    r = ServingRouter(params, cfg32, ServingConfig(),
                      router_config=RouterConfig(replicas=3), device=dev)
    sups = [rep.sup for rep in r._replicas.values()]
    for s in sups:                           # whichever replica decodes
        arm_crash(s, 3)
    serve("server over 3 replicas, replica crashes", r, crashed=sups)
    balanced_fleet(r)
    del r, params
    release()
    log(f"  fp32 server streams equal the supervisor's direct drain: "
        f"{', '.join(done)}")
    return {"paths": done}


# every report field keyed to steps, counts or the trace (not the clock)
REPLAY_STEP_KEYS = (
    "requests", "outcomes", "completed", "failed", "gave_up", "retries",
    "shed_submits", "steps", "tokens_delivered", "good_tokens",
    "mean_fleet", "tp", "ttft_steps_p50", "ttft_steps_p99",
    "arrival_ttft_steps_p50", "arrival_ttft_steps_p99",
    "pre_spawn_ttft_p99_steps", "post_spawn_ttft_p99_steps",
    "ttft_p99_at_spawn_steps", "ttft_p99_after_spawn_steps", "autoscale",
    "chaos_fired", "chaos_kinds", "violations", "audit", "audit_trail",
    "router_failed", "leaked_blocks", "prompt_len_mean", "manifest_json",
    "streams")


def replay_phase(cfg=None, dev="cuda", requests=192, int8_requests=64,
                 hbm_gb=None):
    """Phase 31 (cell U): ``run_replay`` at A's width, 3 replicas on the
    card, 6 chaos events, the autoscaler on; the auditor raises on any
    violation. Then the manifest replayed onto a fresh fleet (every
    step-keyed field and stream equal), then an int8 replay. The capacity
    report sizes pools against ``hbm_gb`` (``None``: the card's memory).
    Returns (metrics, main-path launches)."""
    import torch
    from paddle_tpu_torch.inference.serving import (ReplayManifest,
                                                    ServingConfig,
                                                    WorkloadSpec,
                                                    run_replay)
    from paddle_tpu_torch.models.llama import init_params
    cfg = cfg or model_config(torch.bfloat16)
    params = init_params(cfg, seed=SEED, device=dev)
    spec = WorkloadSpec(vocab_size=cfg.vocab_size, requests=requests,
                        prefix_len=64, tail_lens=(16, 32, 64, 128),
                        output_lens=(8, 16, 32, 64))
    reset_counts()
    one = run_replay(params, cfg, spec=spec, replicas=3, chaos="auto",
                     chaos_events=6, record_streams=True, device=dev,
                     hbm_gb=hbm_gb)
    launches = read_counts()
    n_out = sum(one["outcomes"].values())
    check(n_out == one["requests"] == requests
          and not set(one["outcomes"]) & {"waiting", "backoff", "live"},
          f"replay outcomes {one['outcomes']}")
    check(one["failed"] == 0 and one["router_failed"] == 0
          and one["leaked_blocks"] == 0 and one["violations"] == [],
          f"replay: failed {one['failed']}, router_failed "
          f"{one['router_failed']}, leaked {one['leaked_blocks']}")
    check(one["chips"] == 1.0, f"three replicas on one card counted as "
          f"{one['chips']} chips")
    check(launches["paged_attention"] > 0, "replay never launched paged "
          "attention")
    release()
    two = run_replay(params, cfg,
                     manifest=ReplayManifest.from_json(one["manifest_json"]),
                     record_streams=True, device=dev, hbm_gb=hbm_gb)
    for k in REPLAY_STEP_KEYS:
        check(two[k] == one[k], f"replay of the manifest: {k} differs "
              f"({str(one[k])[:200]} != {str(two[k])[:200]})")
    release()
    keys = ("elapsed_s", "req_s", "goodput_tok_s", "goodput_tok_s_per_chip",
            "chips", "mean_fleet", "completed", "outcomes", "retries",
            "shed_submits", "steps", "ttft_steps_p50", "ttft_steps_p99",
            "ttft_s_p50", "ttft_s_p99", "tpot_s_p50", "tpot_s_p99",
            "tokens_delivered", "good_tokens", "chaos_kinds",
            "chaos_fired", "autoscale")
    out = {"bf16": {k: one[k] for k in keys},
           "rerun_elapsed_s": two["elapsed_s"],
           "capacity": one["capacity"]}
    log(f"  bf16 replay, {requests} requests, 3 replicas: "
        f"{json.dumps(out['bf16'], default=str)}")
    log(f"  capacity report at the card's memory: "
        f"{json.dumps(one['capacity'])}")
    log(f"  the manifest replayed onto a fresh fleet: every step-keyed field "
        f"and all {len(one['streams'])} streams equal "
        f"({two['elapsed_s']} s)")
    del one, two
    ispec = WorkloadSpec(vocab_size=cfg.vocab_size, requests=int8_requests,
                         prefix_len=64, tail_lens=(16, 32, 64, 128),
                         output_lens=(8, 16, 32, 64))
    reset_counts()
    rep8 = run_replay(params, cfg, spec=ispec, replicas=3,
                      serving_config=ServingConfig(quantize="int8",
                                                   kv_quant="int8"),
                      chaos="auto", chaos_events=6, device=dev,
                      hbm_gb=hbm_gb)
    c8 = read_counts()
    check(rep8["failed"] == 0 and rep8["leaked_blocks"] == 0
          and sum(rep8["outcomes"].values()) == int8_requests,
          f"int8 replay {rep8['outcomes']}")
    check(c8["weight_only_matmul"] > 0 and c8["paged_attention_int8"] > 0,
          f"int8 replay launches {c8}")
    out["int8"] = {k: rep8[k] for k in keys}
    log(f"  int8 replay, {int8_requests} requests: "
        f"{json.dumps(out['int8'], default=str)}")
    log(f"  launches: bf16 replay {json.dumps(launches)}, int8 replay "
        f"{json.dumps(c8)}")
    del params, rep8
    release()
    return out, {k: launches[k] + c8[k] for k in launches}


# ---------------------------------------------------------------------------
# phases 32-33: tensor-parallel serving on the one card
# ---------------------------------------------------------------------------

def weight_ptrs(engine):
    """The storage of an engine's ``wq`` (one tensor, or the tuple of a
    tensor-parallel engine's column shards)."""
    wq = engine.prepared_params["layers"]["wq"]
    return tuple(t.data_ptr() for t in wq) if isinstance(wq, tuple) \
        else (wq.data_ptr(),)


def shard_kernel_phase():
    """Phase 32: the two serving kernels at the shapes one shard of A's
    model gets at tp 2 and 4 (8 / 4 query and kv heads; the q/k/v
    projections' N = 2048 / tp), under phase 3's rules."""
    att, mm = [], []
    for tp in (2, 4):
        h = 16 // tp
        shape = f"M=8 H={h} Hk={h} D=128 bs=16 W=128"
        att.append(attention_case(f"tp{tp} shard decode bf16 {shape}", 8, h,
                                  h, 128, 16, 128, False, seed=320 + tp))
        att.append(attention_case(f"tp{tp} shard decode int8 {shape}", 8, h,
                                  h, 128, 16, 128, True, seed=330 + tp))
        att.append(attention_case(
            f"tp{tp} shard verify bf16 Q=5 {shape} draft_lens 0..4", 8, h, h,
            128, 16, 128, False, Q=5, seed=340 + tp, every_draft_len=True))
    for M in (8, 2048):
        for N in (1024, 512):
            mm.append(matmul_case(M, 2048, N, seed=350 + M + N))
    return att, mm


def placement(tp, dev):
    """``tp`` shards all on ``dev`` (the card's index 0, or the CPU)."""
    return [dev if dev == "cpu" else "cuda:0"] * tp


def forwards(m):
    """The model forwards a drain ran: every dispatch is one forward,
    except a decode dispatch, which runs one a decode iteration."""
    return (m["prefill_dispatches"] + m["mixed_dispatches"]
            + m["spec_dispatches"] + m["decode_iters"])


def tp_serving_phase(prompts, news, cfg=None, dev="cuda"):
    """Phase 33, A and B: A's model and trace at bf16 through
    ``ServingEngine`` at tp 1 and at tp 2 with both shards on the card,
    in turns (1, 2, 2, 1), then B's int8 weights and pool at tp 2. Gates
    the exact launch counts: paged attention ``L x tp`` a decode
    iteration or mixed dispatch, the int8 matmul ``L x (3 tp + 4) + 1`` a
    forward; every bf16 stream where tp 1 and tp 2 part is held to bf16
    rounding (``divergence_margins``). Returns (metrics, the first tp-2
    turn's launches plus the int8 run's)."""
    import torch
    from paddle_tpu_torch.inference.serving import (ServingConfig,
                                                    ServingEngine)
    from paddle_tpu_torch.models.llama import init_params
    cfg = cfg or model_config(torch.bfloat16)
    L = cfg.num_hidden_layers
    params = init_params(cfg, seed=SEED, device=dev)
    cuda = dev != "cpu"
    out, turns, main = {}, [], None
    for tp in (1, 2, 2, 1):
        mem0 = mem_gb() if cuda else 0.0
        eng = ServingEngine(params, cfg, ServingConfig(tp=tp),
                            device=placement(tp, dev))
        mem1 = mem_gb() if cuda else 0.0
        eng.run([prompts[0][:40]], max_new_tokens=4, eos_token_id=None)
        reset_counts()
        streams, m = drive(eng, prompts, news)
        c = read_counts()
        want = L * tp * (m["decode_iters"] + m["mixed_dispatches"])
        if cuda:
            check(c["paged_attention"] == want,
                  f"tp {tp}: {c['paged_attention']} paged-attention "
                  f"launches, want {want} ({L} x {tp} a decode iteration "
                  f"or mixed dispatch)")
        if tp == 2 and main is None:
            main = c
        m.update(tp=tp, launches=c,
                 attention_launches_per_decode_iter=L * tp,
                 engine_gb=mem1 - mem0,
                 pool_gb=eng.cache.kv_bytes() / 2**30,
                 pool_shard_gb=eng.cache.kv_bytes(per_shard=True) / 2**30)
        out.setdefault(tp, streams)
        turns.append(m)
        log(f"  tp {tp}: {json.dumps(m)}")
        del eng
        release()
    equal = sum(np.array_equal(a, b) for a, b in zip(out[1], out[2]))
    log(f"  {equal} of {len(prompts)} bf16 streams equal between tp 1 and "
        f"tp 2")
    rows = divergence_margins(params, cfg, prompts, out[1], out[2]) \
        if cuda else []
    eng = ServingEngine(params, cfg, ServingConfig(
        tp=2, quantize="int8", kv_quant="int8"), device=placement(2, dev))
    eng.run([prompts[0][:40]], max_new_tokens=4, eos_token_id=None)
    reset_counts()
    _, m8 = drive(eng, prompts, news)
    c8 = read_counts()
    per = L * (3 * 2 + 4) + 1
    if cuda:
        check(c8["weight_only_matmul"] == per * forwards(m8),
              f"int8 tp 2: {c8['weight_only_matmul']} matmul launches, want "
              f"{per} x {forwards(m8)} forwards")
        check(c8["paged_attention_int8"] == c8["paged_attention"] > 0,
              f"int8 tp 2 attention launches {c8}")
    m8.update(launches=c8, matmul_launches_per_forward=per)
    log(f"  int8 tp 2: {json.dumps(m8)}")
    del eng, params
    release()
    launches = {k: main[k] + c8[k] for k in main}
    return {"turns": turns, "equal_streams": equal, "divergences": rows,
            "int8": m8}, launches


# first-dispatch fp32 logits at tp > 1 against tp 1, as a share of
# max |logit|: fp pools round like the projections (an ulp of cuBLAS's
# fp32 GEMM, whose reduction depends on N); int8 pools may move a KV
# entry by one quantization step (1/127 of its row's range)
FP_LOGIT_TOL, INT8_LOGIT_TOL = 1e-4, 1e-2


def first_dispatch_tp(params, cfg, prompts):
    """A batched prefill, then one decode step through the kernel and the
    gather path, at tp 2 and 4 (shards on the card) against tp 1, fp and
    int8 pools; each logits tensor within its tolerance of tp 1's.
    Returns {case: max |d| / max |logit|}."""
    import torch
    from paddle_tpu_torch.models import generation as G
    from paddle_tpu_torch.models.llama import shard_serving_params
    out = {}
    for kv in (None, "int8"):
        ref = None
        for tp in (1, 2, 4):
            devs = None if tp == 1 else [torch.device("cuda", 0)] * tp
            p = params if tp == 1 else shard_serving_params(params, devs)
            pre, pool, tok, (sl, tbl, act), _ = first_dispatch(
                p, cfg, prompts, kv_quant=kv, devices=devs)
            got = [pre]
            for use in (True, False):
                copy = ({k: v.clone() for k, v in pool.items()} if tp == 1
                        else [{k: v.clone() for k, v in sh.items()}
                              for sh in pool])
                got.append(G.paged_decode_step(p, cfg, tok, sl, tbl, copy,
                                               act, use_kernel=use)[0])
            del pool, p
            if ref is None:
                ref = got
                continue
            tol = INT8_LOGIT_TOL if kv else FP_LOGIT_TOL
            for name, a, b in zip(("prefill", "decode kernel",
                                   "decode gather"), got, ref):
                rel = float((a - b).abs().max() / b.abs().max())
                out[f"{kv or 'fp'} tp{tp} {name}"] = rel
                check(rel <= tol, f"fp32 {kv or 'fp'} pool tp {tp} {name} "
                      f"logits {rel:.3g} x max|logit| from tp 1 > {tol}")
        release()
    return out


def lockstep(params, cfg, tp, prompts, news, knobs, dev, **kw):
    """Drain the trace on a tp-1 engine, then on a tp-``tp`` engine whose
    every sampled token is replaced by the tp-1 engine's at the same
    dispatch (teacher forcing: both see the same contexts throughout),
    then freely. At every dispatch each live row's fp32 logits must lie
    within ``INT8_LOGIT_TOL`` x max |logit| of tp 1's; a live row whose
    own token differs there is a near tie. Returns the worst deviation,
    the near ties, and the free run's streams equal to tp 1's."""
    import torch
    from paddle_tpu_torch.inference.serving import (ServingConfig,
                                                    ServingEngine)
    from paddle_tpu_torch.models import generation as G
    real = {n: getattr(G, n) for n in ("sample_tokens", "paged_prefill",
                                       "paged_prefill_chunk",
                                       "paged_decode_step",
                                       "paged_mixed_step")}

    def run(t, forced=None):
        rec, live = [], [None]
        eng = ServingEngine(params, cfg, ServingConfig(tp=t, **kw),
                            device=placement(t, dev))

        def forward(name):
            # where the entry point takes its active mask (the live rows
            # of the next sampled logits); a chunk is one live row
            at = {"paged_prefill": 6, "paged_decode_step": 6,
                  "paged_mixed_step": 7}.get(name)

            def f(*a, **k):
                live[0] = (torch.ones(1, dtype=torch.bool) if at is None
                           else a[at])
                return real[name](*a, **k)
            return f

        def pick(logits, out):
            rec.append((logits.detach().float().clone(), out.copy(),
                        live[0].detach().cpu().numpy().copy()))
            if forced is not None:
                want = forced[len(rec) - 1][1]
                check(want.shape == out.shape, "the dispatches differ")
                return want.copy()
            return out

        def sample(logits, *a):
            out = real["sample_tokens"](logits, *a).cpu().numpy()
            return torch.from_numpy(pick(logits, out))

        eng._argmax = lambda logits: pick(
            logits, logits.argmax(dim=-1).to(torch.int32).cpu().numpy())
        for name in real:
            setattr(G, name, sample if name == "sample_tokens"
                    else forward(name))
        try:
            streams, _ = drive(eng, prompts, news, knobs, max_iters=2)
        finally:
            for name, fn in real.items():
                setattr(G, name, fn)
        del eng
        release()
        return [[int(x) for x in o] for o in streams], rec

    want, ref = run(1)
    forced, got = run(tp, ref)
    check(forced == want, "teacher forcing did not hold the streams")
    worst, ties = 0.0, []
    for k, ((l1, o1, a1), (l2, o2, _)) in enumerate(zip(ref, got)):
        rows = np.flatnonzero(a1[:len(o1)]) if a1.ndim else []
        for r in rows:
            scale = float(l1[r].abs().max())
            d = float((l1[r] - l2[r]).abs().max()) / scale
            worst = max(worst, d)
            check(d <= INT8_LOGIT_TOL, f"tp {tp} {kw}: dispatch {k} row "
                  f"{r} logits {d:.3g} x max|logit| from tp 1")
            if o1[r] != o2[r]:
                ties.append([k, int(r), int(o1[r]), int(o2[r]), d])
    free, _ = run(tp)
    equal = sum(a == b for a, b in zip(free, want))
    return {"worst_rel": worst, "near_ties": ties,
            "free_streams_equal": f"{equal} of {len(want)}"}



def tp_parity_phase(sp, sn, cfg=None, dev="cuda"):
    """Phase 33, C: fp32 streams at tp 2 and 4 (every shard on the card)
    equal tp 1's on C's model and trace, half the requests seeded, stepped
    2 decode iterations at a time: kernel and gather, fp and int8 pools,
    mixed on and off, speculative verify (a drafter proposing the tp-1
    stream's continuation: every draft verified and accepted), LoRA, an
    engine crash under a supervisor (memory within one pool of its
    pre-crash level, the weight shards not re-made), a 2-replica tp-2
    router with a kill (0 failed, one copy of the weight shards), the
    host offload tier (and a corrupted host block) and one live
    migration. Returns the paths checked."""
    import torch
    from paddle_tpu_torch.inference.serving import (EngineSupervisor,
                                                    RouterConfig,
                                                    ServingConfig,
                                                    ServingEngine,
                                                    ServingRouter)
    from paddle_tpu_torch.models.llama import init_params
    from paddle_tpu_torch.models.lora import lora_init_params
    cfg32 = cfg or model_config(torch.float32)
    params = init_params(cfg32, seed=SEED + 1, device=dev)
    cuda = dev != "cpu"
    knobs = [dict(SAMPLED, seed=i) if i % 2 else {} for i in range(len(sp))]
    done = []

    def engine(tp, **kw):
        return ServingEngine(params, cfg32, ServingConfig(tp=tp, **kw),
                             device=placement(tp, dev))

    def single(tp, adapters=None, hook=None, **kw):
        eng = engine(tp, **kw)
        for name, ap in (adapters or {}).items():
            eng.register_adapter(name, ap)
        if hook is not None:
            hook(eng)
        ids = None
        if adapters:
            names = sorted(adapters)
            ids = [dict(k, adapter_id=names[i % len(names)]) if i % 3 else k
                   for i, k in enumerate(knobs)]
        streams, m = drive(eng, sp, sn, ids or knobs, max_iters=2)
        del eng
        release()
        return [[int(t) for t in o] for o in streams], m

    def same(name, got, want):
        for k, (a, b) in enumerate(zip(got, want)):
            check(a == b, f"fp32 {name}, request {k}: {a} != {b}")
        done.append(name)

    if cuda:
        logits_rows = first_dispatch_tp(params, cfg32, sp)
    for kernel in ("on", "off"):
        want, _ = single(1, paged_kernel=kernel)
        for tp in ((2, 4) if kernel == "on" else (2,)):
            got, m = single(tp, paged_kernel=kernel)
            check(m["mixed_dispatches"] > 0, "no mixed dispatch")
            same(f"tp {tp} fp pool, kernel {kernel}", got, want)
    # int8 pools: fp32 projections at a shard's width round differently
    # (cuBLAS picks its fp32 GEMM by N), and the per-token quantizer
    # turns an ulp into a whole int8 step, so a near-tie may part; each
    # dispatch is held within INT8_LOGIT_TOL of tp 1, teacher-forced
    int8 = {}
    for kernel in ("on", "off"):
        for tp in ((2, 4) if kernel == "on" else (2,)):
            int8[(tp, kernel)] = lockstep(params, cfg32, tp, sp, sn, knobs,
                                          dev, kv_quant="int8",
                                          paged_kernel=kernel)
            done.append(f"tp {tp} int8 pool, kernel {kernel} (lockstep)")
    want = single(1)[0]
    got, _ = single(2, mixed_batch=False)
    same("tp 2 mixed off", got, single(1, mixed_batch=False)[0])
    # the verify path, fed the tp-1 stream's own continuation as drafts
    cont = {np.asarray(p, np.int32).tobytes(): s for p, s in zip(sp, want)}

    def oracle_drafts(eng):
        def drafts(req):
            k = min(4, int(eng._steps_left[req.slot]) - 1)
            t = len(req.tokens)
            s = cont[np.asarray(req.prompt, np.int32).tobytes()]
            return [int(x) for x in s[t:t + k]] if k > 0 else []
        eng._draft_tokens = drafts

    for tp in (2, 4):
        got, m = single(tp, hook=oracle_drafts, spec_decode=4,
                        spec_ngram=2)
        check(m["spec_dispatches"] > 0
              and m["spec_accepted"] == m["spec_drafted"] > 0,
              f"tp {tp} verify: {m['spec_dispatches']} dispatches, "
              f"{m['spec_drafted']} drafted, {m['spec_accepted']} accepted")
        same(f"tp {tp} speculative verify", got, want)
    adapters = {f"a{i}": lora_init_params(cfg32, LORA_RANK, seed=300 + i)
                for i in range(2)}
    lw, _ = single(1, adapters=adapters, lora_rank=LORA_RANK, lora_slots=2,
                   lora_pool=4)
    check(lw != want, "the adapters never moved a stream")
    got, _ = single(2, adapters=adapters, lora_rank=LORA_RANK, lora_slots=2,
                    lora_pool=4)
    same("tp 2 LoRA", got, lw)
    # an engine crash under a supervisor: the rebuild reuses the shards
    sup = EngineSupervisor(params, cfg32, ServingConfig(tp=2),
                           device=placement(2, dev))
    srids, got_s, ms = supervised_drive(sup, sp, sn, knobs, crash_at=3,
                                        max_iters=2)
    same("tp 2 supervisor crash", [got_s[s] for s in srids], want)
    if cuda:
        check(abs(ms["mem_after_gb"] - ms["mem_before_gb"])
              <= ms["pool_gb"], f"memory across the rebuild {ms}")
    crash = {k: ms[k] for k in ("recovery_ms", "mem_before_gb",
                                "mem_after_gb", "pool_gb") if k in ms}
    del sup
    release()
    # a 2-replica tp-2 fleet with a kill: one copy of the weight shards
    r = ServingRouter(params, cfg32, ServingConfig(tp=2),
                      router_config=RouterConfig(replicas=2),
                      device=placement(2, dev))
    ptrs = {weight_ptrs(rep.sup.engine) for rep in r._replicas.values()}
    check(len(ptrs) == 1, f"the replicas hold {len(ptrs)} weight copies")
    c0 = router_counters(r)
    ids, got_r, _ = client_drive(
        r, sp, sn, knobs, max_iters=2,
        after_step=lambda i: arm_kill(r, 0) if i == 1 else None)
    same("tp 2 router with a kill", [got_r[i] for i in ids], want)
    dc = counter_delta(c0, router_counters(r))
    check(dc["failovers"] >= 1 and dc["failed"] == 0, f"kill {dc}")
    balanced_fleet(r)
    del r
    release()
    # the host offload tier: churn, then revisit; a corrupt host block
    churn, revisit = family_trace(cfg32.vocab_size, SEED + 33, fams=6,
                                  per=2, pre=64, tail=16)
    tier = {}
    for tp in (1, 2):
        for corrupt in (False, True):
            eng = engine(tp, num_blocks=40, max_slots=4, prefix_cache=True,
                         offload=True, offload_blocks=128)
            outs, m, _ = churn_revisit(
                eng, churn, revisit, new=8,
                between=(lambda e: e.cache.offload.corrupt_one(1))
                if corrupt else None)
            tier[(tp, corrupt)] = ([[int(t) for t in o] for o in outs],
                                   m["offload"])
            del eng
            release()
    for corrupt in (False, True):
        same(f"tp 2 offload tier{', a corrupt block' if corrupt else ''}",
             tier[(2, corrupt)][0], tier[(1, corrupt)][0])
        check(tier[(2, corrupt)][1] == tier[(1, corrupt)][1],
              f"tier counters {tier[(2, corrupt)][1]} != "
              f"{tier[(1, corrupt)][1]}")
    check(tier[(2, False)][1]["tier_hits"] > 0
          and tier[(2, True)][1]["corrupt_drops"] == 1,
          f"tier {tier[(2, False)][1]} / {tier[(2, True)][1]}")
    # one live migration between two tp-2 engines, mid-decode
    a, b = engine(2), engine(2)
    rids = [a.submit(p, max_new_tokens=n, eos_token_id=None, **k)
            for p, n, k in zip(sp, sn, knobs)]
    got_a, got_b = {}, {}
    for _ in range(2):
        for rid, toks in a.step(2).items():
            got_a.setdefault(rid, []).extend(int(t) for t in toks)
    moved = {}
    for rid in rids:
        moved[rid] = b.adopt(a.serialize_request(rid))
        a.cancel(rid)
    while b.pending:
        for rid, toks in b.step(2).items():
            got_b.setdefault(rid, []).extend(int(t) for t in toks)
    same("tp 2 migration", [got_a.get(r, []) + got_b.get(moved[r], [])
                            for r in rids], want)
    check(b.stats()["recomputed_tokens"] == 0
          and a.cache.manager.blocks_in_use == 0
          and b.cache.manager.blocks_in_use == 0, "migration leaked")
    del a, b, params
    release()
    if cuda:
        log(f"  first-dispatch fp32 logits against tp 1, max |d| / max "
            f"|logit|: {json.dumps(logits_rows)}")
    log(f"  int8 pools, lockstep against tp 1: "
        f"{json.dumps({f'tp{t} kernel {k}': v for (t, k), v in int8.items()})}")
    log(f"  fp32 crash under the supervisor at tp 2: {json.dumps(crash)}")
    log(f"  {len(done)} fp32 paths held to tp 1 (streams equal, or "
        f"lockstep): {'; '.join(done)}")
    return done



# ---------------------------------------------------------------------------
# phases 34-35: fault-tolerant training (cell W)
# ---------------------------------------------------------------------------

def _sync(dev):
    import torch
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def _state_leaves(state):
    from paddle_tpu_torch.models.llama import _leaves
    return _leaves(state)


def _clone_state(state):
    """A device copy of every leaf of ``{"params", "opt"}``."""
    from paddle_tpu_torch.models.llama import _tree_map
    return _tree_map(lambda t: t.detach().clone(), state)


def _fill_state(state, src):
    """Copy ``src``'s leaves into the live tensors of ``state``."""
    import torch
    with torch.no_grad():
        for d, s in zip(_state_leaves(state), _state_leaves(src)):
            d.copy_(s)


def _equal_state(a, b):
    import torch
    la, lb = _state_leaves(a), _state_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


class TokenRows:
    """``n`` seeded rows of ``seq + 1`` int32 tokens; item i is ``(ids,
    labels, i)``: the row's first ``seq`` tokens, its last ``seq`` (the
    shifted pair) and the index."""

    def __init__(self, n, seq, vocab, seed):
        self.rows = np.random.default_rng(seed).integers(
            0, vocab, (n, seq + 1), dtype=np.int32)

    def __len__(self):
        return len(self.rows)

    def __getitem__(self, i):
        r = self.rows[i]
        return r[:-1], r[1:], np.int64(i)


def ft_training_phase(tmp, cfg=None, dev="cuda", batch=8, seq=2048,
                      rows=512, inflight_max=30):
    """Phase 34 (cell W): F's step (``use_kernels``, ``use_fused_norm``,
    full remat, bf16 compute, fp32 params and AdamW at lr 1e-4) with
    ``sentinel=True``, fed by the port's DataLoader (2 forked workers, a
    transient bad row healed by a retry, a deterministic one quarantined)
    through ``prefetch_to_device``; the checkpoint stack and the health
    ladder driven through every rung. Returns (metrics, launches)."""
    import shutil

    import torch
    from paddle_tpu_torch.distributed.checkpoint import (
        AsyncCheckpointer, manifest)
    from paddle_tpu_torch.health import (HealthAbortError, HealthAction,
                                         HealthMonitor, sentinel_init,
                                         unpack_health)
    from paddle_tpu_torch.io import DataLoader, prefetch_to_device
    from paddle_tpu_torch.models.llama import init_params, make_train_step
    from paddle_tpu_torch.testing import chaos
    t_phase = time.time()
    cfg = cfg or train_config(torch.bfloat16, use_fused_norm=True)
    params = init_params(cfg, seed=SEED, device=dev)
    init_opt, step = make_train_step(cfg, lr=1e-4, sentinel=True)
    opt = init_opt(params)
    sent = sentinel_init(dev)
    nbytes = sum(t.numel() * t.element_size()
                 for t in _state_leaves({"params": params, "opt": opt}))
    free = shutil.disk_usage(tmp).free
    log(f"  train state {nbytes / 1e9:.3f} GB (params, m, v, step); free "
        f"in {tmp}: {free / 1e9:.1f} GB")
    check(free >= 3 * nbytes, f"{tmp} has {free / 1e9:.1f} GB free; phase "
          f"34 needs 3 x the {nbytes / 1e9:.2f} GB train state (keep_last_k"
          f"=2 plus the save in flight)")

    healed, poisoned = batch + 1, 10 * batch + 3     # batches 1 and 10
    data = chaos.bad_sample(chaos.bad_sample(
        TokenRows(rows, seq, cfg.vocab_size, SEED + 34), [healed],
        fails_each=1), [poisoned], fails_each=None)
    loader = DataLoader(data, batch_size=batch, num_workers=2,
                        sample_retries=1, sample_retry_backoff=0.001,
                        timeout=120)

    def epochs():
        while True:
            yield from loader

    stream = prefetch_to_device(epochs(), size=2, device=dev)
    ck = AsyncCheckpointer(f"{tmp}/series", keep_last_k=2)
    mon = HealthMonitor(checkpointer=ck, skip_threshold=2, max_restores=1,
                        verbose=False)
    seen, sizes = [], []
    n_steps, gstep = 0, 0

    def state():
        return {"params": params, "opt": opt}

    def next_batch():
        t0 = time.time()
        ids, labels, idx = next(stream)
        wait_ms = (time.time() - t0) * 1e3
        seen.extend(idx.tolist())
        sizes.append(ids.shape[0])
        return (ids.long(), labels.long()), wait_ms

    def train(b):
        nonlocal opt, sent, n_steps
        _, opt, sent, health = step(params, opt, sent, *b)
        n_steps += 1
        return unpack_health(health)

    def timed(n, observe=True):
        nonlocal gstep
        ms, waits, losses = [], [], []
        for _ in range(n):
            b, w = next_batch()
            _sync(dev)
            t0 = time.time()
            loss, bad, _ = train(b)         # unpack_health reads the host
            ms.append((time.time() - t0) * 1e3)
            waits.append(w)
            losses.append(loss)
            gstep += 1
            if observe:
                check(mon.observe(gstep, loss, bad).action
                      is HealthAction.OK, f"step {gstep}: loss {loss}")
        return ms, waits, losses

    reset_counts()
    timed(2)                                           # warm-up
    steady_ms, steady_wait, _ = timed(4)
    s = gstep
    m = {"steady_step_ms": float(np.mean(steady_ms)),
         "steady_step_ms_each": steady_ms,
         "tokens_per_s": batch * seq / (np.mean(steady_ms) / 1e3),
         "data_wait_ms_per_step": float(np.mean(steady_wait))}

    # (2) the first save, the write overlapped with training
    clone_s = _clone_state(state())
    _sync(dev)
    t0 = time.time()
    job = ck.save(state(), s)
    m["snapshot_ms"] = (time.time() - t0) * 1e3
    landed = []
    watcher = threading.Thread(target=lambda: (job.wait(),
                                               landed.append(time.time())))
    watcher.start()
    inflight_ms = []
    while ck.is_saving and len(inflight_ms) < inflight_max:
        inflight_ms += timed(1, observe=False)[0]
    m["save_outlived_loop"] = bool(ck.is_saving)
    ck.wait()
    watcher.join(timeout=600)
    check(landed, "the first save never landed")
    path_s = f"{tmp}/series/{manifest.step_dir_name(s)}"
    on_disk = sum(os.path.getsize(f"{path_s}/{f}") for f in os.listdir(path_s))
    m.update({"inflight_steps": len(inflight_ms),
              "inflight_step_ms": float(np.mean(inflight_ms))
              if inflight_ms else None,
              "write_s": landed[0] - t0 - m["snapshot_ms"] / 1e3,
              "bytes_on_disk": on_disk})
    m["inflight_overhead_pct"] = (
        None if not inflight_ms else
        100.0 * (m["inflight_step_ms"] / m["steady_step_ms"] - 1.0))
    m["write_gb_per_s"] = on_disk / 1e9 / m["write_s"]
    check(manifest.is_committed(path_s), "step s did not commit")

    # (3) back to s, four steps, the second commit at s + 4
    _fill_state(state(), clone_s)
    gstep = s
    timed(4)
    s4 = gstep
    clone_s4 = _clone_state(state())
    t0 = time.time()
    ck.save(state(), s4)
    m["snapshot_ms_2"] = (time.time() - t0) * 1e3
    ck.wait()
    m["save_s_2"] = time.time() - t0
    check(ck.all_steps() == [s, s4], f"series {ck.all_steps()}")

    # (4) NaN in the live parameters: SKIP, RESTORE, refilled from s + 4
    def bad_streak():
        nonlocal gstep
        with torch.no_grad():
            params["ln_f"].copy_(chaos.nan_payload(params["ln_f"]))
        acts = []
        for _ in range(2):
            b, _ = next_batch()
            loss, bad, _ = train(b)
            gstep += 1
            acts.append(mon.observe(gstep, loss, bad).action)
        return acts

    acts = bad_streak()
    check(acts == [HealthAction.SKIP, HealthAction.RESTORE],
          f"ladder {acts}")
    t0 = time.time()
    got = mon.restore(state())
    _sync(dev)
    m["restore_verify_ms"] = (time.time() - t0) * 1e3
    check(got == s4, f"monitor restored step {got}, expected {s4}")
    check(_equal_state(state(), clone_s4),
          "restored state differs from the device clone at s + 4")
    check(int(opt["step"]) == int(clone_s4["opt"]["step"]),
          "AdamW step counter not restored")
    sent = sentinel_init(dev)          # reseed the device EMA, as the
    gstep = s4                         # monitor reseeded its own
    b, _ = next_batch()
    loss, bad, _ = train(b)
    check(np.isfinite(loss) and not bad, f"loss after restore {loss}")

    # (5) the newest commit bit-flipped: restore walks back to s
    chaos.flip_bits(f"{tmp}/series/{manifest.step_dir_name(s4)}/data_0.pkl",
                    seed=34)
    t0 = time.time()
    got = ck.restore(state())
    _sync(dev)
    m["walk_back_restore_ms"] = (time.time() - t0) * 1e3
    check(got == s, f"walk-back restored step {got}, expected {s}")
    check(_equal_state(state(), clone_s),
          "walked-back state differs from the device clone at s")

    # (6) the first loss after it within the spread of two replays
    b, _ = next_batch()
    losses = [train(b)[0]]
    for _ in range(2):
        _fill_state(state(), clone_s)
        losses.append(train(b)[0])
    lo, hi = min(losses[1:]), max(losses[1:])
    log(f"  first loss after the walk-back {losses[0]!r}, replays from the "
        f"clone {losses[1]!r} {losses[2]!r}")
    check(lo <= losses[0] <= hi, f"restored loss {losses[0]} outside the "
          f"replays' spread [{lo}, {hi}]")
    m["restored_replay_losses"] = losses

    # (7) the one restore is spent: the next streak aborts with the diagnosis
    acts = bad_streak()
    check(acts == [HealthAction.SKIP, HealthAction.RESTORE],
          f"second ladder {acts}")
    try:
        mon.restore(state())
    except HealthAbortError as e:
        diagnosis = str(e)
    else:
        diagnosis = None
    check(diagnosis is not None and "restore limit reached" in diagnosis
          and "Recent anomalies" in diagnosis,
          f"no HealthAbortError with a diagnosis: {diagnosis!r}")
    log(f"  abort diagnosis: {diagnosis.splitlines()[0]}")
    _fill_state(state(), clone_s)

    # (8) a writer fault surfaces on wait(); the next save commits
    with chaos.async_writer_fault(RuntimeError("chaos: writer fault")):
        ck.save(state(), s + 5)
        try:
            ck.wait()
        except RuntimeError as e:
            fault = str(e)
        else:
            fault = None
    check(fault == "chaos: writer fault", f"writer fault surfaced as "
          f"{fault!r}")
    ck.save(state(), s + 6)
    ck.wait()
    check(ck.latest_step() == s + 6
          and manifest.verify(f"{tmp}/series/{manifest.step_dir_name(s + 6)}"),
          f"the save after the fault did not commit: {ck.all_steps()}")
    counts = read_counts()
    stream.close()

    m["loader_quarantined"] = sorted(loader._quarantined)
    check(loader._quarantined == {poisoned},
          f"quarantine {loader._quarantined}, expected {{{poisoned}}}")
    check(sizes.count(batch - 1) >= 1 and healed in seen,
          f"batch sizes {sorted(set(sizes))}; healed row seen "
          f"{healed in seen}")

    # (9) one epoch with a worker killed mid-epoch: every row once
    epoch = DataLoader(
        chaos.dead_worker(data, at_index=5 * batch + 2,
                          marker=f"{tmp}/worker_died"),
        batch_size=batch, num_workers=2, sample_retries=1,
        sample_retry_backoff=0.001, worker_restarts=1, timeout=120)
    got_rows = sorted(int(i) for _, _, idx in epoch for i in idx)
    want_rows = [i for i in range(rows) if i != poisoned]
    check(os.path.exists(f"{tmp}/worker_died"), "the worker never died")
    check(got_rows == want_rows, f"epoch after a worker death: "
          f"{len(got_rows)} rows, {len(set(got_rows))} distinct, expected "
          f"{len(want_rows)}")

    per_step = {k: v / n_steps for k, v in counts.items() if v}
    m.update({"steps": n_steps, "launches_per_step": per_step,
              "phase_s": time.time() - t_phase})
    log(f"  {json.dumps(m)}")
    want = expected_launches(cfg)
    check(per_step == want, f"launches per step {per_step}, expected {want}")
    return m, counts


def ft_parity_phase(tmp, cfg=None, dev="cuda", steps=8, at=4, batch=2,
                    seq=512):
    """Phase 35: E's fp32 config with the kernels; 8 steps with a save at
    step 4, loaded into a fresh state that runs steps 5-8 again; and
    ``framework.io`` save/load of the same state on the device."""
    import torch
    from paddle_tpu_torch.distributed.checkpoint import (load_state_dict,
                                                         save_state_dict)
    from paddle_tpu_torch.framework import io as fio
    from paddle_tpu_torch.models.llama import init_params, make_train_step
    cfg = cfg or train_config(torch.float32, hidden_size=512,
                              intermediate_size=1376, num_hidden_layers=4,
                              num_attention_heads=8, num_key_value_heads=4,
                              use_fused_norm=True)
    rng = np.random.default_rng(SEED + 35)
    data = [torch.from_numpy(rng.integers(0, cfg.vocab_size, (batch, seq)))
            .to(dev) for _ in range(steps)]
    init_opt, step = make_train_step(cfg, lr=1e-3)

    def run(st, first, last):
        out = []
        for i in range(first, last):
            st["params"], st["opt"], loss = step(st["params"], st["opt"],
                                                 data[i], data[i])
            out.append(loss.item())
        return out

    params = init_params(cfg, seed=SEED + 3, device=dev)
    st = {"params": params, "opt": init_opt(params)}
    ref = run(st, 0, at)
    saved = _clone_state(st)
    save_state_dict(st, f"{tmp}/e_step{at}")
    ref += run(st, at, steps)
    fresh = init_params(cfg, seed=SEED + 4, device=dev)
    st2 = {"params": fresh, "opt": init_opt(fresh)}
    load_state_dict(st2, f"{tmp}/e_step{at}")
    check(_equal_state(st2, saved), "loaded state differs from the saved one")
    resumed = run(st2, at, steps)
    gaps = [abs(a - b) / abs(b) for a, b in zip(resumed, ref[at:])]
    log(f"  losses {ref}; resumed from step {at}: {resumed}; largest gap "
        f"{max(gaps):.3g} x |loss|")
    check(max(gaps) <= 1e-6, f"resumed losses {resumed} vs {ref[at:]}")
    fio.save(saved, f"{tmp}/e.pdparams")
    back = fio.load(f"{tmp}/e.pdparams", device=None if dev == "cuda"
                    else dev)
    check(_equal_state(back, saved)
          and all(t.device == saved["opt"]["step"].device
                  for t in _state_leaves(back)),
          "framework.io round trip changed the state")
    log(f"  framework.io save/load round trip on {dev}: every leaf equal")
    return {"losses": ref, "resumed": resumed, "max_gap": max(gaps)}


# ---------------------------------------------------------------------------
# phases 36-37: the sharded train step over a placement on the one card
# ---------------------------------------------------------------------------

SHARDED_DEGREES = {"dp": 2, "mp": 2, "sharding": 2}


def replicas_equal(tree):
    """Whether every mesh coordinate that holds the same slice of a
    sharded leaf holds the same bits."""
    import torch
    from paddle_tpu_torch.models.llama import _leaves
    for st in _leaves(tree):
        for idx, c in st.unique():
            for c2 in st.mesh.coords():
                if c2 != c and st.index(c2) == idx and not torch.equal(
                        st.local(c2), st.local(c)):
                    return False
    return True
    return True


def sharded_launches(cfg, pieces, mp):
    """Kernel launches a sharded step: every piece of the batch runs, on
    each mp shard, what a serial step runs (``expected_launches``: the
    flash kernels once a layer in backward and twice forward under full
    remat, 2 RMSNorms a layer twice plus the final norm, q and k RoPE a
    layer twice), at the local head counts; so the serial counts x pieces
    x mp."""
    return {k: v * pieces * mp for k, v in expected_launches(cfg).items()}


def entry_bytes(params, mesh, specs):
    """(the bytes params + m + v hold at one mesh coordinate, the bytes of
    the leaves no spec cuts), from the specs: each fp32 leaf's elements
    over the parts its spec cuts it into, x 3."""
    from paddle_tpu_torch.distributed.sharding import spec_axes
    from paddle_tpu_torch.models.llama import _leaves
    shapes = _leaves(params)
    parts = [int(np.prod([mesh.shape[a] for e in spec for a in spec_axes(e)]
                         or [1])) for spec in _leaves(specs)]
    held = 3 * 4 * sum(t.numel() // n for t, n in zip(shapes, parts))
    whole = 3 * 4 * sum(t.numel() for t, n in zip(shapes, parts) if n == 1)
    return held, whole


def sharded_phase(dev="cuda", cfg=None, batch=8, seq=2048, steps=5,
                  gated=3):
    """Phase 36: F's step (``use_kernels``, ``use_fused_norm``, full
    remat, bf16 compute, fp32 params and AdamW at lr 1e-4, B 8 x S 2048)
    at dp 2 x mp 2 x sharding 2 over ``[dev] * 8``, the batch over
    ``("dp", "sharding")`` as ``examples/train_llama.py`` lays it out,
    beside the serial step from the same weights and batches.

    Gates: the first ``gated`` losses within 5e-3 x |loss| of the serial
    step's (the sharded step adds bf16 partial sums in another order: the
    row-parallel ``wo`` and ``w_down`` products are two half-width GEMMs
    summed in bf16 where the serial step runs one, and the logsumexp
    meets across the vocab shards; bf16 carries 8 bits of mantissa, so a
    loss near 10 moves by some 1e-3 relative through 12 layers); dp
    replicas bit-equal after every step; exactly ``sharded_launches`` a
    step; params + m + v at a placement entry equal to what the specs
    give, within 0.1 % of the serial state / (mp x sharding). Prints step
    ms and tokens/s of both (host clock, the steps after the first), peak
    memory and the device busy share of one profiled sharded step."""
    import torch
    from paddle_tpu_torch.distributed.sharding import shard_to_mesh
    from paddle_tpu_torch.distributed.topology import build_mesh
    from paddle_tpu_torch.models.llama import (batch_spec, init_params,
                                               make_train_step, param_specs,
                                               placement_bytes, shard_params)
    t0 = time.time()
    cfg = cfg or train_config(torch.bfloat16, use_fused_norm=True)
    mesh = build_mesh(SHARDED_DEGREES, [dev] * 8)
    rng = np.random.default_rng(SEED + 36)
    data = [torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                          (batch, seq))).to(dev)
            for _ in range(steps)]
    init_opt, step = make_train_step(cfg, lr=1e-4)
    params = init_params(cfg, seed=SEED, device=dev)
    ps = shard_params(params, mesh, cfg, mp_axis="mp", fsdp_axis="sharding")
    opt_s = init_opt(ps)
    c0 = (0,) * len(mesh.axis_names)
    held = placement_bytes(ps, c0) + placement_bytes(opt_s, c0)
    want, whole = entry_bytes(params, mesh,
                              param_specs(cfg, "mp", "sharding"))
    serial_bytes = 3 * sum(t.numel() * t.element_size()
                           for t in _state_leaves(params))
    share = serial_bytes / (SHARDED_DEGREES["mp"]
                            * SHARDED_DEGREES["sharding"])
    log(f"  placement entry holds {held} bytes of params + m + v (specs "
        f"give {want}); serial state {serial_bytes} / (mp x sharding) = "
        f"{share:.0f} ({held / share:.6f} of it; the replicated norms "
        f"{whole} bytes); {mesh.size} entries {held * mesh.size / 1e9:.2f} "
        f"GB")
    check(held == want and held <= share + whole,
          f"placement entry bytes {held}, specs {want}, share {share}")

    opt = init_opt(params)

    def serial_step(i):
        nonlocal params, opt
        params, opt, loss = step(params, opt, data[i], data[i])
        return loss.item()

    ser, ser_t = timed_steps(serial_step, steps, dev)
    del params, opt
    torch.cuda.empty_cache()
    spec = batch_spec(("dp", "sharding"))
    batches = [shard_to_mesh(d, mesh, spec, "input_ids") for d in data]
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    eq = []

    def sharded_step(i):
        nonlocal ps, opt_s
        ps, opt_s, loss = step(ps, opt_s, batches[i], batches[i])
        return loss.item()

    sh, sh_t = timed_steps(sharded_step, steps, dev, lambda: eq.append(
        replicas_equal(ps) and replicas_equal(opt_s["m"])
        and replicas_equal(opt_s["v"])))
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    pieces = SHARDED_DEGREES["dp"] * SHARDED_DEGREES["sharding"]
    per_step = {k: v / steps for k, v in counts.items() if v}
    wants = sharded_launches(cfg, pieces, SHARDED_DEGREES["mp"])
    rel = [abs(a - b) / abs(b) for a, b in zip(sh[:gated], ser[:gated])]
    m = {"serial_losses": ser, "sharded_losses": sh, "loss_rel": rel,
         "serial_step_ms": float(np.median(ser_t[1:])) * 1e3,
         "sharded_step_ms": float(np.median(sh_t[1:])) * 1e3,
         "serial_step_ms_each": [t * 1e3 for t in ser_t],
         "sharded_step_ms_each": [t * 1e3 for t in sh_t],
         "max_memory_allocated_gb": peak / 2 ** 30,
         "placement_entry_bytes": held, "launches_per_step": per_step}
    m["serial_tokens_per_s"] = batch * seq / m["serial_step_ms"] * 1e3
    m["sharded_tokens_per_s"] = batch * seq / m["sharded_step_ms"] * 1e3
    log(f"  {json.dumps(m)}")
    check(all(np.isfinite(sh)), f"non-finite sharded loss {sh}")
    check(max(rel) <= 5e-3, f"sharded losses {sh[:gated]} vs serial "
          f"{ser[:gated]}: rel {rel}")
    check(all(eq), f"dp replicas bit-equal after each step: {eq}")
    check(per_step == wants, f"launches per step {per_step}, expected "
          f"{wants}")
    prof = profile_device(lambda: step(ps, opt_s, batches[0], batches[0]),
                          "sharded training step", top=10)
    m["profile"] = prof
    m["seconds"] = time.time() - t0
    log(f"  phase 36 took {m['seconds']:.1f} s")
    del ps, opt_s, batches
    torch.cuda.empty_cache()
    return m, counts


def adam_step_gaps(ps, params, grads):
    """How far the sharded params lie from the serial ones after one AdamW
    step: the largest gap over all entries and over the entries whose
    serial gradient exceeds 1e-4 x its leaf's max|g|, and the entries
    beyond 1e-3 with the largest |g| among them (relative to max|g|)."""
    from paddle_tpu_torch.distributed.sharding import assemble
    from paddle_tpu_torch.models.llama import _named
    serial = dict(_named(params))
    out = {"worst": 0.0, "above": 0.0, "n_off": 0, "n": 0, "g_off": 0.0}
    for n, st in _named(ps):
        d = (assemble(st) - serial[n]).abs()
        g = grads[n].abs()
        gmax = g.max()
        off = d > 1e-3
        out["worst"] = max(out["worst"], d.max().item())
        out["above"] = max(out["above"], d[g > 1e-4 * gmax].max().item())
        out["n_off"] += int(off.sum())
        out["n"] += d.numel()
        if off.any():
            out["g_off"] = max(out["g_off"], (g[off].max() / gmax).item())
    return out


def sharded_parity_phase(tmp, dev="cuda", cfg=None, batch=4, seq=512):
    """Phase 37: E's width at fp32 with the kernels (hidden 512, 8 / 4
    heads, 4 layers, B 4 x S 512) at dp 2 x mp 2 x sharding 2 over ``[dev]
    * 8`` against the serial step, with the reference's tolerances: the
    loss within 1e-5, gradients before the update within 1e-4 x max|g|,
    the params within 1e-3 after one AdamW step at lr 1e-2, 3 steps'
    losses within 1e-5 x |loss|. The param gate covers the entries whose
    gradient exceeds the gradient gate's 1e-4 x max|g|: Adam's first step
    moves every entry by lr x g / (|g| + eps), about lr whatever |g| is,
    so where |g| lies within the two paths' fp32 noise the steps part by
    up to 2 lr (the largest gap and the count of such entries are
    printed). Then the collectives on ``dev`` tensors against
    the same calls on CPU tensors (exact); a sharded train state through
    ``AsyncCheckpointer`` into a serial and a sharded state (bit-equal);
    the ZeRO gate (params + m + v + gradients at a placement entry at dp
    2 x sharding 4, B 8, below 0.6 x the replicated layout's)."""
    import torch
    import paddle_tpu_torch.distributed as D
    from paddle_tpu_torch.distributed.checkpoint import AsyncCheckpointer
    from paddle_tpu_torch.distributed.sharding import assemble, shard_to_mesh
    from paddle_tpu_torch.distributed.topology import build_mesh
    from paddle_tpu_torch.models import llama as L
    t0 = time.time()
    cfg = cfg or train_config(torch.float32, hidden_size=512,
                              intermediate_size=1376, num_hidden_layers=4,
                              num_attention_heads=8, num_key_value_heads=4,
                              use_fused_norm=True)
    mesh = build_mesh(SHARDED_DEGREES, [dev] * 8)
    rng = np.random.default_rng(SEED + 37)
    data = [torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                          (batch, seq))).to(dev)
            for _ in range(3)]
    spec = L.batch_spec(("dp", "sharding"))
    init_opt, step = L.make_train_step(cfg, lr=1e-2)
    base = L.init_params(cfg, seed=SEED + 37, device=dev)
    params = L._tree_map(lambda t: t.clone(), base)
    ps = L.shard_params(base, mesh, cfg, mp_axis="mp", fsdp_axis="sharding")
    leaves = L._leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    loss = L.loss_fn(params, data[0], data[0], cfg)
    grads = dict(zip([n for n, _ in L._named(params)],
                     torch.autograd.grad(loss, leaves)))
    b0 = shard_to_mesh(data[0], mesh, spec, "input_ids")
    loss_s, grads_s = L._sharded_grads(ps, b0, b0, cfg)
    loss_gap = abs(loss_s.item() - loss.item())
    g_worst = grad_gap(whole_grads(ps, grads_s), grads)
    del grads_s
    opt, opt_s = init_opt(params), init_opt(ps)
    ser, sh = [], []
    for i, d in enumerate(data):
        params, opt, l1 = step(params, opt, d, d)
        bi = shard_to_mesh(d, mesh, spec, "input_ids")
        ps, opt_s, l2 = step(ps, opt_s, bi, bi)
        ser.append(l1.item())
        sh.append(l2.item())
        if i == 0:
            p = adam_step_gaps(ps, params, grads)
            del grads
    traj = max(abs(a - b) / abs(b) for a, b in zip(sh, ser))
    log(f"  fp32 sharded vs serial: loss gap {loss_gap:.3g}, worst "
        f"gradient leaf max|diff|/max|g| {g_worst:.3g}, params after one "
        f"step: max|diff| {p['worst']:.3g} over all, {p['above']:.3g} "
        f"where |g| > 1e-4 x max|g|, {p['n_off']} of {p['n']} entries "
        f"beyond 1e-3 (their largest |g| {p['g_off']:.3g} x max|g|); "
        f"3-step losses {sh} / {ser} (max gap {traj:.3g} x |loss|)")
    check(loss_gap <= 1e-5, f"fp32 sharded loss gap {loss_gap}")
    check(g_worst <= 1e-4, f"fp32 sharded gradients {g_worst}")
    check(p["above"] <= 1e-3, f"fp32 sharded params {p}")
    check(traj <= 1e-5, f"fp32 sharded 3-step losses {sh} vs {ser}")
    check(replicas_equal(ps), "fp32 dp replicas parted")

    ck = AsyncCheckpointer(f"{tmp}/sharded")
    ck.save({"params": ps, "opt": opt_s}, 3)
    ck.wait()
    serial = {"params": L.init_params(cfg, seed=SEED + 38, device=dev)}
    serial["opt"] = init_opt(serial["params"])
    fresh = L.shard_params(L.init_params(cfg, seed=SEED + 38, device=dev),
                           mesh, cfg, mp_axis="mp", fsdp_axis="sharding")
    sharded = {"params": fresh, "opt": init_opt(fresh)}
    check(ck.restore(serial) == 3 and ck.restore(sharded) == 3,
          "the sharded checkpoint did not restore")
    src = {"params": ps, "opt": {"m": opt_s["m"], "v": opt_s["v"]}}
    dst_s = {"params": sharded["params"], "opt": {"m": sharded["opt"]["m"],
                                                  "v": sharded["opt"]["v"]}}
    dst_1 = {"params": serial["params"], "opt": {"m": serial["opt"]["m"],
                                                 "v": serial["opt"]["v"]}}
    for a, b, c in zip(L._leaves(src), L._leaves(dst_s), L._leaves(dst_1)):
        check(torch.equal(assemble(a), c)
              and all(torch.equal(a.local(k), b.local(k))
                      for k in mesh.coords()),
              "a restored sharded state differs")
    check(int(serial["opt"]["step"]) == int(sharded["opt"]["step"]) == 3,
          "restored step counts")
    log("  AsyncCheckpointer: the sharded state restored bit-equal into a "
        "serial and a sharded state")
    del serial, sharded, fresh

    D.set_hybrid_communicate_group(D.HybridCommunicateGroup(
        dp=8, devices=[dev] * 8))
    try:
        x = torch.from_numpy(rng.standard_normal((8, 1024), np.float32))
        parts = [torch.from_numpy(rng.standard_normal((1024,), np.float32))
                 for _ in range(8)]
        calls = {
            "sum": lambda t: D.all_reduce(t.clone()),
            "max": lambda t: D.all_reduce(t.clone(), op=D.ReduceOp.MAX),
            "min": lambda t: D.all_reduce(t.clone(), op=D.ReduceOp.MIN),
            "gather": lambda t: D.all_gather(t),
            "alltoall": lambda t: D.alltoall(t),
            "broadcast": lambda t: D.broadcast(t.clone(), src=5),
            "scatter": lambda t: D.scatter(torch.zeros_like(t),
                                           tensor_list=list(t.unbind(0))),
            "sum_list": lambda t: torch.stack(D.all_reduce(
                [r.clone() for r in t.unbind(0)])),
        }
        for name, call in calls.items():
            on_dev, on_cpu = call(x.to(dev)), call(x)
            check(on_dev.device.type == torch.device(dev).type
                  and torch.equal(on_dev.cpu(), on_cpu),
                  f"collective {name} on {dev} differs from the CPU")
        got = D.scatter([torch.empty(1024, device=dev) for _ in range(8)],
                        tensor_list=parts)
        check(all(torch.equal(g.cpu(), p) for g, p in zip(got, parts)),
              "per-rank scatter")
        log(f"  collectives on {dev} equal the CPU's: {sorted(calls)}")
    finally:
        D.set_hybrid_communicate_group(None)

    zmesh = build_mesh({"dp": 2, "sharding": 4}, [dev] * 8)
    zb = shard_to_mesh(torch.cat(data[:2]), zmesh, spec, "input_ids")

    def footprint(fsdp):
        zp = L.shard_params(L.init_params(cfg, seed=SEED, device=dev), zmesh,
                            cfg, mp_axis=None, fsdp_axis=fsdp)
        zo = init_opt(zp)
        _, g = L._sharded_grads(zp, zb, zb, cfg)
        gb = sum(t[(0,) * 6].numel() * 4 for t in g.values())
        return (L.placement_bytes(zp, (0,) * 6)
                + L.placement_bytes(zo, (0,) * 6) + gb)

    fs, rp = footprint("sharding"), footprint(None)
    log(f"  ZeRO at dp 2 x sharding 4: {fs} bytes a placement entry "
        f"against {rp} replicated ({fs / rp:.3f})")
    check(fs < 0.6 * rp, f"ZeRO footprint {fs} vs replicated {rp}")
    secs = time.time() - t0
    log(f"  phase 37 took {secs:.1f} s")
    return {"loss_gap": loss_gap, "grad_worst": g_worst, "params": p,
            "traj": traj, "zero_ratio": fs / rp,
            "seconds": secs}


# ---------------------------------------------------------------------------
# phases 38-40: pipeline and context parallelism over a placement
# ---------------------------------------------------------------------------

PP_DEGREES = {"dp": 2, "pp": 4}
SEP_DEGREES = {"dp": 2, "sep": 4}


def pp_launches(cfg, micro, dp):
    """Kernel launches a pipelined step: each micro-batch of each dp rank
    runs every layer as the serial step does (``expected_launches``: the
    flash kernels once a layer in backward and twice forward under full
    remat, 2 RMSNorms a layer twice, q and k RoPE a layer twice), at B /
    (micro x dp) rows; the final norm runs once a dp rank, over all its
    micro-batches at once. So the serial counts x micro x dp, the final
    norm's forward and backward x dp."""
    n = micro * dp
    want = {k: v * n for k, v in expected_launches(cfg).items()}
    if cfg.use_fused_norm:
        for k in ("rms_norm", "rms_norm_bwd"):
            want[k] += dp - n
    return want


def sep_launches(cfg, impl, n):
    """Kernel launches a context-parallel step on unsharded params: the
    serial step's (``expected_launches``; the norms and RoPE run on the
    whole sequence as there), each flash call of a layer replaced by the
    ring's n (n + 1) / 2 block calls (causal: rank i attends blocks 0..i,
    the later ones skipped) or by Ulysses' n (one a rank, on H / n
    heads)."""
    calls = n * (n + 1) // 2 if impl == "ring" else n
    want = expected_launches(cfg)
    for k in ("flash_attention", "flash_attention_bwd_dq",
              "flash_attention_bwd_dkv"):
        want[k] *= calls
    return want


def timed_steps(run, steps, dev, after=None):
    """(losses, host seconds) of ``run(i)`` for i < ``steps``, each timed
    from a synchronized start to its ``loss.item()``; ``after()`` runs
    after each, untimed."""
    losses, times = [], []
    for i in range(steps):
        _sync(dev)
        t = time.time()
        losses.append(run(i))
        times.append(time.time() - t)
        if after is not None:
            after()
    return losses, times


def step_figures(losses, times, batch, seq, dev):
    """Step ms (median of the steps after the first), tokens/s, the
    steps' ms and, on a card, the peak memory."""
    import torch
    ms = float(np.median(times[1:] or times)) * 1e3
    out = {"losses": losses, "step_ms": ms,
           "step_ms_each": [t * 1e3 for t in times],
           "tokens_per_s": batch * seq / ms * 1e3}
    if torch.device(dev).type == "cuda":
        out["max_memory_allocated_gb"] = \
            torch.cuda.max_memory_allocated() / 2 ** 30
    return out


def pp_phase(dev="cuda", cfg=None, batch=8, seq=2048, steps=3, repeats=3,
             micro=4, gated=3):
    """Phase 38: F's step (``use_kernels``, ``use_fused_norm``, full remat,
    bf16 compute, fp32 params and AdamW at lr 1e-4, B 8 x S 2048) through
    ``make_pp_train_step`` at dp 2 x pp 4 over ``[dev] * 8``,
    ``circular_repeats`` 3 (12 layers / (4 x 3) = one block a chunk) and
    4 micro-batches, beside the serial step from the same weights and
    batches.

    Gates: the first ``gated`` losses within 5e-3 x |loss| of the serial
    step's (phase 36's rule: the micro-batches' bf16 sums and the
    vocab-parallel logsumexp run in another order); dp replicas of every
    leaf and moment bit-equal after every step; exactly ``pp_launches`` a
    step; params + m + v at a placement entry equal to what
    ``pp_param_specs`` gives, each block weight and the embedding and head
    at 1/4 a placement entry. Prints step ms and tokens/s of both (host
    clock, the steps after the first), peak memory and the device busy
    share of one profiled pipelined step. One card shows what the
    schedule costs (B / (M x dp) = 1 row a chunk application, 4 x the
    serial step's layer calls), not a speed-up."""
    import torch
    from paddle_tpu_torch.distributed.pipeline import pipeline_ticks
    from paddle_tpu_torch.distributed.sharding import shard_tree
    from paddle_tpu_torch.distributed.topology import build_mesh
    from paddle_tpu_torch.models import llama as L
    t0 = time.time()
    cuda = torch.device(dev).type == "cuda"
    cfg = cfg or train_config(torch.bfloat16, use_fused_norm=True)
    S, dp = PP_DEGREES["pp"], PP_DEGREES["dp"]
    mesh = build_mesh(PP_DEGREES, [dev] * 8)
    rng = np.random.default_rng(SEED + 38)
    data = [torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                          (batch, seq))).to(dev)
            for _ in range(steps)]
    params = L.init_params(cfg, seed=SEED, device=dev)
    specs = L.pp_param_specs(cfg)
    ppp = shard_tree(L.to_pp_layout(params, S, repeats), mesh, specs)
    init_pp, pp_step = L.make_pp_train_step(
        cfg, mesh, micro_batches=micro, circular_repeats=repeats, lr=1e-4)
    opt_pp = init_pp(ppp)
    c0 = (0,) * len(mesh.axis_names)
    held = L.placement_bytes(ppp, c0) + L.placement_bytes(opt_pp, c0)
    want, whole = entry_bytes(L.to_pp_layout(params, S, repeats), mesh,
                              specs)
    quarter = {n: ppp[n].nbytes_at(c0) * S == params[n].numel() * 4
               for n in ("embed", "lm_head") if n in ppp}
    quarter.update({n: st.nbytes_at(c0) * S == params["layers"][n].numel()
                    * 4 for n, st in ppp["layers"].items()})
    log(f"  placement entry holds {held} bytes of params + m + v (specs "
        f"give {want}; ln_f whole: {whole}); every block weight, embed "
        f"and lm_head at 1/{S} an entry: {all(quarter.values())}")
    check(held == want and all(quarter.values()),
          f"pp placement entry bytes {held}, specs {want}, {quarter}")

    init_opt, step = L.make_train_step(cfg, lr=1e-4)
    opt = init_opt(params)

    def serial_step(i):
        nonlocal params, opt
        params, opt, loss = step(params, opt, data[i], data[i])
        return loss.item()

    if cuda:
        torch.cuda.reset_peak_memory_stats()
    ser = step_figures(*timed_steps(serial_step, steps, dev), batch, seq,
                       dev)
    del params, opt
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    reset_counts()
    eq = []

    def pipelined_step(i):
        nonlocal ppp, opt_pp
        ppp, opt_pp, loss = pp_step(ppp, opt_pp, data[i], data[i])
        return loss.item()

    def replicas_held():
        eq.append(replicas_equal(ppp) and replicas_equal(opt_pp["m"])
                  and replicas_equal(opt_pp["v"]))

    pp = step_figures(*timed_steps(pipelined_step, steps, dev,
                                   replicas_held), batch, seq, dev)
    counts = read_counts()
    per_step = {k: v / steps for k, v in counts.items() if v}
    wants = pp_launches(cfg, micro, dp)
    rel = [abs(a - b) / abs(b) for a, b in zip(pp["losses"][:gated],
                                               ser["losses"][:gated])]
    m = {"serial": ser, "pipelined": pp, "loss_rel": rel,
         "placement_entry_bytes": held, "launches_per_step": per_step,
         "ticks": pipeline_ticks(micro, S, repeats)}
    log(f"  {json.dumps(m)}")
    check(all(np.isfinite(pp["losses"])), f"non-finite pp loss {pp}")
    check(max(rel) <= 5e-3, f"pp losses {pp['losses']} vs serial "
          f"{ser['losses']}: rel {rel}")
    check(all(eq), f"dp replicas bit-equal after each step: {eq}")
    if cuda:
        check(per_step == wants, f"launches per step {per_step}, expected "
              f"{wants}")
        m["profile"] = profile_device(
            lambda: pp_step(ppp, opt_pp, data[0], data[0]),
            "pipelined training step", top=10)
    m["seconds"] = time.time() - t0
    log(f"  phase 38 took {m['seconds']:.1f} s")
    del ppp, opt_pp
    if cuda:
        torch.cuda.empty_cache()
    return m, counts


def sep_phase(dev="cuda", cfg=None, batch=8, seq=2048, steps=3, gated=3):
    """Phase 39: F's step (phase 38's flags) on unsharded params with the
    hybrid group at dp 2 x sep 4 over ``[dev] * 8`` and ``sep_axis``,
    set up as ``tests/test_context_parallel.py:163`` sets it up (the batch
    laid out by ``batch_spec(("dp",), "sep")``), for ``cp_impl`` "ring"
    and "ulysses" (16 heads / 4), each from the same weights as the serial
    step and on the same batches, S 2048 (512 a sequence part).

    Gates for each: the first ``gated`` losses within 5e-3 x |loss| of
    the serial step's (the ring merges bf16 block outputs by their lse;
    Ulysses runs the serial attention on 4 heads at a time), exactly
    ``sep_launches`` a step. Prints step ms, tokens/s, peak memory and the
    busy share of one profiled step of each, beside the serial step's.
    Unsharded params: the sharded path keeps a copy of the 8.86 GB state
    a coordinate, and eight do not fit in 80 GB; phase 40 holds the
    sharded sep path at E's width."""
    import dataclasses
    import torch
    from paddle_tpu_torch.distributed.sharding import shard_to_mesh
    from paddle_tpu_torch.distributed.topology import (
        HybridCommunicateGroup, set_hybrid_communicate_group)
    from paddle_tpu_torch.models import llama as L
    t0 = time.time()
    cuda = torch.device(dev).type == "cuda"
    cfg = cfg or train_config(torch.bfloat16, use_fused_norm=True)
    hcg = HybridCommunicateGroup(devices=[dev] * 8, **SEP_DEGREES)
    n = SEP_DEGREES["sep"]
    rng = np.random.default_rng(SEED + 39)
    data = [torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                          (batch, seq))).to(dev)
            for _ in range(steps)]
    spec = L.batch_spec(("dp",), "sep")
    batches = [shard_to_mesh(d, hcg.mesh, spec, "input_ids") for d in data]
    set_hybrid_communicate_group(hcg)
    runs, total = {}, None
    try:
        for impl in (None, "ring", "ulysses"):
            c = cfg if impl is None else dataclasses.replace(
                cfg, sep_axis="sep", cp_impl=impl)
            feed = data if impl is None else batches
            params = L.init_params(c, seed=SEED, device=dev)
            init_opt, step = L.make_train_step(c, lr=1e-4)
            opt = init_opt(params)

            def run(i):
                nonlocal params, opt
                params, opt, loss = step(params, opt, feed[i], feed[i])
                return loss.item()

            if cuda:
                torch.cuda.reset_peak_memory_stats()
            reset_counts()
            fig = step_figures(*timed_steps(run, steps, dev), batch, seq,
                               dev)
            counts = read_counts()
            fig["launches_per_step"] = {k: v / steps for k, v in
                                        counts.items() if v}
            name = impl or "serial"
            if impl is not None:
                total = counts if total is None else {
                    k: total[k] + counts[k] for k in total}
                ref = runs["serial"]["losses"]
                fig["loss_rel"] = [abs(a - b) / abs(b) for a, b in
                                   zip(fig["losses"][:gated], ref[:gated])]
                if cuda:
                    fig["profile"] = profile_device(
                        lambda: step(params, opt, feed[0], feed[0]),
                        f"context-parallel training step ({impl})", top=10)
            runs[name] = fig
            log(f"  {name}: {json.dumps(fig)}")
            if impl is not None:
                check(all(np.isfinite(fig["losses"])),
                      f"{impl}: non-finite loss {fig['losses']}")
                check(max(fig["loss_rel"]) <= 5e-3,
                      f"{impl} losses {fig['losses']} vs serial {ref}")
                want = sep_launches(c, impl, n)
                if cuda:
                    check(fig["launches_per_step"] == want,
                          f"{impl}: launches per step "
                          f"{fig['launches_per_step']}, expected {want}")
            del params, opt
            if cuda:
                torch.cuda.empty_cache()
    finally:
        set_hybrid_communicate_group(None)
    secs = time.time() - t0
    log(f"  phase 39 took {secs:.1f} s")
    return {"runs": runs, "seconds": secs}, total


def whole_grads(tree, grads):
    """``{leaf name: whole gradient}`` from ``{name: {coordinate: slice
    gradient}}`` of a tree of :class:`ShardedTensor` leaves."""
    import torch
    from paddle_tpu_torch.models.llama import _named
    out = {}
    for n, st in _named(tree):
        full = torch.empty(st.shape, dtype=st.dtype, device=st.lead)
        for idx, c in st.unique():
            full[tuple(slice(a, b) for a, b, _ in idx)] = grads[n][c]
        out[n] = full
    return out


def grad_gap(got, want):
    """The largest max|got - want| / max|want| over the leaves."""
    return max(((got[n].to(w.device) - w).abs().max()
                / w.abs().max()).item() for n, w in want.items())


def cp_parity_phase(dev="cuda", cfg=None, batch=8, seq=512):
    """Phase 40: E's width at fp32 with the kernels (hidden 512, 8 / 4
    heads, 4 layers, ``use_fused_norm``, B 8 x S 512) against the serial
    loss and gradients, with the reference's tolerances (the loss within
    1e-5, every gradient leaf within 1e-4 x its max|g|):

    * the pipelined loss (``make_pp_train_step``'s, its slices' gradients
      summed over dp): V 1 at dp 2 x pp 4 (4 micro-batches) and V 2 at dp
      4 x pp 2 (2 micro-batches: 4 layers make 4 chunks), each with untied
      and tied embeddings;
    * ring and Ulysses (hybrid group dp 2 x sep 4) on unsharded params and
      on ``shard_params`` at dp 2 x sep 4 and sharding 2 x sep 4 (the
      batch over ``batch_spec(dp_axes, "sep")``)."""
    import dataclasses
    import torch
    from paddle_tpu_torch.distributed.sharding import (shard_to_mesh,
                                                       shard_tree)
    from paddle_tpu_torch.distributed.topology import (
        HybridCommunicateGroup, build_mesh, set_hybrid_communicate_group)
    from paddle_tpu_torch.models import llama as L
    t0 = time.time()
    cfg = cfg or train_config(torch.float32, hidden_size=512,
                              intermediate_size=1376, num_hidden_layers=4,
                              num_attention_heads=8, num_key_value_heads=4,
                              use_fused_norm=True)
    ids = torch.from_numpy(np.random.default_rng(SEED + 40).integers(
        0, cfg.vocab_size, (batch, seq))).to(dev)

    def serial(c):
        params = L.init_params(c, seed=SEED + 40, device=dev)
        leaves = L._leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        loss = L.loss_fn(params, ids, ids, c)
        return loss.item(), dict(zip([n for n, _ in L._named(params)],
                                     torch.autograd.grad(loss, leaves)))

    gaps = {}

    def hold(name, loss, grads, ref):
        gaps[name] = (abs(loss - ref[0]), grad_gap(grads, ref[1]))
        log(f"  {name}: loss gap {gaps[name][0]:.3g}, worst gradient leaf "
            f"max|diff|/max|g| {gaps[name][1]:.3g}")
        check(gaps[name][0] <= 1e-5 and gaps[name][1] <= 1e-4,
              f"fp32 {name}: {gaps[name]}")

    refs = {tie: serial(dataclasses.replace(cfg, tie_word_embeddings=tie))
            for tie in (False, True)}
    for V, deg, micro in ((1, {"dp": 2, "pp": 4}, 4),
                          (2, {"dp": 4, "pp": 2}, 2)):
        mesh = build_mesh(deg, [dev] * 8)
        for tie in (False, True):
            c = dataclasses.replace(cfg, tie_word_embeddings=tie)
            base = L.init_params(c, seed=SEED + 40, device=dev)
            ppp = shard_tree(L.to_pp_layout(base, deg["pp"], V), mesh,
                             L.pp_param_specs(c))
            rings = L._pp_rings(mesh)
            loss, g = L._replica_grads(ppp, lambda: L._pp_loss(
                ppp, ids, ids, c, rings, micro, V), None)
            g = whole_grads(ppp, g)
            g = {n: t.reshape(refs[tie][1][n].shape) for n, t in g.items()}
            hold(f"pp V {V} dp {deg['dp']} x pp {deg['pp']}"
                 f"{' tied' if tie else ''}", loss.item(), g, refs[tie])
    hcg = HybridCommunicateGroup(devices=[dev] * 8, **SEP_DEGREES)
    set_hybrid_communicate_group(hcg)
    try:
        for impl in ("ring", "ulysses"):
            c = dataclasses.replace(cfg, sep_axis="sep", cp_impl=impl)
            hold(f"{impl} unsharded", *serial(c), refs[False])
            for deg, fs, dp_axes in (({"dp": 2, "sep": 4}, None, ("dp",)),
                                     ({"sharding": 2, "sep": 4}, "sharding",
                                      ("sharding",))):
                mesh = build_mesh(deg, [dev] * 8)
                ps = L.shard_params(L.init_params(c, seed=SEED + 40,
                                                  device=dev),
                                    mesh, c, mp_axis=None, fsdp_axis=fs)
                b = shard_to_mesh(ids, mesh, L.batch_spec(dp_axes, "sep"),
                                  "input_ids")
                loss, g = L._sharded_grads(ps, b, b, c)
                where = " x ".join(f"{a} {k}" for a, k in deg.items())
                hold(f"{impl} sharded {where}", loss.item(),
                     whole_grads(ps, g), refs[False])
    finally:
        set_hybrid_communicate_group(None)
    secs = time.time() - t0
    log(f"  phase 40 took {secs:.1f} s")
    return {"gaps": gaps, "seconds": secs}


# ---------------------------------------------------------------------------
# phases 41-44: the launched job (cell LA), elastic restarts on the card,
# expert parallelism (cell EP) and its fp32 parity
# ---------------------------------------------------------------------------

LAUNCH_TIMEOUT_S = 420
EP_DEGREES = {"dp": 2, "ep": 4}


def e_config(dtype, **kw):
    """E: phase 9's fp32 parity width (hidden 512, 8 / 4 heads, 4 layers)
    with the kernels and ``use_fused_norm``."""
    return train_config(dtype, hidden_size=512, intermediate_size=1376,
                        num_hidden_layers=4, num_attention_heads=8,
                        num_key_value_heads=4, use_fused_norm=True, **kw)


def run_launcher(body, tmp, nproc, *flags, env=None, timeout=None):
    """``python -m paddle_tpu_torch.distributed.launch --nproc_per_node
    nproc`` on a script holding ``body`` (after a line that imports this
    file), run from the checkout's root. Each line the launcher writes to
    stderr is stamped with the host clock as it arrives. Returns ``(rc,
    [(time, line)], seconds)``; the launcher's whole process group is
    killed when ``timeout`` passes (rc None then)."""
    import signal as _signal
    root = os.path.dirname(os.path.abspath(__file__))
    path = os.path.join(tmp, "train.py")
    with open(path, "w") as f:
        f.write("import chip_smoke as cs\n" + body)
    e = dict(os.environ, **(env or {}))
    e["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in [e.get("PYTHONPATH")] if p])
    cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
           "--nproc_per_node", str(nproc), "--log_dir",
           os.path.join(tmp, "log"), *flags, path]
    t0 = time.time()
    proc = subprocess.Popen(cmd, cwd=root, env=e, stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    lines = []

    def read():
        for line in proc.stderr:
            lines.append((time.time(), line.rstrip()))

    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    try:
        rc = proc.wait(timeout=timeout or LAUNCH_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, _signal.SIGKILL)
        proc.wait()
        rc = None
    reader.join(10)
    return rc, lines, time.time() - t0


def worker_logs(tmp, nproc):
    out = []
    for r in range(nproc):
        p = os.path.join(tmp, "log", f"workerlog.{r}")
        with open(p) as f:
            out.append(f.read()[-4000:])
    return out


def _stamp(out, name, value=None):
    with open(os.path.join(out, name), "w") as f:
        f.write(repr(time.time() if value is None else value))


def _read_stamp(out, name):
    with open(os.path.join(out, name)) as f:
        return float(f.read())


def _loss_grads(params, ids, cfg):
    """(detached loss, gradients in leaf order) of ``loss_fn`` on ``ids``
    (labels = ids)."""
    import torch
    from paddle_tpu_torch.models import llama as L
    leaves = L._leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    loss = L.loss_fn(params, ids, ids, cfg)
    grads = torch.autograd.grad(loss, leaves)
    for t in leaves:
        t.requires_grad_(False)
    return loss.detach(), list(grads)


def _launched_build():
    """(every library already built, the seconds ``build_all`` took): a
    launched child loads what the parent built."""
    from paddle_tpu_torch.kernels import build
    prebuilt = all(os.path.exists(build._target(n)) for n in build.SOURCES)
    return prebuilt, build.build_all()


def port_collectives(dev, r):
    """Every collective of the port run once across the two processes of
    a launched world on tensors on ``dev`` (each on gloo's own op):
    ``{op: right}``, each result held to its value on two ranks."""
    import torch
    from paddle_tpu_torch.distributed import collective as C

    def t(*v):
        return torch.tensor(v, device=dev)

    out = {}
    for op, want in ((C.ReduceOp.SUM, [3.0, 10.0]),
                     (C.ReduceOp.AVG, [1.5, 5.0]),
                     (C.ReduceOp.MAX, [2.0, 10.0]),
                     (C.ReduceOp.MIN, [1.0, 0.0]),
                     (C.ReduceOp.PROD, [2.0, 0.0])):
        x = t(r + 1.0, 10.0 * r)
        C.all_reduce(x, op=op)
        out[f"all_reduce_{op}"] = x.tolist() == want and x.device == dev
    x = t(r + 1.0)
    C.reduce(x)
    out["reduce"] = x.tolist() == [3.0]
    out["all_gather"] = C.all_gather(t(float(r), 5.0)).tolist() == \
        [0.0, 5.0, 1.0, 5.0]
    got = []
    C.all_gather(got, t(2.0 * r))
    out["all_gather_list"] = [g.tolist() for g in got] == [[0.0], [2.0]]
    b = t(r * 7.0, 1.0)
    C.broadcast(b, src=1)
    out["broadcast"] = b.tolist() == [7.0, 1.0]
    rs = C.reduce_scatter(torch.arange(4.0, device=dev) * (r + 1))
    out["reduce_scatter"] = rs.tolist() == [[0.0, 3.0], [6.0, 9.0]][r] \
        and rs.device == dev
    a2a = C.alltoall(torch.arange(4.0, device=dev) + 10 * r)
    out["alltoall"] = a2a.tolist() == [[0.0, 1.0, 10.0, 11.0],
                                       [2.0, 3.0, 12.0, 13.0]][r]
    sc = torch.empty(1, device=dev)
    C.scatter(sc, [t(10.0 * r + 1), t(10.0 * r + 2)], src=1)
    out["scatter"] = sc.tolist() == [11.0 + r]
    part = C.scatter(torch.arange(4.0, device=dev) + 100 * r, src=0)
    out["scatter_split"] = part.tolist() == [2.0 * r, 2.0 * r + 1]
    C.barrier()
    out["barrier"] = True
    return out


def _peak_gb(dev):
    import torch
    if torch.device(dev).type != "cuda":
        return None
    return torch.cuda.max_memory_allocated() / 2 ** 30


def _reset_peak(dev):
    import torch
    if torch.device(dev).type == "cuda":
        torch.cuda.reset_peak_memory_stats()


def launched_rank(out, dev="cuda:0", small=False):
    """One rank of phase 41's launched job (both ranks on ``cuda:0``,
    gloo): every collective of the port on CUDA tensors across
    the two processes, F's loss and gradient on this rank's half of a B 8
    x S 2048 batch averaged by ``all_reduce(..., op=AVG)`` as one flat
    buffer (timed), rank 0 holding it to the serial gradient of the whole
    batch; then the same at E's width in fp32. Writes ``rank<r>.json``
    into ``out``. ``dev="cpu"`` and ``small`` (tiny widths) rehearse it
    without a card."""
    import torch
    import torch.distributed as dist
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.models import llama as L
    dev = torch.device(dev)
    cuda = dev.type == "cuda"
    prebuilt, build_s = _launched_build() if cuda else (True, 0.0)
    C.init_parallel_env(timeout=180)
    r, n = C.get_rank(), C.get_world_size()
    res = {"rank": r, "world": n, "prebuilt": prebuilt, "build_s": build_s,
           "device": torch.cuda.get_device_name(0) if cuda else "cpu",
           "collectives": port_collectives(dev, r)}
    runs = (("F", train_config(torch.bfloat16, use_fused_norm=True), 8, 2048),
            ("E", e_config(torch.float32), 8, 512))
    if small:
        runs = tuple((tag, _small(c), b, 16) for tag, c, b, _ in runs)
    for tag, cfg, batch, seq in runs:
        params = L.init_params(cfg, seed=SEED + 41, device=dev)
        ids = torch.from_numpy(np.random.default_rng(SEED + 41).integers(
            0, cfg.vocab_size, (batch, seq))).to(dev)
        half = batch // n
        _reset_peak(dev)
        reset_counts()
        loss, grads = _loss_grads(params, ids[r * half:(r + 1) * half], cfg)
        _sync(dev)
        counts = {k: v for k, v in read_counts().items() if v}
        flat = torch.cat([t.reshape(-1) for t in grads]
                         + [loss.reshape(1).float()])
        del grads
        dist.barrier()
        _sync(dev)
        t0 = time.time()
        C.all_reduce(flat, op=C.ReduceOp.AVG)
        _sync(dev)
        ar_s = time.time() - t0
        rec = {"launches": counts, "launches_want": expected_launches(cfg),
               "local_loss": loss.item(), "loss": flat[-1].item(),
               "entries": flat.numel() - 1,
               "all_reduce_ms": ar_s * 1e3,
               "all_reduce_gb_per_s": flat.numel() * 4 / ar_s / 1e9,
               "peak_memory_gb": _peak_gb(dev)}
        if r == 0:
            reset_counts()
            ref, ref_g = _loss_grads(params, ids, cfg)
            rec["serial_launches"] = {k: v for k, v in read_counts().items()
                                      if v}
            rec["serial_loss"] = ref.item()
            gaps, off = [], 0
            for t in ref_g:
                k = t.numel()
                got = flat[off:off + k].reshape(t.shape)
                gaps.append(((got - t).abs().max()
                             / t.abs().max().clamp(min=1e-30)).item())
                off += k
            rec["grad_gap"] = max(gaps)
            del ref_g
        res[tag] = rec
        del params, flat
        if cuda:
            torch.cuda.empty_cache()
    dist.barrier()
    with open(os.path.join(out, f"rank{r}.json"), "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()


def _small(cfg):
    """``cfg`` at a CPU rehearsal's widths."""
    import dataclasses
    return dataclasses.replace(cfg, vocab_size=256, hidden_size=64,
                               intermediate_size=96, num_hidden_layers=2,
                               num_attention_heads=4, num_key_value_heads=2)


def launch_phase(tmp, dev="cuda:0", small=False):
    """Phase 41 (cell LA): ``python -m paddle_tpu_torch.distributed.launch
    --nproc_per_node 2`` on :func:`launched_rank`, both ranks on ``cuda:0``
    over gloo, after the parent frees its cached memory.

    Gates: rc 0; both ranks report world 2 and their rank; no kernel
    rebuilt in a child; every collective of the port
    (:func:`port_collectives`) right on CUDA tensors; each rank's flash,
    RMSNorm and RoPE launches equal ``expected_launches`` (rank 0's serial
    step's too);
    F's averaged bf16 loss within 5e-3 x |loss| of the serial loss on the
    whole batch; at E's width in fp32 the loss within 1e-5 and every
    gradient leaf within 1e-4 x max|g|. Prints the collectives checked, the
    all-reduce's ms and GB/s for F's 738 M-entry gradient and each rank's
    peak memory. Returns ``(metrics, launches summed over the ranks' F
    steps)``."""
    import torch
    t0 = time.time()
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    rc, lines, secs = run_launcher(
        f"cs.launched_rank({tmp!r}, {dev!r}, {small!r})\n", tmp, 2)
    check(rc == 0, f"launched job rc {rc}: {lines[-5:]} "
          f"{worker_logs(tmp, 2)}")
    res = []
    for r in range(2):
        with open(os.path.join(tmp, f"rank{r}.json")) as f:
            res.append(json.load(f))
    for r, x in enumerate(res):
        log(f"  rank {r}: {json.dumps(x)}")
        check((x["rank"], x["world"]) == (r, 2), f"rank {r}: {x['rank']}")
        check(x["prebuilt"] and x["build_s"] < 5,
              f"rank {r} rebuilt the kernels ({x['build_s']} s)")
        wrong = [op for op, ok in x["collectives"].items() if not ok]
        check(not wrong, f"rank {r}: collectives wrong on {dev}: {wrong}")
        for tag in ("F", "E"):
            check(x[tag]["launches"] == x[tag]["launches_want"],
                  f"rank {r} {tag}: launches {x[tag]['launches']}, expected "
                  f"{x[tag]['launches_want']}")
    f0, e0 = res[0]["F"], res[0]["E"]
    check(f0["serial_launches"] == f0["launches_want"],
          f"serial launches {f0['serial_launches']}")
    rel = abs(f0["loss"] - f0["serial_loss"]) / abs(f0["serial_loss"])
    check(rel <= 5e-3, f"F: launched loss {f0['loss']} vs serial "
          f"{f0['serial_loss']} (rel {rel})")
    e_gap = abs(e0["loss"] - e0["serial_loss"])
    check(e_gap <= 1e-5 and e0["grad_gap"] <= 1e-4,
          f"E fp32: loss gap {e_gap}, gradient gap {e0['grad_gap']}")
    m = {"seconds_launcher": secs, "F_loss_rel": rel,
         "F_grad_gap_bf16": f0["grad_gap"], "E_loss_gap": e_gap,
         "E_grad_gap": e0["grad_gap"],
         "all_reduce_ms": [x["F"]["all_reduce_ms"] for x in res],
         "all_reduce_gb_per_s": [x["F"]["all_reduce_gb_per_s"] for x in res],
         "entries": f0["entries"],
         "peak_memory_gb": [x["F"]["peak_memory_gb"] for x in res],
         "collectives": sorted(res[0]["collectives"])}
    m["seconds"] = time.time() - t0
    log(f"  {json.dumps(m)}")
    log(f"  phase 41 took {m['seconds']:.1f} s")
    counts = {k: sum(x["F"]["launches"].get(k, 0) for x in res)
              for k in read_counts()}
    return m, counts


ELASTIC_STEPS = 8


def _elastic_batch(step, cfg, rows=4, seq=512):
    import torch
    return torch.from_numpy(np.random.default_rng(SEED + 4200 + step)
                            .integers(0, cfg.vocab_size, (rows, seq)))


def elastic_rank(out, dev="cuda:0", small=False):
    """One rank of phase 42's elastic job: E's width at fp32 (the
    kernels), data parallel over the launched world (each rank's half of
    a B 4 x S 512 batch a step, gradients averaged by ``all_reduce`` over
    gloo, AdamW at lr 1e-3), ``ELASTIC_STEPS`` steps, every rank saving
    ``{"params", "opt"}`` through ``AsyncCheckpointer`` after steps 2, 4
    and 6 (a
    commit covers both ranks' files; a restore walks back past one whose
    other rank's files are torn), the heartbeat started by
    ``init_parallel_env``. With ``CHAOS_FAULT=chaos``:
    in round 0 rank 1 SIGKILLs itself at step 5 once a commit exists; in
    round 1 rank 0 stalls its heartbeat at step 6 and sleeps. Stamps the
    host clock at each event into ``out``; rank 0 writes the final loss
    (a fixed batch, no update). ``dev="cpu"`` and ``small`` rehearse it
    without a card."""
    import torch
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.distributed.checkpoint import (AsyncCheckpointer,
                                                         manifest)
    from paddle_tpu_torch.models import llama as L
    from paddle_tpu_torch.testing import chaos
    dev = torch.device(dev)
    prebuilt, build_s = (_launched_build() if dev.type == "cuda"
                         else (True, 0.0))
    rnd = int(os.environ["PADDLE_RESTART_ROUND"])
    fault = os.environ.get("CHAOS_FAULT", "")
    C.init_parallel_env(timeout=180)
    r, n = C.get_rank(), C.get_world_size()
    _stamp(out, f"start.{rnd}.{r}")
    if not prebuilt or build_s > 5:
        raise RuntimeError(f"rank {r} rebuilt the kernels ({build_s} s)")
    cfg = e_config(torch.float32)
    seq = 512
    if small:
        cfg, seq = _small(cfg), 16
    params = L.init_params(cfg, seed=SEED + 42, device=dev)
    opt = L._adamw_init(params)
    ck = AsyncCheckpointer(keep_last_k=2)
    start = ck.restore({"params": params, "opt": opt}) or 0
    _stamp(out, f"resumed.{rnd}.{r}", start)
    _stamp(out, f"resumed_at.{rnd}.{r}")
    names = [k for k, _ in L._named(params)]
    for step in range(start, ELASTIC_STEPS):
        ids = _elastic_batch(step, cfg, seq=seq).to(dev)
        half = ids.shape[0] // n
        loss, grads = _loss_grads(params, ids[r * half:(r + 1) * half], cfg)
        flat = torch.cat([t.reshape(-1) for t in grads])
        C.all_reduce(flat, op=C.ReduceOp.AVG)
        avg, off = {}, 0
        for k, t in zip(names, grads):
            avg[k] = flat[off:off + t.numel()].reshape(t.shape)
            off += t.numel()
        it = iter(avg[k] for k in names)
        with torch.no_grad():
            params, opt = L._adamw_apply(
                params, L._tree_map(lambda _: next(it), params), opt,
                lr=1e-3, beta1=0.9, beta2=0.95, eps=1e-8, weight_decay=0.0,
                opt_dtype=torch.float32)
        if (step + 1) % 2 == 0 and step + 1 < ELASTIC_STEPS:
            ck.save({"params": params, "opt": opt}, step + 1)
        if fault == "chaos" and rnd == 0 and r == 1 and step == 4:
            while manifest.latest_committed(ck.root) is None:
                time.sleep(0.05)
            _stamp(out, "kill_at")
            chaos.kill_self()
        if fault == "chaos" and rnd == 1 and r == 0 and step == 6:
            ck.wait()
            _stamp(out, "stall_at")
            stall = chaos.stall_heartbeat()
            stall.__enter__()
            time.sleep(120)                       # alive but hung
    ck.wait()
    if r == 0:
        with torch.no_grad():
            ids = _elastic_batch(99, cfg, seq=seq).to(dev)
            final = L.loss_fn(params, ids, ids, cfg).item()
        _stamp(out, f"final.{fault or 'clean'}", final)


def elastic_phase(tmp, dev="cuda:0", small=False):
    """Phase 42: :func:`elastic_rank` launched at 2 ranks on ``cuda:0``,
    first unfaulted, then with ``CHAOS_FAULT=chaos`` at ``--max_restart 2
    --elastic_timeout 5`` (heartbeats every 0.5 s): the SIGKILLed rank
    ends round 0, the stalled heartbeat ends round 1 as hung (the
    launcher's ``HUNG_RC``), round 2 resumes and finishes.

    Gates: both jobs rc 0; round 1 resumes from a commit >= 2 and round 2
    from a commit >= round 1's; the launcher reports the crash and the
    hung rank; the final loss within 1e-5 x |loss| of the unfaulted
    run's. Prints the detection latency of each fault (the launcher's
    line against the child's stamp; the stall against the timeout), each
    restart's wall time (from that line to the next round's ranks
    started and resumed) and each job's seconds."""
    from paddle_tpu_torch.distributed.launch.main import HUNG_RC
    t0 = time.time()
    env = {"PADDLE_HEARTBEAT_INTERVAL": "0.5"}
    runs = {}
    for fault, flags in (("", ()), ("chaos", ("--max_restart", "2",
                                              "--elastic_timeout", "5"))):
        d = os.path.join(tmp, fault or "clean")
        os.makedirs(d)
        rc, lines, secs = run_launcher(
            f"cs.elastic_rank({d!r}, {dev!r}, {small!r})\n", d, 2,
            "--ckpt_dir",
            os.path.join(d, "ckpt"), *flags,
            env=dict(env, CHAOS_FAULT=fault))
        check(rc == 0, f"elastic job {fault or 'clean'} rc {rc}: "
              f"{lines[-6:]} {worker_logs(d, 2)}")
        runs[fault or "clean"] = (d, lines, secs)
    clean = _read_stamp(runs["clean"][0], "final.clean")
    d, lines, secs = runs["chaos"]
    final = _read_stamp(d, "final.chaos")

    def first(word):
        hit = [t for t, line in lines if word in line]
        check(hit, f"the launcher never printed {word!r}: {lines}")
        return hit[0]

    crash_t, hung_t = first("exited nonzero"), first("missed heartbeats")
    check(any(f"the last round's rc {HUNG_RC}" in line for _, line in lines),
          f"no round ended with HUNG_RC: {lines}")
    resumed = [_read_stamp(d, f"resumed.{k}.0") for k in (1, 2)]
    check(resumed[0] >= 2 and resumed[1] >= resumed[0],
          f"resumed from {resumed}")
    m = {"clean_final_loss": clean, "chaos_final_loss": final,
         "final_rel": abs(final - clean) / abs(clean),
         "resumed_from": resumed,
         "kill_detect_s": crash_t - _read_stamp(d, "kill_at"),
         "stall_detect_s": hung_t - _read_stamp(d, "stall_at"),
         "elastic_timeout_s": 5.0,
         "restart_s": {
             "after_kill_started": _read_stamp(d, "start.1.0") - crash_t,
             "after_kill_resumed": _read_stamp(d, "resumed_at.1.0")
             - crash_t,
             "after_stall_started": _read_stamp(d, "start.2.0") - hung_t,
             "after_stall_resumed": _read_stamp(d, "resumed_at.2.0")
             - hung_t},
         "job_seconds": {k: v[2] for k, v in runs.items()},
         "launcher_lines": [line for _, line in lines]}
    check(m["final_rel"] <= 1e-5, f"resumed final loss {final} vs clean "
          f"{clean}")
    m["seconds"] = time.time() - t0
    log(f"  {json.dumps(m)}")
    log(f"  phase 42 took {m['seconds']:.1f} s")
    return m


def ep_config(dtype, **kw):
    """L: the MoE model (phase 4's widths with 8 experts, top-2, capacity
    factor 1.25), cut to 2 layers, with ``ep_axis="ep"``."""
    base = dict(num_hidden_layers=2, moe_num_experts=8, moe_top_k=2,
                ep_axis="ep", use_fused_norm=True)
    base.update(kw)
    return train_config(dtype, **base)


def ep_phase(dev="cuda", cfg=None, batch=8, seq=2048, steps=3):
    """Phase 43 (cell EP): L's step (``use_kernels``, ``use_fused_norm``,
    full remat, bf16 compute, fp32 params and AdamW at lr 1e-4) at dp 2 x
    ep 4 over ``[dev] * 8``, the batch B 8 x S 2048 over dp, beside the
    serial step from the same weights and ``steps`` seeded batches.

    The bytes are reckoned from the specs before the layout is made: the
    state (params + m + v + gradients) of the 8 entries and of the serial
    step. Gates: each expert leaf at 1/4 of its bytes on an entry and
    params + m + v at an entry equal to the specs'; the router's kept
    counts on the first batch equal the serial router's; the losses
    within 5e-3 x |loss| of the serial step's; dp replicas of every leaf
    and moment bit-equal after every step; exactly ``sharded_launches``
    a step (the serial counts x 2 pieces). Prints step ms and tokens/s of
    both, the peak memory of each and a profiled sharded step."""
    import torch
    from paddle_tpu_torch.distributed.sharding import shard_to_mesh
    from paddle_tpu_torch.distributed.topology import build_mesh
    from paddle_tpu_torch.models import llama as L
    t0 = time.time()
    cfg = cfg or ep_config(torch.bfloat16)
    mesh = build_mesh(EP_DEGREES, [dev] * 8)
    rng = np.random.default_rng(SEED + 43)
    data = [torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                          (batch, seq))).to(dev)
            for _ in range(steps)]
    init_opt, step = L.make_train_step(cfg, lr=1e-4)
    params = L.init_params(cfg, seed=SEED + 43, device=dev)
    specs = L.param_specs(cfg, mp_axis=None)
    want, whole = entry_bytes(params, mesh, specs)
    serial_bytes = 4 * sum(t.numel() * t.element_size()
                           for t in _state_leaves(params))
    log(f"  reckoned: params + m + v + gradients {want * 4 // 3} bytes an "
        f"entry, {mesh.size} entries {want * 4 // 3 * mesh.size / 1e9:.2f} "
        f"GB; the serial step {serial_bytes / 1e9:.2f} GB")
    _sync(dev)
    kept_serial = L.moe_kept(params, data[0], cfg)
    ps = L.shard_params(params, mesh, cfg, mp_axis=None)
    opt_s = init_opt(ps)
    c0 = (0,) * len(mesh.axis_names)
    held = L.placement_bytes(ps, c0) + L.placement_bytes(opt_s, c0)
    quarter = {k: ps["layers"][k].nbytes_at(c0) * 4
               == params["layers"][k].numel() * 4
               for k in ("w_gate", "w_up", "w_down")}
    kept = L.moe_kept(ps, shard_to_mesh(data[0], mesh, L.batch_spec(),
                                        "input_ids"), cfg)
    log(f"  placement entry holds {held} bytes of params + m + v (specs "
        f"give {want}); expert leaves at 1/4 an entry: {quarter}; kept "
        f"(token, choice) pairs a layer {kept}, serial {kept_serial} of "
        f"{batch * seq * cfg.moe_top_k}")
    check(held == want and all(quarter.values()),
          f"entry bytes {held} (specs {want}), quarters {quarter}")
    check(kept == kept_serial, f"kept {kept} vs serial {kept_serial}")

    opt = init_opt(params)
    torch.cuda.reset_peak_memory_stats()

    def serial_step(i):
        nonlocal params, opt
        params, opt, loss = step(params, opt, data[i], data[i])
        return loss.item()

    ser, ser_t = timed_steps(serial_step, steps, dev)
    serial_peak = torch.cuda.max_memory_allocated()
    del params, opt
    torch.cuda.empty_cache()
    batches = [shard_to_mesh(d, mesh, L.batch_spec(), "input_ids")
               for d in data]
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    eq = []

    def sharded_step(i):
        nonlocal ps, opt_s
        ps, opt_s, loss = step(ps, opt_s, batches[i], batches[i])
        return loss.item()

    sh, sh_t = timed_steps(sharded_step, steps, dev, lambda: eq.append(
        replicas_equal(ps) and replicas_equal(opt_s["m"])
        and replicas_equal(opt_s["v"])))
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    per_step = {k: v / steps for k, v in counts.items() if v}
    wants = sharded_launches(cfg, EP_DEGREES["dp"], 1)
    rel = [abs(a - b) / abs(b) for a, b in zip(sh, ser)]
    m = {"serial_losses": ser, "ep_losses": sh, "loss_rel": rel,
         "kept": kept, "serial_step_ms": float(np.median(ser_t[1:])) * 1e3,
         "ep_step_ms": float(np.median(sh_t[1:])) * 1e3,
         "serial_step_ms_each": [t * 1e3 for t in ser_t],
         "ep_step_ms_each": [t * 1e3 for t in sh_t],
         "serial_peak_gb": serial_peak / 2 ** 30, "ep_peak_gb": peak / 2 ** 30,
         "placement_entry_bytes": held, "launches_per_step": per_step}
    m["serial_tokens_per_s"] = batch * seq / m["serial_step_ms"] * 1e3
    m["ep_tokens_per_s"] = batch * seq / m["ep_step_ms"] * 1e3
    log(f"  {json.dumps(m)}")
    check(all(np.isfinite(sh)), f"non-finite ep loss {sh}")
    check(max(rel) <= 5e-3, f"ep losses {sh} vs serial {ser}: rel {rel}")
    check(all(eq), f"dp replicas bit-equal after each step: {eq}")
    check(per_step == wants, f"launches per step {per_step}, expected "
          f"{wants}")
    m["profile"] = profile_device(
        lambda: step(ps, opt_s, batches[0], batches[0]),
        "expert-parallel training step", top=10)
    m["seconds"] = time.time() - t0
    log(f"  phase 43 took {m['seconds']:.1f} s")
    del ps, opt_s, batches
    torch.cuda.empty_cache()
    return m, counts


def pp_moe_oracle(params, ids, cfg, micro, dp):
    """The serial micro-batched loss of a pipelined MoE step: every
    micro-batch's rows of each dp rank routed alone (as the pp step
    routes them), the summed CE over the tokens plus ``moe_aux_weight`` x
    the mean of the pieces' aux (``tests/test_llama.py:393``'s oracle,
    with dp)."""
    import torch
    from paddle_tpu_torch.models import llama as L
    B = ids.shape[0]
    tot, cnt, auxes = 0.0, 0, []
    for m_ in ids.reshape(micro, B // micro, -1).unbind(0):
        for piece in m_.chunk(dp, dim=0):
            logits, aux = L.forward(params, piece, cfg, return_aux=True)
            logits = logits.float()
            lse = torch.logsumexp(logits, -1)
            tgt = logits.gather(-1, piece.long()[..., None])[..., 0]
            tot = tot + (lse - tgt).sum()
            cnt += piece.numel()
            auxes.append(aux)
    return tot / cnt + cfg.moe_aux_weight * torch.stack(auxes).mean()


def ep_parity_phase(dev="cuda", cfg=None, batch=8, seq=512):
    """Phase 44: E's width at fp32 with the kernels and 8 experts, top-2,
    against the serial loss and gradients (the loss within 1e-5, every
    gradient leaf within 1e-4 x its max|g|): dp 2 x ep 4 through
    ``shard_params`` (the router over the global batch: the serial
    ``loss_fn``); pp 2 x ep 2 (2 micro-batches) and dp 2 x pp 2 x ep 2 at
    V 2 (4 micro-batches) through the pipelined loss, against
    :func:`pp_moe_oracle`."""
    import torch
    from paddle_tpu_torch.distributed.sharding import (shard_to_mesh,
                                                       shard_tree)
    from paddle_tpu_torch.distributed.topology import build_mesh
    from paddle_tpu_torch.models import llama as L
    t0 = time.time()
    cfg = cfg or e_config(torch.float32, moe_num_experts=8, moe_top_k=2,
                          ep_axis="ep")
    ids = torch.from_numpy(np.random.default_rng(SEED + 44).integers(
        0, cfg.vocab_size, (batch, seq))).to(dev)

    def serial(loss_of):
        params = L.init_params(cfg, seed=SEED + 44, device=dev)
        leaves = L._leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        loss = loss_of(params)
        return loss.item(), dict(zip([n for n, _ in L._named(params)],
                                     torch.autograd.grad(loss, leaves)))

    gaps = {}

    def hold(name, loss, grads, ref):
        gaps[name] = (abs(loss - ref[0]), grad_gap(grads, ref[1]))
        log(f"  {name}: loss gap {gaps[name][0]:.3g}, worst gradient leaf "
            f"max|diff|/max|g| {gaps[name][1]:.3g}")
        check(gaps[name][0] <= 1e-5 and gaps[name][1] <= 1e-4,
              f"fp32 {name}: {gaps[name]}")

    mesh = build_mesh(EP_DEGREES, [dev] * 8)
    ps = L.shard_params(L.init_params(cfg, seed=SEED + 44, device=dev), mesh,
                        cfg, mp_axis=None)
    b = shard_to_mesh(ids, mesh, L.batch_spec(), "input_ids")
    loss, g = L._sharded_grads(ps, b, b, cfg)
    hold("dp 2 x ep 4", loss.item(), whole_grads(ps, g),
         serial(lambda p: L.loss_fn(p, ids, ids, cfg)))
    del ps, g
    for deg, V, micro in (({"pp": 2, "ep": 2}, 1, 2),
                          ({"dp": 2, "pp": 2, "ep": 2}, 2, 4)):
        n = int(np.prod(list(deg.values())))
        mesh = build_mesh(deg, [dev] * n)
        dp = deg.get("dp", 1)
        base = L.init_params(cfg, seed=SEED + 44, device=dev)
        ppp = shard_tree(L.to_pp_layout(base, deg["pp"], V), mesh,
                         L.pp_param_specs(cfg, "pp", "ep"))
        rings = L._pp_rings(mesh)
        loss, g = L._replica_grads(ppp, lambda: L._pp_loss(
            ppp, ids, ids, cfg, rings, micro, V), None)
        ref = serial(lambda p: pp_moe_oracle(p, ids, cfg, micro, dp))
        g = {k: t.reshape(ref[1][k].shape)
             for k, t in whole_grads(ppp, g).items()}
        hold(" x ".join(f"{a} {k}" for a, k in deg.items()) + f" V {V}",
             loss.item(), g, ref)
    secs = time.time() - t0
    log(f"  phase 44 took {secs:.1f} s")
    return {"gaps": gaps, "seconds": secs}


# ---------------------------------------------------------------------------
# phase 45: the eager API on the card
# ---------------------------------------------------------------------------

def eager_step_phase(m11, batch=8, seq=2048, steps=2):
    """Phase 45 (a): ``LlamaForCausalLM`` at F's configuration on the
    port's ``init_params`` seed 0 (registered by sorted name), AdamW(1e-4):
    a warm-up step, then ``steps`` timed steps with the counters set to 0
    just before them. Returns (metrics, launches, net)."""
    import torch
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.models.llama import (LlamaForCausalLM,
                                               _sorted_leaves, loss_fn)
    paddle.set_device("gpu:0")
    cfg = train_config(torch.bfloat16, use_fused_norm=True)
    net = LlamaForCausalLM(cfg, seed=SEED)
    params = net.params_pytree()
    check([n for n, _ in net.named_parameters()] ==
          [f"p{i}" for i in range(len(_sorted_leaves(params)))],
          "the eager parameters are not named p0 ... pN")
    ids = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (batch, seq))).cuda()
    with torch.no_grad():
        ref = loss_fn(params, ids, ids, cfg).item()
    x = paddle.to_tensor(ids)
    opt = paddle.optimizer.AdamW(1e-4, parameters=net.parameters())

    def step():
        loss = net(x, x)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss.item()

    losses = [step()]                                   # the warm-up
    first_rel = abs(losses[0] - ref) / abs(ref)
    check(first_rel <= 5e-3, f"eager first loss {losses[0]} vs functional "
          f"{ref} (rel {first_rel})")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    times = []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.time()
        losses.append(step())
        times.append(time.time() - t0)
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    per_step = {k: v / steps for k, v in counts.items() if v}
    step_ms = float(np.median(times)) * 1e3
    m = {"step_ms": step_ms, "step_ms_each": [t * 1e3 for t in times],
         "phase11_step_ms": m11["step_ms"],
         "tokens_per_s": batch * seq / step_ms * 1e3,
         "max_memory_allocated_gb": peak / 2 ** 30, "losses": losses,
         "functional_first_loss": ref, "first_loss_rel": first_rel,
         "launches_per_step": per_step}
    log(f"  (a) {json.dumps(m)}")
    check(all(np.isfinite(losses)), f"non-finite eager loss {losses}")
    check(losses[-1] < losses[0], f"eager loss did not fall: {losses}")
    want = expected_launches(cfg)
    check(per_step == want, f"eager launches per step {per_step}, "
          f"expected {want}")
    m["profile"] = profile_device(step, "eager training step", top=10)
    return m, counts, net


def eager_parity_phase():
    """Phase 45 (b): E's width at fp32 with the kernels; the weights of
    ``init_params`` loaded by name into a net built from another seed."""
    import torch
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.models.llama import (LlamaForCausalLM,
                                               _sorted_leaves, _unflatten,
                                               init_params, loss_fn)
    cfg = train_config(torch.float32, hidden_size=512, intermediate_size=1376,
                       num_hidden_layers=4, num_attention_heads=8,
                       num_key_value_heads=4, use_fused_norm=True)
    ids = torch.from_numpy(np.random.default_rng(1).integers(
        0, 32000, (2, 512))).cuda()
    flat = _sorted_leaves(init_params(cfg, seed=SEED + 2, device="cuda"))
    leaves = [t.clone().requires_grad_(True) for _, t in flat]
    reset_counts()
    ref = loss_fn(_unflatten([p for p, _ in flat], leaves), ids, ids, cfg)
    ref_grads = torch.autograd.grad(ref, leaves)
    net = LlamaForCausalLM(cfg, seed=SEED + 99)
    missing, unexpected = net.set_state_dict(
        {f"p{i}": t for i, (_, t) in enumerate(flat)})
    check(not missing and not unexpected, f"set_state_dict missing "
          f"{missing}, unexpected {unexpected}")
    check(all(torch.equal(p._value, t) for p, (_, t)
              in zip(net.parameters(), flat)), "weights not loaded by name")
    x = paddle.to_tensor(ids)
    loss = net(x, x)
    loss.backward()
    launches = read_counts()
    rel = abs(loss.item() - ref.item()) / abs(ref.item())
    worst = max(((p.grad._value - g).abs().max() / g.abs().max()).item()
                for p, g in zip(net.parameters(), ref_grads))
    # one AdamW step against optimizer.py:255-318 written out
    lr, wd, b1, b2, eps = 1e-3, 0.01, 0.9, 0.999, 1e-8
    want = []
    for p in net.parameters():
        w, g = p._value.detach(), p.grad._value
        v = w * (1.0 - lr * wd)
        mhat = ((1 - b1) * g) / (1 - b1)
        vhat = ((1 - b2) * torch.square(g)) / (1 - b2)
        want.append(v - lr * mhat / (torch.sqrt(vhat) + eps))
    paddle.optimizer.AdamW(lr, parameters=net.parameters(),
                           weight_decay=wd).step()
    adam_gap = max(((p._value - w).abs().max() / w.abs().max()).item()
                   for p, w in zip(net.parameters(), want))
    m = {"loss": loss.item(), "functional_loss": ref.item(), "loss_rel": rel,
         "grad_worst": worst, "adamw_gap": adam_gap,
         "launches": {k: v for k, v in launches.items() if v}}
    log(f"  (b) {json.dumps(m)}")
    check(rel <= 1e-5, f"fp32 eager loss rel {rel}")
    check(worst <= 1e-4, f"fp32 eager gradient {worst} x max|g|")
    check(adam_gap <= 1e-6, f"eager AdamW step {adam_gap} x max|p| from "
          f"the reference formula")
    check(launches["flash_attention_bwd_dkv"] > 0
          and launches["rms_norm_bwd"] > 0 and launches["apply_rope_bwd"] > 0,
          f"the fp32 eager step missed a kernel: {launches}")
    return m


def eager_generate_phase(net):
    """Phase 45 (c): greedy ``net.generate`` at full width against the
    functional ``generate`` on the same params."""
    import torch
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.models import generation as G
    cfg, params = net.config, net.params_pytree()
    ids = np.random.default_rng(2).integers(0, cfg.vocab_size,
                                            (2, 32)).astype(np.int32)
    got = net.generate(paddle.to_tensor(ids), max_new_tokens=4)
    with torch.no_grad():
        want = G.generate(params, ids, cfg, max_new_tokens=4)
    log(f"  (c) eager generate {got.numpy().tolist()}, functional "
        f"{want.cpu().numpy().tolist()}")
    check(torch.equal(got._value.cpu(), want.cpu()),
          "eager generate differs from the functional stream")


def _delta(before, after):
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


def eager_callers_phase():
    """Phase 45 (d): each eager caller on the card takes its kernel (the
    counts rise) and matches its plain path. Returns the callers' launches
    (the plain references launch nothing)."""
    import importlib
    import torch
    import paddle_tpu_torch as paddle
    import paddle_tpu_torch.incubate.nn.functional as IF
    import paddle_tpu_torch.nn.functional as F
    from paddle_tpu_torch.kernels.rms_norm import (rms_norm_bwd_plain,
                                                   rms_norm_fwd_plain)
    from paddle_tpu_torch.kernels.quant_matmul import (
        quantize_weights, weight_only_matmul_plain)
    from paddle_tpu_torch.kernels.rope import apply_rope_plain, rope_cos_sin
    g = torch.Generator(device="cuda").manual_seed(SEED + 45)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    reset_counts()
    out = {}
    # scaled_dot_product_attention: the flash route, then a boolean mask.
    # The plain references are phase 7's: the plain forward, and the plain
    # backward fed the call's own bf16 out (delta = rowsum(dO * O) moves
    # with that rounding in short causal rows) and the plain lse
    FA = importlib.import_module("paddle_tpu_torch.kernels.flash_attention")
    B, S, H, D = 2, 2048, 16, 128
    q, k, v, dout = (randn(B, S, H, D) for _ in range(4))
    scale = 1.0 / D ** 0.5
    ref, ref_lse = FA.flash_attention_fwd_plain(q, k, v, None, None, scale,
                                                True)
    mask = torch.ones((S, S), dtype=torch.bool, device="cuda").tril()
    # the masked call runs the plain formula in bf16 (autograd through its
    # bf16 einsums): its gradients' worst row is held to MASK_ROW, which a
    # mask one diagonal off (the control, "shifted") must exceed. On an
    # H100 80GB HBM3 at 700 W: dq's worst row 5.4e-2 under the right mask,
    # the gradients' 1.7-2.8 under the shifted one
    MASK_ROW = 0.15
    for name, m in (("flash", None), ("mask", mask[None, None]),
                    ("shifted", torch.ones_like(mask).tril(1)[None, None])):
        before = read_counts()
        ts = [paddle.to_tensor(t, stop_gradient=False) for t in (q, k, v)]
        o = F.scaled_dot_product_attention(
            *ts, attn_mask=None if m is None else paddle.to_tensor(m),
            is_causal=m is None)
        o.backward(paddle.to_tensor(dout))
        torch.cuda.synchronize()
        d = _delta(before, read_counts())
        ref_grads = FA.flash_attention_bwd_plain(
            q, k, v, None, None, o._value.detach(), ref_lse, dout, scale,
            True)
        got = [o._value] + [t.grad._value for t in ts]
        errs = [rel_errors(a, b) for a, b in zip(got, [ref, *ref_grads])]
        out[f"sdpa_{name}"] = {"launches": d, "fro_row": errs}
        log(f"  (d) sdpa {name}: launches {d}, (rel, worst row) of out / "
            f"dq / dk / dv {errs}")
        want = ({"flash_attention": 1, "flash_attention_bwd_dq": 1,
                 "flash_attention_bwd_dkv": 1} if m is None else {})
        check(d == want, f"sdpa {name}: launches {d}, expected {want}")
        if name == "shifted":
            check(all(row > MASK_ROW for _, row in errs[1:]),
                  f"a mask one diagonal off passes the masked gate: {errs}")
            continue
        for (fro, row), part in zip(errs, ("out", "dq", "dk", "dv")):
            row_lim = BF16_ROW if m is None or part == "out" else MASK_ROW
            check(fro <= BF16_FRO and row <= row_lim,
                  f"sdpa {name} {part}: rel {fro:.3g}, worst row {row:.3g}")
    del q, k, v, dout, ref, ref_lse, ref_grads
    # RMSNorm's three callers on 8 x 2048 rows of 2048
    x = randn(8 * 2048, 2048)
    w = (1.0 + 0.1 * randn(2048, dtype=torch.float32))
    gout = randn(8 * 2048, 2048)
    ref_out, rstd = rms_norm_fwd_plain(x, w, 1e-6)
    ref_dx, ref_dw = rms_norm_bwd_plain(x, w, rstd, gout)
    layer = paddle.nn.RMSNorm(2048, epsilon=1e-6)
    layer.weight.set_value(w)
    callers = {"F.rms_norm": lambda a, b: F.rms_norm(a, b, 1e-6),
               "nn.RMSNorm": lambda a, b: layer(a),
               "fused_rms_norm": lambda a, b: IF.fused_rms_norm(a, b, None,
                                                                1e-6)}
    for name, fn in callers.items():
        before = read_counts()
        xt = paddle.to_tensor(x, stop_gradient=False)
        wt = layer.weight if name == "nn.RMSNorm" else \
            paddle.to_tensor(w, stop_gradient=False)
        o = fn(xt, wt)
        o.backward(paddle.to_tensor(gout))
        torch.cuda.synchronize()
        d = _delta(before, read_counts())
        out[name] = {"launches": d, "max_abs_err": [
            hold(f"{name} out", o._value, ref_out, 1e-5),
            hold(f"{name} dx", xt.grad._value, ref_dx, 1e-5),
            hold(f"{name} dw", wt.grad._value, ref_dw, 1e-4)]}
        check(d == {"rms_norm": 1, "rms_norm_bwd": 1},
              f"{name}: launches {d}")
    del x, gout, ref_out, rstd, ref_dx, ref_dw
    # fused RoPE on q and k [8, 2048, 16, 128]
    q, k, gq, gk = (randn(8, 2048, 16, 128) for _ in range(4))
    cos, sin = rope_cos_sin(2048, 128, 10000.0, device="cuda")
    before = read_counts()
    qt, kt = (paddle.to_tensor(t, stop_gradient=False) for t in (q, k))
    oq, ok, _ = IF.fused_rotary_position_embedding(qt, kt)
    dq, dk = paddle.grad([oq, ok], [qt, kt],
                         [paddle.to_tensor(gq), paddle.to_tensor(gk)])
    torch.cuda.synchronize()
    d = _delta(before, read_counts())
    out["fused_rope"] = {"launches": d, "max_abs_err": [
        hold("rope q", oq._value, apply_rope_plain(q, cos, sin), 1e-5),
        hold("rope k", ok._value, apply_rope_plain(k, cos, sin), 1e-5),
        hold("rope dq", dq._value, apply_rope_plain(gq, cos, -sin), 1e-5),
        hold("rope dk", dk._value, apply_rope_plain(gk, cos, -sin), 1e-5)]}
    check(d == {"apply_rope": 2, "apply_rope_bwd": 2},
          f"fused_rope: launches {d}")
    del q, k, gq, gk, oq, ok, dq, dk
    # weight_only_linear at the serving step's M and the prefill's
    wq, sc = quantize_weights(randn(2048, 5504, dtype=torch.float32))
    for M in (8, 2048):
        x, dout = randn(M, 2048), randn(M, 5504)
        before = read_counts()
        xt = paddle.to_tensor(x, stop_gradient=False)
        o = paddle.weight_only_linear(xt, paddle.to_tensor(wq),
                                      paddle.to_tensor(sc))
        o.backward(paddle.to_tensor(dout))
        torch.cuda.synchronize()
        d = _delta(before, read_counts())
        xr = x.clone().requires_grad_(True)
        ref = weight_only_matmul_plain(xr, wq, sc, torch.bfloat16)
        (gx,) = torch.autograd.grad(ref, (xr,), dout)
        errs = [((a.float() - b.float()).abs().max()
                 / b.float().abs().max()).item()
                for a, b in ((o._value, ref), (xt.grad._value, gx))]
        out[f"weight_only_linear M={M}"] = {"launches": d,
                                            "rel_max_err": errs}
        check(d == {"weight_only_matmul": 1},
              f"weight_only_linear M={M}: launches {d}")
        check(max(errs) <= 1e-2, f"weight_only_linear M={M}: out / dx "
              f"{errs} x max|ref|")
    launches = read_counts()
    log(f"  (d) {json.dumps(out)}")
    log(f"  (d) launches: {json.dumps(launches)}")
    return out, launches


def eager_phase(m11):
    """Phase 45: the eager API on the card, (a)-(d). Returns (a)'s metrics,
    the launches of (a)'s timed steps and of (d)'s callers."""
    import torch
    m, c_steps, net = eager_step_phase(m11)
    eager_generate_phase(net)
    del net
    torch.cuda.empty_cache()
    eager_parity_phase()
    torch.cuda.empty_cache()
    _, c_callers = eager_callers_phase()
    torch.cuda.empty_cache()
    return m, c_steps, c_callers


# ---------------------------------------------------------------------------
# phase 46: the eager hybrid-parallel API
# ---------------------------------------------------------------------------

_MEGATRON_NAMES = {"wq": "wq.weight", "wk": "wk.weight",
                   "wv": "wv.weight", "wo": "wo.weight",
                   "w_gate": "w_gate.weight", "w_up": "w_up.weight",
                   "w_down": "w_down.weight", "ln_attn": "ln_attn",
                   "ln_mlp": "ln_mlp"}
_MEGATRON_CACHE = {}


def megatron():
    """Phase 46's Megatron-style LLaMA decoder, the standard hybrid-parallel
    script's model, written with the port's public eager API only: a
    ``VocabParallelEmbedding``; per layer ``fused_rms_norm`` ->
    ``ColumnParallelLinear`` q / k / v (``gather_output=False``) ->
    ``fused_rotary_position_embedding`` -> ``F.scaled_dot_product_attention``
    (causal) -> ``RowParallelLinear`` o, then the SwiGLU FFN with the gate
    and up projections column-parallel and the down projection
    row-parallel; the final norm, a column-parallel ``lm_head`` and
    ``ParallelCrossEntropy``; each layer under ``recompute`` while
    training. It computes ``llama.forward`` / ``loss_fn``'s function for a
    dense, untied config, so a functional tree loads into it by name
    (``state_dict``) and the two give the same loss.

    Under mp > 1 the attention core (RoPE and the attention) runs in a
    per-coordinate region over the mp group, its inputs cut on the head
    dim: each mp coordinate rotates and attends over its own heads, so
    the flash kernels launch once a shard. ``parallel=False`` builds the
    same decoder from ``nn.Embedding``, ``nn.Linear`` and
    ``nn.CrossEntropyLoss`` (the serial oracle).

    Returns a namespace (``Llama``, ``DecoderLayer``, ``Embedding``,
    ``Head``, ``token_mean_ce``, ``attention_core``, ``state_dict``),
    built on the first call so that importing this script needs only
    numpy."""
    if "ns" in _MEGATRON_CACHE:
        return _MEGATRON_CACHE["ns"]
    import types
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.distributed.dist_tensor import (PartitionSpec,
                                                          anchor, shard_map)
    from paddle_tpu_torch.distributed.fleet.layers.mpu import (
        ColumnParallelLinear, ParallelCrossEntropy, RowParallelLinear,
        VocabParallelEmbedding)
    from paddle_tpu_torch.distributed.fleet.recompute import recompute
    from paddle_tpu_torch.distributed.topology import (
        Mesh, get_hybrid_communicate_group)
    from paddle_tpu_torch.incubate.nn import functional as IF
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.nn import initializer as I

    heads = PartitionSpec(None, None, "mp", None)

    def mp_group_mesh():
        """The mp group eager code runs at, as a one-axis mesh (None at
        mp 1)."""
        mesh = get_hybrid_communicate_group().mesh
        if int(mesh.shape.get("mp", 1)) == 1:
            return None
        coords = mesh.group(anchor(mesh), ("mp",))
        devs = np.empty(len(coords), dtype=object)
        for i, c in enumerate(coords):
            devs[i] = mesh.devices[c]
        return Mesh(devs, ("mp",))

    def attention_core(q, k, v, theta):
        q, k, _ = IF.fused_rotary_position_embedding(q, k,
                                                     rotary_emb_base=theta)
        return F.scaled_dot_product_attention(q, k, v, is_causal=True)

    def linears(parallel):
        if parallel:
            return (lambda i, o: ColumnParallelLinear(i, o, has_bias=False,
                                                      gather_output=False),
                    lambda i, o: RowParallelLinear(i, o, has_bias=False,
                                                   input_is_parallel=True))
        lin = lambda i, o: nn.Linear(i, o, bias_attr=False)  # noqa: E731
        return lin, lin

    class DecoderLayer(nn.Layer):
        """One pre-norm decoder block on ``x [B, S, E]``."""

        def __init__(self, cfg, parallel=True):
            super().__init__()
            E, I_, D = cfg.hidden_size, cfg.intermediate_size, cfg.head_dim
            H, Hk = cfg.num_attention_heads, cfg.kv_heads
            col, row = linears(parallel)
            self.cfg, self.parallel = cfg, parallel
            self.ln_attn = self.create_parameter(
                [E], default_initializer=I.Constant(1.0))
            self.wq, self.wk, self.wv = col(E, H * D), col(E, Hk * D), \
                col(E, Hk * D)
            self.wo = row(H * D, E)
            self.ln_mlp = self.create_parameter(
                [E], default_initializer=I.Constant(1.0))
            self.w_gate, self.w_up = col(E, I_), col(E, I_)
            self.w_down = row(I_, E)

        def forward(self, x):
            cfg = self.cfg
            B, S, D = x.shape[0], x.shape[1], cfg.head_dim
            h = IF.fused_rms_norm(x, self.ln_attn, epsilon=cfg.rms_norm_eps)
            q, k, v = (f(h).reshape([B, S, -1, D])
                       for f in (self.wq, self.wk, self.wv))
            mesh = mp_group_mesh() if self.parallel else None
            if mesh is None:
                o = attention_core(q, k, v, cfg.rope_theta)
            else:
                o = shard_map(lambda a, b, c: attention_core(
                    a, b, c, cfg.rope_theta), mesh, (heads, heads, heads),
                    heads)(q, k, v)
            x = x + self.wo(o.reshape([B, S, -1]))
            h = IF.fused_rms_norm(x, self.ln_mlp, epsilon=cfg.rms_norm_eps)
            return x + self.w_down(F.silu(self.w_gate(h)) * self.w_up(h))

    class Embedding(nn.Layer):
        """The token embedding, cast to ``cfg.dtype`` (a pipeline's first
        stage)."""

        def __init__(self, cfg, parallel=True):
            super().__init__()
            self.cfg = cfg
            self.embed = VocabParallelEmbedding(
                cfg.vocab_size, cfg.hidden_size) if parallel else \
                nn.Embedding(cfg.vocab_size, cfg.hidden_size)

        def forward(self, ids):
            return self.embed(ids).astype(self.cfg.dtype)

    class Head(nn.Layer):
        """The final norm and the output projection: logits ``[B, S, V]``
        (a pipeline's last stage)."""

        def __init__(self, cfg, parallel=True):
            super().__init__()
            self.cfg = cfg
            self.ln_f = self.create_parameter(
                [cfg.hidden_size], default_initializer=I.Constant(1.0))
            self.lm_head = linears(parallel)[0](cfg.hidden_size,
                                                cfg.vocab_size)

        def forward(self, x):
            x = IF.fused_rms_norm(x, self.ln_f, epsilon=self.cfg.rms_norm_eps)
            return self.lm_head(x)

    def token_mean_ce(ce, logits, labels, parallel):
        """The mean of ``ce``'s per-token loss (float32 logits) over the
        labels that are not -100."""
        lg = logits.astype("float32")
        if parallel:
            per = ce(lg, labels)[..., 0]
        else:
            V = lg.shape[-1]
            per = ce(lg.reshape([-1, V]), labels.reshape([-1])).reshape(
                labels.shape)
        mask = (labels >= 0).astype("float32")
        return (per * mask).sum() / mask.sum().clip(min=1.0)

    class Llama(nn.Layer):
        """The decoder over ``cfg`` (dense, untied); ``forward(ids)`` gives
        the logits, ``forward(ids, labels)`` the mean cross-entropy over
        the labels that are not -100 (labels already shifted), in
        float32."""

        def __init__(self, cfg, parallel=True, use_recompute=True):
            super().__init__()
            if cfg.moe_num_experts or cfg.tie_word_embeddings:
                raise ValueError("the decoder builds dense, untied configs")
            self.cfg, self.parallel = cfg, parallel
            self.use_recompute = use_recompute
            self.embedding = Embedding(cfg, parallel)
            self.layers = nn.LayerList([DecoderLayer(cfg, parallel)
                                        for _ in range(cfg.num_hidden_layers)])
            self.head = Head(cfg, parallel)
            self.ce = ParallelCrossEntropy() if parallel else \
                nn.CrossEntropyLoss(reduction="none")

        def forward(self, ids, labels=None):
            x = self.embedding(ids)
            for layer in self.layers:
                x = recompute(layer, x) if self.use_recompute and \
                    self.training else layer(x)
            logits = self.head(x)
            if labels is None:
                return logits
            return token_mean_ce(self.ce, logits, labels, self.parallel)

    def state_dict(params):
        """A functional LLaMA tree (``llama.init_params``: stacked
        ``[L, ...]`` layers, dense and untied) under ``Llama``'s state-dict
        names, one entry per layer (views, uncopied); ``set_state_dict``
        lays each out as its layer does (an mp layer's entry is its full
        logical weight)."""
        out = {"embedding.embed.weight": params["embed"],
               "head.ln_f": params["ln_f"],
               "head.lm_head.weight": params["lm_head"]}
        for name, leaf in params["layers"].items():
            for l in range(leaf.shape[0]):
                out[f"layers.{l}.{_MEGATRON_NAMES[name]}"] = leaf[l]
        return out

    ns = types.SimpleNamespace(
        Llama=Llama, DecoderLayer=DecoderLayer, Embedding=Embedding,
        Head=Head, token_mean_ce=token_mean_ce,
        attention_core=attention_core, state_dict=state_dict)
    _MEGATRON_CACHE["ns"] = ns
    return ns


def megatron_launches(L, mp):
    """Kernel launches per training step of :func:`megatron`'s decoder
    (phase 46 (a)) at depth ``L`` and mp degree ``mp``, after the first
    step (whose recompute state check runs every layer once more, under
    no_grad).
    Every layer runs under non-reentrant recompute, so its forward runs
    twice (the forward, then the recompute before its backward), its
    backward once. Per layer: the attention core runs once per mp shard
    on that shard's heads (the region), so the flash forward launches
    2 x mp times, dq and dk/dv mp times each, RoPE 2 x 2 x mp forward (q
    and k) and 2 x mp backward; the two RMSNorms launch 2 x 2 forward and
    2 backward; the final norm once each way."""
    return {"flash_attention": 2 * mp * L, "flash_attention_bwd_dq": mp * L,
            "flash_attention_bwd_dkv": mp * L, "rms_norm": 4 * L + 1,
            "rms_norm_bwd": 2 * L + 1, "apply_rope": 4 * mp * L,
            "apply_rope_bwd": 2 * mp * L}


def _fleet(dev, n, **degrees):
    """``fleet.init`` of the port over ``[dev] * n`` with ``degrees``."""
    from paddle_tpu_torch.distributed import fleet
    st = fleet.DistributedStrategy()
    st.hybrid_configs = {"dp_degree": 1, "mp_degree": 1, "pp_degree": 1,
                         "sharding_degree": 1, "sep_degree": 1,
                         "ep_degree": 1, **degrees}
    fleet.init(is_collective=True, strategy=st, devices=[dev] * n)
    return st


def _small_mha(cfg):
    """:func:`_small` with as many kv heads as heads: a CPU rehearsal
    takes the plain attention, which has no GQA (the reference's neither;
    the flash kernels have)."""
    import dataclasses
    small = _small(cfg)
    return dataclasses.replace(small, num_key_value_heads=small.num_attention_heads)


def _drop_fleet():
    from paddle_tpu_torch.distributed.topology import \
        set_hybrid_communicate_group
    set_hybrid_communicate_group(None)


def _sync_dev(dev):
    import torch
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def megatron_mp_phase(dev="cuda:0", small=False, batch=8, seq=2048,
                      steps=6):
    """Phase 46 (a): :func:`megatron`'s decoder at F's widths (bf16, 12
    layers) at mp 2 over ``[dev] * 2``, its weights F's ``init_params``
    seed 0 by name; ``fleet.distributed_model`` and a
    ``distributed_optimizer(AdamW(multi_precision=True))``; a warm-up step,
    then ``steps`` timed steps with the counters set to 0 just before them
    (exact launches: :func:`megatron_launches`), one profiled step. Returns
    (metrics, launches)."""
    import torch
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.models.llama import init_params, loss_fn
    M = megatron()
    paddle.set_device(dev)
    cfg = train_config(torch.bfloat16, use_fused_norm=True)
    if small:
        cfg = _small_mha(cfg)
        batch, seq = 2, 64
    params = init_params(cfg, seed=SEED, device=dev)
    ids = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (batch, seq))).to(dev)
    with torch.no_grad():
        ref = loss_fn(params, ids, ids, cfg).item()
    _fleet(dev, 2, mp_degree=2)
    net = M.Llama(cfg)
    missing, unexpected = net.set_state_dict(M.state_dict(params))
    check(not missing and not unexpected, f"set_state_dict missing "
          f"{missing}, unexpected {unexpected}")
    del params
    net.bfloat16()
    w = net.layers[0].wq.weight
    check({tuple(v.shape) for v in w.locals.values()} ==
          {(cfg.hidden_size, cfg.hidden_size // 2)},
          "the q projection is not cut over mp 2")
    model = fleet.distributed_model(net)
    opt = fleet.distributed_optimizer(paddle.optimizer.AdamW(
        1e-4, parameters=net.parameters(), multi_precision=True))
    x = paddle.to_tensor(ids)

    def step():
        loss = model(x, x)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss.item()

    losses = [step()]
    first_rel = abs(losses[0] - ref) / abs(ref)
    check(first_rel <= 5e-3, f"mp eager first loss {losses[0]} vs "
          f"functional {ref} (rel {first_rel})")
    _sync_dev(dev)
    if not small:
        torch.cuda.reset_peak_memory_stats()
    def allocator():
        """The caching allocator's device allocations and OOM retries so
        far (a step that calls cudaMalloc or retries runs slow)."""
        if torch.device(dev).type != "cuda":
            return [0, 0]
        st = torch.cuda.memory_stats()
        return [st.get("num_device_alloc", 0), st.get("num_alloc_retries", 0)]

    reset_counts()
    times, allocs = [], []
    for _ in range(steps):
        _sync_dev(dev)
        a0 = allocator()
        t0 = time.time()
        losses.append(step())
        times.append(time.time() - t0)
        allocs.append([b - a for a, b in zip(a0, allocator())])
    counts = read_counts()
    per_step = {k: v / steps for k, v in counts.items() if v}
    step_ms = float(np.median(times)) * 1e3
    m = {"depth": cfg.num_hidden_layers, "mp": 2, "step_ms": step_ms,
         "step_ms_each": [t * 1e3 for t in times],
         "device_allocs_and_retries_each": allocs,
         "tokens_per_s": batch * seq / step_ms * 1e3, "losses": losses,
         "functional_first_loss": ref, "first_loss_rel": first_rel,
         "launches_per_step": per_step}
    check(all(np.isfinite(losses)), f"non-finite mp eager loss {losses}")
    if not small:
        m["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated() \
            / 2 ** 30
        want = megatron_launches(cfg.num_hidden_layers, 2)
        check(per_step == want, f"mp eager launches per step {per_step}, "
              f"expected {want}")
        m["profile"] = profile_device(step, "mp eager training step", top=8)
    log(f"  (a) {json.dumps(m)}")
    _drop_fleet()
    return m, counts


def _grad_worst(got, want):
    return max(float(np.abs(got[k] - want[k]).max() /
                     max(np.abs(want[k]).max(), 1e-30)) for k in want)


def megatron_parity_phase(dev="cuda:0", small=False):
    """Phase 46 (a), fp32 at E's width: :func:`megatron`'s decoder at mp 2
    over ``[dev] * 2`` against the serial twin (``nn.Linear`` /
    ``nn.Embedding`` / ``nn.CrossEntropyLoss``) on one device, same
    weights: the loss within 1e-5 x |loss|, every gradient within 1e-4 x
    max|g|."""
    import torch
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.models.llama import init_params
    M = megatron()
    paddle.set_device(dev)
    cfg = e_config(torch.float32)
    if small:
        cfg = _small_mha(cfg)
    sd = M.state_dict(init_params(cfg, seed=SEED + 5, device=dev))
    ids = paddle.to_tensor(torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 64 if small else 512))).to(dev))
    out = []
    for parallel in (True, False):
        if parallel:
            _fleet(dev, 2, mp_degree=2)
        net = M.Llama(cfg, parallel=parallel)
        net.set_state_dict(sd)
        loss = net(ids, ids)
        loss.backward()
        out.append((loss.item(), {k: p.grad.numpy() for k, p in
                                  net.named_parameters()}))
        _drop_fleet()
    rel = abs(out[0][0] - out[1][0]) / abs(out[1][0])
    worst = _grad_worst(out[0][1], out[1][1])
    m = {"loss_mp2": out[0][0], "loss_serial": out[1][0], "loss_rel": rel,
         "grad_worst": worst}
    log(f"  (a) fp32 parity {json.dumps(m)}")
    check(rel <= 1e-5, f"fp32 mp decoder loss rel {rel}")
    check(worst <= 1e-4, f"fp32 mp decoder gradient {worst} x max|g|")
    return m


def fleet_llama_phase(m45, dev="cuda:0", small=False, batch=8, seq=2048,
                      steps=4):
    """Phase 46 (b): F's ``LlamaForCausalLM`` (phase 45's net, seed 0)
    through ``fleet.init`` (dp 2 x sharding 2 over ``[dev] * 4``) ->
    ``distributed_model`` -> ``distributed_optimizer(AdamW)`` (the ``os``
    layout). The first loss within 5e-3 x |loss| of phase 45's on the same
    batch; after a step the dp replicas (and the sharding copies) are
    bit-equal and each optimizer state's locals hold half its leaf on the
    sharding axis. Returns (metrics, launches of the timed steps)."""
    import torch
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.distributed import DataParallel, fleet
    from paddle_tpu_torch.models.llama import LlamaForCausalLM
    paddle.set_device(dev)
    cfg = train_config(torch.bfloat16, use_fused_norm=True)
    if small:
        cfg = _small_mha(cfg)
        batch, seq = 4, 64
    _fleet(dev, 4, dp_degree=2, sharding_degree=2)
    net = LlamaForCausalLM(cfg, seed=SEED)
    opt = paddle.optimizer.AdamW(1e-4, parameters=net.parameters())
    model = fleet.distributed_model(net)
    opt = fleet.distributed_optimizer(opt)
    check(isinstance(model, DataParallel), "distributed_model under dp "
          "did not give DataParallel")
    ids = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (batch, seq))).to(dev)
    x = paddle.to_tensor(ids)

    def step():
        loss = model(x, x)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss.item()

    losses = [step()]
    want = m45["losses"][0] if m45 else losses[0]
    rel = abs(losses[0] - want) / abs(want)
    check(rel <= 5e-3, f"dp x sharding first loss {losses[0]} vs phase 45's "
          f"{want} (rel {rel})")
    unequal, halves = [], True
    for p in net.parameters():
        vals = list(p.locals.values())
        if not all(torch.equal(v, vals[0]) for v in vals[1:]):
            unequal.append(p.name)
        st = opt._accumulators["moment1"][p.name]
        for c, v in st.locals.items():
            if v.numel() * 2 != p._st.locals[c].numel():
                halves = False
    check(not unequal, f"replicas differ after a step: {unequal}")
    check(halves, "an optimizer state's local is not half its leaf")
    _sync_dev(dev)
    reset_counts()
    times = []
    for _ in range(steps):
        _sync_dev(dev)
        t0 = time.time()
        losses.append(step())
        times.append(time.time() - t0)
    counts = read_counts()
    step_ms = float(np.median(times)) * 1e3
    m = {"step_ms": step_ms, "step_ms_each": [t * 1e3 for t in times],
         "phase45_step_ms": m45["step_ms"] if m45 else None,
         "losses": losses, "phase45_first_loss": want, "first_loss_rel": rel,
         "launches_per_step": {k: v / steps for k, v in counts.items() if v}}
    check(all(np.isfinite(losses)), f"non-finite dp loss {losses}")
    log(f"  (b) {json.dumps(m)}")
    _drop_fleet()
    return m, counts


def pipeline_layer_phase(dev="cuda:0", small=False, steps=2):
    """Phase 46 (c): ``PipelineParallel.train_batch`` at pp 2 over
    ``[dev] * 2``, 4 micro-batches, on (a)'s decoder blocks as a
    ``PipelineLayer`` (embedding, E's 4 blocks, the head) at E's width in
    fp32, SGD, against the serial decoder with the same weights and serial
    gradient accumulation: the stacked route (the blocks stacked two a
    stage through ``pipeline_scan``'s ring, the embedding and head as
    prologue and epilogue), each step's loss within 1e-5 x |loss|."""
    import torch
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet.layers.mpu import \
        ParallelCrossEntropy
    from paddle_tpu_torch.distributed.pipeline import (LayerDesc,
                                                       PipelineLayer)
    from paddle_tpu_torch.models.llama import init_params
    M = megatron()
    paddle.set_device(dev)
    cfg = e_config(torch.float32)
    if small:
        cfg = _small_mha(cfg)
    L = cfg.num_hidden_layers
    sd = M.state_dict(init_params(cfg, seed=SEED + 6, device=dev))
    st = _fleet(dev, 2, pp_degree=2)
    st.pipeline_configs = {"accumulate_steps": 4, "micro_batch_size": 2}
    ce = ParallelCrossEntropy()
    pl = PipelineLayer(
        [LayerDesc(M.Embedding, cfg)] +
        [LayerDesc(M.DecoderLayer, cfg) for _ in range(L)] +
        [LayerDesc(M.Head, cfg)], num_stages=2,
        loss_fn=lambda lg, lb: M.token_mean_ce(ce, lg, lb, True))
    rename = {"embedding.": "0.", "head.": f"{L + 1}."}
    rename.update({f"layers.{l}.": f"{l + 1}." for l in range(L)})

    def pp_name(k):
        for a, b in rename.items():
            if k.startswith(a):
                return b + k[len(a):]
        return k

    pl.set_state_dict({pp_name(k): v for k, v in sd.items()})
    model = fleet.distributed_model(pl)
    serial = M.Llama(cfg, parallel=False, use_recompute=False)
    serial.set_state_dict(sd)
    opt_pp = paddle.optimizer.SGD(0.1, parameters=model.parameters())
    opt_s = paddle.optimizer.SGD(0.1, parameters=serial.parameters())
    rng = np.random.default_rng(3)
    gaps, pairs = [], []
    for _ in range(steps):
        ids = paddle.to_tensor(torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (8, 64 if small else 256))).to(dev))
        lp = float(model.train_batch((ids, ids), opt_pp))
        total = 0.0
        for k in range(4):
            part = ids[k * 2:(k + 1) * 2]
            loss = serial(part, part)
            (loss / 4).backward()
            total += loss.item()
        opt_s.step()
        opt_s.clear_grad()
        pairs.append((lp, total / 4))
        gaps.append(abs(lp - total / 4) / abs(total / 4))
    m = {"losses_pp_serial": pairs, "loss_rel": gaps,
         "path": model.last_path}
    log(f"  (c) {json.dumps(m)}")
    check(model.last_path == "compiled", f"pp train_batch took the "
          f"{model.last_path} route, not the stacked ring")
    check(max(gaps) <= 1e-5, f"pp train_batch losses part by {gaps}")
    _drop_fleet()
    return m


def moe_layer_phase(dev="cuda:0", small=False):
    """Phase 46 (d): the eager ``MoELayer`` (8 experts, GShard top-2,
    capacity factor 1.25) at ep 4 over ``[dev] * 4`` against the
    replicated layer on the same weights, fp32 at E's width (tokens B 4 x
    S 512): the output and every gradient within 1e-5 x max|ref|."""
    import torch
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.distributed.dist_tensor import DistParameter
    from paddle_tpu_torch.distributed.moe import MoELayer
    paddle.set_device(dev)
    d, inner, E = (64, 96, 8) if small else (512, 1376, 8)
    _fleet(dev, 4, ep_degree=4)
    layers = []
    for group in ("ep", None):
        paddle.seed(SEED + 7)
        experts = [paddle.nn.Sequential(paddle.nn.Linear(d, inner),
                                        paddle.nn.GELU(),
                                        paddle.nn.Linear(inner, d))
                   for _ in range(E)]
        layers.append(MoELayer(d_model=d, experts=experts,
                               gate={"type": "gshard",
                                     "capacity_factor": 1.25},
                               moe_group=group))
    ep, rep = layers
    rep.gate.weight.set_value(ep.gate.weight.numpy())
    check(all(isinstance(p, DistParameter) and
              {v.shape[0] for v in p.locals.values()} == {E // 4}
              for p in ep._stacked), "the experts are not laid out E/ep")
    a = np.random.default_rng(4).standard_normal(
        (4, 64 if small else 512, d)).astype(np.float32)
    res = []
    for layer in (ep, rep):
        xt = paddle.to_tensor(torch.from_numpy(a).to(dev),
                              stop_gradient=False)
        y = layer(xt)
        ((y ** 2).mean() + 0.01 * layer.aux_loss).backward()
        res.append([y.numpy(), xt.grad.numpy(), layer.gate.weight.grad.numpy()]
                   + [p.grad.numpy() for p in layer._stacked])
    worst = max(float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-30))
                for g, w in zip(res[0], res[1]))
    m = {"worst_rel_to_max": worst, "aux": [float(ep.aux_loss),
                                            float(rep.aux_loss)]}
    log(f"  (d) {json.dumps(m)}")
    check(worst <= 1e-5, f"ep 4 MoELayer parts from the replicated one by "
          f"{worst} x max")
    _drop_fleet()
    return m


def hybrid_phase(m45, dev="cuda:0", small=False):
    """Phase 46: the eager hybrid-parallel API, (a)-(d), each part's
    seconds printed. Returns the launches of (a)'s and (b)'s timed
    steps."""
    import torch
    secs = {}
    t0 = time.time()
    _, ca = megatron_mp_phase(dev, small)
    megatron_parity_phase(dev, small)
    secs["a"] = time.time() - t0
    if not small:
        torch.cuda.empty_cache()
    t0 = time.time()
    _, cb = fleet_llama_phase(m45, dev, small)
    secs["b"] = time.time() - t0
    if not small:
        torch.cuda.empty_cache()
    t0 = time.time()
    pipeline_layer_phase(dev, small)
    secs["c"] = time.time() - t0
    t0 = time.time()
    moe_layer_phase(dev, small)
    secs["d"] = time.time() - t0
    log(f"  part seconds: {json.dumps(secs)}")
    return ca, cb


# ---------------------------------------------------------------------------
# phases 47-49: BERT fine-tuning through paddle.Model, its fp32 parity,
# the parameter-server tables
# ---------------------------------------------------------------------------

BERT_BATCH, BERT_SEQ = 32, 128
# examples/train_recsys.py's configuration, not cut
RECSYS = dict(vocab=1_000_000, dim=32, slots=8, batch=256, steps=20)


def bert_flops_per_step(cfg, batch, seq):
    """Training FLOPs of one BertForSequenceClassification step (forward
    and backward, 3x the forward's matmuls): per token and layer the four
    E x E projections, the two FFN matmuls and attention's two products;
    per sequence the pooler and the 2-class head."""
    E, I, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_hidden_layers
    per_token = L * (2 * (4 * E * E + 2 * E * I) + 4 * seq * E)
    per_seq = 2 * E * E + 2 * E * 2
    return 3 * (batch * seq * per_token + batch * per_seq)


def bert_data(cfg, n, seq, seed):
    """``examples/finetune_bert.py``'s synthetic task: class = whether
    token 0 is in the upper vocab half."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, cfg.vocab_size, (n, seq)).astype("int64")
    return ids, (ids[:, 0] >= cfg.vocab_size // 2).astype("int64")


def _bert_model(paddle, net, amp_configs=None, lr=3e-4, jit=False):
    class Net(paddle.nn.Layer):
        def __init__(self, bert):
            super().__init__()
            self.bert = bert

        def forward(self, x):
            return self.bert(x)

    model = paddle.Model(Net(net))
    model.prepare(optimizer=paddle.optimizer.AdamW(
        learning_rate=lr, parameters=net.parameters()),
        loss=paddle.nn.CrossEntropyLoss(), metrics=paddle.metric.Accuracy(),
        amp_configs=amp_configs, jit=jit)
    return model


def bert_phase(steps=6, eval_batches=4, batch=BERT_BATCH, seq=BERT_SEQ):
    """Phase 47 (cell BT): ``examples/finetune_bert.py``'s loop at BERT-base
    width through ``paddle.Model``. Returns (metrics, launches of its
    evaluate / predict / quantized predict)."""
    import torch
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.kernels.quant_matmul import weight_only_matmul_plain
    from paddle_tpu_torch.models.bert import (BertConfig,
                                              BertForSequenceClassification)
    from paddle_tpu_torch.nn.quant import WeightOnlyLinear
    t0 = time.time()
    paddle.set_device("gpu:0")
    paddle.seed(SEED)
    cfg = BertConfig()
    net = BertForSequenceClassification(cfg, num_classes=2)
    model = _bert_model(paddle, net, amp_configs="O1")
    n_train = (steps + 1) * batch
    ids, labels = bert_data(cfg, n_train + eval_batches * batch, seq, SEED)
    train = paddle.io.TensorDataset([ids[:n_train], labels[:n_train]])
    val = paddle.io.TensorDataset([ids[n_train:], labels[n_train:]])

    class Clock(paddle.callbacks.Callback):
        """Host-clock batch ends (``train_batch`` reads the loss, so each
        end follows the step's device work) and the loss of each."""

        def __init__(self):
            super().__init__()
            self.ends, self.losses = [], []

        def on_train_batch_begin(self, step, logs=None):
            if step == 1:               # after the warm-up step
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                self.ends.append(time.time())

        def on_train_batch_end(self, step, logs=None):
            self.losses.append(logs["loss"])
            if step >= 1:
                self.ends.append(time.time())

    clock = Clock()
    hist = model.fit(train, batch_size=batch, epochs=1, verbose=0,
                     shuffle=True, callbacks=[clock])
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    times = np.diff(clock.ends)
    check(len(times) == steps, f"timed {len(times)} steps, not {steps}")
    check(all(np.isfinite(clock.losses)), f"losses {clock.losses}")
    step_ms = float(np.median(times)) * 1e3
    flops = bert_flops_per_step(cfg, batch, seq)
    m = {"step_ms": step_ms, "step_ms_each": [t * 1e3 for t in times],
         "samples_per_s": batch / step_ms * 1e3,
         "mfu": flops / (step_ms / 1e3) / PEAK_FLOPS["bf16"],
         "flops_per_step": flops, "max_memory_allocated_gb": peak,
         "losses": clock.losses, "epoch_loss": hist["loss"]}
    log(f"  fit: {json.dumps(m)}")
    xb = torch.from_numpy(ids[:batch]).cuda()
    yb = torch.from_numpy(labels[:batch]).cuda()
    m["profile"] = profile_device(lambda: model.train_batch([xb], [yb]),
                                  "BERT-base fit step (O1)", top=8)

    # evaluate under O1: every attention call takes the bf16 flash kernel
    captured = []
    hook = model.network.register_forward_post_hook(
        lambda layer, ins, out: captured.append(out.numpy()))
    reset_counts()
    with paddle.amp.auto_cast(level="O1"):
        ev = model.evaluate(val, batch_size=batch, verbose=0)
    c_eval = read_counts()
    hook.remove()
    y_val = labels[n_train:]
    recount = float((np.concatenate(captured).argmax(-1) == y_val).mean())
    log(f"  evaluate: {json.dumps(ev)}; numpy recount of its predictions: "
        f"acc {recount}; launches {json.dumps(c_eval)}")
    check(c_eval["flash_attention"] == cfg.num_hidden_layers * eval_batches,
          f"evaluate: {c_eval['flash_attention']} flash forwards for "
          f"{eval_batches} batches, expected {cfg.num_hidden_layers} a batch")
    check(ev["acc"] == recount, f"Accuracy {ev['acc']} != numpy {recount}")
    reset_counts()
    with paddle.amp.auto_cast(level="O1"):
        fp_logits = model.predict(val, batch_size=batch,
                                  stack_outputs=True)[0]
    c_pred = read_counts()
    check(c_pred["flash_attention"] == cfg.num_hidden_layers * eval_batches,
          f"predict: {c_pred['flash_attention']} flash forwards")

    # the quantized network: every Linear through the int8 matmul kernel
    swapped = paddle.nn.quant.quantize_linears(model.network)
    per_forward = 6 * cfg.num_hidden_layers + 2
    check(swapped == per_forward, f"quantize_linears swapped {swapped}")
    caps = {}

    def keep_first(layer, ins, out):
        if id(layer) not in caps:
            caps[id(layer)] = (layer, ins[0]._value.detach(),
                               out._value.detach())
    hooks = [layer.register_forward_post_hook(keep_first)
             for layer in model.network.sublayers()
             if isinstance(layer, WeightOnlyLinear)]
    reset_counts()
    with paddle.amp.auto_cast(level="O1"):
        q_logits = model.predict(val, batch_size=batch,
                                 stack_outputs=True)[0]
    c_q = read_counts()
    for h in hooks:
        h.remove()
    check(c_q["flash_attention"] == cfg.num_hidden_layers * eval_batches,
          f"quantized predict: {c_q['flash_attention']} flash forwards")
    check(c_q["weight_only_matmul"] == per_forward * eval_batches,
          f"quantized predict: {c_q['weight_only_matmul']} int8 matmul "
          f"launches for {eval_batches} forwards, expected {per_forward} a "
          f"forward")
    worst = {"max_abs_rel": 0.0, "rel_fro": 0.0, "rel_row": 0.0}
    for layer, x, got in caps.values():
        x2 = x.reshape(-1, x.shape[-1])
        ref = weight_only_matmul_plain(x2, layer.weight._value,
                                       layer.weight_scale._value, x2.dtype)
        if layer.bias is not None:
            ref = ref + layer.bias._value
        got = got.reshape(ref.shape)
        err = (got.float() - ref.float()).abs().max().item()
        rel = err / max(ref.float().abs().max().item(), 1e-30)
        fro, row = rel_errors(got, ref)
        worst = {"max_abs_rel": max(worst["max_abs_rel"], rel),
                 "rel_fro": max(worst["rel_fro"], fro),
                 "rel_row": max(worst["rel_row"], row)}
        check(rel <= 1e-2 and fro <= BF16_FRO and row <= BF16_ROW,
              f"WeightOnlyLinear {tuple(x2.shape)} x {tuple(ref.shape)} "
              f"({x2.dtype}): {rel:.3g} x max|ref|, rel_fro {fro:.3g}, "
              f"rel_row {row:.3g}")
    check(len(caps) == per_forward, f"{len(caps)} WeightOnlyLinear layers ran")
    gap = float(np.abs(q_logits - fp_logits).max())
    scale = float(np.abs(fp_logits).max())
    log(f"  quantized predict: {swapped} layers swapped, int8 matmul "
        f"launches {c_q['weight_only_matmul']} ({per_forward} a forward); "
        f"each layer against its plain dequant-then-matmul: "
        f"{json.dumps(worst)}; logits {gap:.4g} from the fp model's (max "
        f"|logit| {scale:.4g})")
    check(gap <= 5e-2 * scale, f"quantized logits {gap} > 5e-2 x {scale}")
    m.update({"evaluate": ev, "accuracy_recount": recount,
              "eval_flash_fwd_per_batch":
              c_eval["flash_attention"] / eval_batches,
              "int8_matmul_per_forward":
              c_q["weight_only_matmul"] / eval_batches,
              "int8_layers_worst": worst, "int8_logit_gap": gap / scale,
              "seconds": time.time() - t0})
    launches = {k: c_eval[k] + c_pred[k] + c_q[k] for k in c_eval}
    del model, net, caps
    torch.cuda.empty_cache()
    return m, launches


def _grad_map(net):
    return {n: q.grad._value.detach().float().cpu().numpy()
            for n, q in net.named_parameters() if q.grad is not None}


def bert_parity_phase(batch=8, seq=128, steps=3):
    """Phase 48: fp32 parity of ``Model.train_batch`` on the card (flash
    kernels) against the same net on the CPU (the plain path); O1 against
    fp32; ``GradScaler`` at float16; a ``PyLayer`` on CUDA tensors.
    Returns the card run's launches."""
    import torch
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.models.bert import (BertConfig,
                                              BertForSequenceClassification)
    cfg = BertConfig(hidden_size=256, num_hidden_layers=4,
                     num_attention_heads=4, intermediate_size=1024,
                     hidden_dropout_prob=0.0,
                     attention_probs_dropout_prob=0.0)
    ids, labels = bert_data(cfg, (steps + 1) * batch, seq, SEED + 48)
    paddle.set_device("gpu:0")
    paddle.seed(SEED + 48)
    nets, models = {}, {}
    for place in ("gpu:0", "cpu"):
        paddle.set_device(place)
        nets[place] = BertForSequenceClassification(cfg, num_classes=2)
        if place == "cpu":
            nets[place].set_state_dict(nets["gpu:0"].state_dict())
        models[place] = _bert_model(paddle, nets[place], lr=1e-3)

    def batch_of(i, place):
        paddle.set_device(place)
        return ([ids[i * batch:(i + 1) * batch]],
                [labels[i * batch:(i + 1) * batch]])

    res = {}
    for place in ("cpu", "gpu:0"):
        x, y = batch_of(0, place)
        if place != "cpu":
            reset_counts()
        first = models[place].train_batch(x, y, update=False)[0][0]
        if place != "cpu":
            counts = read_counts()
        res[place] = (first, _grad_map(nets[place]))
        models[place]._optimizer.clear_grad()
    paddle.set_device("gpu:0")
    L = cfg.num_hidden_layers
    check((counts["flash_attention"], counts["flash_attention_bwd_dq"],
           counts["flash_attention_bwd_dkv"]) == (L, L, L),
          f"card train_batch flash launches {counts}, expected {L} each")
    (lc, gc), (lg, gg) = res["cpu"], res["gpu:0"]
    loss_rel = abs(lg - lc) / abs(lc)
    check(loss_rel <= 1e-5, f"fp32 loss card {lg} vs CPU {lc}")
    check(gg.keys() == gc.keys(), "gradient leaves differ")
    floor = 1e-2 * max(float(np.abs(g).max()) for g in gc.values())
    grad_gap = max(float(np.abs(gg[n] - gc[n]).max()) /
                   max(float(np.abs(gc[n]).max()), floor) for n in gc)
    check(grad_gap <= 1e-4, f"fp32 gradients card vs CPU: {grad_gap} x "
          f"max|g|")
    step_losses = {}
    for place in ("cpu", "gpu:0"):
        step_losses[place] = [models[place].train_batch(
            *batch_of(i + 1, place))[0][0] for i in range(steps)]
    paddle.set_device("gpu:0")
    step_rel = max(abs(a - b) / abs(b) for a, b in
                   zip(step_losses["gpu:0"], step_losses["cpu"]))
    # AdamW's first step moves an entry by ~lr whatever its gradient's
    # size, so entries whose gradient lies in the fp32 noise part by up
    # to 2 lr (ROADMAP §C): the losses after updates are held to 1e-4
    check(step_rel <= 1e-4, f"AdamW step losses card {step_losses['gpu:0']}"
          f" vs CPU {step_losses['cpu']}")

    net = nets["gpu:0"]
    x = paddle.to_tensor(ids[:batch])
    y = paddle.to_tensor(labels[:batch])
    ce = paddle.nn.CrossEntropyLoss()
    with paddle.no_grad():
        l32 = float(ce(net(x), y))
        with paddle.amp.auto_cast(level="O1"):
            l16 = float(ce(net(x), y))
    o1_rel = abs(l16 - l32) / abs(l32)
    check(o1_rel <= 5e-3, f"O1 bf16 loss {l16} vs fp32 {l32}")

    # GradScaler at float16: an injected inf skips the step, halves the
    # scale; attention takes the plain formula (the flash kernels take
    # fp32 and bf16 only)
    opt = paddle.optimizer.AdamW(parameters=net.parameters())
    scaler = paddle.amp.GradScaler(init_loss_scaling=1024.0)
    reset_counts()
    with paddle.amp.auto_cast(level="O1", dtype="float16"):
        loss = ce(net(x), y)
    fp16_flash = read_counts()["flash_attention"]
    check(fp16_flash == 0, f"float16 attention launched flash {fp16_flash}x")
    scaler.scale(loss).backward()
    params = [q for q in net.parameters() if q.grad is not None]
    before = [q._value.detach().clone() for q in params]
    params[0].grad.set_value(np.full(params[0].shape, np.inf, np.float32))
    scaler.step(opt)
    scaler.update()
    check(all(torch.equal(a, q._value) for a, q in zip(before, params)),
          "GradScaler stepped on an inf gradient")
    check(scaler.get_init_loss_scaling() == 512.0,
          f"scale {scaler.get_init_loss_scaling()} after an inf, not 512")
    opt.clear_grad()

    class Cube(paddle.autograd.PyLayer):
        @staticmethod
        def forward(ctx, t):
            ctx.save_for_backward(t)
            return t * t * t

        @staticmethod
        def backward(ctx, g):
            (t,) = ctx.saved_tensor()
            return g * 3.0 * t * t

    a = np.random.default_rng(48).standard_normal(4096).astype(np.float32)
    t = paddle.to_tensor(a, stop_gradient=False)
    out = Cube.apply(t)
    out.sum().backward()
    check(t.grad._value.is_cuda, "PyLayer gradient left the card")
    py_gap = float(np.abs(t.grad.numpy() - 3.0 * a * a).max() /
                   np.abs(3.0 * a * a).max())
    check(py_gap <= 1e-6 and np.allclose(out.numpy(), a ** 3, rtol=1e-6),
          f"PyLayer on CUDA: gradient gap {py_gap}")
    m = {"loss_rel": loss_rel, "grad_gap": grad_gap,
         "step_losses_card": step_losses["gpu:0"],
         "step_losses_cpu": step_losses["cpu"], "step_loss_rel": step_rel,
         "o1_loss_rel": o1_rel, "fp16_skip_scale": 512.0,
         "pylayer_grad_gap": py_gap, "card_launches": counts}
    log(f"  {json.dumps(m)}")
    del nets, models, net
    torch.cuda.empty_cache()
    return counts


def recsys_run(host, tower_state, steps=RECSYS["steps"]):
    """``examples/train_recsys.py``'s loop on the card (a ``host`` or a
    device table): losses, step ms, the host gather and AsyncLookup's
    wait, the backward's memory growth."""
    import torch
    import paddle_tpu_torch as paddle
    import paddle_tpu_torch.nn as nn
    from paddle_tpu_torch.distributed.ps import (AsyncLookup, SparseAdam,
                                                 SparseEmbedding)
    V, D, S, B = (RECSYS[k] for k in ("vocab", "dim", "slots", "batch"))
    paddle.set_device("gpu:0")
    rng = np.random.default_rng(0)
    emb = SparseEmbedding(V, D, host=host, seed=1)
    tower = nn.Sequential(nn.Linear(S * D, 64), nn.ReLU(), nn.Linear(64, 1))
    tower.set_state_dict(tower_state)
    opt_dense = paddle.optimizer.Adam(learning_rate=1e-3,
                                      parameters=tower.parameters())
    opt_sparse = SparseAdam(emb, learning_rate=1e-2)
    prefetch = AsyncLookup(emb) if host else None

    def batch():
        ids = rng.integers(0, V, (B, S)).astype(np.int64)
        y = ((ids.sum(1) % 97) / 96.0).astype(np.float32)[:, None]
        return ids, y

    ids_np, y_np = batch()
    losses, times, waits, growth = [], [], [], 0
    for step in range(steps):
        torch.cuda.synchronize()
        t0 = time.time()
        ids_next, y_next = batch()
        if prefetch is not None:
            prefetch.prefetch(ids_next)
        out = emb(paddle.to_tensor(ids_np))
        pred = tower(paddle.reshape(out, [B, S * D]))
        loss = ((pred - paddle.to_tensor(y_np)) ** 2).mean()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        loss.backward()
        torch.cuda.synchronize()
        growth = max(growth, torch.cuda.max_memory_allocated() - base)
        opt_sparse.step(emb.sparse_grad())
        opt_dense.step()
        opt_dense.clear_grad()
        losses.append(float(loss))
        if prefetch is not None:
            w0 = time.time()
            prefetch.take()
            waits.append(time.time() - w0)
        times.append(time.time() - t0)
        ids_np, y_np = ids_next, y_next
    m = {"host": host, "losses": losses,
         "step_ms": float(np.median(times[1:])) * 1e3,
         "device_bytes": emb.device_bytes(),
         "table_bytes": V * D * 4, "backward_growth_bytes": growth}
    if host:
        gathers = []
        for _ in range(5):
            flat = batch()[0].reshape(-1)
            torch.cuda.synchronize()
            t0 = time.time()
            emb._gather(flat)
            torch.cuda.synchronize()
            gathers.append(time.time() - t0)
        g_ms = float(np.median(gathers)) * 1e3
        w_ms = float(np.median(waits[1:])) * 1e3
        m.update({"host_gather_ms": g_ms, "take_wait_ms": w_ms,
                  "hidden_share": max(0.0, 1.0 - w_ms / g_ms)})
    return m


def ps_rank(out, place="gpu:0", steps=3):
    """One rank of phase 49's vocab-sharded job: a host
    ``DistributedSparseEmbedding`` at the recsys vocabulary over the gloo
    group, lookups and pushes (SparseSGD) beside the whole table in this
    process (the single-process run), the gaps written to
    ``out/ps{rank}.json``."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.distributed.ps import (DistributedSparseEmbedding,
                                                 SparseEmbedding, SparseSGD,
                                                 distributed_push_sparse)
    V, D, S, B = (RECSYS[k] for k in ("vocab", "dim", "slots", "batch"))
    paddle.set_device(place)
    C.init_parallel_env(timeout=300)
    r = C.get_rank()
    table = DistributedSparseEmbedding(V, D, host=True, seed=1)
    whole = SparseEmbedding(V, D, host=True, seed=1)
    rng = np.random.default_rng(49)
    row_gap = 0.0
    for _ in range(steps):
        ids = paddle.to_tensor(rng.integers(0, V, (B, S)))
        got, want = table(ids), whole(ids)
        row_gap = max(row_gap, float((got._value - want._value).abs().max()))
        (got * got).sum().backward()
        distributed_push_sparse(table, SparseSGD(table.local, 0.1))
        (want * want).sum().backward()
        SparseSGD(whole, 0.1).step()
    full = table.weight_full()
    res = {"rank": r, "world": C.get_world_size(), "row_gap": row_gap,
           "table_gap": float(np.abs(full - whole.weight).max()),
           "shard_rows": table.shard, "rows_on": str(got._value.device)}
    with open(os.path.join(out, f"ps{r}.json"), "w") as f:
        json.dump(res, f)


def recsys_phase(tmp, place="gpu:0"):
    """Phase 49 (cell RS): ``examples/train_recsys.py`` on the card with a
    host and a device table, then its 2-rank vocab-sharded job."""
    import torch
    import paddle_tpu_torch as paddle
    import paddle_tpu_torch.nn as nn
    paddle.set_device("gpu:0")
    paddle.seed(SEED)
    S, D = RECSYS["slots"], RECSYS["dim"]
    tower = nn.Sequential(nn.Linear(S * D, 64), nn.ReLU(), nn.Linear(64, 1))
    state = {k: v.numpy().copy() for k, v in tower.state_dict().items()}
    runs = {h: recsys_run(h, state) for h in (True, False)}
    hm, dm = runs[True], runs[False]
    rel = max(abs(a - b) / abs(b) for a, b in zip(hm["losses"],
                                                   dm["losses"]))
    log(f"  host table: {json.dumps(hm)}")
    log(f"  device table: {json.dumps(dm)}")
    check(rel <= 1e-6, f"host and device tables' losses part by {rel}")
    check(hm["device_bytes"] == 0, f"host table on the card: "
          f"{hm['device_bytes']} bytes")
    check(dm["backward_growth_bytes"] < dm["table_bytes"] / 2,
          f"a backward grew memory by {dm['backward_growth_bytes']} bytes "
          f"(table {dm['table_bytes']}): a dense gradient?")
    check(hm["losses"][-1] < hm["losses"][0], f"recsys loss did not fall: "
          f"{hm['losses']}")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    rc, lines, secs = run_launcher(f"cs.ps_rank({tmp!r}, {place!r})\n",
                                   tmp, 2)
    check(rc == 0, f"sharded job rc {rc}: {lines[-5:]} "
          f"{worker_logs(tmp, 2)}")
    res = []
    for r in range(2):
        with open(os.path.join(tmp, f"ps{r}.json")) as f:
            res.append(json.load(f))
        log(f"  rank {r}: {json.dumps(res[-1])}")
        check((res[-1]["rank"], res[-1]["world"]) == (r, 2),
              f"rank {r}: {res[-1]}")
        check(res[-1]["row_gap"] <= 1e-6 and res[-1]["table_gap"] <= 1e-6,
              f"rank {r}: sharded rows / table part from the single-process "
              f"run by {res[-1]['row_gap']} / {res[-1]['table_gap']}")
    m = {"loss_rel_host_device": rel, "sharded_job_s": secs}
    log(f"  {json.dumps(m)}")
    return m


# ---------------------------------------------------------------------------
# phases 50-52: the captured step (jit), hapi's jit path, deployment
# ---------------------------------------------------------------------------

def _jit_fallbacks():
    from paddle_tpu_torch.jit import fallbacks
    return dict(fallbacks)


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


def captured_llama_phase(m45, batch=8, seq=2048, timed=4):
    """Phase 50 (a): phase 45's ``LlamaForCausalLM`` at F's configuration
    through ``make_train_step``: three eager steps from ``init_params``
    seed 0, then a fresh net from the same seed through the captured step
    on the same batches (an eager warm-up, the capture, a replay), then
    ``timed`` timed replays and a profiled one. Returns (metrics, the
    timed replays' launches)."""
    import torch
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.models.llama import LlamaForCausalLM
    paddle.set_device("gpu:0")
    cfg = train_config(torch.bfloat16, use_fused_norm=True)
    rng = np.random.default_rng(SEED + 50)
    ids = [torch.from_numpy(rng.integers(0, cfg.vocab_size, (batch, seq)))
           .cuda() for _ in range(3)]

    net = LlamaForCausalLM(cfg, seed=SEED)
    opt = paddle.optimizer.AdamW(1e-4, parameters=net.parameters())
    eager = []
    for b in ids:
        x = paddle.to_tensor(b)
        loss = net(x, x)
        loss.backward()
        opt.step()
        opt.clear_grad()
        eager.append(loss.item())
    del net, opt, loss
    torch.cuda.empty_cache()

    net = LlamaForCausalLM(cfg, seed=SEED)
    opt = paddle.optimizer.AdamW(1e-4, parameters=net.parameters())
    step = paddle.jit.make_train_step(net, opt, lambda loss: loss)
    check(step.donate, "the captured step does not donate on the card")
    captured, secs = [], []
    for b in ids:
        x = paddle.to_tensor(b)
        torch.cuda.synchronize()
        t0 = time.time()
        captured.append(step([x, x]).item())
        secs.append(time.time() - t0)
    rels = [_rel(c, e) for c, e in zip(captured, eager)]
    log(f"  (a) losses eager {eager}, captured {captured} (warm-up, "
        f"capture + replay, replay; {[round(s, 3) for s in secs]} s); rel "
        f"{rels}; bit-equal {[c == e for c, e in zip(captured, eager)]}")
    for r in rels:
        check(r <= 5e-3, f"captured F loss rel {r} from eager")

    x = paddle.to_tensor(ids[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    times = []
    for _ in range(timed):
        torch.cuda.synchronize()
        t0 = time.time()
        step([x, x]).item()
        times.append(time.time() - t0)
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    # a replay allocates nothing: the graph's pool is reserved memory
    reserved = torch.cuda.memory_reserved() / 2 ** 30
    per_step = {k: v / timed for k, v in counts.items() if v}
    want = expected_launches(cfg)
    check(per_step == want, f"captured F launches per step {per_step}, "
          f"expected {want}")
    step_ms = float(np.median(times)) * 1e3
    m = {"step_ms": step_ms, "step_ms_each": [t * 1e3 for t in times],
         "phase45_step_ms": m45["step_ms"],
         "tokens_per_s": batch * seq / step_ms * 1e3,
         "max_memory_allocated_gb": peak, "memory_reserved_gb": reserved,
         "phase45_max_memory_allocated_gb": m45["max_memory_allocated_gb"],
         "launches_per_step": per_step, "losses_eager": eager,
         "losses_captured": captured, "loss_rel": rels,
         "build_s": secs[1]}
    log(f"  (a) {json.dumps(m)}")
    m["profile"] = profile_device(lambda: step([x, x]).item(),
                                  "captured F step", top=10)
    check(m["profile"].get("graph_launch_calls", 0) >= 1,
          "the profiled captured step launched no CUDA graph")
    del step, net, opt
    torch.cuda.empty_cache()
    return m, counts


def _e_width_cfg():
    import torch
    return train_config(torch.float32, hidden_size=512,
                        intermediate_size=1376, num_hidden_layers=4,
                        num_attention_heads=8, num_key_value_heads=4,
                        use_fused_norm=True)


def captured_parity_phase(steps=4):
    """Phase 50 (b): E's width at fp32 with the kernels, captured against
    eager from the same weights: the loss and every gradient of a
    ``to_static`` forward-backward, AdamW steps under a ``StepDecay``
    scheduler stepped between replays, fresh dropout masks, the fused
    sentinel on a NaN batch and its cost. Returns the launches of the
    captured calls."""
    import torch
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.models.llama import LlamaForCausalLM
    cfg = _e_width_cfg()
    rng = np.random.default_rng(SEED + 51)
    ids = [torch.from_numpy(rng.integers(0, 32000, (2, 512))).cuda()
           for _ in range(steps)]
    xs = [paddle.to_tensor(b) for b in ids]

    # loss and gradients
    ref_net = LlamaForCausalLM(cfg, seed=SEED + 2)
    net = LlamaForCausalLM(cfg, seed=SEED + 2)

    @paddle.jit.to_static
    def fwd_bwd(x):
        loss = net(x, x)
        loss.backward()
        return loss

    reset_counts()
    for x in xs[:3]:             # warm-up, capture + replay, replay
        net.clear_gradients()
        loss = fwd_bwd(x)
    counts = read_counts()
    ref = ref_net(xs[2], xs[2])
    ref.backward()
    rel = _rel(loss.item(), ref.item())
    worst = max(((p.grad._value - q.grad._value).abs().max()
                 / q.grad._value.abs().max()).item()
                for p, q in zip(net.parameters(), ref_net.parameters()))
    log(f"  (b) to_static loss {loss.item()} vs eager {ref.item()} (rel "
        f"{rel}); gradients {worst} x max|g|")
    check(rel <= 1e-5, f"captured fp32 loss rel {rel}")
    check(worst <= 1e-4, f"captured fp32 gradient {worst} x max|g|")
    del ref_net, net, fwd_bwd
    torch.cuda.empty_cache()

    # AdamW under a scheduler stepped between replays
    nets, losses = [], {}
    for compiled in (False, True):
        n = LlamaForCausalLM(cfg, seed=SEED + 2)
        sched = paddle.optimizer.lr.StepDecay(1e-3, step_size=1, gamma=0.5)
        opt = paddle.optimizer.AdamW(sched, parameters=n.parameters(),
                                     weight_decay=0.01)
        step = paddle.jit.make_train_step(n, opt, lambda l: l)
        out = []
        for x in xs:
            if compiled:
                out.append(step([x, x]).item())
            else:
                l = n(x, x)
                l.backward()
                opt.step()
                opt.clear_grad()
                out.append(l.item())
            sched.step()
        losses[compiled] = out
        nets.append(n)
    loss_rel = max(_rel(a, b) for a, b in zip(losses[True], losses[False]))
    w_gap = max(((p._value - q._value).abs().max()
                 / q._value.abs().max()).item()
                for p, q in zip(nets[1].parameters(), nets[0].parameters()))
    log(f"  (b) AdamW, StepDecay between replays: losses eager "
        f"{losses[False]}, captured {losses[True]} (worst rel {loss_rel}); "
        f"weights {w_gap} x max|p| from eager's")
    check(loss_rel <= 1e-5, f"captured AdamW losses rel {loss_rel}")
    check(w_gap <= 1e-5, f"captured AdamW weights {w_gap} x max|p|")
    del nets, step, opt
    torch.cuda.empty_cache()

    # dropout draws fresh masks on every replay
    drop = paddle.nn.Dropout(0.5)
    f = paddle.jit.to_static(lambda x: drop(x))
    ones = paddle.to_tensor(torch.ones(8, 1024, device="cuda"))
    masks = [f(ones).numpy() for _ in range(4)]
    check(not np.array_equal(masks[2], masks[3]),
          "two replays drew the same dropout mask")
    check(all(abs((m != 0).mean() - 0.5) < 0.05 for m in masks),
          "dropout keep rate off 0.5")

    # the fused sentinel: a NaN batch (an out-of-vocab id embeds as NaN)
    def guarded(sentinel):
        n = LlamaForCausalLM(cfg, seed=SEED + 3)
        opt = paddle.optimizer.AdamW(1e-3, parameters=n.parameters())
        return n, opt, paddle.jit.make_train_step(n, opt, lambda l: l,
                                                  sentinel=sentinel)

    net, opt, step = guarded(True)
    for x in xs[:3]:
        step([x, x])
    check(not step.sentinel.last_bad, "the sentinel flagged a clean step")
    before = [t._value.clone() for t in
              paddle.health.health_state_tensors(net, opt)]
    bad_ids = ids[3].clone()
    bad_ids[0, 0] = cfg.vocab_size
    loss = step([paddle.to_tensor(bad_ids), xs[3]]).item()
    after = paddle.health.health_state_tensors(net, opt)
    intact = all(torch.equal(a._value, b) for a, b in zip(after, before))
    log(f"  (b) sentinel: NaN batch loss {loss}, last_bad "
        f"{step.sentinel.last_bad}, {len(before)} state tensors bit-"
        f"unchanged: {intact}")
    check(not np.isfinite(loss) and step.sentinel.last_bad,
          "the sentinel missed the NaN batch")
    check(intact, "a skipped step changed the state")
    check(np.isfinite(step([xs[3], xs[3]]).item())
          and not step.sentinel.last_bad, "no recovery after the NaN batch")

    def replay_ms(st):
        t = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.time()
            st([xs[0], xs[0]]).item()
            t.append(time.time() - t0)
        return float(np.median(t)) * 1e3

    on = replay_ms(step)
    del net, opt, step
    torch.cuda.empty_cache()
    net, opt, plain = guarded(False)
    for x in xs[:2]:
        plain([x, x])
    off = replay_ms(plain)
    log(f"  (b) sentinel cost: {on:.3f} ms a step guarded, {off:.3f} ms "
        f"unguarded ({on - off:.3f} ms)")
    del net, opt, plain
    torch.cuda.empty_cache()
    return counts, {"sentinel_ms": on, "unguarded_ms": off}


def captured_control_flow_phase():
    """Phase 50 (c): on CUDA tensors against eager — a tensor ``if``
    (dy2static), a ``return`` inside a tensor branch (SOT) and a tensor
    ``while_loop``, each over inputs that take every path."""
    import torch
    import paddle_tpu_torch as paddle

    @paddle.jit.to_static
    def branch(x):
        if x.mean() > 0:
            y = x * 2.0
        else:
            y = x - 1.0
        return y.sum()

    def early(x):
        if x.mean() > 0:
            return x * 2.0
        return x - 1.0

    sot = paddle.jit.to_static(early, backend="sot")

    @paddle.jit.to_static
    def grow(x):
        n, s = paddle.jit.while_loop(
            lambda n, s: s.sum() < 100.0, lambda n, s: (n + 1, s * 2.0),
            [paddle.to_tensor(torch.zeros((), dtype=torch.int64,
                                          device="cuda")), x.abs() + 1.0])
        return n, s

    rng = np.random.default_rng(SEED + 52)
    trips = set()
    for i in range(6):
        a = rng.standard_normal(16).astype(np.float32) * (i + 1)
        if i % 2:
            a = -np.abs(a)
        x = paddle.to_tensor(torch.from_numpy(a).cuda())
        want = (a * 2.0 if a.mean() > 0 else a - 1.0)
        check(abs(branch(x).item() - want.sum()) <= 1e-5 * abs(want.sum())
              + 1e-6, f"dy2static branch on {a.mean()}")
        check(np.allclose(sot(x).numpy(), want, rtol=1e-6),
              "SOT return branch")
        n, s = grow(x)
        z, k = np.abs(a) + 1.0, 0
        while z.sum() < 100.0:
            z, k = z * 2.0, k + 1
        check(int(n.item()) == k and np.allclose(s.numpy(), z, rtol=1e-6),
              f"while_loop: {int(n.item())} trips, eager {k}")
        trips.add(k)
    check(branch._ast_fn is not None, "the dy2static rewrite did not engage")
    entry = next(iter(sot._entries.values()))[0]
    check(len(entry.paths) == 2, f"SOT paths {len(entry.paths)}")
    log(f"  (c) dy2static if, SOT return branch (2 paths), tensor "
        f"while_loop (trips {sorted(trips)}) equal eager on CUDA tensors")


def captured_phase(m45):
    """Phase 50: (a)-(c); prints the eager fallbacks the reference itself
    takes. Returns (a)'s metrics and launches, (b)'s launches."""
    import torch
    f0 = _jit_fallbacks()
    t0 = time.time()
    m, c_a = captured_llama_phase(m45)
    log(f"  (a) {time.time() - t0:.1f} s")
    t0 = time.time()
    c_b, sent = captured_parity_phase()
    m["sentinel"] = sent
    log(f"  (b) {time.time() - t0:.1f} s")
    t0 = time.time()
    captured_control_flow_phase()
    log(f"  (c) {time.time() - t0:.1f} s")
    f1 = _jit_fallbacks()
    log(f"  eager fallbacks the reference also takes (GradScaler, "
        f"enable_to_static(False), SOT graph break, nested to_static): "
        f"{json.dumps({k: f1[k] - f0[k] for k in f1})}")
    torch.cuda.empty_cache()
    return m, c_a, c_b


def bert_jit_phase(m47, steps=6, batch=BERT_BATCH, seq=BERT_SEQ):
    """Phase 51 (cell BT through the captured step): phase 47's loop with
    ``prepare(..., jit=True)``, then a dropout-0 run against the eager
    ``train_batch`` from the same weights. Returns (metrics, the
    fine-tuned network, the dropout-0 run's launches)."""
    import torch
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.models.bert import (BertConfig,
                                              BertForSequenceClassification)
    paddle.set_device("gpu:0")
    paddle.seed(SEED)
    cfg = BertConfig()
    net = BertForSequenceClassification(cfg, num_classes=2)
    model = _bert_model(paddle, net, amp_configs="O1", jit=True)
    n_train = (steps + 2) * batch
    ids, labels = bert_data(cfg, n_train, seq, SEED)
    train = paddle.io.TensorDataset([ids, labels])

    class Clock(paddle.callbacks.Callback):
        """Batch ends after the warm-up and the capture."""

        def __init__(self):
            super().__init__()
            self.ends, self.losses = [], []

        def on_train_batch_begin(self, step, logs=None):
            if step == 2:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                self.ends.append(time.time())

        def on_train_batch_end(self, step, logs=None):
            self.losses.append(logs["loss"])
            if step >= 2:
                self.ends.append(time.time())

    clock = Clock()
    model.fit(train, batch_size=batch, epochs=1, verbose=0, shuffle=True,
              callbacks=[clock])
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    reserved = torch.cuda.memory_reserved() / 2 ** 30
    times = np.diff(clock.ends)
    check(len(times) == steps, f"timed {len(times)} steps, not {steps}")
    check(all(np.isfinite(clock.losses)), f"losses {clock.losses}")
    step_ms = float(np.median(times)) * 1e3
    flops = bert_flops_per_step(cfg, batch, seq)
    m = {"step_ms": step_ms, "step_ms_each": [t * 1e3 for t in times],
         "phase47_step_ms": m47["step_ms"], "memory_reserved_gb": reserved,
         "samples_per_s": batch / step_ms * 1e3,
         "phase47_samples_per_s": m47["samples_per_s"],
         "mfu": flops / (step_ms / 1e3) / PEAK_FLOPS["bf16"],
         "phase47_mfu": m47["mfu"], "max_memory_allocated_gb": peak,
         "phase47_max_memory_allocated_gb": m47["max_memory_allocated_gb"],
         "losses": clock.losses}
    log(f"  fit (jit): {json.dumps(m)}")
    xb = torch.from_numpy(ids[:batch]).cuda()
    yb = torch.from_numpy(labels[:batch]).cuda()
    # the fit's batches came through the loader: the same program
    m["profile"] = profile_device(lambda: model.train_batch([xb], [yb]),
                                  "BERT-base captured fit step (O1)", top=8)
    p47 = m47["profile"]
    log(f"  beside phase 47: busy share {m['profile']['device_busy_share']}"
        f" (eager {p47['device_busy_share']}), launch calls "
        f"{m['profile']['launch_calls']} + {m['profile']['graph_launch_calls']}"
        f" graph launches (eager {p47['launch_calls']})")
    del model

    # dropout 0: the captured train_batch against the eager one
    cfg0 = BertConfig(hidden_dropout_prob=0.0,
                      attention_probs_dropout_prob=0.0)
    runs = {}
    reset_counts()
    for jit in (False, True):
        paddle.seed(SEED + 1)
        n0 = BertForSequenceClassification(cfg0, num_classes=2)
        mod = _bert_model(paddle, n0, amp_configs="O1", jit=jit)
        runs[jit] = [mod.train_batch([torch.from_numpy(ids[i:i + batch])
                                      .cuda()],
                                     [torch.from_numpy(labels[i:i + batch])
                                      .cuda().reshape(-1, 1)])
                     for i in range(0, 3 * batch, batch)]
        if not jit:
            reset_counts()
        del mod, n0
    counts = read_counts()
    rels = [_rel(a[0][0], b[0][0]) for a, b in zip(runs[True], runs[False])]
    same = [a[1] == b[1] for a, b in zip(runs[True], runs[False])]
    log(f"  dropout 0: captured {runs[True]}, eager {runs[False]}; loss rel "
        f"{rels}; metrics equal {same}; captured launches "
        f"{json.dumps({k: v for k, v in counts.items() if v})}")
    for r in rels:
        check(r <= 5e-3, f"captured BERT loss rel {r}")
    check(all(same), "captured BERT metrics differ from eager's")
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    return m, net, counts


def deploy_phase(net, batches=4, batch=BERT_BATCH, seq=BERT_SEQ, small=8):
    """Phase 52: ``Model.save(training=False)`` of the fine-tuned BERT
    (fp32), the network dropped, ``create_predictor`` serving ``batches``
    batches through the handles and one of ``small`` rows; then the same
    for its ``quantize_linears`` network. Returns the predictors'
    launches."""
    import torch
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import inference
    from paddle_tpu_torch.models.bert import (BertConfig,
                                              BertForSequenceClassification)
    layers = BertConfig().num_hidden_layers
    ids, _ = bert_data(BertConfig(), batches * batch, seq, SEED + 52)
    feeds = [ids[i * batch:(i + 1) * batch] for i in range(batches)]
    feeds.append(ids[:small])
    spec = [paddle.jit.InputSpec([None, seq], "int64", "input_ids")]
    sd = {k: v.numpy() for k, v in net.state_dict().items()}
    total = {}

    def eager_logits(n, profile=False):
        n.eval()
        with paddle.no_grad():
            outs = [n(paddle.to_tensor(torch.from_numpy(f).cuda())).numpy()
                    for f in feeds]
        t = []
        x = paddle.to_tensor(torch.from_numpy(feeds[0]).cuda())
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.time()
            with paddle.no_grad():
                n(x).numpy()
            t.append(time.time() - t0)
        if profile:
            with paddle.no_grad():
                profile_device(lambda: n(x).numpy(),
                               "eager fp32 BERT-base forward", top=6)
        return outs, float(np.median(t)) * 1e3

    def serve(path, want, per_batch, label):
        pred = inference.create_predictor(inference.Config(
            path + ".pdmodel", path + ".pdiparams"))
        name = pred.get_input_names()[0]
        outs, t = [], []
        for i, f in enumerate(feeds):
            if i == batches:
                c = read_counts()
            h = pred.get_input_handle(name)
            h.reshape(f.shape)
            h.copy_from_cpu(f)
            torch.cuda.synchronize()
            t0 = time.time()
            pred.run()
            outs.append(pred.get_output_handle(
                pred.get_output_names()[0]).copy_to_cpu())
            t.append(time.time() - t0)
        got = {k: v / batches for k, v in c.items() if v}
        if label == "fp32":
            profile_device(pred.run, "fp32 predictor batch", top=6)
        scale = max(float(np.abs(w).max()) for w in want)
        gap = max(float(np.abs(o - w).max()) for o, w in zip(outs, want))
        for k, v in per_batch.items():
            check(got.get(k) == v, f"{label} predictor: {got.get(k)} {k} "
                  f"launches a batch, expected {v}")
        check(gap <= 1e-4 * scale, f"{label} predictor logits {gap} > 1e-4 "
              f"x {scale}")
        check(outs[-1].shape == (small, 2), f"{label} at batch {small}")
        for k, v in read_counts().items():
            total[k] = total.get(k, 0) + v
        return {"launches_per_batch": got, "logit_gap": gap / scale,
                "predictor_ms": float(np.median(t[1:batches])) * 1e3}

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        want, eager_ms = eager_logits(net, profile=True)
        path = os.path.join(tmp, "bert")
        t0 = time.time()
        paddle.Model(net, inputs=spec).save(path, training=False)
        export_s = time.time() - t0
        del net
        torch.cuda.empty_cache()
        reset_counts()
        out["fp32"] = serve(path, want, {"flash_attention": layers}, "fp32")
        out["fp32"].update({"export_s": export_s, "eager_ms": eager_ms})
        log(f"  fp32: {json.dumps(out['fp32'])}")

        qnet = BertForSequenceClassification(BertConfig(), num_classes=2)
        qnet.set_state_dict(sd)
        swapped = paddle.nn.quant.quantize_linears(qnet)
        check(swapped == 6 * layers + 2, f"quantize_linears {swapped}")
        want, eager_ms = eager_logits(qnet)
        qpath = os.path.join(tmp, "bert_int8")
        t0 = time.time()
        paddle.Model(qnet, inputs=spec).save(qpath, training=False)
        export_s = time.time() - t0
        del qnet
        torch.cuda.empty_cache()
        reset_counts()
        out["int8"] = serve(qpath, want,
                            {"flash_attention": layers,
                             "weight_only_matmul": 6 * layers + 2}, "int8")
        out["int8"].update({"export_s": export_s, "eager_ms": eager_ms})
        log(f"  int8: {json.dumps(out['int8'])}")
    torch.cuda.empty_cache()
    return out, total


# phases 53-55: vision (cells RN and DT) — conv, pooling and the layout
# pass reach cuDNN through torch.nn.functional; no port kernel runs

RN_BATCH, RN_IMAGE = 32, 224
DT_BATCH, DT_IMAGE, DT_CLASSES = 8, 320, 80


def conv_linear_macs(net, *inputs):
    """Multiply-adds of one eval forward of ``net`` on ``inputs``, from the
    output shape of every Conv and Linear layer (forward post-hooks): a
    conv output element costs (in_channels / groups) x prod(kernel), a
    transposed conv's input element (out_channels / groups) x
    prod(kernel), a Linear output element in_features."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.nn.layers.conv import _ConvNd
    total = [0]

    def numel(t):
        return int(np.prod(t.shape))

    def hook(layer, ins, out):
        if isinstance(layer, _ConvNd):
            k = int(np.prod(layer.kernel_size))
            if layer._transpose:
                total[0] += numel(ins[0]) * layer.out_channels // \
                    layer.groups * k
            else:
                total[0] += numel(out) * layer.in_channels // \
                    layer.groups * k
        else:
            total[0] += numel(out) * layer.in_features

    handles = [l.register_forward_post_hook(hook)
               for l in net.sublayers(include_self=True)
               if isinstance(l, (_ConvNd, paddle.nn.Linear))]
    was_training = net.training
    net.eval()
    try:
        with paddle.no_grad():
            net(*inputs)
    finally:
        for h in handles:
            h.remove()
        if was_training:
            net.train()
    return total[0]


def _vision_counts_zero(counts, phase):
    launched = {k: v for k, v in counts.items() if v}
    check(not launched, f"phase {phase} launched port kernels {launched}")


def _snapshot(net):
    return {k: v._value.detach().clone() for k, v in net.state_dict().items()}


def _eager_vs_captured(make_net, opt_fn, loss_fn, batches):
    """Three eager steps on one net, then a fresh net from the same weights
    through ``make_train_step`` on the same batches (an eager warm-up, the
    capture and a replay). Returns (eager losses, captured losses, the
    captured step's seconds, the step, its net, and the peak memory
    allocated over the eager steps and over the captured ones: a replay
    allocates nothing, its activations live in the graph's pool)."""
    import torch
    import paddle_tpu_torch as paddle
    net = make_net()
    opt = opt_fn(net)
    eager = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for ins, labs in batches:
        net.train()
        with paddle.amp.auto_cast():
            out = net(*ins)
            outs = list(out) if isinstance(out, (list, tuple)) else [out]
            loss = loss_fn(*outs, *labs)
        loss.backward()
        opt.step()
        opt.clear_grad()
        eager.append(loss.item())
    peaks = {"eager_peak_gb": torch.cuda.max_memory_allocated() / 2 ** 30}
    del net, opt, loss, out, outs
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    net = make_net()
    step = paddle.jit.make_train_step(net, opt_fn(net), loss_fn, amp=True)
    check(step.donate, "the captured step does not donate on the card")
    captured, secs = [], []
    for ins, labs in batches:
        torch.cuda.synchronize()
        t0 = time.time()
        captured.append(step(ins, labs).item())
        secs.append(time.time() - t0)
    peaks["capture_peak_gb"] = torch.cuda.max_memory_allocated() / 2 ** 30
    return eager, captured, secs, step, net, peaks


def _timed_replays(step, ins, labs, timed, label, flops_per_step,
                   batch):
    """``timed`` replays (host clock to ``loss.item()``), peak memory, MFU
    over the bf16 peak, one profiled replay (with its copy kernels)."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(timed):
        torch.cuda.synchronize()
        t0 = time.time()
        step(ins, labs).item()
        times.append(time.time() - t0)
    step_ms = float(np.median(times)) * 1e3
    m = {"step_ms": step_ms, "step_ms_each": [t * 1e3 for t in times],
         "images_per_s": batch / step_ms * 1e3,
         "flops_per_step": flops_per_step,
         "mfu": flops_per_step / (step_ms / 1e3) / PEAK_FLOPS["bf16"],
         "max_memory_allocated_gb":
             torch.cuda.max_memory_allocated() / 2 ** 30,
         "memory_reserved_gb": torch.cuda.memory_reserved() / 2 ** 30}
    m["profile"] = profile_device(lambda: step(ins, labs).item(), label,
                                  top=8)
    check(m["profile"].get("graph_launch_calls", 0) >= 1,
          f"the profiled {label} launched no CUDA graph")
    return m


def resnet_phase(timed=8, batch=RN_BATCH, image=RN_IMAGE, loader_steps=8):
    """Phase 53 (cell RN): ``bench.py:bench_resnet`` in the port —
    ResNet-50 (1000 classes, random weights from ``paddle.seed(0)``),
    ``Momentum(0.1, 0.9)``, ``CrossEntropyLoss``, ``make_train_step(...,
    amp=True)`` at B 32 x 3 x 224 x 224, NCHW and under ChannelsLast from
    the same weights; then ``examples/train_resnet.py``'s loop (the
    FakeImageDataset through the DataLoader's two workers). Returns its
    metrics."""
    import torch
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.vision.models import resnet50
    paddle.set_device("gpu:0")
    reset_counts()
    paddle.seed(0)
    sd = _snapshot(resnet50(num_classes=1000))
    macs = conv_linear_macs(resnet50(num_classes=1000), paddle.to_tensor(
        np.zeros((1, 3, image, image), np.float32)))
    log(f"  ResNet-50 forward at {image}^2: {macs / 1e9:.4f} G multiply-"
        f"adds an image (published: ~4.1 G)")
    check(image != 224 or abs(macs / 4.1e9 - 1) < 0.05,
          f"ResNet-50 MACs {macs}")
    flops = 3 * 2 * macs * batch       # forward + backward (2x), 2 a MAC
    rng = np.random.default_rng(SEED + 53)
    batches = [([paddle.to_tensor(torch.from_numpy(rng.standard_normal(
        (batch, 3, image, image)).astype(np.float32)).cuda())],
        [paddle.to_tensor(torch.from_numpy(rng.integers(
            0, 1000, (batch,))).cuda())]) for _ in range(3)]
    in_mb = batch * 3 * image * image * 4 / 1e6

    def opt_fn(net):
        return paddle.optimizer.Momentum(0.1, momentum=0.9,
                                         parameters=net.parameters())

    loss_fn = paddle.nn.CrossEntropyLoss()
    out = {"input_batch_mb": in_mb}
    steps = {}
    for layout in ("nchw", "channels_last"):
        def make_net():
            net = resnet50(num_classes=1000)
            net.set_state_dict(sd)
            return paddle.nn.ChannelsLast(net) if layout != "nchw" else net
        eager, captured, secs, step, net, peaks = _eager_vs_captured(
            make_net, opt_fn, loss_fn, batches)
        rels = [_rel(c, e) for c, e in zip(captured, eager)]
        log(f"  {layout}: losses eager {eager}, captured {captured} "
            f"(warm-up, capture + replay, replay; "
            f"{[round(t, 3) for t in secs]} s); rel {rels}; bit-equal "
            f"{[c == e for c, e in zip(captured, eager)]}")
        # the gate: the warm-up and the first captured loss (the third
        # step's follows two Momentum updates at lr 0.1 and is printed)
        for r in rels[:2]:
            check(r <= 5e-3, f"{layout} captured loss rel {r} from eager")
        m = _timed_replays(step, *batches[0], timed,
                           f"ResNet-50 {layout} step", flops, batch)
        m.update(losses_eager=eager, losses_captured=captured,
                 loss_rel=rels, capture_s=secs[1], **peaks)
        log(f"  {layout}: {json.dumps(m)}")
        log(f"  {layout}: input batch {in_mb:.1f} MB beside peak "
            f"{peaks['capture_peak_gb']:.2f} GiB allocated over the "
            f"capture ({peaks['eager_peak_gb']:.2f} GiB eager, "
            f"{m['memory_reserved_gb']:.2f} GiB reserved while replaying)")
        out[layout] = m
        steps[layout] = (step, net)
        if layout == "nchw":
            del step, net
            steps.pop(layout)
            torch.cuda.empty_cache()
    first = out["nchw"]["losses_captured"][0]
    cl = out["channels_last"]["losses_captured"][0]
    check(_rel(cl, first) <= 5e-3, f"ChannelsLast loss {cl} against NCHW "
          f"{first}")
    out["channels_last_vs_nchw"] = {
        "step_ms": [out["channels_last"]["step_ms"], out["nchw"]["step_ms"]],
        "copy_kernel_calls": [out["channels_last"]["profile"].get(
            "copy_kernel_calls"), out["nchw"]["profile"].get(
            "copy_kernel_calls")],
        "first_loss_rel": _rel(cl, first)}
    log(f"  ChannelsLast against NCHW: {json.dumps(out['channels_last_vs_nchw'])}")

    # examples/train_resnet.py's loop: the DataLoader's workers feed the
    # captured ChannelsLast step
    step, _ = steps["channels_last"]
    ds = paddle.vision.datasets.FakeImageDataset(
        (loader_steps + 2) * batch, (3, image, image), 1000)
    loader = paddle.io.DataLoader(ds, batch_size=batch, num_workers=2,
                                  use_shared_memory=True)
    it = paddle.io.prefetch_to_device(loader)
    waits, times, losses = [], [], []
    t_loop = time.time()
    for i in range(loader_steps + 1):
        t0 = time.time()
        x, y = next(it)
        t1 = time.time()
        losses.append(step([x], [y]).item())
        t2 = time.time()
        if i:                               # the first batch starts workers
            waits.append((t1 - t0) * 1e3)
            times.append((t2 - t1) * 1e3)
    del it, loader
    loop = {"data_wait_ms_per_step": float(np.mean(waits)),
            "data_wait_ms_each": waits,
            "step_ms_per_step": float(np.mean(times)),
            "images_per_s_with_loader": batch * loader_steps /
            (sum(waits) + sum(times)) * 1e3,
            "loop_s": time.time() - t_loop, "losses": losses}
    check(all(np.isfinite(losses)), f"loader losses {losses}")
    log(f"  train_resnet.py loop (2 workers, shared memory): "
        f"{json.dumps(loop)}")
    out["loader"] = loop
    del steps, step
    torch.cuda.empty_cache()
    _vision_counts_zero(read_counts(), 53)
    return out


def _max_rel(got, want):
    got = got.detach().float().cpu().numpy() if hasattr(got, "detach") \
        else np.asarray(got)
    want = want.detach().float().cpu().numpy() if hasattr(want, "detach") \
        else np.asarray(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def vision_parity_phase():
    """Phase 54: fp32 vision on the card against the CPU (TF32 off):
    ResNet-18's loss, gradients and running statistics, NHWC against
    NCHW, three captured Momentum steps (in fp64 and fp32); the conv and
    pooling routes."""
    import torch
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.vision.models import resnet18
    F = paddle.nn.functional
    reset_counts()
    rng = np.random.default_rng(SEED + 54)
    paddle.set_device("cpu")
    paddle.seed(54)
    sd = {k: v.numpy() for k, v in resnet18(num_classes=10).state_dict()
          .items()}
    x = rng.standard_normal((4, 3, 32, 32)).astype(np.float32)
    y = rng.integers(0, 10, (4,)).astype(np.int64)
    res = {}
    for place, layout in (("cpu", "nchw"), ("gpu:0", "nchw"),
                          ("gpu:0", "nhwc")):
        paddle.set_device(place)
        net = resnet18(num_classes=10)
        net.set_state_dict(sd)
        m = paddle.nn.ChannelsLast(net) if layout == "nhwc" else net
        m.train()
        loss = paddle.nn.CrossEntropyLoss()(m(paddle.to_tensor(x)),
                                            paddle.to_tensor(y))
        loss.backward()
        res[(place, layout)] = (
            loss.item(),
            {n: p.grad.numpy() for n, p in net.named_parameters()},
            {k: v.numpy() for k, v in net.state_dict().items()
             if k.endswith(("_mean", "_variance"))})
    ref = res[("cpu", "nchw")]
    worst = {}
    for key in (("gpu:0", "nchw"), ("gpu:0", "nhwc")):
        got = res[key]
        rel = _rel(got[0], ref[0])
        g = max(_max_rel(got[1][k], ref[1][k]) for k in ref[1])
        st = max(float(np.abs(got[2][k] - ref[2][k]).max()) for k in ref[2])
        worst[key[1]] = {"loss_rel": rel, "grad_worst_of_max": g,
                         "running_stats_max_abs": st}
    # three captured Momentum steps at lr 1e-3 (the CPU tests' value) on
    # three batches of 32 (at B 4 the net is ill-conditioned in fp32: the
    # CPU tests' docstring, tests/test_torch_vision_models.py). The gate
    # runs them in fp64, where the card and the CPU compute the same steps
    # to rounding: every loss, and after the steps every parameter and
    # running statistic, within 1e-10 of the CPU's. In fp32 the program
    # does not decide the trajectory to 1e-4: a ReLU whose input lies
    # within the fp32 forward error of 0 may fall on the other side on the
    # card, and BatchNorm over layer4's 1 x 1 maps spreads that one
    # gradient over its channel's whole batch. The fp32 run is held to
    # what fp32 decides (its first loss, and every layer's forward output
    # against the fp64 run's, which a TF32 or other reduced-precision
    # kernel would miss by ~1e-3); its three losses and its ReLU sign
    # flips against fp64 are printed.
    batches = [(rng.standard_normal((32, 3, 32, 32)).astype(np.float32),
                rng.integers(0, 10, (32,)).astype(np.int64))
               for _ in range(3)]

    def on(place, layout, dtype, fn):
        paddle.set_device(place)
        prev = paddle.get_default_dtype()
        paddle.set_default_dtype(dtype)
        try:
            net = resnet18(num_classes=10)
            net.set_state_dict({k: v.astype(dtype) for k, v in sd.items()})
            return fn(net, paddle.nn.ChannelsLast(net) if layout == "nhwc"
                      else net, layout, dtype)
        finally:
            paddle.set_default_dtype(prev)

    def trajectory(net, m, layout, dtype):
        step = paddle.jit.make_train_step(
            m, paddle.optimizer.Momentum(1e-3, momentum=0.9,
                                         parameters=m.parameters()),
            paddle.nn.CrossEntropyLoss())
        losses = [step(paddle.to_tensor(a.astype(dtype)),
                       paddle.to_tensor(b)).item() for a, b in batches]
        return losses, {k: v.numpy().astype(np.float64)
                        for k, v in net.state_dict().items()}

    def forward(net, m, layout, dtype):
        """Every leaf layer's output (NCHW) and every ReLU's input of a
        train-mode forward on the first batch, in call order."""
        outs, relu_in = [], []

        def nchw(t):
            v = t._value.detach()
            if layout == "nhwc" and v.dim() == 4:
                v = v.permute(0, 3, 1, 2)
            return v.double().cpu().numpy()

        def hook(layer, ins, out):
            outs.append(nchw(out))
            if isinstance(layer, paddle.nn.ReLU):
                relu_in.append(nchw(ins[0]))

        for _, sub in net.named_sublayers():
            if not sub.sublayers():
                sub.register_forward_post_hook(hook)
        m.train()
        m(paddle.to_tensor(batches[0][0].astype(dtype)))
        return outs, relu_in

    runs = (("cpu", "nchw"), ("gpu:0", "nchw"), ("gpu:0", "nhwc"))
    traj = {(p, l, d): on(p, l, d, trajectory) for d in ("float64", "float32")
            for p, l in runs}
    fwd = {(p, l, d): on(p, l, d, forward) for p, l, d in (
        ("cpu", "nchw", "float64"), ("gpu:0", "nchw", "float32"),
        ("gpu:0", "nhwc", "float32"))}
    ref64, ref32 = traj[("cpu", "nchw", "float64")], \
        traj[("cpu", "nchw", "float32")]
    ref_out, ref_relu = fwd[("cpu", "nchw", "float64")]
    for place, layout in runs[1:]:
        w = worst[layout]
        losses, state = traj[(place, layout, "float64")]
        w["fp64_three_step_loss_rel"] = [_rel(a, b)
                                         for a, b in zip(losses, ref64[0])]
        w["fp64_state_after_worst_of_max"] = max(
            _max_rel(state[k], ref64[1][k]) for k in ref64[1])
        losses32 = traj[(place, layout, "float32")][0]
        w["fp32_three_step_loss_rel"] = [_rel(a, b)
                                         for a, b in zip(losses32, ref32[0])]
        w["fp32_three_step_loss_rel_to_fp64"] = [
            _rel(a, b) for a, b in zip(losses32, ref64[0])]
        outs, relu_in = fwd[(place, layout, "float32")]
        w["fp32_forward_worst_of_max"] = max(
            _max_rel(a, b) for a, b in zip(outs, ref_out))
        flips = []
        for i, (z, z64) in enumerate(zip(relu_in, ref_relu)):
            bad = np.argwhere((z > 0) != (z64 > 0))
            flips += [{"relu_call": i, "at": e.tolist(),
                       "fp64_input_of_max": float(z64[tuple(e)] /
                                                  np.abs(z64).max()),
                       "fp32_input_of_max": float(z[tuple(e)] /
                                                  np.abs(z64).max())}
                      for e in bad]
        w["fp32_relu_sign_flips"] = flips
    worst["nhwc"]["fp64_three_step_loss_rel_to_nchw"] = [
        _rel(a, b) for a, b in zip(traj[("gpu:0", "nhwc", "float64")][0],
                                   traj[("gpu:0", "nchw", "float64")][0])]
    log(f"  ResNet-18 card against CPU (fp32; three steps also fp64): "
        f"{json.dumps(worst)}")
    for layout, w in worst.items():
        check(w["loss_rel"] <= 1e-5, f"ResNet-18 {layout} loss {w}")
        check(w["grad_worst_of_max"] <= 1e-3, f"ResNet-18 {layout} grad {w}")
        check(w["running_stats_max_abs"] <= 1e-5,
              f"ResNet-18 {layout} running stats {w}")
        check(max(w["fp64_three_step_loss_rel"]) <= 1e-10,
              f"ResNet-18 {layout} three fp64 steps {w}")
        check(w["fp64_state_after_worst_of_max"] <= 1e-10,
              f"ResNet-18 {layout} state after three fp64 steps {w}")
        check(w["fp32_three_step_loss_rel"][0] <= 1e-5,
              f"ResNet-18 {layout} first fp32 step's loss {w}")
        check(w["fp32_forward_worst_of_max"] <= 1e-4,
              f"ResNet-18 {layout} fp32 forward against fp64 {w}")
    check(max(worst["nhwc"]["fp64_three_step_loss_rel_to_nchw"]) <= 1e-10,
          f"ResNet-18 NHWC against NCHW, three fp64 steps {worst['nhwc']}")

    # the conv and pooling routes, card against CPU, with gradients
    def both(fn, arrays, **kw):
        outs = []
        for place in ("cpu", "gpu:0"):
            paddle.set_device(place)
            ts = [paddle.to_tensor(a, stop_gradient=False) for a in arrays]
            out = fn(*ts, **kw)
            res = out if isinstance(out, tuple) else (out,)
            r = np.random.default_rng(1).standard_normal(
                res[0].shape).astype(np.float32)
            fin = np.isfinite(res[0].numpy())
            (res[0] * paddle.to_tensor(np.where(fin, r, 0).astype(
                np.float32))).sum().backward()
            outs.append([o.numpy() for o in res] +
                        [t.grad.numpy() for t in ts])
        errs = []
        for a, b in zip(*outs):
            if a.dtype.kind in "iu":
                check(np.array_equal(a, b), f"{fn.__name__} {kw} indices")
                errs.append(0.0)
                continue
            fin = np.isfinite(a)
            check(np.array_equal(fin, np.isfinite(b)), f"{fn.__name__} inf")
            errs.append(_max_rel(b[fin], a[fin]) if fin.any() else 0.0)
        check(max(errs) <= 1e-5, f"{fn.__name__} {kw}: {errs}")
        return max(errs)

    def xs(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    cases = {
        "conv2d groups 2 dilation 2 SAME stride 2": both(
            F.conv2d, [xs(2, 8, 17, 19), xs(12, 4, 3, 3), xs(12)], stride=2,
            padding="SAME", dilation=2, groups=2),
        "conv2d asymmetric pads stride 2": both(
            F.conv2d, [xs(2, 8, 17, 19), xs(12, 8, 3, 3)], stride=2,
            padding=[1, 2, 0, 3]),
        "conv2d NHWC": both(F.conv2d, [xs(2, 17, 19, 8), xs(12, 4, 3, 3)],
                            stride=2, padding=1, groups=2,
                            data_format="NHWC"),
        "conv2d_transpose output_padding groups": both(
            F.conv2d_transpose, [xs(2, 8, 9, 10), xs(8, 3, 3, 3), xs(6)],
            stride=2, padding=1, output_padding=1, groups=2),
        "conv2d_transpose output_padding past torch's": both(
            F.conv2d_transpose, [xs(2, 8, 9, 10), xs(8, 6, 3, 3)], stride=1,
            padding=1, output_padding=2),
    }
    x7 = xs(2, 3, 15, 17)
    relu = np.maximum(x7, 0)
    relu[:, :, :6, :6] = 0.0                   # all-tie windows
    for name, fn, arr, kw in (
            ("max ceil", F.max_pool2d, x7, dict(kernel_size=3, stride=2,
                                                padding=1, ceil_mode=True)),
            ("max asymmetric", F.max_pool2d, x7, dict(
                kernel_size=3, stride=2, padding=[1, 2, 0, 1])),
            ("max return_mask", F.max_pool2d, x7, dict(
                kernel_size=3, stride=2, padding=1, return_mask=True)),
            ("max ceil return_mask", F.max_pool2d, x7, dict(
                kernel_size=2, stride=2, ceil_mode=True, return_mask=True)),
            ("max ReLU ties", F.max_pool2d, relu, dict(kernel_size=3,
                                                       stride=2, padding=1)),
            ("avg exclusive ceil", F.avg_pool2d, x7, dict(
                kernel_size=3, stride=2, padding=1, ceil_mode=True)),
            ("avg inclusive ceil", F.avg_pool2d, x7, dict(
                kernel_size=3, stride=2, padding=1, ceil_mode=True,
                exclusive=False)),
            ("avg SAME", F.avg_pool2d, x7, dict(kernel_size=3, stride=2,
                                                 padding="SAME")),
            ("avg divisor", F.avg_pool2d, x7, dict(kernel_size=3, stride=2,
                                                    divisor_override=4)),
            ("adaptive avg", F.adaptive_avg_pool2d, x7, dict(
                output_size=(4, 5))),
            ("adaptive max", F.adaptive_max_pool2d, x7, dict(
                output_size=(3, 4))),
            ("max NHWC", F.max_pool2d, np.ascontiguousarray(
                x7.transpose(0, 2, 3, 1)), dict(kernel_size=3, stride=2,
                                                padding=1,
                                                data_format="NHWC"))):
        cases[name] = both(fn, [arr], **kw)
    log(f"  conv and pooling, card against CPU (max error of max|ref|, "
        f"outputs and gradients): {json.dumps(cases)}")
    paddle.set_device("gpu:0")
    _vision_counts_zero(read_counts(), 54)
    return {"resnet18": worst, "routes": cases}


def detector_phase(timed=8, batch=DT_BATCH, image=DT_IMAGE):
    """Phase 55 (cell DT): ``bench.py:bench_detect`` in the port — the
    PP-YOLOE detector over MobileNetV3-small at 320 px, 80 classes,
    ``Momentum(0.01, 0.9)``, ``make_train_step(..., amp=True)`` over
    ``detection_loss`` at B 8 with ``bench.py``'s ground truth; then
    ``examples/train_detector.py``'s inference at 64 px, the three NMS
    ops on the card against the same calls on the CPU."""
    import torch
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.vision.detection import (detection_loss,
                                                   ppyoloe_mbv3, static_nms)
    from paddle_tpu_torch.vision.ops import matrix_nms, multiclass_nms
    paddle.set_device("gpu:0")
    reset_counts()
    paddle.seed(0)
    det = ppyoloe_mbv3(num_classes=DT_CLASSES, image_size=image)
    sd = _snapshot(det)
    pts, strides = det.anchor_points()
    macs = conv_linear_macs(det, paddle.to_tensor(
        np.zeros((1, 3, image, image), np.float32)))
    del det
    flops = 3 * 2 * macs * batch
    log(f"  detector forward at {image}^2: {macs / 1e9:.4f} G multiply-adds "
        f"an image")
    rng = np.random.default_rng(0)

    def mk(b):                          # bench.py:371-379
        x = rng.standard_normal((b, 3, image, image)).astype(np.float32)
        lo = rng.uniform(0, image - 64, (b, 4, 2)).astype(np.float32)
        wh = rng.uniform(16, 64, (b, 4, 2)).astype(np.float32)
        gt_b = np.concatenate([lo, lo + wh], -1)
        gt_l = rng.integers(0, DT_CLASSES, (b, 4)).astype(np.int32)
        return ([paddle.to_tensor(x)],
                [paddle.to_tensor(gt_b), paddle.to_tensor(gt_l)])

    batches = [mk(batch) for _ in range(3)]

    def make_net():
        net = ppyoloe_mbv3(num_classes=DT_CLASSES, image_size=image)
        net.set_state_dict(sd)
        return net

    def opt_fn(net):
        return paddle.optimizer.Momentum(0.01, momentum=0.9,
                                         parameters=net.parameters())

    def loss_fn(cls, boxes, gt_b, gt_l):
        return detection_loss(cls, boxes, gt_b, gt_l, pts, strides,
                              DT_CLASSES)

    eager, captured, secs, step, net, peaks = _eager_vs_captured(
        make_net, opt_fn, loss_fn, batches)
    rels = [_rel(c, e) for c, e in zip(captured, eager)]
    log(f"  losses eager {eager}, captured {captured} (warm-up, capture + "
        f"replay, replay; {[round(t, 3) for t in secs]} s); rel {rels}; "
        f"bit-equal {[c == e for c, e in zip(captured, eager)]}")
    for r in rels[:2]:              # the warm-up and the first captured
        check(r <= 5e-3, f"captured detector loss rel {r} from eager")
    m = _timed_replays(step, *batches[0], timed, "detector step",
                       flops, batch)
    m.update(losses_eager=eager, losses_captured=captured, loss_rel=rels,
             capture_s=secs[1], **peaks)
    log(f"  {json.dumps(m)}")
    del step, net
    torch.cuda.empty_cache()

    # examples/train_detector.py's inference at 64 px: the three NMS ops
    # on the card and on the CPU from the same logits and boxes
    paddle.seed(1)
    small = ppyoloe_mbv3(num_classes=3, image_size=64)
    small.eval()
    cls, boxes = small(paddle.to_tensor(rng.standard_normal(
        (2, 3, 64, 64)).astype(np.float32)))
    scores = torch.sigmoid(cls._value).permute(0, 2, 1).contiguous()
    calls = {
        "multiclass_nms": lambda b, s: multiclass_nms(
            b, s, score_threshold=0.05, nms_top_k=32, keep_top_k=8,
            nms_threshold=0.6),
        "matrix_nms": lambda b, s: matrix_nms(
            b, s, score_threshold=0.05, nms_top_k=32, keep_top_k=8),
        # one image, each anchor's best class
        "static_nms": lambda b, s: static_nms(b, s, top_k=32,
                                              iou_threshold=0.6),
    }
    nms = {}
    for name, fn in calls.items():
        b, s = boxes._value.detach(), scores
        if name == "static_nms":
            b, s = b[0], s[0].amax(0)
        args = {d: (paddle.to_tensor(b.to(d)), paddle.to_tensor(s.to(d)))
                for d in ("cpu", "cuda")}
        want = [o.numpy() for o in fn(*args["cpu"])]
        got = [o.numpy() for o in fn(*args["cuda"])]
        for i, (a, b) in enumerate(zip(want, got)):
            check(a.shape == b.shape and np.array_equal(a, b),
                  f"{name} output {i}: card {b} against CPU {a}")
        ms = cuda_ms(lambda: fn(*args["cuda"]), iters=10, warmup=2)
        prof = profile_device(lambda: fn(*args["cuda"]), name, top=3)
        nms[name] = {"ms": ms, "launch_calls": prof.get("launch_calls"),
                     "kept": int(np.asarray(got[-1]).sum()) if
                     name == "static_nms" else got[-1].tolist()}
    log(f"  NMS on the card, equal to the CPU's: {json.dumps(nms)}")
    m["nms"] = nms
    _vision_counts_zero(read_counts(), 55)
    return m


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
    # BERT-base's quantized linears (phase 47): the encoder's at M = B 32
    # x S 128, the pooler's and the 2-class head's at M = 32
    mm += [matmul_case(M, K, N, seed=M + K + N)
           for M, K, N in ((4096, 768, 768), (4096, 768, 3072),
                           (4096, 3072, 768), (32, 768, 2))]
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
                     1024, 2048, 16, 16, 128, True, seed=24),
          flash_case("(e) sharded-step shard B=2 S=2048 H=Hk=8 D=128 causal",
                     2, 2048, 2048, 8, 8, 128, True, seed=25),
          flash_case("(f) ring block B=4 S=512 H=Hk=16 D=128 causal, dlse",
                     4, 512, 512, 16, 16, 128, True, seed=26, dlse=True),
          flash_case("(g) ring block B=4 S=512 H=Hk=16 D=128 non-causal, "
                     "dlse", 4, 512, 512, 16, 16, 128, False, seed=27,
                     dlse=True),
          flash_case("(h) BERT-base B=32 S=128 H=Hk=12 D=64 non-causal",
                     32, 128, 128, 12, 12, 64, False, seed=28)]
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

    log("== phase 29: the serving front end (cell T), full width, bf16, "
        "HTTP/1.1 + SSE from 16 clients")
    with tempfile.TemporaryDirectory() as tmp:
        _, c29 = frontend_phase(prompts, news, tmp)
    log("== phase 30: fp32 parity through the server on C's model and "
        "trace")
    server_parity_phase(sp, sn)
    log("== phase 31: workload replay (cell U), full width, bf16, 3 "
        "replicas under chaos, then int8")
    _, c31 = replay_phase()
    for c in (c29, c31):
        launches = {k: launches[k] + c[k] for k in launches}

    log("== phase 32: paged attention and the int8 matmul at one tensor-"
        "parallel shard's shapes (A at tp 2 and 4)")
    att32, mm32 = shard_kernel_phase()
    att += att32
    mm += mm32
    log(f"  nvidia-smi: {card}")
    log("== phase 33: tensor-parallel serving on the one card (cell V): A "
        "at tp 1 and 2 in turns, B at tp 2, fp32 parity at tp 2 and 4")
    _, c33 = tp_serving_phase(prompts, news)
    tp_parity_phase(sp, sn)
    launches = {k: launches[k] + c33[k] for k in launches}
    log(f"  nvidia-smi: {card}")

    log("== phase 34: fault-tolerant training (cell W), full width, bf16, "
        "F's step with the sentinel, the loader, the checkpoint series and "
        "the health ladder")
    with tempfile.TemporaryDirectory() as tmp:
        _, c34 = ft_training_phase(tmp)
    torch.cuda.empty_cache()
    log(f"  nvidia-smi: {card}")
    log("== phase 35: fp32 checkpoint resume and framework.io on the card "
        "(E's config)")
    with tempfile.TemporaryDirectory() as tmp:
        ft_parity_phase(tmp)
    torch.cuda.empty_cache()

    log("== phase 36: the sharded train step (cell X), F at dp 2 x mp 2 x "
        "sharding 2 over cuda:0 x 8, beside the serial step")
    _, c36 = sharded_phase()
    log(f"  nvidia-smi: {card}")
    log("== phase 37: fp32 sharded parity (E's width), the collectives on "
        "the card, a sharded checkpoint, the ZeRO gate")
    with tempfile.TemporaryDirectory() as tmp:
        sharded_parity_phase(tmp)
    torch.cuda.empty_cache()

    log("== phase 38: the pipelined train step, F at dp 2 x pp 4 x V 3 over "
        "cuda:0 x 8, 4 micro-batches, beside the serial step")
    _, c38 = pp_phase()
    log(f"  nvidia-smi: {card}")
    log("== phase 39: context-parallel training, F on unsharded params at "
        "dp 2 x sep 4 over cuda:0 x 8, ring and Ulysses, beside the serial "
        "step")
    _, c39 = sep_phase()
    log(f"  nvidia-smi: {card}")
    log("== phase 40: fp32 pipeline and context-parallel parity (E's "
        "width): pp V 1 and 2, tied and untied; ring and Ulysses on "
        "unsharded and sharded params")
    cp_parity_phase()
    torch.cuda.empty_cache()

    log("== phase 41: the launched job (cell LA): python -m "
        "paddle_tpu_torch.distributed.launch --nproc_per_node 2, both ranks "
        "on cuda:0 over gloo, F's gradient averaged across the processes")
    with tempfile.TemporaryDirectory() as tmp:
        _, c41 = launch_phase(tmp)
    log(f"  nvidia-smi: {card}")
    log("== phase 42: elastic restarts on the card: a SIGKILLed rank and a "
        "stalled heartbeat, each round resumed from AsyncCheckpointer")
    with tempfile.TemporaryDirectory() as tmp:
        elastic_phase(tmp)
    log("== phase 43: expert parallelism (cell EP): L (8 experts, 2 layers) "
        "at dp 2 x ep 4 over cuda:0 x 8, beside the serial step")
    _, c43 = ep_phase()
    log(f"  nvidia-smi: {card}")
    log("== phase 44: fp32 expert-parallel parity (E's width, 8 experts): "
        "dp 2 x ep 4, pp 2 x ep 2, dp 2 x pp 2 x ep 2 at V 2")
    ep_parity_phase()
    torch.cuda.empty_cache()

    log("== phase 45: the eager API on the card: LlamaForCausalLM at F, "
        "E's fp32 parity, eager generate, the eager kernel callers")
    m45, c45, c45d = eager_phase(m11)
    launches = {k: launches[k] + c45d[k] for k in launches}
    log(f"  nvidia-smi: {card}")
    log("== phase 46: the eager hybrid-parallel API: a Megatron decoder at "
        "F's widths at mp 2 over cuda:0 x 2, F's LlamaForCausalLM through "
        "fleet at dp 2 x sharding 2, PipelineParallel at pp 2, MoELayer at "
        "ep 4")
    c46a, c46b = hybrid_phase(m45)
    log(f"  nvidia-smi: {card}")

    log("== phase 47: BERT-base fine-tuning through paddle.Model (cell BT), "
        "O1, B 32 x S 128; evaluate and predict; the int8 network")
    m47, c47 = bert_phase()
    launches = {k: launches[k] + c47[k] for k in launches}
    log(f"  nvidia-smi: {card}")
    log("== phase 48: fp32 parity of Model.train_batch on the card against "
        "the CPU (hidden 256, 4 heads of D 64, 4 layers), O1, GradScaler at "
        "float16, PyLayer")
    c48 = bert_parity_phase()
    log("== phase 49: examples/train_recsys.py on the card (cell RS): host "
        "and device tables, AsyncLookup, the 2-rank vocab-sharded job")
    with tempfile.TemporaryDirectory() as tmp:
        recsys_phase(tmp)
    log(f"  nvidia-smi: {card}")
    log("== phase 50: the captured train step (jit): F's LlamaForCausalLM "
        "through make_train_step, E's fp32 parity (scheduler, dropout, "
        "sentinel), control flow on CUDA tensors")
    _, c50a, c50b = captured_phase(m45)
    log(f"  nvidia-smi: {card}")
    log("== phase 51: BERT-base fine-tuning through Model.prepare(jit=True) "
        "(cell BT captured), O1, B 32 x S 128; the dropout-0 parity run")
    _, bt_net, c51 = bert_jit_phase(m47)
    log("== phase 52: deployment: Model.save(training=False) of phase 51's "
        "network, create_predictor, fp32 and int8")
    _, c52 = deploy_phase(bt_net)
    del bt_net
    launches = {k: launches[k] + c52.get(k, 0) for k in launches}
    log(f"  nvidia-smi: {card}")
    log("== phase 53: ResNet-50 training (cell RN) as bench_resnet runs it: "
        "B 32 x 3 x 224^2, bf16 auto_cast, Momentum, make_train_step; NCHW "
        "and ChannelsLast; examples/train_resnet.py's DataLoader loop")
    resnet_phase()
    log(f"  nvidia-smi: {card}")
    log("== phase 54: fp32 parity of vision on the card against the CPU: "
        "ResNet-18, NHWC, three captured steps, the conv and pooling routes")
    vision_parity_phase()
    log("== phase 55: the PP-YOLOE detector (cell DT) as bench_detect runs "
        "it: MobileNetV3-small, 320 px, B 8, bf16 auto_cast, Momentum, "
        "make_train_step over detection_loss; NMS on the card against the "
        "CPU")
    detector_phase()
    log(f"  nvidia-smi: {card}")
    trained = (c8, c34, c36, c38, c39, c41, c43, c45, c45d, c46a, c46b, c47,
               c48, c50a, c50b, c51, c52)
    normed = (c11, c34, c36, c38, c39, c41, c43, c45, c45d, c46a, c46b, c50a,
              c50b)

    log("== main paths driven: " + ", ".join(PATHS))
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
                          sum(c["flash_attention" + counter]
                              for c in trained))
        if which != "fwd":
            entry["library_note"] = ("scaled_dot_product_attention backward "
                                     "(dq, dk and dv in one call)")
        kernels.append(entry)
    csrc = "paddle_tpu_torch/csrc/"
    kernels += [
        summarize("rms_norm_fwd", csrc + "rms_norm.cu",
                  "paddle_tpu/kernels/rms_norm.py:27",
                  [r["fwd"] for r in norms],
                  sum(c["rms_norm"] for c in normed)),
        summarize("rms_norm_bwd", csrc + "rms_norm.cu",
                  "paddle_tpu/kernels/rms_norm.py:35",
                  [r["bwd"] for r in norms if "bwd" in r],
                  sum(c["rms_norm_bwd"] for c in normed)),
        summarize("apply_rope", csrc + "rope.cu",
                  "paddle_tpu/kernels/rope.py:25", ropes,
                  sum(c[k] for c in normed
                      for k in ("apply_rope", "apply_rope_bwd"))),
    ]
    kernels[-1]["launches_fwd_bwd"] = [
        sum(c["apply_rope"] for c in normed),
        sum(c["apply_rope_bwd"] for c in normed)]
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

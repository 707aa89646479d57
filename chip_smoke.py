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
   could take (bound).
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
   per row), then the forward, backward dq and backward dk/dv kernels
   timed alone beside their plain versions, ``scaled_dot_product_attention``
   and the bound.
8. Training at full width, bf16: the same model with ``use_kernels`` and
   full remat, B 8 x S 2048, AdamW at lr 1e-4: one warm-up step, then
   timed steps (step time, tokens/s, MFU, peak memory, launches per step)
   and one profiled step (device busy share, top kernels).
9. Training parity at fp32 on the card (hidden 512, 8 heads, 4 kv heads,
   4 layers, B 2 x S 512): the flash kernels against the plain attention
   on the loss, every gradient leaf and 3 AdamW steps' losses.

Then the kernels JSON line, the card line and the result line. Phases 4
and 5 each serve one short warm-up request first (first-call set-up stays
out of the numbers). Kernel launch counters are set to 0 just before each
main-path run and read just after it: paged attention must have launched
on both entry points in phase 4, the int8 matmul and the int8-pool
attention in phase 5, the three flash kernels in every timed step of
phase 8 (24 forward, 12 dq, 12 dk/dv per step: the forward runs again in
each layer's recompute). The kernels line reports the serving launches of
phases 4 and 5 together and the flash launches of phase 8.
Exits non-zero, printing no result, without a CUDA device or outside a
checkout of the repository.
"""

from __future__ import annotations

import json
import subprocess
import sys
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
           ("flash_attention", "launches_bwd_dkv"))


def _count_owners():
    from paddle_tpu_torch.kernels.flash_attention import flash_attention
    from paddle_tpu_torch.kernels.paged_attention import paged_attention
    from paddle_tpu_torch.kernels.quant_matmul import weight_only_matmul
    return {"paged_attention": paged_attention,
            "weight_only_matmul": weight_only_matmul,
            "flash_attention": flash_attention}


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


def bound(nbytes, flops, kind):
    """(least ms, what bounds it): bytes over HBM rate vs flops over peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def attention_case(name, M, H, Hk, D, bs, W, quant, Q=None, seed=0):
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.kernels.paged_attention import (
        paged_attention, paged_attention_plain)
    from paddle_tpu_torch.models.generation import _kv_quantize
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
    dl_np = (None if Q is None
             else rng.integers(0, Q, size=M).astype(np.int32))
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
        return paged_attention(q, k, v, tbl, sl, draft_lens=dl, **extra)

    def plain():
        return paged_attention_plain(q, k, v, tbl, sl, draft_lens=dl,
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
    row = {"case": name, "max_abs_err": err, "tol": tol, "ms": ms,
           "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": b_ms,
           "bound_by": b_by}
    log(f"  {name}: max_abs_err {err:.3g} (tol {tol:.3g})  kernel "
        f"{ms:.4f} ms  plain {plain_ms:.4f} ms  sdpa {library_ms:.4f} ms  "
        f"bound {b_ms:.4f} ms ({b_by})")
    return row


def matmul_case(M, K, N, seed=0):
    import torch
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
    iters = 5 if M > 16 else 20
    ms = cuda_ms(kern, iters=iters)
    plain_ms = cuda_ms(plain, iters=iters)
    library_ms = cuda_ms(lambda: torch.matmul(x, w_deq), iters=iters)
    nbytes = M * K * 2 + K * N + N * 4 + M * N * 2
    b_ms, b_by = bound(nbytes, 2.0 * M * N * K, "bf16")
    name = f"M={M} K={K} N={N}"
    log(f"  {name}: max_abs_err {err:.3g} (tol {tol:.3g})  kernel "
        f"{ms:.4f} ms  plain {plain_ms:.4f} ms  matmul {library_ms:.4f} ms  "
        f"bound {b_ms:.4f} ms ({b_by})")
    return {"case": name, "max_abs_err": err, "tol": tol, "ms": ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": b_ms, "bound_by": b_by}


def summarize(name, source, replaces, rows, launches):
    """One kernels-line entry: times summed over the checked shapes."""
    by = {}
    for r in rows:
        by[r["bound_by"]] = by.get(r["bound_by"], 0.0) + r["bound_ms"]
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": sum(r["ms"] for r in rows),
            "plain_ms": sum(r["plain_ms"] for r in rows),
            "bound_ms": sum(r["bound_ms"] for r in rows),
            "bound_by": max(by, key=by.get),
            "library_ms": sum(r["library_ms"] for r in rows),
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
    rows = {}
    for which, _, _ in FLASH_KERNELS:
        ms, plain_ms, lib_ms = times[which]
        if lib_ms is None:
            lib_ms = lib_bwd_ms
        b_ms, b_by = bound(nbytes[which], flops[which] * D * pairs, "bf16")
        rows[which] = {"case": name, **errs[which], "ms": ms,
                       "plain_ms": plain_ms, "library_ms": lib_ms,
                       "bound_ms": b_ms, "bound_by": b_by,
                       "visible_pairs": pairs}
        log(f"  {name} {which}: rel_fro {errs[which]['rel_fro']:.3g}  "
            f"kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  sdpa "
            f"{'bwd ' if which != 'fwd' else ''}{lib_ms:.4f} ms  bound "
            f"{b_ms:.4f} ms ({b_by})")
    return rows


# ---------------------------------------------------------------------------
# phases 8-9: the training step
# ---------------------------------------------------------------------------

PEAK_BF16 = PEAK_FLOPS["bf16"]


def train_flops_per_step(cfg, batch, seq):
    """``bench.py:_train_flops_per_step``: 6 N per token plus the causal
    attention term 6 L E S."""
    from paddle_tpu_torch.models.llama import num_params
    return batch * seq * (6 * num_params(cfg)
                          + 6 * cfg.num_hidden_layers * cfg.hidden_size * seq)


def profile_device(run, label, top=6):
    """Run ``run()`` under ``torch.profiler``: the wall time, the device
    time of every kernel (CUPTI) and its share of the wall time, and the
    kernels that took the most device time."""
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
            for short in ("paged_attention_kernel",
                          "weight_only_matmul_kernel", "flash_fwd_kernel",
                          "flash_bwd_dq_kernel", "flash_bwd_dkv_kernel"):
                if short in name:
                    name = short
            # summed by the printed (60-character) name: instantiations of
            # one PyTorch kernel template share it
            name = name[:60]
            kernels[name] = kernels.get(name, 0.0) + e.self_device_time_total
    busy_ms = sum(kernels.values()) / 1e3
    out = {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
           "device_busy_share": busy_ms / wall_ms,
           "top_kernels_ms": {k: v / 1e3 for k, v in sorted(
               kernels.items(), key=lambda kv: -kv[1])[:top]}}
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


def train_phase(steps=4, batch=8, seq=2048):
    """Phase 8: one warm-up step, ``steps`` timed steps with the launch
    counters set to 0 just before them, one profiled step."""
    import torch
    from paddle_tpu_torch.models.llama import init_params, make_train_step
    cfg = train_config(torch.bfloat16)
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
    per_step = {k: counts[f"flash_attention{k}"] / steps
                for k in ("", "_bwd_dq", "_bwd_dkv")}
    L = cfg.num_hidden_layers
    m = {"step_ms": step_s * 1e3, "step_ms_each": [t * 1e3 for t in times],
         "tokens_per_s": batch * seq / step_s,
         "mfu": flops / step_s / PEAK_BF16, "flops_per_step": flops,
         "max_memory_allocated_gb": peak / 2 ** 30, "losses": losses,
         "flash_launches_per_step": per_step}
    log(f"  {json.dumps(m)}")
    check(all(np.isfinite(losses)), f"non-finite loss {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    for k, want in (("", 2 * L), ("_bwd_dq", L), ("_bwd_dkv", L)):
        check(per_step[k] == want,
              f"flash_attention{k}: {per_step[k]} launches per step, "
              f"expected {want}")
    prof = profile_device(lambda: step(params, opt, ids, ids),
                          "training step", top=10)
    m["profile"] = prof
    return m, counts


def parity_phase():
    """Phase 9: fp32, the flash kernels against the plain attention."""
    import torch
    from paddle_tpu_torch.models.llama import (_leaves, init_params,
                                               loss_fn, make_train_step)
    cfg = {use: train_config(torch.float32, hidden_size=512,
                             intermediate_size=1376, num_hidden_layers=4,
                             num_attention_heads=8, num_key_value_heads=4,
                             use_kernels=use)
           for use in (True, False)}
    ids = torch.from_numpy(np.random.default_rng(1).integers(
        0, 32000, (2, 512))).cuda()
    res = {}
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
    log(f"  loss kernel {lk:.8f} plain {lp:.8f} (rel {rel:.3g}); worst "
        f"gradient leaf max|diff|/max|g| {worst:.3g}; 3-step losses kernel "
        f"{tk} plain {tp} (max rel {traj_rel:.3g})")
    check(rel <= 1e-5, f"fp32 loss kernel vs plain rel {rel}")
    check(worst <= 1e-4, f"fp32 gradient kernel vs plain {worst}")
    check(traj_rel <= 1e-4, f"fp32 3-step losses rel {traj_rel}")
    return {"loss_rel": rel, "grad_worst": worst, "traj_rel": traj_rel}


# ---------------------------------------------------------------------------
# phases 4-6: the serving engine
# ---------------------------------------------------------------------------

def model_config(dtype):
    """``bench.py:_presets("tpu")`` (lines 68-74): the model the repo's
    own TPU benchmark serves."""
    from paddle_tpu_torch.models.llama import LlamaConfig
    import torch
    return LlamaConfig(vocab_size=32000, hidden_size=2048,
                       intermediate_size=5504, num_hidden_layers=12,
                       num_attention_heads=16, num_key_value_heads=16,
                       max_position_embeddings=2048, dtype=dtype,
                       param_dtype=torch.float32)


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
                   "mixed_dispatches", "decode_iters", "chunks", "steps",
                   "prefix_hit_tokens", "preemptions")


def drive(engine, prompts, news):
    """Submit the whole trace, drain it, return (outputs, metrics). The
    counters and dispatch times are this drain's alone (the engine may
    have served a warm-up before)."""
    import torch
    st0 = engine.stats()
    torch.cuda.synchronize()
    t0 = time.time()
    rids = [engine.submit(p, max_new_tokens=m, eos_token_id=None)
            for p, m in zip(prompts, news)]
    while engine.pending:
        engine.step()
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
               "ms_per_decode_step": (secs["decode"] * 1e3
                                      / max(1, d["decode_iters"])),
               "ms_per_mixed_dispatch": (secs["mixed"] * 1e3
                                         / max(1, d["mixed_dispatches"])),
               **d}
    return [np.asarray(r.tokens) for r in reqs], metrics


def profile_drain(engine, prompts, news):
    """Drain a short trace under ``torch.profiler`` (``profile_device``)."""
    for p, m in zip(prompts, news):
        engine.submit(p, max_new_tokens=m, eos_token_id=None)

    def drain():
        while engine.pending:
            engine.step()

    return profile_device(drain, f"drain of {len(prompts)} requests")


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
    _, m4 = drive(engine, prompts, news)
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
    _, m5 = drive(engine, prompts, news)
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
    B, W = 4, 16
    pool = G.init_paged_pool(cfg32, 1 + B * W, 16, device="cuda")
    ids = np.zeros((B, 128), np.int32)
    plens = np.array([len(p[:120]) for p in sp[:B]], np.int32)
    for b in range(B):
        ids[b, :plens[b]] = sp[b][:120]
    tbl = torch.arange(1, 1 + B * W, dtype=torch.int32,
                       device="cuda").reshape(B, W)
    t = lambda a: torch.from_numpy(a).cuda()  # noqa: E731
    act = torch.ones(B, dtype=torch.bool, device="cuda")
    logits, pool = G.paged_prefill(params, cfg32, t(ids), t(plens), tbl,
                                   pool, act)
    tok = logits.argmax(-1).to(torch.int32)
    out = {}
    for use in (True, False):
        lg, _ = G.paged_decode_step(params, cfg32, tok, t(plens), tbl,
                                    {k: v.clone() for k, v in pool.items()},
                                    act, use_kernel=use)
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
    parity_phase()

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
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

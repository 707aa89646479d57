"""Structured-prediction / decoding op family — counterpart of
``paddle_tpu/ops/decode.py``.

Each dynamic-programming recursion of the reference (a ``lax.scan``: the
CRF forward algorithm, Viterbi and its back-pointer walk, the beam
back-tracking, Levenshtein) is a Python loop of T device steps over the
whole batch with static ``[B, T]`` shapes and length masks: no host read
of a length, so a captured graph holds it, as ``nn.functional.ctc_loss``
does for CTC. ``edit_distance``'s inner recurrence along the input,
``cur[i] = min(c[i], cur[i-1] + 1)``, is one ``cummin`` per label step.
Argmax and top-k ties break to the lower index, as JAX's do.
"""

from __future__ import annotations

import torch

from ._helpers import ensure_tensor, forward_op

__all__ = [
    "linear_chain_crf", "crf_decoding", "ctc_align", "warpctc",
    "beam_search", "beam_search_decode", "gather_tree", "edit_distance",
]


def _lengths(ln, B, T, device):
    return ln[0].long() if ln else torch.full((B,), T, dtype=torch.long,
                                              device=device)


# -- CRF (transition layout [K+2, K]: row 0 start, row 1 stop) ----------------

def linear_chain_crf(emission, transition, label, length=None, name=None):
    """Negative log-likelihood of a linear-chain CRF: ``emission [B, T,
    K]``, ``transition [K+2, K]`` (row 0 = start, row 1 = stop, rows 2.. =
    pairwise), ``label [B, T]``. Returns ``log_likelihood [B]`` (logZ -
    path score, the reference's sign)."""
    args = [ensure_tensor(emission), ensure_tensor(transition),
            ensure_tensor(label)]
    if length is not None:
        args.append(ensure_tensor(length))

    def impl(ev, tv, lv, *ln):
        B, T, K = ev.shape
        start, stop, trans = tv[0], tv[1], tv[2:]
        lens = _lengths(ln, B, T, ev.device)
        valid = torch.arange(T, device=ev.device)[None, :] < lens[:, None]
        alpha = start[None] + ev[:, 0]
        for t in range(1, T):
            s = alpha[:, :, None] + trans[None] + ev[:, t][:, None, :]
            alpha = torch.where(valid[:, t:t + 1], torch.logsumexp(s, 1),
                                alpha)
        log_z = torch.logsumexp(alpha + stop[None], 1)
        lv = lv.long()
        zero = torch.zeros((), dtype=ev.dtype, device=ev.device)
        em = torch.gather(ev, 2, lv[..., None])[..., 0]
        em_sc = torch.where(valid, em, zero).sum(1)
        tr = trans[lv[:, :-1], lv[:, 1:]]
        tr_sc = torch.where(valid[:, 1:], tr, zero).sum(1)
        last = torch.gather(lv, 1, torch.clamp(lens - 1, min=0)[:, None])[:, 0]
        return log_z - (em_sc + tr_sc + start[lv[:, 0]] + stop[last])

    return forward_op("linear_chain_crf", impl, args)


def crf_decoding(emission, transition, length=None, name=None):
    """Viterbi decode with the CRF's [K+2, K] transition layout. Returns the
    argmax path ``[B, T]`` (padding tail 0)."""
    args = [ensure_tensor(emission), ensure_tensor(transition)]
    if length is not None:
        args.append(ensure_tensor(length))

    def impl(ev, tv, *ln):
        B, T, K = ev.shape
        start, stop, trans = tv[0], tv[1], tv[2:]
        lens = _lengths(ln, B, T, ev.device)
        valid = torch.arange(T, device=ev.device)[None, :] < lens[:, None]
        stay = torch.arange(K, device=ev.device)[None].expand(B, K)
        alpha = start[None] + ev[:, 0]
        ptrs = []
        for t in range(1, T):
            s = alpha[:, :, None] + trans[None] + ev[:, t][:, None, :]
            keep = valid[:, t:t + 1]
            alpha = torch.where(keep, s.amax(1), alpha)
            ptrs.append(torch.where(keep, s.argmax(1), stay))
        lab = (alpha + stop[None]).argmax(1)
        labs = [lab]
        for ptr in reversed(ptrs):
            lab = torch.gather(ptr, 1, lab[:, None])[:, 0]
            labs.append(lab)
        path = torch.stack(labs[::-1], 1)
        return torch.where(valid, path, torch.zeros_like(path))

    return forward_op("crf_decoding", impl, args, differentiable=False)


# -- CTC ----------------------------------------------------------------------

def _collapse(ids, lens, blank, fill):
    """Merge repeats, drop blanks, left-align (a stable sort of the kept
    positions); returns (out [B, T], new_lens [B])."""
    B, T = ids.shape
    j = torch.arange(T, device=ids.device)[None, :]
    prev = torch.cat([torch.full((B, 1), -1, dtype=ids.dtype,
                                 device=ids.device), ids[:, :-1]], 1)
    keep = (j < lens[:, None]) & (ids != blank) & (ids != prev)
    order = torch.sort(torch.where(keep, j, torch.full_like(j, T)), dim=1,
                       stable=True).indices
    g = torch.gather(ids, 1, order)
    new_lens = keep.sum(1)
    return torch.where(j < new_lens[:, None], g, torch.full_like(g, fill)), \
        new_lens


def ctc_align(input, input_length=None, blank: int = 0, padding_value: int = 0,  # noqa: A002
              name=None):
    """Collapse CTC raw predictions: merge repeats then drop blanks; fixed
    ``[B, T]`` out + lengths."""
    args = [ensure_tensor(input)]
    if input_length is not None:
        args.append(ensure_tensor(input_length))

    def impl(v, *ln):
        return _collapse(v, _lengths(ln, v.shape[0], v.shape[1], v.device),
                         blank, padding_value)
    return forward_op("ctc_align", impl, args, differentiable=False)


def warpctc(logits, label, logits_length, labels_length, blank: int = 0,
            norm_by_times: bool = False, name=None):
    """CTC loss under Paddle's warpctc entry point: ``nn.functional.
    ctc_loss``'s alpha recursion, per row. ``logits [T, B, K]``."""
    from ..nn import functional as F
    loss = F.ctc_loss(ensure_tensor(logits), label, logits_length,
                      labels_length, blank=blank, reduction="none")
    if norm_by_times:
        return forward_op(
            "warpctc_norm",
            lambda l, n: l / torch.clamp(n.to(l.dtype), min=1),
            [loss, ensure_tensor(logits_length)])
    return loss


# -- beam search ---------------------------------------------------------------

def beam_search(pre_ids, pre_scores, ids, scores, beam_size: int,
                end_id: int, level: int = 0, is_accumulated: bool = True,
                name=None):
    """One beam-search expansion step: the global top-W of W*V candidates
    per batch; finished beams (last id == end_id) only re-emit end_id at
    their own score. Returns ``(selected_ids [B, W], selected_scores [B,
    W], parent_idx [B, W])``."""
    def impl(pi, ps, sc):
        B, W, V = sc.shape
        fin = (pi == end_id)[..., None]
        is_end = (torch.arange(V, device=sc.device) == end_id)[None, None]
        total = torch.where(fin, torch.full_like(sc, float("-inf")),
                            ps[..., None] + sc)
        total = torch.where(fin & is_end, ps[..., None].expand_as(sc), total)
        top, idx = torch.sort(total.reshape(B, W * V), dim=1,
                              descending=True, stable=True)
        top, idx = top[:, :W], idx[:, :W]
        return idx % V, top, idx // V

    return forward_op("beam_search", impl,
                      [ensure_tensor(pre_ids), ensure_tensor(pre_scores),
                       ensure_tensor(scores)], differentiable=False)


def gather_tree(ids, parents, name=None):
    """Reconstruct full beams from per-step tokens + parent pointers:
    ``ids/parents [T, B, W]``, walked from the last step back."""
    def impl(iv, pv):
        T, B, W = iv.shape
        beam = torch.arange(W, device=iv.device)[None].expand(B, W)
        toks = [None] * T
        for t in reversed(range(T)):
            toks[t] = torch.gather(iv[t], 1, beam)
            beam = torch.gather(pv[t], 1, beam).long()
        return torch.stack(toks)

    return forward_op("gather_tree", impl,
                      [ensure_tensor(ids), ensure_tensor(parents)],
                      differentiable=False)


def beam_search_decode(ids, parents, beam_size=None, end_id: int = -1,
                       name=None):
    """Full-beam decode: gather_tree, then each beam's length up to and
    including its first ``end_id``. Returns ``(sequences [T, B, W],
    lengths [B, W])``."""
    full = gather_tree(ids, parents)

    def impl(fv):
        hit = (fv == end_id).to(torch.int32)
        first = hit.argmax(0) + 1
        return fv, torch.where(hit.amax(0) > 0, first,
                               torch.full_like(first, fv.shape[0]))

    return forward_op("beam_search_decode", impl, [full],
                      differentiable=False)


# -- edit distance ---------------------------------------------------------------

def edit_distance(input, label, input_length=None, label_length=None,  # noqa: A002
                  normalized: bool = True, name=None):
    """Levenshtein distance per batch row: ``input [B, T1]``, ``label [B,
    T2]`` id sequences with optional lengths. The DP column over the input
    rolls forward one label token per step. Returns ``(distance [B],
    sequence_num [B])``."""
    args = [ensure_tensor(input), ensure_tensor(label)]
    if input_length is not None:
        args += [ensure_tensor(input_length), ensure_tensor(label_length)]

    def impl(iv, lv, *ln):
        B, T1 = iv.shape
        T2 = lv.shape[1]
        dev = iv.device
        ilen = ln[0].long() if ln else torch.full((B,), T1, device=dev)
        llen = ln[1].long() if ln else torch.full((B,), T2, device=dev)
        pos = torch.arange(T1 + 1, dtype=torch.float32, device=dev)
        dp = pos[None].expand(B, T1 + 1)
        i = pos[None, :-1]
        for j in range(T2):
            sub = dp[:, :-1] + (iv != lv[:, j:j + 1]).to(torch.float32)
            c = torch.minimum(dp[:, 1:] + 1.0, sub)
            # cur[i] = min(c[i], cur[i-1] + 1), cur[-1] = j + 1
            run = torch.cummin(c - i, dim=1).values
            cur = i + torch.clamp(run, max=float(j + 2))
            new = torch.cat([torch.full((B, 1), float(j + 1), device=dev),
                             cur], 1)
            dp = torch.where((j < llen)[:, None], new, dp)
        dist = torch.gather(dp, 1, ilen[:, None])[:, 0]
        if normalized:
            dist = dist / torch.clamp(llen.to(torch.float32), min=1)
        return dist, torch.ones((B,), dtype=torch.int32, device=dev)

    return forward_op("edit_distance", impl, args, differentiable=False)


def ctc_greedy_decoder(input, blank: int = 0, input_length=None, name=None):  # noqa: A002
    """Greedy CTC decode: argmax per step then collapse. ``input [B, T,
    K]``. Returns ``(out [B, T], out_lens [B])``."""
    args = [ensure_tensor(input)]
    if input_length is not None:
        args.append(ensure_tensor(input_length))

    def impl(v, *ln):
        ids = torch.argmax(v, -1)
        return _collapse(ids, _lengths(ln, ids.shape[0], ids.shape[1],
                                       ids.device), blank, 0)
    return forward_op("ctc_greedy_decoder", impl, args, differentiable=False)


__all__ += ["ctc_greedy_decoder"]

"""Loss functionals — counterpart of ``paddle_tpu/nn/functional/loss.py``
(``python/paddle/nn/functional/loss.py`` in Paddle and the legacy loss ops
of ``paddle/fluid/operators``): every loss of the reference, under its
signature, reduction and op name, each through ``forward_op`` so that AMP,
the profiler and ``enforce`` reach it.

``ctc_loss`` and ``rnnt_loss`` walk their lattices as device steps over
T with no host read; ``rnnt_loss``'s in-row emit recursion is one
``logcumsumexp`` over U a step. ``class_center_sample`` draws from the
port's generator of the label's device (``ops/random.py``), where the
reference draws from numpy's global one. ``center_loss`` and
``margin_cross_entropy`` return the reference's tuples.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as TF

from ...ops._helpers import ensure_tensor, forward_op


def _reduce(out, reduction):
    if reduction == "mean":
        return torch.mean(out)
    if reduction == "sum":
        return torch.sum(out)
    return out


def cross_entropy(input, label, weight=None, ignore_index=-100, reduction="mean",  # noqa: A002
                  soft_label=False, axis=-1, use_softmax=True, label_smoothing=0.0,
                  name=None):
    """Softmax cross entropy (ref: nn.functional.cross_entropy →
    softmax_with_cross_entropy phi kernel)."""
    input, label = ensure_tensor(input), ensure_tensor(label)
    args = [input, label] + ([ensure_tensor(weight)] if weight is not None else [])

    def impl(logits, lab, *w):
        ax = axis % logits.dim()
        logp = torch.log_softmax(logits, dim=ax) if use_softmax else \
            torch.log(torch.clamp(logits, min=1e-30))
        n_classes = logits.shape[ax]
        zero = torch.zeros((), dtype=logp.dtype, device=logp.device)
        if soft_label or (lab.dim() == logits.dim() and lab.shape == logits.shape):
            soft = lab
            if label_smoothing > 0:
                soft = soft * (1 - label_smoothing) + label_smoothing / n_classes
            loss = -torch.sum(soft * logp, dim=ax)
            valid = None
        else:
            lab_idx = lab
            if lab_idx.dim() == logits.dim():  # trailing 1 dim
                lab_idx = lab_idx.squeeze(ax)
            lab_idx = lab_idx.long()
            valid = lab_idx != ignore_index
            safe = torch.where(valid, lab_idx, torch.zeros_like(lab_idx))
            picked = torch.take_along_dim(logp, safe.unsqueeze(ax),
                                          dim=ax).squeeze(ax)
            if label_smoothing > 0:
                smooth_loss = -torch.mean(logp, dim=ax)
                loss = -(1 - label_smoothing) * picked + label_smoothing * smooth_loss
            else:
                loss = -picked
            if w:
                loss = loss * w[0][safe]
            loss = torch.where(valid, loss, zero)
        if reduction == "mean":
            if valid is not None:
                if w:
                    return torch.sum(loss) / torch.clamp(torch.sum(
                        torch.where(valid, w[0][safe], zero)), min=1e-12)
                return torch.sum(loss) / torch.clamp(
                    torch.sum(valid.to(loss.dtype)), min=1.0)
            return torch.mean(loss)
        if reduction == "sum":
            return torch.sum(loss)
        return loss

    return forward_op("cross_entropy", impl, args)


def mse_loss(input, label, reduction="mean", name=None):  # noqa: A002
    return forward_op("mse_loss",
                      lambda a, b: _reduce(torch.square(a - b), reduction),
                      [ensure_tensor(input), ensure_tensor(label)])


_NEG_INF = -1e30


def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0,
             reduction="mean", norm_by_times=False):
    """CTC loss by the alpha recursion in log space (ref:
    nn.functional.ctc_loss, warpctc in Paddle), as the reference computes
    it: ``log_probs [T, B, C]`` (logits or log-probabilities: a
    log-softmax is taken first), labels ``[B, S]``, a loop of T - 1 steps
    over the extended label sequence on the device, with no host read.

    Two rows differ from the reference, which is wrong there (ROADMAP §C):
    an empty label's likelihood is the all-blank path alone (the reference
    reads position 0 twice and adds log 2), and ``reduction="mean"``
    divides such a row by 1, not 0, as torch's ``ctc_loss`` does."""
    args = [ensure_tensor(log_probs), ensure_tensor(labels),
            ensure_tensor(input_lengths), ensure_tensor(label_lengths)]

    def impl(lp, lab, in_len, lab_len):
        lp = torch.log_softmax(lp, dim=-1)
        T, B, _ = lp.shape
        E = 2 * lab.shape[1] + 1
        # extended label sequence: blank, l1, blank, l2, ... blank
        ext = torch.full((B, E), blank, dtype=torch.long, device=lp.device)
        ext[:, 1::2] = lab.long()
        probs = torch.gather(lp, 2, ext[None].expand(T, B, E))  # [T, B, E]
        neg = torch.full((), _NEG_INF, dtype=lp.dtype, device=lp.device)
        lab_len = lab_len.long()
        alpha = torch.full((B, E), _NEG_INF, dtype=lp.dtype, device=lp.device)
        alpha[:, 0] = probs[0, :, 0]
        alpha[:, 1] = torch.where(lab_len > 0, probs[0, :, 1], neg)
        no_skip = torch.cat([torch.ones((B, 2), dtype=torch.bool,
                                        device=lp.device),
                             ext[:, 2:] == ext[:, :-2]], 1)
        alphas = [alpha]
        for t in range(1, T):
            s1 = TF.pad(alpha[:, :-1], (1, 0), value=_NEG_INF)
            s2 = torch.where(no_skip, neg,
                             TF.pad(alpha[:, :-2], (2, 0), value=_NEG_INF))
            alpha = torch.logaddexp(torch.logaddexp(alpha, s1), s2) + probs[t]
            alphas.append(alpha)
        t_idx = (in_len.long() - 1).clamp(0, T - 1)
        final = torch.stack(alphas)[t_idx, torch.arange(B, device=lp.device)]
        e1 = torch.gather(final, 1, (2 * lab_len - 1).clamp(0, E - 1)[:, None])
        e2 = torch.gather(final, 1, (2 * lab_len).clamp(0, E - 1)[:, None])
        e1 = torch.where(lab_len[:, None] > 0, e1, neg)
        loss = -torch.logaddexp(e1, e2)[:, 0]
        if norm_by_times:
            loss = loss / in_len.to(loss.dtype)
        if reduction == "mean":
            return torch.mean(loss / lab_len.clamp(min=1).to(loss.dtype))
        if reduction == "sum":
            return torch.sum(loss)
        return loss

    return forward_op("ctc_loss", impl, args)


def _log1pexp_abs(z):
    """log(1 + exp(-|z|)), the stable tail of the logistic losses."""
    return torch.log1p(torch.exp(-torch.abs(z)))


def softmax_with_cross_entropy(logits, label, soft_label=False, ignore_index=-100,
                               numeric_stable_mode=True, return_softmax=False,
                               axis=-1):
    loss = cross_entropy(logits, label, soft_label=soft_label,
                         ignore_index=ignore_index, reduction="none", axis=axis)
    # paddle keeps the reduced axis
    from ...ops.manipulation import unsqueeze
    loss = unsqueeze(loss, axis)
    if return_softmax:
        from .activation import softmax
        return loss, softmax(logits, axis=axis)
    return loss


def nll_loss(input, label, weight=None, ignore_index=-100, reduction="mean",  # noqa: A002
             name=None):
    """Negative log-likelihood over the class axis 1 of ``input`` ([N, C]
    or [N, C, d1, ...], Paddle's contract)."""
    input, label = ensure_tensor(input), ensure_tensor(label)
    args = [input, label] + ([ensure_tensor(weight)] if weight is not None else [])

    def impl(logp, lab, *w):
        lab = lab.long()
        valid = lab != ignore_index
        safe = torch.where(valid, lab, torch.zeros_like(lab))
        loss = -torch.take_along_dim(logp, safe.unsqueeze(1), dim=1).squeeze(1)
        wt = w[0][safe] if w else torch.ones_like(loss)
        zero = torch.zeros((), dtype=loss.dtype, device=loss.device)
        loss = torch.where(valid, loss * wt, zero)
        if reduction == "mean":
            return torch.sum(loss) / torch.clamp(
                torch.sum(torch.where(valid, wt, zero)), min=1e-12)
        if reduction == "sum":
            return torch.sum(loss)
        return loss

    return forward_op("nll_loss", impl, args)


def l1_loss(input, label, reduction="mean", name=None):  # noqa: A002
    return forward_op("l1_loss",
                      lambda a, b: _reduce(torch.abs(a - b), reduction),
                      [ensure_tensor(input), ensure_tensor(label)])


def smooth_l1_loss(input, label, reduction="mean", delta=1.0, name=None):  # noqa: A002
    def impl(a, b):
        d = a - b
        ad = torch.abs(d)
        loss = torch.where(ad < delta, 0.5 * d * d / delta, ad - 0.5 * delta)
        # paddle multiplies by delta (huber normalization)
        return _reduce(loss * delta, reduction)

    return forward_op("smooth_l1_loss", impl,
                      [ensure_tensor(input), ensure_tensor(label)])


def binary_cross_entropy(input, label, weight=None, reduction="mean", name=None):  # noqa: A002
    args = [ensure_tensor(input), ensure_tensor(label)] + \
        ([ensure_tensor(weight)] if weight is not None else [])

    def impl(p, y, *w):
        p = torch.clamp(p, 1e-12, 1.0 - 1e-12)
        loss = -(y * torch.log(p) + (1 - y) * torch.log1p(-p))
        if w:
            loss = loss * w[0]
        return _reduce(loss, reduction)

    return forward_op("binary_cross_entropy", impl, args)


def binary_cross_entropy_with_logits(logit, label, weight=None, reduction="mean",
                                     pos_weight=None, name=None):
    args = [ensure_tensor(logit), ensure_tensor(label)]
    if weight is not None:
        args.append(ensure_tensor(weight))
    if pos_weight is not None:
        args.append(ensure_tensor(pos_weight))

    def impl(z, y, *extra):
        w = extra[0] if weight is not None else None
        pw = extra[-1] if pos_weight is not None else None
        log_sig_pos = -TF.softplus(-z)
        log_sig_neg = -z - TF.softplus(-z)
        if pw is not None:
            loss = -(pw * y * log_sig_pos + (1 - y) * log_sig_neg)
        else:
            loss = -(y * log_sig_pos + (1 - y) * log_sig_neg)
        if w is not None:
            loss = loss * w
        return _reduce(loss, reduction)

    return forward_op("bce_with_logits", impl, args)


def kl_div(input, label, reduction="mean", log_target=False, name=None):  # noqa: A002
    def impl(logp, y):
        if log_target:
            loss = torch.exp(y) * (y - logp)
        else:
            loss = y * (torch.log(torch.clamp(y, min=1e-12)) - logp)
        if reduction == "batchmean":
            return torch.sum(loss) / logp.shape[0]
        return _reduce(loss, reduction)

    return forward_op("kl_div", impl, [ensure_tensor(input), ensure_tensor(label)])


def margin_ranking_loss(input, other, label, margin=0.0, reduction="mean", name=None):  # noqa: A002
    return forward_op(
        "margin_ranking_loss",
        lambda a, b, y: _reduce(torch.clamp(-y * (a - b) + margin, min=0.0),
                                reduction),
        [ensure_tensor(input), ensure_tensor(other), ensure_tensor(label)])


def hinge_embedding_loss(input, label, margin=1.0, reduction="mean", name=None):  # noqa: A002
    return forward_op(
        "hinge_embedding_loss",
        lambda x, y: _reduce(torch.where(y == 1, x,
                                         torch.clamp(margin - x, min=0.0)),
                             reduction),
        [ensure_tensor(input), ensure_tensor(label)])


def cosine_embedding_loss(input1, input2, label, margin=0.0, reduction="mean",
                          name=None):
    def impl(a, b, y):
        cos = torch.sum(a * b, -1) / (torch.linalg.vector_norm(a, dim=-1) *
                                      torch.linalg.vector_norm(b, dim=-1) + 1e-12)
        loss = torch.where(y == 1, 1 - cos, torch.clamp(cos - margin, min=0.0))
        return _reduce(loss, reduction)

    return forward_op("cosine_embedding_loss", impl,
                      [ensure_tensor(input1), ensure_tensor(input2),
                       ensure_tensor(label)])


def _pdist(a, b, p):
    return torch.sum(torch.abs(a - b) ** p, -1) ** (1 / p)


def triplet_margin_loss(input, positive, negative, margin=1.0, p=2.0, epsilon=1e-6,  # noqa: A002
                        swap=False, reduction="mean", name=None):
    def impl(a, pos, neg):
        dp = _pdist(a, pos, p)
        dn = _pdist(a, neg, p)
        if swap:
            dn = torch.minimum(dn, _pdist(pos, neg, p))
        return _reduce(torch.clamp(dp - dn + margin, min=0.0), reduction)

    return forward_op("triplet_margin_loss", impl,
                      [ensure_tensor(input), ensure_tensor(positive),
                       ensure_tensor(negative)])


def log_loss(input, label, epsilon=1e-4, name=None):  # noqa: A002
    return forward_op(
        "log_loss",
        lambda p, y: -y * torch.log(p + epsilon) - (1 - y) * torch.log(1 - p + epsilon),
        [ensure_tensor(input), ensure_tensor(label)])


def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25, gamma=2.0,
                       reduction="sum", name=None):
    args = [ensure_tensor(logit), ensure_tensor(label)] + \
        ([ensure_tensor(normalizer)] if normalizer is not None else [])

    def impl(z, y, *n):
        p = torch.sigmoid(z)
        ce = torch.clamp(z, min=0) - z * y + _log1pexp_abs(z)
        p_t = p * y + (1 - p) * (1 - y)
        a_t = alpha * y + (1 - alpha) * (1 - y)
        loss = a_t * ((1 - p_t) ** gamma) * ce
        if n:
            loss = loss / n[0]
        return _reduce(loss, reduction)

    return forward_op("sigmoid_focal_loss", impl, args)


def square_error_cost(input, label):  # noqa: A002
    return forward_op("square_error_cost", lambda a, b: torch.square(a - b),
                      [ensure_tensor(input), ensure_tensor(label)])


def dice_loss(input, label, epsilon=1e-5, name=None):  # noqa: A002
    def impl(p, y):
        # one-hot by comparison: an out-of-range label gives a zero row
        y1 = (y.squeeze(-1)[..., None] ==
              torch.arange(p.shape[-1], device=p.device)).to(p.dtype)
        dims = tuple(range(1, p.dim()))
        inter = torch.sum(p * y1, dim=dims)
        union = torch.sum(p, dim=dims) + torch.sum(y1, dim=dims)
        return torch.mean(1 - (2 * inter + epsilon) / (union + epsilon))

    return forward_op("dice_loss", impl, [ensure_tensor(input), ensure_tensor(label)])


def huber_loss(input, label, delta=1.0, reduction="mean", name=None):  # noqa: A002
    """ref: paddle.nn.functional.huber_loss (quadratic within delta)."""
    def f(a, b):
        d = a - b
        ad = torch.abs(d)
        out = torch.where(ad <= delta, 0.5 * d * d, delta * (ad - 0.5 * delta))
        return _reduce(out, reduction)
    return forward_op("huber_loss", f, [ensure_tensor(input), ensure_tensor(label)])


def soft_margin_loss(input, label, reduction="mean", name=None):  # noqa: A002
    """ref: soft_margin_loss — log(1 + exp(-y * x)) with y in {-1, 1}."""
    return forward_op("soft_margin_loss",
                      lambda a, b: _reduce(TF.softplus(-b * a), reduction),
                      [ensure_tensor(input), ensure_tensor(label)])


def multi_label_soft_margin_loss(input, label, weight=None,  # noqa: A002
                                 reduction="mean", name=None):
    """ref: multi-label one-vs-all BCE-with-logits averaged over classes."""
    args = [ensure_tensor(input), ensure_tensor(label)] + \
        ([ensure_tensor(weight)] if weight is not None else [])

    def f(a, b, *w):
        per = -(b * TF.logsigmoid(a) + (1 - b) * TF.logsigmoid(-a))
        if w:
            per = per * w[0]
        return _reduce(per.mean(dim=-1), reduction)
    return forward_op("multi_label_soft_margin_loss", f, args)


def poisson_nll_loss(input, label, log_input=True, full=False,  # noqa: A002
                     epsilon=1e-8, reduction="mean", name=None):
    """ref: poisson_nll_loss (Stirling term when full=True)."""
    def f(a, b):
        if log_input:
            out = torch.exp(a) - b * a
        else:
            out = a - b * torch.log(a + epsilon)
        if full:
            stirling = b * torch.log(b + epsilon) - b + \
                0.5 * torch.log(2 * math.pi * (b + epsilon))
            out = out + torch.where(b > 1, stirling, torch.zeros_like(stirling))
        return _reduce(out, reduction)
    return forward_op("poisson_nll_loss", f,
                      [ensure_tensor(input), ensure_tensor(label)])


def gaussian_nll_loss(input, label, variance, full=False,  # noqa: A002
                      epsilon=1e-6, reduction="mean", name=None):
    """ref: gaussian_nll_loss — 0.5*(log var + (x-y)^2/var) [+ const]."""
    def f(a, b, var):
        var = torch.clamp(var, min=epsilon)
        out = 0.5 * (torch.log(var) + torch.square(a - b) / var)
        if full:
            out = out + 0.5 * math.log(2 * math.pi)
        return _reduce(out, reduction)
    return forward_op("gaussian_nll_loss", f,
                      [ensure_tensor(input), ensure_tensor(label),
                       ensure_tensor(variance)])


def npair_loss(anchor, positive, labels, l2_reg: float = 0.002, name=None):
    """ref: npair_loss — softmax CE over the anchor·positiveᵀ similarity
    matrix with same-label targets, plus an L2 term on the embeddings."""
    def f(av, pv, lv):
        sim = av @ pv.T                                     # [B, B]
        same = (lv[:, None] == lv[None, :]).to(av.dtype)
        tgt = same / torch.clamp(same.sum(-1, keepdim=True), min=1)
        ce = -(tgt * torch.log_softmax(sim, -1)).sum(-1).mean()
        reg = l2_reg * (torch.sum(av * av) + torch.sum(pv * pv)) \
            / (2 * av.shape[0])
        return ce + reg

    return forward_op("npair_loss", f, [ensure_tensor(anchor),
                                        ensure_tensor(positive),
                                        ensure_tensor(labels)])


def margin_cross_entropy(logits, label, margin1: float = 1.0,
                         margin2: float = 0.5, margin3: float = 0.0,
                         scale: float = 64.0, return_softmax: bool = False,
                         reduction="mean", name=None):
    """ref: margin_cross_entropy_op (ArcFace/CosFace family): the target
    class cosine becomes ``cos(m1*θ + m2) - m3``, everything scaled by
    ``scale`` before CE; ``(loss, softmax)`` when ``return_softmax``."""
    def f(lv, yv):
        yv = yv.long()
        cos_t = torch.take_along_dim(lv, yv[:, None], -1)[:, 0]
        cos_t = torch.clamp(cos_t, -1 + 1e-7, 1 - 1e-7)
        target = torch.cos(margin1 * torch.arccos(cos_t) + margin2) - margin3
        adj = lv.scatter(1, yv[:, None], target[:, None].to(lv.dtype)) * scale
        logp = torch.log_softmax(adj, -1)
        out = _reduce(-torch.take_along_dim(logp, yv[:, None], -1)[:, 0],
                      reduction)
        if return_softmax:
            return out, torch.exp(logp)
        return out

    return forward_op("margin_cross_entropy", f,
                      [ensure_tensor(logits), ensure_tensor(label)])


def rank_loss(label, left, right, name=None):
    """ref: rank_loss_op (RankNet): -label*(l-r) + log(1 + e^(l-r))."""
    def f(lv, av, bv):
        o = av - bv
        return torch.clamp(o, min=0) - o * lv + _log1pexp_abs(o)

    return forward_op("rank_loss", f, [ensure_tensor(label), ensure_tensor(left),
                                       ensure_tensor(right)])


def multi_margin_loss(input, label, p: int = 1, margin: float = 1.0,  # noqa: A002
                      weight=None, reduction="mean", name=None):
    """ref: multi_margin_loss — mean_j max(0, margin - x_y + x_j)^p."""
    args = [ensure_tensor(input), ensure_tensor(label)] + \
        ([ensure_tensor(weight)] if weight is not None else [])

    def f(xv, yv, *w):
        yv = yv.long()
        C = xv.shape[1]
        xy = torch.take_along_dim(xv, yv[:, None], -1)
        m = torch.clamp(margin - xy + xv, min=0) ** p
        if w:
            m = m * w[0][yv][:, None]
        m = m * (torch.arange(C, device=xv.device)[None] != yv[:, None])
        return _reduce(m.sum(-1) / C, reduction)

    return forward_op("multi_margin_loss", f, args)


def triplet_margin_with_distance_loss(input, positive, negative,  # noqa: A002
                                      distance_function=None,
                                      margin: float = 1.0, swap: bool = False,
                                      reduction="mean", name=None):
    """ref: triplet_margin_with_distance_loss — triplet loss under a
    user distance (defaults to L2)."""
    a, p, n = ensure_tensor(input), ensure_tensor(positive), \
        ensure_tensor(negative)
    if distance_function is not None:
        dp = distance_function(a, p)
        dn = distance_function(a, n)
        if swap:
            dn = forward_op("tmwd_min", torch.minimum,
                            [ensure_tensor(dn),
                             ensure_tensor(distance_function(p, n))])
        return forward_op(
            "triplet_margin_with_distance_loss",
            lambda d1, d2: _reduce(torch.clamp(margin + d1 - d2, min=0),
                                   reduction),
            [ensure_tensor(dp), ensure_tensor(dn)])

    def l2(x, y):
        return torch.sqrt(torch.sum((x - y) ** 2, -1) + 1e-12)

    def f(av, pv, nv):
        dp, dn = l2(av, pv), l2(av, nv)
        if swap:
            dn = torch.minimum(dn, l2(pv, nv))
        return _reduce(torch.clamp(margin + dp - dn, min=0), reduction)

    return forward_op("triplet_margin_with_distance_loss", f, [a, p, n])


def rnnt_loss(logits, labels, logit_lengths, label_lengths, blank: int = 0,
              fastemit_lambda: float = 0.0, reduction="mean", name=None):
    """RNN-T loss (ref: warprnnt_op). ``logits [B, T, U+1, K]``
    (log-probabilities are taken here), ``labels [B, U]``.

    The lattice rolls forward over t in T - 1 device steps, the whole
    ``[B, U+1]`` front at once. Within a row the emit recursion
    ``alpha[u] = logaddexp(b[u], alpha[u-1] + e[u-1])`` is solved in one
    pass: with ``c[u] = e[0] + ... + e[u-1]``,
    ``alpha[u] = c[u] + logcumsumexp(b - c)[u]``. Rows past a sequence's
    length keep its last alpha; no host read."""
    def f(lgv, lbv, ltv, utv):
        B, T, U1, _ = lgv.shape
        logp = torch.log_softmax(lgv, -1)
        blank_lp = logp[..., blank]                            # [B, T, U+1]
        emit_lp = torch.take_along_dim(
            logp[:, :, :U1 - 1, :],
            lbv.long()[:, None, :, None], -1)[..., 0]          # [B, T, U]
        if fastemit_lambda:
            emit_lp = emit_lp + math.log1p(fastemit_lambda)
        zero = torch.zeros((B, 1), dtype=logp.dtype, device=logp.device)
        # c[t, u]: the emits along row t up to column u
        csum = torch.cat([zero[:, None].expand(B, T, 1),
                          torch.cumsum(emit_lp, -1)], -1)    # [B, T, U+1]
        alpha = csum[:, 0]                                   # row t = 0
        ltv = ltv.long()
        for t in range(1, T):
            from_blank = alpha + blank_lp[:, t - 1]
            c = csum[:, t]
            row = c + torch.logcumsumexp(from_blank - c, -1)
            alpha = torch.where((t < ltv)[:, None], row, alpha)
        utv = utv.long()
        last_t = torch.clamp(ltv - 1, min=0)
        b_idx = torch.arange(B, device=logp.device)
        ll = torch.take_along_dim(alpha, utv[:, None], 1)[:, 0] + \
            blank_lp[b_idx, last_t, utv]
        return _reduce(-ll, reduction)

    return forward_op("rnnt_loss", f, [ensure_tensor(logits),
                                       ensure_tensor(labels),
                                       ensure_tensor(logit_lengths),
                                       ensure_tensor(label_lengths)])


def adaptive_log_softmax_with_loss(input, label, head_weight, tail_weights,  # noqa: A002
                                   cutoffs, head_bias=None, name=None):
    """ref: adaptive_log_softmax_with_loss — frequency-adaptive softmax:
    head classes + shortlist cluster logits, tail clusters project down
    then out. Returns (output [B] log-probs of the target, loss scalar)."""
    tws = [ensure_tensor(w) for pair in tail_weights for w in pair]
    args = [ensure_tensor(input), ensure_tensor(label),
            ensure_tensor(head_weight)] + tws + \
        ([ensure_tensor(head_bias)] if head_bias is not None else [])
    n_tail = len(tail_weights)
    shortlist = cutoffs[0]

    def f(xv, yv, hwv, *rest):
        yv = yv.long()
        head_logits = xv @ hwv                               # [B, s + n_tail]
        if head_bias is not None:
            head_logits = head_logits + rest[-1]
        head_logp = torch.log_softmax(head_logits, -1)
        out = torch.take_along_dim(
            head_logp, torch.clamp(yv, 0, shortlist - 1)[:, None], -1)[:, 0]
        lo = shortlist
        for i in range(n_tail):
            w1, w2 = rest[2 * i], rest[2 * i + 1]
            hi = cutoffs[i + 1]
            tail_logp = torch.log_softmax((xv @ w1) @ w2, -1)
            rel = torch.clamp(yv - lo, 0, hi - lo - 1)
            cand = head_logp[:, shortlist + i] + torch.take_along_dim(
                tail_logp, rel[:, None], -1)[:, 0]
            out = torch.where((yv >= lo) & (yv < hi), cand, out)
            lo = hi
        return out, -out.mean()

    return forward_op("adaptive_log_softmax_with_loss", f, args)


def class_center_sample(label, num_classes: int, num_samples: int,
                        group=None, name=None):
    """ref: class_center_sample_op (PartialFC): sample ``num_samples``
    class centers, every positive class among them (the positives first,
    ascending, then negatives drawn without replacement); returns the
    labels remapped into the sampled index space and the sampled centers.
    The negatives come from the port's generator of the label's device."""
    from ...core.tensor import _wrap
    from ...ops.random import generator
    lv = ensure_tensor(label)._value.reshape(-1).long()
    dev = lv.device
    pos = torch.unique(lv)
    is_pos = torch.zeros(num_classes, dtype=torch.bool, device=dev)
    is_pos[pos] = True
    rest = torch.nonzero(~is_pos).reshape(-1)
    n_extra = min(max(0, num_samples - pos.numel()), rest.numel())
    order = torch.randperm(rest.numel(), generator=generator(dev),
                           device=dev)[:n_extra]
    sampled = torch.cat([pos, rest[order]])
    remap = torch.full((num_classes,), -1, dtype=torch.long, device=dev)
    remap[sampled] = torch.arange(sampled.numel(), device=dev)
    return _wrap(remap[lv]), _wrap(sampled)


def center_loss(input, label, centers, alpha: float = 0.5,  # noqa: A002
                update_center: bool = True, name=None):
    """ref: center_loss_op — squared distance to the class center; returns
    ``(loss [B], new_centers)`` (the in-place CUDA center update made
    pure)."""
    def f(xv, yv, cv):
        yv = yv.long()
        diff = xv - cv[yv]
        loss = 0.5 * torch.sum(diff * diff, -1)
        if not update_center:
            return loss, cv
        cnt = torch.zeros(cv.shape[0], dtype=cv.dtype, device=cv.device) \
            .index_add(0, yv, torch.ones_like(yv, dtype=cv.dtype))
        upd = torch.zeros_like(cv).index_add(0, yv, diff)
        return loss, cv + alpha * upd / (cnt[:, None] + 1.0)

    return forward_op("center_loss", f, [ensure_tensor(input),
                                         ensure_tensor(label),
                                         ensure_tensor(centers)])


def teacher_student_sigmoid_loss(input, label,  # noqa: A002
                                 soft_max_up_bound: float = 15.0,
                                 soft_max_lower_bound: float = -15.0,
                                 name=None):
    """ref: teacher_student_sigmoid_loss_op (CTR distillation): hard CE
    when label <= 0/1 bounds, soft sigmoid regression otherwise."""
    def f(xv, yv):
        z = torch.clamp(xv, soft_max_lower_bound, soft_max_up_bound)
        log1pe = torch.clamp(z, min=0) + _log1pexp_abs(z)
        hard = torch.where(yv > 0.5, log1pe - z, log1pe)
        soft = log1pe - z * yv
        return torch.where((yv <= 0.0) | (yv >= 1.0), hard, soft)

    return forward_op("teacher_student_sigmoid_loss", f,
                      [ensure_tensor(input), ensure_tensor(label)])


def bpr_loss(input, label, name=None):  # noqa: A002
    """ref: bpr_loss_op (Bayesian Personalized Ranking): -mean over
    negatives of log sigmoid(x_pos - x_neg)."""
    def f(xv, yv):
        yv = yv.long()
        C = xv.shape[1]
        o = torch.take_along_dim(xv, yv[:, None], -1) - xv
        lse = _log1pexp_abs(o) + torch.clamp(-o, min=0)
        mask = torch.arange(C, device=xv.device)[None] != yv[:, None]
        return (lse * mask).sum(-1) / max(C - 1, 1)

    return forward_op("bpr_loss", f, [ensure_tensor(input), ensure_tensor(label)])


def cos_sim(X, Y, name=None):
    """ref: cos_sim_op — rowwise cosine similarity [B] (Y may broadcast
    from one row)."""
    def f(av, bv):
        bv = bv.expand(av.shape)
        return (av * bv).sum(-1) / torch.clamp(
            torch.linalg.vector_norm(av, dim=-1) *
            torch.linalg.vector_norm(bv, dim=-1), min=1e-12)

    return forward_op("cos_sim", f, [ensure_tensor(X), ensure_tensor(Y)])


def squared_l2_norm(x, name=None):
    """ref: squared_l2_norm_op — sum of squares (the grad-clip kernel)."""
    return forward_op("squared_l2_norm", lambda v: torch.sum(v * v),
                      [ensure_tensor(x)])


def squared_l2_distance(x, y, name=None):
    """ref: squared_l2_distance_op — rowwise sum of squared differences."""
    return forward_op("squared_l2_distance",
                      lambda a, b: torch.sum((a - b) ** 2, dim=-1),
                      [ensure_tensor(x), ensure_tensor(y)])


def modified_huber_loss(input, label, name=None):  # noqa: A002
    """ref: modified_huber_loss_op — quadratically-smoothed hinge for
    {0,1} labels: max(0, 1-yx)^2 if yx >= -1 else -4yx (y in {-1, 1})."""
    def f(xv, yv):
        z = (2.0 * yv - 1.0) * xv
        return torch.where(z >= -1.0, torch.clamp(1.0 - z, min=0) ** 2, -4.0 * z)

    return forward_op("modified_huber_loss", f,
                      [ensure_tensor(input), ensure_tensor(label)])


def identity_loss(x, reduction="none", name=None):
    """ref: identity_loss_op — marks a value as the loss with an optional
    reduction (sum/mean/none)."""
    red = {0: "sum", 1: "mean", 2: "none"}.get(reduction, reduction)
    return forward_op("identity_loss", lambda v: _reduce(v, red),
                      [ensure_tensor(x)])


def hsigmoid_loss(input, label, num_classes: int, weight, bias=None,  # noqa: A002
                  path_table=None, path_code=None, is_sparse: bool = False,
                  name=None):
    """ref: hsigmoid_loss (hierarchical_sigmoid_op): binary classifications
    down a binary tree over the classes. The default tree is the
    reference's complete-binary coding (node ids from the class id's path,
    ``weight [num_classes - 1, D]``); a custom tree comes as ``path_table``
    / ``path_code [B, L]`` (negative entries end a path)."""
    args = [ensure_tensor(input), ensure_tensor(label), ensure_tensor(weight)]
    if path_table is not None:
        args += [ensure_tensor(path_table), ensure_tensor(path_code)]
    if bias is not None:
        args.append(ensure_tensor(bias))
    L = max(1, int(math.ceil(math.log2(max(num_classes, 2)))))

    def f(xv, yv, wv, *rest):
        bv = rest[-1] if bias is not None else None
        if path_table is not None:
            pt, pc = rest[0].long(), rest[1]
            valid = pt >= 0
            nodes = torch.clamp(pt, 0, wv.shape[0] - 1)
            codes = pc.to(xv.dtype)
        else:
            node = yv.long() + num_classes               # leaf position
            levels, code_l = [], []
            for _ in range(L):
                code_l.append((node % 2).to(xv.dtype))
                node = node // 2
                levels.append(node - 1)                  # internal id (root 0)
            nodes = torch.stack(levels[::-1], 1)         # [B, L] root->leaf
            codes = torch.stack(code_l[::-1], 1)
            valid = nodes >= 0
            nodes = torch.clamp(nodes, 0, wv.shape[0] - 1)
        logits = torch.einsum("bd,bld->bl", xv, wv[nodes])
        if bv is not None:
            logits = logits + bv.reshape(-1)[nodes]
        # BCE with the code as the target
        lse = torch.clamp(logits, min=0) - logits * codes + \
            _log1pexp_abs(logits)
        return (lse * valid).sum(-1)

    return forward_op("hsigmoid_loss", f, args)

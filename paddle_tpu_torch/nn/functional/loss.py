"""Loss functionals — the part of ``paddle_tpu/nn/functional/loss.py`` the
port has so far: ``cross_entropy``, ``mse_loss`` and ``ctc_loss``. The
reference's other losses are still to be ported (ROADMAP §A item 7)."""

from __future__ import annotations

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

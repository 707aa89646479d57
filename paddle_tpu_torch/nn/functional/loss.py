"""Loss functionals — the part of ``paddle_tpu/nn/functional/loss.py`` this
slice ports: ``cross_entropy`` and ``mse_loss``. The reference's other
losses are still to be ported (ROADMAP §A item 11)."""

from __future__ import annotations

import torch

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

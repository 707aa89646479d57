"""Gradient clipping — counterpart of ``paddle_tpu/nn/clip.py``
(ClipGradByValue, ClipGradByNorm, ClipGradByGlobalNorm, applied by the
optimizer to its ``(param, grad)`` pairs before the update)."""

from __future__ import annotations

import torch

from ..core.tensor import Tensor, _wrap

__all__ = ["ClipGradByValue", "ClipGradByNorm", "ClipGradByGlobalNorm"]


class ClipGradBase:
    def __call__(self, params_grads):
        raise NotImplementedError


def _clips(p, g) -> bool:
    return g is not None and getattr(p, "need_clip", True)


class ClipGradByValue(ClipGradBase):
    def __init__(self, max, min=None):  # noqa: A002
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def __call__(self, params_grads):
        return [(p, _wrap(torch.clamp(g._value, self.min, self.max)))
                if _clips(p, g) else (p, g) for p, g in params_grads]


class ClipGradByNorm(ClipGradBase):
    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def __call__(self, params_grads):
        out = []
        for p, g in params_grads:
            if not _clips(p, g):
                out.append((p, g))
                continue
            n = torch.sqrt(torch.sum(torch.square(g._value.float())))
            scale = torch.clamp(self.clip_norm / torch.clamp(n, min=1e-12),
                                max=1.0)
            out.append((p, _wrap((g._value * scale).to(g._value.dtype))))
        return out


class ClipGradByGlobalNorm(ClipGradBase):
    def __init__(self, clip_norm, group_name="default_group", auto_skip_clip=False):
        self.clip_norm = float(clip_norm)

    def __call__(self, params_grads):
        sq = [torch.sum(torch.square(g._value.float()))
              for p, g in params_grads if _clips(p, g)]
        if not sq:
            return params_grads
        gnorm = torch.sqrt(torch.stack(sq).sum())
        scale = torch.clamp(self.clip_norm / torch.clamp(gnorm, min=1e-12),
                            max=1.0)
        return [(p, _wrap((g._value * scale).to(g._value.dtype)))
                if _clips(p, g) else (p, g) for p, g in params_grads]


def clip_grad_norm_(parameters, max_norm, norm_type=2.0, error_if_nonfinite=False):
    """torch-style utility paddle also ships (paddle.nn.utils.clip_grad_norm_)."""
    if isinstance(parameters, Tensor):
        parameters = [parameters]
    grads = [p.grad for p in parameters if p.grad is not None]
    if not grads:
        return None
    if norm_type == float("inf"):
        total = torch.stack([g._value.abs().max() for g in grads]).max()
    else:
        total = torch.stack([torch.sum(g._value.float().abs() ** norm_type)
                             for g in grads]).sum() ** (1.0 / norm_type)
    scale = torch.clamp(max_norm / torch.clamp(total, min=1e-12), max=1.0)
    for p in parameters:
        if p.grad is not None:
            p.grad = _wrap((p.grad._value * scale).to(p.grad._value.dtype))
    return _wrap(total)

"""RoPE tables — counterpart of ``paddle_tpu/kernels/rope.py:73-81``.

Only :func:`rope_cos_sin` is ported: the paged serving entry points apply
RoPE through ``models.llama._rope`` (plain tensor ops), and the Pallas
``apply_rope`` kernel serves only the training forward, which a later
slice ports.
"""

from __future__ import annotations

import torch

__all__ = ["rope_cos_sin"]


def rope_cos_sin(seq_len: int, head_dim: int, base: float = 10000.0,
                 dtype=torch.float32, position_ids=None, device=None):
    """cos/sin tables ``[S, D]`` (or ``[..., S, D]`` for batched
    ``position_ids``) for the rotate-half convention."""
    if position_ids is not None:
        pos = torch.as_tensor(position_ids).to(torch.float32)
        device = pos.device
    else:
        pos = torch.arange(seq_len, dtype=torch.float32, device=device)
    inv = 1.0 / (base ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                       device=device) / head_dim))
    freqs = pos[..., :, None] * inv                # [..., S, D/2]
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb).to(dtype), torch.sin(emb).to(dtype)

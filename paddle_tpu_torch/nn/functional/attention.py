"""Attention functionals — counterpart of
``paddle_tpu/nn/functional/attention.py`` (Paddle's
``scaled_dot_product_attention`` / ``flash_attention``, layout
``[batch, seq, heads, head_dim]``).

``scaled_dot_product_attention`` is the eager caller of the flash
kernels: :func:`flash_route` sends a call to
``kernels.flash_attention.flash_attention`` (``flash_fwd_kernel``
forward; ``flash_bwd_dq_kernel`` and ``flash_bwd_dkv_kernel`` on
backward) when q, k and v are on the card, there is no mask and no
active dropout, and the shapes and dtypes are what ``csrc/flash_attention.cu``
takes (head_dim 64 or 128, q/k/v all float32 or all bfloat16, the query
heads a multiple of the kv heads, causal only with ``Sq <= Sk``). The
TPU gate (``D % 128``, ``Sq % 128``) belonged to that kernel's tiles. Every
other call runs :func:`_sdpa_ref`, as the reference does. The route is
an explicit condition; the kernel's launch counters show which ran.
"""

from __future__ import annotations

import math

import torch

from ...device import on_cuda
from ...ops._helpers import ensure_tensor, forward_op
from ...ops.random import generator

_FLASH_HEAD_DIMS = (64, 128)
_FLASH_DTYPES = (torch.float32, torch.bfloat16)


def _apply_mask(logits, mask):
    if mask.dtype == torch.bool:
        return logits.masked_fill(~mask, float("-inf"))
    return logits + mask


def _sdpa_ref(q, k, v, mask=None, dropout_p=0.0, causal=False, scale=None,
              keep=None):
    """Plain attention on [B, S, H, D] (``keep``: the dropout mask)."""
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    logits = torch.einsum("bhqd,bhkd->bhqk", qh, kh) * scale
    if causal:
        sq, sk = logits.shape[-2], logits.shape[-1]
        cmask = torch.ones((sq, sk), dtype=torch.bool,
                           device=q.device).tril(sk - sq)
        logits = logits.masked_fill(~cmask, float("-inf"))
    if mask is not None:
        logits = _apply_mask(logits, mask)
    probs = torch.softmax(logits.to(torch.float32), dim=-1).to(q.dtype)
    if dropout_p > 0.0 and keep is not None:
        probs = torch.where(keep, probs / (1.0 - dropout_p),
                            torch.zeros((), dtype=probs.dtype,
                                        device=probs.device))
    out = torch.einsum("bhqk,bhkd->bhqd", probs, vh)
    return out.transpose(1, 2)


def flash_route(q, k, v, causal, mask, dropout_p) -> bool:
    """Whether the call takes the flash kernels (see the module note)."""
    if mask is not None or dropout_p > 0.0 or not on_cuda(q, "flash_attention"):
        return False
    return (q.dim() == 4 and k.dim() == 4 and v.shape == k.shape
            and q.shape[-1] in _FLASH_HEAD_DIMS and k.shape[-1] == q.shape[-1]
            and q.dtype in _FLASH_DTYPES and k.dtype == q.dtype
            and v.dtype == q.dtype and q.shape[0] == k.shape[0]
            and q.shape[2] % k.shape[2] == 0
            and not (causal and q.shape[1] > k.shape[1]))


def scaled_dot_product_attention(query, key, value, attn_mask=None, dropout_p=0.0,
                                 is_causal=False, training=True, name=None):
    """Attention in paddle's [B, S, H, D] layout: the flash kernels where
    :func:`flash_route` allows, else the plain formula."""
    query, key, value = ensure_tensor(query), ensure_tensor(key), ensure_tensor(value)
    args = [query, key, value]
    if attn_mask is not None:
        args.append(ensure_tensor(attn_mask))
    p = dropout_p if training else 0.0
    keep = None
    if p > 0.0:
        q0, k0 = query._value, key._value
        shape = (q0.shape[0], q0.shape[2], q0.shape[1], k0.shape[1])
        keep = torch.empty(shape, device=q0.device).uniform_(
            generator=generator(q0.device)) < (1.0 - p)
    use_flash = flash_route(query._value, key._value, value._value, is_causal,
                            attn_mask, p)

    def impl(q, k, v, *m):
        if use_flash:
            from ...kernels.flash_attention import flash_attention
            return flash_attention(q, k, v, causal=is_causal)
        return _sdpa_ref(q, k, v, m[0] if m else None, p, is_causal, keep=keep)

    return forward_op("scaled_dot_product_attention", impl, args)


def attention_probs(query, key, attn_mask=None, scale=None):
    """Materialized softmax attention weights [B, H, Sq, Sk] (need_weights path)."""
    query, key = ensure_tensor(query), ensure_tensor(key)
    args = [query, key]
    if attn_mask is not None:
        args.append(ensure_tensor(attn_mask))

    def impl(q, k, *m):
        d = q.shape[-1]
        s = scale if scale is not None else 1.0 / math.sqrt(d)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * s
        if m:
            logits = _apply_mask(logits, m[0])
        return torch.softmax(logits.to(torch.float32), dim=-1).to(q.dtype)

    return forward_op("attention_probs", impl, args)


def flash_attention(query, key, value, dropout=0.0, causal=False,
                    return_softmax=False, name=None, fixed_seed_offset=None,
                    rng_name="", training=True):
    """paddle.nn.functional.flash_attention.flash_attention parity: returns
    (out, softmax); softmax is None unless return_softmax (flash never materializes
    the probability matrix — same contract as the reference kernel)."""
    out = scaled_dot_product_attention(query, key, value, None, dropout, causal,
                                       training)
    return out, None


def sequence_mask(x, maxlen=None, dtype="int64", name=None):
    from ...core.dtype import canonical_dtype
    x = ensure_tensor(x)
    ml = int(maxlen) if maxlen is not None else int(x.numpy().max())
    dt = canonical_dtype(dtype)

    def impl(v):
        return (torch.arange(ml, device=v.device) < v[..., None]).to(dt)

    return forward_op("sequence_mask", impl, [x], differentiable=False)

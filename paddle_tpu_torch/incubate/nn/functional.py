"""incubate.nn.functional — the fused-op names this slice ports, the eager
callers of the RoPE and RMSNorm kernels: ``fused_rotary_position_embedding``
and ``fused_rms_norm`` (counterpart of
``paddle_tpu/incubate/nn/functional.py:32-65``). The module's other fused
names are still to be ported (ROADMAP §A item 11).

Both call the kernel wrappers directly: ``kernels.rope.apply_rope`` (with
tables from ``rope_cos_sin``) and ``kernels.rms_norm.rms_norm``, which
launch ``csrc/rope.cu`` and ``csrc/rms_norm.cu`` on CUDA tensors (x
float32 or bfloat16) and run their plain versions on CPU tensors.
"""

from __future__ import annotations

from ...ops._helpers import ensure_tensor, forward_op

__all__ = ["fused_rotary_position_embedding", "fused_rms_norm"]


def fused_rotary_position_embedding(q, k=None, v=None, sin=None, cos=None,
                                    position_ids=None, use_neox_rotary_style=True,
                                    time_major=False, rotary_emb_base=10000.0):
    """ref: incubate fused_rope — applies RoPE to q/k (v passes through).
    q/k: [B, S, H, D]; sin/cos default to tables built from rotary_emb_base."""
    from ...kernels.rope import apply_rope, rope_cos_sin
    qt = ensure_tensor(q)
    B, S, H, D = qt.shape
    dev = qt._value.device
    if cos is None or sin is None:
        pos = None if position_ids is None else \
            ensure_tensor(position_ids)._value.to(dev)
        cos_v, sin_v = rope_cos_sin(S, D, rotary_emb_base, position_ids=pos,
                                    device=dev)
    else:
        cos_v = ensure_tensor(cos)._value.reshape(S, D)
        sin_v = ensure_tensor(sin)._value.reshape(S, D)

    def rope_one(t):
        return forward_op("fused_rope",
                          lambda x: apply_rope(x, cos_v, sin_v), [t])
    out_q = rope_one(qt)
    out_k = rope_one(ensure_tensor(k)) if k is not None else None
    out_v = ensure_tensor(v) if v is not None else None
    return out_q, out_k, out_v


def fused_rms_norm(x, norm_weight, norm_bias=None, epsilon=1e-6,
                   begin_norm_axis=-1, **kwargs):
    """ref: incubate fused_rms_norm — the RMSNorm kernel's Function."""
    from ...kernels.rms_norm import rms_norm
    t, w = ensure_tensor(x), ensure_tensor(norm_weight)
    out = forward_op("fused_rms_norm",
                     lambda v, wv: rms_norm(v, wv, epsilon), [t, w])
    if norm_bias is not None:
        out = out + ensure_tensor(norm_bias)
    return out

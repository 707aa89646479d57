"""The port's kernels: hand-written CUDA C++ for Hopper (``csrc/``), each
wrapped beside its plain PyTorch version (counterpart of
``paddle_tpu/kernels``). Importing this package builds nothing; a kernel
is compiled at its first launch (``build.py``)."""

from .flash_attention import flash_attention, flash_attention_with_lse
from .paged_attention import paged_attention
from .quant_matmul import weight_only_matmul
from .rms_norm import rms_norm
from .rope import apply_rope

__all__ = ["apply_rope", "flash_attention", "flash_attention_with_lse",
           "paged_attention", "rms_norm", "weight_only_matmul",
           "launch_counts", "set_launch_counts", "add_launch_counts",
           "count_delta"]

# every wrapper's launch counters: (wrapper, attribute); a dict-valued
# counter holds one count per route
_COUNTERS = ((paged_attention, "launches"),
             (paged_attention, "launches_multiquery"),
             (paged_attention, "launches_int8"),
             (weight_only_matmul, "launches"),
             (flash_attention, "launches"),
             (flash_attention, "launches_bwd_dq"),
             (flash_attention, "launches_bwd_dq_by_route"),
             (flash_attention, "launches_bwd_dkv"),
             (rms_norm, "launches"),
             (rms_norm, "launches_by_route"),
             (rms_norm, "launches_bwd"),
             (rms_norm, "launches_bwd_by_route"),
             (apply_rope, "launches"),
             (apply_rope, "launches_bwd"))


def launch_counts():
    """A copy of every launch counter, in ``_COUNTERS``' order."""
    return [dict(v) if isinstance(v, dict) else v
            for v in (getattr(o, a) for o, a in _COUNTERS)]


def set_launch_counts(counts) -> None:
    """Set every launch counter from :func:`launch_counts`' list."""
    for (o, a), v in zip(_COUNTERS, counts):
        setattr(o, a, dict(v) if isinstance(v, dict) else v)


def add_launch_counts(delta) -> None:
    """Add a difference of two :func:`launch_counts` lists (what a
    replayed CUDA graph launched: the wrappers do not run then)."""
    for (o, a), d in zip(_COUNTERS, delta):
        if isinstance(d, dict):
            cur = getattr(o, a)
            for k, n in d.items():
                cur[k] = cur.get(k, 0) + n
        elif d:
            setattr(o, a, getattr(o, a) + d)


def count_delta(before, after):
    """``after - before`` of two :func:`launch_counts` lists."""
    return [({k: v - b.get(k, 0) for k, v in a.items()}
             if isinstance(a, dict) else a - b)
            for b, a in zip(before, after)]

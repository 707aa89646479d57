"""Device resolution — the port's one gate between the card and the CPU.

Counterpart of ``paddle_tpu/kernels/dispatch.py`` (``on_tpu`` /
``interpret`` / ``use_pallas``). The rule is simpler here: a kernel
wrapper launches its CUDA kernel for a tensor on a CUDA device and runs
its plain PyTorch version for a tensor on the CPU — nothing else decides.
Entry points that create tensors (``init_params``, ``init_paged_pool``,
``ServingEngine``) resolve their ``device`` argument through
:func:`resolve_device`: ``cuda`` by default, ``cpu`` only when asked, and
an error — never a quiet CPU run — when no card is present.
"""

from __future__ import annotations

import functools
from typing import Any, Optional

import torch

__all__ = ["on_cuda", "resolve_device", "resolve_paged_kernel", "sm_count"]

_ON = (True, 1, "on", "1", "true", "yes")
_OFF = (None, False, 0, "off", "0", "false", "no", "none", "")


def on_cuda(t: torch.Tensor, what: str) -> bool:
    """The kernel gate: ``True`` for a tensor on a CUDA device (launch the
    kernel), ``False`` for one on the CPU (run the plain version); any
    other device raises naming the wrapper ``what``."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {t.device}")
    return True


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """The streaming multiprocessors of a CUDA ``device``: the kernels'
    plans size their grids (splits over K or KV) to fill them."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def resolve_device(device: Optional[Any] = None) -> torch.device:
    """``None`` -> the current CUDA device (raises when there is none);
    anything else -> ``torch.device(device)``, checked to exist."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "paddle_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; options: 'cuda', 'cpu'")
    return dev


def resolve_paged_kernel(knob: Any, device: torch.device) -> bool:
    """Resolve a paged-attention on/off/auto knob for ``device``:
    ``"auto"`` means the CUDA kernel on a card and the gather path on the
    CPU; ``True``/``"on"`` forces the kernel wrapper (its plain version on
    the CPU); ``False``/``None``/``"off"`` forces the gather path. Unknown
    values raise naming the options."""
    k = knob.strip().lower() if isinstance(knob, str) else knob
    if isinstance(k, str):
        if k == "auto":
            return device.type == "cuda"
        if k in _ON:
            return True
        if k in _OFF:
            return False
    elif k in (True, False, None) or isinstance(k, int):
        return bool(k)
    raise ValueError(f"unknown kernel-dispatch knob {knob!r}; options: "
                     f"True/'on', False/'off'/None, 'auto'")

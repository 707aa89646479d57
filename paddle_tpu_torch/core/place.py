"""Device placement — counterpart of ``paddle_tpu/core/place.py``.

``CUDAPlace(i)`` and ``set_device("gpu:i" | "cuda:i")`` map to
``torch.device("cuda", i)``, ``CPUPlace()`` and ``set_device("cpu")`` to
the CPU. The reference's ``TPUPlace`` and ``XPUPlace`` are accepted as
aliases of ``CUDAPlace``, as the reference accepts ``CUDAPlace`` for its
accelerator. The default place is ``gpu:0``: on a host with no card the
first tensor that needs it raises naming ``paddle.set_device("cpu")`` —
nothing falls back to the CPU on its own.

The current place is one process-wide setting (the reference keeps it per
thread); ``set_device`` in a test fixture covers every thread it starts.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["Place", "CPUPlace", "CUDAPlace", "TPUPlace", "XPUPlace",
           "set_device", "get_device", "device_count", "is_compiled_with_cuda",
           "is_compiled_with_xpu", "is_compiled_with_tpu", "torch_device",
           "place_of"]


class Place:
    """Base place. Equality by (kind, device id)."""

    kind = "undefined"

    def __init__(self, device_id: int = 0):
        self.device_id = int(device_id)

    def __eq__(self, other):
        return isinstance(other, Place) and self.kind == other.kind \
            and self.device_id == other.device_id

    def __hash__(self):
        return hash((self.kind, self.device_id))

    def __repr__(self):
        return f"Place({self.kind}:{self.device_id})"

    def get_device_id(self) -> int:
        return self.device_id

    def is_cpu_place(self):
        return self.kind == "cpu"

    def is_gpu_place(self):
        return self.kind == "gpu"

    # the reference's accelerator spelling
    is_tpu_place = is_gpu_place


class CPUPlace(Place):
    kind = "cpu"

    def __init__(self):
        super().__init__(0)


class CUDAPlace(Place):
    kind = "gpu"


def TPUPlace(device_id: int = 0) -> CUDAPlace:  # noqa: N802 — Paddle name
    return CUDAPlace(device_id)


def XPUPlace(device_id: int = 0) -> CUDAPlace:  # noqa: N802
    return CUDAPlace(device_id)


_place: Optional[Place] = None


def _current_place() -> Place:
    return _place if _place is not None else CUDAPlace(0)


def _parse(device) -> Place:
    if isinstance(device, Place):
        return device
    if isinstance(device, torch.device):
        return CPUPlace() if device.type == "cpu" else \
            CUDAPlace(device.index or 0)
    s = str(device).lower()
    if s == "cpu":
        return CPUPlace()
    name, _, idx = s.partition(":")
    if name in ("gpu", "cuda", "tpu", "xpu"):
        return CUDAPlace(int(idx) if idx else 0)
    raise ValueError(f"unknown device {device!r}; options: 'cpu', 'gpu:i', "
                     f"'cuda:i'")


def set_device(device) -> Place:
    """``paddle.set_device('gpu:0' | 'cuda:0' | 'cpu' | Place)``."""
    global _place
    _place = _parse(device)
    return _place


def get_device() -> str:
    p = _current_place()
    return "cpu" if p.is_cpu_place() else f"gpu:{p.device_id}"


def torch_device(place=None) -> torch.device:
    """The ``torch.device`` of ``place`` (a Place, a string, a torch
    device; the current place when None). A card that is not there
    raises, naming ``paddle.set_device("cpu")``."""
    p = _current_place() if place is None else _parse(place)
    if p.is_cpu_place():
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "paddle_tpu_torch places tensors on gpu:0 by default and no CUDA "
            "device is available; call paddle.set_device(\"cpu\") to run on "
            "the CPU")
    return torch.device("cuda", p.device_id)


def place_of(t: torch.Tensor) -> Place:
    return CPUPlace() if t.device.type == "cpu" else \
        CUDAPlace(t.device.index or 0)


def device_count() -> int:
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def is_compiled_with_cuda() -> bool:
    return torch.cuda.is_available()


def is_compiled_with_xpu() -> bool:
    return False


def is_compiled_with_tpu() -> bool:
    return False

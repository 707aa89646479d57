"""PyTorch/CUDA port of ``paddle_tpu``'s paged LLaMA serving path.

The package keeps the JAX package's module layout (``models/llama.py``,
``models/generation.py``, ``inference/serving/*``, ``kernels/*``) so every
module has a counterpart a reader can find, but it imports only ``torch``
and numpy — never ``jax`` and nothing of ``paddle_tpu``. The two Pallas
kernels of the serving path are hand-written CUDA C++ for Hopper
(``csrc/``), built with ``nvcc`` at first use (``kernels/build.py``).

Entry points take an explicit ``device`` and run on ``cuda`` unless the
caller passes ``device="cpu"``; with no card and no ``device="cpu"`` they
raise (:func:`paddle_tpu_torch.device.resolve_device`).
"""

from .device import resolve_device

__all__ = ["resolve_device"]

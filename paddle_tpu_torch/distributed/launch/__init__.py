"""``python -m paddle_tpu_torch.distributed.launch`` — the process launcher,
counterpart of ``paddle_tpu/distributed/launch/`` (one process a rank, the
``PADDLE_TRAINER_*`` environment, per-rank log files, the failure watch and
elastic restarts). See ``main.py``.
"""

from .main import main  # noqa: F401

__all__ = ["main"]

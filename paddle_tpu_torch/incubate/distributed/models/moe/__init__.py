"""Paddle's import location for MoE (``incubate/distributed/models/moe``);
the implementation is ``paddle_tpu_torch.distributed.moe``."""

from .....distributed.moe import GShardGate, MoELayer, NaiveGate, SwitchGate

__all__ = ["MoELayer", "NaiveGate", "SwitchGate", "GShardGate"]

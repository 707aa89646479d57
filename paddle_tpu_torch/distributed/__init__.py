"""Distributed pieces of the port — counterpart of ``paddle_tpu/distributed``:
the MoE routing math, the serving tensor-parallel placement and shard
helpers, and the checkpoint stack (``checkpoint``: sharded save,
reshard-on-load, ``AsyncCheckpointer``)."""

from . import checkpoint
from .checkpoint import AsyncCheckpointer, load_state_dict, save_state_dict

__all__ = ["checkpoint", "save_state_dict", "load_state_dict",
           "AsyncCheckpointer"]

"""Serving tensor-parallel placement — counterpart of ``tp_mesh`` in
``paddle_tpu/distributed/topology.py``.

The JAX engine is one host program over a ``"tp"`` mesh; the port is one
host program over a PLACEMENT: an ordered list of ``tp`` devices, shard
``s`` of the QKV projections and of the paged KV pool living on entry
``s`` and everything replicated on entry 0 (the lead device). Entries may
repeat, so every shard can sit on one card (or on the CPU, the
counterpart of the test suite's virtual host devices): an in-process
fleet stacks its TP replicas on the same slice, as the reference's does.
"""

from __future__ import annotations

from typing import Any, List, Sequence, Union

import torch

from ..device import resolve_device

__all__ = ["tp_devices"]


def tp_devices(tp: int, device: Union[None, Any, Sequence[Any]] = None
               ) -> List[torch.device]:
    """The placement of a serving engine at tensor-parallel degree ``tp``.

    * ``"cpu"``: ``[cpu] * tp``;
    * ``None`` / ``"cuda"``: ``cuda:0 .. cuda:tp-1`` (``"cuda:i"``: from
      ``cuda:i`` on; at ``tp == 1`` the device as given), or a structured
      error when the platform has fewer CUDA devices than that — a
      placement never shrinks and never falls back to the CPU;
    * a list or tuple of ``tp`` devices: used as given, repeats allowed
      (two shards on one card: ``["cuda:0", "cuda:0"]``).

    ``tp < 1`` raises the reference's ">= 1" error."""
    tp = int(tp)
    if tp < 1:
        raise ValueError(f"tensor-parallel degree must be >= 1, got {tp}")
    if isinstance(device, (list, tuple)):
        if len(device) != tp:
            raise ValueError(
                f"tensor-parallel degree tp={tp} needs {tp} devices but "
                f"the placement lists {len(device)} ({list(device)}); "
                f"give one device a shard")
        return [_indexed(resolve_device(d)) for d in device]
    dev = resolve_device(device)
    if dev.type == "cpu" or tp == 1:
        return [dev] * tp
    first = dev.index or 0
    n = torch.cuda.device_count()
    if first + tp > n:
        raise ValueError(
            f"tensor-parallel degree tp={tp} needs {tp} devices but the "
            f"platform has {n - first} (from cuda:{first}); lower "
            f"ServingConfig.tp / FLAGS_serving_tp, or place several shards "
            f"on one card with device=['cuda:0', 'cuda:0', ...]")
    return [torch.device("cuda", first + s) for s in range(tp)]


def _indexed(dev: torch.device) -> torch.device:
    """A CUDA device with its index (an index-less ``cuda`` is the current
    device), so placements compare equal to tensors' devices."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev

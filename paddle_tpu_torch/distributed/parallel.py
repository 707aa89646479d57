"""Data parallelism and the parallel environment — counterpart of
``paddle_tpu/distributed/parallel.py`` (``DataParallel``, ``ParallelEnv``).

``DataParallel(layers)`` lays every parameter of ``layers`` out replicated
over the hybrid mesh (one copy per coordinate, each its own leaf; an
already distributed parameter keeps its layout). ``forward`` calls the
wrapped layers ONCE on the whole batch, at the coordinate eager code runs
at (the lead), as the reference calls them once on the batch sharded over
dp: whatever the model reduces itself is reduced over the whole batch —
a token mean over the labels that are not -100, MoE routing with the
batch's capacity and aux loss, a sum, BatchNorm's statistics. Running
the pieces apart would change each of those (a mean of per-piece means is
not the token mean), and on one placement device it would buy nothing.
The lead replica's locals take the gradient; a parameter's ``.grad`` sums
its replicas' (the others add nothing) and the optimizer applies it to
every replica, which is the reference's gradient all-reduce: the replicas
stay bit-equal.
"""

from __future__ import annotations

import warnings

from ..core.tensor import Tensor
from ..nn.layer import Layer
from . import collective
from .dist_tensor import DistTensor, anchor, distribute
from .topology import get_hybrid_communicate_group

__all__ = ["DataParallel", "ParallelEnv"]


class ParallelEnv:
    """``paddle.distributed.ParallelEnv``: this process's rank and the
    process count (1 and 0 unless launched)."""

    @property
    def rank(self) -> int:
        return collective.get_rank()

    @property
    def world_size(self) -> int:
        return collective.get_world_size()

    @property
    def device_id(self) -> int:
        import os
        return int(os.environ.get("PADDLE_LOCAL_RANK", 0)) \
            if collective._launched() else 0

    @property
    def nranks(self) -> int:
        return self.world_size

    local_rank = rank

    @property
    def dev_id(self) -> int:
        return self.device_id


class DataParallel(Layer):
    """Split the batch over the dp axis; replicate the parameters (see the
    module note)."""

    def __init__(self, layers: Layer, strategy=None, comm_buffer_size_MB: int = 25,
                 last_comm_buffer_size_MB: int = 1, find_unused_parameters=False,
                 group=None):
        super().__init__()
        self._layers = layers
        self._mesh = get_hybrid_communicate_group().mesh
        self._axis = "dp"
        for p in layers.parameters():
            if not isinstance(p, DistTensor):
                distribute(p, self._mesh, ())

    def _place(self, t, n: int, lead):
        """``t`` on the lead device; a batch dim that does not split over
        dp warns, as the reference's (which then leaves it replicated)."""
        if not isinstance(t, Tensor) or t.ndim == 0:
            return t
        if n > 1 and t.shape[0] % n:
            warnings.warn(
                f"DataParallel: batch dim {t.shape[0]} is not divisible by "
                f"dp degree {n}; input stays replicated (no data parallelism "
                f"for this tensor)", RuntimeWarning, stacklevel=4)
        return t if t._value.device == lead else t.to(lead)

    def forward(self, *args, **kwargs):
        mesh = self._mesh
        n = int(mesh.shape[self._axis])
        lead = mesh.devices[anchor(mesh)]
        args = tuple(self._place(a, n, lead) for a in args)
        kwargs = {k: self._place(v, n, lead) for k, v in kwargs.items()}
        return self._layers(*args, **kwargs)

    # the wrapped layer's module surface
    def parameters(self, include_sublayers=True):
        return self._layers.parameters(include_sublayers)

    def named_parameters(self, prefix="", include_sublayers=True):
        return self._layers.named_parameters(prefix, include_sublayers)

    def state_dict(self, *a, **k):
        return self._layers.state_dict(*a, **k)

    def set_state_dict(self, *a, **k):
        return self._layers.set_state_dict(*a, **k)

    def scale_loss(self, loss):
        return loss         # the gradients are exact sums; no rescale

    def apply_collective_grads(self):
        return None         # the parameters' .grad already sums replicas


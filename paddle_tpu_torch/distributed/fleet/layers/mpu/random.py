"""Tensor-parallel RNG state tracking — counterpart of
``paddle_tpu/distributed/fleet/layers/mpu/random.py`` (``RNGStatesTracker``,
``get_rng_state_tracker``, ``model_parallel_random_seed``).

A tracker state is a named :class:`~.....ops.random.Generator` (one
``torch.Generator`` per device, seeded once). Inside ``rng_state(name)``
that set stands in for the global one, so dropout and every other draw in
the block take the named stream; leaving restores the global stream where
it was. ``next_key`` draws a fresh 64-bit key from the active stream (the
global one outside any ``rng_state``); inside a region each coordinate's
key has its rank along the mp axis added, so model-parallel ranks
decorrelate as the reference's fold-in does.
"""

from __future__ import annotations

import contextlib
from typing import Dict

import torch

from ....dist_tensor import in_region, region_axis_bound
from .....ops import random as _random

__all__ = ["RNGStatesTracker", "get_rng_state_tracker",
           "model_parallel_random_seed", "MODEL_PARALLEL_RNG"]

MODEL_PARALLEL_RNG = "model_parallel_rng"


class RNGStatesTracker:
    def __init__(self):
        self.states_: Dict[str, _random.Generator] = {}
        self.seeds_ = set()
        self._active = None

    def reset(self):
        self.states_ = {}
        self.seeds_ = set()
        self._active = None

    def get_states_tracker(self):
        return {k: g.get_state() for k, g in self.states_.items()}

    def set_states_tracker(self, states):
        for k, st in states.items():
            if k not in self.states_:
                self.states_[k] = _random.Generator(0)
            self.states_[k].set_state(st)

    def add(self, name: str, seed: int):
        if seed in self.seeds_:
            raise ValueError(f"seed {seed} already exists")
        self.seeds_.add(seed)
        if name in self.states_:
            raise ValueError(f"state {name!r} already exists")
        self.states_[name] = _random.Generator(seed)

    @contextlib.contextmanager
    def rng_state(self, name: str = MODEL_PARALLEL_RNG):
        if name not in self.states_:
            raise ValueError(f"state {name!r} does not exist")
        prev, prev_gen = self._active, _random._default_generator
        self._active = name
        _random._default_generator = self.states_[name]
        try:
            yield
        finally:
            self._active = prev
            _random._default_generator = prev_gen

    def next_key(self, axis: str = "mp") -> torch.Tensor:
        """A fresh key (an int64 scalar) from the active stream; inside a
        region with ``axis``, a region value with each coordinate's mp rank
        added."""
        g = _random.generator(torch.device("cpu"))
        key = torch.randint(0, 2 ** 62, (), generator=g, dtype=torch.int64)
        if region_axis_bound(axis):
            region = in_region()
            return region.wrap({c: key + region.mesh.rank_in(c, (axis,))
                                for c in region.coords})
        return key


_TRACKER = RNGStatesTracker()


def get_rng_state_tracker() -> RNGStatesTracker:
    return _TRACKER


def model_parallel_random_seed(seed: int = 100):
    """Seed the tracker: the global stream every rank shares, and the
    model-parallel stream (seed + 1024) that decorrelates."""
    _TRACKER.reset()
    _random.seed(seed)
    _TRACKER.add(MODEL_PARALLEL_RNG, seed + 1024)

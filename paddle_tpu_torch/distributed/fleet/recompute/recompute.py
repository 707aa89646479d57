"""Activation recomputation (gradient checkpointing) — counterpart of
``paddle_tpu/distributed/fleet/recompute/recompute.py`` (``recompute``,
``recompute_sequential``).

``recompute(function, *args)`` runs ``function`` under PyTorch's
non-reentrant checkpoint: the forward keeps only the inputs, and backward
runs ``function`` again to rebuild what it needs. Parameters the function
closes over (layer weights, distributed locals) get their gradients as
usual, because the checkpoint works on the tensors autograd saves, not on
the argument list.

* RNG: the port's draws come from its own per-device generators
  (``ops.random``), so the generator set active at the call is stashed
  and put back for the recomputation: dropout draws the same mask in the
  forward and in the recomputed pass.
* State writes: the first call of a callable runs it once under
  ``no_grad`` with every in-place write watched (and then undone, the RNG
  rewound). A function that writes framework state (BatchNorm running
  statistics) runs unchecked, with a ``RuntimeWarning``, so the writes
  happen once; a pure one is remembered in ``_STATE_CACHE`` (keyed by the
  callable, or by a bound method's object and function) and later calls
  skip the check.
* Outputs: Tensors come back as Tensors, any other leaf (a raw torch
  value) as it was returned.
"""

from __future__ import annotations

import math
import warnings
import weakref
from typing import Any, Callable, List

import torch
from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

from ....core import autograd
from ....core import tensor as _tensor
from ....core.tensor import Tensor, _wrap
from ....ops import random as _random

__all__ = ["recompute", "recompute_sequential"]

_STATE_CACHE: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _cache_entry(function):
    """(weak key, sub key): a bound method is made anew at every attribute
    access, so it keys on ``__self__`` with ``__func__`` as the sub key —
    two methods of one object keep separate entries."""
    if hasattr(function, "__self__") and hasattr(function, "__func__"):
        return function.__self__, function.__func__
    return function, None


def _known_pure(function) -> bool:
    key, sub = _cache_entry(function)
    try:
        entry = _STATE_CACHE.get(key)
    except TypeError:
        return False
    return isinstance(entry, dict) and sub in entry


def _remember_pure(function):
    key, sub = _cache_entry(function)
    try:
        per_obj = _STATE_CACHE.get(key)
        if not isinstance(per_obj, dict):
            per_obj = {}
            _STATE_CACHE[key] = per_obj
        per_obj[sub] = ()
    except TypeError:
        pass        # unhashable or not weak-referenceable: no caching


def _rewind(gen, state):
    """Put the generator set back to ``state``; a device generator made
    since is dropped (it will be made again from the seed)."""
    for k in [k for k in gen._gens if k not in state]:
        del gen._gens[k]
    gen.set_state(state)


def _writes_state(function, args, kwargs) -> bool:
    """Run ``function`` once under ``no_grad`` watching in-place writes;
    undo them and rewind the RNG. True when it wrote anything."""
    gen = _random._default_generator
    rng = gen.get_state()
    _tensor._write_watch = {}
    try:
        with autograd.no_grad():
            function(*args, **kwargs)
    finally:
        written = _tensor._write_watch
        _tensor._write_watch = None
        _rewind(gen, rng)
    for t, value, version in written.values():
        t._value = value
        t._version = version
    return bool(written)


def _flatten(obj, leaves: List[Any]):
    """``obj`` with every Tensor / torch leaf replaced by its index."""
    if isinstance(obj, (Tensor, torch.Tensor)):
        leaves.append(obj)
        return _Leaf(len(leaves) - 1)
    if isinstance(obj, (list, tuple)):
        return type(obj)(_flatten(o, leaves) for o in obj)
    if isinstance(obj, dict):
        return {k: _flatten(v, leaves) for k, v in obj.items()}
    return obj


def _unflatten(obj, leaves):
    if isinstance(obj, _Leaf):
        return leaves[obj.i]
    if isinstance(obj, (list, tuple)):
        return type(obj)(_unflatten(o, leaves) for o in obj)
    if isinstance(obj, dict):
        return {k: _unflatten(v, leaves) for k, v in obj.items()}
    return obj


class _Leaf:
    __slots__ = ("i",)

    def __init__(self, i):
        self.i = i


def recompute(function: Callable, *args, **kwargs):
    """Run ``function(*args, **kwargs)`` keeping only its inputs; backward
    recomputes the rest. ``preserve_rng_state`` and ``use_reentrant`` are
    accepted (the stream is always replayed); ``offload`` warns and is
    ignored."""
    kwargs.pop("preserve_rng_state", True)
    kwargs.pop("use_reentrant", True)
    if kwargs.pop("offload", False):
        warnings.warn("recompute: offload is not supported (device-resident "
                      "checkpointing only); ignoring", RuntimeWarning)
    if not autograd.is_grad_enabled():
        return function(*args, **kwargs)
    if not _known_pure(function):
        if _writes_state(function, args, kwargs):
            warnings.warn(
                "recompute: function mutates framework state (e.g. BN running "
                "stats); running it un-checkpointed to keep the writes correct",
                RuntimeWarning)
            return function(*args, **kwargs)
        _remember_pure(function)

    in_leaves: List[Any] = []
    in_tree = _flatten((args, kwargs), in_leaves)
    is_tensor = [isinstance(t, Tensor) for t in in_leaves]
    gen = _random._default_generator
    rng = gen.get_state()
    calls = [0]
    cell = {}

    def pure(*vals):
        calls[0] += 1
        replay = calls[0] > 1
        if replay:
            now = gen.get_state()
            _rewind(gen, rng)
        try:
            leaves = [_wrap(v) if t else v for v, t in zip(vals, is_tensor)]
            call_args, call_kwargs = _unflatten(in_tree, leaves)
            out = function(*call_args, **call_kwargs)
        finally:
            if replay:
                _rewind(gen, now)
        out_leaves: List[Any] = []
        cell["tree"] = _flatten(out, out_leaves)
        cell["is_tensor"] = [isinstance(t, Tensor) for t in out_leaves]
        return tuple(t._value if isinstance(t, Tensor) else t
                     for t in out_leaves)

    vals = [t._value if isinstance(t, Tensor) else t for t in in_leaves]
    # the recomputation runs to its end: the dispatcher would otherwise
    # see torch's early-stop signal as an op's error
    with set_checkpoint_early_stop(False):
        outs = checkpoint(pure, *vals, use_reentrant=False,
                          preserve_rng_state=True)
    out_leaves = [_wrap(v) if t else v
                  for v, t in zip(outs, cell["is_tensor"])]
    return _unflatten(cell["tree"], out_leaves)


def recompute_sequential(ctx: dict, functions, *args, **kwargs):
    """Checkpoint a Sequential in ``segments`` chunks (the Sequential
    protocol threads exactly one activation between layers)."""
    segments = int((ctx or {}).get("segments", 1))
    fns = list(functions)
    if len(args) != 1:
        raise ValueError(
            "recompute_sequential threads a single activation through the "
            f"layer list (Sequential protocol); got {len(args)} positional "
            "args — use recompute() directly for multi-input functions")
    if len(fns) == 0:
        return args[0]
    seg_len = max(1, math.ceil(len(fns) / segments))

    def run_chunk(chunk):
        def f(x):
            for layer in chunk:
                x = layer(x)
            return x
        return f

    x = args[0]
    for s in range(0, len(fns), seg_len):
        x = recompute(run_chunk(fns[s:s + seg_len]), x, **kwargs)
    return x

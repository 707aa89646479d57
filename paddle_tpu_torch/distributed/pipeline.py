"""Pipeline parallelism, the functional part — counterpart of
``pipeline_ticks``, ``ring_schedule`` and ``pipeline_scan`` in
``paddle_tpu/distributed/pipeline.py``.

The JAX package runs the rotational schedule as one compiled program: a
scan over ``V*M + S - 1`` ticks in which every stage applies a chunk to
what its left neighbour handed it (a ``ppermute``), stage 0 feeding fresh
micro-batches and, under the circular schedule (``circular_repeats=V``),
parking the activations that come back from stage ``S - 1`` in a
hand-back buffer until their next lap. Here one process drives every
stage (single-controller) over a list of devices, repeats allowed: the
same ticks in the same order, a hand-off is a ``.to()`` onto the next
stage's device, and one autograd graph spans the stages (the backward of
a hand-off carries the gradient back). A bubble tick (a stage with no
work item) does no work: the JAX ring computes it on garbage and
discards its output and masks its aux, so skipping it changes nothing;
:func:`pipeline_ticks` still reports the reference's tick count.

``LayerDesc``, ``PipelineLayer`` and ``PipelineParallel`` wrap
``nn.Layer`` models and wait for the port's ``nn`` (ROADMAP.md section A,
item 11).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch
from torch.utils.checkpoint import checkpoint

from .sharding import spec_axes
from .topology import get_hybrid_communicate_group

__all__ = ["pipeline_ticks", "ring_schedule", "pipeline_scan"]


def pipeline_ticks(micro_batches: int, stages: int,
                   circular_repeats: int = 1) -> int:
    """Tick count of the schedule: ``V*M + S - 1``. One tick applies one
    chunk (``1/V`` of a stage), so in stage-time units the schedule costs
    ``M + (S-1)/V``: the interleaved bubble fraction is ``((S-1)/V) / (M +
    (S-1)/V)`` against ``(S-1)/(M+S-1)`` without interleaving."""
    return circular_repeats * micro_batches + stages - 1


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _unstack(tree, n: int, dim: int = 0):
    """A pytree whose leaves have size ``n`` on ``dim`` -> the ``n``
    pytrees along it (each leaf unbound once, so its gradient comes back
    as one stack)."""
    parts = [t.unbind(dim) for t in _leaves(tree)]
    out = []
    for i in range(n):
        it = iter([p[i] for p in parts])
        out.append(_tree_map(lambda _: next(it), tree))
    return out


def ring_schedule(stage_fn: Callable, params_local: Sequence, xs, *,
                  devices: Optional[Sequence] = None,
                  circular_repeats: int = 1, with_aux: bool = False):
    """The rotational schedule over ``S = len(params_local)`` stages.

    Args:
      stage_fn: ``(chunk_params, x) -> y`` with ``y.shape == x.shape``
        (``with_aux``: ``(y, aux_scalar)``).
      params_local: per-stage list; entry ``s`` is stage ``s``'s pytree of
        ``[V, ...]`` chunk leaves (chunk ``c = v*S + s`` at lap ``v``), on
        its device.
      xs: ``[M, b, ...]`` micro-batched stage-0 inputs.
      devices: the stages' devices (default: each stage's first leaf's).
      circular_repeats: ``V``, laps around the ring.

    At tick ``t`` stage ``s`` processes work item ``idx = t - s`` (micro-
    batch ``idx % M``, lap ``idx // M``) when ``0 <= idx < V*M`` and hands
    its output to stage ``s + 1`` (stage 0, around the ring, when ``V >
    1``). Stage 0 parks what comes back from stage ``S - 1`` in an
    ``[M]`` hand-back buffer at slot ``(t - S) % M`` until its next lap
    starts ``M - S`` ticks later, so the circular schedule needs ``M >=
    S``.

    Returns the ``[M, b, ...]`` last-chunk outputs on the last stage's
    device; ``with_aux``: ``(outs, aux_total)``, ``aux_total`` the sum
    over every (chunk, micro-batch) application (each stage's sum over its
    ticks, then the stages in order, on the last stage's device)."""
    S, V, M = len(params_local), int(circular_repeats), xs.shape[0]
    if V > 1 and M < S:
        raise ValueError(
            f"circular schedule needs micro_batches >= stages (got M={M} < "
            f"S={S}); the lap hand-back buffer is consumed M - S ticks after "
            f"arrival")
    if devices is None:
        devices = [_leaves(p)[0].device for p in params_local]
    chunks = [_unstack(p, V) for p in params_local]
    feed = xs.unbind(0)
    ring: List = [None] * S        # ring[s]: stage s's last output, handed on
    park: List = [None] * M
    last: List = [None] * M
    aux = [None] * S
    for t in range(pipeline_ticks(M, S, V)):
        if V > 1 and 0 <= t - S < V * M:     # stage S-1's output arrives
            park[(t - S) % M] = ring[S - 1]
        out: List = [None] * S
        for s in range(S):
            idx = t - s
            if not 0 <= idx < V * M:
                continue                       # a bubble tick: no work
            m, v = idx % M, idx // M
            if s == 0:
                x = feed[m].to(devices[0]) if v == 0 else park[m]
            else:
                x = ring[s - 1]
            y = stage_fn(chunks[s][v], x)
            if with_aux:
                y, a = y
                a = a.float()
                aux[s] = a if aux[s] is None else aux[s] + a
            if s == S - 1 and v == V - 1:
                last[m] = y
            if s < S - 1 or V > 1:
                out[s] = y.to(devices[(s + 1) % S])
        ring = out
    outs = torch.stack(last)
    if not with_aux:
        return outs
    dev = devices[-1]
    total = None
    for a in aux:
        if a is not None:
            total = a.to(dev) if total is None else total + a.to(dev)
    return outs, total


def pipeline_scan(stage_fn: Callable, stage_params, xs, *, mesh=None,
                  axis: str = "pp", remat: bool = False,
                  batch_spec: Optional[tuple] = None,
                  circular_repeats: int = 1):
    """Run ``M`` micro-batches through the ``S`` stages of ``mesh``'s
    ``axis`` (default: the hybrid group's mesh).

    Args:
      stage_fn: ``(params_one_chunk, x) -> y`` with ``y.shape == x.shape``.
      stage_params: pytree of stacked per-chunk ``[S*V, ...]`` leaves
        (chunk ``c`` runs on stage ``c % S``); each stage's chunks are
        moved to its device.
      xs: micro-batched input ``[M, B, ...]``.
      remat: checkpoint each chunk application.
      batch_spec: the spec of ``xs`` over the other axes, e.g. ``(None,
        "dp")``: one ring per coordinate of those axes on its slice of
        dim 1 (its stages at that coordinate); default replicated (one
        ring, the other axes at 0).
      circular_repeats: ``V``; needs ``M >= S`` when ``V > 1``.

    Returns the ``[M, B, ...]`` last-chunk outputs, on the first ring's
    last stage's device."""
    mesh = mesh or get_hybrid_communicate_group().mesh
    S = int(mesh.shape[axis])
    V = int(circular_repeats)
    leaves = _leaves(stage_params)
    if leaves and leaves[0].shape[0] != S * V:
        raise ValueError(
            f"stage_params leading dim {leaves[0].shape[0]} != "
            f"num_stages*circular_repeats = {S}*{V}")
    fn = ((lambda p, x: checkpoint(stage_fn, p, x, use_reentrant=False))
          if remat else stage_fn)
    if S == 1:
        per = _unstack(stage_params, V)
        ys = []
        for x in xs.unbind(0):
            for p in per:
                x = fn(p, x)
            ys.append(x)
        return torch.stack(ys)
    # [S*V, ...] -> [V, S, ...]: chunk c = v*S + s is stage s's lap v
    stages = _unstack(_tree_map(lambda p: p.reshape((V, S) + p.shape[1:]),
                                stage_params), S, dim=1)
    axes = spec_axes(batch_spec[1]) if batch_spec and len(batch_spec) > 1 \
        else ()
    base = (0,) * len(mesh.axis_names)
    rings = [mesh.group(c, (axis,)) for c in mesh.group(base, axes)]
    outs = []
    for cs, x in zip(rings, xs.chunk(len(rings), dim=1)):
        devs = [mesh.devices[c] for c in cs]
        local = [_tree_map(lambda t, d=d: t.to(d), p)
                 for p, d in zip(stages, devs)]
        outs.append(ring_schedule(fn, local, x.to(devs[0]), devices=devs,
                                  circular_repeats=V))
    lead = outs[0].device
    return torch.cat([o.to(lead) for o in outs], dim=1)

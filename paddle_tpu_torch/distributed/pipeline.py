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

The eager part: ``LayerDesc`` / ``SharedLayerDesc`` (deferred layer
construction, a shared layer built once), ``PipelineLayer`` (a layer list
cut into stages uniformly by count or at ``layer:<ClassName>`` marks;
its ``forward`` runs every stage in order) and ``PipelineParallel``
(``fleet.distributed_model`` under pp). ``train_batch`` takes the
reference's routes and decisions:

* the stacked route ("compiled"): the layer list's longest run of
  structurally identical blocks (a multiple of pp x V of them) has its
  parameters stacked ``[S*V, blocks a chunk, ...]`` (a differentiable
  stack of the Parameters, so their gradients land where they live) and
  runs through :func:`pipeline_scan`'s ring, V laps under
  ``virtual_pp_degree``; the layers before and after run as prologue and
  epilogue;
* the heterogeneous route ("compiled-hetero", V 1): the longest run of
  layers whose boundary shapes agree (probed on one micro-batch) is cut
  into S stages balanced by parameter count, each stage's parameters
  packed into one flat row of an ``[S, Lmax]`` array in their own dtype,
  each ring stage unpacking its row and running its layers; stages of
  mixed dtypes do not pack and fall back;
* otherwise eager micro-batch accumulation ("eager"), opt-in at pp > 1
  (``pipeline_configs["allow_eager_fallback"]``; without it the step
  raises with the reason), with one warning naming the reason.

A route over the ring computes serial gradient accumulation's numbers,
which the reference's 1F1B order does not change either. The eager
route runs each micro-batch through the stages in turn, each stage's
layers on its pp coordinate's device (a hand-off is a ``.to()``).
"""

from __future__ import annotations

import warnings
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from .sharding import spec_axes
from .topology import get_hybrid_communicate_group

__all__ = ["pipeline_ticks", "ring_schedule", "pipeline_scan", "LayerDesc",
           "SharedLayerDesc", "PipelineLayer", "PipelineParallel"]


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


# ---------------------------------------------------------------------------
# the eager part: LayerDesc segmentation and the fleet wrapper
# ---------------------------------------------------------------------------

def _nn():
    from ..nn.layer import Layer
    return Layer


def _param_sig(layer):
    """Structural signature for stacking: the class names of the sublayer
    tree with their scalar hyperparameters (GELU and ReLU differ), and
    every parameter's shape and dtype."""
    def cfg(l):
        return tuple(sorted(
            (k, v) for k, v in vars(l).items()
            if not k.startswith("_") and isinstance(v, (int, float, bool, str))))
    tree = [layer] + layer.sublayers()
    return (tuple((type(l).__name__, cfg(l)) for l in tree),
            tuple((tuple(p.shape), str(p.dtype)) for p in layer.parameters()))


def _functional_apply(layers, leaves, x: torch.Tensor) -> torch.Tensor:
    """``layers`` applied in order to the torch value ``x`` with their
    parameters' values swapped for ``leaves`` (in ``parameters()`` order;
    a distributed parameter's locals for ``leaves``' slices) for the call,
    so the gradient reaches the leaves."""
    import contextlib
    from ..core.tensor import Tensor, _wrap
    from .dist_tensor import DistTensor, substituted
    params = [p for l in layers for p in l.parameters()]
    if len(params) != len(leaves):
        raise ValueError(f"leaf count {len(leaves)} != param count "
                         f"{len(params)}")
    plain = [(p, p._value) for p in params if not isinstance(p, DistTensor)]
    with contextlib.ExitStack() as stack:
        for p, v in zip(params, leaves):
            if isinstance(p, DistTensor):
                stack.enter_context(substituted(p, v))
            else:
                p._value = v
        try:
            h = _wrap(x)
            for l in layers:
                h = l(h)
        finally:
            for p, v in plain:
                p._value = v
    return h._value if isinstance(h, Tensor) else h


def _find_block_run(sigs, min_repeats: int):
    """The longest contiguous run of a repeating unit of layer signatures
    (a unit owns a parameter): ``(start, period, repeats)`` or None."""
    n = len(sigs)
    best = None
    for start in range(n):
        for period in range(1, (n - start) // max(min_repeats, 2) + 1):
            unit = sigs[start:start + period]
            if not any(s[1] for s in unit):
                continue
            r = 1
            while (start + (r + 1) * period <= n and
                   sigs[start + r * period:start + (r + 1) * period] == unit):
                r += 1
            if r >= min_repeats:
                cov = r * period
                if best is None or cov > best[3]:
                    best = (start, period, r, cov)
    return best[:3] if best else None


_NO_RUN_REASON = (
    "no stackable block run detected in the layer list; build the model as "
    "[prologue..., N identical blocks, epilogue...] with N a multiple of "
    "pp_degree*virtual_pp_degree")

_NO_HETERO_REASON_PREFIX = "heterogeneous compiled path unavailable: "


def _balanced_partition(costs, S):
    """Contiguous partition of ``costs`` into S non-empty groups, each
    closed once it reaches 1/S of the total (or when the remaining items
    just fill the remaining groups)."""
    n = len(costs)
    if n < S:
        return None
    total = float(sum(costs))
    bounds, acc = [0], 0.0
    for i, c in enumerate(costs):
        remaining_slots = S - len(bounds)
        remaining_items = n - i
        acc += c
        if len(bounds) < S and (acc >= total / S or
                                remaining_items == remaining_slots):
            bounds.append(i + 1)
            acc = 0.0
    bounds.append(n)
    bounds = sorted(set(bounds))
    while len(bounds) < S + 1:
        for j in range(len(bounds) - 1):
            if bounds[j + 1] - bounds[j] > 1:
                bounds.insert(j + 1, bounds[j] + 1)
                break
    return [(bounds[i], bounds[i + 1]) for i in range(S)]



class LayerDesc:
    """Deferred layer construction (ref: pp_layers.py LayerDesc)."""

    def __init__(self, layer_cls, *args, **kwargs):
        if not (isinstance(layer_cls, type) and issubclass(layer_cls, _nn())):
            raise TypeError(f"LayerDesc expects a Layer subclass, got {layer_cls}")
        self.layer_cls = layer_cls
        self.args = args
        self.kwargs = kwargs

    def build_layer(self):
        return self.layer_cls(*self.args, **self.kwargs)

    def __repr__(self):
        return f"LayerDesc({self.layer_cls.__name__})"


class SharedLayerDesc(LayerDesc):
    """A layer shared between stages (embedding / output-head tying): the
    stages that name ``key`` hold the same layer object, so its weights
    get every stage's gradient."""

    def __init__(self, key, layer_cls, *args, forward_func=None,
                 shared_weight_attr="weight", **kwargs):
        super().__init__(layer_cls, *args, **kwargs)
        self.layer_name = key
        self.forward_func = forward_func
        self.shared_weight_attr = shared_weight_attr


class _FnLayer(_nn()):
    def __init__(self, fn):
        super().__init__()
        self._fn = fn

    def forward(self, *a, **k):
        return self._fn(*a, **k)


class PipelineLayer(_nn()):
    """A model cut into stages (ref: pp_layers.PipelineLayer). ``layers``
    holds Layers, LayerDescs or callables; ``seg_method`` "uniform" splits
    by layer count, "layer:<ClassName>" starts each stage at a layer of
    that class. ``forward`` runs every stage in order (the serial
    oracle)."""

    def __init__(self, layers: Sequence, num_stages: Optional[int] = None,
                 topology=None, loss_fn=None, seg_method: str = "uniform",
                 recompute_interval: int = 0, **kwargs):
        super().__init__()
        hcg = topology or get_hybrid_communicate_group()
        self._hcg = hcg
        self.num_stages = num_stages or hcg.get_pipe_parallel_world_size()
        if self.num_stages < 1:
            raise ValueError("num_stages must be >= 1")
        self._loss_fn = loss_fn
        self._recompute_interval = recompute_interval
        self._shared = {}
        built = []
        self._descs = list(layers)
        for i, item in enumerate(self._descs):
            if isinstance(item, SharedLayerDesc):
                if item.layer_name not in self._shared:
                    self._shared[item.layer_name] = item.build_layer()
                layer = self._shared[item.layer_name]
            elif isinstance(item, LayerDesc):
                layer = item.build_layer()
            elif isinstance(item, _nn()):
                layer = item
            elif callable(item):
                layer = _FnLayer(item)
            else:
                raise TypeError(f"unsupported pipeline item: {item!r}")
            self.add_sublayer(str(i), layer)
            built.append(layer)
        self._layers_list = built
        self._stage_bounds = self._segment(seg_method)

    def _segment(self, seg_method: str) -> List[int]:
        n, S = len(self._layers_list), self.num_stages
        if n < S:
            raise ValueError(f"cannot split {n} layers into {S} stages")
        if seg_method.startswith("layer:"):
            cls_name = seg_method.split(":", 1)[1]
            marks = [i for i, l in enumerate(self._layers_list)
                     if type(l).__name__ == cls_name]
            if len(marks) < S:
                raise ValueError(
                    f"seg_method {seg_method!r}: only {len(marks)} marks for "
                    f"{S} stages")
            per, extra = len(marks) // S, len(marks) % S
            bounds, idx = [0], 0
            for s in range(S - 1):
                idx += per + (1 if s < extra else 0)
                bounds.append(marks[idx] if idx < len(marks) else n)
            bounds.append(n)
            return bounds
        per, extra = n // S, n % S
        bounds = [0]
        for s in range(S):
            bounds.append(bounds[-1] + per + (1 if s < extra else 0))
        return bounds

    def get_stage_layers(self, stage: int):
        lo, hi = self._stage_bounds[stage], self._stage_bounds[stage + 1]
        return self._layers_list[lo:hi]

    @property
    def segment_parts(self) -> List[int]:
        return list(self._stage_bounds)

    def _apply(self, lo: int, hi: int, x):
        """Layers ``lo:hi`` on ``x`` (every ``recompute_interval``-th layer
        under recompute while training)."""
        from ..core.tensor import Tensor
        from .fleet.recompute import recompute
        for i in range(lo, hi):
            layer = self._layers_list[i]
            if self._recompute_interval and self.training and \
                    i % self._recompute_interval == 0 and \
                    isinstance(x, Tensor) and x.is_floating_point():
                x = recompute(layer, x)
            else:
                x = layer(x)
        return x

    def forward(self, x, *args):
        return self._apply(0, len(self._layers_list), x)


def _split_microbatches(t, m: int):
    if isinstance(t, (list, tuple)):
        parts = [_split_microbatches(x, m) for x in t]
        return [type(t)(p[i] for p in parts) for i in range(m)]
    b = t.shape[0]
    if b % m:
        raise ValueError(f"batch {b} not divisible by accumulate_steps {m}")
    step = b // m
    return [t[i * step:(i + 1) * step] for i in range(m)]


class PipelineParallel(_nn()):
    """``fleet.distributed_model`` under pp (ref: PipelineParallel) over a
    :class:`PipelineLayer` (see the module note for the routes).
    ``strategy.pipeline_configs``: ``accumulate_steps`` (micro-batches a
    step), ``micro_batch_size``, ``virtual_pp_degree`` (laps of the ring),
    ``compiled`` (default True: try the ring routes),
    ``allow_eager_fallback`` (default False)."""

    def __init__(self, layers, hcg=None, strategy=None):
        super().__init__()
        if not isinstance(layers, PipelineLayer):
            raise TypeError(
                "PipelineParallel requires a PipelineLayer (build the model "
                "from LayerDescs; ref: fleet.meta_parallel.PipelineLayer)")
        self._layers = layers
        self._hcg = hcg or get_hybrid_communicate_group()
        cfg = getattr(strategy, "pipeline_configs", None) or {}
        self.accumulate_steps = int(cfg.get("accumulate_steps", 1))
        self.micro_batch_size = int(cfg.get("micro_batch_size", 1))
        self.virtual_pp_degree = int(cfg.get("virtual_pp_degree", 1))
        self._use_compiled = bool(cfg.get("compiled", True))
        self.allow_eager_fallback = bool(cfg.get("allow_eager_fallback",
                                                 False))
        self.last_path = None      # "compiled" | "compiled-hetero" | "eager"
        self._compiled_step = None
        self._compile_attempted = False
        mesh = self._hcg.mesh
        S = layers.num_stages
        pp = int(mesh.shape.get("pp", 1))
        base = (0,) * len(mesh.axis_names)
        group = mesh.group(base, ("pp",)) if pp == S else [base] * S
        self._devices = [mesh.devices[c] for c in group]
        shared = {id(l) for l in layers._shared.values()}
        for s in range(S):
            for layer in layers.get_stage_layers(s):
                if id(layer) not in shared:
                    _place(layer, self._devices[s])

    def forward(self, *args, **kwargs):
        return self._layers(*args, **kwargs)

    # -- the ring routes -----------------------------------------------------
    def _try_build_compiled(self, sample=None):
        """The stacked route's plan, or the heterogeneous one's, or a
        string saying why neither applies."""
        self._compile_attempted = True
        S = int(self._hcg.get_pipe_parallel_world_size())
        V, M = self.virtual_pp_degree, self.accumulate_steps
        if S < 2:
            return "pp degree is 1 (nothing to pipeline)"
        if V > 1 and M < S:
            return (f"virtual_pp_degree={V} needs accumulate_steps >= "
                    f"pp_degree (got {M} < {S}); raise accumulate_steps")
        all_layers = self._layers._layers_list
        if any(l.buffers(include_sublayers=True) for l in all_layers):
            return ("the model registers stateful buffers (e.g. BatchNorm "
                    "running stats), which cannot be updated from inside "
                    "the ring schedule")
        run = _find_block_run([_param_sig(l) for l in all_layers],
                              min_repeats=S * V)
        if run is None:
            return self._try_build_hetero(sample)
        start, period, repeats = run
        r_use = (repeats // (S * V)) * (S * V)
        if r_use < S * V:
            return self._try_build_hetero(sample)
        blocks = [all_layers[start + i * period:start + (i + 1) * period]
                  for i in range(r_use)]
        n_leaf = len([p for l in blocks[0] for p in l.parameters()])
        if n_leaf == 0:
            return _NO_RUN_REASON
        unit, bpc = blocks[0], r_use // (S * V)

        def stack_now():
            per = [[p._value for l in b for p in l.parameters()]
                   for b in blocks]
            return tuple(torch.stack([pb[j] for pb in per]).reshape(
                (S * V, bpc) + tuple(per[0][j].shape)) for j in range(n_leaf))

        def chunk_fn(chunk, x):
            for b in range(bpc):
                x = _functional_apply(unit, [leaf[b] for leaf in chunk], x)
            return x

        return {"pro": all_layers[:start],
                "epi": all_layers[start + r_use * period:],
                "stack": stack_now, "stage_fn": chunk_fn, "V": V}

    def _try_build_hetero(self, sample):
        """The shape-stable interior cut into S stages by parameter count,
        each stage's parameters one flat row (their dtype) of ``[S, Lmax]``
        (see the module note); a string when it does not apply."""
        from ..core import autograd as _ag
        from ..core.tensor import Tensor, _wrap
        S = int(self._hcg.get_pipe_parallel_world_size())
        pre = _NO_HETERO_REASON_PREFIX
        if self.virtual_pp_degree > 1:
            return _NO_RUN_REASON + "; " + pre + \
                "virtual_pp_degree > 1 needs the stacked-block form"
        if sample is None:
            return _NO_RUN_REASON + "; " + pre + "no sample batch to probe"
        all_layers = self._layers._layers_list
        xv = sample._value if isinstance(sample, Tensor) else \
            torch.as_tensor(sample)
        h = _wrap(xv[:self.micro_batch_size])
        shapes = [tuple(h.shape)]
        with _ag.no_grad():
            for l in all_layers:
                h = l(_to(h, _first_device(l, h)))
                shapes.append(tuple(int(d) for d in h.shape))
        best, i, n = None, 0, len(all_layers)
        while i < n:
            j = i
            while j < n and shapes[j + 1] == shapes[i]:
                j += 1
            if j > i and (best is None or j - i > best[1] - best[0]):
                best = (i, j)
            i = max(j, i + 1)
        if best is None or best[1] - best[0] < S:
            return _NO_RUN_REASON + "; " + pre + (
                f"no shape-stable run of >= pp_degree ({S}) layers "
                f"(boundary shapes {shapes})")
        i0, i1 = best
        interior = all_layers[i0:i1]
        costs = [max(1, sum(int(np.prod(p.shape)) for p in l.parameters()))
                 for l in interior]
        stage_layers = [interior[a:b] for a, b in
                        _balanced_partition(costs, S)]
        dtypes = sorted({str(p.dtype) for sl in stage_layers for l in sl
                         for p in l.parameters()})
        if len(dtypes) > 1:
            return _NO_RUN_REASON + "; " + pre + (
                f"mixed stage parameter dtypes {dtypes} cannot flat-pack "
                "into one rectangular array")
        meta = [[tuple(p.shape) for l in sl for p in l.parameters()]
                for sl in stage_layers]
        Lmax = max(1, max(sum(int(np.prod(t)) for t in m) for m in meta))
        dev = self._devices[0]
        dtype = next((p.dtype for sl in stage_layers for l in sl
                      for p in l.parameters()), torch.float32)

        def pack(sl):
            leaves = [p._value.reshape(-1).to(dev)
                      for l in sl for p in l.parameters()]
            flat = torch.cat(leaves) if leaves else \
                torch.zeros((0,), dtype=dtype, device=dev)
            return torch.nn.functional.pad(flat, (0, Lmax - flat.shape[0]))

        def stack_now():
            return torch.stack([pack(sl) for sl in stage_layers])

        def stage_fn(row, x):
            flat, s = row
            s = int(s)
            leaves, off = [], 0
            for shape in meta[s]:
                size = int(np.prod(shape))
                leaves.append(flat[off:off + size].reshape(shape))
                off += size
            return _functional_apply(stage_layers[s], leaves, x)

        return {"pro": all_layers[:i0], "epi": all_layers[i1:],
                "stack": stack_now, "stage_fn": stage_fn, "V": 1,
                "hetero": True}

    def _train_batch_compiled(self, data, optimizer, lr_scheduler):
        """One step through the ring: the prologue on stage 0's device,
        :func:`pipeline_scan` over the stacked (or packed) parameters, the
        epilogue and each micro-batch's loss on the last stage's device,
        backward of their mean, one optimizer step."""
        from ..core.tensor import Tensor, _wrap
        info = self._compiled_step
        inputs, labels = data
        M = self.accumulate_steps
        xv = inputs._value if isinstance(inputs, Tensor) else \
            torch.as_tensor(inputs)
        yv = labels._value if isinstance(labels, Tensor) else \
            torch.as_tensor(labels)
        B = xv.shape[0]
        if B % M:
            raise ValueError(f"batch {B} not divisible by accumulate_steps "
                             f"{M}")
        first, last = self._devices[0], self._devices[-1]
        x = xv.to(first)
        if info["pro"]:
            x = _functional_apply(info["pro"], [
                p._value for l in info["pro"] for p in l.parameters()], x)
        xs = x.reshape((M, B // M) + tuple(x.shape[1:]))
        stacked = info["stack"]()
        if info.get("hetero"):
            S = stacked.shape[0]
            stacked = (stacked, torch.arange(S))
        out = pipeline_scan(info["stage_fn"], stacked, xs,
                            mesh=self._hcg.mesh, axis="pp",
                            remat=bool(self._layers._recompute_interval),
                            circular_repeats=info["V"])
        o = out.to(last).reshape((B,) + tuple(out.shape[2:]))
        if info["epi"]:
            o = _functional_apply(info["epi"], [
                p._value for l in info["epi"] for p in l.parameters()], o)
        ys = yv.to(last)
        step = B // M
        losses = []
        for m in range(M):
            lo = self._layers._loss_fn(_wrap(o[m * step:(m + 1) * step]),
                                       _wrap(ys[m * step:(m + 1) * step]))
            losses.append(lo._value if isinstance(lo, Tensor) else lo)
        loss = torch.stack(losses).mean()
        loss.backward()
        optimizer.step()
        optimizer.clear_grad()
        if lr_scheduler is not None:
            lr_scheduler.step()
        return _wrap(loss.detach())

    # -- the step ------------------------------------------------------------
    def _run_stages(self, x):
        """One micro-batch through the stages, handed from device to
        device."""
        pl = self._layers
        for s in range(pl.num_stages):
            lo, hi = pl._stage_bounds[s], pl._stage_bounds[s + 1]
            x = _to(x, self._devices[s])
            x = pl._apply(lo, hi, x)
        return x

    def train_batch(self, data, optimizer, lr_scheduler=None, scaler=None):
        """One pipelined training step; returns the mean micro-batch
        loss."""
        if self._layers._loss_fn is None:
            raise ValueError("PipelineLayer needs loss_fn for train_batch")
        if scaler is None and self._use_compiled:
            if not self._compile_attempted:
                built = self._try_build_compiled(sample=data[0])
                if isinstance(built, str):
                    if self._hcg.get_pipe_parallel_world_size() > 1:
                        if not self.allow_eager_fallback:
                            raise RuntimeError(
                                "PipelineParallel: no ring schedule for this "
                                "layer list and eager fallback is opt-in "
                                "(pipeline_configs['allow_eager_fallback']="
                                "True): " + built)
                        warnings.warn(
                            f"PipelineParallel: falling back to eager "
                            f"micro-batch accumulation (numerically "
                            f"identical, but not the ring schedule): "
                            f"{built}", stacklevel=2)
                else:
                    self._compiled_step = built
            if self._compiled_step is not None:
                self.last_path = "compiled-hetero" \
                    if self._compiled_step.get("hetero") else "compiled"
                return self._train_batch_compiled(data, optimizer,
                                                  lr_scheduler)
        self.last_path = "eager"
        inputs, labels = data
        M = self.accumulate_steps
        total = 0.0
        for x, y in zip(_split_microbatches(inputs, M),
                        _split_microbatches(labels, M)):
            out = self._run_stages(x)
            loss = self._layers._loss_fn(out, _to(y, self._devices[-1]))
            scaled = loss / M
            if scaler is not None:
                scaler.scale(scaled).backward()
            else:
                scaled.backward()
            total += float(loss)
        if scaler is not None:
            scaler.step(optimizer)
            scaler.update()
        else:
            optimizer.step()
        optimizer.clear_grad()
        if lr_scheduler is not None:
            lr_scheduler.step()
        from ..core.tensor import to_tensor
        return to_tensor(total / M, place=self._devices[-1])

    def eval_batch(self, data, compute_loss=True):
        inputs, labels = data
        out = self._run_stages(inputs)
        if compute_loss and self._layers._loss_fn is not None:
            return self._layers._loss_fn(out, _to(labels, self._devices[-1]))
        return out

    def parameters(self, include_sublayers=True):
        return self._layers.parameters(include_sublayers)

    def named_parameters(self, prefix="", include_sublayers=True):
        return self._layers.named_parameters(prefix, include_sublayers)

    def state_dict(self, *a, **k):
        return self._layers.state_dict(*a, **k)

    def set_state_dict(self, *a, **k):
        return self._layers.set_state_dict(*a, **k)


def _first_device(layer, h):
    ps = layer.parameters()
    return ps[0]._value.device if ps else h._value.device


def _to(x, dev):
    from ..core.tensor import Tensor
    if isinstance(x, Tensor) and x._value.device != dev:
        return x.to(dev)
    if isinstance(x, (list, tuple)):
        return type(x)(_to(v, dev) for v in x)
    return x


def _place(layer, dev):
    """Move ``layer``'s parameters and buffers to ``dev`` (when they are
    elsewhere), keeping the tensor objects."""
    for t in list(layer.parameters()) + list(layer.buffers()):
        if t is not None and t._value.device != dev:
            t._replace(t._value.to(dev), cast=True)

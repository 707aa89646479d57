"""Eager tensors over a placement — the port's counterpart of an eager
``Tensor`` whose ``jax.Array`` carries a ``NamedSharding``, and of the
``shard_map`` regions the JAX package's parallel layers run in.

The JAX package keeps one logical array and lets GSPMD place it; the port
has no GSPMD, so it keeps the pieces itself:

* :class:`DistTensor` / :class:`DistParameter`: a tensor of logical
  ``shape`` laid out over a :class:`~.topology.Mesh` by a spec (the
  reference's ``PartitionSpec`` as a tuple): one local torch tensor per
  mesh coordinate (a :class:`~.sharding.ShardedTensor`), replicas as
  separate copies. The locals of a ``DistParameter`` are the autograd
  leaves, so they are what backward fills and the optimizer steps.
  ``numpy()``, ``state_dict()``, ``set_value()`` and ``.grad`` present the
  logical tensor: ``.grad`` is, slice by slice, the sum of every replica's
  local gradient in mesh order.
* Where eager code runs: at the mesh's first coordinate (the lead).
  Read there, a ``DistTensor``'s value is the logical tensor joined from
  the locals of the lead's group over the axes its spec names (the lead's
  own local when it is replicated), so an ordinary op on it
  differentiates into those locals. Under :func:`at_coordinate` (a
  region body, the optimizer's per-coordinate update) its value is the
  local of that coordinate.
* :func:`shard_map`: the per-coordinate region. Its body runs once, but
  every tensor in it is a :class:`RegionTensor` holding one value per
  coordinate, and every dispatched op (``core.dispatch.forward_op``) runs
  once per coordinate over those values; the collectives of
  :mod:`.fleet.layers.mpu.mp_ops` cross coordinates inside one autograd
  ``Function``. Entering, each coordinate gets its slice of an input by
  its in-spec; leaving, the out-spec's slices are joined at their first
  holders, and backward hands a slice's cotangent to each of its ``n``
  holders divided by ``n`` while the inputs' cotangents sum over the
  coordinates: the transpose rules of JAX's ``shard_map`` with
  ``check_vma=False``, so a region's gradients equal the JAX package's.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core import dispatch
from ..core.place import place_of
from ..core.tensor import Parameter, Tensor, _auto_name, _wrap, as_torch
from .sharding import ShardedTensor, shard_dim_spec, shard_to_mesh, spec_axes

__all__ = ["PartitionSpec", "DistTensor", "DistParameter", "RegionTensor",
           "at_coordinate", "anchor", "distribute", "dist_tensor",
           "shard_map", "in_region", "region_axis_bound", "group_op",
           "logical_value", "substituted"]


class PartitionSpec(tuple):
    """``PartitionSpec("mp", None)``: one entry per leading dim, an axis
    name, a tuple of names or None (the reference's spelling)."""

    def __new__(cls, *entries):
        return tuple.__new__(cls, entries)


# ---------------------------------------------------------------------------
# where eager code runs
# ---------------------------------------------------------------------------

class _Ctx:
    mesh = None        # the mesh of the coordinate being run
    coord = None       # that coordinate, while its locals are read


_ctx = _Ctx()


@contextlib.contextmanager
def at_coordinate(mesh, coord):
    """Run the block at ``coord`` of ``mesh``: every distributed tensor on
    ``mesh`` reads (and writes) that coordinate's local."""
    saved = (_ctx.mesh, _ctx.coord)
    _ctx.mesh, _ctx.coord = mesh, tuple(coord)
    try:
        yield
    finally:
        _ctx.mesh, _ctx.coord = saved


def anchor(mesh) -> tuple:
    """The coordinate of ``mesh`` eager code runs at: the one
    :func:`at_coordinate` runs, else the first (the lead)."""
    if _ctx.mesh is mesh and _ctx.coord is not None:
        return _ctx.coord
    return (0,) * len(mesh.axis_names)


def _local_coord(mesh):
    return _ctx.coord if _ctx.mesh is mesh else None


def _starts(idx) -> tuple:
    return tuple(a for a, _, _ in idx)


def _join(pieces: Dict[tuple, torch.Tensor], ndim: int) -> torch.Tensor:
    """Concatenate the slices keyed by their start offsets into one tensor
    (differentiably), dim by dim from the last."""
    for d in reversed(range(ndim)):
        groups: Dict[tuple, list] = {}
        for starts, t in pieces.items():
            groups.setdefault(starts[:d] + starts[d + 1:], []).append(
                (starts[d], t))
        if all(len(g) == 1 for g in groups.values()):
            continue
        pieces = {k[:d] + (0,) + k[d:]: torch.cat(
            [t for _, t in sorted(g, key=lambda e: e[0])], dim=d)
            for k, g in groups.items()}
    (out,) = pieces.values()
    return out


def logical_value(st: ShardedTensor, at: tuple,
                  device: Optional[torch.device] = None) -> torch.Tensor:
    """The logical tensor of ``st`` as the coordinates of ``at``'s group
    over the spec's axes hold it, joined on ``device`` (``at``'s device
    by default); the anchor's own local when the spec names no axis."""
    axes = [a for e in st.spec for a in spec_axes(e)]
    dev = st.mesh.devices[at] if device is None else device
    if not axes:
        return st.locals[at].to(dev)
    pieces = {_starts(st.index(c)): st.locals[c].to(dev)
              for c in st.mesh.group(at, axes)}
    return _join(pieces, len(st.shape))


def _summed_grad(st: ShardedTensor) -> Optional[torch.Tensor]:
    """Slice by slice, the sum of every holder's local ``.grad`` in mesh
    order, joined on the lead device; None when no local has one."""
    holders: Dict[tuple, list] = {}
    for c in st.mesh.coords():
        holders.setdefault(st.index(c), []).append(c)
    pieces, any_grad = {}, False
    for idx, cs in holders.items():
        acc = None
        for c in cs:
            g = st.locals[c].grad
            if g is not None:
                any_grad = True
                g = g.to(st.lead)
                acc = g if acc is None else acc + g
        if acc is None:
            acc = torch.zeros(st.locals[cs[0]].shape,
                              dtype=st.locals[cs[0]].dtype, device=st.lead)
        pieces[_starts(idx)] = acc
    return _join(pieces, len(st.shape)) if any_grad else None


# ---------------------------------------------------------------------------
# tensors over a mesh
# ---------------------------------------------------------------------------

class DistTensor(Tensor):
    """A tensor laid out over a mesh by a spec (see the module note);
    ``locals`` maps each coordinate to its torch tensor."""

    is_distributed = True

    @classmethod
    def _of(cls, st: ShardedTensor, name: Optional[str] = None,
            stop_gradient: bool = True):
        t = Tensor.__new__(cls)
        t.__dict__["_st"] = st
        t._sg = True
        t.name = name or _auto_name()
        t.persistable = isinstance(t, Parameter)
        t._version = 0
        t.stop_gradient = stop_gradient
        return t

    # -- layout --------------------------------------------------------------
    @property
    def mesh(self):
        return self._st.mesh

    @property
    def spec(self) -> tuple:
        return self._st.spec

    @property
    def locals(self) -> Dict[tuple, torch.Tensor]:
        return self._st.locals

    def local(self, coord) -> torch.Tensor:
        return self._st.locals[tuple(coord)]

    @property
    def _first(self) -> torch.Tensor:
        return next(iter(self._st.locals.values()))

    # -- the value -----------------------------------------------------------
    @property
    def _value(self) -> torch.Tensor:
        st = self._st
        c = _local_coord(st.mesh)
        if c is not None:
            return st.locals[c]
        return logical_value(st, anchor(st.mesh))

    @_value.setter
    def _value(self, v: torch.Tensor):
        st = self._st
        c = _local_coord(st.mesh)
        if c is not None:
            st.locals[c] = v
            return
        self._relay(v)

    def _relay(self, v: torch.Tensor):
        """Write the logical value ``v`` into every local, keeping each a
        leaf that needs a gradient when it was one (``.grad`` kept)."""
        st = self._st
        new = shard_to_mesh(v.detach(), st.mesh, st.spec, name=self.name)
        for c, old in st.locals.items():
            t = new.locals[c].to(old.dtype)
            if old.requires_grad:
                t.requires_grad_(True)
                t.grad = old.grad
            st.locals[c] = t

    @property
    def shape(self):
        c = _local_coord(self._st.mesh)
        if c is not None:
            return list(self._st.locals[c].shape)
        return list(self._st.shape)

    @property
    def ndim(self) -> int:
        return len(self.shape)

    dim = ndim.fget

    @property
    def size(self) -> int:
        return int(np.prod(self.shape))

    @property
    def dtype(self):
        return self._first.dtype

    @property
    def place(self):
        return place_of(self._first)

    # -- autograd ------------------------------------------------------------
    @property
    def stop_gradient(self) -> bool:
        v = self._first
        if v.is_floating_point() or v.is_complex():
            return not v.requires_grad
        return self._sg

    @stop_gradient.setter
    def stop_gradient(self, stop: bool):
        self._sg = bool(stop)
        for c, v in self._st.locals.items():
            if not (v.is_floating_point() or v.is_complex()):
                continue
            if stop and v.requires_grad:
                self._st.locals[c] = v.detach()
            elif not stop and not v.requires_grad:
                v.requires_grad_(True)

    @property
    def is_leaf(self) -> bool:
        return all(v.is_leaf for v in self._st.locals.values())

    @property
    def grad(self) -> Optional[Tensor]:
        g = _summed_grad(self._st)
        return None if g is None else _wrap(g)

    @grad.setter
    def grad(self, g):
        if g is None:
            self.clear_grad()
            return
        st = self._st
        gs = shard_to_mesh(as_torch(g).detach(), st.mesh, st.spec)
        for c, v in st.locals.items():
            v.grad = gs.locals[c].to(v.dtype)

    def clear_grad(self):
        for v in self._st.locals.values():
            v.grad = None

    clear_gradient = clear_grad

    # -- conversion and writes -------------------------------------------------
    def numpy(self) -> np.ndarray:
        v = logical_value(self._st, (0,) * len(self.mesh.axis_names),
                          torch.device("cpu")).detach()
        if v.dtype == torch.bfloat16:
            v = v.float()
        return v.numpy()

    def detach(self) -> Tensor:
        return _wrap(self._value.detach())

    def _replace(self, v: torch.Tensor, cast: bool = False) -> "DistTensor":
        if cast:    # Layer.to: each local in v's dtype, on its own device
            st = self._st
            for c, old in st.locals.items():
                t = old.detach().to(dtype=v.dtype)
                if old.requires_grad:
                    t.requires_grad_(True)
                st.locals[c] = t
        else:
            self._relay(v)
        self._bump()
        return self

    def set_value(self, value) -> "DistTensor":
        v = as_torch(value)
        if tuple(v.shape) != tuple(self._st.shape):
            raise ValueError(f"set_value shape mismatch: {tuple(v.shape)} vs "
                             f"{tuple(self._st.shape)}")
        return self._replace(v)

    def __repr__(self):
        return (f"DistTensor(shape={list(self._st.shape)}, spec={self.spec}, "
                f"mesh={self.mesh.shape}, dtype={self.dtype})")


class DistParameter(DistTensor, Parameter):
    """A ``Parameter`` over a mesh: its locals are the leaves."""

    def __repr__(self):
        return "Parameter containing:\n" + DistTensor.__repr__(self)


@contextlib.contextmanager
def substituted(t: DistTensor, value: torch.Tensor):
    """For the block: ``t``'s locals are ``value``'s slices (differentiable
    views moved to each coordinate's device), so whatever reads ``t`` —
    its logical value or a coordinate's local — reads ``value``."""
    st = t._st
    old = st.locals
    st.locals = {c: value[tuple(slice(a, b) for a, b, _ in st.index(c))].to(
        st.mesh.devices[c]) for c in st.mesh.coords()}
    try:
        yield
    finally:
        st.locals = old


def dist_tensor(value, mesh, spec, name: Optional[str] = None,
                stop_gradient: bool = True) -> DistTensor:
    """A new :class:`DistTensor` of ``value`` cut by ``spec`` over
    ``mesh``."""
    st = shard_to_mesh(as_torch(value).detach(), mesh, tuple(spec),
                       name=name or "tensor")
    return DistTensor._of(st, name, stop_gradient)


def distribute(p: Tensor, mesh, spec) -> DistTensor:
    """Lay ``p`` out over ``mesh`` by ``spec`` IN PLACE: the same object
    (an optimizer holding it keeps working) becomes a
    :class:`DistParameter` (a :class:`DistTensor` for a plain Tensor)
    whose locals are fresh leaves; attributes (name, optimize_attr, ...)
    stay. An already distributed tensor is re-laid."""
    spec = tuple(spec)
    if isinstance(p, DistTensor):
        if p._st.mesh is mesh and p._st.spec == spec:
            return p
        full = logical_value(p._st, (0,) * len(p.mesh.axis_names)).detach()
    else:
        full = p._value.detach()
    trainable = not p.stop_gradient
    st = shard_to_mesh(full, mesh, spec, name=p.name)
    if trainable and (full.is_floating_point() or full.is_complex()):
        for v in st.locals.values():
            v.requires_grad_(True)
    if not isinstance(p, DistTensor):
        Tensor._value.__delete__(p)
        p.__class__ = DistParameter if isinstance(p, Parameter) else DistTensor
    p.__dict__["_st"] = st
    p._bump()
    return p


# ---------------------------------------------------------------------------
# the per-coordinate region
# ---------------------------------------------------------------------------

class RegionTensor(Tensor):
    """A value inside a :func:`shard_map` body: one torch tensor per
    region coordinate (``vals``). Outside the per-coordinate loop its
    ``_value`` is the first coordinate's (shapes and dtypes agree)."""

    @classmethod
    def _of(cls, region, vals: Dict[tuple, torch.Tensor]):
        t = Tensor.__new__(cls)
        t.__dict__["_region"] = region
        t.__dict__["vals"] = vals
        first = next(iter(vals.values()))
        t._sg = not first.requires_grad
        t.name = _auto_name()
        t.persistable = False
        t._version = 0
        return t

    @property
    def _value(self) -> torch.Tensor:
        c = _local_coord(self._region.mesh)
        return self.vals[c if c is not None else self._region.coords[0]]

    @_value.setter
    def _value(self, v):
        c = _local_coord(self._region.mesh)
        if c is None:
            raise RuntimeError("a region value is written per coordinate")
        self.vals[c] = v

    def _rebind(self, new: Tensor) -> "RegionTensor":
        self.__dict__["vals"] = dict(new.vals)
        self._bump()
        return self

    def numpy(self) -> np.ndarray:
        raise RuntimeError("a region value has one tensor per coordinate; "
                           "leave the region (out_specs) to read it")


class _Region:
    def __init__(self, mesh):
        self.mesh = mesh
        self.coords = mesh.coords()

    def resolve(self, a, c):
        """The torch value of argument ``a`` at coordinate ``c``."""
        if isinstance(a, Tensor):
            v = a._value
            dev = self.mesh.devices[c]
            return v if v.device == dev else v.to(dev)
        return a

    def run(self, name, fn, args, kwargs, differentiable):
        """``forward_op`` inside the region: ``fn`` once per coordinate."""
        from ..core.enforce import translate_op_error
        outs = {}
        saved = dispatch._Regions.active
        dispatch._Regions.active = None
        try:
            for c in self.coords:
                with at_coordinate(self.mesh, c):
                    vals = [self.resolve(a, c) for a in args]
                    try:
                        with torch.set_grad_enabled(
                                differentiable and torch.is_grad_enabled()):
                            outs[c] = fn(*vals, **kwargs)
                    except Exception as e:
                        raise translate_op_error(e, name, vals) from e
        finally:
            dispatch._Regions.active = saved
        first = outs[self.coords[0]]
        if isinstance(first, (tuple, list)):
            return tuple(self.wrap({c: o[i] for c, o in outs.items()})
                         for i in range(len(first)))
        return self.wrap(outs)

    def wrap(self, vals):
        vals = {c: v if isinstance(v, torch.Tensor) else torch.as_tensor(v)
                for c, v in vals.items()}
        return RegionTensor._of(self, vals)

    # -- entering and leaving ------------------------------------------------
    def enter(self, a, spec, k: int) -> RegionTensor:
        v = a._value if isinstance(a, Tensor) else as_torch(a)
        spec = tuple(spec)
        layout = ShardedTensor(self.mesh, spec, tuple(v.shape), {})
        for d, e in enumerate(spec):
            axes = spec_axes(e)
            if axes:
                parts = int(np.prod([self.mesh.shape[x] for x in axes]))
                shard_dim_spec(v.shape, parts, e, d, f"shard_map input {k}")
        vals = {}
        for c in self.coords:
            part = v[tuple(slice(s, e) for s, e, _ in layout.index(c))]
            dev = self.mesh.devices[c]
            vals[c] = part if part.device == dev else part.to(dev)
        return RegionTensor._of(self, vals)

    def leave(self, out, spec):
        if not isinstance(out, RegionTensor):
            return out
        spec = tuple(spec)
        local = tuple(out.vals[self.coords[0]].shape)
        shape = list(local)
        for d, e in enumerate(spec):
            axes = spec_axes(e)
            if axes:
                shape[d] *= int(np.prod([self.mesh.shape[x] for x in axes]))
        layout = ShardedTensor(self.mesh, spec, tuple(shape), {})
        vals = [out.vals[c] for c in self.coords]
        return _wrap(_Leave.apply(self, layout, *vals))


class _Leave(torch.autograd.Function):
    """The out-spec's slices joined at their first holders; backward, each
    holder of a slice gets its cotangent divided by the holder count."""

    @staticmethod
    def forward(ctx, region, layout, *vals):
        ctx.region, ctx.layout = region, layout
        ctx.meta = [(v.device, v.dtype) for v in vals]
        lead = region.mesh.devices[region.coords[0]]
        pieces = {}
        for c, v in zip(region.coords, vals):
            pieces.setdefault(_starts(layout.index(c)), v.detach().to(lead))
        return _join(pieces, len(layout.shape))

    @staticmethod
    def backward(ctx, g):
        region, layout = ctx.region, ctx.layout
        idx = [layout.index(c) for c in region.coords]
        count = {i: idx.count(i) for i in set(idx)}
        out = []
        for i, (dev, dt) in zip(idx, ctx.meta):
            part = g[tuple(slice(s, e) for s, e, _ in i)]
            if count[i] > 1:
                part = part / count[i]
            out.append(part.to(device=dev, dtype=dt))
        return (None, None, *out)


def _spec_list(specs, n: int):
    """A :class:`PartitionSpec` applies to every argument (as a JAX
    pytree prefix); otherwise one spec per argument."""
    if isinstance(specs, PartitionSpec):
        return [specs] * n
    return list(specs)


def shard_map(body, mesh, in_specs, out_specs):
    """The per-coordinate region (JAX's ``shard_map`` with
    ``check_vma=False``): ``f(*args)`` hands ``body`` one
    :class:`RegionTensor` per argument, cut by ``in_specs``, and joins
    what it returns by ``out_specs`` (a spec, or a tuple of specs for a
    tuple of outputs)."""

    def f(*args):
        region = _Region(mesh)
        specs = _spec_list(in_specs, len(args))
        ins = [region.enter(a, s, k) for k, (a, s) in
               enumerate(zip(args, specs))]
        saved = dispatch._Regions.active
        dispatch._Regions.active = region
        try:
            out = body(*ins)
        finally:
            dispatch._Regions.active = saved
        if isinstance(out, tuple):
            return tuple(region.leave(o, s) for o, s in
                         zip(out, _spec_list(out_specs, len(out))))
        return region.leave(out, out_specs)

    return f


def in_region() -> Optional[_Region]:
    """The active region, or None."""
    return dispatch._Regions.active


def region_axis_bound(axis) -> bool:
    """True inside a region whose mesh has ``axis`` (all of a tuple)."""
    r = dispatch._Regions.active
    if r is None or axis is None:
        return False
    names = axis if isinstance(axis, tuple) else (axis,)
    return all(n in r.mesh.axis_names for n in names)


class _GroupOp(torch.autograd.Function):
    """A collective over the region's groups along one axis: ``fwd`` and
    ``bwd`` map one group's values (rank order) to its outputs."""

    @staticmethod
    def forward(ctx, region, axis, fwd, bwd, *vals):
        ctx.region, ctx.axis, ctx.bwd = region, axis, bwd
        return tuple(_by_groups(region, axis, fwd,
                                [v.detach() for v in vals]))

    @staticmethod
    def backward(ctx, *gs):
        return (None, None, None, None,
                *_by_groups(ctx.region, ctx.axis, ctx.bwd, list(gs)))


def _by_groups(region, axis, fn, vals) -> List[torch.Tensor]:
    names = axis if isinstance(axis, tuple) else (axis,)
    pos = {c: i for i, c in enumerate(region.coords)}
    out: List[Optional[torch.Tensor]] = [None] * len(vals)
    done = set()
    for c in region.coords:
        if c in done:
            continue
        members = region.mesh.group(c, names)
        done.update(members)
        res = fn([vals[pos[m]] for m in members])
        for m, r in zip(members, res):
            out[pos[m]] = r
    return out


def group_op(x: RegionTensor, axis, fwd, bwd=None) -> RegionTensor:
    """Apply the collective ``fwd`` (backward ``bwd``; None: not
    differentiable) to a region value over ``axis``."""
    region = x._region
    vals = [x.vals[c] for c in region.coords]
    if bwd is None:
        with torch.no_grad():
            outs = _by_groups(region, axis, fwd, vals)
    else:
        outs = _GroupOp.apply(region, axis, fwd, bwd, *vals)
    return region.wrap(dict(zip(region.coords, outs)))


# ---------------------------------------------------------------------------
# the optimizer over a layout
# ---------------------------------------------------------------------------

def _slices(idx, shape) -> tuple:
    return tuple(slice(a, shape[d] if b is None else b)
                 for d, (a, b, _) in enumerate(idx))


def _rel(outer, inner, shape) -> tuple:
    """``inner``'s slices relative to the block ``outer`` that holds it."""
    o, i = _slices(outer, shape), _slices(inner, shape)
    return tuple(slice(b.start - a.start, b.stop - a.start)
                 for a, b in zip(o, i))


def _logical_shape(p) -> tuple:
    return tuple(p._st.shape) if isinstance(p, DistTensor) \
        else tuple(p._value.shape)


def state_layout(opt, p):
    """``(mesh, spec)`` of ``p``'s update and optimizer state: ``p``'s own
    layout, with the optimizer's sharding axis (ZeRO stage 1, set by
    ``shard_optimizer_states``) added on the first dim that ``p`` leaves
    whole and that splits evenly. None when ``p`` is not distributed and
    no dim splits (the serial update)."""
    shape = _logical_shape(p)
    axis = getattr(opt, "_sharding_axis", None)
    if isinstance(p, DistTensor):
        mesh = p.mesh
        spec = list(p.spec) + [None] * (len(shape) - len(p.spec))
    else:
        mesh = opt._sharding_mesh
        spec = [None] * len(shape)
    used = {a for e in spec for a in spec_axes(e)}
    if axis is not None and mesh.shape.get(axis, 1) > 1 and axis not in used:
        n = mesh.shape[axis]
        for d, size in enumerate(shape):
            if spec[d] is None and size > 0 and size % n == 0:
                spec[d] = axis
                break
    if not isinstance(p, DistTensor) and all(e is None for e in spec):
        return None
    return mesh, tuple(spec)


def state_tensor(p, layout, fill_value=0.0, dtype=None, shape=None,
                 master: bool = False) -> DistTensor:
    """An optimizer state of ``p`` laid out by ``layout``: filled with
    ``fill_value`` (a scalar ``shape=()`` state: one copy per coordinate),
    or ``master``: ``p``'s value in float32."""
    mesh, spec = layout
    if master:
        full = logical_value(p._st, (0,) * len(mesh.axis_names)) \
            if isinstance(p, DistTensor) else p._value
        return DistTensor._of(shard_to_mesh(
            full.detach().to(torch.float32), mesh, spec))
    shape = _logical_shape(p) if shape is None else tuple(shape)
    spec = spec if len(shape) else ()
    st = ShardedTensor(mesh, spec, shape, {})
    for c in mesh.coords():
        local = [len(range(*s.indices(n))) for s, n in
                 zip(_slices(st.index(c), shape), shape)]
        st.locals[c] = torch.full(local, fill_value, dtype=dtype,
                                  device=mesh.devices[c])
    return DistTensor._of(st)


def laid_out_step(opt, p, g, lr, layout):
    """One optimizer update of ``p`` run per mesh coordinate: coordinate
    ``c`` updates its slice of the layout from its slice of the logical
    gradient ``g`` with its locals of the optimizer state, and every local
    of ``p`` then takes the new slices of its block. Replicas do the same
    arithmetic on equal inputs, so they stay bit-equal."""
    if not opt._elementwise:
        raise NotImplementedError(
            f"{type(opt).__name__} takes whole-parameter norms; its update "
            f"does not run per slice of a distributed or sharded parameter")
    mesh, spec = layout
    shape = _logical_shape(p)
    lay = ShardedTensor(mesh, spec, shape, {})
    dist = isinstance(p, DistTensor)
    gv = g._value.detach()
    new = {}
    for c in mesh.coords():
        if dist:
            value = p._st.locals[c].detach()[
                _rel(p._st.index(c), lay.index(c), shape)]
        else:
            value = p._value.detach()[_slices(lay.index(c), shape)]
        grad = gv[_slices(lay.index(c), shape)].to(value.device)
        with at_coordinate(mesh, c):
            new[c] = opt._update_value(p, value, grad, lr)
    with torch.no_grad():
        if dist:
            extra = [a for e in spec for a in spec_axes(e)
                     if a not in {x for y in p.spec for x in spec_axes(y)}]
            for c, local in p._st.locals.items():
                for c2 in mesh.group(c, extra):
                    local[_rel(p._st.index(c), lay.index(c2), shape)].copy_(
                        new[c2].to(device=local.device, dtype=local.dtype))
        else:
            for idx, c in lay.unique():
                p._value[_slices(idx, shape)].copy_(
                    new[c].to(device=p._value.device, dtype=p._value.dtype))
    p._version += 1

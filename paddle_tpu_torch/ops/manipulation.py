"""Shape / layout manipulation ops — counterpart of
``paddle_tpu/ops/manipulation.py``. Every op returns a new tensor (a view
where torch makes one, never written in place)."""

from __future__ import annotations

import numpy as np
import torch

from ..core.tensor import Tensor, to_tensor
from ._helpers import axes_arg, ensure_tensor, forward_op, patch_methods


def _shape_arg(shape):
    if isinstance(shape, Tensor):
        return tuple(int(s) for s in shape.numpy().reshape(-1))
    out = []
    for s in (shape if isinstance(shape, (list, tuple)) else [shape]):
        if isinstance(s, Tensor):
            s = s.item()
        # a symbolic size (torch.export) stays symbolic
        out.append(s if isinstance(s, torch.SymInt) else int(s))
    return tuple(out)


def _long(i):
    return i.long() if i.dtype != torch.bool else i


def reshape(x, shape, name=None) -> Tensor:
    x = ensure_tensor(x)
    shp = _shape_arg(shape)
    # paddle semantics: 0 means "copy this dim from input"
    shp = tuple(x._value.shape[i] if s == 0 else s for i, s in enumerate(shp))
    return forward_op("reshape", lambda v: v.reshape(shp), [x])


def reshape_(x, shape, name=None) -> Tensor:
    x._rebind(reshape(x, shape))
    return x


view = reshape


def view_as(x, other, name=None) -> Tensor:
    return reshape(x, ensure_tensor(other).shape)


def transpose(x, perm, name=None) -> Tensor:
    x = ensure_tensor(x)
    perm = tuple(int(p) for p in perm)
    return forward_op("transpose", lambda v: v.permute(perm), [x])


def moveaxis(x, source, destination, name=None) -> Tensor:
    return forward_op("moveaxis",
                      lambda v: torch.movedim(v, axes_arg(source),
                                              axes_arg(destination)),
                      [ensure_tensor(x)])


def swapaxes(x, axis0, axis1, name=None) -> Tensor:
    return forward_op("swapaxes",
                      lambda v: torch.swapaxes(v, int(axis0), int(axis1)),
                      [ensure_tensor(x)])


def concat(x, axis=0, name=None) -> Tensor:
    ts = [ensure_tensor(t) for t in x]
    if isinstance(axis, Tensor):
        axis = int(axis.item())
    return forward_op("concat", lambda *vs: torch.cat(vs, dim=int(axis)), ts)


def stack(x, axis=0, name=None) -> Tensor:
    ts = [ensure_tensor(t) for t in x]
    return forward_op("stack", lambda *vs: torch.stack(vs, dim=int(axis)), ts)


def split(x, num_or_sections, axis=0, name=None):
    x = ensure_tensor(x)
    ax = int(axis.item()) if isinstance(axis, Tensor) else int(axis)
    dim = x._value.shape[ax]
    if isinstance(num_or_sections, int):
        if dim % num_or_sections != 0:
            raise ValueError(
                f"split: dim {dim} along axis {ax} is not divisible by "
                f"{num_or_sections}")
        sizes = [dim // num_or_sections] * num_or_sections
    else:
        sizes = [int(s) for s in num_or_sections]
        if any(s == -1 for s in sizes):
            rest = dim - sum(s for s in sizes if s != -1)
            sizes = [rest if s == -1 else s for s in sizes]
    outs = forward_op("split", lambda v: tuple(torch.split(v, sizes, ax)), [x])
    return list(outs)


def chunk(x, chunks, axis=0, name=None):
    return split(x, int(chunks), axis)


def unbind(x, axis=0):
    x = ensure_tensor(x)
    return list(forward_op("unbind", lambda v: tuple(v.unbind(int(axis))), [x]))


unstack = unbind


def squeeze(x, axis=None, name=None) -> Tensor:
    x = ensure_tensor(x)
    ax = axes_arg(axis)
    if isinstance(ax, int):
        ax = (ax,)

    def impl(v):
        if ax is None:
            return torch.squeeze(v)
        keep = tuple(a for a in ax if v.shape[a] == 1)  # paddle ignores non-1 dims
        return torch.squeeze(v, keep) if keep else v

    return forward_op("squeeze", impl, [x])


def squeeze_(x, axis=None, name=None) -> Tensor:
    x._rebind(squeeze(x, axis))
    return x


def unsqueeze(x, axis, name=None) -> Tensor:
    x = ensure_tensor(x)
    ax = axes_arg(axis)
    if isinstance(ax, int):
        ax = (ax,)

    def impl(v):
        n = v.dim() + len(ax)
        for a in sorted(a % n for a in ax):
            v = v.unsqueeze(a)
        return v

    return forward_op("unsqueeze", impl, [x])


def unsqueeze_(x, axis, name=None) -> Tensor:
    x._rebind(unsqueeze(x, axis))
    return x


def flatten(x, start_axis=0, stop_axis=-1, name=None) -> Tensor:
    x = ensure_tensor(x)
    nd = x.ndim
    s = start_axis % nd if nd else 0
    e = stop_axis % nd if nd else 0

    def impl(v):
        return v.reshape(tuple(v.shape[:s]) + (-1,) + tuple(v.shape[e + 1:]))

    return forward_op("flatten", impl, [x])


def flatten_(x, start_axis=0, stop_axis=-1, name=None) -> Tensor:
    x._rebind(flatten(x, start_axis, stop_axis))
    return x


def tile(x, repeat_times, name=None) -> Tensor:
    x = ensure_tensor(x)
    reps = _shape_arg(repeat_times)
    return forward_op("tile", lambda v: torch.tile(v, reps), [x])


def expand(x, shape, name=None) -> Tensor:
    x = ensure_tensor(x)
    shp = _shape_arg(shape)
    offset = len(shp) - x.ndim  # new leading dims prepended by broadcast
    resolved = []
    for i, s in enumerate(shp):
        if s == -1:
            if i < offset:
                raise ValueError(
                    f"expand: -1 is not allowed for a newly added leading dim "
                    f"(dim {i} of target shape {tuple(shp)} for input shape "
                    f"{tuple(x._value.shape)})")
            s = x._value.shape[i - offset]
        resolved.append(s)
    shp = tuple(resolved)
    return forward_op("expand", lambda v: torch.broadcast_to(v, shp), [x])


def expand_as(x, y, name=None) -> Tensor:
    return expand(x, ensure_tensor(y).shape)


def broadcast_to(x, shape, name=None) -> Tensor:
    shp = _shape_arg(shape)
    return forward_op("broadcast_to", lambda v: torch.broadcast_to(v, shp),
                      [ensure_tensor(x)])


def broadcast_tensors(inputs, name=None):
    ts = [ensure_tensor(t) for t in inputs]
    return list(forward_op("broadcast_tensors",
                           lambda *vs: tuple(torch.broadcast_tensors(*vs)), ts))


def broadcast_shape(x_shape, y_shape):
    return list(np.broadcast_shapes(tuple(x_shape), tuple(y_shape)))


def gather(x, index, axis=0, name=None) -> Tensor:
    """paddle.gather: select rows of `axis` by a 1-D index."""
    x, index = ensure_tensor(x), ensure_tensor(index)
    ax = int(axis.item()) if isinstance(axis, Tensor) else int(axis)
    return forward_op("gather",
                      lambda v, i: torch.index_select(v, ax, i.reshape(-1).long()),
                      [x, index])


def gather_nd(x, index, name=None) -> Tensor:
    x, index = ensure_tensor(x), ensure_tensor(index)

    def impl(v, idx):
        return v[tuple(torch.movedim(idx.long(), -1, 0))]

    return forward_op("gather_nd", impl, [x, index])


def scatter(x, index, updates, overwrite=True, name=None) -> Tensor:
    """paddle.scatter: write `updates` rows into `x` at `index` along axis 0."""
    x, index, updates = ensure_tensor(x), ensure_tensor(index), ensure_tensor(updates)

    def impl(v, i, u):
        i = (i.reshape(-1).long(),)
        u = u.to(v.dtype)
        if overwrite:
            return v.index_put(i, u)
        return v.index_put(i, torch.zeros_like(u)).index_put(i, u,
                                                             accumulate=True)

    return forward_op("scatter", impl, [x, index, updates])


def scatter_(x, index, updates, overwrite=True, name=None) -> Tensor:
    x._rebind(scatter(x, index, updates, overwrite))
    return x


def scatter_nd_add(x, index, updates, name=None) -> Tensor:
    x, index, updates = ensure_tensor(x), ensure_tensor(index), ensure_tensor(updates)

    def impl(v, i, u):
        return v.index_put(tuple(torch.movedim(i.long(), -1, 0)), u.to(v.dtype),
                           accumulate=True)

    return forward_op("scatter_nd_add", impl, [x, index, updates])


def scatter_nd(index, updates, shape, name=None) -> Tensor:
    index, updates = ensure_tensor(index), ensure_tensor(updates)
    shp = _shape_arg(shape)

    def impl(i, u):
        base = torch.zeros(shp, dtype=u.dtype, device=u.device)
        return base.index_put(tuple(torch.movedim(i.long(), -1, 0)), u,
                              accumulate=True)

    return forward_op("scatter_nd", impl, [index, updates])


def index_select(x, index, axis=0, name=None) -> Tensor:
    x, index = ensure_tensor(x), ensure_tensor(index)
    return forward_op("index_select",
                      lambda v, i: torch.index_select(v, int(axis),
                                                      i.reshape(-1).long()),
                      [x, index])


def index_sample(x, index) -> Tensor:
    x, index = ensure_tensor(x), ensure_tensor(index)
    return forward_op("index_sample",
                      lambda v, i: torch.take_along_dim(v, i.long(), dim=1),
                      [x, index])


def index_add(x, index, axis, value, name=None) -> Tensor:
    x, index, value = ensure_tensor(x), ensure_tensor(index), ensure_tensor(value)
    return forward_op("index_add",
                      lambda v, i, u: torch.index_add(v, int(axis),
                                                      i.reshape(-1).long(),
                                                      u.to(v.dtype)),
                      [x, index, value])


def index_put(x, indices, value, accumulate=False, name=None) -> Tensor:
    x, value = ensure_tensor(x), ensure_tensor(value)
    dev = x._value.device
    idx = tuple(_long(i._value if isinstance(i, Tensor) else
                      torch.as_tensor(i, device=dev)) for i in indices)
    return forward_op("index_put",
                      lambda v, u: v.index_put(idx, u.to(v.dtype),
                                               accumulate=accumulate),
                      [x, value])


def take_along_axis(arr, indices, axis, broadcast=True) -> Tensor:
    arr, indices = ensure_tensor(arr), ensure_tensor(indices)
    return forward_op("take_along_axis",
                      lambda v, i: torch.take_along_dim(v, i.long(), dim=int(axis)),
                      [arr, indices])


def put_along_axis(arr, indices, values, axis, reduce="assign", include_self=True,
                   broadcast=True) -> Tensor:
    arr, indices = ensure_tensor(arr), ensure_tensor(indices)
    values = ensure_tensor(values)

    def impl(v, i, u):
        i = i.long()
        u = torch.broadcast_to(u.to(v.dtype), i.shape)
        ax = int(axis)
        if reduce == "assign":
            return torch.scatter(v, ax, i, u)
        mode = {"add": "sum", "multiply": "prod", "mul": "prod",
                "amin": "amin", "amax": "amax"}[reduce]
        return torch.scatter_reduce(v, ax, i, u, mode, include_self=True)

    return forward_op("put_along_axis", impl, [arr, indices, values])


def take(x, index, mode="raise", name=None) -> Tensor:
    x, index = ensure_tensor(x), ensure_tensor(index)

    def impl(v, i):
        flat = v.reshape(-1)
        i = i.long()
        i = torch.remainder(i, flat.numel()) if mode == "wrap" else \
            torch.clamp(i, 0, flat.numel() - 1)
        return flat[i]

    return forward_op("take", impl, [x, index])


def flip(x, axis, name=None) -> Tensor:
    ax = axes_arg(axis)
    ax = (ax,) if isinstance(ax, int) else ax
    return forward_op("flip", lambda v: torch.flip(v, ax), [ensure_tensor(x)])


def roll(x, shifts, axis=None, name=None) -> Tensor:
    sh = axes_arg(shifts)
    ax = axes_arg(axis)
    if ax is None:
        return forward_op("roll", lambda v: torch.roll(v, sh), [ensure_tensor(x)])
    return forward_op("roll", lambda v: torch.roll(v, sh, ax), [ensure_tensor(x)])


def rot90(x, k=1, axes=(0, 1), name=None) -> Tensor:
    return forward_op("rot90", lambda v: torch.rot90(v, k, tuple(axes)),
                      [ensure_tensor(x)])


def repeat_interleave(x, repeats, axis=None, name=None) -> Tensor:
    x = ensure_tensor(x)
    r = repeats._value if isinstance(repeats, Tensor) else repeats
    return forward_op("repeat_interleave",
                      lambda v: torch.repeat_interleave(v, r, dim=axes_arg(axis)),
                      [x])


def masked_select(x, mask, name=None) -> Tensor:
    x, mask = ensure_tensor(x), ensure_tensor(mask)
    return forward_op("masked_select", lambda v, m: v[m.bool()], [x, mask])


def masked_fill(x, mask, value, name=None) -> Tensor:
    x, mask = ensure_tensor(x), ensure_tensor(mask)
    if isinstance(value, Tensor):
        return forward_op("masked_fill",
                          lambda v, m, u: torch.where(m.bool(), u.to(v.dtype), v),
                          [x, mask, value])
    return forward_op("masked_fill",
                      lambda v, m: torch.where(
                          m.bool(), torch.tensor(value, dtype=v.dtype,
                                                 device=v.device), v),
                      [x, mask])


def masked_scatter(x, mask, value, name=None) -> Tensor:
    x, mask, value = ensure_tensor(x), ensure_tensor(mask), ensure_tensor(value)

    def impl(v, m, u):
        m = torch.broadcast_to(m.bool(), v.shape)
        flat_idx = torch.cumsum(m.reshape(-1).long(), 0) - 1
        picked = u.reshape(-1)[torch.clamp(flat_idx, 0, u.numel() - 1)]
        return torch.where(m, picked.reshape(v.shape).to(v.dtype), v)

    return forward_op("masked_scatter", impl, [x, mask, value])


def unique(x, return_index=False, return_inverse=False, return_counts=False,
           axis=None, dtype="int64", name=None):
    """Eager-only (dynamic output shape), on the host as the reference's."""
    x = ensure_tensor(x)
    res = np.unique(x.numpy(), return_index=return_index,
                    return_inverse=return_inverse, return_counts=return_counts,
                    axis=axes_arg(axis))
    place = x.place
    if not isinstance(res, tuple):
        return to_tensor(res, place=place)
    return tuple(to_tensor(r, place=place) for r in res)


def unique_consecutive(x, return_inverse=False, return_counts=False, axis=None,
                       dtype="int64", name=None):
    t = ensure_tensor(x)
    x = t.numpy()
    if axis is None:
        x = x.reshape(-1)
        keep = np.concatenate([[True], x[1:] != x[:-1]])
    else:
        raise NotImplementedError("unique_consecutive with axis")
    out = to_tensor(x[keep], place=t.place)
    extras = []
    if return_inverse:
        extras.append(to_tensor(np.cumsum(keep) - 1, place=t.place))
    if return_counts:
        idx = np.flatnonzero(keep)
        extras.append(to_tensor(np.diff(np.append(idx, x.size)), place=t.place))
    return (out, *extras) if extras else out


def as_complex(x, name=None) -> Tensor:
    return forward_op("as_complex", lambda v: torch.complex(v[..., 0], v[..., 1]),
                      [ensure_tensor(x)])


def as_real(x, name=None) -> Tensor:
    def impl(v):
        if not v.is_complex():
            return torch.stack([v, torch.zeros_like(v)], -1)
        return torch.stack([torch.real(v), torch.imag(v)], -1)

    return forward_op("as_real", impl, [ensure_tensor(x)])


def tensordot(x, y, axes=2, name=None) -> Tensor:
    ax = axes
    if isinstance(ax, Tensor):
        ax = ax.numpy().tolist()
    return forward_op("tensordot", lambda a, b: torch.tensordot(a, b, dims=ax),
                      [ensure_tensor(x), ensure_tensor(y)])


def shard_index(input, index_num, nshards, shard_id, ignore_value=-1):  # noqa: A002
    input = ensure_tensor(input)
    size = index_num // nshards

    def impl(v):
        shard = torch.div(v, size, rounding_mode="floor")
        local = torch.remainder(v, size)
        return torch.where(shard == shard_id, local,
                           torch.full_like(local, ignore_value))

    return forward_op("shard_index", impl, [input], differentiable=False)


def crop(x, shape=None, offsets=None, name=None) -> Tensor:
    x = ensure_tensor(x)
    shp = _shape_arg(shape)
    offs = _shape_arg(offsets) if offsets is not None else (0,) * len(shp)
    shp = tuple(x._value.shape[i] - offs[i] if s == -1 else s for i, s in enumerate(shp))
    sl = tuple(slice(o, o + s) for o, s in zip(offs, shp))
    return forward_op("crop", lambda v: v[sl], [x])


patch_methods([
    ("reshape", reshape), ("reshape_", reshape_), ("view", view), ("view_as", view_as),
    ("transpose", transpose), ("moveaxis", moveaxis), ("swapaxes", swapaxes),
    ("split", split), ("chunk", chunk), ("squeeze", squeeze), ("squeeze_", squeeze_),
    ("unsqueeze", unsqueeze), ("unsqueeze_", unsqueeze_), ("flatten", flatten),
    ("flatten_", flatten_), ("tile", tile), ("expand", expand), ("expand_as", expand_as),
    ("broadcast_to", broadcast_to), ("gather", gather), ("gather_nd", gather_nd),
    ("scatter", scatter), ("scatter_", scatter_), ("scatter_nd_add", scatter_nd_add),
    ("index_select", index_select), ("index_sample", index_sample),
    ("index_add", index_add), ("index_put", index_put),
    ("take_along_axis", take_along_axis), ("put_along_axis", put_along_axis),
    ("take", take), ("flip", flip), ("roll", roll), ("rot90", rot90),
    ("repeat_interleave", repeat_interleave), ("masked_select", masked_select),
    ("masked_fill", masked_fill), ("unique", unique), ("unbind", unbind),
    ("tensordot", tensordot), ("as_complex", as_complex), ("as_real", as_real),
])

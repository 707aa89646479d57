"""The eager Tensor — counterpart of ``paddle_tpu/core/tensor.py``.

A ``Tensor`` holds a ``torch.Tensor`` in ``_value`` where the reference
holds a ``jax.Array``; PyTorch's autograd is the tape:

* ``stop_gradient`` is the negation of the value's ``requires_grad``
  (integer and bool tensors, which torch never differentiates, keep the
  flag beside the value); a ``Parameter`` is a leaf with
  ``stop_gradient=False``; ``.grad`` wraps the leaf's torch ``.grad``.
* In-place semantics are the reference's: an in-place op builds its
  result out of place and *rebinds* ``_value`` (bumping ``_version``), so
  an earlier op's backward always sees the value it saw — ``u[0] = 5.0``
  zeroes the gradient at that slot, and no tensor autograd saved is ever
  mutated. ``set_value`` / ``copy_`` / ``zero_`` / ``fill_`` replace the
  value with a fresh copy (a leaf stays a leaf and keeps its ``.grad``).
  Only the optimizers write a parameter in place, under ``no_grad``.

Methods are patched onto the class by the op modules at import time
(``ops/__init__.py``), as the reference patches them.
"""

from __future__ import annotations

import itertools
from typing import Callable, Optional

import numpy as np
import torch

from .dtype import canonical_dtype, dtype_name, get_default_dtype
from .place import Place, place_of, torch_device

__all__ = ["Tensor", "Parameter", "to_tensor", "_wrap", "as_torch"]

_name_counter = itertools.count()

# While set (a dict), every in-place write records the tensor's value and
# version before its first write: recompute's state discovery, which
# restores them afterwards.
_write_watch = None


def _note_write(t: "Tensor"):
    if _write_watch is not None and id(t) not in _write_watch:
        _write_watch[id(t)] = (t, t._value, t._version)


# While set, every host read of a tensor's value (``bool`` / ``int`` /
# ``float`` / ``item`` / ``numpy`` / ``tolist``) calls it with
# ``(kind, tensor)`` and returns what it returns: ``jit/trace.py`` raises
# there (no host read inside a captured program), ``jit/sot.py`` records
# or replays the outcome.
_materialize_hook = None


def _materialize(kind: str, t: "Tensor", read: Callable):
    hook = _materialize_hook
    return read() if hook is None else hook(kind, t, read)


def _auto_name(prefix="generated_tensor"):
    return f"{prefix}_{next(_name_counter)}"


def _differentiable(v: torch.Tensor) -> bool:
    return v.is_floating_point() or v.is_complex()


def as_torch(value, dtype=None, device=None) -> torch.Tensor:
    """A torch tensor of ``value`` (a Tensor, a torch tensor, numpy data or
    Python data) on ``device`` (the current place when None). Python and
    numpy data are copied; Python floats take the default dtype."""
    if isinstance(value, Tensor):
        value = value._value
    if isinstance(value, torch.Tensor):
        t = value
    else:
        arr = np.asarray(value)
        if dtype is None and arr.dtype == np.float64 and \
                not hasattr(value, "dtype"):
            arr = arr.astype(str(get_default_dtype()).replace("torch.", ""))
        if arr.dtype.name == "bfloat16":       # an ml_dtypes array
            t = torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(arr, copy=True))
    dev = torch_device(device) if device is not None or \
        not isinstance(value, (torch.Tensor, Tensor)) else None
    return t.to(device=dev, dtype=canonical_dtype(dtype))


class Tensor:
    __slots__ = ("_value", "_sg", "name", "persistable", "_version",
                 "__weakref__", "__dict__")

    def __init__(self, value, stop_gradient: bool = True,
                 name: Optional[str] = None):
        v = as_torch(value)
        if isinstance(value, (Tensor, torch.Tensor)):
            v = v.detach()
        self._value = v
        self._sg = True
        self.name = name or _auto_name()
        self.persistable = False
        self._version = 0
        self.stop_gradient = stop_gradient

    # -- autograd flags ------------------------------------------------------
    @property
    def stop_gradient(self) -> bool:
        v = self._value
        return not v.requires_grad if _differentiable(v) else self._sg

    @stop_gradient.setter
    def stop_gradient(self, stop: bool):
        stop = bool(stop)
        v = self._value
        if not _differentiable(v):
            self._sg = stop
        elif stop and v.requires_grad:
            if v.is_leaf:
                v.requires_grad_(False)
            else:
                self._value = v.detach()
        elif not stop and not v.requires_grad:
            v.requires_grad_(True)

    @property
    def is_leaf(self) -> bool:
        return self._value.is_leaf

    @property
    def grad(self) -> Optional["Tensor"]:
        v = self._value
        if not (v.is_leaf or v.retains_grad) or v.grad is None:
            return None
        g = _wrap(v.grad)
        g.__dict__["_grad_of"] = self
        return g

    @grad.setter
    def grad(self, g):
        self._value.grad = None if g is None else as_torch(g).to(
            self._value.dtype)

    # -- basic properties ---------------------------------------------------
    @property
    def shape(self):
        return list(self._value.shape)

    @property
    def dtype(self):
        return self._value.dtype

    @property
    def ndim(self) -> int:
        return self._value.dim()

    dim = ndim.fget

    @property
    def size(self) -> int:
        return self._value.numel()

    @property
    def place(self) -> Place:
        return place_of(self._value)

    @property
    def T(self):
        from ..ops import manipulation
        return manipulation.transpose(self, list(range(self.ndim))[::-1])

    @property
    def mT(self):
        from ..ops import manipulation
        perm = list(range(self.ndim))
        perm[-2], perm[-1] = perm[-1], perm[-2]
        return manipulation.transpose(self, perm)

    # -- conversion ---------------------------------------------------------
    def numpy(self) -> np.ndarray:
        """A host copy; bf16 comes back as float32 (numpy has no bf16)."""
        return _materialize("numpy", self, self._numpy)

    def _numpy(self) -> np.ndarray:
        v = self._value.detach()
        if v.dtype == torch.bfloat16:
            v = v.float()
        return v.cpu().numpy()

    def __array__(self, dtype=None, copy=None):
        a = self.numpy()
        return a if dtype is None else a.astype(dtype)

    def item(self):
        return _materialize("item", self, lambda: self._value.item())

    def tolist(self):
        return _materialize("tolist", self, lambda: self._numpy().tolist())

    def numel(self) -> int:
        return self.size

    def element_size(self) -> int:
        return self._value.element_size()

    def is_floating_point(self) -> bool:
        return self._value.is_floating_point()

    def is_integer(self) -> bool:
        return not (self._value.is_floating_point() or
                    self._value.is_complex() or self._value.dtype == torch.bool)

    def is_complex(self) -> bool:
        return self._value.is_complex()

    # -- autograd -----------------------------------------------------------
    def backward(self, grad_tensor=None, retain_graph: bool = False):
        from . import autograd
        autograd.backward(self, grad_tensor, retain_graph=retain_graph)

    def register_hook(self, hook: Callable):
        """``hook(grad) -> grad | None`` runs when the gradient passes this
        tensor; returns a handle with ``remove()``."""
        def call(g):
            r = hook(_wrap(g))
            return None if r is None else as_torch(r)
        return self._value.register_hook(call)

    def retain_grads(self):
        if self._value.requires_grad and not self._value.is_leaf:
            self._value.retain_grad()

    def clear_grad(self):
        self._value.grad = None

    clear_gradient = clear_grad

    def detach(self) -> "Tensor":
        t = _wrap(self._value.detach())
        t.name = self.name + ".detach"
        return t

    def detach_(self) -> "Tensor":
        self._value = self._value.detach()
        self._sg = True
        return self

    def clone(self) -> "Tensor":
        from .dispatch import forward_op
        return forward_op("clone", lambda x: x.clone(), [self])

    # -- mutation (the in-place surface: rebinding, never torch in-place) --
    def _rebind(self, new: "Tensor") -> "Tensor":
        """Adopt another tensor's value and graph position (the in-place
        protocol)."""
        _note_write(self)
        self._value = new._value
        self._sg = new._sg
        self._bump()
        return self

    def _bump(self):
        self._version += 1
        owner = self.__dict__.get("_grad_of")
        if owner is not None:           # this is a parameter's .grad
            owner._value.grad = self._value.detach()

    def _replace(self, v: torch.Tensor, cast: bool = False) -> "Tensor":
        """The value-only write of ``set_value`` / ``copy_`` / ``zero_`` /
        ``fill_``: a fresh copy of ``v`` in this tensor's dtype and place
        (in ``v``'s when ``cast``: ``Layer.to``); a leaf that needs a
        gradient stays one and keeps its ``.grad`` (dropped on a cast)."""
        _note_write(self)
        old = self._value
        new = v.detach().to(device=v.device if cast else old.device,
                            dtype=v.dtype if cast else old.dtype, copy=True)
        if old.requires_grad:
            new.requires_grad_(True)
            if old.is_leaf and not cast:
                new.grad = old.grad
        self._value = new
        self._bump()
        return self

    @property
    def inplace_version(self) -> int:
        return self._version

    def copy_(self, other, blocking: bool = True) -> "Tensor":
        return self._replace(as_torch(other, device=self.place))

    def set_value(self, value) -> "Tensor":
        v = as_torch(value, device=self.place)
        if tuple(v.shape) != tuple(self._value.shape):
            raise ValueError(f"set_value shape mismatch: {tuple(v.shape)} vs "
                             f"{tuple(self._value.shape)}")
        return self._replace(v)

    def zero_(self) -> "Tensor":
        return self._replace(torch.zeros_like(self._value))

    def fill_(self, v) -> "Tensor":
        return self._replace(torch.full_like(self._value, v))

    # -- placement ----------------------------------------------------------
    def to(self, *args, **kwargs) -> "Tensor":
        from .dispatch import forward_op
        device = kwargs.pop("device", None)
        dtype = kwargs.pop("dtype", None)
        for a in args:
            if isinstance(a, (Place, torch.device)) or (
                    isinstance(a, str) and not _looks_like_dtype(a)):
                device = a
            else:
                dtype = a
        dt = canonical_dtype(dtype)
        dev = torch_device(device) if device is not None else None
        if dt is None and dev is None:
            return self
        return forward_op("to", lambda v: v.to(device=dev, dtype=dt), [self])

    def cpu(self) -> "Tensor":
        return self.to("cpu")

    def cuda(self, device_id=0) -> "Tensor":
        return self.to(f"gpu:{device_id}")

    def tpu(self, device_id=0) -> "Tensor":
        """The reference's name for "to the accelerator": the card here."""
        return self.cuda(device_id)

    def pin_memory(self) -> "Tensor":
        return self

    def contiguous(self) -> "Tensor":
        return self

    def is_contiguous(self) -> bool:
        return True

    # -- indexing -----------------------------------------------------------
    def __getitem__(self, idx):
        from .dispatch import forward_op
        idx = _convert_index(idx, self._value.device)
        return forward_op("slice", lambda x: x[idx], [self])

    def __setitem__(self, idx, value):
        from .dispatch import forward_op
        idx = _convert_index(idx, self._value.device)

        def put(x, v):
            out = x.clone()
            slot = out[idx]
            v = v.to(dtype=x.dtype, device=x.device)
            if v.shape != slot.shape:
                v = v.reshape(slot.shape) if v.numel() == slot.numel() \
                    else v.expand(slot.shape)
            out[idx] = v
            return out

        val = value if isinstance(value, Tensor) else \
            device_scalar(value, self._value.device) \
            if isinstance(value, (bool, int, float, complex)) else \
            torch.as_tensor(value, device=self._value.device)
        self._rebind(forward_op("set_value_", put, [self, val]))

    # -- python protocol ----------------------------------------------------
    def __len__(self):
        if self.ndim == 0:
            raise TypeError("len() of a 0-d tensor")
        return self.shape[0]

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def __bool__(self):
        return _materialize("bool", self, lambda: bool(self._value.detach()))

    def __int__(self):
        return _materialize("int", self, lambda: int(self._value.detach()))

    def __float__(self):
        return _materialize("float", self,
                            lambda: float(self._value.detach()))

    def __index__(self):
        return _materialize("int", self, lambda: int(self._value.detach()))

    def __format__(self, spec):
        if self.ndim == 0:
            return format(self.item(), spec)
        return format(str(self), spec)

    __hash__ = object.__hash__

    def __repr__(self):
        grad_part = "" if self.stop_gradient else ", stop_gradient=False"
        return (f"Tensor(shape={self.shape}, dtype={dtype_name(self.dtype)}, "
                f"place={self.place}{grad_part},\n       "
                f"{self._value.detach()})")

    def __dlpack__(self, *a, **k):
        return self._value.detach().__dlpack__(*a, **k)


def _looks_like_dtype(a) -> bool:
    try:
        canonical_dtype(a)
        return True
    except (TypeError, AttributeError):
        return False


def _convert_index(idx, device):
    """Tensors and integer lists inside an index expression -> torch
    tensors on ``device``."""
    if isinstance(idx, Tensor):
        return idx._value.to(device)
    if isinstance(idx, np.ndarray):
        return torch.as_tensor(idx, device=device)
    if isinstance(idx, tuple):
        return tuple(_convert_index(i, device) for i in idx)
    if isinstance(idx, list):
        return torch.as_tensor(idx, device=device)
    return idx


class Parameter(Tensor):
    """A trainable Tensor (``paddle.base.framework.Parameter`` parity): a
    leaf with ``stop_gradient=False`` and ``persistable=True`` by default.
    A torch value is taken without a copy."""

    def __init__(self, value, trainable: bool = True,
                 name: Optional[str] = None):
        super().__init__(value, stop_gradient=not trainable,
                         name=name or _auto_name("param"))
        self.persistable = True

    @property
    def trainable(self) -> bool:
        return not self.stop_gradient

    @trainable.setter
    def trainable(self, v: bool):
        self.stop_gradient = not v

    def __repr__(self):
        return "Parameter containing:\n" + super().__repr__()


def _wrap(value: torch.Tensor, name: Optional[str] = None) -> Tensor:
    """A Tensor around an op's torch output (its autograd state as is)."""
    t = Tensor.__new__(Tensor)
    t._value = value
    t._sg = not value.requires_grad
    t.name = name or _auto_name()
    t.persistable = False
    t._version = 0
    return t


def to_tensor(data, dtype=None, place=None,
              stop_gradient: bool = True) -> Tensor:
    """``paddle.to_tensor``: copy ``data`` into a new Tensor on ``place``
    (the current place when None)."""
    if isinstance(data, Tensor):
        v = data._value.detach()
        v = v.to(device=torch_device(place) if place is not None else None,
                 dtype=canonical_dtype(dtype), copy=True)
    elif isinstance(data, (list, tuple)) and \
            any(isinstance(x, Tensor) for x in _flatten(data)):
        v = torch.stack([to_tensor(x, place=place)._value for x in data])
        v = v.to(dtype=canonical_dtype(dtype))
    elif isinstance(data, torch.Tensor):
        v = data.detach().to(device=torch_device(place),
                             dtype=canonical_dtype(dtype), copy=True)
    else:
        v = as_torch(data, dtype=dtype, device=place)
    return Tensor(v, stop_gradient=stop_gradient)


def _flatten(seq):
    for x in seq:
        if isinstance(x, (list, tuple)):
            yield from _flatten(x)
        else:
            yield x


# -- the value watch of a program capture (jit/trace.py) -----------------------

_VALUE_SLOT = Tensor.__dict__["_value"]


def capturing() -> bool:
    """True while a program is being captured (``jit/trace.py``): a value
    made from Python data must then be made on the device (a fill), not
    copied from the host."""
    return Tensor.__dict__["_value"] is not _VALUE_SLOT


def device_scalar(v, device) -> torch.Tensor:
    """``torch.tensor(v, device=device)`` for a Python scalar — made by a
    fill on the device while a program is captured (a pageable
    host-to-device copy cannot be captured)."""
    if capturing():
        return torch.full((), v, device=device)
    return torch.tensor(v, device=device)


def raw_value(t: Tensor):
    """``t._value`` past any watch; raises AttributeError on a Tensor
    whose value was never set (one being built)."""
    return _VALUE_SLOT.__get__(t, Tensor)


def set_raw_value(t: Tensor, v: torch.Tensor) -> None:
    """``t._value = v`` past any watch."""
    _VALUE_SLOT.__set__(t, v)


class _WatchedValue:
    """Stands in for the ``_value`` slot while a program is captured: every
    read reaches ``watch.on_read(t, v)`` and every write
    ``watch.on_write(t, v)``, whose result is what the slot takes. The
    slot is swapped only for the capture, so the eager path pays nothing."""

    def __init__(self, watch):
        self.watch = watch

    def __get__(self, obj, typ=None):
        if obj is None:
            return self
        v = _VALUE_SLOT.__get__(obj, typ)
        self.watch.on_read(obj, v)
        return v

    def __set__(self, obj, v):
        _VALUE_SLOT.__set__(obj, self.watch.on_write(obj, v))


class watch_values:
    """``with watch_values(watch):`` routes every Tensor's ``_value``
    reads and writes through ``watch`` (see :class:`_WatchedValue`)."""

    def __init__(self, watch):
        self.watch = watch

    def __enter__(self):
        if Tensor.__dict__["_value"] is not _VALUE_SLOT:
            raise RuntimeError("a program capture is already watching "
                               "tensor values")
        Tensor._value = _WatchedValue(self.watch)
        return self.watch

    def __exit__(self, *exc):
        Tensor._value = _VALUE_SLOT
        return False

"""Checkpoint tier 1: ``save`` / ``load`` — counterpart of
``paddle_tpu/framework/io.py`` (``paddle.save`` / ``paddle.load``).

The same container, byte for byte in layout: a pickle of the object with
every tensor replaced by a record ``{"__paddle_tpu_tensor__": True,
"value": <numpy array>, "stop_gradient": ..., "name": ...}`` (a
``torch.nn.Parameter`` becomes ``{"__paddle_tpu_param__": True, "value":
..., "trainable": requires_grad, "name": ...}``), then the 32-byte
SHA-256 of the pickle and the 8-byte magic ``PTCKSM1\\n``. A file either
package writes loads in the other.

* bf16: numpy has no bfloat16 without ``ml_dtypes``, which the port never
  imports. A bf16 tensor is written as the array JAX writes: its 2-byte
  bits under the dtype ``ml_dtypes.bfloat16``, a name the port's pickler
  (:class:`_Pickler`) puts into the stream without importing its module,
  so the JAX package loads a bf16 tensor as ``bfloat16``, bit for bit.
  Reading, :func:`unpickle` maps that type to a 2-byte void, viewed as
  bf16 (JAX's files and the port's alike); older port files, which held
  float32 values under ``"dtype": "bfloat16"``, still load as bf16.
* ``save`` is ATOMIC (temp file, flush + fsync, ``os.replace``) and hashes
  the pickle while it streams to disk; ``load`` verifies the footer when
  present and ``FLAGS_checkpoint_verify`` is on, raising
  :class:`CheckpointCorruptionError` on a truncated or bit-flipped file.
* ``async_save`` copies every tensor to host memory NOW, then pickles,
  hashes and writes on the shared background writer thread;
  ``wait_save()`` / ``is_saving()`` let a train loop overlap the write
  with compute.
* ``load(path, device=None)`` returns tensors on the card; pass
  ``device="cpu"`` for the CPU.
"""

from __future__ import annotations

import hashlib
import os
import pickle
from typing import Any

import numpy as np
import torch

from ..device import resolve_device
from .async_writer import default_writer
from .integrity import (CheckpointCorruptionError, atomic_stream,
                        verify_enabled)

__all__ = ["save", "load", "async_save", "wait_save", "is_saving",
           "to_host", "from_host", "unpickle"]

_SENTINEL = "__paddle_tpu_tensor__"
_PARAM_SENTINEL = "__paddle_tpu_param__"

# integrity footer: <pickle payload><32-byte sha256 digest><8-byte magic>
_FOOTER_MAGIC = b"PTCKSM1\n"
_FOOTER_LEN = 32 + len(_FOOTER_MAGIC)


def to_host(t: torch.Tensor) -> np.ndarray:
    """A host numpy COPY of ``t`` (never a view of it: the train step
    overwrites its tensors in place after a snapshot). bf16 becomes its
    float32 values, exactly."""
    h = t.detach().to("cpu", copy=True)
    if h.dtype == torch.bfloat16:
        h = h.to(torch.float32)
    return h.numpy()


class _Global:
    """A module-level name to write into a pickle stream as it is, without
    importing its module (the C pickler's ``save_global`` imports it)."""

    def __init__(self, module: str, name: str):
        self.module, self.name = module, name


class _BF16Bits:
    """A bf16 tensor's bits (a uint16 numpy array), pickled as the
    ``ml_dtypes.bfloat16`` numpy array the JAX package writes."""

    def __init__(self, bits: np.ndarray):
        self.bits = bits


class _BF16Dtype:
    """``np.dtype(ml_dtypes.bfloat16)`` in a pickle stream."""


# the state numpy pickles for the dtype ml_dtypes.bfloat16 (little-endian,
# 2 bytes, alignment 2, flags 64)
_BF16_DTYPE_STATE = (3, "<", None, None, None, 2, 2, 64)


class _Pickler(pickle._Pickler):
    """The pure-Python pickler, which writes :class:`_Global` names with
    ``STACK_GLOBAL`` and no import, and a :class:`_BF16Bits` array with the
    opcodes numpy's own reduction gives an ``ml_dtypes.bfloat16`` array."""

    dispatch = dict(pickle._Pickler.dispatch)

    def _save_name(self, obj):
        self.save(obj.module)
        self.save(obj.name)
        self.write(pickle.STACK_GLOBAL)
        self.memoize(obj)

    dispatch[_Global] = _save_name

    def reducer_override(self, obj):
        if isinstance(obj, _BF16Bits):
            fn, args, (ver, shape, _, fortran, raw) = \
                obj.bits.__reduce_ex__(4)
            return fn, args, (ver, shape, _BF16Dtype(), fortran, raw)
        if isinstance(obj, _BF16Dtype):
            return (np.dtype, (_Global("ml_dtypes", "bfloat16"), False, True),
                    _BF16_DTYPE_STATE)
        return NotImplemented


def from_host(value, dtype=None, device=None) -> torch.Tensor:
    """The tensor a stored array describes, on ``device`` (on the CPU it
    may share the array's memory). ``dtype == "bfloat16"`` casts stored
    float32 values back to bf16 (exact); a 2-byte void array holds a JAX
    file's raw bf16 bits."""
    a = np.asarray(value)
    if not (a.flags.c_contiguous and a.flags.writeable):
        a = np.array(a, order="C")       # torch needs its own writable copy
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
        if dtype == "bfloat16":
            t = t.to(torch.bfloat16)
    return t.to(device) if device is not None else t


class _Unpickler(pickle.Unpickler):
    """``pickle.Unpickler`` that reads ``ml_dtypes.bfloat16`` arrays (the
    JAX package's bf16) as 2-byte void arrays holding the same bits, so no
    ``ml_dtypes`` is needed."""

    def find_class(self, module, name):
        if module == "ml_dtypes" and name == "bfloat16":
            return np.void
        return super().find_class(module, name)


def unpickle(f):
    """``pickle.load(f)`` through :class:`_Unpickler`."""
    return _Unpickler(f).load()


def _value(t: torch.Tensor):
    """A host copy of ``t`` to pickle: bf16 as its bits
    (:class:`_BF16Bits`), anything else as :func:`to_host` gives it."""
    if t.dtype == torch.bfloat16:
        bits = t.detach().to("cpu", memory_format=torch.contiguous_format,
                            copy=True).view(torch.int16).numpy()
        return _BF16Bits(bits.view(np.uint16))
    return to_host(t)


def _encode(obj):
    if isinstance(obj, torch.Tensor):
        if isinstance(obj, torch.nn.Parameter):
            return {_PARAM_SENTINEL: True, "value": _value(obj),
                    "trainable": bool(obj.requires_grad), "name": None}
        return {_SENTINEL: True, "value": _value(obj),
                "stop_gradient": not obj.requires_grad, "name": None}
    if isinstance(obj, dict):
        return {k: _encode(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_encode(v) for v in obj)
    return obj


def _decode(obj, device):
    if isinstance(obj, dict):
        if obj.get(_PARAM_SENTINEL):
            t = from_host(obj["value"], obj.get("dtype"), device)
            return torch.nn.Parameter(
                t, requires_grad=bool(obj.get("trainable", True))
                and t.is_floating_point())
        if obj.get(_SENTINEL):
            t = from_host(obj["value"], obj.get("dtype"), device)
            if not obj.get("stop_gradient", True) and t.is_floating_point():
                t.requires_grad_(True)
            return t
        return {k: _decode(v, device) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_decode(v, device) for v in obj)
    return obj


def _decode_numpy(obj):
    if isinstance(obj, dict):
        if obj.get(_PARAM_SENTINEL) or obj.get(_SENTINEL):
            t = from_host(obj["value"], obj.get("dtype"))
            return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
        return {k: _decode_numpy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_decode_numpy(v) for v in obj)
    return obj


def _dump_atomic(encoded, path: str, protocol: int) -> None:
    """Stream-pickle into a same-dir temp file (hashing as it goes), append
    the integrity footer, fsync, ``os.replace`` — atomic AND single-copy."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with atomic_stream(path) as w:
        _Pickler(w, protocol=protocol).dump(encoded)
        w.raw.write(w.sha.digest() + _FOOTER_MAGIC)


def save(obj: Any, path: str, protocol: int = 4, **configs) -> None:
    _dump_atomic(_encode(obj), path, protocol)


def async_save(obj: Any, path: str, protocol: int = 4, **configs):
    """Copy ``obj``'s tensors to host memory now, write the file in the
    background. Returns the pending job; ``wait_save()`` drains all pending
    writes and re-raises any writer error."""
    with torch.profiler.record_function("ckpt"):  # the device->host copy
        encoded = _encode(obj)
    return default_writer().submit(
        lambda: _dump_atomic(encoded, path, protocol), label=path)


def wait_save(timeout=None) -> None:
    """Block until every pending ``async_save`` landed on disk; re-raises
    the first background-writer error."""
    default_writer().wait_all(timeout)


def is_saving() -> bool:
    return default_writer().busy


def load(path: str, device=None, **configs) -> Any:
    """Read a file :func:`save` (or the JAX package's ``paddle.save``)
    wrote. Tensors land on ``device`` (the card when None; ``"cpu"`` when
    asked). ``verify=`` overrides ``FLAGS_checkpoint_verify``;
    ``return_numpy=True`` returns numpy arrays (bf16 as float32)."""
    verify = configs.get("verify")
    if verify is None:
        verify = verify_enabled()
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        digest = None
        if size > _FOOTER_LEN:
            f.seek(size - len(_FOOTER_MAGIC))
            if f.read(len(_FOOTER_MAGIC)) == _FOOTER_MAGIC:
                f.seek(size - _FOOTER_LEN)
                digest = f.read(32)
        if digest is not None and verify:
            # stream-hash the payload (everything before the footer)
            f.seek(0)
            h = hashlib.sha256()
            remaining = size - _FOOTER_LEN
            while remaining > 0:
                chunk = f.read(min(1 << 20, remaining))
                if not chunk:
                    break
                h.update(chunk)
                remaining -= len(chunk)
            if remaining != 0 or h.digest() != digest:
                raise CheckpointCorruptionError(
                    f"checkpoint {path!r} failed SHA-256 verification — "
                    f"the file is truncated or corrupted (expected "
                    f"{digest.hex()[:16]}..., got {h.hexdigest()[:16]}...)")
        f.seek(0)
        try:
            # pickle stops at its STOP opcode; the footer is never read
            data = unpickle(f)
        except Exception as e:
            # a corrupt pickle stream surfaces as almost any exception type;
            # this is the one failure domain here, so wrap uniformly
            raise CheckpointCorruptionError(
                f"checkpoint {path!r} is unreadable (truncated or "
                f"corrupted): {type(e).__name__}: {e}") from e
    if configs.get("return_numpy"):
        return _decode_numpy(data)
    return _decode(data, resolve_device(device))

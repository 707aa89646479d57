"""Eager op dispatch — counterpart of ``paddle_tpu/core/dispatch.py``.

``forward_op(name, fn, args)`` keeps the reference's signature: it reads
the torch values of the Tensor arguments, runs ``fn`` on them, and wraps
the outputs. PyTorch's autograd records the graph as ``fn`` runs (under
``torch.no_grad()`` when ``differentiable=False``), so there is no tape
here. It keeps the reference's ``FLAGS_check_nan_inf`` scan
(:func:`_maybe_check_nan`), its typed, op-named errors
(``enforce.translate_op_error``) and its AMP hook: under
``amp.auto_cast`` the op's input values are cast by
``amp.auto_cast.amp_cast_inputs`` before ``fn`` sees them, on every route
(in a distributed region, per coordinate).

Left out for now, with its package (ROADMAP §A item 11): the
static-Program recorder (``static/``).

``OP_REGISTRY`` is the schema registry in the spirit of the reference's
``ops.yaml``: the op modules register under the reference's names and
categories, so a test can walk the names both registries share.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Sequence

import torch

__all__ = ["forward_op", "register_op", "OP_REGISTRY", "OpDef"]


@dataclass
class OpDef:
    """Schema entry for one op. ``category`` ("unary"/"binary") marks the
    elementwise factory ops; ``public`` is the user-facing wrapper."""
    name: str
    fn: Callable
    doc: str = ""
    n_outputs: int = 1
    differentiable: bool = True
    category: str = ""
    public: Optional[Callable] = None


OP_REGISTRY: Dict[str, OpDef] = {}


class _Regions:
    """The per-coordinate region ``forward_op`` maps over
    (``distributed.dist_tensor.shard_map`` sets it), or None."""
    active = None


def register_op(name: str, fn: Callable, doc: str = "", n_outputs: int = 1,
                differentiable: bool = True, category: str = "",
                public: Optional[Callable] = None) -> OpDef:
    d = OpDef(name, fn, doc, n_outputs, differentiable, category, public)
    OP_REGISTRY[name] = d
    return d


def forward_op(name: str, fn: Callable, args: Sequence[Any],
               kwargs: Optional[dict] = None, differentiable: bool = True):
    """Run ``fn`` on mixed Tensor/raw ``args`` (``kwargs`` are static);
    returns a Tensor, or a tuple of them mirroring ``fn``'s outputs."""
    from .tensor import Tensor
    kwargs = kwargs or {}
    if _amp_state().enable:
        fn = _amp_cast(name, fn)
    if _Regions.active is not None:
        return _Regions.active.run(name, fn, args, kwargs, differentiable)
    vals = [a._value if isinstance(a, Tensor) else a for a in args]
    try:
        if differentiable:
            out = fn(*vals, **kwargs)
        else:
            with torch.no_grad():
                out = fn(*vals, **kwargs)
    except Exception as e:  # typed error with op + shapes + user frame
        from .enforce import translate_op_error
        raise translate_op_error(e, name, vals) from e
    _maybe_check_nan(name, out)
    return _wrap_outputs(out)


_AMP = []


def _amp_state():
    """``amp.auto_cast``'s thread-local state (imported on first use: the
    amp package imports the tensor core)."""
    if not _AMP:
        from ..amp.auto_cast import _amp_state as st
        _AMP.append(st)
    return _AMP[0]


def _amp_cast(name: str, fn: Callable) -> Callable:
    """``fn`` with its positional values cast by the active auto_cast
    state (the reference's generated AMP checks)."""
    from ..amp.auto_cast import amp_cast_inputs

    def cast_fn(*vals, **kw):
        return fn(*amp_cast_inputs(name, vals), **kw)
    return cast_fn


def _wrap_outputs(out):
    from .. import flags
    from .tensor import _wrap
    retain = flags.flag("FLAGS_retain_grad_for_all_tensor")

    def one(v):
        if not isinstance(v, torch.Tensor):
            v = torch.as_tensor(v)
        if retain and v.requires_grad and not v.is_leaf:
            v.retain_grad()
        return _wrap(v)

    if isinstance(out, (tuple, list)):
        return tuple(one(v) for v in out)
    return one(out)


def _maybe_check_nan(name, out):
    from .. import flags
    if not flags.flag("FLAGS_check_nan_inf"):
        return
    for v in out if isinstance(out, (tuple, list)) else (out,):
        if isinstance(v, torch.Tensor) and v.is_floating_point() and \
                not bool(torch.isfinite(v.detach()).all()):
            raise FloatingPointError(
                f"NaN/Inf detected in output of op {name!r}")

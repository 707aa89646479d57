"""``paddle.static`` — counterpart of ``paddle_tpu/static/__init__.py``.

* ``enable_static`` / ``disable_static`` / ``in_static_mode``: in static
  mode the default main Program records every dispatched op
  (``program.py``); construction still runs eagerly on the placeholders,
  and ``Executor.run(feed, fetch_list)`` replays the tape.
  ``disable_static`` leaves static mode: an eager op is then not recorded.
* ``Program``, ``Executor``, ``program_guard``, ``data``,
  ``append_backward``, ``MissingFeedError`` and the default Programs.
* ``InputSpec`` (``jit``'s), and ``save_inference_model`` /
  ``load_inference_model`` over ``jit.save`` / ``jit.load``.
* ``nn``: ``fc``, ``batch_norm``, ``conv2d`` and ``sequence_pool``, which
  record like any op; ``name_scope`` and ``device_guard`` change nothing.
"""

from __future__ import annotations

import contextlib

from ..jit.api import InputSpec
from .program import (Executor, MissingFeedError, Program, append_backward,
                      data, default_main_program, default_startup_program,
                      program_guard)

__all__ = ["InputSpec", "enable_static", "disable_static", "Program",
           "Executor", "MissingFeedError", "data",
           "append_backward", "default_main_program",
           "default_startup_program", "program_guard",
           "save_inference_model", "load_inference_model",
           "name_scope", "device_guard", "nn"]

_static_mode = False


def enable_static():
    """Enter static mode: the default main Program records every
    dispatched op from here on."""
    global _static_mode
    from ..core import dispatch as _d
    _static_mode = True
    _d._static_recorder = default_main_program()


def disable_static():
    """Leave static mode: nothing records any more."""
    global _static_mode
    from ..core import dispatch as _d
    _static_mode = False
    _d._static_recorder = None


def in_static_mode() -> bool:
    return _static_mode


class nn:
    """``paddle.static.nn``: the layer ops of the static workflow (each
    records into the active Program through the dispatcher)."""
    from ..ops.legacy import fc  # noqa: F401
    fc = staticmethod(fc)

    @staticmethod
    def batch_norm(x, *a, **k):
        from ..nn import functional as F
        return F.batch_norm(x, *a, **k)

    @staticmethod
    def conv2d(x, *a, **k):
        from ..nn import functional as F
        return F.conv2d(x, *a, **k)

    @staticmethod
    def sequence_pool(x, pool_type, lens):
        from ..ops.sequence import sequence_pool
        return sequence_pool(x, pool_type, lens)


def name_scope(prefix=None):
    return contextlib.nullcontext()


def device_guard(device=None):
    return contextlib.nullcontext()


def save_inference_model(path_prefix, feed_vars, fetch_vars, executor=None,
                         **kwargs):
    """``jit.save`` of the layer or function passed as ``fetch_vars`` (or
    as ``program=``), with ``feed_vars`` as its input specs; the
    ``executor`` argument has nothing to do."""
    from ..jit import api as jit_api
    program = kwargs.get("program")
    layer = program if program is not None else fetch_vars
    specs = feed_vars if feed_vars else None
    return jit_api.save(layer, path_prefix, input_spec=specs)


def load_inference_model(path_prefix, executor=None, **kwargs):
    """``jit.load`` of the saved artifact, on the current place."""
    from ..jit import api as jit_api
    return jit_api.load(path_prefix)

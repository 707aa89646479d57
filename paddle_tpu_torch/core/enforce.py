"""Error-handling layer — counterpart of ``paddle_tpu/core/enforce.py``
(PADDLE_ENFORCE parity).

The same typed error classes and codes, the ``enforce*`` check helpers
that record the calling frame, :func:`translate_op_error` (the eager
dispatcher's op-named, shape-listing errors, with this package's and
PyTorch's frames trimmed from the user frame) and the ``faulthandler``
dump of native crashes (a fault inside a CUDA library should still leave
a python stack).
"""

from __future__ import annotations

import faulthandler
import sys

__all__ = ["EnforceNotMet", "InvalidArgumentError", "NotFoundError",
           "OutOfRangeError", "AlreadyExistsError", "PermissionDeniedError",
           "UnimplementedError", "UnavailableError", "ResourceExhaustedError",
           "PreconditionNotMetError", "ExecutionTimeoutError", "FatalError",
           "enforce", "enforce_eq", "enforce_gt", "enforce_not_none",
           "install_signal_handlers", "translate_op_error", "user_frame"]


class EnforceNotMet(RuntimeError):
    """Base check failure (ref: platform::EnforceNotMet). Carries the calling
    frame so the message reads like the reference's [operator ... at file:line]
    context block."""

    error_code = "ENFORCE_NOT_MET"

    def __init__(self, message: str, frame=None):
        if frame is None:
            f = sys._getframe(2) if sys._getframe(1).f_code.co_filename == \
                __file__ else sys._getframe(1)
            frame = (f.f_code.co_filename, f.f_lineno, f.f_code.co_name)
        fname, lineno, func = frame
        super().__init__(
            f"{message}\n  [Hint: raised from {func} at {fname}:{lineno}] "
            f"(error code: {self.error_code})")
        self.frame = frame


class InvalidArgumentError(EnforceNotMet):
    error_code = "INVALID_ARGUMENT"


class NotFoundError(EnforceNotMet):
    error_code = "NOT_FOUND"


class OutOfRangeError(EnforceNotMet):
    error_code = "OUT_OF_RANGE"


class AlreadyExistsError(EnforceNotMet):
    error_code = "ALREADY_EXISTS"


class PermissionDeniedError(EnforceNotMet):
    error_code = "PERMISSION_DENIED"


class UnimplementedError(EnforceNotMet):
    error_code = "UNIMPLEMENTED"


class UnavailableError(EnforceNotMet):
    error_code = "UNAVAILABLE"


class ResourceExhaustedError(EnforceNotMet):
    error_code = "RESOURCE_EXHAUSTED"


class PreconditionNotMetError(EnforceNotMet):
    error_code = "PRECONDITION_NOT_MET"


class ExecutionTimeoutError(EnforceNotMet):
    error_code = "EXECUTION_TIMEOUT"


class FatalError(EnforceNotMet):
    error_code = "FATAL"


def enforce(condition, message: str = "enforce failed",
            exc: type = EnforceNotMet):
    """ref: PADDLE_ENFORCE(cond, msg)."""
    if not condition:
        raise exc(message)


def enforce_eq(a, b, message: str = ""):
    if a != b:
        raise InvalidArgumentError(
            f"expected {a!r} == {b!r}" + (f": {message}" if message else ""))


def enforce_gt(a, b, message: str = ""):
    if not a > b:
        raise InvalidArgumentError(
            f"expected {a!r} > {b!r}" + (f": {message}" if message else ""))


def enforce_not_none(value, message: str = ""):
    if value is None:
        raise NotFoundError(message or "expected a value, got None")
    return value


# ---------------------------------------------------------------------------
# dispatcher-raised error translation (the PADDLE_ENFORCE user experience:
# op name + argument shapes/dtypes + the USER's stack frame, with torch
# internals trimmed, and actionable hints for the common failure classes)
# ---------------------------------------------------------------------------

_INTERNAL_MARKERS = ("/paddle_tpu_torch/", "/torch/", "<frozen")


def user_frame():
    """(filename, lineno, funcname) of the innermost stack frame OUTSIDE
    this framework and torch — the line of user code that triggered the op
    (ref: the python-side of the fused C++/Python traceback)."""
    f = sys._getframe(1)
    while f is not None:
        fn = f.f_code.co_filename
        if not any(m in fn for m in _INTERNAL_MARKERS):
            return (fn, f.f_lineno, f.f_code.co_name)
        f = f.f_back
    return None


def _describe(v) -> str:
    shape = getattr(v, "shape", None)
    if shape is None:
        return repr(v)[:40]
    dtype = getattr(v, "dtype", "?")
    return f"{dtype}{list(shape)}"


def translate_op_error(e: BaseException, op: str, vals=()) -> "EnforceNotMet":
    """Map a raw torch exception from operator ``op`` to a typed framework
    error carrying the op name, input signatures, the user stack frame, and
    a hint when the failure class is recognized (OOM, shape mismatch, dtype
    mismatch, donation, NaN). The original exception is preserved as
    ``__cause__`` (raise ... from e at the call site)."""
    if isinstance(e, EnforceNotMet):
        return e
    import re as _re
    text = str(e)
    low = text.lower()
    cls, hint = InvalidArgumentError, ""
    # typed-exception classes first: their message text must not reroute
    # them through the substring heuristics
    if isinstance(e, NotImplementedError):
        cls = UnimplementedError
    elif isinstance(e, MemoryError):
        cls = ResourceExhaustedError
    elif "resource_exhausted" in low or "out of memory" in low or \
            "ran out of memory" in low:
        cls = ResourceExhaustedError
        hint = ("the program does not fit in device memory — lower the "
                "batch size, enable activation recomputation "
                "(recompute/remat), store optimizer moments in bfloat16, "
                "or shard parameters (ZeRO/mp) across more devices")
    elif "donat" in low:
        cls = InvalidArgumentError
        hint = ("a donated buffer was reused — don't read tensors passed "
                "for donation after the call, or drop the donation")
    elif "incompatible shapes" in low or "shapes must be equal" in low or \
            "dimension" in low and ("mismatch" in low or "must" in low) or \
            "rank" in low and "must" in low or "got shape" in low or \
            "size" in low and "reshape" in low:
        cls = InvalidArgumentError
        hint = "check the input shapes listed above"
    elif "dtype" in low or "must be a" in low and "type" in low:
        cls = InvalidArgumentError
        hint = "check the input dtypes listed above"
    elif isinstance(e, FloatingPointError) or \
            _re.search(r"\bnan\b|\binf\b|non-finite", low):
        cls = FatalError
        hint = ("enable FLAGS_check_nan_inf to pinpoint the first operator "
                "producing non-finite values")

    sig = ", ".join(_describe(v) for v in vals) if vals else "-"
    first = text.strip().splitlines()[0][:400] if text.strip() else \
        type(e).__name__
    uf = user_frame()
    at = f"\n  [user code: {uf[0]}:{uf[1]} in {uf[2]}]" if uf else ""
    hint_s = f"\n  [Hint: {hint}]" if hint else ""
    err = cls(
        f"operator `{op}` failed: {first}\n  inputs: ({sig}){at}{hint_s}",
        frame=uf or ("<unknown>", 0, "?"))
    return err


_handlers_installed = False


def install_signal_handlers():
    """ref: paddle/fluid/platform/init.cc InitSignalHandler — dump the python
    stack of every thread on SIGSEGV/SIGFPE/SIGABRT/SIGBUS (native crashes in
    a CUDA library otherwise die silently)."""
    global _handlers_installed
    if not _handlers_installed:
        faulthandler.enable(all_threads=True)
        _handlers_installed = True


# installed at import (matching the reference: the framework installs its
# handler during paddle.base init)
install_signal_handlers()

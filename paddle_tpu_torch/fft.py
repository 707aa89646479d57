"""``paddle.fft`` — counterpart of ``paddle_tpu/fft.py``: spectral ops
over ``torch.fft`` (cuFFT on the card), through the eager dispatcher.

Norms are "backward", "ortho" and "forward". The dtype rule is the
reference's (``jnp.fft`` with 32-bit defaults): integer, bool, bfloat16
and float16 inputs are computed in float32 (complex64), so a half input
never takes cuFFT's half-precision route, which takes only power-of-two
sizes; a transform of a real input (``rfft*``, ``ihfft*``) refuses a
half one, as ``jnp.fft`` does; float64 stays float64.
"""

from __future__ import annotations

import torch

from .core.dispatch import register_op
from .core.dtype import canonical_dtype
from .core.place import torch_device
from .core.tensor import Tensor
from .ops._helpers import axes_arg, ensure_tensor, forward_op

__all__ = ["fft", "ifft", "rfft", "irfft", "hfft", "ihfft", "fft2", "ifft2",
           "rfft2", "irfft2", "fftn", "ifftn", "rfftn", "irfftn",
           "fftfreq", "rfftfreq", "fftshift", "ifftshift"]

_WIDE = (torch.float32, torch.float64, torch.complex64, torch.complex128)


def _norm(norm):
    if norm not in (None, "backward", "ortho", "forward"):
        raise ValueError(f"fft norm must be backward/ortho/forward, got "
                         f"{norm!r}")
    return norm or "backward"


# the transforms that take a real input: the reference refuses a half one
_REAL_IN = {"rfft", "rfftn", "ihfft", "ihfftn"}


def _widen(v, name):
    """The reference's input rule: integer and bool inputs are computed in
    float32, as are half-precision ones, except that a transform of a real
    input refuses them (as ``jnp.fft``'s)."""
    if v.dtype in _WIDE:
        return v
    if name in _REAL_IN and v.dtype in (torch.float16, torch.bfloat16):
        raise ValueError(f"RFFT input must be float32 or float64, got "
                         f"{str(v.dtype).replace('torch.', '')}")
    return v.to(torch.float32)


def _hfft_nd(v, s, axes, norm, inverse: bool):
    """The Hermitian N-d transforms (torch.fft semantics: one-sided in the
    last transform dim only)."""
    f = torch.fft.ihfftn if inverse else torch.fft.hfftn
    v = _widen(v, f.__name__)
    dims = None if axes is None else tuple(axes)
    return f(v, s=None if s is None else tuple(s), dim=dims,
             norm=_norm(norm)).resolve_conj()


def _mk1(name):
    tfn = getattr(torch.fft, name)

    def op(x, n=None, axis=-1, norm="backward", name_=None):
        return forward_op(name, lambda v: tfn(
            _widen(v, name), n=n, dim=axis, norm=_norm(norm)).resolve_conj(),
            [ensure_tensor(x)])
    op.__name__ = name
    op.__doc__ = f"paddle.fft.{name} (torch.fft; reference parity)."
    return op


def _mkn(name):
    tfn = getattr(torch.fft, name)

    def op(x, s=None, axes=None, norm="backward", name_=None):
        return forward_op(
            name, lambda v: tfn(_widen(v, name),
                                s=None if s is None else tuple(s),
                                dim=None if axes is None else tuple(axes),
                                norm=_norm(norm)).resolve_conj(),
            [ensure_tensor(x)])
    op.__name__ = name
    op.__doc__ = f"paddle.fft.{name} (torch.fft; reference parity)."
    return op


def _mk2(name):
    nfn = _mkn(name.replace("2", "n"))

    def op(x, s=None, axes=(-2, -1), norm="backward", name_=None):
        return nfn(x, s=s, axes=axes, norm=norm)
    op.__name__ = name
    return op


fft = _mk1("fft")
ifft = _mk1("ifft")
rfft = _mk1("rfft")
irfft = _mk1("irfft")
hfft = _mk1("hfft")
ihfft = _mk1("ihfft")
fftn = _mkn("fftn")
ifftn = _mkn("ifftn")
rfftn = _mkn("rfftn")
irfftn = _mkn("irfftn")
fft2 = _mk2("fft2")
ifft2 = _mk2("ifft2")
rfft2 = _mk2("rfft2")
irfft2 = _mk2("irfft2")


def fftfreq(n, d=1.0, dtype="float32", name=None):
    return Tensor(torch.fft.fftfreq(n, d, device=torch_device()).to(
        canonical_dtype(dtype)))


def rfftfreq(n, d=1.0, dtype="float32", name=None):
    return Tensor(torch.fft.rfftfreq(n, d, device=torch_device()).to(
        canonical_dtype(dtype)))


def fftshift(x, axes=None, name=None):
    return forward_op("fftshift",
                      lambda v: torch.fft.fftshift(v, dim=axes_arg(axes)),
                      [ensure_tensor(x)])


def ifftshift(x, axes=None, name=None):
    return forward_op("ifftshift",
                      lambda v: torch.fft.ifftshift(v, dim=axes_arg(axes)),
                      [ensure_tensor(x)])


for _n in __all__:
    _f = globals()[_n]
    register_op(_n, _f, (_f.__doc__ or "").strip().split("\n")[0],
                category="fft", public=_f)

"""Window functions — counterpart of ``paddle_tpu/ops/windows.py``.

``get_window`` and the ``*_window`` creation ops, each a torch expression
of ``arange(M)`` computed in float64 on the current device and cast to the
requested dtype; ``sym=False`` (``fftbins=True``) computes the M+1 window
and drops the last sample, as scipy.signal does.
"""

from __future__ import annotations

import math as _math

import numpy as np
import torch

from ..core.dtype import canonical_dtype
from ..core.place import torch_device
from ._helpers import forward_op, register_op

__all__ = [
    "blackman_window", "hamming_window", "hann_window", "bartlett_window",
    "kaiser_window", "nuttall_window", "blackman_harris_window",
    "bohman_window", "cosine_window", "tukey_window", "gaussian_window",
    "exponential_window", "general_cosine_window", "general_hamming_window",
    "triang_window", "taylor_window", "get_window",
]

_F64 = torch.float64


def _ext(M: int, sym: bool):
    """scipy's extend/truncate trick for periodic windows."""
    return (M + 1, True) if (not sym and M > 1) else (M, False)


def _ar(n, dev, start=0):
    return torch.arange(start, n, dtype=_F64, device=dev)


def _general_cosine(M, a, sym, dev):
    Mx, trunc = _ext(M, sym)
    if Mx == 1:
        w = torch.ones(1, dtype=_F64, device=dev)
    else:
        fac = torch.linspace(-_math.pi, _math.pi, Mx, dtype=_F64, device=dev)
        w = sum(ai * torch.cos(i * fac) for i, ai in enumerate(a))
    return w[:-1] if trunc else w


def _blackman(M, sym=True, dev=None):
    return _general_cosine(M, [0.42, 0.50, 0.08], sym, dev)


def _hamming(M, sym=True, dev=None):
    return _general_cosine(M, [0.54, 0.46], sym, dev)


def _general_hamming(M, alpha, sym=True, dev=None):
    return _general_cosine(M, [alpha, 1.0 - alpha], sym, dev)


def _hann(M, sym=True, dev=None):
    return _general_cosine(M, [0.5, 0.5], sym, dev)


def _nuttall(M, sym=True, dev=None):
    return _general_cosine(M, [0.3635819, 0.4891775, 0.1365995, 0.0106411],
                           sym, dev)


def _blackman_harris(M, sym=True, dev=None):
    return _general_cosine(M, [0.35875, 0.48829, 0.14128, 0.01168], sym, dev)


def _bartlett(M, sym=True, dev=None):
    Mx, trunc = _ext(M, sym)
    if Mx == 1:
        return torch.ones(1, dtype=_F64, device=dev)
    n = _ar(Mx, dev)
    w = torch.where(n <= (Mx - 1) / 2.0, 2.0 * n / (Mx - 1),
                    2.0 - 2.0 * n / (Mx - 1))
    return w[:-1] if trunc else w


def _triang(M, sym=True, dev=None):
    Mx, trunc = _ext(M, sym)
    n = _ar((Mx + 1) // 2 + 1, dev, start=1)
    if Mx % 2 == 0:
        w = (2 * n - 1.0) / Mx
        w = torch.cat([w, w.flip(0)])
    else:
        w = 2 * n / (Mx + 1.0)
        w = torch.cat([w, w[:-1].flip(0)])
    return w[:-1] if trunc else w


def _kaiser(M, beta=12.0, sym=True, dev=None):
    Mx, trunc = _ext(M, sym)
    if Mx == 1:
        return torch.ones(1, dtype=_F64, device=dev)
    n = _ar(Mx, dev)
    alpha = (Mx - 1) / 2.0
    arg = torch.clamp(1.0 - ((n - alpha) / alpha) ** 2, 0.0, 1.0)
    w = torch.special.i0(beta * torch.sqrt(arg)) / torch.special.i0(
        torch.tensor(float(beta), dtype=_F64, device=dev))
    return w[:-1] if trunc else w


def _bohman(M, sym=True, dev=None):
    Mx, trunc = _ext(M, sym)
    if Mx == 1:
        return torch.ones(1, dtype=_F64, device=dev)
    fac = torch.linspace(-1, 1, Mx, dtype=_F64, device=dev).abs()
    w = (1 - fac) * torch.cos(_math.pi * fac) + \
        1.0 / _math.pi * torch.sin(_math.pi * fac)
    w[0] = 0.0          # the endpoints are exactly zero in scipy
    w[-1] = 0.0
    return w[:-1] if trunc else w


def _cosine(M, sym=True, dev=None):
    Mx, trunc = _ext(M, sym)
    w = torch.sin(_math.pi / Mx * (_ar(Mx, dev) + 0.5))
    return w[:-1] if trunc else w


def _tukey(M, alpha=0.5, sym=True, dev=None):
    Mx, trunc = _ext(M, sym)
    if Mx == 1:
        return torch.ones(1, dtype=_F64, device=dev)
    if alpha <= 0:
        w = torch.ones(Mx, dtype=_F64, device=dev)
    elif alpha >= 1:
        w = _hann(Mx, sym=True, dev=dev)
    else:
        n = _ar(Mx, dev)
        width = alpha * (Mx - 1) / 2.0
        w = torch.where(
            n < width,
            0.5 * (1 + torch.cos(_math.pi * (-1 + 2.0 * n / alpha
                                             / (Mx - 1)))),
            torch.where(
                n > (Mx - 1) * (1 - alpha / 2.0),
                0.5 * (1 + torch.cos(_math.pi * (-2.0 / alpha + 1 + 2.0 * n
                                                 / alpha / (Mx - 1)))),
                torch.ones_like(n)))
    return w[:-1] if trunc else w


def _gaussian(M, std=7.0, sym=True, dev=None):
    Mx, trunc = _ext(M, sym)
    n = _ar(Mx, dev) - (Mx - 1.0) / 2.0
    w = torch.exp(-(n ** 2) / (2.0 * std * std))
    return w[:-1] if trunc else w


def _exponential(M, center=None, tau=1.0, sym=True, dev=None):
    Mx, trunc = _ext(M, sym)
    c = (Mx - 1) / 2.0 if center is None else center
    w = torch.exp(-(_ar(Mx, dev) - c).abs() / tau)
    return w[:-1] if trunc else w


def _taylor(M, nbar=4, sll=30, norm=True, sym=True, dev=None):
    Mx, trunc = _ext(M, sym)
    B = 10 ** (sll / 20.0)
    A = _math.acosh(B) / _math.pi
    s2 = nbar ** 2 / (A ** 2 + (nbar - 0.5) ** 2)
    man = np.arange(1, nbar)
    Fm = []
    for mi in man:
        numer = (-1) ** (mi + 1) * np.prod(
            1 - mi ** 2 / s2 / (A ** 2 + (man - 0.5) ** 2))
        denom = 2 * np.prod([1 - mi ** 2 / j ** 2 for j in man if j != mi])
        Fm.append(numer / denom)
    Fm = torch.as_tensor(np.asarray(Fm, np.float64), device=dev)
    ma = torch.as_tensor(man.astype(np.float64), device=dev)
    n = _ar(Mx, dev)
    w = 1 + 2 * torch.sum(
        Fm[:, None] * torch.cos(2 * _math.pi * ma[:, None]
                                * (n[None] - Mx / 2.0 + 0.5) / Mx), dim=0)
    if norm:
        w = w / (1 + 2 * torch.sum(Fm * torch.cos(2 * _math.pi * ma * 0.0)))
    return w[:-1] if trunc else w


def _general_cosine_pub(M, a, sym=True, dev=None):
    return _general_cosine(M, list(a), sym, dev)


def _creation(name, fn, doc=""):
    """Register a window creation op returning a float Tensor."""
    def op(window_length, *args, sym=True, dtype="float32", name_=None,
           **kw):
        dt = canonical_dtype(dtype)
        dev = torch_device()
        return forward_op(
            name, lambda: fn(int(window_length), *args, sym=sym, dev=dev,
                             **kw).to(dt), [], differentiable=False)

    op.__name__ = name
    op.__qualname__ = name
    op.__doc__ = doc or f"{name} of the given length (sym=False -> periodic)."
    register_op(name, fn, op.__doc__, differentiable=False,
                category="window", public=op)
    return op


blackman_window = _creation("blackman_window", _blackman)
hamming_window = _creation("hamming_window", _hamming)
hann_window = _creation("hann_window", _hann)
bartlett_window = _creation("bartlett_window", _bartlett)
kaiser_window = _creation("kaiser_window", _kaiser)
nuttall_window = _creation("nuttall_window", _nuttall)
blackman_harris_window = _creation("blackman_harris_window", _blackman_harris)
bohman_window = _creation("bohman_window", _bohman)
cosine_window = _creation("cosine_window", _cosine)
tukey_window = _creation("tukey_window", _tukey)
gaussian_window = _creation("gaussian_window", _gaussian)
exponential_window = _creation("exponential_window", _exponential)
general_cosine_window = _creation("general_cosine_window",
                                  _general_cosine_pub)
general_hamming_window = _creation("general_hamming_window", _general_hamming)
triang_window = _creation("triang_window", _triang)
taylor_window = _creation("taylor_window", _taylor)

_BY_NAME = {
    "blackman": _blackman, "hamming": _hamming, "hann": _hann,
    "bartlett": _bartlett, "kaiser": _kaiser, "nuttall": _nuttall,
    "blackmanharris": _blackman_harris, "bohman": _bohman,
    "cosine": _cosine, "tukey": _tukey, "gaussian": _gaussian,
    "exponential": _exponential, "general_cosine": _general_cosine_pub,
    "general_hamming": _general_hamming, "triang": _triang,
    "taylor": _taylor,
}


def get_window(window, win_length: int, fftbins: bool = True,
               dtype: str = "float64"):
    """``paddle.audio.functional.get_window`` parity: window by name (or
    ``(name, param)`` tuple), periodic by default (``fftbins=True``)."""
    args = ()
    if isinstance(window, (tuple, list)):
        window, *args = window
    if not isinstance(window, str):
        raise TypeError(f"window must be a str or (str, param), got "
                        f"{window!r}")
    try:
        fn = _BY_NAME[window]
    except KeyError:
        raise ValueError(
            f"unknown window {window!r}; options: {sorted(_BY_NAME)}") \
            from None
    dt = canonical_dtype(dtype)
    dev = torch_device()
    return forward_op("get_window",
                      lambda: fn(int(win_length), *args, sym=not fftbins,
                                 dev=dev).to(dt),
                      [], differentiable=False)


register_op("get_window", get_window, get_window.__doc__,
            differentiable=False, category="window", public=get_window)

"""``paddle.signal`` — counterpart of ``paddle_tpu/signal.py``: ``stft``
and ``istft`` as the reference computes them. Framing is one gather of
static frame indices, the transform ``torch.fft`` (cuFFT on the card);
the inverse is a windowed overlap-add (``index_add``) normalized by the
window-square envelope. No Python loop over frames.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .core.dispatch import register_op
from .ops._helpers import ensure_tensor, forward_op

__all__ = ["stft", "istft"]

# jnp.pad's mode names -> torch's
_PAD_MODES = {"reflect": "reflect", "edge": "replicate",
              "replicate": "replicate", "constant": "constant",
              "wrap": "circular", "circular": "circular"}


def _prep_window(window, win_length: int, n_fft: int, device):
    if window is None:
        w = torch.ones(win_length, dtype=torch.float32, device=device)
    else:
        w = ensure_tensor(window)._value.to(torch.float32)
        if w.shape[0] != win_length:
            raise ValueError(f"window length {w.shape[0]} != win_length "
                             f"{win_length}")
    pad = n_fft - win_length
    return F.pad(w, (pad // 2, pad - pad // 2)) if pad else w


def _frame_index(n_frames, hop, n_fft, device):
    return (torch.arange(n_frames, device=device)[:, None] * hop
            + torch.arange(n_fft, device=device)[None, :])


def stft(x, n_fft: int, hop_length: Optional[int] = None,
         win_length: Optional[int] = None, window=None, center: bool = True,
         pad_mode: str = "reflect", normalized: bool = False,
         onesided: bool = True, name=None):
    """Short-time Fourier transform -> ``[..., n_freq, n_frames]`` complex
    (ref: paddle.signal.stft)."""
    t = ensure_tensor(x)
    hop = int(hop_length) if hop_length else n_fft // 4
    wl = int(win_length) if win_length else n_fft
    w = _prep_window(window, wl, n_fft, t._value.device)

    def impl(v):
        one_d = v.dim() == 1
        vv = v[None] if one_d else v.reshape(-1, v.shape[-1])
        if center:
            vv = F.pad(vv[:, None], (n_fft // 2, n_fft // 2),
                       mode=_PAD_MODES[pad_mode])[:, 0]
        n_frames = 1 + (vv.shape[-1] - n_fft) // hop
        frames = vv[:, _frame_index(n_frames, hop, n_fft, v.device)] * w
        sp = torch.fft.rfft(frames, dim=-1) if onesided \
            else torch.fft.fft(frames, dim=-1)
        if normalized:
            sp = sp / (n_fft ** 0.5)
        sp = sp.transpose(-1, -2)                        # [B, freq, frames]
        return sp[0] if one_d else sp.reshape(v.shape[:-1] + sp.shape[-2:])

    return forward_op("stft", impl, [t])


def istft(x, n_fft: int, hop_length: Optional[int] = None,
          win_length: Optional[int] = None, window=None, center: bool = True,
          normalized: bool = False, onesided: bool = True,
          length: Optional[int] = None, return_complex: bool = False,
          name=None):
    """Inverse STFT by windowed overlap-add with window-square
    normalization (ref: paddle.signal.istft)."""
    t = ensure_tensor(x)
    hop = int(hop_length) if hop_length else n_fft // 4
    wl = int(win_length) if win_length else n_fft
    w = _prep_window(window, wl, n_fft, t._value.device)

    def impl(sp):
        one_batch = sp.dim() == 2
        s = sp[None] if one_batch else sp.reshape((-1,) + sp.shape[-2:])
        s = s.transpose(-1, -2)                          # [B, frames, freq]
        if normalized:
            s = s * (n_fft ** 0.5)
        frames = torch.fft.irfft(s, n=n_fft, dim=-1) if onesided \
            else torch.fft.ifft(s, dim=-1)
        if not return_complex and frames.is_complex():
            frames = frames.real
        frames = frames * w
        B, n_frames = frames.shape[0], frames.shape[1]
        T = n_fft + hop * (n_frames - 1)
        idx = _frame_index(n_frames, hop, n_fft, sp.device).reshape(-1)
        out = torch.zeros((B, T), dtype=frames.dtype, device=sp.device
                          ).index_add(1, idx, frames.reshape(B, -1))
        env = torch.zeros(T, dtype=torch.float32, device=sp.device
                          ).index_add(0, idx, (w * w).repeat(n_frames))
        out = out / torch.clamp(env, min=1e-11)[None, :]
        if center:
            out = out[:, n_fft // 2: T - n_fft // 2]
        if length is not None:
            out = out[:, :length]
        return out[0] if one_batch else \
            out.reshape(sp.shape[:-2] + out.shape[-1:])

    return forward_op("istft", impl, [t])


register_op("stft", stft, "Short-time Fourier transform.", public=stft)
register_op("istft", istft, "Inverse STFT (windowed overlap-add).",
            public=istft)

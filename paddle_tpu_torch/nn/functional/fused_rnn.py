"""Fused RNN ops — counterpart of ``paddle_tpu/nn/functional/fused_rnn.py``
(fusion_gru_op / fusion_lstm_op / multi_gru_op / gru_unit_op /
lstm_unit_op in Paddle).

The reference's weight layouts: ``wx [D, 3H/4H]``, ``wh [H, 3H/4H]``, gate
order update / reset / candidate for the GRU and i / f / c / o for the
LSTM. One GEMM projects every step's input (``[B, T, D] @ wx``), then a
loop over the T steps does one ``[B, H] @ wh`` GEMM and the gate formula
each, as the reference's ``lax.scan`` step does.

Registered as the reference registers them: ``fusion_gru``,
``fusion_lstm`` and ``multi_gru`` in the "fused" category here;
``gru_unit`` and ``lstm_unit`` join ``__all__`` after that, so
``nn.functional``'s own registration takes them.
"""

from __future__ import annotations

import torch

from ...ops._helpers import ensure_tensor, forward_op

__all__ = ["fusion_gru", "fusion_lstm", "multi_gru"]


def _gru_gate(xg, hg, h, origin_mode):
    H = h.shape[-1]
    u = torch.sigmoid(xg[:, :H] + hg[:, :H])
    r = torch.sigmoid(xg[:, H:2 * H] + hg[:, H:2 * H])
    c = torch.tanh(xg[:, 2 * H:] + r * hg[:, 2 * H:])
    return u * h + (1 - u) * c if origin_mode else (1 - u) * h + u * c


def lstm_gate(g, c, forget_bias=0.0):
    """The LSTM step from the summed gate pre-activations ``g [..., 4H]``
    (i / f / c / o) and the cell ``c [..., H]``: (hidden, cell). The
    recurrent layers' LSTM shares it."""
    H = c.shape[-1]
    i = torch.sigmoid(g[..., :H])
    f = torch.sigmoid(g[..., H:2 * H] + forget_bias)
    cc = torch.tanh(g[..., 2 * H:3 * H])
    o = torch.sigmoid(g[..., 3 * H:])
    nc = f * c + i * cc
    return o * torch.tanh(nc), nc


def fusion_gru(x, wx, wh, bias=None, h0=None, is_reverse: bool = False,
               origin_mode: bool = False, name=None):
    """One-layer GRU over [B, T, D] -> hidden sequence [B, T, H]."""
    args = [ensure_tensor(x), ensure_tensor(wx), ensure_tensor(wh)]
    if bias is not None:
        args.append(ensure_tensor(bias))
    if h0 is not None:
        args.append(ensure_tensor(h0))

    def impl(xv, wxv, whv, *rest):
        bv = rest[0] if bias is not None else None
        B, T, _ = xv.shape
        xs = xv @ wxv                                        # [B, T, 3H]
        if bv is not None:
            xs = xs + bv
        h = rest[-1] if h0 is not None else xv.new_zeros(B, whv.shape[0])
        hs = [None] * T
        for t in (range(T - 1, -1, -1) if is_reverse else range(T)):
            h = _gru_gate(xs[:, t], h @ whv, h, origin_mode)
            hs[t] = h
        return torch.stack(hs, 1)

    return forward_op("fusion_gru", impl, args)


def fusion_lstm(x, wx, wh, bias=None, h0=None, c0=None,
                is_reverse: bool = False, name=None):
    """One-layer LSTM over [B, T, D] -> (hidden seq [B, T, H],
    cell seq [B, T, H])."""
    args = [ensure_tensor(x), ensure_tensor(wx), ensure_tensor(wh)]
    if bias is not None:
        args.append(ensure_tensor(bias))
    if h0 is not None:
        args += [ensure_tensor(h0), ensure_tensor(c0)]

    def impl(xv, wxv, whv, *rest):
        bv = rest[0] if bias is not None else None
        B, T, _ = xv.shape
        xs = xv @ wxv                                        # [B, T, 4H]
        if bv is not None:
            xs = xs + bv
        if h0 is not None:
            h, c = rest[-2], rest[-1]
        else:
            h = c = xv.new_zeros(B, whv.shape[0])
        hs, cs = [None] * T, [None] * T
        for t in (range(T - 1, -1, -1) if is_reverse else range(T)):
            h, c = lstm_gate(xs[:, t] + h @ whv, c)
            hs[t], cs[t] = h, c
        return torch.stack(hs, 1), torch.stack(cs, 1)

    return forward_op("fusion_lstm", impl, args)


def multi_gru(x, wx_list, wh_list, bias_list=None, layers: int = None,
              name=None):
    """Stacked bidirectional GRU (ref: multi_gru_op): each layer runs a
    forward and a reverse fusion_gru and concatenates."""
    from ...ops.manipulation import concat
    n = layers if layers is not None else len(wx_list) // 2
    out = x
    for l in range(n):
        fwd = fusion_gru(out, wx_list[2 * l], wh_list[2 * l],
                         bias_list[2 * l] if bias_list else None)
        bwd = fusion_gru(out, wx_list[2 * l + 1], wh_list[2 * l + 1],
                         bias_list[2 * l + 1] if bias_list else None,
                         is_reverse=True)
        out = concat([fwd, bwd], axis=-1)
    return out


def _register():
    from ...core.dispatch import register_op
    for _n in __all__:
        _f = globals()[_n]
        register_op(_n, _f, (_f.__doc__ or "").strip().split("\n")[0],
                    category="fused", public=_f)


_register()


def gru_unit(input, hidden, weight, bias=None, activation="tanh",  # noqa: A002
             gate_activation="sigmoid", origin_mode: bool = False,
             name=None):
    """Single GRU cell step (ref: gru_unit_op): ``input [B, 3H]`` (already
    projected), ``hidden [B, H]``, ``weight [H, 3H]``. Returns the new
    hidden state."""
    args = [ensure_tensor(input), ensure_tensor(hidden), ensure_tensor(weight)]
    if bias is not None:
        args.append(ensure_tensor(bias))

    def impl(xg, h, w, *b):
        if b:
            xg = xg + b[0]
        return _gru_gate(xg, h @ w, h, origin_mode)

    return forward_op("gru_unit", impl, args)


def lstm_unit(x, pre_cell, forget_bias: float = 0.0, name=None):
    """Single LSTM cell step over pre-projected gates (ref: lstm_unit_op):
    ``x [B, 4H]`` fused i/f/c/o gates, ``pre_cell [B, H]``. Returns
    ``(hidden, cell)``."""
    return forward_op("lstm_unit", lambda g, c: lstm_gate(g, c, forget_bias),
                      [ensure_tensor(x), ensure_tensor(pre_cell)])


__all__ += ["gru_unit", "lstm_unit"]

"""Recurrent layers — counterpart of ``paddle_tpu/nn/layers/rnn.py``
(python/paddle/nn/layer/rnn.py in Paddle): ``SimpleRNN`` / ``LSTM`` /
``GRU`` and their cells, the ``RNN`` wrapper and ``BiRNN``.

The reference's parameter names (``weight_ih_l{i}[_reverse]``, ...),
shapes (``[gates * hidden, in]``) and gate orders: LSTM (i, f, g, o), GRU
(z, r, n) — torch's and cuDNN's GRU order is (r, z, n), so these layers
do not go through cuDNN. The reference compiles the time loop as one
``lax.scan`` per layer and direction; here a layer is one input GEMM over
every step (``[T, B, I] @ W_ih^T``) and then a loop over the T steps on
the device, both directions of a layer in one batched GEMM a step
(``baddbmm`` over ``[D, B, H] x [D, H, G]``), the cell's formula in
elementwise ops. Inside ``jit.make_train_step`` the whole loop is one
captured CUDA graph, so the per-step launches cost no host dispatch.

``sequence_length`` follows Paddle's semantics: the steps past a row's
length leave its state unchanged and output zeros, and the reverse
direction runs over each row's own steps reversed. The reference accepts
the argument and ignores it (ROADMAP §C). Dropout between layers draws
its masks from the port's generator, not ``jax.random``.
"""

from __future__ import annotations

import math

import torch

from ...ops._helpers import ensure_tensor, forward_op
from .. import initializer as I
from ..functional.fused_rnn import lstm_gate
from ..layer import Layer

_GATES = {"LSTM": 4, "GRU": 3}


def _cell_params(layer: Layer, input_size: int, hidden_size: int, gates: int,
                 suffix: str = ""):
    std = 1.0 / math.sqrt(hidden_size)
    u = I.Uniform(-std, std)
    wi = layer.create_parameter([gates * hidden_size, input_size],
                                default_initializer=u)
    wh = layer.create_parameter([gates * hidden_size, hidden_size],
                                default_initializer=u)
    bi = layer.create_parameter([gates * hidden_size], is_bias=True,
                                default_initializer=u)
    bh = layer.create_parameter([gates * hidden_size], is_bias=True,
                                default_initializer=u)
    layer.add_parameter(f"weight_ih{suffix}", wi)
    layer.add_parameter(f"weight_hh{suffix}", wh)
    layer.add_parameter(f"bias_ih{suffix}", bi)
    layer.add_parameter(f"bias_hh{suffix}", bh)
    return wi, wh, bi, bh


def _cell(mode, xg, hg, state):
    """One step of ``mode``'s formula from the input part ``xg`` (x W_ih^T
    + b_ih) and the hidden part ``hg`` (h W_hh^T + b_hh); ``state`` is h,
    or (h, c) for the LSTM. Returns the new state."""
    if mode == "LSTM":
        return lstm_gate(xg + hg, state[1])
    if mode == "GRU":
        H = state.shape[-1]
        zr = torch.sigmoid(xg[..., :2 * H] + hg[..., :2 * H])
        z, r = zr[..., :H], zr[..., H:]
        n = torch.tanh(xg[..., 2 * H:] + r * hg[..., 2 * H:])
        return (1 - z) * n + z * state
    act = torch.relu if mode == "RNN_RELU" else torch.tanh
    return act(xg + hg)


def _step(mode, x, state, wi, wh, bi, bh):
    """A cell's step on ``x [B, I]`` (the reference's ``_*_step``)."""
    h = state[0] if mode == "LSTM" else state
    return _cell(mode, torch.addmm(bi, x, wi.t()), torch.addmm(bh, h, wh.t()),
                 state)


def _reverse_index(lens, T):
    """[T, B] source step of each row's own steps reversed: ``len - 1 - t``
    for t < len, t past it."""
    t = torch.arange(T, device=lens.device)[:, None]
    n = lens.to(torch.long)[None, :]
    return torch.where(t < n, n - 1 - t, t)


def _take_steps(v, idx):
    """``v [T, B, ...]`` at step ``idx [T, B]`` per row."""
    shape = idx.shape + (1,) * (v.dim() - 2)
    return torch.gather(v, 0, idx.reshape(shape).expand_as(v))


def run_layer(mode, x, weights, init, lens=None):
    """One layer over ``x [T, B, I]`` in D directions at once. ``weights``:
    D tuples (W_ih, W_hh, b_ih, b_hh), direction 1 the reverse; ``init``:
    [D, B, H] (a pair for the LSTM). Returns (outputs [D, T, B, H], final
    state [D, B, H] (a pair for the LSTM)); ``lens [B]`` masks the steps
    past each row's length."""
    T = x.shape[0]
    D = len(weights)
    xs = torch.stack([torch.addmm(bi, x.reshape(-1, x.shape[-1]), wi.t())
                      .reshape(T, x.shape[1], -1)
                      for wi, _, bi, _ in weights])               # [D,T,B,G]
    rev = None
    if D == 2:
        if lens is None:
            xs = torch.stack([xs[0], xs[1].flip(0)])
        else:
            rev = _reverse_index(lens, T)
            xs = torch.stack([xs[0], _take_steps(xs[1], rev)])
    wh = torch.stack([w[1].t() for w in weights])                 # [D,H,G]
    bh = torch.stack([w[3] for w in weights])[:, None]            # [D,1,G]
    state = init
    outs = []
    for t in range(T):
        h = state[0] if mode == "LSTM" else state
        new = _cell(mode, xs[:, t], torch.baddbmm(bh, h, wh), state)
        if lens is not None:
            live = (t < lens)[None, :, None]
            if mode == "LSTM":
                new = (torch.where(live, new[0], state[0]),
                       torch.where(live, new[1], state[1]))
            else:
                new = torch.where(live, new, state)
            h_out = torch.where(live, new[0] if mode == "LSTM" else new,
                                torch.zeros((), dtype=h.dtype,
                                            device=h.device))
        else:
            h_out = new[0] if mode == "LSTM" else new
        state = new
        outs.append(h_out)
    out = torch.stack(outs, 1)                                    # [D,T,B,H]
    if D == 2:
        back = out[1].flip(0) if rev is None else _take_steps(out[1], rev)
        out = torch.stack([out[0], back])
    return out, state


class SimpleRNNCell(Layer):
    def __init__(self, input_size, hidden_size, activation="tanh",
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None):
        super().__init__()
        self.hidden_size = hidden_size
        self.activation = activation
        _cell_params(self, input_size, hidden_size, 1)

    def forward(self, inputs, states=None):
        inputs = ensure_tensor(inputs)
        mode = "RNN_RELU" if self.activation == "relu" else "RNN_TANH"
        args = [inputs, self.weight_ih, self.weight_hh, self.bias_ih,
                self.bias_hh] + ([ensure_tensor(states)] if states is not None
                                 else [])

        def impl(x, wi, wh, bi, bh, *h):
            h = h[0] if h else x.new_zeros(x.shape[0], self.hidden_size)
            return _step(mode, x, h, wi, wh, bi, bh)

        out = forward_op("simple_rnn_cell", impl, args)
        return out, out


class LSTMCell(Layer):
    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None):
        super().__init__()
        self.hidden_size = hidden_size
        _cell_params(self, input_size, hidden_size, 4)

    def forward(self, inputs, states=None):
        inputs = ensure_tensor(inputs)
        st = [] if states is None else [ensure_tensor(s) for s in states]

        def impl(x, wi, wh, bi, bh, *hc):
            if not hc:
                z = x.new_zeros(x.shape[0], self.hidden_size)
                hc = (z, z)
            return _step("LSTM", x, tuple(hc), wi, wh, bi, bh)

        h2, c2 = forward_op("lstm_cell", impl,
                            [inputs, self.weight_ih, self.weight_hh,
                             self.bias_ih, self.bias_hh] + st)
        return h2, (h2, c2)


class GRUCell(Layer):
    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None):
        super().__init__()
        self.hidden_size = hidden_size
        _cell_params(self, input_size, hidden_size, 3)

    def forward(self, inputs, states=None):
        inputs = ensure_tensor(inputs)
        args = [inputs, self.weight_ih, self.weight_hh, self.bias_ih,
                self.bias_hh] + ([ensure_tensor(states)] if states is not None
                                 else [])

        def impl(x, wi, wh, bi, bh, *h):
            h = h[0] if h else x.new_zeros(x.shape[0], self.hidden_size)
            return _step("GRU", x, h, wi, wh, bi, bh)

        out = forward_op("gru_cell", impl, args)
        return out, out


class _RNNBase(Layer):
    """Multi-layer (bi)directional recurrence: per layer one input GEMM and
    a T-step loop over both directions (see the module note)."""

    MODE = None  # "RNN_TANH" | "RNN_RELU" | "LSTM" | "GRU"

    def __init__(self, input_size, hidden_size, num_layers=1, direction="forward",
                 time_major=False, dropout=0.0, activation="tanh",
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None):
        super().__init__()
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.time_major = time_major
        self.dropout = dropout
        self.activation = activation
        self.bidirect = direction in ("bidirect", "bidirectional")
        self.num_directions = 2 if self.bidirect else 1
        gates = _GATES.get(self.MODE, 1)
        self._param_names = []
        for layer_i in range(num_layers):
            for d in range(self.num_directions):
                in_sz = input_size if layer_i == 0 else \
                    hidden_size * self.num_directions
                sfx = f"_l{layer_i}" + ("_reverse" if d else "")
                _cell_params(self, in_sz, hidden_size, gates, sfx)
                self._param_names.append(sfx)

    def forward(self, inputs, initial_states=None, sequence_length=None):
        inputs = ensure_tensor(inputs)
        mode = self.MODE
        is_lstm = mode == "LSTM"
        L, D, H = self.num_layers, self.num_directions, self.hidden_size
        v0 = inputs._value
        T, B = (v0.shape[0], v0.shape[1]) if self.time_major else \
            (v0.shape[1], v0.shape[0])
        params = []
        for sfx in self._param_names:
            params += [getattr(self, "weight_ih" + sfx),
                       getattr(self, "weight_hh" + sfx),
                       getattr(self, "bias_ih" + sfx),
                       getattr(self, "bias_hh" + sfx)]
        p = self.dropout if self.training else 0.0
        keeps = []
        if p > 0 and L > 1:
            from ..functional.common import _keep_mask
            keeps = [_keep_mask(v0, p, (T, B, D * H)) for _ in range(L - 1)]
        if initial_states is None:
            states = []
        elif is_lstm:
            states = [ensure_tensor(s) for s in initial_states]
        else:
            states = [ensure_tensor(initial_states)]
        lens = [] if sequence_length is None else [ensure_tensor(
            sequence_length)]
        n_st, n_len = len(states), len(lens)
        time_major = self.time_major

        def impl(x, *flat):
            st, ln, pv = flat[:n_st], flat[n_st:n_st + n_len], \
                flat[n_st + n_len:]
            lv = ln[0] if ln else None
            if not st:
                z = x.new_zeros(L * D, B, H)
                st = (z, z) if is_lstm else (z,)
            if not time_major:
                x = x.transpose(0, 1)                          # [T, B, I]
            layer_in = x
            last = []
            for li in range(L):
                ws = [tuple(pv[(li * D + d) * 4:(li * D + d) * 4 + 4])
                      for d in range(D)]
                sl = slice(li * D, li * D + D)
                init = (st[0][sl], st[1][sl]) if is_lstm else st[0][sl]
                out, final = run_layer(mode, layer_in, ws, init, lv)
                last.append(final)
                layer_in = torch.cat(out.unbind(0), -1) if D == 2 else out[0]
                if li < L - 1 and keeps:
                    layer_in = torch.where(
                        keeps[li], layer_in / (1 - p),
                        torch.zeros((), dtype=layer_in.dtype,
                                    device=layer_in.device))
            out = layer_in if time_major else layer_in.transpose(0, 1)
            if is_lstm:
                return (out, torch.cat([f[0] for f in last]),
                        torch.cat([f[1] for f in last]))
            return out, torch.cat(last)

        res = forward_op(f"rnn_{mode}", impl, [inputs] + states + lens + params)
        if is_lstm:
            out, h, c = res
            return out, (h, c)
        return res


class SimpleRNN(_RNNBase):
    MODE = "RNN_TANH"

    def __init__(self, input_size, hidden_size, num_layers=1, direction="forward",
                 time_major=False, dropout=0.0, activation="tanh", **kwargs):
        if activation == "relu":
            self.MODE = "RNN_RELU"
        super().__init__(input_size, hidden_size, num_layers, direction, time_major,
                         dropout, activation, **kwargs)


class LSTM(_RNNBase):
    MODE = "LSTM"


class GRU(_RNNBase):
    MODE = "GRU"


def _mask_state(new, old, live):
    """``new`` where ``live [B, 1]``, else ``old`` (zeros where None)."""
    if isinstance(new, (tuple, list)):
        olds = old if old is not None else [None] * len(new)
        return type(new)(_mask_state(n, o, live) for n, o in zip(new, olds))
    if old is None:
        return forward_op("step_mask", lambda n, m: torch.where(
            m, n, torch.zeros((), dtype=n.dtype, device=n.device)),
            [new, live])
    return forward_op("step_mask", lambda n, o, m: torch.where(m, n, o),
                      [new, ensure_tensor(old), live])


class RNN(Layer):
    """Wrapper running a cell over time (ref: paddle.nn.RNN). With
    ``sequence_length`` a row's state stops at its length, its later
    outputs are zeros, and ``is_reverse`` runs each row's own steps
    backwards."""

    def __init__(self, cell, is_reverse=False, time_major=False):
        super().__init__()
        self.cell = cell
        self.is_reverse = is_reverse
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None, **kwargs):
        from ...ops.manipulation import stack, unbind
        inputs = ensure_tensor(inputs)
        axis = 0 if self.time_major else 1
        T = inputs.shape[axis]
        lens = None if sequence_length is None else ensure_tensor(
            sequence_length)
        if lens is not None and self.is_reverse:
            # each row's own steps reversed, as a gather on time
            def rev(v, n):
                tm = v if self.time_major else v.transpose(0, 1)
                out = _take_steps(tm, _reverse_index(n, tm.shape[0]))
                return out if self.time_major else out.transpose(0, 1)
            inputs = forward_op("reverse_sequence", rev, [inputs, lens])
        steps = unbind(inputs, axis)
        order = range(T)
        if self.is_reverse and lens is None:
            order = reversed(order)
        outs = [None] * T
        states = initial_states
        for t in order:
            out, new = self.cell(steps[t], states)
            if lens is not None:
                live = forward_op("step_live", lambda n: (t < n)[:, None],
                                  [lens], differentiable=False)
                new = _mask_state(new, states, live)
                out = _mask_state(out, None, live)
            states = new
            outs[t] = out
        out = stack(outs, axis)
        if lens is not None and self.is_reverse:
            out = forward_op("reverse_sequence", rev, [out, lens])
        return out, states


class BiRNN(Layer):
    def __init__(self, cell_fw, cell_bw, time_major=False):
        super().__init__()
        self.rnn_fw = RNN(cell_fw, False, time_major)
        self.rnn_bw = RNN(cell_bw, True, time_major)

    def forward(self, inputs, initial_states=None, sequence_length=None):
        from ...ops.manipulation import concat
        st_fw, st_bw = (initial_states if initial_states is not None
                        else (None, None))
        out_fw, s_fw = self.rnn_fw(inputs, st_fw, sequence_length)
        out_bw, s_bw = self.rnn_bw(inputs, st_bw, sequence_length)
        return concat([out_fw, out_bw], axis=-1), (s_fw, s_bw)

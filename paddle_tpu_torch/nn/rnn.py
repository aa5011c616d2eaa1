"""Recurrent layers: counterpart of paddle_tpu/nn/rnn.py
(python/paddle/nn/layer/rnn.py: SimpleRNNCell, LSTMCell, GRUCell, the RNN
wrapper, SimpleRNN, LSTM and GRU).

JAX runs the recurrence as a `lax.scan` inside one dispatched op (XLA, no
Pallas kernel); the port runs a plain torch loop over time inside one
dispatched op under the same name (`LSTMCell`, `rnn_scan`,
`stacked_rnn`), and autograd gives the backward.

As in JAX:
- the weight layout: weight_ih `[G*hidden, input]`, weight_hh
  `[G*hidden, hidden]`, bias_ih/bias_hh `[G*hidden]`, gate order i, f, c,
  o for LSTM and r, z, c for GRU; each drawn U(-1/sqrt(hidden),
  1/sqrt(hidden)) from the key chain, in that order (the `*_attr`
  arguments are accepted and unused, as in JAX);
- `sequence_length`: steps past a sequence's length carry the state
  through and emit zeros, so the final state is the state at the length;
- `direction="bidirect"` (or "bidirectional") concatenates the forward and
  the reversed pass; `time_major` takes `[T, B, ...]`;
- the stacked layers' initial and final states are `[layers * dirs, B,
  hidden]` (a pair for LSTM), and `dropout` between layers draws one key
  a forward and folds in the layer index.

The port's own keyword `device` comes last and keyword-only.
"""
from __future__ import annotations

import math

import torch

from ..core.random import _fold, next_key
from ..core.tensor import Parameter, Tensor
from ..ops import threefry
from ..ops.dispatch import apply, as_tensor
from ..ops.nn_ops import _keep_mask
from .layer import Layer

__all__ = ["SimpleRNNCell", "LSTMCell", "GRUCell", "RNN",
           "SimpleRNN", "LSTM", "GRU"]


def _uniform(shape, k, device):
    return threefry.uniform_shaped(next_key(), shape, torch.float32, -k, k,
                                   device)


def _flat(states):
    return list(states) if isinstance(states, (tuple, list)) else [states]


def _simple_step(wih, whh, bih, bhh, x, h, activation="tanh"):
    z = x @ wih.T + bih + h @ whh.T + bhh
    out = torch.tanh(z) if activation == "tanh" else torch.relu(z)
    return out, out


def _lstm_step(wih, whh, bih, bhh, x, state):
    h, c = state
    gates = x @ wih.T + bih + h @ whh.T + bhh
    i, f, g, o = torch.chunk(gates, 4, dim=-1)
    i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
    g = torch.tanh(g)
    c2 = f * c + i * g
    h2 = o * torch.tanh(c2)
    return h2, (h2, c2)


def _gru_step(wih, whh, bih, bhh, x, h):
    xg = x @ wih.T + bih
    hg = h @ whh.T + bhh
    xr, xz, xc = torch.chunk(xg, 3, dim=-1)
    hr, hz, hc = torch.chunk(hg, 3, dim=-1)
    r = torch.sigmoid(xr + hr)
    z = torch.sigmoid(xz + hz)
    c = torch.tanh(xc + r * hc)  # paddle applies r to the hidden term
    h2 = (1.0 - z) * c + z * h
    return h2, h2


class _CellBase(Layer):
    """Parameters and the step function shared by a cell's own forward
    (one step) and the RNN loops."""

    GATES = 1
    LSTM = False

    def __init__(self, input_size, hidden_size, device=None):
        super().__init__()
        self._place = device
        self.input_size = input_size
        self.hidden_size = hidden_size
        g = self.GATES
        k = 1.0 / math.sqrt(hidden_size)
        dev = self._device()
        self.weight_ih = Parameter(_uniform((g * hidden_size, input_size), k,
                                            dev))
        self.weight_hh = Parameter(_uniform((g * hidden_size, hidden_size),
                                            k, dev))
        self.bias_ih = Parameter(_uniform((g * hidden_size,), k, dev))
        self.bias_hh = Parameter(_uniform((g * hidden_size,), k, dev))

    def _params(self):
        return [self.weight_ih, self.weight_hh, self.bias_ih, self.bias_hh]

    def step_fn(self):
        """The step `(wih, whh, bih, bhh, x, state) -> (out, state)`."""
        raise NotImplementedError

    def forward(self, inputs, states=None):
        x = as_tensor(inputs)
        lstm = self.LSTM
        if states is None:
            z = Tensor(torch.zeros(x.shape[0], self.hidden_size,
                                   dtype=x.dtype, device=x.device))
            states = (z, z) if lstm else z
        st = [as_tensor(s) for s in _flat(states)]
        step = self.step_fn()

        def fn(xa, wih, whh, bih, bhh, *flat):
            out, new = step(wih, whh, bih, bhh, xa,
                            tuple(flat) if lstm else flat[0])
            return (out, *_flat(new))

        outs = apply(type(self).__name__, fn, x, *self._params(), *st)
        out, new = outs[0], outs[1:]
        return out, (tuple(new) if lstm else new[0])


class SimpleRNNCell(_CellBase):
    GATES = 1

    def __init__(self, input_size, hidden_size, activation="tanh",
                 weight_ih_attr=None, weight_hh_attr=None,
                 bias_ih_attr=None, bias_hh_attr=None, name=None, *,
                 device=None):
        super().__init__(input_size, hidden_size, device)
        if activation not in ("tanh", "relu"):
            raise ValueError("activation must be tanh or relu")
        self.activation = activation

    def step_fn(self):
        act = self.activation
        return (lambda wih, whh, bih, bhh, x, st:
                _simple_step(wih, whh, bih, bhh, x, st, act))


class LSTMCell(_CellBase):
    GATES = 4  # gate order i, f, c, o (paddle rnn.py parity)
    LSTM = True

    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None, *, device=None):
        super().__init__(input_size, hidden_size, device)

    def step_fn(self):
        return _lstm_step


class GRUCell(_CellBase):
    GATES = 3  # gate order r, z, c (paddle rnn.py parity)

    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None, *, device=None):
        super().__init__(input_size, hidden_size, device)

    def step_fn(self):
        return _gru_step


def _run_layer(step, wih, whh, bih, bhh, x_tbi, st0, reverse, lstm,
               seq_len=None):
    """One direction of one layer over time-major `[T, B, I]`: outputs
    `[T, B, H]` and the final state. Past `seq_len` a step carries the
    previous state and emits zeros."""
    T = x_tbi.shape[0]
    st = st0
    outs = [None] * T
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        out, new = step(wih, whh, bih, bhh, x_tbi[t], st)
        if seq_len is not None:
            valid = (t < seq_len)[:, None]
            if lstm:
                new = tuple(torch.where(valid, n, o)
                            for n, o in zip(new, st))
            else:
                new = torch.where(valid, new, st)
            out = torch.where(valid, out, torch.zeros_like(out))
        st = new
        outs[t] = out
    return torch.stack(outs), st


def _seq_len(sequence_length, device):
    if sequence_length is None:
        return None
    s = sequence_length
    s = s.detach() if isinstance(s, torch.Tensor) else torch.as_tensor(s)
    return s.as_subclass(torch.Tensor).to(device)


class RNN(Layer):
    """Runs any cell over a sequence (rnn.py RNN parity)."""

    def __init__(self, cell, is_reverse=False, time_major=False):
        super().__init__()
        self.cell = cell
        self.is_reverse = is_reverse
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None):
        x = as_tensor(inputs)
        cell = self.cell
        tm = self.time_major
        lstm = cell.LSTM
        B = x.shape[1] if tm else x.shape[0]
        if initial_states is None:
            z = Tensor(torch.zeros(B, cell.hidden_size, dtype=x.dtype,
                                   device=x.device))
            initial_states = (z, z) if lstm else z
        st = [as_tensor(s) for s in _flat(initial_states)]
        seq = _seq_len(sequence_length, x.device)
        step = cell.step_fn()
        reverse = self.is_reverse

        def fn(xa, wih, whh, bih, bhh, *flat):
            x_tbi = xa if tm else xa.transpose(0, 1)
            outs, final = _run_layer(step, wih, whh, bih, bhh, x_tbi,
                                     tuple(flat) if lstm else flat[0],
                                     reverse, lstm, seq)
            if not tm:
                outs = outs.transpose(0, 1)
            return (outs, *_flat(final))

        res = apply("rnn_scan", fn, x, *cell._params(), *st)
        outs, final = res[0], res[1:]
        return outs, (tuple(final) if lstm else final[0])


class _StackedRNN(Layer):
    """Shared engine for SimpleRNN/LSTM/GRU: `num_layers` stacked, each
    forward or bidirectional (concatenated), the whole one dispatched
    op."""

    CELL = None

    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 activation=None, device=None, **kwargs):
        super().__init__()
        if direction not in ("forward", "bidirect", "bidirectional"):
            raise ValueError(f"bad direction {direction!r}")
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.bidirect = direction != "forward"
        self.time_major = time_major
        self.dropout = float(dropout)
        self.activation = activation
        ndir = 2 if self.bidirect else 1
        self._cells = []
        for layer in range(num_layers):
            in_sz = input_size if layer == 0 else hidden_size * ndir
            for d in range(ndir):
                if activation is not None and self.CELL is SimpleRNNCell:
                    cell = self.CELL(in_sz, hidden_size, activation,
                                     device=device)
                else:
                    cell = self.CELL(in_sz, hidden_size, device=device)
                setattr(self, f"cell_{layer}_{d}", cell)
                self._cells.append(cell)

    @property
    def state_components(self):
        return 2 if self.CELL is LSTMCell else 1

    def forward(self, inputs, initial_states=None, sequence_length=None):
        x = as_tensor(inputs)
        ndir = 2 if self.bidirect else 1
        L = self.num_layers
        tm = self.time_major
        B = x.shape[1] if tm else x.shape[0]
        ncomp = self.state_components
        lstm = self.CELL is LSTMCell

        # initial states: [L*ndir, B, H] per component (paddle layout),
        # op inputs so that a learnable h0 receives gradients
        if initial_states is None:
            z = Tensor(torch.zeros(L * ndir, B, self.hidden_size,
                                   dtype=x.dtype, device=x.device))
            init = [z] * ncomp
        else:
            init = [as_tensor(i) for i in _flat(initial_states)]
        seq = _seq_len(sequence_length, x.device)
        step = self._cells[0].step_fn()
        drop = self.dropout if self.training else 0.0
        params = []
        for c in self._cells:
            params.extend(c._params())
        nw = len(params)
        base_key = next_key() if drop > 0 else None

        def fn(xa, *args):
            weights, st0 = args[:nw], args[nw:]
            h = xa if tm else xa.transpose(0, 1)
            finals = []
            for layer in range(L):
                outs_dirs = []
                for d in range(ndir):
                    ci = layer * ndir + d
                    wih, whh, bih, bhh = weights[ci * 4:ci * 4 + 4]
                    s0 = (st0[0][ci], st0[1][ci]) if lstm else st0[0][ci]
                    outs, fin = _run_layer(step, wih, whh, bih, bhh, h, s0,
                                           d == 1, lstm, seq)
                    outs_dirs.append(outs)
                    finals.append(fin)
                h = torch.cat(outs_dirs, -1) if ndir == 2 else outs_dirs[0]
                if drop > 0 and layer < L - 1:
                    keep = _keep_mask(_fold(base_key, layer), 1 - drop,
                                      h.shape, h.device)
                    h = torch.where(keep, h / (1 - drop),
                                    torch.zeros((), dtype=h.dtype,
                                                device=h.device))
            out = h if tm else h.transpose(0, 1)
            if lstm:
                return (out, torch.stack([f[0] for f in finals]),
                        torch.stack([f[1] for f in finals]))
            return out, torch.stack(finals)

        res = apply("stacked_rnn", fn, x, *params, *init)
        if lstm:
            return res[0], (res[1], res[2])
        return res[0], res[1]


class SimpleRNN(_StackedRNN):
    CELL = SimpleRNNCell

    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 activation="tanh", *, device=None, **kwargs):
        super().__init__(input_size, hidden_size, num_layers, direction,
                         time_major, dropout, activation=activation,
                         device=device)


class LSTM(_StackedRNN):
    CELL = LSTMCell

    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 activation=None, *, device=None, **kwargs):
        super().__init__(input_size, hidden_size, num_layers, direction,
                         time_major, dropout, activation, device=device)


class GRU(_StackedRNN):
    CELL = GRUCell

    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 activation=None, *, device=None, **kwargs):
        super().__init__(input_size, hidden_size, num_layers, direction,
                         time_major, dropout, activation, device=device)

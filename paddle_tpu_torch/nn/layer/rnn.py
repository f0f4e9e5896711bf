"""Recurrent layers (paddle_tpu/nn/layer/rnn.py): the cells, the
multi-layer ``SimpleRNN`` / ``LSTM`` / ``GRU``, and the cell-driven ``RNN``
and ``BiRNN``.

The three scans are registry ops under the JAX names ``rnn_scan_tanh``,
``lstm_scan`` and ``gru_scan``. Each forms the input product of every
step at once (``x @ wiᵀ + bi``, one GEMM), then runs the time loop of
``h @ whᵀ + bh`` and the gates in the JAX order (LSTM i, f, g, o; GRU r,
z, n with ``r * hn`` after ``bh``). A step whose row is masked out (past
its ``sequence_length``) keeps that row's old state AND emits it as its
output, as the JAX scan does; cuDNN's packed sequences emit zeros there,
so ``torch.nn.LSTM`` is not a counterpart. No JAX scan reaches a Pallas
kernel: these are plain torch.
"""
from __future__ import annotations

import numpy as np
import torch

from ... import ops
from ...ops._dispatch import defop, wrap
from .. import functional as F
from .. import initializer as I
from .layers import Layer

__all__ = ["SimpleRNNCell", "LSTMCell", "GRUCell", "RNN", "SimpleRNN",
           "LSTM", "GRU", "BiRNN", "RNNCellBase"]


# -- the scans ----------------------------------------------------------------

def _scan(x, wi, bi, mask, h0, step):
    """The input product of every step, then ``step(xg_t, state)`` over
    time; a masked row keeps and emits its old state. Returns
    (outputs [b, t, H], final state)."""
    xg = torch.matmul(x, wi.t()) + bi                  # [b, t, G]
    state, outs = h0, []
    for t in range(x.shape[1]):
        new = step(xg[:, t], state)
        m = mask[:, t, None]
        if isinstance(state, tuple):
            state = tuple(torch.where(m, n, o) for n, o in zip(new, state))
            outs.append(state[0])
        else:
            state = torch.where(m, new, state)
            outs.append(state)
    return torch.stack(outs, dim=1), state


@defop
def _rnn_scan_tanh(x, h0, wi, wh, bi, bh, mask):
    def step(xg, h):
        return torch.tanh(xg + torch.matmul(h, wh.t()) + bh)
    return _scan(x, wi, bi, mask, h0, step)


@defop
def _lstm_scan(x, h0, c0, wi, wh, bi, bh, mask):
    def step(xg, hc):
        h, c = hc
        i, f, g, o = torch.chunk(xg + torch.matmul(h, wh.t()) + bh, 4,
                                 dim=-1)
        nc = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        return torch.sigmoid(o) * torch.tanh(nc), nc
    out, (hT, cT) = _scan(x, wi, bi, mask, (h0, c0), step)
    return out, hT, cT


@defop
def _gru_scan(x, h0, wi, wh, bi, bh, mask):
    def step(xg, h):
        xr, xz, xn = torch.chunk(xg, 3, dim=-1)
        hr, hz, hn = torch.chunk(torch.matmul(h, wh.t()) + bh, 3, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        return (1.0 - z) * n + z * h
    return _scan(x, wi, bi, mask, h0, step)


# -- cells --------------------------------------------------------------------

class RNNCellBase(Layer):
    def _init_weights(self, input_size, hidden_size, gates, weight_ih_attr,
                      weight_hh_attr, bias_ih_attr, bias_hh_attr):
        std = 1.0 / np.sqrt(hidden_size)
        u = I.Uniform(-std, std)
        self.weight_ih = self.create_parameter(
            [gates * hidden_size, input_size], attr=weight_ih_attr,
            default_initializer=u)
        self.weight_hh = self.create_parameter(
            [gates * hidden_size, hidden_size], attr=weight_hh_attr,
            default_initializer=u)
        self.bias_ih = self.create_parameter(
            [gates * hidden_size], attr=bias_ih_attr, is_bias=True,
            default_initializer=u)
        self.bias_hh = self.create_parameter(
            [gates * hidden_size], attr=bias_hh_attr, is_bias=True,
            default_initializer=u)
        self.hidden_size = hidden_size
        self.input_size = input_size

    def get_initial_states(self, batch_size, dtype="float32"):
        return ops.zeros([batch_size, self.hidden_size], dtype)

    def _gates(self, inputs, h):
        return (ops.matmul(inputs, self.weight_ih, transpose_y=True)
                + ops.matmul(h, self.weight_hh, transpose_y=True)
                + self.bias_ih + self.bias_hh)


class SimpleRNNCell(RNNCellBase):
    def __init__(self, input_size, hidden_size, activation="tanh",
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None):
        super().__init__()
        self.activation = activation
        self._init_weights(input_size, hidden_size, 1, weight_ih_attr,
                           weight_hh_attr, bias_ih_attr, bias_hh_attr)

    def forward(self, inputs, states=None):
        h = states if states is not None \
            else self.get_initial_states(inputs.shape[0])
        z = self._gates(inputs, h)
        nh = ops.tanh(z) if self.activation == "tanh" else F.relu(z)
        return nh, nh


class LSTMCell(RNNCellBase):
    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None):
        super().__init__()
        self._init_weights(input_size, hidden_size, 4, weight_ih_attr,
                           weight_hh_attr, bias_ih_attr, bias_hh_attr)

    def forward(self, inputs, states=None):
        if states is None:
            b = inputs.shape[0]
            states = (self.get_initial_states(b), self.get_initial_states(b))
        h, c = states
        i, f, g, o = ops.split(self._gates(inputs, h), 4, axis=-1)
        i, f, o = F.sigmoid(i), F.sigmoid(f), F.sigmoid(o)
        nc = f * c + i * ops.tanh(g)
        nh = o * ops.tanh(nc)
        return nh, (nh, nc)


class GRUCell(RNNCellBase):
    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None):
        super().__init__()
        self._init_weights(input_size, hidden_size, 3, weight_ih_attr,
                           weight_hh_attr, bias_ih_attr, bias_hh_attr)

    def forward(self, inputs, states=None):
        h = states if states is not None \
            else self.get_initial_states(inputs.shape[0])
        xg = ops.matmul(inputs, self.weight_ih, transpose_y=True) \
            + self.bias_ih
        hg = ops.matmul(h, self.weight_hh, transpose_y=True) + self.bias_hh
        xr, xz, xn = ops.split(xg, 3, axis=-1)
        hr, hz, hn = ops.split(hg, 3, axis=-1)
        r = F.sigmoid(xr + hr)
        z = F.sigmoid(xz + hz)
        n = ops.tanh(xn + r * hn)
        nh = (1.0 - z) * n + z * h
        return nh, nh


# -- multi-layer wrappers -----------------------------------------------------

class _RNNBase(Layer):
    """Stacked (optionally bidirectional) recurrence over the scan ops.
    Parameters ``weight_ih_l{k}[_reverse]`` etc., as the JAX layer names
    them; a reverse direction runs the scan over the flipped sequence and
    its mask."""

    MODE = None  # "RNN_TANH" | "LSTM" | "GRU"

    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 activation="tanh", weight_ih_attr=None, weight_hh_attr=None,
                 bias_ih_attr=None, bias_hh_attr=None, name=None):
        super().__init__()
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.time_major = time_major
        self.dropout = dropout
        self.bidirect = direction in ("bidirect", "bidirectional")
        self.num_directions = 2 if self.bidirect else 1
        gates = {"RNN_TANH": 1, "LSTM": 4, "GRU": 3}[self.MODE]
        std = 1.0 / np.sqrt(hidden_size)
        u = I.Uniform(-std, std)
        for layer in range(num_layers):
            for d in range(self.num_directions):
                in_sz = input_size if layer == 0 \
                    else hidden_size * self.num_directions
                sfx = f"{layer}" + ("_reverse" if d else "")
                self.add_parameter(f"weight_ih_l{sfx}", self.create_parameter(
                    [gates * hidden_size, in_sz], default_initializer=u))
                self.add_parameter(f"weight_hh_l{sfx}", self.create_parameter(
                    [gates * hidden_size, hidden_size],
                    default_initializer=u))
                self.add_parameter(f"bias_ih_l{sfx}", self.create_parameter(
                    [gates * hidden_size], is_bias=True,
                    default_initializer=u))
                self.add_parameter(f"bias_hh_l{sfx}", self.create_parameter(
                    [gates * hidden_size], is_bias=True,
                    default_initializer=u))

    def _scan(self, x, init, wi, wh, bi, bh, mask):
        if self.MODE == "LSTM":
            out, hT, cT = _lstm_scan(x, init[0], init[1], wi, wh, bi, bh,
                                     mask)
            return out, (hT, cT)
        if self.MODE == "GRU":
            return _gru_scan(x, init, wi, wh, bi, bh, mask)
        return _rnn_scan_tanh(x, init, wi, wh, bi, bh, mask)

    def forward(self, inputs, initial_states=None, sequence_length=None):
        x = inputs
        if self.time_major:
            x = ops.transpose(x, [1, 0, 2])
        b, t = x.shape[0], x.shape[1]
        if sequence_length is not None:
            mask = F.sequence_mask(sequence_length, maxlen=t, dtype="bool")
        else:
            mask = wrap(torch.ones(b, t, dtype=torch.bool, device=x.device))

        def zeros():
            return wrap(torch.zeros(b, self.hidden_size, device=x.device))

        is_lstm = self.MODE == "LSTM"
        n_states = self.num_layers * self.num_directions
        if initial_states is None:
            init_h = [zeros() for _ in range(n_states)]
            init_c = [zeros() for _ in range(n_states)] if is_lstm else None
        elif is_lstm:
            init_h = ops.unbind(initial_states[0], 0)
            init_c = ops.unbind(initial_states[1], 0)
        else:
            init_h = ops.unbind(initial_states, 0)

        final_h, final_c = [], []
        out = x
        for layer in range(self.num_layers):
            outs = []
            for d in range(self.num_directions):
                sfx = f"{layer}" + ("_reverse" if d else "")
                wi = getattr(self, f"weight_ih_l{sfx}")
                wh = getattr(self, f"weight_hh_l{sfx}")
                bi = getattr(self, f"bias_ih_l{sfx}")
                bh = getattr(self, f"bias_hh_l{sfx}")
                idx = layer * self.num_directions + d
                seq = ops.flip(out, [1]) if d else out
                m = ops.flip(mask, [1]) if d else mask
                init = (init_h[idx], init_c[idx]) if is_lstm else init_h[idx]
                o, hT = self._scan(seq, init, wi, wh, bi, bh, m)
                if d:
                    o = ops.flip(o, [1])
                outs.append(o)
                if is_lstm:
                    final_h.append(hT[0])
                    final_c.append(hT[1])
                else:
                    final_h.append(hT)
            out = ops.concat(outs, axis=-1) if len(outs) > 1 else outs[0]
            if self.dropout > 0 and layer < self.num_layers - 1:
                out = F.dropout(out, p=self.dropout, training=self.training)

        if self.time_major:
            out = ops.transpose(out, [1, 0, 2])
        h_stack = ops.stack(final_h, axis=0)
        if is_lstm:
            return out, (h_stack, ops.stack(final_c, axis=0))
        return out, h_stack


class SimpleRNN(_RNNBase):
    MODE = "RNN_TANH"


class LSTM(_RNNBase):
    MODE = "LSTM"


class GRU(_RNNBase):
    MODE = "GRU"


def _masked_state(m, new, old):
    """Freeze state past each sequence's end (per-timestep select)."""
    if isinstance(new, (tuple, list)):
        return type(new)(_masked_state(m, n, o) for n, o in zip(new, old))
    return new * m + old * (1.0 - m)


class RNN(Layer):
    """Runs any cell over time, step by step. With ``sequence_length``
    (and a given initial state) a row past its end outputs zeros and
    keeps its state, as the JAX wrapper does."""

    def __init__(self, cell, is_reverse=False, time_major=False):
        super().__init__()
        self.cell = cell
        self.is_reverse = is_reverse
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None):
        x = inputs
        if self.time_major:
            x = ops.transpose(x, [1, 0, 2])
        t = x.shape[1]
        mask = None
        if sequence_length is not None:
            mask = F.sequence_mask(sequence_length, maxlen=t,
                                   dtype="float32")
        steps = range(t - 1, -1, -1) if self.is_reverse else range(t)
        state = initial_states
        outs = [None] * t
        for i in steps:
            o, new_state = self.cell(x[:, i], state)
            if mask is not None and state is not None:
                m = ops.unsqueeze(mask[:, i], -1)
                o = o * m  # zero outputs past each sequence's end
                new_state = _masked_state(m, new_state, state)
            outs[i] = o
            state = new_state
        out = ops.stack(outs, axis=1)
        if self.time_major:
            out = ops.transpose(out, [1, 0, 2])
        return out, state


class BiRNN(Layer):
    """A forward and a reverse ``RNN``, outputs concatenated on the last
    axis. As in the JAX layer, ``sequence_length`` is not passed to the
    two directions."""

    def __init__(self, cell_fw, cell_bw, time_major=False):
        super().__init__()
        self.fw = RNN(cell_fw, is_reverse=False, time_major=time_major)
        self.bw = RNN(cell_bw, is_reverse=True, time_major=time_major)

    def forward(self, inputs, initial_states=None, sequence_length=None):
        sf = sb = None
        if initial_states is not None:
            sf, sb = initial_states
        of, sf = self.fw(inputs, sf)
        ob, sb = self.bw(inputs, sb)
        return ops.concat([of, ob], axis=-1), (sf, sb)

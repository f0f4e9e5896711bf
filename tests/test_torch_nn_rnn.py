"""Port parity: the recurrent layers (paddle_tpu_torch/nn/layer/rnn.py)
against paddle_tpu's: SimpleRNN / LSTM / GRU (one and two layers, one
and two directions, batch- and time-major, with and without initial
states) on ragged ``sequence_length`` (a row past its end keeps its state
and emits it), the three cells, ``RNN`` over a cell and ``BiRNN``. The
outputs, the final states, and the gradients of the input and of every
weight within 1e-5 absolute plus 1e-4 relative (f32; t 6 steps of
recurrent products)."""
import numpy as np
import pytest
import torch

import paddle_tpu_torch as tp
import test_torch_nn_cases as C
from paddle_tpu_torch import device as tdevice


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _cpu():
    with tdevice.device_scope("cpu"):
        yield


B, T, IN, HID = 3, 6, 4, 5
X = C.f32(B, T, IN, seed=1)
LENS = np.array([6, 4, 1], np.int64)
TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("mode", ["SimpleRNN", "LSTM", "GRU"])
@pytest.mark.parametrize("layers, direction", [
    (1, "forward"), (2, "forward"), (1, "bidirect"), (2, "bidirectional")])
def test_multi_layer_rnn_matches_jax_on_ragged_rows(mode, layers,
                                                    direction):
    C.check(lambda pkg: getattr(pkg.nn, mode)(IN, HID, layers, direction),
            [X, None, LENS], **TOL)


@pytest.mark.parametrize("mode", ["SimpleRNN", "LSTM", "GRU"])
def test_time_major_with_initial_states(mode):
    h0 = C.f32(2, B, HID, seed=2, scale=0.5)
    init = (h0, C.f32(2, B, HID, seed=3, scale=0.5)) if mode == "LSTM" \
        else h0

    def make(pkg):
        net = getattr(pkg.nn, mode)(IN, HID, 1, "bidirect",
                                    time_major=True)
        state = tuple(pkg.to_tensor(s) for s in init) \
            if mode == "LSTM" else pkg.to_tensor(init)
        return _Bound(pkg, net, state)

    C.check(make, [np.ascontiguousarray(X.transpose(1, 0, 2)), LENS], **TOL)


def test_masked_rows_keep_and_emit_their_state():
    """Past its length a row's output repeats its last state (the JAX
    scan's carry), not zeros as cuDNN's packed sequences give."""
    net = tp.nn.GRU(IN, HID)
    out, h = net(tp.to_tensor(X), sequence_length=tp.to_tensor(LENS))
    out = out.detach().numpy()
    for row, n in enumerate(LENS):
        for t in range(n, T):
            np.testing.assert_array_equal(out[row, t], out[row, n - 1])
        np.testing.assert_array_equal(h.detach().numpy()[0, row],
                                      out[row, n - 1])


@pytest.mark.parametrize("cell, kw", [
    ("SimpleRNNCell", {}), ("SimpleRNNCell", {"activation": "relu"}),
    ("LSTMCell", {}), ("GRUCell", {})])
def test_cell_matches_jax(cell, kw):
    C.check(lambda pkg: getattr(pkg.nn, cell)(IN, HID, **kw),
            [X[:, 0]], **TOL)


@pytest.mark.parametrize("cell", ["SimpleRNNCell", "LSTMCell", "GRUCell"])
def test_rnn_wrapper_matches_jax(cell):
    h0 = C.f32(B, HID, seed=4, scale=0.5)
    state = (h0, h0 * 0.5) if cell == "LSTMCell" else h0

    def make(pkg):
        net = pkg.nn.RNN(getattr(pkg.nn, cell)(IN, HID), is_reverse=True)
        st = tuple(pkg.to_tensor(s) for s in state) \
            if cell == "LSTMCell" else pkg.to_tensor(state)
        return _Bound(pkg, net, st)

    C.check(make, [X, LENS], **TOL)


def test_birnn_matches_jax():
    C.check(lambda pkg: pkg.nn.BiRNN(pkg.nn.GRUCell(IN, HID),
                                     pkg.nn.LSTMCell(IN, HID)),
            [X, None, LENS], **TOL)


class _Bound:
    """A layer called with a fixed initial state: (x, lengths) ->
    layer(x, state, lengths). Not a Layer itself: ``check`` reads its
    parameters through the wrapped layer."""

    def __init__(self, pkg, layer, state):
        self.layer, self.state = layer, state

    def __call__(self, x, lens):
        return self.layer(x, self.state, lens)

    def __getattr__(self, name):
        return getattr(self.layer, name)

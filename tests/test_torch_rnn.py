"""The port's recurrent layers (`paddle_tpu_torch/nn/rnn.py`) against
JAX's `lax.scan` ones (`paddle_tpu/nn/rnn.py`) on the CPU: the cells, the
`RNN` wrapper (forward and reversed, time-major), and the stacked
`SimpleRNN`, `LSTM` and `GRU` with `sequence_length`, bidirectional,
between-layer dropout and a given initial state. After the same seed the
weights are JAX's bit for bit (uniform draws in JAX's order and layout);
from JAX's state the outputs, the final states and every gradient agree
within each case's tolerance (`tools/paddle_layer_cases.py`).
"""
import numpy as np
import pytest

import paddle_tpu as jp
import paddle_tpu_torch as tp
import paddle_tpu_torch.nn as tnn

from _paddle_state import paddle_state  # noqa: F401
from test_torch_nn_layers import RNN_CASES, check_case, check_init, plc


@pytest.mark.parametrize("name", sorted(RNN_CASES))
def test_rnn_matches_jax_scan(name):
    case = plc.LAYER_CASES[name]
    jl, tl = plc.build_case(jp, case), plc.build_case(tp, case)
    js = check_init(name, jl, tl)
    check_case(name, case, jl, tl, js)


def test_layout_states_and_masked_carry():
    """Gate-major weights `[G*H, in]`, `[layers*dirs, B, H]` states (a
    pair for LSTM), and past a sequence's length the state carried and
    the output zero."""
    tp.seed(0)
    lstm = tnn.LSTM(3, 5, num_layers=2, direction="bidirectional")
    assert tuple(lstm.cell_0_0.weight_ih.shape) == (20, 3)
    assert tuple(lstm.cell_1_1.weight_ih.shape) == (20, 10)
    x = tp.to_tensor(np.random.RandomState(0).randn(2, 6, 3)
                     .astype(np.float32))
    out, (h, c) = lstm(x, sequence_length=tp.to_tensor(np.array([6, 2])))
    assert tuple(out.shape) == (2, 6, 10)
    assert tuple(h.shape) == tuple(c.shape) == (4, 2, 5)
    o = out.numpy()
    assert np.all(o[1, 2:] == 0) and np.any(o[0, 2:] != 0)
    # the forward direction's last layer ends at step 2 for sequence 1
    np.testing.assert_array_equal(h.numpy()[2, 1], o[1, 1, :5])
    cell_out, cell_h = tnn.GRU(3, 4).cell_0_0(x[:, 0])
    assert tuple(cell_out.shape) == (2, 4)
    np.testing.assert_array_equal(cell_h.numpy(), cell_out.numpy())
    with pytest.raises(ValueError, match="direction"):
        tnn.GRU(3, 4, direction="up")
    with pytest.raises(ValueError, match="tanh or relu"):
        tnn.SimpleRNNCell(3, 4, "gelu")

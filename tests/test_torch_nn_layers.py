"""The port's `nn` layers against the JAX package's on the CPU: the
initializers (`paddle_tpu_torch/nn/initializer.py`), the `Layer` surface
(`nn/layer.py`), the constructors of Queue C 30, and one case per layer
class of `tools/paddle_layer_cases.py` (the recurrent ones are in
`test_torch_rnn.py`).

After the same `seed` in both packages every layer's parameters and
buffers equal JAX's, under JAX's names in JAX's order: the uniform family
bit for bit, the normal family within 1e-6. Given JAX's state, the forward,
the input gradients, the parameter gradients and the state after the
forward agree within each case's tolerance. JAX's side runs under one
`jax.jit` a case (one compile rather than one an op, the same values as
its eager tape), except where its forward writes a buffer only eagerly.
"""
import os
import sys

import numpy as np
import pytest
import torch

import jax

import paddle_tpu as jp
import paddle_tpu.nn as jnn
import paddle_tpu.nn.initializer as JI
import paddle_tpu_torch as tp
import paddle_tpu_torch.nn as tnn
from paddle_tpu_torch.nn import initializer as TI

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
import paddle_layer_cases as plc  # noqa: E402
from _paddle_state import paddle_state  # noqa: E402,F401

RNN_CASES = {"SimpleRNNCell", "LSTMCell", "GRUCell", "RNN", "RNN_reverse",
             "SimpleRNN", "LSTM", "GRU", "LSTM_dropout"}
CASES = [n for n in plc.LAYER_CASES if n not in RNN_CASES]
# parameters drawn from the normal family (XavierNormal, Normal) or
# normalized normal draws (SpectralNorm's vectors): within 1e-6; every
# other case's state is uniform draws and constants, bit for bit
NORMAL_INIT = {"Linear", "Sequential", "LayerList", "ParameterList",
               "LayerDict", "Embedding", "SpectralNorm"}
# forwards that write a buffer only eagerly in JAX (under a bare jax.jit
# SpectralNorm keeps its vectors)
JAX_EAGER = {"SpectralNorm"}


def _jax_arrays(res):
    conv = {"outs": list, "in_grads": list}
    out = {}
    for k, v in res.items():
        if k in conv:
            out[k] = [None if t is None else t._array for t in v]
        else:
            out[k] = {n: t._array for n, t in v.items()}
    return out


def run_jax(name, case, layer):
    """JAX's result for the case, numpy: the layer's state arrays are the
    arguments of one `jax.jit` around the eager tape, restored after."""
    if name in JAX_EAGER:
        return plc.numpy_result(plc.run_case(jp, name, case, layer))
    state = list(layer.state_dict().values())
    saved = [t._array for t in state]

    def traced(arrays):
        for t, a in zip(state, arrays):
            t._array = a
        return _jax_arrays(plc.run_case(jp, name, case, layer))

    try:
        res = jax.jit(traced)(saved)
    finally:
        for t, a in zip(state, saved):
            t._array = a
        layer.clear_gradients()
    return plc.numpy_result(res, conv=np.asarray)


def check_init(name, jl, tl):
    js, ts = plc.state_numpy(jl), plc.state_numpy(tl)
    assert list(ts) == list(js)
    assert [n for n, _ in tl.named_parameters()] == \
        [n for n, _ in jl.named_parameters()]
    for k in js:
        if name in NORMAL_INIT:
            np.testing.assert_allclose(ts[k], js[k], rtol=0, atol=1e-6,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(ts[k], js[k], err_msg=k)
    return js


def check_case(name, case, jl, tl, js):
    missing, unexpected = tl.set_state_dict(js)
    assert missing == [] and unexpected == []
    want = run_jax(name, case, jl)
    got = plc.numpy_result(plc.run_case(tp, name, case, tl))
    err = plc.max_err(got, want)
    assert err <= case.tol, (name, err)


@pytest.mark.parametrize("name", CASES)
def test_layer_matches_jax(name):
    """Init after `seed(0)`, names and order; then, from JAX's state, the
    forward and gradients (and the state after a training forward)."""
    case = plc.LAYER_CASES[name]
    jl, tl = plc.build_case(jp, case), plc.build_case(tp, case)
    js = check_init(name, jl, tl)
    check_case(name, case, jl, tl, js)


def test_every_ported_class_has_a_case():
    classes = {n for n in dir(jnn) if isinstance(getattr(jnn, n), type)
               and issubclass(getattr(jnn, n), jnn.Layer)}
    covered = set(plc.LAYER_CASES) | set(plc.ALSO_COVERS.values())
    # the losses (test_torch_losses.py), the Transformer layers
    # (test_torch_transformer*.py) and Layer itself are held elsewhere
    elsewhere = {"Layer", "CrossEntropyLoss", "MSELoss", "L1Loss",
                 "SmoothL1Loss", "NLLLoss", "BCELoss", "BCEWithLogitsLoss",
                 "KLDivLoss", "MarginRankingLoss", "HingeEmbeddingLoss",
                 "MultiHeadAttention", "TransformerEncoderLayer",
                 "TransformerEncoder", "TransformerDecoderLayer",
                 "TransformerDecoder", "Transformer"}
    assert classes - covered - elsewhere == set()
    for n in classes:
        assert issubclass(getattr(tnn, n), (tnn.Layer, torch.nn.Module))


# -- the initializers -----------------------------------------------------

INITS = [("Constant", (0.3,)), ("Normal", (0.1, 0.7)),
         ("TruncatedNormal", (0.2, 0.7)), ("Uniform", (-0.3, 0.6)),
         ("XavierNormal", ()), ("XavierUniform", ()),
         ("KaimingNormal", ()), ("KaimingUniform", ()), ("Dirac", ()),
         ("Assign", (np.arange(48, dtype=np.float32) / 7,))]
UNIFORM = {"Constant", "Uniform", "XavierUniform", "KaimingUniform",
           "Dirac", "Assign"}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,args", INITS, ids=[n for n, _ in INITS])
def test_initializer_draws_jax_s(name, args, dtype):
    """After the same seed: the uniform family bit for bit, the normal
    family within 1e-6 (bf16 through JAX's 16-bit path: the uniform per op
    in bf16, the normal's scale rounded to bf16 first), at a conv shape
    (fans from the receptive field; the layer cases cover the matrix
    shapes), twice, in the key chain's order."""
    jp.seed(5)
    tp.seed(5)
    shape = (4, 3, 2, 2)
    for _ in range(2):
        j = np.asarray(getattr(JI, name)(*args)(shape, dtype)
                       .astype("float32"))
        t = getattr(TI, name)(*args)(shape, dtype, device="cpu")
        assert t.dtype == getattr(torch, dtype) and tuple(t.shape) == shape
        t = t.float().numpy()
        if name in UNIFORM or dtype == "bfloat16":
            np.testing.assert_array_equal(t, j)
        else:
            np.testing.assert_allclose(t, j, rtol=0, atol=1e-6)


def test_orthogonal_is_jax_s_up_to_the_qr():
    """Orthogonal rows or columns, JAX's shape, and JAX's matrix up to the
    QR's rounding (signs fixed by R's diagonal, as jax.random.orthogonal
    does; ROADMAP Queue C caveat 29); the gain scales it."""
    for shape in ((5, 7), (4, 3, 6)):
        jp.seed(2)
        tp.seed(2)
        j = np.asarray(JI.Orthogonal(1.5)(shape, "float32"))
        t = TI.Orthogonal(1.5)(shape, "float32", device="cpu").numpy()
        assert t.shape == shape
        m = t.reshape(-1, shape[-1]) / 1.5
        small = min(m.shape)
        g = m.T @ m if m.shape[0] >= m.shape[1] else m @ m.T
        np.testing.assert_allclose(g, np.eye(small), atol=1e-5)
        np.testing.assert_allclose(t, j, atol=1e-5)
    assert TI.calculate_gain("leaky_relu", 0.2) == \
        JI.calculate_gain("leaky_relu", 0.2)


# -- the Layer surface ----------------------------------------------------

class _Net(tnn.Layer):
    def __init__(self):
        super().__init__()
        self.fc = tnn.Linear(4, 3)
        self.bn = tnn.BatchNorm1D(3)
        self.register_buffer("steps", tp.to_tensor(np.zeros(2, np.float32)),
                             persistable=False)

    def forward(self, x):
        return self.bn(self.fc(x))


def test_state_dict_round_trip_and_missing_unexpected():
    tp.seed(0)
    net = _Net()
    sd = net.state_dict()
    assert list(sd) == ["fc.weight", "fc.bias", "bn.weight", "bn.bias",
                        "bn._mean", "bn._variance"]
    assert sd["fc.weight"] is net.fc.weight          # the tensors themselves
    assert list(net.state_dict(structured_name_prefix="m"))[0] == \
        "m.fc.weight"
    assert "steps" in dict(net.named_buffers())
    tp.seed(1)
    other = _Net()
    arrays = {k: v.numpy() for k, v in sd.items()}
    arrays.pop("bn.bias")
    arrays["extra"] = np.zeros(1, np.float32)
    missing, unexpected = other.set_state_dict(arrays)
    assert missing == ["bn.bias"] and unexpected == ["extra"]
    np.testing.assert_array_equal(other.fc.weight.numpy(),
                                  net.fc.weight.numpy())
    assert other.load_dict is not None and other.set_dict is not None
    # torch's own machinery: a torch parent's state_dict and
    # load_state_dict go through Module's, with the same names
    parent = torch.nn.Sequential(net)
    tsd = parent.state_dict()
    assert list(tsd) == ["0." + k for k in sd]
    fresh = torch.nn.Sequential(_Net())
    fresh.load_state_dict(tsd)
    np.testing.assert_array_equal(fresh[0].fc.weight.numpy(),
                                  net.fc.weight.numpy())


def test_hooks_apply_order_and_sublayers():
    tp.seed(0)
    net = tnn.Sequential(tnn.Linear(4, 4), tnn.Sequential(tnn.ReLU()),
                         tnn.Linear(4, 2))
    seen = []
    h1 = net.register_forward_pre_hook(lambda m, inp: seen.append("pre"))
    h2 = net.register_forward_post_hook(
        lambda m, inp, out: out * 0 + 1.0)
    x = tp.to_tensor(np.ones((1, 4), np.float32))
    np.testing.assert_array_equal(net(x).numpy(), np.ones((1, 2)))
    assert seen == ["pre"]
    h1.remove()
    h2.remove()
    assert float(np.abs(net(x).numpy() - 1).max()) > 0 and seen == ["pre"]
    order = []
    net.apply(lambda m: order.append(type(m).__name__))
    assert order == ["Sequential", "Linear", "Sequential", "ReLU", "Linear"]
    assert [n for n, _ in net.named_sublayers()] == ["0", "1", "1.0", "2"]
    assert len(net.sublayers()) == 4 and len(net.sublayers(True)) == 5
    assert [type(c).__name__ for c in net.children()] == \
        ["Linear", "Sequential", "Linear"]
    assert net.full_name() == "sequential"
    assert isinstance(net.parameters(), list) and len(net.parameters()) == 4
    assert len(net.parameters(include_sublayers=False)) == 0
    net.train()
    net.eval()
    assert not any(m.training for m in net.sublayers(True))


def test_to_astype_cast_parameters_and_buffers_in_place():
    tp.seed(0)
    net = _Net()
    w = net.fc.weight
    opt = tp.optimizer.SGD(learning_rate=0.1, parameters=net.parameters())
    net.astype("bfloat16")
    assert net.fc.weight is w and w.dtype == torch.bfloat16
    assert net.bn._mean.dtype == torch.bfloat16 and net._dtype == "bfloat16"
    assert net.fc._dtype == "bfloat16"
    net.float()
    assert w.dtype == torch.float32 and net.bn._variance.dtype == \
        torch.float32
    net.to(dtype="bfloat16")
    net.to("float32")                       # a dtype given first
    assert w.dtype == torch.float32
    net.to(device="cpu")
    assert opt._parameter_list[0] is w
    # a new layer's parameters follow its dtype
    net.bfloat16()
    assert net.create_parameter([2]).dtype == torch.bfloat16


def test_create_parameter_attrs_and_the_selected_place(monkeypatch):
    lay = tnn.Layer()
    assert lay.create_parameter([3], attr=False) is None
    p = lay.create_parameter(
        [2, 3], attr=tnn.ParamAttr(name="w", learning_rate=0.5,
                                   trainable=False,
                                   initializer=TI.Constant(2.0)))
    assert p.name == "w" and p.optimize_attr == {"learning_rate": 0.5}
    assert p.stop_gradient and not p.trainable
    np.testing.assert_array_equal(p.numpy(), np.full((2, 3), 2.0))
    assert lay.create_parameter([3], is_bias=True).numpy().tolist() == \
        [0.0, 0.0, 0.0]
    # with no place selected the parameters go to the card, and raise
    # where there is none; device= puts them on the CPU
    from paddle_tpu_torch.core import device as cdev

    monkeypatch.setattr(cdev, "_current_place", None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tnn.Linear(2, 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tnn.BatchNorm2D(4)
    assert tnn.Linear(2, 2, device="cpu").weight.device.type == "cpu"
    assert tnn.Conv2D(2, 2, 3, device="cpu").weight.device.type == "cpu"


def test_containers_index_insert_and_name():
    tp.seed(0)
    ll = tnn.LayerList([tnn.ReLU(), tnn.Tanh()])
    ll.append(tnn.Sigmoid())
    ll.insert(1, tnn.GELU())
    assert [type(m).__name__ for m in ll] == ["ReLU", "GELU", "Tanh",
                                              "Sigmoid"]
    assert type(ll[-1]).__name__ == "Sigmoid" and len(ll[1:3]) == 2
    ll[0] = tnn.Silu()
    assert [n for n, _ in ll.named_children()] == ["0", "1", "2", "3"]
    seq = tnn.Sequential(("a", tnn.Linear(2, 2)), ("b", tnn.ReLU()))
    assert [n for n, _ in seq.named_parameters()] == ["a.weight", "a.bias"]
    assert type(seq[1]).__name__ == "ReLU" and len(seq[:1]) == 1
    d = tnn.LayerDict({"x": tnn.ReLU()})
    d["y"] = tnn.Tanh()
    assert list(d.keys()) == ["x", "y"] and len(d) == 2
    del d["x"]
    assert list(d) == ["y"]
    pl = tnn.ParameterList([tnn.Linear(2, 2).weight])
    pl.append(tnn.Linear(2, 3).bias)
    assert [n for n, _ in pl.named_parameters()] == ["0", "1"]
    assert tuple(pl[-1].shape) == (3,)


# -- Queue C 30: JAX's parameters in JAX's order --------------------------

def test_queue_c30_constructors_take_jax_s_arguments():
    jp.seed(0)
    tp.seed(0)
    jb, tb = jnn.BatchNorm2D(4, 0.9, 1e-5, False), \
        tnn.BatchNorm2D(4, 0.9, 1e-5, False)
    assert [n for n, _ in tb.named_parameters()] == \
        [n for n, _ in jb.named_parameters()] == ["bias"]
    assert tb._use_global_stats is None
    args = (3, 8, 3, 1, 1, 1, 1, "zeros", None, False)
    jc, tc = jnn.Conv2D(*args), tnn.Conv2D(*args)
    assert [n for n, _ in tc.named_parameters()] == \
        [n for n, _ in jc.named_parameters()] == ["weight"]
    np.testing.assert_array_equal(tc.weight.numpy(),
                                  np.asarray(jc.weight._array))
    tnn.Conv2D(3, 8, 3, data_format="NHWC", weight_attr=tnn.ParamAttr())
    tnn.MaxPool2D(2, 2, 0, False, False, "NCHW")
    tnn.AdaptiveAvgPool2D(1, "NCHW")
    tnn.ConvBNReLU(8, 8, 3, 1, 1, 1, 1, "relu", "dense", None, "NHWC")
    with pytest.raises(NotImplementedError, match="Queue C 29"):
        tnn.MaxPool2D(2, ceil_mode=True)(tp.to_tensor(
            np.zeros((1, 1, 4, 4), np.float32)))
    with pytest.raises(NotImplementedError, match="Queue C 29"):
        tnn.Conv2D(3, 8, 3, padding_mode="reflect")
    # NHWC ConvBNReLU equals NCHW on the transposed input
    tp.seed(3)
    a = tnn.ConvBNReLU(8, 8, 3, padding=1, backend="dense")
    tp.seed(3)
    b = tnn.ConvBNReLU(8, 8, 3, padding=1, backend="dense",
                       data_format="NHWC")
    x = np.random.RandomState(0).randn(2, 8, 5, 5).astype(np.float32)
    ya = a(tp.to_tensor(x)).numpy()
    yb = b(tp.to_tensor(x.transpose(0, 2, 3, 1))).numpy()
    np.testing.assert_allclose(yb.transpose(0, 3, 1, 2), ya, atol=1e-5)

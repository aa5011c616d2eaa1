"""The `nn` layer cases: one case per layer class ported from
`paddle_tpu/nn` (common, container, activation_layers, norm, pooling,
conv, rnn, fused), at small shapes, with the runner that builds a case's
layer, loads a state into it and runs its forward and backward in either
package.

`tests/test_torch_nn_layers.py` and `tests/test_torch_rnn.py` hold each
case on the CPU to the JAX package's (the initial parameters after the
same seed, then the forward and the gradients from JAX's state); phase
`paddle_layers` of `chip_smoke.py` holds the same cases, and the RNNs at a
card-sized shape (`CARD_CASES`), on the card to the CPU. Imports numpy
only: `paddle` is the package (`paddle_tpu` or `paddle_tpu_torch`).
"""
import numpy as np


class LayerCase:
    """One layer's case.

    `build(nn)` makes the layer from the package's `nn`; `inputs` are
    specs of the forward's arguments: ("f", shape) normal f32 (a leaf that
    takes a gradient), ("i", shape, lo, hi) int64 ids, ("len", values) int
    lengths, ("c", shape) a normal f32 constant, or a plain value;
    `call(layer, *inputs)` runs the forward (the layer itself by default)
    and `kw` goes to it; the outputs are flattened from nested tuples. The
    forward and the gradients are held within `tol` (relative to the
    largest magnitude above 1). `train` leaves the layer in train mode
    (the default, as both packages build them), else eval; `draws` marks a
    forward that draws from the key chain (reseeded before it); without
    `grad` the forward alone runs (an eval forward that is forward-only
    in both packages, as ConvBNReLU's fused one)."""

    def __init__(self, build, *inputs, call=None, tol=1e-5, train=True,
                 draws=False, grad=True, kw=None):
        self.build, self.inputs, self.call = build, inputs, call
        self.tol, self.train, self.draws = tol, train, draws
        self.grad = grad
        self.kw = kw or {}


C = LayerCase
_X34 = ("f", (3, 4))
_IMG = ("f", (2, 4, 5, 5))


def _plist(nn):
    lin = nn.Linear(4, 3)
    return nn.ParameterList([lin.weight, lin.bias])


def _dict(nn):
    return nn.LayerDict({"proj": nn.Linear(4, 6), "act": nn.GELU()})


LAYER_CASES = {
    # common
    "Linear": C(lambda nn: nn.Linear(6, 5), ("f", (4, 3, 6))),
    "Dropout": C(lambda nn: nn.Dropout(0.3), ("f", (4, 8)), draws=True),
    "Dropout2D": C(lambda nn: nn.Dropout2D(0.5), ("f", (2, 6, 3, 3)),
                   draws=True),
    "Embedding": C(lambda nn: nn.Embedding(10, 6, padding_idx=0),
                   ("i", (3, 5), 0, 10)),
    "Flatten": C(lambda nn: nn.Flatten(), ("f", (2, 3, 4))),
    "Identity": C(lambda nn: nn.Identity(), _X34),
    "Upsample": C(lambda nn: nn.Upsample(scale_factor=2, mode="bilinear"),
                  ("f", (1, 2, 3, 3))),
    "Pad2D": C(lambda nn: nn.Pad2D([1, 0, 2, 1], value=0.5),
               ("f", (1, 2, 3, 3))),
    "PixelShuffle": C(lambda nn: nn.PixelShuffle(2), ("f", (1, 8, 3, 3))),
    "CosineSimilarity": C(lambda nn: nn.CosineSimilarity(axis=1),
                          ("f", (3, 5)), ("f", (3, 5))),
    "Unfold": C(lambda nn: nn.Unfold([2, 2]), ("f", (1, 2, 4, 4))),
    "Fold": C(lambda nn: nn.Fold([4, 4], [2, 2]), ("f", (1, 8, 9))),
    # container
    "Sequential": C(lambda nn: nn.Sequential(
        ("fc1", nn.Linear(4, 8)), ("act", nn.Tanh()),
        ("fc2", nn.Linear(8, 2))), _X34),
    "LayerList": C(lambda nn: nn.LayerList([nn.Linear(4, 4), nn.Sigmoid(),
                                            nn.Linear(4, 2)]), _X34,
                   call=lambda m, x: m[2](m[1](m[0](x)))),
    "ParameterList": C(_plist, _X34,
                       call=lambda m, x: x @ m[0] + m[1]),
    "LayerDict": C(_dict, _X34, call=lambda m, x: m["act"](m["proj"](x))),
    # activation_layers
    "CELU": C(lambda nn: nn.CELU(1.3), _X34),
    "ELU": C(lambda nn: nn.ELU(0.7), _X34),
    "GELU": C(lambda nn: nn.GELU(approximate=True), _X34),
    "SELU": C(lambda nn: nn.SELU(), _X34),
    "Hardshrink": C(lambda nn: nn.Hardshrink(0.4), _X34),
    "Hardsigmoid": C(lambda nn: nn.Hardsigmoid(), _X34),
    "Hardswish": C(lambda nn: nn.Hardswish(), _X34),
    "Hardtanh": C(lambda nn: nn.Hardtanh(-0.5, 0.7), _X34),
    "LeakyReLU": C(lambda nn: nn.LeakyReLU(0.2), _X34),
    "LogSigmoid": C(lambda nn: nn.LogSigmoid(), _X34),
    "LogSoftmax": C(lambda nn: nn.LogSoftmax(0), _X34),
    "Maxout": C(lambda nn: nn.Maxout(3), ("f", (2, 6, 3))),
    "Mish": C(lambda nn: nn.Mish(), _X34),
    "PReLU": C(lambda nn: nn.PReLU(3, 0.1), ("f", (2, 3, 4))),
    "ReLU": C(lambda nn: nn.ReLU(), _X34),
    "ReLU6": C(lambda nn: nn.ReLU6(), ("f", (3, 4), 4.0)),
    "Sigmoid": C(lambda nn: nn.Sigmoid(), _X34),
    "Silu": C(lambda nn: nn.Silu(), _X34),
    "Softmax": C(lambda nn: nn.Softmax(1), _X34),
    "Softplus": C(lambda nn: nn.Softplus(2.0, 15.0), _X34),
    "Softshrink": C(lambda nn: nn.Softshrink(0.3), _X34),
    "Softsign": C(lambda nn: nn.Softsign(), _X34),
    "Swish": C(lambda nn: nn.Swish(), _X34),
    "Tanh": C(lambda nn: nn.Tanh(), _X34),
    "Tanhshrink": C(lambda nn: nn.Tanhshrink(), _X34),
    # norm
    "LayerNorm": C(lambda nn: nn.LayerNorm(6), ("f", (3, 4, 6))),
    "RMSNorm": C(lambda nn: nn.RMSNorm(6), ("f", (3, 4, 6))),
    "GroupNorm": C(lambda nn: nn.GroupNorm(2, 4), ("f", (2, 4, 3, 3))),
    "BatchNorm": C(lambda nn: nn.BatchNorm(4), ("f", (2, 4, 3, 3))),
    "BatchNorm1D": C(lambda nn: nn.BatchNorm1D(4), ("f", (3, 4, 5))),
    "BatchNorm2D": C(lambda nn: nn.BatchNorm2D(4, momentum=0.8),
                     ("f", (2, 4, 3, 3))),
    "BatchNorm2D_eval": C(lambda nn: nn.BatchNorm2D(4), ("f", (2, 4, 3, 3)),
                          train=False),
    "BatchNorm3D": C(lambda nn: nn.BatchNorm3D(4),
                     ("f", (2, 4, 2, 3, 3))),
    "SyncBatchNorm": C(lambda nn: nn.SyncBatchNorm(4), ("f", (2, 4, 3, 3))),
    "InstanceNorm2D": C(lambda nn: nn.InstanceNorm2D(4),
                        ("f", (2, 4, 3, 3))),
    "LocalResponseNorm": C(lambda nn: nn.LocalResponseNorm(3),
                           ("f", (2, 5, 3, 3))),
    "SpectralNorm": C(lambda nn: nn.SpectralNorm([6, 4], power_iters=2),
                      ("f", (6, 4))),
    # pooling
    "AvgPool1D": C(lambda nn: nn.AvgPool1D(2), ("f", (2, 3, 6))),
    "AvgPool2D": C(lambda nn: nn.AvgPool2D(3, 2, 1), ("f", (1, 2, 5, 5))),
    "AvgPool3D": C(lambda nn: nn.AvgPool3D(2), ("f", (1, 2, 4, 4, 4))),
    "MaxPool1D": C(lambda nn: nn.MaxPool1D(2), ("f", (2, 3, 6))),
    "MaxPool2D": C(lambda nn: nn.MaxPool2D(3, 2, 1), ("f", (1, 2, 5, 5))),
    "MaxPool3D": C(lambda nn: nn.MaxPool3D(2), ("f", (1, 2, 4, 4, 4))),
    "AdaptiveAvgPool2D": C(lambda nn: nn.AdaptiveAvgPool2D(2),
                           ("f", (1, 2, 4, 6))),
    "AdaptiveMaxPool2D": C(lambda nn: nn.AdaptiveMaxPool2D([2, 3]),
                           ("f", (1, 2, 4, 6))),
    # conv
    "Conv1D": C(lambda nn: nn.Conv1D(3, 4, 3, padding=1), ("f", (2, 3, 7))),
    "Conv2D": C(lambda nn: nn.Conv2D(4, 6, 3, stride=2, padding=1), _IMG),
    "Conv2D_nhwc": C(lambda nn: nn.Conv2D(4, 6, 3, padding=1,
                                          data_format="NHWC"),
                     ("f", (2, 5, 5, 4))),
    "Conv3D": C(lambda nn: nn.Conv3D(2, 3, 3, padding=1),
                ("f", (1, 2, 3, 3, 3))),
    "Conv2DTranspose": C(lambda nn: nn.Conv2DTranspose(4, 3, 3, stride=2,
                                                       padding=1), _IMG),
    # fused: the composition on the CPU, the kernels on the card
    "ConvBNReLU": C(lambda nn: nn.ConvBNReLU(8, 8, 3, padding=1),
                    ("f", (2, 8, 6, 6))),
    "ConvBNReLU_eval": C(lambda nn: nn.ConvBNReLU(8, 16, 1, act=None),
                         ("f", (2, 8, 6, 6)), train=False, grad=False),
    # rnn
    "SimpleRNNCell": C(lambda nn: nn.SimpleRNNCell(4, 6, "relu"),
                       ("f", (3, 4)), ("f", (3, 6))),
    "LSTMCell": C(lambda nn: nn.LSTMCell(4, 6), ("f", (3, 4)),
                  call=lambda m, x: m(x)),
    "GRUCell": C(lambda nn: nn.GRUCell(4, 6), ("f", (3, 4)), ("f", (3, 6))),
    "RNN": C(lambda nn: nn.RNN(nn.LSTMCell(4, 6)), ("f", (3, 5, 4)),
             kw={"sequence_length": ("len", [5, 2, 4])}),
    "RNN_reverse": C(lambda nn: nn.RNN(nn.GRUCell(4, 6), is_reverse=True,
                                       time_major=True), ("f", (5, 3, 4))),
    "SimpleRNN": C(lambda nn: nn.SimpleRNN(4, 6, num_layers=2),
                   ("f", (3, 5, 4))),
    "LSTM": C(lambda nn: nn.LSTM(4, 6, num_layers=2, direction="bidirect"),
              ("f", (3, 5, 4)), kw={"sequence_length": ("len", [5, 3, 1])}),
    "GRU": C(lambda nn: nn.GRU(4, 6, direction="bidirect", time_major=True),
             ("f", (5, 3, 4)), ("f", (2, 3, 6))),
    "LSTM_dropout": C(lambda nn: nn.LSTM(4, 6, num_layers=2, dropout=0.4),
                      ("f", (3, 5, 4)), draws=True),
}

# the classes each case covers beyond its key's (the aliases)
ALSO_COVERS = {"BatchNorm2D_eval": "BatchNorm2D", "Conv2D_nhwc": "Conv2D",
               "ConvBNReLU_eval": "ConvBNReLU", "RNN_reverse": "RNN",
               "LSTM_dropout": "LSTM"}

# the RNNs at a card-sized shape, for the card only
CARD_CASES = {
    "LSTM_card": C(lambda nn: nn.LSTM(1024, 1024, num_layers=2,
                                      direction="bidirect"),
                   ("f", (32, 128, 1024)), tol=1e-4),
    "GRU_card": C(lambda nn: nn.GRU(1024, 1024, num_layers=2,
                                    direction="bidirect"),
                  ("f", (32, 128, 1024)), tol=1e-4),
}


def _array(spec, rng):
    if not isinstance(spec, tuple):
        return spec
    kind = spec[0]
    if kind in ("f", "c"):
        scale = spec[2] if len(spec) > 2 else 1.0
        return (scale * rng.randn(*spec[1])).astype(np.float32)
    if kind == "i":
        return rng.randint(spec[2], spec[3], size=spec[1]).astype(np.int64)
    if kind == "len":
        return np.asarray(spec[1], np.int64)
    raise ValueError(f"unknown spec {spec!r}")


def case_inputs(name, case, seed=0):
    """The case's numpy inputs, keyword inputs and cotangent seed."""
    rng = np.random.RandomState(seed + sum(map(ord, name)))
    args = [_array(s, rng) for s in case.inputs]
    kw = {k: _array(s, rng) for k, s in case.kw.items()}
    return args, kw


def state_numpy(layer):
    """{name: float32 numpy} of the layer's `state_dict()`."""
    return {k: np.array(v.numpy(), dtype=np.float32)
            for k, v in layer.state_dict().items()}


def _flatten(out):
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _flatten(o)]
    return [out]


def build_case(paddle, case, seed=0):
    """The case's layer, built after `paddle.seed(seed)` on the selected
    place, in the case's mode."""
    paddle.seed(seed)
    layer = case.build(paddle.nn)
    return layer.train() if case.train else layer.eval()


def run_case(paddle, name, case, layer, seed=0):
    """Forward and backward of `layer` on the case's inputs: a dict of the
    outputs, the input gradients (None for an input that takes none), the
    parameter gradients by name and the state after the forward, as the
    package's tensors (`numpy_result` converts them). The loss is the sum
    of each output times a fixed numpy cotangent; a case without `grad`
    runs the forward only."""
    args, kw = case_inputs(name, case, seed)
    tensors = []
    for spec, a in zip(case.inputs, args):
        leaf = case.grad and isinstance(spec, tuple) and spec[0] == "f"
        tensors.append(paddle.to_tensor(a, stop_gradient=not leaf)
                       if isinstance(a, np.ndarray) else a)
    kwt = {k: paddle.to_tensor(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}
    if case.draws:
        paddle.seed(seed + 1)
    call = case.call or (lambda m, *xs, **k: m(*xs, **k))
    outs = _flatten(call(layer, *tensors, **kwt))
    in_grads, pgrads = [None] * len(tensors), {}
    if case.grad:
        rng = np.random.RandomState(seed + 7)
        loss = None
        for o in outs:
            cot = paddle.to_tensor(rng.randn(*o.shape).astype(np.float32))
            term = (o * cot).sum()
            loss = term if loss is None else loss + term
        loss.backward()
        in_grads = [t.grad if isinstance(s, tuple) and s[0] == "f" else None
                    for s, t in zip(case.inputs, tensors)]
        pgrads = {n: p.grad for n, p in layer.named_parameters()
                  if p.grad is not None}
    return {"outs": outs, "in_grads": in_grads, "param_grads": pgrads,
            "state": dict(layer.state_dict())}


def numpy_result(res, conv=None):
    """`run_case`'s result as float32 numpy arrays; `conv` maps one tensor
    to an array (its `.numpy()` by default)."""
    conv = conv or (lambda t: t.numpy())

    def one(t):
        return None if t is None else np.array(conv(t), dtype=np.float32)

    return {"outs": [one(o) for o in res["outs"]],
            "in_grads": [one(g) for g in res["in_grads"]],
            "param_grads": {k: one(v) for k, v in res["param_grads"].items()},
            "state": {k: one(v) for k, v in res["state"].items()}}


def max_err(got, want):
    """The largest difference over everything `run_case` returns,
    relative to the largest magnitude above 1; and the first part where
    the structures differ, if any."""
    worst = 0.0

    def one(a, b, where):
        nonlocal worst
        if (a is None) != (b is None):
            raise AssertionError(f"{where}: one side is None")
        if a is None:
            return
        if a.shape != b.shape:
            raise AssertionError(f"{where}: shape {a.shape} != {b.shape}")
        scale = max(1.0, float(np.abs(b).max()) if b.size else 1.0)
        worst = max(worst, float(np.abs(a - b).max()) / scale
                    if a.size else 0.0)

    if len(got["outs"]) != len(want["outs"]):
        raise AssertionError("output count differs")
    for i, (a, b) in enumerate(zip(got["outs"], want["outs"])):
        one(a, b, f"out {i}")
    for i, (a, b) in enumerate(zip(got["in_grads"], want["in_grads"])):
        one(a, b, f"input grad {i}")
    for part in ("param_grads", "state"):
        if set(got[part]) != set(want[part]):
            raise AssertionError(f"{part} names {sorted(got[part])} != "
                                 f"{sorted(want[part])}")
        for k in want[part]:
            one(got[part][k], want[part][k], f"{part} {k}")
    return worst

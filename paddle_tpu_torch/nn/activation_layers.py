"""Activation layers: counterpart of paddle_tpu/nn/activation_layers.py
(python/paddle/nn/layer/activation.py), each over the port's
`ops.activation` (the op dispatch)."""
from __future__ import annotations

from ..ops import activation as act
from . import initializer as I
from .layer import Layer


def _simple(name, fn):
    class _Act(Layer):
        def __init__(self, name=None):
            super().__init__()

        def forward(self, x):
            return fn(x)

    _Act.__name__ = _Act.__qualname__ = name
    return _Act


ReLU = _simple("ReLU", act.relu)
ReLU6 = _simple("ReLU6", act.relu6)
Sigmoid = _simple("Sigmoid", act.sigmoid)
Tanh = _simple("Tanh", act.tanh)
Silu = _simple("Silu", act.silu)
Swish = _simple("Swish", act.swish)
Mish = _simple("Mish", act.mish)
Hardswish = _simple("Hardswish", act.hardswish)
Hardsigmoid = _simple("Hardsigmoid", act.hardsigmoid)
Softsign = _simple("Softsign", act.softsign)
Tanhshrink = _simple("Tanhshrink", act.tanhshrink)
LogSigmoid = _simple("LogSigmoid", act.log_sigmoid)


class GELU(Layer):
    def __init__(self, approximate=False, name=None):
        super().__init__()
        self.approximate = approximate

    def forward(self, x):
        return act.gelu(x, self.approximate)


class LeakyReLU(Layer):
    def __init__(self, negative_slope=0.01, name=None):
        super().__init__()
        self.negative_slope = negative_slope

    def forward(self, x):
        return act.leaky_relu(x, self.negative_slope)


class ELU(Layer):
    def __init__(self, alpha=1.0, name=None):
        super().__init__()
        self.alpha = alpha

    def forward(self, x):
        return act.elu(x, self.alpha)


class SELU(Layer):
    def __init__(self, scale=1.0507009873554805, alpha=1.6732632423543772,
                 name=None):
        super().__init__()
        self.scale, self.alpha = scale, alpha

    def forward(self, x):
        return act.selu(x, self.scale, self.alpha)


class CELU(Layer):
    def __init__(self, alpha=1.0, name=None):
        super().__init__()
        self.alpha = alpha

    def forward(self, x):
        return act.celu(x, self.alpha)


class PReLU(Layer):
    def __init__(self, num_parameters=1, init=0.25, weight_attr=None,
                 name=None, *, device=None, dtype=None):
        super().__init__(dtype=dtype or "float32")
        self._place = device
        self.weight = self.create_parameter(
            [num_parameters], attr=weight_attr,
            default_initializer=I.Constant(init))

    def forward(self, x):
        return act.prelu(x, self.weight)


class Softmax(Layer):
    def __init__(self, axis=-1, name=None):
        super().__init__()
        self.axis = axis

    def forward(self, x):
        return act.softmax(x, self.axis)


class LogSoftmax(Layer):
    def __init__(self, axis=-1, name=None):
        super().__init__()
        self.axis = axis

    def forward(self, x):
        return act.log_softmax(x, self.axis)


class Softplus(Layer):
    def __init__(self, beta=1.0, threshold=20.0, name=None):
        super().__init__()
        self.beta, self.threshold = beta, threshold

    def forward(self, x):
        return act.softplus(x, self.beta, self.threshold)


class Hardtanh(Layer):
    def __init__(self, min=-1.0, max=1.0, name=None):
        super().__init__()
        self.min, self.max = min, max

    def forward(self, x):
        return act.hardtanh(x, self.min, self.max)


class Hardshrink(Layer):
    def __init__(self, threshold=0.5, name=None):
        super().__init__()
        self.threshold = threshold

    def forward(self, x):
        return act.hardshrink(x, self.threshold)


class Softshrink(Layer):
    def __init__(self, threshold=0.5, name=None):
        super().__init__()
        self.threshold = threshold

    def forward(self, x):
        return act.softshrink(x, self.threshold)


class Maxout(Layer):
    def __init__(self, groups, axis=1, name=None):
        super().__init__()
        self.groups, self.axis = groups, axis

    def forward(self, x):
        return act.maxout(x, self.groups, self.axis)

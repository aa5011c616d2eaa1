"""Activation ops of the paddle surface: counterpart of
paddle_tpu/ops/activation.py (python/paddle/nn/functional/activation.py),
through `ops.dispatch.apply` under the JAX package's names. Each is
written as jax.nn writes it where torch's own function differs at an edge (leaky_relu's slope at 0, softplus' threshold:
jax's softplus is `logaddexp(x, 0)`); the random ones draw from the
paddle key chain (`core.random.next_key`, jax's bits).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core import dtype as dtypes
from ..core.random import next_key
from . import threefry
from .dispatch import apply, as_tensor

__all__ = [
    "relu", "relu6", "leaky_relu", "elu", "selu", "celu", "gelu", "silu",
    "swish", "sigmoid", "hardsigmoid", "hardswish", "hardtanh", "hardshrink",
    "softshrink", "tanhshrink", "softplus", "softsign", "mish", "prelu",
    "log_sigmoid", "softmax", "log_softmax", "gumbel_softmax", "maxout",
    "glu", "tanh",
    "thresholded_relu", "rrelu",
]


def _softplus(a):
    return torch.logaddexp(a, torch.zeros((), dtype=a.dtype,
                                          device=a.device))


def _unary(name, fn):
    def op(x, *args, **kwargs):
        return apply(name, fn, as_tensor(x))

    op.__name__ = name
    return op


relu = _unary("relu", torch.relu)
relu6 = _unary("relu6", lambda a: torch.clamp(a, 0.0, 6.0))
sigmoid = _unary("sigmoid", torch.sigmoid)
silu = _unary("silu", F.silu)
softsign = _unary("softsign", lambda a: a / (torch.abs(a) + 1))
log_sigmoid = _unary("log_sigmoid", lambda a: -_softplus(-a))
tanh = _unary("tanh", torch.tanh)
mish = _unary("mish", lambda a: a * torch.tanh(_softplus(a)))


def leaky_relu(x, negative_slope=0.01):
    return apply("leaky_relu",
                 lambda a: torch.where(a >= 0, a, negative_slope * a),
                 as_tensor(x))


def elu(x, alpha=1.0):
    return apply("elu", lambda a: torch.where(a > 0, a, alpha * torch.expm1(
        torch.where(a > 0, torch.zeros_like(a), a))), as_tensor(x))


def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772):
    return apply("selu", lambda a: scale * torch.where(
        a > 0, a, alpha * torch.expm1(a)), as_tensor(x))


def celu(x, alpha=1.0):
    return apply("celu", lambda a: torch.clamp(a, min=0.0) + alpha *
                 torch.expm1(torch.clamp(a, max=0.0) / alpha), as_tensor(x))


def gelu(x, approximate=False):
    mode = "tanh" if approximate else "none"
    return apply("gelu", lambda a: F.gelu(a, approximate=mode), as_tensor(x))


def swish(x):
    return silu(x)


def hardsigmoid(x, slope=1.0 / 6, offset=0.5):
    return apply("hardsigmoid",
                 lambda a: torch.clamp(slope * a + offset, 0.0, 1.0),
                 as_tensor(x))


def hardswish(x):
    return apply("hardswish",
                 lambda a: a * torch.clamp(a + 3.0, 0.0, 6.0) / 6.0,
                 as_tensor(x))


def hardtanh(x, min=-1.0, max=1.0):
    return apply("hardtanh", lambda a: torch.clamp(a, min, max),
                 as_tensor(x))


def hardshrink(x, threshold=0.5):
    return apply("hardshrink", lambda a: torch.where(
        torch.abs(a) > threshold, a, torch.zeros_like(a)), as_tensor(x))


def softshrink(x, threshold=0.5):
    return apply("softshrink", lambda a: torch.where(
        a > threshold, a - threshold, torch.where(
            a < -threshold, a + threshold, torch.zeros_like(a))),
        as_tensor(x))


def tanhshrink(x):
    return apply("tanhshrink", lambda a: a - torch.tanh(a), as_tensor(x))


def softplus(x, beta=1.0, threshold=20.0):
    return apply("softplus", lambda a: torch.where(
        beta * a > threshold, a, _softplus(beta * a) / beta), as_tensor(x))


def prelu(x, weight):
    def fn(a, w):
        if w.numel() == 1:
            return torch.where(a > 0, a, w.reshape(()) * a)
        # channel-wise (NCHW): the weight broadcast over the spatial dims
        shape = [1] * a.ndim
        shape[1] = w.numel()
        return torch.where(a > 0, a, w.reshape(shape) * a)

    return apply("prelu", fn, as_tensor(x), as_tensor(weight))


def softmax(x, axis=-1, dtype=None):
    def fn(a):
        if dtype is not None:
            a = a.to(dtypes.to_torch(dtype))
        return torch.softmax(a, axis)

    return apply("softmax", fn, as_tensor(x))


def log_softmax(x, axis=-1):
    return apply("log_softmax", lambda a: torch.log_softmax(a, axis),
                 as_tensor(x))


def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1):
    x = as_tensor(x)
    key = next_key()

    def fn(a):
        g = threefry.gumbel_shaped(key, a.shape, a.dtype, a.device)
        y = torch.softmax((a + g) / temperature, axis)
        if hard:
            idx = torch.argmax(y, axis, keepdim=True)
            y_hard = torch.zeros_like(y).scatter(axis, idx, 1.0)
            y = y_hard - y.detach() + y
        return y

    return apply("gumbel_softmax", fn, x)


def maxout(x, groups, axis=1):
    def fn(a):
        shape = list(a.shape)
        c = shape[axis]
        shape[axis:axis + 1] = [c // groups, groups]
        return torch.amax(a.reshape(shape), axis + 1)

    return apply("maxout", fn, as_tensor(x))


def glu(x, axis=-1):
    return apply("glu", lambda a: F.glu(a, axis), as_tensor(x))


def thresholded_relu(x, threshold=1.0, name=None):
    return apply("thresholded_relu", lambda a: torch.where(
        a > threshold, a, torch.zeros_like(a)), as_tensor(x))


def rrelu(x, lower=1.0 / 8.0, upper=1.0 / 3.0, training=True, name=None):
    """Randomized leaky relu: training draws each element's negative slope
    uniformly from [lower, upper); eval takes the mean slope."""
    x = as_tensor(x)
    if not training:
        mid = (lower + upper) / 2.0
        return apply("rrelu", lambda a: torch.where(a >= 0, a, mid * a), x)
    key = next_key()

    def fn(a):
        slope = threefry.uniform_shaped(key, a.shape, torch.float32,
                                        lower, upper, a.device).to(a.dtype)
        return torch.where(a >= 0, a, slope * a)

    return apply("rrelu", fn, x)

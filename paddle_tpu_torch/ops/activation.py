"""Activation ops of the paddle surface: counterpart of
paddle_tpu/ops/activation.py (python/paddle/nn/functional/activation.py),
over torch ops. Each is written as jax.nn writes it where torch's own
function differs at an edge (leaky_relu's slope at 0, softplus' threshold:
jax's softplus is `logaddexp(x, 0)`); the random ones draw from the
paddle key chain (`core.random.next_key`, jax's bits).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core import dtype as dtypes
from ..core.random import next_key
from ..core.tensor import as_tensor
from . import threefry

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
        return fn(as_tensor(x))

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
    x = as_tensor(x)
    return torch.where(x >= 0, x, negative_slope * x)


def elu(x, alpha=1.0):
    x = as_tensor(x)
    return torch.where(x > 0, x, alpha * torch.expm1(
        torch.where(x > 0, torch.zeros_like(x), x)))


def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772):
    x = as_tensor(x)
    return scale * torch.where(x > 0, x, alpha * torch.expm1(x))


def celu(x, alpha=1.0):
    x = as_tensor(x)
    return torch.clamp(x, min=0.0) + alpha * torch.expm1(
        torch.clamp(x, max=0.0) / alpha)


def gelu(x, approximate=False):
    return F.gelu(as_tensor(x), approximate="tanh" if approximate
                  else "none")


def swish(x):
    return silu(x)


def hardsigmoid(x, slope=1.0 / 6, offset=0.5):
    return torch.clamp(slope * as_tensor(x) + offset, 0.0, 1.0)


def hardswish(x):
    x = as_tensor(x)
    return x * torch.clamp(x + 3.0, 0.0, 6.0) / 6.0


def hardtanh(x, min=-1.0, max=1.0):
    return torch.clamp(as_tensor(x), min, max)


def hardshrink(x, threshold=0.5):
    x = as_tensor(x)
    return torch.where(torch.abs(x) > threshold, x, torch.zeros_like(x))


def softshrink(x, threshold=0.5):
    x = as_tensor(x)
    return torch.where(x > threshold, x - threshold, torch.where(
        x < -threshold, x + threshold, torch.zeros_like(x)))


def tanhshrink(x):
    x = as_tensor(x)
    return x - torch.tanh(x)


def softplus(x, beta=1.0, threshold=20.0):
    x = as_tensor(x)
    return torch.where(beta * x > threshold, x, _softplus(beta * x) / beta)


def prelu(x, weight):
    x, w = as_tensor(x), as_tensor(weight)
    if w.numel() == 1:
        return torch.where(x > 0, x, w.reshape(()) * x)
    # channel-wise (NCHW): the weight broadcast over the spatial dims
    shape = [1] * x.ndim
    shape[1] = w.numel()
    return torch.where(x > 0, x, w.reshape(shape) * x)


def softmax(x, axis=-1, dtype=None):
    x = as_tensor(x)
    if dtype is not None:
        x = x.to(dtypes.to_torch(dtype))
    return torch.softmax(x, axis)


def log_softmax(x, axis=-1):
    return torch.log_softmax(as_tensor(x), axis)


def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1):
    x = as_tensor(x)
    g = threefry.gumbel_shaped(next_key(), x.shape, x.dtype, x.device)
    y = torch.softmax((x + g) / temperature, axis)
    if hard:
        idx = torch.argmax(y, axis, keepdim=True)
        y_hard = torch.zeros_like(y).scatter(axis, idx, 1.0)
        y = y_hard - y.detach() + y
    return y


def maxout(x, groups, axis=1):
    x = as_tensor(x)
    shape = list(x.shape)
    c = shape[axis]
    shape[axis:axis + 1] = [c // groups, groups]
    return torch.amax(x.reshape(shape), axis + 1)


def glu(x, axis=-1):
    return F.glu(as_tensor(x), axis)


def thresholded_relu(x, threshold=1.0, name=None):
    x = as_tensor(x)
    return torch.where(x > threshold, x, torch.zeros_like(x))


def rrelu(x, lower=1.0 / 8.0, upper=1.0 / 3.0, training=True, name=None):
    """Randomized leaky relu: training draws each element's negative slope
    uniformly from [lower, upper); eval takes the mean slope."""
    x = as_tensor(x)
    if not training:
        mid = (lower + upper) / 2.0
        return torch.where(x >= 0, x, mid * x)
    slope = threefry.uniform_shaped(next_key(), x.shape, torch.float32,
                                    lower, upper, x.device).to(x.dtype)
    return torch.where(x >= 0, x, slope * x)

"""Weight initializers: counterpart of paddle_tpu/nn/initializer.py
(python/paddle/nn/initializer/).

Each initializer is a callable `(shape, dtype) -> tensor`, as in JAX, and
draws from the global key chain (`core.random.next_key`), so that
`paddle.seed(s)` gives the JAX package's weights: the uniform family bit
for bit (`ops.threefry.uniform_shaped`), the normal family through XLA's
f32 erf_inv (`ops.threefry.normal`, within a few ulps). The draw lands on
the selected place (`core.device.current_device`), or on `device` when the
caller passes one (keyword-only, the port's own).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core import dtype as dtypes
from ..core.device import current_device
from ..core.random import next_key
from ..ops import threefry

__all__ = [
    "Initializer", "Constant", "Normal", "TruncatedNormal", "Uniform",
    "XavierNormal", "XavierUniform", "KaimingNormal", "KaimingUniform",
    "Assign", "Orthogonal", "Dirac", "calculate_gain",
]


def _fans(shape):
    shape = tuple(shape)
    if len(shape) < 1:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]  # paddle linear weight [in, out]
    receptive = int(np.prod(shape[2:]))
    fan_in = shape[1] * receptive
    fan_out = shape[0] * receptive
    return fan_in, fan_out


def calculate_gain(nonlinearity, param=None):
    gains = {
        "sigmoid": 1.0, "linear": 1.0, "conv1d": 1.0, "conv2d": 1.0,
        "conv3d": 1.0, "tanh": 5.0 / 3, "relu": math.sqrt(2.0),
        "leaky_relu": math.sqrt(2.0 / (1 + (param or 0.01) ** 2)),
        "selu": 3.0 / 4,
    }
    return gains.get(nonlinearity, 1.0)


def _s(v, t):
    """Python scalar `v` in `t`'s dtype, as JAX rounds a weakly typed
    scalar to the array's dtype before the op."""
    return torch.full((), v, dtype=t.dtype, device=t.device)


def _normal(shape, dtype, device):
    """jax.random.normal(next_key(), shape, dtype)."""
    return threefry.normal(next_key(), tuple(shape), dtypes.to_torch(dtype),
                           current_device(device))


def _uniform(shape, dtype, device, low, high):
    """jax.random.uniform(next_key(), shape, dtype, low, high)."""
    return threefry.uniform_shaped(next_key(), tuple(shape),
                                   dtypes.to_torch(dtype), low, high,
                                   current_device(device))


class Initializer:
    def __call__(self, shape, dtype="float32", *, device=None):
        raise NotImplementedError


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def __call__(self, shape, dtype="float32", *, device=None):
        return torch.full(tuple(shape), self.value,
                          dtype=dtypes.to_torch(dtype),
                          device=current_device(device))


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype="float32", *, device=None):
        n = _normal(shape, dtype, device)
        return _s(self.mean, n) + _s(self.std, n) * n


class TruncatedNormal(Initializer):
    """jax.random.truncated_normal(key, -2, 2): `sqrt(2) erf_inv(u)` of a
    uniform `u` on [erf(-sqrt 2), erf(sqrt 2)], clipped inside (-2, 2)."""

    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype="float32", *, device=None):
        td = dtypes.to_torch(dtype)
        dev = current_device(device)
        sqrt2 = torch.tensor(math.sqrt(2), dtype=td)
        lower, upper = torch.tensor(-2.0, dtype=td), torch.tensor(2.0,
                                                                  dtype=td)
        a = torch.erf((lower / sqrt2).float()).to(td).item()
        b = torch.erf((upper / sqrt2).float()).to(td).item()
        u = threefry.uniform_shaped(next_key(), tuple(shape), td, a, b, dev)
        out = sqrt2.to(dev) * threefry.erfinv32(u.float()).to(td)
        lo = torch.nextafter(lower, torch.tensor(math.inf, dtype=td))
        hi = torch.nextafter(upper, torch.tensor(-math.inf, dtype=td))
        out = torch.clamp(out, lo.to(dev), hi.to(dev))
        return _s(self.mean, out) + _s(self.std, out) * out


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0):
        self.low, self.high = low, high

    def __call__(self, shape, dtype="float32", *, device=None):
        return _uniform(shape, dtype, device, self.low, self.high)


class XavierNormal(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype="float32", *, device=None):
        fi, fo = _fans(shape)
        fi = self.fan_in or fi
        fo = self.fan_out or fo
        std = self.gain * math.sqrt(2.0 / (fi + fo))
        n = _normal(shape, dtype, device)
        return _s(std, n) * n


class XavierUniform(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype="float32", *, device=None):
        fi, fo = _fans(shape)
        fi = self.fan_in or fi
        fo = self.fan_out or fo
        limit = self.gain * math.sqrt(6.0 / (fi + fo))
        return _uniform(shape, dtype, device, -limit, limit)


class KaimingNormal(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self.fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def __call__(self, shape, dtype="float32", *, device=None):
        fi, _ = _fans(shape)
        fi = self.fan_in or fi
        gain = calculate_gain(self.nonlinearity, self.negative_slope)
        std = gain / math.sqrt(fi)
        n = _normal(shape, dtype, device)
        return _s(std, n) * n


class KaimingUniform(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self.fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def __call__(self, shape, dtype="float32", *, device=None):
        fi, _ = _fans(shape)
        fi = self.fan_in or fi
        gain = calculate_gain(self.nonlinearity, self.negative_slope)
        limit = gain * math.sqrt(3.0 / fi)
        return _uniform(shape, dtype, device, -limit, limit)


class Assign(Initializer):
    def __init__(self, value):
        self.value = value

    def __call__(self, shape, dtype="float32", *, device=None):
        v = self.value
        if isinstance(v, torch.Tensor):
            v = v.detach().float().cpu().numpy()
        arr = torch.as_tensor(np.asarray(v)).to(dtypes.to_torch(dtype))
        return arr.reshape(tuple(shape)).to(current_device(device))


class Orthogonal(Initializer):
    """jax.nn.initializers.orthogonal(): the Q of a QR of a normal draw
    `[max(r, c), min(r, c)]` (r the product of all but the last dim, c the
    last), its columns signed by R's diagonal, transposed when r < c."""

    def __init__(self, gain=1.0):
        self.gain = gain

    def __call__(self, shape, dtype="float32", *, device=None):
        shape = tuple(shape)
        if len(shape) < 2:
            raise ValueError(
                "orthogonal initializer requires at least a 2D shape")
        td = dtypes.to_torch(dtype)
        n_cols = shape[-1]
        n_rows = math.prod(shape) // n_cols
        z = _normal((max(n_rows, n_cols), min(n_rows, n_cols)), dtype,
                    device)
        q, r = torch.linalg.qr(z.float())
        q = (q * torch.sign(torch.diagonal(r))[None, :]).to(td)
        if n_rows < n_cols:
            q = q.T
        q = torch.ones((), dtype=td, device=q.device) * q.reshape(shape)
        return _s(self.gain, q) * q


class Dirac(Initializer):
    def __init__(self, groups=1):
        self.groups = groups

    def __call__(self, shape, dtype="float32", *, device=None):
        o, i = shape[0], shape[1]
        arr = np.zeros(tuple(shape), np.float32)
        centers = tuple(s // 2 for s in shape[2:])
        for k in range(min(o, i * self.groups)):
            arr[(k, k % i) + centers] = 1.0
        return torch.from_numpy(arr).to(current_device(device),
                                        dtypes.to_torch(dtype))

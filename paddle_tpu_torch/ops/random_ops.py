"""Random sampling ops of the paddle surface: counterpart of
paddle_tpu/ops/random_ops.py (python/paddle/tensor/random.py).

Every op takes a fresh subkey from the global generator
(`core.random.next_key`: the JAX package's key chain for the same seed)
and draws jax.random's bits from it on the tensor's device
(`ops.threefry`), so a seed gives the JAX package's draws: the bits, the
uniforms and the integer draws bit for bit; the normal and exponential
transforms within a few ulps (torch's erfinv and log1p, not XLA's
polynomials). `poisson` is the exception: jax's algorithm (a while loop of
key splits) is not reproduced; it seeds torch's own Poisson sampler from
the subkey's bits, deterministic for a seed, JAX's distribution and not
its draws.
"""
from __future__ import annotations

import torch

from ..core import dtype as dtypes
from ..core.device import current_device
from ..core.random import next_key
from ..core.tensor import Tensor
from . import threefry
from .creation import _shape_tuple
from .dispatch import apply_nograd, as_tensor, unwrap

__all__ = [
    "rand", "randn", "randint", "randint_like", "randperm", "uniform",
    "normal", "standard_normal", "bernoulli", "multinomial", "poisson",
    "exponential", "shuffle", "uniform_", "normal_",
]


def _t(x) -> Tensor:
    return x.as_subclass(Tensor)


def rand(shape, dtype=None):
    return uniform(shape, dtype=dtype, min=0.0, max=1.0)


def randn(shape, dtype=None):
    return _t(threefry.normal(next_key(), _shape_tuple(shape),
                              dtypes.to_torch(dtype), current_device()))


def standard_normal(shape, dtype=None):
    return randn(shape, dtype)


def uniform(shape, dtype=None, min=-1.0, max=1.0, seed=0):
    return _t(threefry.uniform_shaped(next_key(), _shape_tuple(shape),
                                      dtypes.to_torch(dtype), min, max,
                                      current_device()))


def normal(mean=0.0, std=1.0, shape=None):
    if isinstance(mean, torch.Tensor) or isinstance(std, torch.Tensor):
        m, sd = unwrap(mean), unwrap(std)
        ref = m if isinstance(m, torch.Tensor) else sd
        n = threefry.normal(next_key(), tuple(ref.shape), torch.float32,
                            ref.device)
        return _t(m + sd * n)
    dev = current_device()
    n = threefry.normal(next_key(), _shape_tuple(shape),
                        dtypes.to_torch(None), dev)
    return _t(mean + std * n)


def randint(low=0, high=None, shape=(1,), dtype="int64"):
    if high is None:
        low, high = 0, low
    return _t(threefry.randint(next_key(), _shape_tuple(shape), low, high,
                               dtypes.to_torch(dtype), current_device()))


def randint_like(x, low=0, high=None, dtype=None):
    x = as_tensor(x)
    if high is None:
        low, high = 0, low
    return _t(threefry.randint(next_key(), tuple(x.shape), low, high,
                               dtypes.to_torch(dtype or x.dtype), x.device))


def randperm(n, dtype="int64"):
    idx = threefry.permutation(next_key(), int(n))
    return _t(idx.to(device=current_device(), dtype=dtypes.to_torch(dtype)))


def bernoulli(x):
    key = next_key()
    return apply_nograd("bernoulli", lambda a: threefry.bernoulli(
        key, a).to(a.dtype), as_tensor(x))


def multinomial(x, num_samples=1, replacement=False):
    x = as_tensor(x)
    key = next_key()

    def fn(a):
        logits = torch.log(torch.clamp(a, min=1e-30))
        if replacement:
            # jax.random.categorical(key, logits, shape=(num_samples,) +
            # batch): a Gumbel a sample and category, then the argmax
            g = threefry.gumbel_shaped(key, (num_samples,) + tuple(a.shape),
                                       a.dtype, a.device)
            out = torch.argmax(g + logits, -1).to(torch.int32)
            return out.T if a.ndim > 1 else out
        # without replacement: the Gumbel top-k trick
        g = threefry.gumbel_shaped(key, tuple(a.shape), torch.float32,
                                   a.device)
        idx = torch.sort(logits + g, dim=-1, descending=True,
                         stable=True).indices[..., :num_samples]
        return idx.to(torch.int32)

    return apply_nograd("multinomial", fn, x)


def poisson(x):
    """Poisson draws of rate `x`, from torch's sampler seeded by the
    subkey (not jax's draws; see the module docstring)."""
    x = as_tensor(x)
    k1, k2 = next_key()
    gen = torch.Generator(device=x.device)
    gen.manual_seed((k1 << 32) | k2)
    return apply_nograd("poisson", lambda a: torch.poisson(
        a, generator=gen).to(a.dtype), x)


def exponential(x, lam=1.0):
    key = next_key()
    return apply_nograd("exponential", lambda a: threefry.exponential(
        key, tuple(a.shape), a.dtype, a.device) / lam, as_tensor(x))


def shuffle(x, axis=0):
    key = next_key()
    return apply_nograd("shuffle", lambda a: threefry.permutation(
        key, a, axis), as_tensor(x))


def uniform_(x, min=-1.0, max=1.0):
    with torch.no_grad():
        x.copy_(threefry.uniform_shaped(next_key(), tuple(x.shape), x.dtype,
                                        min, max, x.device))
    return x


def normal_(x, mean=0.0, std=1.0):
    with torch.no_grad():
        x.copy_(mean + std * threefry.normal(next_key(), tuple(x.shape),
                                             x.dtype, x.device))
    return x

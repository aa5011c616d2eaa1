"""JAX's default PRNG as torch integer arithmetic: the counterpart of what
`jax.random` computes under the sampler (jax's threefry2x32 PRNG with
`jax_threefry_partitionable` on, its default).

Every value is a uint32 held in an int64 tensor and masked to 32 bits
after each add, so nothing here needs `torch.uint32`. The functions take
and return such tensors, broadcasting as torch does: a key is a pair
`(k1, k2)` of tensors (each `[...]`), and a draw of `n` values under keys
of shape `[N]` is `[N, n]`.

- `threefry2x32(k1, k2, x1, x2)`: the 20-round Threefry-2x32 hash, rotations
  (13, 15, 26, 6) and (17, 29, 16, 24), key schedule `k1 ^ k2 ^ 0x1BD11BDA`;
- `fold_in(key, data)`: the hash of `(0, data)` under `key`;
- `random_bits32(key, n)`: the partitionable layout, counts `(i >> 32,
  i & 0xFFFFFFFF)` for `i < n`, bits `b1 ^ b2`;
- `uniform(key, n, minval)`: `(bits >> 9) | 0x3F800000` viewed as f32,
  minus 1, then `max(minval, u * (1 - minval) + minval)`, all in f32;
- `gumbel(key, n)`: `-log(-log(uniform(key, n, tiny)))`, jax's default
  "low" mode.

These are the plain versions of the draw kernels of `csrc/sampling.cu`
(`ops/sampling.py` holds their wrappers).
"""
from __future__ import annotations

import torch

__all__ = ["M32", "threefry2x32", "fold_in", "random_bits32", "uniform",
           "gumbel", "TINY"]

M32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
#: the smallest normal f32, jax's minval for the Gumbel's uniform
TINY = torch.finfo(torch.float32).tiny


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & M32


def threefry2x32(k1, k2, x1, x2):
    """Threefry-2x32 of the counts `(x1, x2)` under the key `(k1, k2)`:
    int64 tensors of uint32 values, broadcast together. Returns the two
    output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    a = (x1 + ks[0]) & M32
    b = (x2 + ks[1]) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            a = (a + b) & M32
            b = _rotl(b, r) ^ a
        a = (a + ks[(i + 1) % 3]) & M32
        b = (b + ks[(i + 2) % 3] + i + 1) & M32
    return a, b


def fold_in(key, data):
    """jax.random.fold_in: the key `(k1, k2)` with `data` (ints or int
    tensors, taken as uint32) hashed in."""
    k1, k2 = key
    data = torch.as_tensor(data, dtype=torch.int64, device=k1.device) & M32
    return threefry2x32(k1, k2, torch.zeros_like(data), data)


def random_bits32(key, n):
    """jax.random.bits(key, (n,), uint32) under each key: `[..., n]`."""
    k1, k2 = key
    idx = torch.arange(n, dtype=torch.int64, device=k1.device)
    b1, b2 = threefry2x32(k1[..., None], k2[..., None], idx >> 32,
                          idx & M32)
    return b1 ^ b2


def _f32(x, like):
    return torch.as_tensor(x, dtype=torch.float32, device=like.device)


def uniform(key, n, minval=0.0):
    """jax.random.uniform(key, (n,), float32, minval, 1.0) under each key:
    `[..., n]` f32."""
    bits = random_bits32(key, n)
    u = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) \
        - _f32(1.0, bits)
    lo = _f32(minval, bits)
    return torch.maximum(lo, u * (_f32(1.0, bits) - lo) + lo)


def gumbel(key, n):
    """jax.random.gumbel(key, (n,), float32) in its default "low" mode
    under each key: `[..., n]` f32."""
    return -torch.log(-torch.log(uniform(key, n, TINY)))

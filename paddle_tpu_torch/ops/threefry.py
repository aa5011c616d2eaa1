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

The shaped draws of `jax.random` under one key, for the paddle API's
random ops (`ops/random_ops.py`): the key is a pair of Python ints, so the
key chain stays on the host, and the draw runs on `device`:

- `split(key, n)`: `jax.random.split`, key i the hash of `(0, i)` (the
  partitionable layout: `fold_in(key, i)`);
- `bits(key, shape, nbits, device)`: `_random_bits`, row-major counts,
  the low `nbits` of `b1 ^ b2`;
- `uniform_shaped`, `normal`, `randint`, `bernoulli`, `exponential`,
  `gumbel_shaped`, `permutation`: `jax.random`'s `_uniform` (its
  mantissa trick at the dtype's width, 8 random bits below 8 mantissa
  bits; the scale and shift one fused multiply-add at f32, one rounding
  an op at 16 bits, as XLA's CPU code computes them), `_normal_real`
  (`sqrt(2) erfinv(u)` over `u` on
  `(nextafter(-1, 0), 1)`), `_randint` (two words a value from
  `split(key)`, the span's remainders), `_bernoulli` (`u < p`),
  `_exponential` (`-log1p(-u)`), `_gumbel` ("low") and `_shuffle`
  (sorts by fresh 32-bit keys, `ceil(3 ln n / ln(2^32 - 1))` rounds).
  The integer steps are exact; erf_inv is XLA's f32 polynomial over
  torch's log1p (`erfinv32`), the exponential's log1p torch's.
"""
from __future__ import annotations

import math

import torch

__all__ = ["M32", "threefry2x32", "fold_in", "random_bits32", "uniform",
           "gumbel", "TINY", "split", "bits", "uniform_shaped", "erfinv32",
           "normal",
           "randint", "bernoulli", "exponential", "gumbel_shaped",
           "permutation"]

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


# ---------------------------------------------------------------------------
# shaped draws under a host key (a pair of Python ints)
# ---------------------------------------------------------------------------
def split(key, n=2):
    """jax.random.split(key, n): `n` host keys, key i the hash of (0, i)."""
    k1, k2 = key
    return [threefry2x32(k1, k2, 0, i) for i in range(n)]


def bits(key, shape, nbits=32, device=None):
    """jax's `_random_bits(key, nbits, shape)`: `shape` int64 tensor of
    uint values on `device`."""
    shape = tuple(shape)
    n = math.prod(shape)
    idx = torch.arange(n, dtype=torch.int64, device=device)
    b1, b2 = threefry2x32(key[0], key[1], idx >> 32, idx & M32)
    b = b1 ^ b2
    if nbits < 32:
        b = b & ((1 << nbits) - 1)
    return b.view(shape)


# float dtype -> (bits, mantissa bits, the int dtype of its width)
_FLOATS = {torch.float32: (32, 23, torch.int32),
           torch.float16: (16, 10, torch.int16),
           torch.bfloat16: (16, 7, torch.int16)}


def uniform_shaped(key, shape, dtype=torch.float32, minval=0.0, maxval=1.0,
                   device=None):
    """jax.random.uniform(key, shape, dtype, minval, maxval)."""
    nbits, nmant, idt = _FLOATS[dtype]
    rng_bits = 8 if nmant < 8 else nbits
    b = bits(key, shape, rng_bits, device)
    one = {32: 0x3F800000, 16: 0x3F80 if dtype == torch.bfloat16
           else 0x3C00}[nbits]
    f = ((b >> (rng_bits - nmant)) | one).to(idt).view(dtype)
    f = f - torch.ones((), dtype=dtype, device=device)
    lo = torch.as_tensor(minval, dtype=dtype, device=device)
    hi = torch.as_tensor(maxval, dtype=dtype, device=device)
    if nbits == 16:
        # XLA rounds each 16-bit op to the dtype: no contraction
        return torch.maximum(lo, f * (hi - lo) + lo)
    # XLA contracts `f * (hi - lo) + lo` into one fused multiply-add: the
    # product is exact in float64, so the sum rounds once, as the FMA does
    span = (hi - lo).double()
    return torch.maximum(lo, (f.double() * span + lo.double()).to(dtype))


# XLA's single-precision erf_inv (Giles' polynomial): the coefficients for
# w = -log1p(-x^2) below 5 and at or above it
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erfinv32(x):
    """XLA's f32 erf_inv of an f32 tensor: its polynomial, each step one
    fused multiply-add as XLA's CPU code emits it (the product exact in
    float64, one rounding); the log1p is torch's."""
    w = -torch.log1p(-(x * x))
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0).double()

    def coeff(i):
        return torch.where(lt, _ERFINV_LT5[i], _ERFINV_GE5[i]).to(
            torch.float32)

    p = coeff(0)
    for i in range(1, len(_ERFINV_LT5)):
        p = (coeff(i).double() + p.double() * w).to(torch.float32)
    return torch.where(torch.abs(x) == 1, x * torch.finfo(x.dtype).max,
                       p * x)


def normal(key, shape, dtype=torch.float32, device=None):
    """jax.random.normal(key, shape, dtype), real dtypes: `sqrt(2)
    erf_inv(u)`, XLA's f32 erf_inv (`erfinv32`; narrower dtypes through
    f32, as XLA widens them)."""
    lo = torch.nextafter(torch.tensor(-1.0, dtype=dtype),
                         torch.tensor(0.0, dtype=dtype)).item()
    u = uniform_shaped(key, shape, dtype, lo, 1.0, device)
    e = erfinv32(u.float()).to(dtype)
    return torch.as_tensor(math.sqrt(2), dtype=dtype, device=device) * e


_INT_RANGE = {torch.int32: (-2 ** 31, 2 ** 31 - 1),
              torch.int16: (-2 ** 15, 2 ** 15 - 1),
              torch.int8: (-2 ** 7, 2 ** 7 - 1),
              torch.uint8: (0, 2 ** 8 - 1)}


def randint(key, shape, minval, maxval, dtype=torch.int32, device=None):
    """jax.random.randint(key, shape, minval, maxval, dtype) for Python int
    bounds and 32-bit or narrower dtypes: two words a value, from
    `split(key)`; the offset `(hi % span * (2^32 % span) + lo % span) %
    span` in uint32 arithmetic (the multiplier `((2^16 % span)^2) %
    span`)."""
    lo_t, hi_t = _INT_RANGE[dtype]
    nbits = 32 if dtype == torch.int32 else (16 if dtype == torch.int16
                                             else 8)
    mask = (1 << nbits) - 1
    out_of_range = maxval > hi_t
    minval = min(max(int(minval), lo_t), hi_t)
    maxval = min(max(int(maxval), lo_t), hi_t)
    k1, k2 = split(key)
    higher, lower = bits(k1, shape, nbits, device), bits(k2, shape, nbits,
                                                         device)
    span = (maxval - minval) & mask
    if maxval <= minval:
        span = 1
    if out_of_range and maxval > minval:
        span = (span + 1) & mask
    if span == 0:                 # 2^nbits: the remainders do nothing
        off = (higher * 0 + lower) & mask
    else:
        mult = ((((2 ** (nbits // 2)) % span) ** 2) & mask) % span
        off = (((higher % span) * mult) & mask) + (lower % span)
        off = (off & mask) % span
    return (minval + off).to(dtype)


def bernoulli(key, p):
    """jax.random.bernoulli(key, p): `uniform(key, p.shape, p.dtype) < p`."""
    return uniform_shaped(key, p.shape, p.dtype, device=p.device) < p


def exponential(key, shape, dtype=torch.float32, device=None):
    """jax.random.exponential(key, shape, dtype): `-log1p(-u)`."""
    return -torch.log1p(-uniform_shaped(key, shape, dtype, device=device))


def gumbel_shaped(key, shape, dtype=torch.float32, device=None):
    """jax.random.gumbel(key, shape, dtype) in its default "low" mode."""
    tiny = torch.finfo(dtype).tiny
    return -torch.log(-torch.log(uniform_shaped(key, shape, dtype, tiny, 1.0,
                                                device)))


def permutation(key, x, axis=0):
    """jax.random.permutation(key, x, axis): of `arange(x)` for an int, else
    of the slices of tensor `x` along `axis` (one shuffled index)."""
    n = x if isinstance(x, int) else x.shape[axis]
    dev = None if isinstance(x, int) else x.device
    idx = torch.arange(n, dtype=torch.int64, device=dev)
    rounds = int(math.ceil(3 * math.log(max(1, n)) / math.log(M32)))
    for _ in range(rounds):
        key, sub = split(key)
        order = torch.sort(bits(sub, (n,), 32, dev), stable=True).indices
        idx = idx[order]
    return idx if isinstance(x, int) else torch.index_select(x, axis, idx)

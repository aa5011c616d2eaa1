"""Linear algebra ops of the paddle surface: counterpart of
paddle_tpu/ops/linalg.py (python/paddle/tensor/linalg.py), over torch
ops, through `ops.dispatch` under the JAX package's names.

JAX computes `matmul` outside any Pallas kernel, so the port's is
`torch.matmul`, with JAX's numeric contract: floating inputs accumulate in
fp32, and the product is cast to the promoted dtype (cuBLAS' bf16 GEMM
keeps fp32 accumulators; its split-K partials stay fp32 while
`torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction` is
False). The decompositions are LAPACK's (or cuSOLVER's): `svd`, `qr` and
`eigh` are unique only up to the signs of their vectors, as JAX's are.
"""
from __future__ import annotations

import torch

from ..core import dtype as dtypes
from .dispatch import apply, apply_nograd, as_tensor, const

__all__ = [
    "matmul", "mm", "bmm", "dot", "outer", "inner", "t", "norm", "dist",
    "cross", "cholesky", "inverse", "pinv", "solve", "triangular_solve",
    "svd", "qr", "eigh", "det", "slogdet", "matrix_power", "trace",
    "diagonal", "kron", "mv", "histogram",
    "einsum", "baddbmm", "renorm", "corrcoef", "cov",
]

_LOW = (torch.bfloat16, torch.float16)


def _matmul(a, b):
    """jnp.matmul(a, b, preferred_element_type=f32) cast to the promoted
    dtype: fp32 inputs as they are; bf16/f16 through fp32 on the CPU
    (where torch's own low-precision GEMM rounds partial sums), on the card
    the low-precision GEMM, which accumulates in fp32 and rounds once."""
    common = dtypes.promote_types(a.dtype, b.dtype)
    a, b = a.to(common), b.to(common)
    if common in _LOW and a.device.type == "cpu":
        return torch.matmul(a.float(), b.float()).to(common)
    return torch.matmul(a, b)


def matmul(x, y, transpose_x=False, transpose_y=False):
    def fn(a, b):
        if transpose_x and a.ndim >= 2:
            a = a.transpose(-1, -2)
        if transpose_y and b.ndim >= 2:
            b = b.transpose(-1, -2)
        return _matmul(a, b)

    return apply("matmul", fn, as_tensor(x), as_tensor(y))


def mm(x, y):
    return matmul(x, y)


def bmm(x, y):
    return matmul(x, y)


def dot(x, y):
    return apply("dot", lambda a, b: torch.sum(a * b, -1), as_tensor(x),
                 as_tensor(y))


def outer(x, y):
    return apply("outer", lambda a, b: torch.outer(a.reshape(-1),
                                                   b.reshape(-1)),
                 as_tensor(x), as_tensor(y))


def inner(x, y):
    return apply("inner", torch.inner, as_tensor(x), as_tensor(y))


def t(x):
    x = as_tensor(x)
    if x.ndim < 2:
        from .manipulation import clone

        return clone(x)
    return apply("t", lambda a: a.transpose(-1, -2), x)


def mv(x, vec):
    return apply("mv", _matmul, as_tensor(x), as_tensor(vec))


def _axis(axis):
    return tuple(axis) if isinstance(axis, list) else axis


def norm(x, p="fro", axis=None, keepdim=False):
    """JAX's elementwise norms over `axis` (all axes when None): "fro" and
    p=2 with no axis the root sum of squares, inf/-inf the max/min of |x|,
    0 the count of nonzeros, 1 the sum of |x|, else (sum |x|^p)^(1/p)."""
    ax = _axis(axis)

    def red(fn, a):
        if ax is None:
            return fn(a, dim=tuple(range(a.ndim)), keepdim=keepdim)
        return fn(a, dim=ax, keepdim=keepdim)

    def fn(a):
        if p == "fro" or (p == 2 and axis is None):
            return torch.sqrt(red(torch.sum, torch.square(a)))
        if p == float("inf"):
            return red(torch.amax, torch.abs(a))
        if p == float("-inf"):
            return red(torch.amin, torch.abs(a))
        if p == 0:
            return red(torch.sum, (a != 0).to(a.dtype))
        if p == 1:
            return red(torch.sum, torch.abs(a))
        return torch.pow(red(torch.sum, torch.pow(torch.abs(a), p)),
                         1.0 / p)

    return apply("norm", fn, as_tensor(x))


def dist(x, y, p=2):
    from .math import subtract

    return norm(subtract(x, y), p=float(p) if p != 2 else 2)


def cross(x, y, axis=-1):
    return apply("cross", lambda a, b: torch.linalg.cross(a, b, dim=axis),
                 as_tensor(x), as_tensor(y))


def cholesky(x, upper=False):
    def fn(a):
        L = torch.linalg.cholesky(a)
        return L.transpose(-1, -2) if upper else L

    return apply("cholesky", fn, as_tensor(x))


def inverse(x):
    return apply("inverse", torch.linalg.inv, as_tensor(x))


def pinv(x, rcond=1e-15):
    return apply("pinv", lambda a: torch.linalg.pinv(a, rtol=rcond),
                 as_tensor(x))


def solve(x, y):
    return apply("solve", torch.linalg.solve, as_tensor(x), as_tensor(y))


def triangular_solve(x, y, upper=True, transpose=False, unitriangular=False):
    def fn(a, b):
        if transpose:
            a, up = a.transpose(-1, -2), not upper
        else:
            up = upper
        return torch.linalg.solve_triangular(a, b, upper=up,
                                             unitriangular=unitriangular)

    return apply("triangular_solve", fn, as_tensor(x), as_tensor(y))


def svd(x, full_matrices=False):
    return apply("svd", lambda a: tuple(torch.linalg.svd(
        a, full_matrices=full_matrices)), as_tensor(x))


def qr(x, mode="reduced"):
    if mode == "r":
        return apply("qr", lambda a: torch.linalg.qr(a, mode="r")[1],
                     as_tensor(x))
    return apply("qr", lambda a: tuple(torch.linalg.qr(a, mode=mode)),
                 as_tensor(x))


def eigh(x, UPLO="L"):
    return apply("eigh", lambda a: tuple(torch.linalg.eigh(a, UPLO=UPLO)),
                 as_tensor(x))


def det(x):
    return apply("det", torch.linalg.det, as_tensor(x))


def slogdet(x):
    return apply("slogdet", lambda a: tuple(torch.linalg.slogdet(a)),
                 as_tensor(x))


def matrix_power(x, n):
    return apply("matrix_power", lambda a: torch.linalg.matrix_power(a, n),
                 as_tensor(x))


def trace(x, offset=0, axis1=0, axis2=1):
    return apply("trace", lambda a: torch.diagonal(
        a, offset, axis1, axis2).sum(-1), as_tensor(x))


def diagonal(x, offset=0, axis1=0, axis2=1):
    return apply("diagonal", lambda a: torch.diagonal(a, offset, axis1,
                                                      axis2), as_tensor(x))


def kron(x, y):
    return apply("kron", torch.kron, as_tensor(x), as_tensor(y))


def histogram(x, bins=100, min=0, max=0):
    """Counts of `bins` equal bins over [min, max]; min == max == 0 means
    the data's range, and an empty range widens by 0.5 each side (JAX's
    rules). The edges are jnp.linspace's, the last bin is closed, values
    outside are not counted; the counts take x's dtype, as JAX's."""
    def fn(a):
        out_dtype = a.dtype
        a = a.float().reshape(-1)
        if min == 0 and max == 0:
            lo, hi = a.min(), a.max()
        else:
            lo = torch.tensor(float(min), device=a.device)
            hi = torch.tensor(float(max), device=a.device)
        empty = hi == lo
        lo, hi = torch.where(empty, lo - 0.5, lo), torch.where(
            empty, hi + 0.5, hi)
        step = torch.arange(bins, dtype=torch.float32, device=a.device) \
            / bins
        edges = torch.cat([lo * (1 - step) + hi * step, hi[None]])
        idx = torch.searchsorted(edges, a, right=True) - 1
        idx = torch.where(a == edges[-1], bins - 1, idx)
        ok = (idx >= 0) & (idx < bins)
        return torch.bincount(idx[ok], minlength=bins).to(out_dtype)

    return apply_nograd("histogram", fn, as_tensor(x))


def einsum(equation, *operands, name=None):
    """paddle.einsum: one contraction over the operands."""
    ts = [as_tensor(o) for o in operands]
    return apply("einsum", lambda *arrs: torch.einsum(equation, *arrs), *ts)


def baddbmm(input, x, y, beta=1.0, alpha=1.0, name=None):
    """beta*input + alpha*(x @ y) batched (paddle baddbmm)."""
    return apply("baddbmm", lambda a, b, c: beta * a + alpha *
                 torch.matmul(b, c), as_tensor(input), as_tensor(x),
                 as_tensor(y))


def renorm(x, p, axis, max_norm, name=None):
    """Clamp each slice along `axis` to p-norm <= max_norm."""
    def fn(a):
        red = tuple(i for i in range(a.ndim) if i != axis % a.ndim)
        norms = torch.sum(torch.abs(a) ** p, red, keepdim=True) \
            ** (1.0 / p)
        factor = torch.where(norms > max_norm, max_norm / (norms + 1e-7),
                             torch.ones((), dtype=a.dtype, device=a.device))
        return a * factor

    return apply("renorm", fn, as_tensor(x))


def corrcoef(x, rowvar=True, name=None):
    def fn(a):
        a = a if rowvar else a.transpose(-1, -2)
        return torch.corrcoef(a)

    return apply("corrcoef", fn, as_tensor(x))


def cov(x, rowvar=True, ddof=True, fweights=None, aweights=None,
        name=None):
    fw = None if fweights is None else const(as_tensor(fweights))
    aw = None if aweights is None else const(as_tensor(aweights))

    def fn(a):
        a = a if rowvar else a.transpose(-1, -2)
        return torch.cov(a, correction=1 if ddof else 0,
                         fweights=None if fw is None else fw.long(),
                         aweights=aw)

    return apply("cov", fn, as_tensor(x))

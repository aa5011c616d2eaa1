"""Reduction and search ops of the paddle surface: counterpart of
paddle_tpu/ops/reduction.py (python/paddle/tensor/{math,search,stat}.py),
over torch ops, through `ops.dispatch` under the JAX package's names.
Where torch and jnp differ, JAX's rule holds: integer sums and cumulative
sums stay int32, means of integers are float32, medians
and quantiles interpolate (`jnp.median`, not torch's lower median),
sorts are stable with descending the flip of ascending, `topk` takes the
lower index on a tie, and indices are int32.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import dtype as dtypes
from ..core.tensor import Tensor
from .dispatch import apply, apply_nograd, as_tensor

__all__ = [
    "sum", "mean", "max", "min", "prod", "std", "var", "median",
    "argmax", "argmin", "argsort", "sort", "topk", "all", "any",
    "cumsum", "cumprod", "logsumexp", "amax", "amin", "count_nonzero",
    "nansum", "nanmean", "kthvalue", "mode", "unique", "nonzero",
    "quantile", "bincount", "nanmedian", "trapezoid",
]

_INTS = (torch.int8, torch.int16, torch.int32, torch.int64, torch.uint8,
         torch.bool)


def _dims(axis, ndim):
    if axis is None:
        return tuple(range(ndim))
    if isinstance(axis, (int, np.integer)):
        return (int(axis) % ndim if ndim else 0,)
    return tuple(int(a) % ndim for a in axis)


def _int32(t, like):
    """JAX keeps integer reductions at its default int: int32."""
    return t.to(torch.int32) if like.dtype in _INTS else t


def _reduce(name, fn, cast_int=False, float_int=False):
    def op(x, axis=None, keepdim=False):
        x = as_tensor(x)

        def f(a):
            if float_int and a.dtype in _INTS:
                a = a.to(torch.float32)
            if a.ndim == 0:
                out = fn(a, (), False)
            else:
                out = fn(a, _dims(axis, a.ndim), keepdim)
            return _int32(out, a) if cast_int else out

        return apply(name, f, x)

    op.__name__ = name
    return op


def _prod(x, dims, keepdim):
    for d in sorted(dims, reverse=True):
        x = torch.prod(x, d, keepdim=keepdim)
    return x


def _logsumexp(a, dims, keepdim):
    m = torch.amax(a, dims, keepdim=True)
    return torch.log(torch.sum(torch.exp(a - m), dims, keepdim=keepdim)) \
        + torch.amax(a, dims, keepdim=keepdim)


sum = _reduce("sum", lambda x, d, k: torch.sum(x, d, keepdim=k),
              cast_int=True)
mean = _reduce("mean", lambda x, d, k: torch.mean(x, d, keepdim=k),
               float_int=True)
max = _reduce("max", lambda x, d, k: torch.amax(x, d, keepdim=k))
min = _reduce("min", lambda x, d, k: torch.amin(x, d, keepdim=k))
amax = _reduce("amax", lambda x, d, k: torch.amax(x, d, keepdim=k))
amin = _reduce("amin", lambda x, d, k: torch.amin(x, d, keepdim=k))
prod = _reduce("prod", _prod, cast_int=True)
nansum = _reduce("nansum", lambda x, d, k: torch.nansum(x, d, keepdim=k))
nanmean = _reduce("nanmean", lambda x, d, k: torch.nanmean(x, d,
                                                           keepdim=k),
                  float_int=True)
logsumexp = _reduce("logsumexp", _logsumexp)


def _moments(name, fn):
    def op(x, axis=None, unbiased=True, keepdim=False):
        def f(a):
            if a.dtype in _INTS:
                a = a.to(torch.float32)
            return fn(a, _dims(axis, a.ndim),
                      correction=1 if unbiased else 0, keepdim=keepdim)

        return apply(name, f, as_tensor(x))

    op.__name__ = name
    return op


std = _moments("std", torch.std)
var = _moments("var", torch.var)


def _over_last(x, dims):
    """x with the axes `dims` moved to the end and flattened into one."""
    rest = [d for d in range(x.ndim) if d not in dims]
    y = x.permute(*rest, *dims)
    return y.reshape(*[x.shape[d] for d in rest], -1)


def _quantile(name, fn, x, q, axis, keepdim):
    def f(a):
        if a.dtype in _INTS:
            a = a.to(torch.float32)
        dims = _dims(axis, a.ndim)
        qt = q if isinstance(q, float) else torch.as_tensor(
            q, dtype=a.dtype, device=a.device)
        out = fn(_over_last(a, dims), qt, dim=-1)
        if keepdim:
            lead = 0 if isinstance(q, float) else 1
            for d in sorted(dims):
                out = out.unsqueeze(lead + d)
        return out

    return apply(name, f, as_tensor(x))


def median(x, axis=None, keepdim=False):
    return _quantile("median", torch.quantile, x, 0.5, axis, keepdim)


def quantile(x, q, axis=None, keepdim=False):
    return _quantile("quantile", torch.quantile, x, q, axis, keepdim)


def nanmedian(x, axis=None, keepdim=False, name=None):
    return _quantile("nanmedian", torch.nanquantile, x, 0.5, axis, keepdim)


def _arg(name, fn):
    def op(x, axis=None, keepdim=False, dtype="int64"):
        def f(a):
            if axis is None:
                r = fn(a.reshape(-1), 0)
            else:
                r = fn(a, int(axis), keepdim=keepdim)
            return r.to(dtypes.to_torch(dtype))

        return apply_nograd(name, f, as_tensor(x))

    op.__name__ = name
    return op


argmax = _arg("argmax", torch.argmax)
argmin = _arg("argmin", torch.argmin)


def argsort(x, axis=-1, descending=False):
    def fn(a):
        idx = torch.argsort(a, dim=axis, stable=True)
        if descending:
            idx = torch.flip(idx, (axis,))
        return idx.to(torch.int32)

    return apply_nograd("argsort", fn, as_tensor(x))


def sort(x, axis=-1, descending=False):
    def fn(a):
        s = torch.sort(a, dim=axis, stable=True).values
        return torch.flip(s, (axis,)) if descending else s

    return apply("sort", fn, as_tensor(x))


def topk(x, k, axis=-1, largest=True, sorted=True):
    k = int(k)

    def fn(a):
        key = a if largest else -a
        idx = torch.sort(key, dim=axis, descending=True, stable=True) \
            .indices.narrow(axis, 0, k)
        return torch.gather(a, axis, idx), idx.to(torch.int32)

    return apply("topk", fn, as_tensor(x))


def _logical(name, fn):
    def op(x, axis=None, keepdim=False):
        def f(a):
            if a.ndim == 0:
                return fn(a)
            return fn(a, _dims(axis, a.ndim), keepdim=keepdim)

        return apply_nograd(name, f, as_tensor(x))

    op.__name__ = name
    return op


all = _logical("all", torch.all)
any = _logical("any", torch.any)


def cumsum(x, axis=None):
    def fn(a):
        out = torch.cumsum(a.reshape(-1), 0) if axis is None else \
            torch.cumsum(a, int(axis))
        return _int32(out, a) if a.dtype != torch.bool else \
            out.to(torch.int32)

    return apply("cumsum", fn, as_tensor(x))


def cumprod(x, dim=None):
    def fn(a):
        out = torch.cumprod(a.reshape(-1), 0) if dim is None else \
            torch.cumprod(a, int(dim))
        return _int32(out, a)

    return apply("cumprod", fn, as_tensor(x))


def count_nonzero(x, axis=None, keepdim=False):
    return apply_nograd("count_nonzero", lambda a: torch.sum(
        a != 0, _dims(axis, a.ndim), keepdim=keepdim).to(torch.int32),
        as_tensor(x))


def kthvalue(x, k, axis=-1, keepdim=False):
    def fn(a):
        s, i = torch.sort(a, dim=axis, stable=True)
        v, ix = s.select(axis, k - 1), i.select(axis, k - 1)
        if keepdim:
            v, ix = v.unsqueeze(axis), ix.unsqueeze(axis)
        return v, ix.to(torch.int32)

    return apply("kthvalue", fn, as_tensor(x))


def mode(x, axis=-1, keepdim=False):
    """The most frequent value along `axis` (the smallest of the most
    frequent): the JAX package's run-length walk over the sorted values."""
    def fn(a):
        s = torch.sort(a, dim=axis).values
        first = torch.zeros_like(s.narrow(axis, 0, 1), dtype=torch.int32)
        same = torch.cat([first, (torch.diff(s, dim=axis) == 0)
                          .to(torch.int32)], axis)
        cs = torch.cumsum(same, axis, dtype=torch.int32)
        run = cs - torch.cumsum(torch.where(same == 0, cs, 0), axis,
                                dtype=torch.int32)
        best = torch.argmax(run, dim=axis, keepdim=True)
        v = torch.take_along_dim(s, best, axis)
        return v if keepdim else v.squeeze(axis)

    return apply_nograd("mode", fn, as_tensor(x))


def unique(x, return_index=False, return_inverse=False, return_counts=False,
           axis=None):
    # dynamic output shape: host-side, as the JAX package's
    x = as_tensor(x)
    res = np.unique(Tensor.numpy(x), return_index=return_index,
                    return_inverse=return_inverse,
                    return_counts=return_counts, axis=axis)
    if isinstance(res, tuple):
        return tuple(Tensor(np.asarray(r), place=x.device) for r in res)
    return Tensor(np.asarray(res), place=x.device)


def nonzero(x, as_tuple=False):
    x = as_tensor(x)
    idx = torch.nonzero(x.as_subclass(torch.Tensor)).to(torch.int32)
    if as_tuple:
        return tuple(idx[:, i].as_subclass(Tensor)
                     for i in range(idx.shape[1]))
    return idx.as_subclass(Tensor)


def bincount(x, weights=None, minlength=0):
    w = None if weights is None else as_tensor(weights).as_subclass(
        torch.Tensor)

    def fn(a):
        out = torch.bincount(a, w, minlength)
        return out.to(torch.int32) if w is None else out.to(w.dtype)

    return apply_nograd("bincount", fn, as_tensor(x))


def trapezoid(y, x=None, dx=None, axis=-1, name=None):
    """Trapezoidal integration (paddle.trapezoid)."""
    if x is not None and dx is not None:
        raise ValueError("trapezoid: pass x (coordinates) OR dx "
                         "(uniform spacing), not both")
    y = as_tensor(y)
    if x is not None:
        # the coordinates are constants of the op, as in the JAX package
        xs = as_tensor(x, y).as_subclass(torch.Tensor).detach()
        return apply("trapezoid", lambda a: torch.trapezoid(
            a, xs.to(a.device), dim=axis), y)
    d = 1.0 if dx is None else float(dx)
    return apply("trapezoid", lambda a: torch.trapezoid(a, dx=d, dim=axis),
                 y)

"""Reduction and search ops of the paddle surface: counterpart of
paddle_tpu/ops/reduction.py (python/paddle/tensor/{math,search,stat}.py),
over torch ops. Where torch and jnp differ, JAX's rule holds: integer sums
and cumulative sums stay int32, means of integers are float32, medians
and quantiles interpolate (`jnp.median`, not torch's lower median),
sorts are stable with descending the flip of ascending, `topk` takes the
lower index on a tie, and indices are int32.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import dtype as dtypes
from ..core.tensor import Tensor, as_tensor

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
        if float_int and x.dtype in _INTS:
            x = x.to(torch.float32)
        if x.ndim == 0:
            out = fn(x, (), False)
        else:
            out = fn(x, _dims(axis, x.ndim), keepdim)
        return _int32(out, x) if cast_int else out

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


def _moments(fn):
    def op(x, axis=None, unbiased=True, keepdim=False):
        x = as_tensor(x)
        if x.dtype in _INTS:
            x = x.to(torch.float32)
        return fn(x, _dims(axis, x.ndim), correction=1 if unbiased else 0,
                  keepdim=keepdim)

    return op


std = _moments(torch.std)
std.__name__ = "std"
var = _moments(torch.var)
var.__name__ = "var"


def _over_last(x, dims):
    """x with the axes `dims` moved to the end and flattened into one."""
    rest = [d for d in range(x.ndim) if d not in dims]
    y = x.permute(*rest, *dims)
    return y.reshape(*[x.shape[d] for d in rest], -1)


def _quantile(fn, x, q, axis, keepdim):
    x = as_tensor(x)
    if x.dtype in _INTS:
        x = x.to(torch.float32)
    dims = _dims(axis, x.ndim)
    qt = q if isinstance(q, float) else torch.as_tensor(
        q, dtype=x.dtype, device=x.device)
    out = fn(_over_last(x, dims), qt, dim=-1)
    if keepdim:
        lead = 0 if isinstance(q, float) else 1
        for d in sorted(dims):
            out = out.unsqueeze(lead + d)
    return out


def median(x, axis=None, keepdim=False):
    return _quantile(torch.quantile, x, 0.5, axis, keepdim)


def quantile(x, q, axis=None, keepdim=False):
    return _quantile(torch.quantile, x, q, axis, keepdim)


def nanmedian(x, axis=None, keepdim=False, name=None):
    return _quantile(torch.nanquantile, x, 0.5, axis, keepdim)


def _arg(fn):
    def op(x, axis=None, keepdim=False, dtype="int64"):
        x = as_tensor(x)
        if axis is None:
            r = fn(x.reshape(-1), 0)
        else:
            r = fn(x, int(axis), keepdim=keepdim)
        return r.to(dtypes.to_torch(dtype))

    return op


argmax = _arg(torch.argmax)
argmax.__name__ = "argmax"
argmin = _arg(torch.argmin)
argmin.__name__ = "argmin"


def argsort(x, axis=-1, descending=False):
    x = as_tensor(x)
    idx = torch.argsort(x, dim=axis, stable=True)
    if descending:
        idx = torch.flip(idx, (axis,))
    return idx.to(torch.int32)


def sort(x, axis=-1, descending=False):
    x = as_tensor(x)
    s = torch.sort(x, dim=axis, stable=True).values
    return torch.flip(s, (axis,)) if descending else s


def topk(x, k, axis=-1, largest=True, sorted=True):
    x = as_tensor(x)
    k = int(k)
    key = x if largest else -x
    idx = torch.sort(key, dim=axis, descending=True, stable=True) \
        .indices.narrow(axis, 0, k)
    return torch.gather(x, axis, idx), idx.to(torch.int32)


def _logical(fn):
    def op(x, axis=None, keepdim=False):
        x = as_tensor(x)
        if x.ndim == 0:
            return fn(x)
        return fn(x, _dims(axis, x.ndim), keepdim=keepdim)

    return op


all = _logical(torch.all)
all.__name__ = "all"
any = _logical(torch.any)
any.__name__ = "any"


def cumsum(x, axis=None):
    x = as_tensor(x)
    out = torch.cumsum(x.reshape(-1), 0) if axis is None else \
        torch.cumsum(x, int(axis))
    return _int32(out, x) if x.dtype != torch.bool else out.to(torch.int32)


def cumprod(x, dim=None):
    x = as_tensor(x)
    out = torch.cumprod(x.reshape(-1), 0) if dim is None else \
        torch.cumprod(x, int(dim))
    return _int32(out, x)


def count_nonzero(x, axis=None, keepdim=False):
    x = as_tensor(x)
    return torch.sum(x != 0, _dims(axis, x.ndim), keepdim=keepdim) \
        .to(torch.int32)


def kthvalue(x, k, axis=-1, keepdim=False):
    x = as_tensor(x)
    s, i = torch.sort(x, dim=axis, stable=True)
    v, ix = s.select(axis, k - 1), i.select(axis, k - 1)
    if keepdim:
        v, ix = v.unsqueeze(axis), ix.unsqueeze(axis)
    return v, ix.to(torch.int32)


def mode(x, axis=-1, keepdim=False):
    """The most frequent value along `axis` (the smallest of the most
    frequent): the JAX package's run-length walk over the sorted values."""
    x = as_tensor(x)
    with torch.no_grad():
        s = torch.sort(x, dim=axis).values
        first = torch.zeros_like(s.narrow(axis, 0, 1), dtype=torch.int32)
        same = torch.cat([first, (torch.diff(s, dim=axis) == 0)
                          .to(torch.int32)], axis)
        cs = torch.cumsum(same, axis, dtype=torch.int32)
        run = cs - torch.cumsum(torch.where(same == 0, cs, 0), axis,
                                dtype=torch.int32)
        best = torch.argmax(run, dim=axis, keepdim=True)
        v = torch.take_along_dim(s, best, axis)
        return v if keepdim else v.squeeze(axis)


def unique(x, return_index=False, return_inverse=False, return_counts=False,
           axis=None):
    # dynamic output shape: host-side, as the JAX package's
    x = as_tensor(x)
    res = np.unique(x.numpy(), return_index=return_index,
                    return_inverse=return_inverse,
                    return_counts=return_counts, axis=axis)
    if isinstance(res, tuple):
        return tuple(Tensor(np.asarray(r), place=x.device) for r in res)
    return Tensor(np.asarray(res), place=x.device)


def nonzero(x, as_tuple=False):
    x = as_tensor(x)
    idx = torch.nonzero(x).to(torch.int32)
    if as_tuple:
        return tuple(idx[:, i] for i in range(idx.shape[1]))
    return idx


def bincount(x, weights=None, minlength=0):
    x = as_tensor(x)
    w = None if weights is None else as_tensor(weights)
    out = torch.bincount(x, w, minlength)
    return out.to(torch.int32) if w is None else out.to(w.dtype)


def trapezoid(y, x=None, dx=None, axis=-1, name=None):
    """Trapezoidal integration (paddle.trapezoid)."""
    if x is not None and dx is not None:
        raise ValueError("trapezoid: pass x (coordinates) OR dx "
                         "(uniform spacing), not both")
    y = as_tensor(y)
    if x is not None:
        # the coordinates are constants of the op, as in the JAX package
        return torch.trapezoid(y, as_tensor(x, y).detach().to(y.device),
                               dim=axis)
    return torch.trapezoid(y, dx=1.0 if dx is None else float(dx), dim=axis)

"""Tensor creation ops of the paddle surface: counterpart of
paddle_tpu/ops/creation.py (python/paddle/tensor/creation.py).

New tensors land on the selected place (`core.device.set_device`; the
card when none is selected), ops of a tensor on that tensor's device. The
dtypes are JAX's names over 32-bit storage (`core.dtype`). The ops that
go through `ops.dispatch.apply` in JAX (tril, triu, vander, diagflat,
complex) go through the port's; the others build their tensor directly, as
JAX's do, and are not counted.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import dtype as dtypes
from ..core.device import current_device
from ..core.tensor import Tensor
from .dispatch import apply, as_tensor, unwrap

__all__ = [
    "to_tensor",
    "zeros",
    "ones",
    "full",
    "zeros_like",
    "ones_like",
    "full_like",
    "empty",
    "empty_like",
    "arange",
    "linspace",
    "eye",
    "diag",
    "tril",
    "triu",
    "meshgrid",
    "one_hot",
    "logspace",
    "vander",
    "diagflat",
    "complex",
]


def _t(x) -> Tensor:
    return x.as_subclass(Tensor)


def to_tensor(data, dtype=None, place=None, stop_gradient=True) -> Tensor:
    return Tensor(data, dtype=dtype, stop_gradient=stop_gradient,
                  place=place)


def _shape_tuple(shape):
    if isinstance(shape, torch.Tensor):
        shape = shape.tolist()
    if isinstance(shape, (int, np.integer)):
        return (int(shape),)
    return tuple(int(s) for s in shape)


def zeros(shape, dtype=None) -> Tensor:
    return _t(torch.zeros(_shape_tuple(shape), dtype=dtypes.to_torch(dtype),
                          device=current_device()))


def ones(shape, dtype=None) -> Tensor:
    return _t(torch.ones(_shape_tuple(shape), dtype=dtypes.to_torch(dtype),
                         device=current_device()))


def full(shape, fill_value, dtype=None) -> Tensor:
    if dtype is None and isinstance(fill_value, (bool, int, float)):
        dtype = dtypes.infer_dtype(fill_value)
    return _t(torch.full(_shape_tuple(shape), fill_value,
                         dtype=dtypes.to_torch(dtype),
                         device=current_device()))


def _like_dtype(x, dtype):
    return x.dtype if dtype is None else dtypes.to_torch(dtype)


def zeros_like(x, dtype=None) -> Tensor:
    return _t(torch.zeros(x.shape, dtype=_like_dtype(x, dtype),
                          device=x.device))


def ones_like(x, dtype=None) -> Tensor:
    return _t(torch.ones(x.shape, dtype=_like_dtype(x, dtype),
                         device=x.device))


def full_like(x, fill_value, dtype=None) -> Tensor:
    return _t(torch.full(x.shape, fill_value, dtype=_like_dtype(x, dtype),
                         device=x.device))


def empty(shape, dtype=None) -> Tensor:
    # zeros, as the JAX package's (XLA has no uninitialized memory)
    return zeros(shape, dtype)


def empty_like(x, dtype=None) -> Tensor:
    return zeros_like(x, dtype)


def arange(start=0, end=None, step=1, dtype=None) -> Tensor:
    if end is None:
        start, end = 0, start
    if dtype is None:
        if any(isinstance(v, float) for v in (start, end, step)):
            dtype = dtypes.get_default_dtype()
        else:
            dtype = "int64"
    td = dtypes.to_torch(dtype)
    if td.is_floating_point:
        # jnp.arange over floats: start + i * step, in the dtype
        n = int(np.ceil((end - start) / step))
        i = torch.arange(max(n, 0), dtype=td, device=current_device())
        return _t(torch.full((), start, dtype=td, device=i.device)
                  + i * torch.full((), step, dtype=td, device=i.device))
    return _t(torch.arange(start, end, step, dtype=td,
                           device=current_device()))


def linspace(start, stop, num, dtype=None) -> Tensor:
    td = dtypes.to_torch(dtype)
    num = int(num)
    dev = current_device()
    if num == 1:
        return _t(torch.full((1,), start, dtype=td, device=dev))
    # jnp.linspace: start + i * step in float32, the last point `stop`
    i = torch.arange(num, dtype=torch.float32, device=dev)
    step = (float(stop) - float(start)) / (num - 1)
    out = torch.full((), start, dtype=torch.float32, device=dev) + i * \
        torch.full((), step, dtype=torch.float32, device=dev)
    out[-1] = stop
    return _t(out.to(td))


def eye(num_rows, num_columns=None, dtype=None) -> Tensor:
    m = num_rows if num_columns is None else num_columns
    return _t(torch.eye(int(num_rows), int(m), dtype=dtypes.to_torch(dtype),
                        device=current_device()))


def diag(x, offset=0) -> Tensor:
    return _t(torch.diag(unwrap(as_tensor(x)), offset))


def tril(x, diagonal=0) -> Tensor:
    return apply("tril", lambda a: torch.tril(a, diagonal), as_tensor(x))


def triu(x, diagonal=0) -> Tensor:
    return apply("triu", lambda a: torch.triu(a, diagonal), as_tensor(x))


def meshgrid(*xs):
    ts = [unwrap(as_tensor(x)) for x in xs]
    return tuple(_t(m) for m in torch.meshgrid(*ts, indexing="ij"))


def one_hot(x, num_classes, dtype=None) -> Tensor:
    x = unwrap(as_tensor(x))
    td = dtypes.to_torch(dtype or dtypes.get_default_dtype())
    # jax.nn.one_hot: indices outside [0, num_classes) give zero rows
    col = torch.arange(int(num_classes), device=x.device)
    return _t((x[..., None].long() == col).to(td))


def logspace(start, stop, num, base=10.0, dtype=None, name=None):
    td = dtypes.to_torch(dtype) if dtype is not None else torch.float32
    exps = unwrap(linspace(float(start), float(stop), int(num), "float32"))
    return _t(torch.pow(torch.full((), float(base), device=exps.device),
                        exps).to(td))


def vander(x, n=None, increasing=False, name=None):
    def fn(a):
        m = a.shape[0] if n is None else int(n)
        pw = torch.arange(m, device=a.device)
        if not increasing:
            pw = pw.flip(0)
        if not (a.dtype.is_floating_point or a.dtype.is_complex):
            return a[:, None] ** pw.to(a.dtype)
        return torch.pow(a[:, None], pw.to(a.dtype))

    return apply("vander", fn, as_tensor(x))


def diagflat(x, offset=0, name=None):
    return apply("diagflat", lambda a: torch.diagflat(a, offset),
                 as_tensor(x))


def complex(real, imag, name=None):
    r = as_tensor(real)
    i = as_tensor(imag, r)
    fdt = dtypes.promote_types(r.dtype, i.dtype)
    if not fdt.is_floating_point or torch.finfo(fdt).bits < 32:
        fdt = torch.float32          # complex parts are f32 or f64

    def fn(a, b):
        a, b = torch.broadcast_tensors(a.to(fdt), b.to(fdt))
        return torch.complex(a, b)

    return apply("complex", fn, r, i)

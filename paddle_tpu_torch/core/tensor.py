"""The paddle Tensor of the port: counterpart of paddle_tpu/core/tensor.py.

JAX's `Tensor` wraps a jax array and keeps its own tape. The port's is a
`torch.Tensor` subclass: its storage, ops and autograd are torch's, and it
adds what JAX's has and torch lacks or spells differently:

- `stop_gradient`, the inverse of `requires_grad`, True by default
  (setting it on a non-leaf detaches it in place, as JAX's ops then stop
  recording through it);
- `numpy()` and `__array__` that detach (bf16 comes back as float32:
  numpy has no bfloat16);
- `place`, `astype`, `clear_grad` and `clear_gradient` (the gradient
  becomes None), `set_value`, `name`, `persistable`;
- `backward(grad_tensor, retain_graph)` seeding ones of a non-scalar
  tensor's shape, as JAX's does;
- `register_hook(hook)` with JAX's timing: on a leaf the hook sees the
  leaf's gradient summed over the whole backward, once, before it is
  accumulated into `.grad` (torch's AccumulateGrad hook point); on a
  non-leaf, its cotangent. The hook receives a `Tensor` and returns one or
  None; the handle has `.remove()`.

Any torch op on a `Tensor` returns a `Tensor` (`__torch_function__`), so
the paddle ops and torch's own mix. `Parameter` is also an
`nn.Parameter`, so modules register it; ops on it return `Tensor`s.
Nothing is set on `torch.Tensor` itself: the models, the engine and
`TrainStep` keep plain tensors and pay no per-op Python hook.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.overrides import get_default_nowrap_functions

from . import dtype as dtypes
from .device import Place, current_device

__all__ = ["Tensor", "Parameter", "to_torch_tensor", "as_tensor"]

_NOWRAP = get_default_nowrap_functions()


def _is_input(ret, args, kwargs):
    for a in (*args, *kwargs.values()):
        if a is ret or (isinstance(a, (list, tuple))
                        and any(b is ret for b in a)):
            return True
    return False


def _convert(ret, args=(), kwargs=None):
    """`ret` with its torch tensors as `Tensor`s: a new plain tensor is
    retyped in place (no alias, so it stays a non-view that `detach_`
    takes); a plain tensor handed in as an operand is aliased instead."""
    if type(ret) is torch.Tensor:
        if _is_input(ret, args, kwargs or {}):
            return ret.as_subclass(Tensor)
        ret.__class__ = Tensor
        return ret
    if isinstance(ret, torch.Tensor) and not isinstance(ret, Tensor):
        return ret.as_subclass(Tensor)
    if isinstance(ret, (tuple, list)):
        return type(ret)(_convert(r, args, kwargs) for r in ret)
    return ret


def to_torch_tensor(data, dtype=None, place=None) -> torch.Tensor:
    """A plain torch tensor of `data` (a tensor, numpy array, list or
    scalar) in the canonical storage dtype, on `place` or the selected
    place (a tensor stays on its device unless `place` is given)."""
    if place is None and isinstance(data, torch.Tensor):
        dev = data.device
    else:
        dev = current_device(place)
    if dtype is None:
        dtype = dtypes.infer_dtype(data)
    td = dtypes.to_torch(dtype)
    if isinstance(data, torch.Tensor):
        return data.detach().to(device=dev, dtype=td)
    if isinstance(data, (list, tuple)) and data and all(
            isinstance(d, torch.Tensor) for d in data):
        return torch.stack([d.detach().to(dev) for d in data]).to(td)
    arr = np.asarray(data)
    if arr.dtype == np.float64 and td != torch.float64:
        arr = arr.astype(np.float32) if td == torch.float32 else arr
    return torch.as_tensor(arr).to(device=dev, dtype=td)


class Tensor(torch.Tensor):
    """The eager paddle tensor: a torch tensor with paddle's surface."""

    name = ""
    persistable = False

    def __new__(cls, data=None, dtype=None, stop_gradient: bool = True,
                name: str = "", place=None):
        if data is None:
            data = []
        t = to_torch_tensor(data, dtype, place)
        out = torch.Tensor._make_subclass(cls, t, not stop_gradient)
        if name:
            out.name = name
        return out

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        with torch._C.DisableTorchFunctionSubclass():
            ret = func(*args, **kwargs)
        return ret if func in _NOWRAP else _convert(ret, args, kwargs)

    # -- autograd ----------------------------------------------------------
    @property
    def stop_gradient(self) -> bool:
        return not self.requires_grad

    @stop_gradient.setter
    def stop_gradient(self, value: bool):
        if value and self.grad_fn is not None:
            self.detach_()
        else:
            self.requires_grad_(not value)

    def backward(self, grad_tensor=None, retain_graph: bool = False):
        from .autograd import run_backward

        run_backward(self, grad_tensor, retain_graph=retain_graph)

    @property
    def grad(self):
        g = torch._C.TensorBase.grad.__get__(self)
        return None if g is None else _convert(g)

    @grad.setter
    def grad(self, value):
        torch._C.TensorBase.grad.__set__(self, value)

    def clear_grad(self):
        self.grad = None

    def clear_gradient(self):  # reference spelling
        self.grad = None

    def register_hook(self, hook):
        def torch_hook(g, _hook=hook):
            out = _hook(g.as_subclass(Tensor))
            return None if out is None else torch.as_tensor(out)

        return torch.Tensor.register_hook(self, torch_hook)

    # -- paddle spellings ----------------------------------------------------
    @property
    def place(self) -> Place:
        return Place.of(self.device)

    def astype(self, dtype) -> "Tensor":
        from ..ops.math import cast

        return cast(self, dtype)

    def set_value(self, value):
        with torch.no_grad():
            src = value if isinstance(value, torch.Tensor) else \
                torch.as_tensor(np.asarray(value))
            self.copy_(src.to(device=self.device, dtype=self.dtype)
                       .reshape(self.shape))
        return self

    # -- host interop --------------------------------------------------------
    def numpy(self) -> np.ndarray:
        t = self.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return torch.Tensor.numpy(t.cpu())

    def __array__(self, dtype=None, copy=None):
        a = self.numpy()
        return a.astype(dtype) if dtype is not None else a


class Parameter(Tensor, torch.nn.Parameter):
    """Trainable tensor: paddle's Parameter/EagerParamBase, and an
    `nn.Parameter`, so modules register it. `stop_gradient` is
    `not trainable`; it is persistable."""

    persistable = True
    trainable = True

    def __new__(cls, data, dtype=None, name: str = "",
                trainable: bool = True):
        t = to_torch_tensor(data, dtype)
        out = torch.Tensor._make_subclass(cls, t, bool(trainable))
        if name:
            out.name = name
        out.trainable = bool(trainable)
        return out

    def __repr__(self):
        plain = self.detach().as_subclass(torch.Tensor)
        return f"Parameter containing:\n{plain!r}"

    __torch_function__ = classmethod(Tensor.__torch_function__.__func__)

    def __deepcopy__(self, memo):
        if id(self) not in memo:
            memo[id(self)] = Parameter(self.detach().clone(),
                                       name=self.name,
                                       trainable=self.trainable)
        return memo[id(self)]


def as_tensor(x, ref=None):
    """Coerce an op's operand to a `Tensor` (JAX's `dispatch.as_tensor`):
    a tensor passes (a plain one as a `Tensor` view); a Python scalar
    takes the dtype of `ref` where `ref` is inexact, or where both are
    integers (paddle's scalar promotion: `x * 2.0` keeps x's dtype), and
    `ref`'s device; anything else becomes a new tensor."""
    if isinstance(x, Tensor):
        return x
    if isinstance(x, torch.Tensor):
        return x.as_subclass(Tensor)
    if ref is not None and isinstance(x, (bool, int, float)):
        if ref.dtype.is_floating_point or ref.dtype.is_complex or (
                isinstance(x, int) and not isinstance(x, bool)
                and dtypes.is_integer(ref.dtype)):
            return torch.full((), x, dtype=ref.dtype,
                              device=ref.device).as_subclass(Tensor)
        return Tensor(x, place=ref.device)
    return Tensor(x)

"""The paddle Tensor of the port: counterpart of paddle_tpu/core/tensor.py.

JAX's `Tensor` wraps a jax array and keeps its own tape. The port's is a
`torch.Tensor` subclass: its storage, ops and autograd are torch's, and it
adds what JAX's has and torch lacks or spells differently:

- `stop_gradient`, the inverse of `requires_grad`, True by default
  (setting it on a non-leaf detaches it in place, as JAX's ops then stop
  recording through it);
- `numpy()` and `__array__` that detach (bf16 comes back as float32:
  numpy has no bfloat16);
- `place`, `clear_grad` and `clear_gradient` (the gradient becomes
  None), `set_value`, `name`, `persistable`;
- `backward(grad_tensor, retain_graph)` seeding ones of a non-scalar
  tensor's shape, as JAX's does;
- `register_hook(hook)` with JAX's timing: on a leaf the hook sees the
  leaf's gradient summed over the whole backward, once, before it is
  accumulated into `.grad` (torch's AccumulateGrad hook point); on a
  non-leaf, its cotangent. The hook receives a `Tensor` and returns one or
  None; the handle has `.remove()`.

The paddle methods and dunders (`transpose(perm)`, `astype`, `x + y`
through `paddle.add`, ...) are installed by `ops.tensor_methods`. Any
torch function on a `Tensor` runs on plain views of it and returns a
`Tensor` (`__torch_function__`), so torch's own code never meets paddle's
methods. `Parameter` is also an `nn.Parameter`, so modules register it;
ops on it return `Tensor`s. Nothing is set on `torch.Tensor` itself: the
models, the engine and `TrainStep` keep plain tensors, pay no per-op
Python hook, and take plain views of what they are given (`plain`,
`plain_entry`).
"""
from __future__ import annotations

import copy
import functools

import numpy as np
import torch
from torch.overrides import get_default_nowrap_functions

from . import dtype as dtypes
from .device import Place, current_device

__all__ = ["Tensor", "Parameter", "to_torch_tensor", "plain", "to_paddle",
           "plain_entry"]

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


# functions of a tensor's own state (in-place ops, attribute reads and
# writes, autograd metadata, `torch.autograd.grad`'s inputs): they run on
# the object itself, not on a plain alias, whose own grad_fn, grad and
# view state are the alias's
_OWN_STATE = {"__setitem__", "retain_grad", "register_hook", "backward",
              "register_post_accumulate_grad_hook", "__reduce_ex__",
              "__deepcopy__", "__setstate__", "share_memory_", "__get__",
              "__set__", "__delete__", "_is_view", "grad"}


_MODE = {}                      # func -> 0 plain views, 1 own state, 2 nowrap


def _mode(func):
    try:
        return _MODE[func]
    except (KeyError, TypeError):
        pass
    n = getattr(func, "__name__", "")
    mode = 2 if func in _NOWRAP else int(
        (n.endswith("_") and not n.endswith("__")) or n.startswith("__i")
        or n in _OWN_STATE)
    try:
        _MODE[func] = mode
    except TypeError:
        pass
    return mode


def _plain_tree(x, views):
    if isinstance(x, Tensor):
        v = x.as_subclass(torch.Tensor)
        views[id(v)] = x
        return v
    if isinstance(x, (list, tuple)) and any(isinstance(a, Tensor)
                                            for a in x):
        return type(x)(_plain_tree(a, views) for a in x)
    return x


def _back(ret, views, args, kwargs):
    if isinstance(ret, torch.Tensor) and id(ret) in views:
        return views[id(ret)]
    if isinstance(ret, (tuple, list)) and not hasattr(ret, "_fields") \
            and type(ret) in (tuple, list):
        return type(ret)(_back(r, views, args, kwargs) for r in ret)
    return _convert(ret, args, kwargs)


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
        """torch's function on plain views of the `Tensor` operands, its
        new tensors retyped to `Tensor`: torch's own Python code inside
        `func` then meets torch's methods, never paddle's. Functions that
        change their tensor's own state (in-place ops, hooks) run on the
        object itself; an operand that comes back is returned as itself."""
        kwargs = kwargs or {}
        mode = _mode(func)
        if mode:
            with torch._C.DisableTorchFunctionSubclass():
                ret = func(*args, **kwargs)
            return ret if mode == 2 or not isinstance(
                ret, (torch.Tensor, tuple, list)) else _convert(
                    ret, args, kwargs)
        views = {}
        pargs = tuple(_plain_tree(a, views) for a in args)
        pkw = {k: _plain_tree(v, views) for k, v in kwargs.items()}
        with torch._C.DisableTorchFunctionSubclass():
            ret = func(*pargs, **pkw)
        return _back(ret, views, pargs, pkw)

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

    def set_value(self, value):
        with torch.no_grad():
            src = value if isinstance(value, torch.Tensor) else \
                torch.as_tensor(np.asarray(value))
            self.copy_(src.to(device=self.device, dtype=self.dtype)
                       .reshape(self.shape))
        return self

    def __repr__(self, *, tensor_contents=None):
        body = repr(self.detach().as_subclass(torch.Tensor))
        body = "Tensor" + body[len("tensor"):]
        if self.requires_grad:
            body = body[:-1] + ", stop_gradient=False)"
        return body

    def __deepcopy__(self, memo):
        """A copy of the data and of the Python attributes (`name`,
        `persistable`), still a `Tensor` (torch's default needs
        `new_empty` to keep the subclass)."""
        if id(self) not in memo:
            data = self.detach().as_subclass(torch.Tensor).clone()
            out = torch.Tensor._make_subclass(type(self), data,
                                              self.requires_grad)
            memo[id(self)] = out
            out.__dict__.update(copy.deepcopy(self.__dict__, memo))
        return memo[id(self)]

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


def _has_paddle(x):
    if isinstance(x, Tensor):
        return True
    if isinstance(x, (list, tuple)):
        return any(_has_paddle(a) for a in x)
    if isinstance(x, dict):
        return any(_has_paddle(a) for a in x.values())
    return False


def plain(x):
    """`x` with every `Tensor` in it (lists, tuples and dicts walked) as a
    plain torch alias on the same autograd graph: what the port's own
    modules take, so paddle's methods never reach their code."""
    if isinstance(x, Tensor):
        return x.as_subclass(torch.Tensor)
    if isinstance(x, (list, tuple)) and _has_paddle(x):
        return type(x)(plain(a) for a in x)
    if isinstance(x, dict) and _has_paddle(x):
        return {k: plain(v) for k, v in x.items()}
    return x


def to_paddle(x):
    """`x` with its plain torch tensors retyped to `Tensor`."""
    if type(x) is torch.Tensor:
        return x.as_subclass(Tensor)
    if isinstance(x, tuple) and not hasattr(x, "_fields"):
        return tuple(to_paddle(a) for a in x)
    if isinstance(x, list):
        return [to_paddle(a) for a in x]
    if isinstance(x, dict):
        return {k: to_paddle(v) for k, v in x.items()}
    return x


def _paddle_slots(module):
    """(submodule, table, name, tensor) of every `Tensor` parameter or
    buffer of `module`."""
    return [(m, table, n, t) for m in module.modules()
            for table in (m._parameters, m._buffers)
            for n, t in table.items() if isinstance(t, Tensor)]


def plain_entry(what=None):
    """Decorate a port module's `forward` to run on plain tensors: the
    arguments as plain aliases, and for the call's duration each `Tensor`
    parameter or buffer of the module swapped for its plain alias (the
    gradients still reach the `Parameter`s). The outputs are `Tensor`s when
    a `Tensor` was given. `what` names a module that calls torch directly:
    it raises under an enabled `amp.auto_cast` (one check a call)."""
    def deco(forward):
        @functools.wraps(forward)
        def wrapper(self, *args, **kwargs):
            if what is not None:
                from ..amp.auto_cast import refuse_under_auto_cast

                refuse_under_auto_cast(what)
            given = _has_paddle(args) or _has_paddle(kwargs)
            slots = _paddle_slots(self)
            if not given and not slots:
                return forward(self, *args, **kwargs)
            for m, table, n, t in slots:
                table[n] = t.as_subclass(torch.Tensor)
            try:
                out = forward(self, *plain(args), **plain(kwargs))
            finally:
                for m, table, n, t in slots:
                    table[n] = t
            return to_paddle(out) if given else out

        return wrapper

    return deco

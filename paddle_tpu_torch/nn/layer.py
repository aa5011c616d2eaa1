"""`ParamAttr` and `Layer`: counterpart of paddle_tpu/nn/layer.py
(paddle.nn.Layer, python/paddle/fluid/dygraph/layers.py).

`Layer` is a `torch.nn.Module`, so that the port's optimizers, `TrainStep`,
the clips and `models/convert.py` take it as they take the models, and a
`Layer` and a torch module nest either way. It carries JAX's surface with
JAX's meanings where the two collide:

- `parameters()`, `buffers()` and `sublayers()` return lists;
  `named_parameters`/`named_buffers` take `include_sublayers` (torch's
  `recurse`); the order is JAX's (own entries, then each sublayer's).
- `state_dict(include_sublayers, structured_name_prefix)` gives the
  parameters and the persistable buffers themselves (not detached copies),
  and `set_state_dict` copies numpy arrays or tensors into them and returns
  `(missing, unexpected)`.
- `register_buffer(name, tensor, persistable=True)`: torch's `persistent`.
- `to(device=None, dtype=None, blocking=None)` casts the floating
  parameters and buffers in place (the parameter objects stay, so an
  optimizer built over them keeps them) and moves them to `device`.
- `apply(fn)` visits the layer first, then its sublayers (JAX's pre-order;
  torch's visits the children first).
- `register_forward_post_hook` is torch's forward hook, with JAX's call
  `hook(layer, inputs, output)`; the handles' `.remove()` is torch's.
- A call given paddle `Tensor`s gives `Tensor`s; a call given only plain
  torch tensors runs on plain aliases of the parameters and gives plain
  tensors, as the op dispatch does.

torch's own machinery keeps working: torch calls `state_dict` on a child
with its keywords (`destination`, `prefix`, `keep_vars`), which go to
`torch.nn.Module.state_dict`; `load_state_dict`, `deepcopy`, `.cuda()` and
`.to()` of a torch parent walk `_parameters`, `_buffers` and `_modules`
(`_apply`, `_load_from_state_dict`), which `Layer` does not override.

`create_parameter` builds the port's `core.tensor.Parameter` on the
selected place (`core.device.current_device`): the card unless
`set_device('cpu')`, raising where there is none; a layer built with the
port's `device=` keyword puts its parameters there instead.
"""
from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

from ..core import dtype as dtypes
from ..core.device import current_device
from ..core.tensor import Parameter, Tensor, _has_paddle, _paddle_slots

__all__ = ["ParamAttr", "Layer"]


class ParamAttr:
    """Analog of paddle.ParamAttr."""

    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable

    @staticmethod
    def _to_attr(attr):
        if attr is None or attr is True:
            return ParamAttr()
        if attr is False:
            return None
        if isinstance(attr, ParamAttr):
            return attr
        # an Initializer instance
        return ParamAttr(initializer=attr)


def refuse_ignored(what, flag):
    """Raise for an option that JAX's layer takes and ignores, so computes
    the wrong thing (ROADMAP Queue C 29), when `flag` is set."""
    if flag:
        raise NotImplementedError(
            f"{what}: the JAX package ignores it (ROADMAP Queue C 29)")


def _is_dtype(x):
    if isinstance(x, torch.dtype):
        return True
    if isinstance(x, str):
        try:
            dtypes.canonical_name(x)
            return True
        except TypeError:
            return False
    return False


class Layer(torch.nn.Module):
    def __init__(self, name_scope=None, dtype="float32"):
        super().__init__()
        self._dtype = dtypes.canonical_name(dtype)
        self._name_scope = name_scope or self.__class__.__name__.lower()
        # the port's `device=` keyword of a layer's constructor: where its
        # parameters and buffers are made (None: the selected place)
        self._place = None

    def _device(self):
        return current_device(self._place)

    # -- parameter management ----------------------------------------------
    def create_parameter(self, shape, attr=None, dtype=None, is_bias=False,
                         default_initializer=None):
        """Analog of Layer.create_parameter (dygraph/layers.py): None when
        `attr` is False; else a `Parameter` drawn by `attr`'s initializer,
        `default_initializer`, or XavierNormal (Constant(0) for a bias)."""
        from . import initializer as I

        attr = ParamAttr._to_attr(attr)
        if attr is None:
            return None
        dtype = dtypes.canonical_name(dtype or self._dtype)
        init = attr.initializer or default_initializer
        if init is None:
            init = I.Constant(0.0) if is_bias else I.XavierNormal()
        data = init(shape, dtype, device=self._device())
        p = Parameter(data, dtype=dtype, name=attr.name or "",
                      trainable=attr.trainable)
        p.optimize_attr = {"learning_rate": attr.learning_rate}
        return p

    def add_parameter(self, name, parameter):
        self.register_parameter(name, parameter)
        return parameter

    def add_sublayer(self, name, sublayer):
        self.add_module(name, sublayer)
        return sublayer

    def register_buffer(self, name, tensor, persistable=True,
                        persistent=None):
        """A buffer, in `state_dict` when `persistable` (`persistent` is
        torch's spelling of it). A value that is no tensor becomes a
        `Tensor` on this layer's place."""
        if persistent is not None:
            persistable = persistent
        if tensor is not None and not isinstance(tensor, torch.Tensor):
            tensor = Tensor(tensor, place=self._device())
        if tensor is not None:
            tensor.persistable = persistable
        super().register_buffer(name, tensor, persistent=persistable)
        return tensor

    # -- iteration ---------------------------------------------------------
    def named_parameters(self, prefix="", include_sublayers=True,
                         remove_duplicate=True, recurse=None):
        if recurse is not None:
            include_sublayers = recurse
        return super().named_parameters(prefix, include_sublayers,
                                        remove_duplicate)

    def parameters(self, include_sublayers=True, recurse=None):
        if recurse is not None:
            include_sublayers = recurse
        return [p for _, p in self.named_parameters(
            include_sublayers=include_sublayers)]

    def named_buffers(self, prefix="", include_sublayers=True,
                      remove_duplicate=True, recurse=None):
        if recurse is not None:
            include_sublayers = recurse
        return super().named_buffers(prefix, include_sublayers,
                                     remove_duplicate)

    def buffers(self, include_sublayers=True, recurse=None):
        if recurse is not None:
            include_sublayers = recurse
        return [b for _, b in self.named_buffers(
            include_sublayers=include_sublayers)]

    def sublayers(self, include_self=False):
        mods = list(self.modules())
        return mods if include_self else mods[1:]

    def named_sublayers(self, prefix="", include_self=False):
        it = self.named_modules(prefix=prefix)
        if not include_self:
            next(it)
        yield from it

    def apply(self, fn):
        for layer in self.sublayers(include_self=True):
            fn(layer)
        return self

    # -- state dict ----------------------------------------------------------
    def state_dict(self, include_sublayers=True, structured_name_prefix="",
                   **torch_kwargs):
        """JAX's: the parameters and persistable buffers themselves, by
        structured name. torch's keywords (`destination`, `prefix`,
        `keep_vars`: a torch parent's call) give torch's."""
        if torch_kwargs:
            return super().state_dict(**torch_kwargs)
        out = OrderedDict()
        for n, p in self.named_parameters(
                structured_name_prefix, include_sublayers):
            out[n] = p
        persistent = set(super().state_dict(keep_vars=True))
        for n, b in self.named_buffers(include_sublayers=include_sublayers):
            if n in persistent:
                out[f"{structured_name_prefix}.{n}"
                    if structured_name_prefix else n] = b
        return out

    @torch.no_grad()
    def set_state_dict(self, state_dict, use_structured_name=True):
        own = self.state_dict()
        missing, unexpected = [], []
        for name, t in own.items():
            if name in state_dict:
                v = state_dict[name]
                src = v.detach() if isinstance(v, torch.Tensor) else \
                    torch.as_tensor(np.asarray(v))
                t.copy_(src.to(device=t.device, dtype=t.dtype)
                        .reshape(t.shape))
            else:
                missing.append(name)
        for name in state_dict:
            if name not in own:
                unexpected.append(name)
        return missing, unexpected

    load_dict = set_state_dict
    set_dict = set_state_dict

    # -- dtype / device movement -------------------------------------------
    def to(self, device=None, dtype=None, blocking=None):
        """Cast the floating parameters and buffers to `dtype` and move
        every one to `device`, in place. A dtype given first (torch's
        `.to(torch.bfloat16)`) is taken as the dtype."""
        if device is not None and _is_dtype(device) and dtype is None:
            device, dtype = None, device
        kw = {}
        if device is not None:
            kw["device"] = current_device(device)
        td = None if dtype is None else dtypes.to_torch(dtype)

        def convert(t):
            if td is not None and t.is_floating_point():
                return t.to(dtype=td, **kw)
            return t.to(**kw) if kw else t

        self._apply(convert)
        if dtype is not None:
            for layer in self.sublayers(include_self=True):
                if isinstance(layer, Layer):
                    layer._dtype = dtypes.canonical_name(dtype)
        return self

    def astype(self, dtype):
        return self.to(dtype=dtype)

    def float(self):
        return self.to(dtype="float32")

    def bfloat16(self):
        return self.to(dtype="bfloat16")

    # -- call --------------------------------------------------------------
    def __call__(self, *args, **kwargs):
        """torch's call (hooks, then `forward`). Given no paddle `Tensor`,
        the call runs with each `Tensor` parameter and buffer swapped for
        its plain alias (the gradients still reach the `Parameter`s), so
        that plain torch tensors in give plain tensors out, as the op
        dispatch does: torch code around a layer never meets paddle's
        methods."""
        if _has_paddle(args) or _has_paddle(kwargs):
            return super().__call__(*args, **kwargs)
        slots = _paddle_slots(self)
        if not slots:
            return super().__call__(*args, **kwargs)
        for m, table, n, t in slots:
            table[n] = t.as_subclass(torch.Tensor)
        try:
            return super().__call__(*args, **kwargs)
        finally:
            for m, table, n, t in slots:
                table[n] = t

    # -- hooks -------------------------------------------------------------
    def register_forward_post_hook(self, hook):
        """`hook(layer, inputs, output)` after each forward; a value it
        returns replaces the output."""
        return self.register_forward_hook(hook)

    # -- misc --------------------------------------------------------------
    def full_name(self):
        return self._name_scope

    def clear_gradients(self):
        for p in self.parameters():
            p.grad = None

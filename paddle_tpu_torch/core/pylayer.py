"""PyLayer: user-defined autograd ops, counterpart of
paddle_tpu/core/pylayer.py (python/paddle/autograd/py_layer.py).

    class cus_tanh(PyLayer):
        @staticmethod
        def forward(ctx, x):
            y = paddle.tanh(x)
            ctx.save_for_backward(y)
            return y

        @staticmethod
        def backward(ctx, dy):
            y, = ctx.saved_tensor()
            return dy * (1 - paddle.square(y))

    out = cus_tanh.apply(x)

Every PyLayer runs through one `torch.autograd.Function`: `forward` runs
without recording, one graph node stands
for it, and its backward calls the user's `backward` with the outputs'
cotangents. The contract is JAX's: `backward` returns one gradient per
differentiable tensor input (a floating tensor that requires grad), in
order, or one per tensor input with None where there is none; any other
count raises. Tensors nested in lists and tuples of the arguments are
inputs too. Without `set_materialize_grads(False)` an output that the loss
does not reach gets a zero cotangent.
"""
from __future__ import annotations

import torch

from .tensor import Tensor

__all__ = ["PyLayer", "PyLayerContext", "PyLayerContextLegacy"]


class PyLayerContext:
    """The `ctx` handed to forward and backward."""

    def __init__(self):
        self._saved = ()
        self.not_inplace_tensors = ()
        self.materialize_grads = True

    def save_for_backward(self, *tensors):
        self._saved = tuple(tensors)

    def saved_tensor(self):
        return self._saved

    # reference-compat alias
    saved_tensors = property(lambda self: self._saved)

    def mark_not_inplace(self, *tensors):
        self.not_inplace_tensors = tuple(tensors)

    def set_materialize_grads(self, value: bool):
        self.materialize_grads = bool(value)


class PyLayerContextLegacy(PyLayerContext):
    pass


def _flatten(obj, out):
    """The tensors of `obj` (nested lists and tuples) into `out`; returns
    `obj` with each replaced by its index in `out`."""
    if isinstance(obj, torch.Tensor):
        out.append(obj)
        return _Slot(len(out) - 1)
    if isinstance(obj, (list, tuple)):
        return type(obj)(_flatten(o, out) for o in obj)
    if isinstance(obj, dict):
        return {k: _flatten(v, out) for k, v in obj.items()}
    return obj


class _Slot:
    __slots__ = ("i",)

    def __init__(self, i):
        self.i = i


def _rebuild(obj, tensors):
    if isinstance(obj, _Slot):
        return tensors[obj.i]
    if isinstance(obj, (list, tuple)):
        return type(obj)(_rebuild(o, tensors) for o in obj)
    if isinstance(obj, dict):
        return {k: _rebuild(v, tensors) for k, v in obj.items()}
    return obj


def _differentiable(t):
    return t.requires_grad and (t.dtype.is_floating_point
                                or t.dtype.is_complex)


class _Function(torch.autograd.Function):
    @staticmethod
    def forward(fctx, layer, spec, diff, *tensors):
        ctx = PyLayerContext()
        args, kwargs = _rebuild(spec, tensors)
        outs = layer.forward(ctx, *args, **kwargs)
        fctx.layer, fctx.pctx, fctx.diff_mask = layer, ctx, diff
        fctx.set_materialize_grads(ctx.materialize_grads)
        return outs

    @staticmethod
    def backward(fctx, *grads):
        layer, ctx = fctx.layer, fctx.pctx
        grads = [None if g is None else g.as_subclass(Tensor)
                 for g in grads]
        with torch.no_grad():
            gin = layer.backward(ctx, *grads)
        gin = list(gin) if isinstance(gin, (tuple, list)) else [gin]
        diff = fctx.diff_mask
        if len(gin) != len(diff):
            if len(gin) != sum(diff):
                raise RuntimeError(
                    f"{layer.__name__}.backward returned {len(gin)} grads "
                    f"for {sum(diff)} differentiable inputs")
            it = iter(gin)
            gin = [next(it) if m else None for m in diff]
        return (None, None, None,
                *[g if m else None for g, m in zip(gin, diff)])


class PyLayer:
    @staticmethod
    def forward(ctx, *args, **kwargs):
        raise NotImplementedError("PyLayer subclasses must define forward")

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError("PyLayer subclasses must define backward")

    @classmethod
    def apply(cls, *args, **kwargs):
        tensors = []
        spec = _flatten((args, kwargs), tensors)
        if not (torch.is_grad_enabled()
                and any(_differentiable(t) for t in tensors)):
            with torch.no_grad():
                return cls.forward(PyLayerContext(), *args, **kwargs)
        diff = [_differentiable(t) for t in tensors]
        return _Function.apply(cls, spec, diff, *tensors)

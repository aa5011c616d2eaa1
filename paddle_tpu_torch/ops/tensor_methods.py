"""The paddle Tensor methods: counterpart of the installation in
paddle_tpu/ops/__init__.py.

JAX's dunders and named methods are set on the port's `Tensor` (and so on
`Parameter`), never on `torch.Tensor`. Several names mean something else
in torch (`transpose(perm)`, `split(num)`, `gather`/`scatter`/
`index_select`'s argument order, `where` with `self` the condition,
`equal`/`allclose` returning tensors, `numel` a tensor, `sort` and
`max`/`min` with an axis returning values only, `cumsum(axis=None)`,
`norm`, `softmax`, `expand`). They do not leak into torch's own code:
`Tensor.__torch_function__` hands torch plain views, and the port's own
modules take plain views of what they are given (`core.tensor.plain`).
The set of installed names is the op schema's `tensor_method: true` set.
"""
from __future__ import annotations

import torch

from ..core.tensor import Tensor
from . import activation, linalg, manipulation, math, reduction

__all__ = ["install", "METHODS"]

m, r, mp, lg, act = math, reduction, manipulation, linalg, activation

METHODS = {
    "add": m.add, "subtract": m.subtract, "multiply": m.multiply,
    "divide": m.divide, "mod": m.mod, "pow": m.pow,
    "maximum": m.maximum, "minimum": m.minimum,
    "exp": m.exp, "log": m.log, "sqrt": m.sqrt, "rsqrt": m.rsqrt,
    "abs": m.abs, "sign": m.sign, "floor": m.floor, "ceil": m.ceil,
    "round": m.round, "reciprocal": m.reciprocal, "square": m.square,
    "sin": m.sin, "cos": m.cos, "tan": m.tan, "tanh": m.tanh,
    "erf": m.erf, "clip": m.clip, "scale": m.scale, "cast": m.cast,
    "astype": m.cast, "isnan": m.isnan, "isinf": m.isinf,
    "isfinite": m.isfinite, "equal": m.equal, "not_equal": m.not_equal,
    "less_than": m.less_than, "greater_than": m.greater_than,
    "logical_and": m.logical_and, "logical_or": m.logical_or,
    "logical_not": m.logical_not, "where": m.where,
    # reductions
    "sum": r.sum, "mean": r.mean, "max": r.max, "min": r.min,
    "prod": r.prod, "std": r.std, "var": r.var,
    "argmax": r.argmax, "argmin": r.argmin, "argsort": r.argsort,
    "sort": r.sort, "topk": r.topk, "all": r.all, "any": r.any,
    "cumsum": r.cumsum, "cumprod": r.cumprod, "logsumexp": r.logsumexp,
    "unique": r.unique, "nonzero": r.nonzero,
    # manipulation
    "reshape": mp.reshape, "flatten": mp.flatten,
    "squeeze": mp.squeeze, "unsqueeze": mp.unsqueeze,
    "transpose": mp.transpose, "split": mp.split, "chunk": mp.chunk,
    "tile": mp.tile, "expand": mp.expand, "expand_as": mp.expand_as,
    "broadcast_to": mp.broadcast_to, "flip": mp.flip, "roll": mp.roll,
    "gather": mp.gather, "gather_nd": mp.gather_nd,
    "scatter": mp.scatter, "index_select": mp.index_select,
    "masked_select": mp.masked_select, "unbind": mp.unbind,
    "repeat_interleave": mp.repeat_interleave, "numel": mp.numel,
    "pad": mp.pad, "clone": mp.clone,
    # linalg
    "matmul": lg.matmul, "mm": lg.mm, "bmm": lg.bmm, "dot": lg.dot,
    "norm": lg.norm, "dist": lg.dist, "t": lg.t, "trace": lg.trace,
    "cholesky": lg.cholesky, "inverse": lg.inverse,
    # activations
    "softmax": act.softmax, "sigmoid": act.sigmoid, "relu": act.relu,
    # special functions, complex, indexing, the rest
    "frac": m.frac, "lgamma": m.lgamma, "digamma": m.digamma,
    "conj": m.conj, "real": m.real, "imag": m.imag,
    "angle": m.angle, "sgn": m.sgn, "logit": m.logit,
    "erfinv": m.erfinv, "expm1": m.expm1, "fmax": m.fmax,
    "fmin": m.fmin, "remainder": m.remainder, "fmod": m.fmod,
    "copysign": m.copysign, "hypot": m.hypot,
    "isclose": m.isclose, "allclose": m.allclose,
    "equal_all": m.equal_all, "multiply_": m.multiply_,
    "take": mp.take, "diff": mp.diff, "swapaxes": mp.swapaxes,
    "swapdims": mp.swapdims,
    "as_strided": mp.as_strided, "bucketize": mp.bucketize,
    "nanmedian": r.nanmedian, "trapezoid": r.trapezoid,
    "cov": lg.cov, "corrcoef": lg.corrcoef,
}

DUNDERS = {
    "__add__": lambda s, o: m.add(s, o),
    "__radd__": lambda s, o: m.add(o, s),
    "__sub__": lambda s, o: m.subtract(s, o),
    "__rsub__": lambda s, o: m.subtract(o, s),
    "__mul__": lambda s, o: m.multiply(s, o),
    "__rmul__": lambda s, o: m.multiply(o, s),
    "__truediv__": lambda s, o: m.divide(s, o),
    "__rtruediv__": lambda s, o: m.divide(o, s),
    "__floordiv__": lambda s, o: m.floor_divide(s, o),
    "__mod__": lambda s, o: m.mod(s, o),
    "__pow__": lambda s, o: m.pow(s, o),
    "__rpow__": lambda s, o: m.pow(o, s),
    "__matmul__": lambda s, o: lg.matmul(s, o),
    "__rmatmul__": lambda s, o: lg.matmul(o, s),
    "__neg__": lambda s: m.neg(s),
    "__abs__": lambda s: m.abs(s),
    "__invert__": lambda s: m.logical_not(s),
    "__eq__": lambda s, o: m.equal(s, o),
    "__ne__": lambda s, o: m.not_equal(s, o),
    "__lt__": lambda s, o: m.less_than(s, o),
    "__le__": lambda s, o: m.less_equal(s, o),
    "__gt__": lambda s, o: m.greater_than(s, o),
    "__ge__": lambda s, o: m.greater_equal(s, o),
    "__and__": lambda s, o: m.logical_and(s, o),
    "__or__": lambda s, o: m.logical_or(s, o),
    "__xor__": lambda s, o: m.logical_xor(s, o),
    "__getitem__": lambda s, item: mp.getitem(s, item),
    "__setitem__": lambda s, item, v: mp.setitem(s, item, v),
}


def install():
    for name, fn in {**DUNDERS, **METHODS}.items():
        setattr(Tensor, name, fn)
    # a class that defines __eq__ loses its __hash__; modules dedup their
    # parameters through a set, so Parameters must stay hashable
    Tensor.__hash__ = torch.Tensor.__hash__
    Tensor.T = property(lambda s: mp.transpose(s))


install()

"""Elementwise and binary math ops of the paddle surface: counterpart of
paddle_tpu/ops/math.py (python/paddle/tensor/math.py), over torch ops,
each through `ops.dispatch.apply` under the JAX package's name.

Operands go through `ops.dispatch.as_tensor` (a Python scalar takes the
other operand's dtype), and two tensors of different dtypes meet at
`core.dtype.promote_types` inside the op, as JAX's `_binary` promotes
them. Autograd is torch's.
"""
from __future__ import annotations

import torch

from ..core import dtype as dtypes
from .dispatch import apply, apply_nograd, as_tensor, const

__all__ = [
    "add", "subtract", "multiply", "divide", "floor_divide", "mod", "pow",
    "maximum", "minimum", "fmax", "fmin", "atan2",
    "exp", "log", "log2", "log10", "log1p", "expm1", "sqrt", "rsqrt",
    "abs", "neg", "sign", "floor", "ceil", "round", "trunc", "reciprocal",
    "sin", "cos", "tan", "asin", "acos", "atan", "sinh", "cosh", "tanh",
    "asinh", "acosh", "atanh", "erf", "erfinv", "square",
    "clip", "scale", "lerp", "addmm",
    "equal", "not_equal", "less_than", "less_equal", "greater_than",
    "greater_equal", "logical_and", "logical_or", "logical_not",
    "logical_xor", "isnan", "isinf", "isfinite", "bitwise_and",
    "bitwise_or", "bitwise_xor", "bitwise_not", "where", "cast",
    "increment", "stanh", "multiplex", "nan_to_num",
    "frac", "sinc", "signbit", "digamma", "lgamma", "i0", "angle", "real",
    "imag", "conj", "sgn", "logit", "polygamma", "copysign", "nextafter",
    "heaviside", "hypot", "logaddexp", "fmod", "remainder", "true_divide",
    "float_power", "isclose", "allclose", "equal_all", "multiply_",
]


def _operands(x, y):
    if isinstance(x, torch.Tensor) and isinstance(y, torch.Tensor):
        return x, y
    if not isinstance(x, torch.Tensor):
        x = as_tensor(x, y if isinstance(y, torch.Tensor) else None)
    return as_tensor(x), as_tensor(y, x)


def _promoting(fn):
    """`fn` on its operands brought to their promoted dtype (inside the
    op, on the plain tensors)."""
    def run(a, b):
        if a.dtype != b.dtype:
            common = dtypes.promote_types(a.dtype, b.dtype)
            a, b = a.to(common), b.to(common)
        return fn(a, b)

    return run


def _binary(name, fn):
    run = _promoting(fn)

    def op(x, y):
        return apply(name, run, *_operands(x, y))

    op.__name__ = name
    return op


def _binary_nograd(name, fn):
    def op(x, y):
        return apply_nograd(name, fn, *_operands(x, y))

    op.__name__ = name
    return op


def _unary(opname, fn, nograd=False):
    ap = apply_nograd if nograd else apply

    def op(x, name=None):
        return ap(opname, fn, as_tensor(x))

    op.__name__ = opname
    return op


def _scalar(v, ref):
    """A Python scalar operand of `ref`'s op: itself where torch's op
    rounds it as JAX does (f32 and integer tensors), else a 0-d tensor of
    `ref`'s dtype (JAX rounds a weak scalar to a bf16 or f16 operand)."""
    if isinstance(v, torch.Tensor) or ref.dtype not in (torch.bfloat16,
                                                        torch.float16):
        return v
    return torch.full((), v, dtype=ref.dtype, device=ref.device)


add = _binary("add", torch.add)
subtract = _binary("subtract", torch.sub)
multiply = _binary("multiply", torch.mul)
divide = _binary("divide", torch.true_divide)
floor_divide = _binary_nograd("floor_divide", torch.floor_divide)
mod = _binary("mod", torch.remainder)
pow = _binary("pow", torch.pow)
maximum = _binary("maximum", torch.maximum)
minimum = _binary("minimum", torch.minimum)
fmax = _binary("fmax", torch.fmax)
fmin = _binary("fmin", torch.fmin)
atan2 = _binary("atan2", torch.atan2)

exp = _unary("exp", torch.exp)
log = _unary("log", torch.log)
log2 = _unary("log2", torch.log2)
log10 = _unary("log10", torch.log10)
log1p = _unary("log1p", torch.log1p)
expm1 = _unary("expm1", torch.expm1)
sqrt = _unary("sqrt", torch.sqrt)
rsqrt = _unary("rsqrt", torch.rsqrt)
abs = _unary("abs", torch.abs)
neg = _unary("neg", torch.neg)
sign = _unary("sign", torch.sign)
floor = _unary("floor", torch.floor)
ceil = _unary("ceil", torch.ceil)
round = _unary("round", torch.round)
trunc = _unary("trunc", torch.trunc)
reciprocal = _unary("reciprocal", torch.reciprocal)
sin = _unary("sin", torch.sin)
cos = _unary("cos", torch.cos)
tan = _unary("tan", torch.tan)
asin = _unary("asin", torch.asin)
acos = _unary("acos", torch.acos)
atan = _unary("atan", torch.atan)
sinh = _unary("sinh", torch.sinh)
cosh = _unary("cosh", torch.cosh)
tanh = _unary("tanh", torch.tanh)
asinh = _unary("asinh", torch.asinh)
acosh = _unary("acosh", torch.acosh)
atanh = _unary("atanh", torch.atanh)
erf = _unary("erf", torch.erf)
erfinv = _unary("erfinv", torch.erfinv)
square = _unary("square", torch.square)


def clip(x, min=None, max=None):
    lo, hi = const(min), const(max)
    return apply("clip", lambda a: torch.clamp(a, lo, hi), as_tensor(x))


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None):
    x = as_tensor(x)
    s, b = _scalar(float(scale), x), _scalar(float(bias), x)
    if bias_after_scale:
        out = apply("scale", lambda a: a * s + b, x)
    else:
        out = apply("scale", lambda a: (a + b) * s, x)
    if act is not None:
        from . import activation

        out = getattr(activation, act)(out)
    return out


def lerp(x, y, weight):
    x, y = as_tensor(x), as_tensor(y)
    w = const(_scalar(weight, x))
    return apply("lerp", lambda a, b: a + w * (b - a), x, y)


def addmm(input, x, y, beta=1.0, alpha=1.0):
    input, x, y = as_tensor(input), as_tensor(x), as_tensor(y)
    b, al = _scalar(beta, input), _scalar(alpha, x)
    return apply("addmm", lambda i, p, q: b * i + al * torch.matmul(p, q),
                 input, x, y)


equal = _binary_nograd("equal", torch.eq)
not_equal = _binary_nograd("not_equal", torch.ne)
less_than = _binary_nograd("less_than", torch.lt)
less_equal = _binary_nograd("less_equal", torch.le)
greater_than = _binary_nograd("greater_than", torch.gt)
greater_equal = _binary_nograd("greater_equal", torch.ge)
logical_and = _binary_nograd("logical_and", torch.logical_and)
logical_or = _binary_nograd("logical_or", torch.logical_or)
logical_xor = _binary_nograd("logical_xor", torch.logical_xor)
bitwise_and = _binary_nograd("bitwise_and", torch.bitwise_and)
bitwise_or = _binary_nograd("bitwise_or", torch.bitwise_or)
bitwise_xor = _binary_nograd("bitwise_xor", torch.bitwise_xor)


def logical_not(x):
    return apply_nograd("logical_not", torch.logical_not, as_tensor(x))


def bitwise_not(x):
    return apply_nograd("bitwise_not", torch.bitwise_not, as_tensor(x))


def isnan(x):
    return apply_nograd("isnan", torch.isnan, as_tensor(x))


def isinf(x):
    return apply_nograd("isinf", torch.isinf, as_tensor(x))


def isfinite(x):
    return apply_nograd("isfinite", torch.isfinite, as_tensor(x))


def where(condition, x=None, y=None):
    if x is None and y is None:
        c = as_tensor(condition)
        idx = torch.nonzero(c.as_subclass(torch.Tensor), as_tuple=True)
        return tuple(i.as_subclass(type(c)) for i in idx)
    cond = as_tensor(condition).as_subclass(torch.Tensor)
    x = as_tensor(x, y if isinstance(y, torch.Tensor) else None)
    y = as_tensor(y, x)
    common = dtypes.promote_types(x.dtype, y.dtype)
    return apply("where", lambda a, b: torch.where(
        cond.to(a.device), a.to(common), b.to(common)), x, y)


def cast(x, dtype):
    x = as_tensor(x)
    td = dtypes.to_torch(dtype)
    inexact = (td.is_floating_point or td.is_complex) and (
        x.dtype.is_floating_point or x.dtype.is_complex)
    return (apply if inexact else apply_nograd)("cast", lambda a: a.to(td),
                                                x)


def increment(x, value=1.0):
    with torch.no_grad():
        x.add_(value)
    return x


def stanh(x, scale_a=0.67, scale_b=1.7159):
    x = as_tensor(x)
    sa, sb = _scalar(scale_a, x), _scalar(scale_b, x)
    return apply("stanh", lambda a: sb * torch.tanh(sa * a), x)


def multiplex(inputs, index):
    ts = [as_tensor(t) for t in inputs]
    idx = as_tensor(index).as_subclass(torch.Tensor).reshape(-1).long()

    def fn(*arrs):
        stacked = torch.stack(arrs, 0)
        rows = torch.arange(stacked.shape[1], device=stacked.device)
        return stacked[idx.to(stacked.device), rows]

    return apply("multiplex", fn, *ts)


def nan_to_num(x, nan=0.0, posinf=None, neginf=None):
    return apply("nan_to_num", lambda a: torch.nan_to_num(
        a, nan=nan, posinf=posinf, neginf=neginf), as_tensor(x))


def _frac(a):
    return a - torch.trunc(a)


def _imag(a):
    if a.is_complex():
        return torch.imag(a)
    # zeros, on the graph of `a` (its gradient zeros, as jnp.imag's)
    return torch.where(torch.zeros_like(a, dtype=torch.bool), a, 0.0)


def _real(a):
    return torch.real(a) if a.is_complex() else a


frac = _unary("frac", _frac)
sinc = _unary("sinc", torch.sinc)
signbit = _unary("signbit", torch.signbit, nograd=True)
digamma = _unary("digamma", torch.digamma)
lgamma = _unary("lgamma", torch.lgamma)
i0 = _unary("i0", torch.i0)
angle = _unary("angle", torch.angle)
real = _unary("real", _real)
imag = _unary("imag", _imag)
conj = _unary("conj", torch.conj_physical)


def sgn(x, name=None):
    """sign for real; x/|x| (0 -> 0) for complex (paddle sgn)."""
    return apply("sgn", torch.sgn, as_tensor(x))


def logit(x, eps=None, name=None):
    def fn(a):
        p = a if eps is None else torch.clamp(a, eps, 1.0 - eps)
        return torch.log(p / (1.0 - p))

    return apply("logit", fn, as_tensor(x))


def polygamma(x, n, name=None):
    return apply("polygamma", lambda a: torch.polygamma(int(n), a),
                 as_tensor(x))


copysign = _binary("copysign", torch.copysign)
nextafter = _binary("nextafter", torch.nextafter)
heaviside = _binary("heaviside", torch.heaviside)
hypot = _binary("hypot", torch.hypot)
logaddexp = _binary("logaddexp", torch.logaddexp)
fmod = _binary("fmod", torch.fmod)
remainder = _binary("remainder", torch.remainder)


def true_divide(x, y, name=None):
    """Always-float division (paddle true_divide)."""
    return apply("true_divide", torch.true_divide, *_operands(x, y))


def float_power(x, y, name=None):
    x, y = _operands(x, y)
    # jnp.float_power's widest float is float32 here (no float64 storage)
    common = dtypes.promote_types(dtypes.promote_types(x.dtype, y.dtype),
                                  torch.float32)
    return apply("float_power",
                 lambda a, b: torch.pow(a.to(common), b.to(common)), x, y)


def isclose(x, y, rtol=1e-5, atol=1e-8, equal_nan=False, name=None):
    return apply_nograd("isclose", lambda a, b: torch.isclose(
        a, b, rtol=rtol, atol=atol, equal_nan=equal_nan),
        as_tensor(x), as_tensor(y))


def allclose(x, y, rtol=1e-5, atol=1e-8, equal_nan=False, name=None):
    return apply_nograd("allclose", lambda a, b: torch.isclose(
        a, b, rtol=rtol, atol=atol, equal_nan=equal_nan).all(),
        as_tensor(x), as_tensor(y))


def equal_all(x, y, name=None):
    def fn(a, b):
        if tuple(a.shape) != tuple(b.shape):
            return torch.zeros((), dtype=torch.bool, device=a.device)
        return (a == b).all()

    return apply_nograd("equal_all", fn, as_tensor(x), as_tensor(y))


def multiply_(x, y, name=None):
    """In-place multiply (paddle inplace-op parity): x <- x * y. As in the
    JAX package, a tensor that requires grad is refused."""
    x = as_tensor(x)
    if x.requires_grad:
        raise RuntimeError(
            "multiply_: in-place op on a tensor that requires grad; use "
            "x = x * y (out-of-place) inside differentiated code")
    with torch.no_grad():
        x.copy_(multiply(x, y))
    return x

"""Dtype registry and promotion: counterpart of paddle_tpu/core/dtype.py.

Dtypes are named by strings that map onto torch dtypes. As in the JAX
package, the 64-bit names are ALIASES of their 32-bit counterparts
("int64" -> int32, "float64" -> float32, "complex128" -> complex64): the
API takes the 64-bit names everywhere (paddle parity, e.g. int64 labels)
and stores 32 bits, so that the port's tensors carry the dtypes the JAX
package reports. torch's index ops want int64 indices; the ops cast
inside the call.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["set_default_dtype", "get_default_dtype", "canonical_name",
           "to_torch", "is_floating", "is_integer", "is_inexact",
           "infer_dtype", "promote_types", "name_of"]

# canonical name -> torch dtype
_DTYPE_MAP = {
    "float32": torch.float32,
    "float64": torch.float64,     # unreachable: aliased to float32
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "int8": torch.int8,
    "int16": torch.int16,
    "int32": torch.int32,
    "int64": torch.int64,         # unreachable: aliased to int32
    "uint8": torch.uint8,
    "uint16": torch.uint16,
    "uint32": torch.uint32,
    "bool": torch.bool,
    "complex64": torch.complex64,
    "complex128": torch.complex128,
}

_ALIASES = {
    "float": "float32",
    "double": "float32",
    "half": "float16",
    "bf16": "bfloat16",
    "fp16": "float16",
    "fp32": "float32",
    "int": "int32",
    "long": "int32",
    # 64-bit -> 32-bit, as the JAX package stores them
    "int64": "int32",
    "uint64": "uint32",
    "float64": "float32",
    "complex128": "complex64",
}

_NAME_OF = {v: k for k, v in _DTYPE_MAP.items()}

_default_dtype = "float32"


def set_default_dtype(d) -> None:
    global _default_dtype
    name = canonical_name(d)
    if name not in ("float32", "float64", "float16", "bfloat16"):
        raise ValueError(f"default dtype must be floating, got {name}")
    _default_dtype = name


def get_default_dtype() -> str:
    return _default_dtype


def name_of(d) -> str:
    """The name of a torch dtype, before aliasing."""
    return _NAME_OF[d]


def canonical_name(d) -> str:
    """Normalise any dtype-ish object (a name, a torch or numpy dtype) to a
    canonical string name."""
    if d is None:
        return _default_dtype
    if isinstance(d, str):
        d = _ALIASES.get(d, d)
        if d in _DTYPE_MAP:
            return d
    if isinstance(d, torch.dtype):
        if d not in _NAME_OF:
            raise TypeError(f"unsupported dtype: {d!r}")
        name = _NAME_OF[d]
    else:
        try:
            name = np.dtype(d).name
        except TypeError as e:
            raise TypeError(f"unsupported dtype: {d!r}") from e
    name = _ALIASES.get(name, name)
    if name not in _DTYPE_MAP:
        raise TypeError(f"unsupported dtype: {d!r}")
    return name


def to_torch(d) -> torch.dtype:
    """Any dtype-ish -> the torch dtype that stores it."""
    return _DTYPE_MAP[canonical_name(d)]


def is_floating(d) -> bool:
    return to_torch(d).is_floating_point


def is_integer(d) -> bool:
    t = to_torch(d)
    return not (t.is_floating_point or t.is_complex or t == torch.bool)


def is_inexact(d) -> bool:
    t = to_torch(d)
    return t.is_floating_point or t.is_complex


def promote_types(a, b) -> torch.dtype:
    """The common dtype of two torch dtypes, jnp.promote_types' lattice on
    the dtypes the port stores (it agrees with torch's there)."""
    return torch.promote_types(a, b)


def infer_dtype(value):
    """Dtype for a host value the way the reference's to_tensor does:
    python float -> default float dtype, python int -> int64 (stored
    int32), bool -> bool."""
    if isinstance(value, bool):
        return "bool"
    if isinstance(value, int):
        return "int32"
    if isinstance(value, float):
        return _default_dtype
    if isinstance(value, complex):
        return "complex64"
    if isinstance(value, torch.Tensor):
        return canonical_name(value.dtype)
    arr = np.asarray(value)
    if arr.dtype == np.float64:
        # match paddle.to_tensor: host doubles become default float dtype
        return _default_dtype
    return canonical_name(arr.dtype)

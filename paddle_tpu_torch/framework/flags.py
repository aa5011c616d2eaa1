"""The global FLAGS registry: counterpart of paddle_tpu/framework/flags.py
(paddle.set_flags / get_flags). Flags start from the environment
(`FLAGS_xxx=1`, the reference's export convention).

- `FLAGS_check_nan_inf`: eager ops (`ops.dispatch.apply`) and
  `jit.TrainStep`'s loss and gradients are checked for NaN/Inf;
- `FLAGS_check_nan_inf_level`: 0 raises `FloatingPointError`, 3 warns;
- `FLAGS_cudnn_deterministic`, `FLAGS_embedding_deterministic`: stored
  and read back, and read by nothing else, as in the JAX package.
"""
from __future__ import annotations

import os

__all__ = ["set_flags", "get_flags"]

_DEFAULTS = {
    "FLAGS_check_nan_inf": False,
    "FLAGS_check_nan_inf_level": 0,
    "FLAGS_cudnn_deterministic": False,
    "FLAGS_embedding_deterministic": 0,
}


def _coerce(name, value):
    proto = _DEFAULTS[name]
    if isinstance(proto, bool):
        if isinstance(value, str):
            return value.lower() in ("1", "true", "yes", "on")
        return bool(value)
    if isinstance(proto, int):
        return int(value)
    return value


def _from_environment():
    return {k: _coerce(k, os.environ[k]) if k in os.environ else v
            for k, v in _DEFAULTS.items()}


_FLAGS = _from_environment()


def set_flags(flags: dict):
    """paddle.set_flags: `{'FLAGS_check_nan_inf': 1}`; an unknown name
    raises ValueError."""
    for k, v in flags.items():
        if k not in _DEFAULTS:
            raise ValueError(f"unknown flag {k!r}; known: "
                             f"{sorted(_DEFAULTS)}")
        _FLAGS[k] = _coerce(k, v)


def get_flags(flags):
    """paddle.get_flags: a name or a list of names -> {name: value}."""
    names = [flags] if isinstance(flags, str) else list(flags)
    out = {}
    for k in names:
        if k not in _FLAGS:
            raise ValueError(f"unknown flag {k!r}")
        out[k] = _FLAGS[k]
    return out


def flag(name):
    """A flag's value, for the port's own hot paths."""
    return _FLAGS[name]

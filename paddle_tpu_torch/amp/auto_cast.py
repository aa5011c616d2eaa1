"""AMP autocast: counterpart of paddle_tpu/amp/auto_cast.py.

The casts happen at op dispatch (`ops.dispatch.apply`), by the op's
dispatch name and the lists authored in the op schema (the port's copy
of ops.yaml, `ops.registry`):

- O1: white-list ops take the low dtype, black-list ops fp32, the rest
  what they are given;
- O2: every op takes the low dtype except the black list.

`custom_white_list` / `custom_black_list` add names for one context; the
state is restored on exit, also when contexts nest. The port's own
modules (the models, `nn` layers, `TrainStep`) call torch directly and
raise under an enabled `auto_cast` rather than run fp32 silently.
"""
from __future__ import annotations

import contextlib

import torch

from ..core import dtype as dtypes
from ..ops import registry as _registry

__all__ = ["auto_cast", "amp_state", "maybe_autocast", "WHITE_LIST",
           "BLACK_LIST", "refuse_under_auto_cast"]

WHITE_LIST = set(_registry.amp_white())
BLACK_LIST = set(_registry.amp_black())

_state = {"enabled": False, "dtype": "bfloat16", "level": "O1"}


def amp_state():
    return _state


@contextlib.contextmanager
def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              level="O1", dtype="bfloat16"):
    """paddle.amp.auto_cast."""
    prev = dict(_state)
    _state.update(
        enabled=bool(enable),
        dtype=dtypes.canonical_name(dtype),
        level=level,
        extra_white=frozenset(custom_white_list or ()),
        extra_black=frozenset(custom_black_list or ()),
    )
    try:
        yield
    finally:
        _state.clear()
        _state.update(prev)


def maybe_autocast(op_name, inputs, policy=None):
    """The inputs of op `op_name` cast by the policy: floating inputs to
    fp32 for black-list ops; to the low dtype for white-list ops, and for
    every other op at O2."""
    if not _state["enabled"] or op_name == "amp_cast":
        return inputs
    white = WHITE_LIST | _state.get("extra_white", frozenset())
    black = BLACK_LIST | _state.get("extra_black", frozenset())
    from .cast_helper import cast_tensor_list

    if op_name in black:
        return cast_tensor_list(inputs, torch.float32)
    if op_name in white or _state["level"] == "O2":
        return cast_tensor_list(inputs, dtypes.to_torch(_state["dtype"]))
    return inputs


def refuse_under_auto_cast(what):
    """Raise NotImplementedError if `auto_cast` is enabled: `what` calls
    torch directly, so it would run in fp32 where the JAX package's runs
    in the low dtype."""
    if _state["enabled"]:
        raise NotImplementedError(
            f"{what} under an enabled amp.auto_cast: the port's own modules "
            "call torch directly and are not cast at dispatch yet "
            "(ROADMAP Queue A 13, the nn bullet)")

"""NaN/Inf checks under `FLAGS_check_nan_inf`: counterpart of
paddle_tpu/framework/nan_inf.py (nan_inf_utils.h:37).

- `check_eager(op_name, tensors)`: an eager op's outputs, one host read
  an op (`ops.dispatch.apply` calls it only while the flag is on);
- `check_named(named, where)`: a train step's loss and gradients by
  name, one stacked `isfinite` reduction and one host read (JAX stages
  the same check inside its compiled step).

A detection adds one to `nan_inf_events_total` in the port's metrics
registry, then warns at level 3 and raises `FloatingPointError`
otherwise, with the JAX package's message.
"""
from __future__ import annotations

import warnings

import torch

from .flags import flag

__all__ = ["check_enabled", "check_eager", "check_named"]


def check_enabled():
    return flag("FLAGS_check_nan_inf")


def _report(bad_names, where):
    from ..observability.metrics import get_registry

    get_registry().counter(
        "nan_inf_events_total",
        "NaN/Inf detections (FLAGS_check_nan_inf); each event may "
        "cover several tensors of one op/step.").inc()
    msg = (f"nan/inf detected in {where}: {', '.join(bad_names)} "
           "(FLAGS_check_nan_inf)")
    if flag("FLAGS_check_nan_inf_level") >= 3:
        warnings.warn(msg)
    else:
        raise FloatingPointError(msg)


def _inexact(t):
    return isinstance(t, torch.Tensor) and (t.dtype.is_floating_point
                                            or t.dtype.is_complex)


def check_named(named, where):
    """Check `(name, tensor)` pairs with one host read."""
    named = [(n, t) for n, t in named if _inexact(t)]
    if not named:
        return
    with torch.no_grad():
        ok = torch.stack([torch.isfinite(t.detach()).all().to(
            named[0][1].device) for _, t in named]).cpu().tolist()
    if not all(ok):
        _report([n for (n, _), o in zip(named, ok) if not o], where)


def check_eager(op_name, tensors):
    """An eager op's outputs (`output[i]` names, as in JAX)."""
    check_named([(f"output[{i}]", t) for i, t in enumerate(tensors)],
                f"op '{op_name}'")

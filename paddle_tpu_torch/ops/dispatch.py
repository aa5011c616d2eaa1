"""Op dispatch of the paddle surface: counterpart of
paddle_tpu/ops/dispatch.py.

Every op of the paddle API runs through `apply(name, fn, *inputs)` (or
`apply_nograd` for ops without a gradient), under the JAX package's
dispatch name. In order, `apply`:

1. counts the op in `OpStats.counts` while `OpStats.enabled`;
2. casts the inputs by `amp.auto_cast`'s policy for `name`;
3. runs `fn` on plain `torch.Tensor` views of the inputs, so the torch
   calls inside it never reach `Tensor.__torch_function__` nor paddle's
   Tensor methods (`as_subclass` keeps the autograd graph);
4. checks the outputs for NaN/Inf while `FLAGS_check_nan_inf` is on;
5. calls `OpStats.span_hook(name, start_us, end_us, synced)` when it is
   set, after a `torch.cuda.synchronize` of the outputs' device when
   `OpStats.sync_spans`.

The outputs are retyped to the port's `Tensor` once. A plain torch
tensor in gives a plain torch tensor out: when every tensor input is a
plain torch tensor, the outputs stay plain, so the port's own modules,
which hold plain tensors, never meet paddle's methods. Autograd is
torch's; `apply_nograd` runs `fn` under `torch.no_grad()` and does not
autocast, as in JAX.

JAX's `apply_with_cpu_fallback` (a CPU hop for backends without complex
buffers or host callbacks) has no counterpart: the card has both.
"""
from __future__ import annotations

import time
from typing import Callable

import torch

from ..amp.auto_cast import _state as _amp_state
from ..amp.auto_cast import maybe_autocast
from ..core import dtype as dtypes
from ..core.tensor import Tensor
from ..framework import flags as _flags

__all__ = ["apply", "apply_nograd", "as_tensor", "unwrap", "const",
           "OpStats"]


class OpStats:
    """Per-op dispatch counters and the profiler's span hook.

    `span_hook`, when set, receives `(name, start_us, end_us, synced)`
    for every eager dispatch; `synced=True` means the dispatch waited for
    its outputs (`sync_spans`), so the span covers host dispatch and
    device execution."""

    counts: dict = {}
    enabled = False
    span_hook = None
    sync_spans = False

    @classmethod
    def record(cls, name):
        if cls.enabled:
            cls.counts[name] = cls.counts.get(name, 0) + 1


def as_tensor(x, ref=None):
    """An op's operand as a tensor: a tensor passes as it is (a plain one
    stays plain); a Python scalar takes `ref`'s dtype where `ref` is
    inexact, or where both are integers (`x * 2.0` keeps x's dtype), and
    `ref`'s device and class; anything else becomes a new `Tensor` on
    the selected place."""
    if isinstance(x, torch.Tensor):
        return x
    if ref is not None and isinstance(x, (bool, int, float)):
        paddle = isinstance(ref, Tensor)
        ref = ref.as_subclass(torch.Tensor) if paddle else ref
        if ref.dtype.is_floating_point or ref.dtype.is_complex or (
                isinstance(x, int) and not isinstance(x, bool)
                and dtypes.is_integer(ref.dtype)):
            t = torch.full((), x, dtype=ref.dtype, device=ref.device)
        else:
            t = torch.as_tensor(x, device=ref.device)
            t = t.to(dtypes.to_torch(dtypes.infer_dtype(x)))
        return t.as_subclass(Tensor) if paddle else t
    return Tensor(x)


def unwrap(x):
    """A plain torch view of a `Tensor`; anything else as it is."""
    if isinstance(x, Tensor):
        return x.as_subclass(torch.Tensor)
    return x


def const(x):
    """An operand the op closes over, as JAX closes over a raw array: a
    plain tensor outside autograd (anything else as it is)."""
    if isinstance(x, torch.Tensor):
        return x.detach().as_subclass(torch.Tensor)
    return x


def _plain(inputs):
    return [t.as_subclass(torch.Tensor) if isinstance(t, Tensor) else t
            for t in inputs]


def _retype(out, inputs):
    if type(out) is torch.Tensor:
        for t in inputs:
            if out is t:
                return out.as_subclass(Tensor)
        out.__class__ = Tensor
        return out
    if isinstance(out, (tuple, list)):
        return tuple(_retype(o, inputs) for o in out)
    return out


def _finish(name, out, inputs, paddle):
    outs = out if isinstance(out, (tuple, list)) else (out,)
    if _flags._FLAGS["FLAGS_check_nan_inf"]:
        from ..framework import nan_inf

        nan_inf.check_eager(name, [o for o in outs
                                   if isinstance(o, torch.Tensor)])
    if paddle:
        return _retype(out, inputs)
    return tuple(out) if isinstance(out, list) else out


def _is_paddle(inputs):
    plain = False
    for t in inputs:
        if isinstance(t, Tensor):
            return True
        plain = plain or isinstance(t, torch.Tensor)
    return not plain


def _timed(name, run):
    t0 = time.perf_counter_ns() // 1000
    out = run()
    synced = False
    if OpStats.sync_spans:
        outs = out if isinstance(out, tuple) else (out,)
        devs = {o.device for o in outs if isinstance(o, torch.Tensor)}
        for d in devs:
            if d.type == "cuda":
                torch.cuda.synchronize(d)
        synced = bool(devs)
    OpStats.span_hook(name, t0, time.perf_counter_ns() // 1000, synced)
    return out


def apply(name: str, fn: Callable, *inputs, amp_policy: str = None):
    """Run differentiable op `fn(*plain_tensors)` under dispatch name
    `name`; returns a tensor or a tuple of them."""
    if OpStats.span_hook is not None:
        return _timed(name, lambda: _apply(name, fn, inputs, amp_policy))
    return _apply(name, fn, inputs, amp_policy)


def _apply(name, fn, inputs, amp_policy):
    OpStats.record(name)
    if _amp_state["enabled"]:
        inputs = maybe_autocast(name, inputs, amp_policy)
    plain = _plain(inputs)
    return _finish(name, fn(*plain), plain, _is_paddle(inputs))


def apply_nograd(name: str, fn: Callable, *inputs):
    """Run op `fn(*plain_tensors)` without a gradient (comparisons,
    indices, draws): no autocast, outputs that do not require grad."""
    if OpStats.span_hook is not None:
        return _timed(name, lambda: _apply_nograd(name, fn, inputs))
    return _apply_nograd(name, fn, inputs)


def _apply_nograd(name, fn, inputs):
    OpStats.record(name)
    plain = _plain(inputs)
    with torch.no_grad():
        out = fn(*plain)
    return _finish(name, out, plain, _is_paddle(inputs))

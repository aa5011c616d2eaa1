"""Symmetric absmax int8 quantization: counterpart of `quantize_absmax`
and `dequantize` in paddle_tpu/quantization/__init__.py, on torch tensors.
QAT, PTQ and the observers are not ported (ROADMAP Queue A 13).

The int8 weights of the serving engine quantize each Linear weight per
output channel: torch's weight is `[out, in]`, so `axis=0` keeps one scale
a row (`[out, 1]`), where the JAX package, whose weights are `[in, out]`,
passes `axis=1` for the same scales.
"""
from __future__ import annotations

import torch

__all__ = ["quantize_absmax", "dequantize"]


def quantize_absmax(w, bits=8, axis=None):
    """(int8 codes, scale): scale = max |w| / (2^(bits-1) - 1) over the
    tensor (`axis=None`) or over every axis but `axis` (kept with size 1),
    in w's dtype and floored at 1e-8; codes = clip(round(w / scale),
    -qmax - 1, qmax), rounding half to even."""
    qmax = 2 ** (bits - 1) - 1
    if axis is None:
        scale = w.abs().max() / qmax
    else:
        red = tuple(i for i in range(w.dim()) if i != axis % w.dim())
        scale = w.abs().amax(dim=red, keepdim=True) / qmax
    scale = torch.clamp_min(scale, 1e-8)
    q = torch.clamp(torch.round(w / scale), -qmax - 1, qmax).to(torch.int8)
    return q, scale


def dequantize(q, scale, dtype=None):
    """A float tensor from int8 codes and their scale: `q.to(dtype) *
    scale.to(dtype)`, dtype float32 by default (the compute dtype makes
    the one multiply land in it)."""
    dt = torch.float32 if dtype is None else dtype
    return q.to(dt) * scale.to(dt)

"""The paddle.device package of the port: counterpart of
paddle_tpu/device/__init__.py (python/paddle/device/__init__.py).

The place functions are `core.device`'s: `set_device` selects 'gpu' (the
CUDA cards) or 'cpu' for new tensors; with none selected the place is the
card, and resolving it raises where there is none. Every entry point of
the port (the models, the serving engine) runs on the card unless its
caller asks for the CPU: `resolve_device` resolves a device per object and
sets no global state. The memory functions are `device.memory`'s.
"""
from __future__ import annotations

import contextlib

import torch

from ..core.device import (Place, current_device, device_count, get_device,
                           get_place, is_compiled_with_cuda, resolve_device,
                           set_device)
from .memory import (max_memory_allocated, max_memory_reserved,
                     memory_allocated, memory_reserved, memory_stats,
                     record_peak, reset_peak_memory_stats)

__all__ = [
    "set_device", "get_device", "get_place", "device_count", "Place",
    "is_compiled_with_cuda", "is_compiled_with_tpu", "synchronize",
    "memory_stats", "memory_allocated", "max_memory_allocated",
    "memory_reserved", "max_memory_reserved", "reset_peak_memory_stats",
    "record_peak", "resolve_device", "on_device",
]


def is_compiled_with_tpu() -> bool:
    """The port runs on CUDA cards and the CPU, never a TPU."""
    return False


def synchronize(device=None):
    """Wait for the card's queued work (`torch.cuda.synchronize` of
    `device`, or of the selected place); nothing on the CPU, whose ops
    finish in the call."""
    if device is None and not torch.cuda.is_available():
        return
    dev = current_device(device)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def on_device(t):
    """A context that makes `t`'s card the current one (the hand-written
    kernels launch on the current device), or nothing for a CPU tensor: a
    tensor-parallel shard on another card of its mesh launches there."""
    if t.device.type == "cuda":
        return torch.cuda.device(t.device)
    return contextlib.nullcontext()

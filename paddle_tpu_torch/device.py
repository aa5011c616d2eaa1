"""Device resolution for the port: counterpart of paddle_tpu/core/device.py.

Every entry point of the port (the model, the serving engine) runs on the
CUDA card unless its caller asks for the CPU. Nothing here sets global
state: a device is resolved per object and passed down explicitly.
"""
from __future__ import annotations

import contextlib

import torch

__all__ = ["resolve_device", "on_device"]


def resolve_device(device=None) -> torch.device:
    """`None` means the CUDA card, and raises when there is none: the port
    never drops to the CPU unasked. Pass `device="cpu"` to run the plain
    PyTorch versions of the kernels on the CPU (the tests do)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the plain PyTorch versions on the CPU")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"device must be 'cpu' or 'cuda', got {device!r}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but no CUDA "
                           "device is available")
    return dev


def on_device(t):
    """A context that makes `t`'s card the current one (the hand-written
    kernels launch on the current device), or nothing for a CPU tensor: a
    tensor-parallel shard on another card of its mesh launches there."""
    if t.device.type == "cuda":
        return torch.cuda.device(t.device)
    return contextlib.nullcontext()

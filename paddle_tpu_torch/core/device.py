"""Device API of the paddle surface: counterpart of
paddle_tpu/core/device.py (python/paddle/device/__init__.py:355,
set_device).

JAX's places are 'tpu' and 'cpu'; the port's are 'gpu' (the CUDA cards)
and 'cpu'. `set_device` selects the place where the creation ops put new
tensors. With no `set_device` call the place is the card, and resolving
it raises where there is none: the port never drops to the CPU unasked
(`resolve_device`, which the `device` package re-exports). Ops on
tensors stay on their tensors' device.
"""
from __future__ import annotations

import torch

__all__ = ["Place", "set_device", "get_device", "get_place", "device_count",
           "is_compiled_with_cuda", "current_device", "resolve_device"]

_current_place = None


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


class Place:
    """A device place, e.g. Place('gpu', 0). Analog of phi::Place."""

    def __init__(self, device_type: str, device_id: int = 0):
        self.device_type = device_type
        self.device_id = device_id

    def __repr__(self):
        return f"Place({self.device_type}:{self.device_id})"

    def __eq__(self, other):
        return (isinstance(other, Place)
                and self.device_type == other.device_type
                and self.device_id == other.device_id)

    def __hash__(self):
        return hash((self.device_type, self.device_id))

    def torch_device(self) -> torch.device:
        if self.device_type == "cpu":
            return torch.device("cpu")
        return resolve_device(f"cuda:{self.device_id}")

    @staticmethod
    def of(dev: torch.device) -> "Place":
        if dev.type == "cuda":
            return Place("gpu", dev.index or 0)
        return Place(dev.type, 0)


def _parse(device) -> Place:
    if isinstance(device, Place):
        return device
    if isinstance(device, torch.device):
        return Place.of(device)
    device = str(device).lower()
    kind, _, idx = device.partition(":")
    kind = {"cuda": "gpu"}.get(kind, kind)
    if kind not in ("gpu", "cpu"):
        raise ValueError(f"set_device: the port's places are 'gpu' and "
                         f"'cpu', got {device!r}")
    return Place(kind, int(idx) if idx else 0)


def set_device(device) -> Place:
    """Select the place of new tensors: 'gpu', 'gpu:N' or 'cpu'. A card
    that is not there raises."""
    global _current_place
    place = _parse(device)
    place.torch_device()
    _current_place = place
    return place


def get_place() -> Place:
    """The selected place; with none selected, the card (raising where
    there is none)."""
    if _current_place is None:
        resolve_device(None)
        return Place("gpu", 0)
    return _current_place


def get_device() -> str:
    p = get_place()
    return f"{p.device_type}:{p.device_id}"


def current_device(place=None) -> torch.device:
    """The torch device of `place` (a Place, a name or a torch device), or
    of the selected place."""
    if place is not None:
        return _parse(place).torch_device()
    if _current_place is None:
        return resolve_device(None)
    return _current_place.torch_device()


def is_compiled_with_cuda() -> bool:
    """Whether the PyTorch under the port was built with CUDA (the port's
    kernels are CUDA; a CPU-only build runs their plain versions)."""
    return torch.backends.cuda.is_built()


def device_count() -> int:
    """The CUDA cards this process sees (JAX counts its own devices)."""
    return torch.cuda.device_count()

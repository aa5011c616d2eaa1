"""Device memory statistics: counterpart of paddle_tpu/device/memory.py
(paddle/fluid/memory/stats.h; python/paddle/device/cuda/__init__.py's
memory_allocated and the rest).

On a card the functions read the CUDA caching allocator
(`torch.cuda.memory_stats`; `source` "cuda_caching_allocator"). On the
CPU, which has no allocator statistics, they follow the JAX package's
live-array accounting: the bytes of the distinct storages of the live CPU
tensors that Python holds (found through the garbage collector), with a
process-local high-water mark advanced at each query (`memory_stats`,
`max_memory_allocated`, `record_peak`; `source` "live_tensors"). A tensor
that only autograd's graph holds has no Python object and is not counted,
as JAX's view counts no in-program temporaries.

`device` is None (the selected place), an int (that card), or a name,
`Place` or torch device.
"""
from __future__ import annotations

import gc

import torch

from ..core.device import current_device

__all__ = [
    "memory_stats", "memory_allocated", "max_memory_allocated",
    "memory_reserved", "max_memory_reserved", "reset_peak_memory_stats",
    "record_peak", "program_memory",
]

# process-local high-water marks of the CPU accounting ({key: bytes})
_peaks: dict = {}


def _device(device=None) -> torch.device:
    if isinstance(device, int):
        device = f"gpu:{device}"
    return current_device(device)


def _live_bytes() -> int:
    """Bytes of the distinct storages of the live CPU tensors."""
    seen = {}
    tensor = torch.Tensor
    for o in gc.get_objects():
        # the type, not isinstance: no attribute of an arbitrary object
        # is read (some warn when read)
        if not issubclass(type(o), tensor):
            continue
        try:
            if o.device.type != "cpu" or o.layout != torch.strided:
                continue
            st = o.untyped_storage()
            seen[st.data_ptr()] = st.nbytes()
        except (RuntimeError, ReferenceError, NotImplementedError):
            continue
    return sum(seen.values())


def _advance(key, cur):
    _peaks[key] = max(_peaks.get(key, 0), cur)
    return _peaks[key]


def record_peak(device=None) -> int:
    """Sample the current usage and advance the high-water mark; returns
    the current bytes."""
    dev = _device(device)
    cur = memory_allocated(dev)
    if dev.type == "cpu":
        _advance(str(dev), cur)
    return cur


def memory_stats(device=None) -> dict:
    """All counters for `device` as a dict, under JAX's keys."""
    dev = _device(device)
    if dev.type == "cuda":
        raw = torch.cuda.memory_stats(dev)
        return {
            "source": "cuda_caching_allocator",
            "allocated_bytes": raw.get("allocated_bytes.all.current", 0),
            "peak_allocated_bytes": raw.get("allocated_bytes.all.peak", 0),
            "reserved_bytes": raw.get("reserved_bytes.all.current", 0),
            "peak_reserved_bytes": raw.get("reserved_bytes.all.peak", 0),
            "largest_free_block_bytes": None,
            "raw": raw,
        }
    cur = _live_bytes()
    peak = _advance(str(dev), cur)
    return {
        "source": "live_tensors",
        "allocated_bytes": cur,
        "peak_allocated_bytes": peak,
        "reserved_bytes": cur,
        "peak_reserved_bytes": peak,
        "largest_free_block_bytes": None,
        "raw": None,
    }


def memory_allocated(device=None) -> int:
    """Bytes allocated on `device` now."""
    dev = _device(device)
    if dev.type == "cuda":
        return int(torch.cuda.memory_allocated(dev))
    return _live_bytes()


def max_memory_allocated(device=None) -> int:
    """Peak allocated bytes since the process started or the last reset."""
    dev = _device(device)
    if dev.type == "cuda":
        return int(torch.cuda.max_memory_allocated(dev))
    return int(memory_stats(dev)["peak_allocated_bytes"])


def memory_reserved(device=None) -> int:
    dev = _device(device)
    if dev.type == "cuda":
        return int(torch.cuda.memory_reserved(dev))
    return int(memory_stats(dev)["reserved_bytes"])


def max_memory_reserved(device=None) -> int:
    dev = _device(device)
    if dev.type == "cuda":
        return int(torch.cuda.max_memory_reserved(dev))
    return int(memory_stats(dev)["peak_reserved_bytes"])


def reset_peak_memory_stats(device=None) -> None:
    """Reset the peaks: the caching allocator's on a card, the high-water
    mark of the CPU accounting."""
    dev = _device(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    else:
        _peaks[str(dev)] = 0


def program_memory(compiled) -> dict:
    """JAX reads an XLA executable's `memory_analysis()`; the port runs
    eagerly and has no compiled program to read."""
    raise NotImplementedError(
        "program_memory reads a compiled XLA program, which the eager port "
        "does not have (ROADMAP Queue A 14, the tiers that read XLA "
        "programs)")

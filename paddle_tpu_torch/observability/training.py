"""Training-step telemetry: step time, tokens/s, grad norm, memory
(counterpart of paddle_tpu/observability/training.py).

The training-side counterpart of the engine's serving metrics. A
`TrainingTelemetry` owns the metric handles; feed it per-step either
explicitly (`observe_step`) or by handing it to `jit.TrainStep(...,
telemetry=...)`, which times each optimizer step (waiting on the loss,
so the measured time is device time + launches, not launches alone —
only paid when telemetry is attached).

Device-memory watermarks are read on demand (`record_memory()` /
`memory_every=N`), not per step, through `device.memory.memory_stats`:
on a CUDA device from the caching allocator (`allocated_bytes.all.current`
and `.peak`), on the CPU from the live-tensor accounting, as the JAX
package falls back to live-array accounting on a device without allocator
statistics.
"""
from __future__ import annotations

import time
from contextlib import contextmanager

from ..device.memory import memory_stats
from .metrics import LATENCY_BUCKETS, get_registry

__all__ = ["TrainingTelemetry"]


class TrainingTelemetry:
    def __init__(self, registry=None, prefix="train",
                 tokens_per_step=None, memory_every=0):
        reg = registry if registry is not None else get_registry()
        self.registry = reg
        self.tokens_per_step = tokens_per_step
        self.memory_every = int(memory_every)
        self._steps = reg.counter(
            f"{prefix}_steps_total", "Optimizer steps completed.")
        self._step_time = reg.histogram(
            f"{prefix}_step_seconds",
            "Wall time of one training step (loss blocked on).",
            buckets=LATENCY_BUCKETS)
        self._tokens = reg.counter(
            f"{prefix}_tokens_total", "Tokens consumed by training.")
        self._tps = reg.gauge(
            f"{prefix}_tokens_per_second",
            "Instantaneous tokens/s of the last observed step.")
        self._grad_norm = reg.gauge(
            f"{prefix}_grad_norm", "Last observed global gradient norm.")
        self._loss = reg.gauge(f"{prefix}_loss", "Last observed loss.")
        self._mem = reg.gauge(
            f"{prefix}_device_memory_bytes",
            "Device memory from device.memory.memory_stats.",
            labelnames=("kind",))

    def observe_step(self, step_time_s, tokens=None, grad_norm=None,
                     loss=None):
        self._steps.inc()
        self._step_time.observe(step_time_s)
        tokens = self.tokens_per_step if tokens is None else tokens
        if tokens:
            self._tokens.inc(tokens)
            if step_time_s > 0:
                self._tps.set(tokens / step_time_s)
        if grad_norm is not None:
            self._grad_norm.set(float(grad_norm))
        if loss is not None:
            self._loss.set(float(loss))
        if self.memory_every and \
                int(self._steps.value) % self.memory_every == 0:
            self.record_memory()

    @contextmanager
    def step(self, tokens=None, grad_norm=None):
        """Time a step body: `with tel.step(tokens=B*S): loss = ...`"""
        t0 = time.perf_counter()
        yield
        self.observe_step(time.perf_counter() - t0, tokens=tokens,
                          grad_norm=grad_norm)

    def record_memory(self, device=None):
        """Sample allocated/peak bytes of `device` (the selected place when
        None) into gauges (peak is a high-water gauge — it never goes down
        between resets)."""
        stats = memory_stats(device)
        self._mem.labels(kind="allocated").set(stats["allocated_bytes"])
        self._mem.labels(kind="peak").set_max(
            stats["peak_allocated_bytes"])
        return stats

"""Profiler — the host half of paddle_tpu/profiler (counterpart of
python/paddle/profiler/): `RecordEvent` host spans recorded while a
`Profiler(timer_only=True)` records, exported as chrome://tracing JSON.
"""
from .profiler import (
    Profiler,
    ProfilerState,
    ProfilerTarget,
    RecordEvent,
    export_chrome_tracing,
    make_scheduler,
)

__all__ = [
    "Profiler", "RecordEvent", "ProfilerState", "ProfilerTarget",
    "make_scheduler", "export_chrome_tracing",
]

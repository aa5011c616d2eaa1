"""The host half of paddle_tpu/profiler/profiler.py (counterpart of
paddle.profiler): host spans (`RecordEvent`) recorded into a buffer while
a `Profiler` records, exported as chrome://tracing JSON.

Standard library only. `Profiler(timer_only=True)` records the host spans
and step times as in the JAX package. `timer_only=False` also asks for a
device trace, which the JAX package takes from jax.profiler and its
per-op dispatch hook; the port has neither yet (ROADMAP Queue A 13, the
profiler), so it raises. The engine's `engine.step`, `engine.prefill`,
`engine.decode` and `engine.cow` spans go through `RecordEvent`.
"""
from __future__ import annotations

import enum
import itertools
import json
import os
import threading
import time
from typing import Callable, Iterable, List, Optional

__all__ = ["Profiler", "ProfilerState", "ProfilerTarget", "RecordEvent",
           "make_scheduler", "export_chrome_tracing"]


class ProfilerState(enum.Enum):
    CLOSED = 0
    READY = 1
    RECORD = 2
    RECORD_AND_RETURN = 3


class ProfilerTarget(enum.Enum):
    CPU = 0
    GPU = 1


class _HostEventRecorder:
    """Ring-buffer host span recorder (host_event_recorder.h analog)."""

    def __init__(self):
        self.events: List[dict] = []
        self._lock = threading.Lock()
        self.enabled = False

    def record(self, name, start_us, end_us, tid, cat="host"):
        if not self.enabled:
            return
        with self._lock:
            self.events.append(
                {"name": name, "ph": "X", "ts": start_us,
                 "dur": end_us - start_us, "pid": os.getpid(), "tid": tid,
                 "cat": cat})

    def drain(self):
        with self._lock:
            out = self.events
            self.events = []
        return out

    def peek(self):
        """Non-destructive copy of the buffered spans — the tracing
        timeline merge (`observability.tracing.export_timeline`) reads
        the stream without stealing it from a recording Profiler."""
        with self._lock:
            return [dict(e) for e in self.events]


_recorder = _HostEventRecorder()


class RecordEvent:
    """Analog of paddle.profiler.RecordEvent (event_tracing.h RecordEvent)."""

    def __init__(self, name: str, event_type=None):
        self.name = name
        self._start = None

    def begin(self):
        self._start = time.perf_counter_ns() // 1000

    def end(self):
        if self._start is not None:
            _recorder.record(self.name, self._start,
                             time.perf_counter_ns() // 1000,
                             threading.get_ident() % 100000)
            self._start = None

    def __enter__(self):
        self.begin()
        return self

    def __exit__(self, *exc):
        self.end()
        return False


def make_scheduler(*, closed: int, ready: int, record: int, repeat: int = 0,
                   skip_first: int = 0) -> Callable[[int], ProfilerState]:
    """Analog of paddle.profiler.make_scheduler."""
    cycle = closed + ready + record

    def schedule(step: int) -> ProfilerState:
        if step < skip_first:
            return ProfilerState.CLOSED
        s = step - skip_first
        if repeat and s >= cycle * repeat:
            return ProfilerState.CLOSED
        pos = s % cycle
        if pos < closed:
            return ProfilerState.CLOSED
        if pos < closed + ready:
            return ProfilerState.READY
        if pos == cycle - 1:
            return ProfilerState.RECORD_AND_RETURN
        return ProfilerState.RECORD

    return schedule


# monotonic export sequence: two exports within the same wall-clock
# second (scheduler cycles faster than 1 Hz, tests) must land in two
# files — `{name}_{epoch}.json` alone silently overwrites the first
_export_seq = itertools.count()


def export_chrome_tracing(dir_name: str, worker_name: Optional[str] = None):
    def handler(prof: "Profiler"):
        os.makedirs(dir_name, exist_ok=True)
        name = worker_name or f"worker_{os.getpid()}"
        path = os.path.join(
            dir_name,
            f"{name}_{int(time.time())}_{next(_export_seq):04d}.json")
        prof._export_path = path
        prof.export(path)

    return handler


def _refuse_device_trace():
    raise NotImplementedError(
        "Profiler(timer_only=False) and summary() need the device trace and "
        "per-op statistics, which are not ported yet (ROADMAP Queue A 13, "
        "the profiler); use Profiler(timer_only=True) for host spans, or "
        "torch.profiler for device time")


class Profiler:
    """Analog of paddle.profiler.Profiler (profiler.py:344), host spans
    only: `timer_only=True` is required."""

    def __init__(self, *, targets: Optional[Iterable] = None, scheduler=None,
                 on_trace_ready=None, record_shapes=False, profile_memory=False,
                 timer_only=False, with_flops=False):
        if not timer_only:
            _refuse_device_trace()
        self._scheduler = scheduler
        self._on_trace_ready = on_trace_ready
        self.step_num = 0
        self._state = ProfilerState.CLOSED
        self._events: List[dict] = []
        self._export_path = None
        self._step_t0 = None
        self._step_times = []
        self._trace_ready_fired = False

    # -- lifecycle ---------------------------------------------------------
    def _set_recording(self, on: bool):
        _recorder.enabled = on

    def start(self):
        self._state = (self._scheduler(self.step_num)
                       if self._scheduler else ProfilerState.RECORD)
        self._set_recording(self._state in (
            ProfilerState.RECORD, ProfilerState.RECORD_AND_RETURN))
        self._step_t0 = time.perf_counter()
        return self

    def stop(self):
        self._set_recording(False)
        self._events.extend(_recorder.drain())
        if self._on_trace_ready and not self._trace_ready_fired:
            self._on_trace_ready(self)
        self._trace_ready_fired = False
        self._state = ProfilerState.CLOSED

    def step(self, num_frames: int = 1):
        now = time.perf_counter()
        if self._step_t0 is not None:
            self._step_times.append(now - self._step_t0)
        self._step_t0 = now
        self.step_num += num_frames
        if self._scheduler:
            new_state = self._scheduler(self.step_num)
            if new_state != self._state:
                if new_state in (ProfilerState.RECORD,
                                 ProfilerState.RECORD_AND_RETURN):
                    self._set_recording(True)
                    self._trace_ready_fired = False  # new record window
                elif self._state in (ProfilerState.RECORD,
                                     ProfilerState.RECORD_AND_RETURN):
                    self._events.extend(_recorder.drain())
                    self._set_recording(False)
                    if new_state == ProfilerState.CLOSED \
                            and self._on_trace_ready:
                        # fired here; stop() must not export a duplicate
                        self._on_trace_ready(self)
                        self._trace_ready_fired = True
                self._state = new_state

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False

    # -- export ------------------------------------------------------------
    def export(self, path: str, format: str = "json"):
        self._events.extend(_recorder.drain())
        with open(path, "w") as f:
            json.dump({"traceEvents": self._events}, f)

    def summary(self, sorted_by=None, op_detail=True, thread_sep=False,
                time_unit="ms"):
        _refuse_device_trace()

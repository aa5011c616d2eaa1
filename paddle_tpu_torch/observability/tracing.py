"""Request-scoped tracing + step-phase timeline — the span half of
serving observability (metrics.py answers "how much / how often"; this
module answers "where did request X's 40 ms go"). Copied from
paddle_tpu/observability/tracing.py (standard library only); only
`profiler_host_events` differs: it peeks at the port's own profiler.

Three host-side pieces, shared by the engine and the fleet:

- **TraceRecorder**: a thread-safe bounded ring of Chrome
  trace-event-format spans. Every span carries a `trace_id` (one per
  request, minted at intake and riding the disaggregated handoff
  across replicas) plus its own `span_id`/`parent_id`, so one Perfetto
  timeline shows a request crossing engines. The ring is bounded
  (`capacity` spans, oldest dropped first, drops counted) so
  steady-state serving never grows memory without bound.
- **PhaseTimer**: exclusive-time accounting for the named host phases
  one `engine.step()` decomposes into (`STEP_PHASES`). Nested phases
  PAUSE their parent, so per-phase totals partition the step wall
  exactly — the serial-host tax of ROADMAP item 3 becomes a number
  (`engine_step_host_gap_seconds{phase=…}`) instead of an assertion.
- **FlightRecorder**: a bounded ring of recent request-lifecycle
  events (queued/admit/first_token/stall/finish/handoff/…) — the
  postmortem `drain()`'s leak audit attaches to its exception.

Clock policy: every timestamp is `time.perf_counter_ns() // 1000` —
the SAME monotonic microsecond clock `profiler.RecordEvent` stamps its
spans with, so `export_timeline` can merge a TraceRecorder stream and
the profiler's `_HostEventRecorder` stream onto one coherent timeline
without offset juggling.

House invariant: tracing is HOST-SIDE ONLY. Nothing in this module
ever reaches a kernel, so a tracing-enabled engine launches the same
kernels, the same number of times, as a disabled one. No torch imports
— importing this module must never initialize a device context.
"""
from __future__ import annotations

import itertools
import json
import os
import threading
import time
from collections import deque
from contextlib import contextmanager

__all__ = [
    "STEP_PHASES", "TraceRecorder", "PhaseTimer", "FlightRecorder",
    "new_trace_id", "now_us", "merge_trace_events", "export_timeline",
    "profiler_host_events",
]

#: The named host phases one `engine.step()` decomposes into. Every
#: phase is host work between (or around) compiled dispatches:
#: - schedule:      admission loop, lane scan, growth allocation
#: - prefix_lookup: prefix-cache chain walk at admission
#: - adapter_swap:  adapter-page acquire (incl. host->device swap-in)
#: - draft_propose: speculative drafter proposal (host-side)
#: - dispatch:      building host args + issuing a compiled step
#: - device_wait:   blocking on device results (the token readback or
#:                  its CUDA event — the only phase that is device time)
#: - accept_walk:   greedy draft-acceptance walk over verify output
#: - sample_walk:   rejection-sampling acceptance walk (sampled lanes)
#: - cow:           copy-on-write block promotion
#: - finish:        token emission, TTFT/TPOT accounting, retirement
STEP_PHASES = ("schedule", "prefix_lookup", "adapter_swap",
               "draft_propose", "dispatch", "device_wait",
               "accept_walk", "sample_walk", "cow", "finish")

_trace_seq = itertools.count(1)


def now_us():
    """Monotonic microseconds — the shared span clock (see module
    docstring for the cross-stream merge policy)."""
    return time.perf_counter_ns() // 1000


def new_trace_id():
    """Process-unique request trace id. Deliberately NOT random: the
    pid prefix keeps ids unique across processes (multi-host fleets)
    while the counter keeps single-process test traces deterministic."""
    return f"{os.getpid():x}-{next(_trace_seq):x}"


class TraceRecorder:
    """Thread-safe bounded ring of Chrome trace-event spans.

    Events are plain dicts in the trace-event JSON schema ("X" duration
    spans, "i" instants), timestamped by `now_us()`. The ring holds the
    newest `capacity` events; `dropped` counts evictions so a truncated
    export is visible, never silent.
    """

    def __init__(self, capacity=4096, process_name="engine"):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.process_name = process_name
        self._events = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self._span_seq = itertools.count(1)
        self.total_recorded = 0

    @property
    def dropped(self):
        """Events evicted by the ring bound (recorded - retained)."""
        with self._lock:
            return self.total_recorded - len(self._events)

    def new_span_id(self):
        return next(self._span_seq)

    def _push(self, ev):
        with self._lock:
            self._events.append(ev)
            self.total_recorded += 1

    def add_span(self, name, start_us, end_us, *, trace_id=None,
                 parent_id=None, tid=0, cat="engine", args=None):
        """Record one completed span; returns its span id (usable as
        another span's `parent_id`)."""
        sid = self.new_span_id()
        a = {"span_id": sid}
        if trace_id is not None:
            a["trace_id"] = trace_id
        if parent_id is not None:
            a["parent_id"] = parent_id
        if args:
            a.update(args)
        self._push({"name": name, "ph": "X", "ts": int(start_us),
                    "dur": max(int(end_us) - int(start_us), 0),
                    "pid": os.getpid(), "tid": int(tid), "cat": cat,
                    "args": a})
        return sid

    def add_instant(self, name, ts_us=None, *, trace_id=None, tid=0,
                    cat="engine", args=None):
        """Record a zero-duration marker (finish reasons, sheds,
        first-token ticks)."""
        a = {}
        if trace_id is not None:
            a["trace_id"] = trace_id
        if args:
            a.update(args)
        self._push({"name": name, "ph": "i", "s": "t",
                    "ts": int(now_us() if ts_us is None else ts_us),
                    "pid": os.getpid(), "tid": int(tid), "cat": cat,
                    "args": a})

    @contextmanager
    def span(self, name, *, trace_id=None, parent_id=None, tid=0,
             cat="engine", args=None):
        t0 = now_us()
        try:
            yield
        finally:
            self.add_span(name, t0, now_us(), trace_id=trace_id,
                          parent_id=parent_id, tid=tid, cat=cat,
                          args=args)

    def snapshot(self):
        """Non-destructive copy of the retained events, oldest first."""
        with self._lock:
            return [dict(e) for e in self._events]

    def clear(self):
        with self._lock:
            self._events.clear()
            self.total_recorded = 0


class PhaseTimer:
    """Exclusive-time phase accounting for one scheduler iteration.

    `phase(name)` is a reentrant-by-stack context manager: entering a
    nested phase PAUSES the enclosing one, so `totals()` values are
    disjoint and sum to (at most) the step's wall time — the property
    that makes `engine_step_device_fraction` = device_wait / wall a
    real fraction instead of double-counting nested sections.

    Thread-confined: each thread owns its own stack AND accumulator
    (the async engine core runs drafter proposals on a helper thread
    while the step thread is inside its own phases — a phase recorded
    off the step thread must neither pause the step thread's active
    phase nor fold its overlapped seconds into the step thread's
    totals, or phase sums would exceed step wall time and
    `engine_step_device_fraction` would stop being a fraction).
    `reset()` and `totals()` operate on the calling thread's clock
    only; no locks needed because no state is shared.
    """

    def __init__(self):
        self._tls = threading.local()

    def _state(self):
        tls = self._tls
        if not hasattr(tls, "acc"):
            tls.acc = {}
            tls.stack = []             # [name, slice_start] frames
        return tls.acc, tls.stack

    def reset(self):
        acc, stack = self._state()
        self._tls.acc = {}
        stack.clear()
        return acc

    @contextmanager
    def phase(self, name):
        acc, stack = self._state()
        now = time.perf_counter()
        if stack:                      # pause the enclosing phase
            outer = stack[-1]
            acc[outer[0]] = acc.get(outer[0], 0.0) + now - outer[1]
        stack.append([name, now])
        try:
            yield
        finally:
            acc, stack = self._state()
            frame = stack.pop()
            now = time.perf_counter()
            acc[frame[0]] = acc.get(frame[0], 0.0) + now - frame[1]
            if stack:                  # resume the enclosing phase
                stack[-1][1] = now

    def totals(self):
        """phase -> accumulated exclusive seconds since last reset,
        for the CALLING thread's clock."""
        return dict(self._state()[0])


class FlightRecorder:
    """Bounded ring of recent request-lifecycle events — the engine's
    black box. Always on (a handful of dict appends per request, far
    off any hot path), bounded so steady-state serving never grows it,
    and formatted into `drain()`'s leak-audit exception so a failed
    audit arrives WITH the recent history that explains it."""

    def __init__(self, capacity=256):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._events = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self.total_recorded = 0

    def record(self, event, req_id=None, **detail):
        ev = {"t_us": now_us(), "event": event}
        if req_id is not None:
            ev["req_id"] = req_id
        if detail:
            ev.update(detail)
        with self._lock:
            self._events.append(ev)
            self.total_recorded += 1

    def dump(self):
        """Retained events, oldest first (JSON-able dicts)."""
        with self._lock:
            return [dict(e) for e in self._events]

    def format(self, limit=None):
        """Human-readable tail for exception messages."""
        rows = self.dump()
        if limit is not None:
            rows = rows[-limit:]
        head = (f"flight recorder ({len(rows)} of "
                f"{self.total_recorded} events, newest last):")
        lines = [head]
        for e in rows:
            extra = " ".join(f"{k}={e[k]}" for k in e
                             if k not in ("t_us", "event", "req_id"))
            rid = f" req={e['req_id']!r}" if "req_id" in e else ""
            lines.append(f"  [{e['t_us']}us] {e['event']}{rid}"
                         + (f" {extra}" if extra else ""))
        return "\n".join(lines)


def profiler_host_events():
    """Non-destructive peek at the port's profiler `_HostEventRecorder`
    stream (the `engine.step`/`engine.prefill`/`engine.decode`/
    `engine.cow` spans `RecordEvent` emits while a Profiler records).
    Lazy import: the profiler package is stdlib-only too, but tracing
    must stay importable standalone."""
    from ..profiler.profiler import _recorder

    return _recorder.peek()


def merge_trace_events(groups):
    """Merge named event streams onto one timeline: `groups` is an
    iterable of (process_name, events). Each group is re-pidded to a
    stable small integer (1, 2, …) with a `process_name` metadata
    event, so Perfetto renders one track group per engine/replica/
    profiler stream — events share the monotonic clock (module
    docstring), so no timestamp shifting happens here."""
    out = []
    for pid, (pname, events) in enumerate(groups, start=1):
        out.append({"name": "process_name", "ph": "M", "pid": pid,
                    "tid": 0, "args": {"name": pname}})
        for ev in events:
            e = dict(ev)
            e["pid"] = pid
            out.append(e)
    return out


def export_timeline(path, groups):
    """Write merged `groups` (see `merge_trace_events`) as one Chrome
    trace-event / Perfetto JSON file. Returns the event count."""
    events = merge_trace_events(groups)
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
    return len(events)

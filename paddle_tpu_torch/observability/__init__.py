"""Unified metrics & telemetry — counterpart of paddle_tpu/observability
(the counters/gauges/histograms half; `profiler` holds the span half).

    from paddle_tpu_torch import observability as obs

    reg = obs.get_registry()                    # process-default registry
    reqs = reg.counter("requests_total", "...", labelnames=("verb",))
    reqs.labels(verb="GET").inc()

    print(reg.render_prometheus())              # text exposition
    srv = obs.MetricsServer(reg)                # loopback /metrics
    merged = obs.aggregate()                    # one member: the local fold

Importing this package has no device side effects (no CUDA context);
the distributed fold and memory sampling import torch lazily.
"""
from .metrics import (
    Counter,
    Gauge,
    Histogram,
    LATENCY_BUCKETS,
    MetricsRegistry,
    get_registry,
    label_snapshot,
    merge_snapshots,
    quantile_from_buckets,
    series_total,
)
from .aggregate import aggregate
from .exposition import parse_prometheus, render_prometheus
from .server import MetricsServer
from .tracing import (
    STEP_PHASES,
    FlightRecorder,
    PhaseTimer,
    TraceRecorder,
    export_timeline,
    merge_trace_events,
    new_trace_id,
)
from .training import TrainingTelemetry

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "get_registry",
    "LATENCY_BUCKETS", "merge_snapshots", "label_snapshot",
    "quantile_from_buckets", "series_total", "aggregate",
    "render_prometheus", "parse_prometheus", "MetricsServer",
    "TrainingTelemetry",
    "TraceRecorder", "PhaseTimer", "FlightRecorder", "STEP_PHASES",
    "new_trace_id", "merge_trace_events", "export_timeline",
]

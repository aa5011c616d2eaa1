"""Thread-safe metrics registry: labeled Counter / Gauge / Histogram.

Copied from paddle_tpu/observability/metrics.py (standard library only),
so the port's snapshots, merges and exposition are the JAX package's.

The *metrics* half of the observability story (the profiler reproduces
the reference's span/trace half): monotonically increasing counters,
point-in-time gauges, and fixed-bucket histograms that a scrape
endpoint (`observability.server`), a bench harness, or
a cross-rank fold (`observability.aggregate`) can read continuously —
the serving-telemetry style of Orca/vLLM (TTFT, per-output-token
latency, KV-pool utilization).

Design constraints this module enforces:

- histograms use FIXED EXPLICIT bucket bounds declared at creation, so
  a cross-rank merge is an exact elementwise sum of counts — no
  re-bucketing, no approximation (see DESIGN_DECISIONS.md);
- no torch / device imports at module level: importing observability
  must never initialize a device context (a metrics scrape thread on a
  serving host must not race device init);
- everything is guarded by one registry lock — increments are a dict
  update + float add, far off any hot path's critical section.
"""
from __future__ import annotations

import json
import math
import re
import threading

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "get_registry", "LATENCY_BUCKETS", "DEFAULT_BUCKETS",
    "merge_snapshots", "label_snapshot", "quantile_from_buckets",
    "series_total",
]

# latency buckets (seconds): sub-ms decode steps through multi-second
# prefill; shared by every latency histogram so cross-metric and
# cross-rank comparisons line up bucket-for-bucket
LATENCY_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
)
DEFAULT_BUCKETS = LATENCY_BUCKETS

_METRIC_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


class _Family:
    """One named metric family: a set of label-keyed series sharing a
    type and help string. Child handles are cached per label tuple so
    hot-path `.labels(...)` is a dict hit."""

    kind = None

    def __init__(self, registry, name, help, labelnames):
        if not _METRIC_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        for ln in labelnames:
            if not _LABEL_RE.match(ln):
                raise ValueError(f"invalid label name {ln!r}")
            if ln == "le":
                raise ValueError("label name 'le' is reserved for "
                                 "histogram buckets")
        self._registry = registry
        self._lock = registry._lock
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._series = {}            # label-value tuple -> child

    def labels(self, *values, **kw):
        if kw:
            if values:
                raise ValueError("pass labels positionally or by "
                                 "keyword, not both")
            try:
                values = tuple(kw[ln] for ln in self.labelnames)
            except KeyError as e:
                raise ValueError(
                    f"{self.name}: missing label {e.args[0]!r} "
                    f"(labelnames={self.labelnames})") from None
            if len(kw) != len(self.labelnames):
                extra = set(kw) - set(self.labelnames)
                raise ValueError(f"{self.name}: unknown labels {extra}")
        values = tuple(str(v) for v in values)
        if len(values) != len(self.labelnames):
            raise ValueError(
                f"{self.name} takes {len(self.labelnames)} label "
                f"value(s) {self.labelnames}, got {len(values)}")
        with self._lock:
            child = self._series.get(values)
            if child is None:
                child = self._series[values] = self._new_child()
            return child

    def _default(self):
        if self.labelnames:
            raise ValueError(
                f"{self.name} is labeled {self.labelnames}; call "
                ".labels(...) first")
        return self.labels()

    def _snapshot_series(self):
        # children snapped while HOLDING the lock: a histogram observe
        # mutates counts/sum/count as three writes, and a concurrent
        # scrape must not see them torn (the lock is an RLock)
        with self._lock:
            out = []
            for values, child in sorted(self._series.items()):
                entry = {"labels": dict(zip(self.labelnames, values))}
                entry.update(child._snap())
                out.append(entry)
        return out

    def _reset(self):
        # zero children IN PLACE: callers hold .labels() handles for
        # hot-path speed, and clearing the dict would orphan them (their
        # increments would silently stop appearing in snapshots)
        with self._lock:
            for child in self._series.values():
                child._zero()


class _CounterChild:
    __slots__ = ("_value", "_lock")

    def __init__(self, lock):
        self._value = 0.0
        self._lock = lock

    def inc(self, amount=1.0):
        if amount < 0:
            raise ValueError("counters only go up; use a Gauge")
        with self._lock:
            self._value += amount

    def _zero(self):
        self._value = 0.0            # guarded-by: _lock

    @property
    def value(self):
        return self._value

    def _snap(self):
        return {"value": self._value}


class Counter(_Family):
    """Monotonic counter family (prometheus `counter`)."""

    kind = "counter"

    def _new_child(self):
        return _CounterChild(self._lock)

    def inc(self, amount=1.0):
        self._default().inc(amount)

    @property
    def value(self):
        return self._default().value


class _GaugeChild:
    __slots__ = ("_value", "_lock")

    def __init__(self, lock):
        self._value = 0.0
        self._lock = lock

    def set(self, value):
        with self._lock:
            self._value = float(value)

    def inc(self, amount=1.0):
        with self._lock:
            self._value += amount

    def dec(self, amount=1.0):
        self.inc(-amount)

    def set_max(self, value):
        """High-water-mark update: keep the larger of current/new."""
        with self._lock:
            if value > self._value:
                self._value = float(value)

    def _zero(self):
        self._value = 0.0            # guarded-by: _lock

    @property
    def value(self):
        return self._value

    def _snap(self):
        return {"value": self._value}


class Gauge(_Family):
    """Point-in-time gauge family (prometheus `gauge`)."""

    kind = "gauge"

    def _new_child(self):
        return _GaugeChild(self._lock)

    def set(self, value):
        self._default().set(value)

    def inc(self, amount=1.0):
        self._default().inc(amount)

    def dec(self, amount=1.0):
        self._default().dec(amount)

    def set_max(self, value):
        self._default().set_max(value)

    @property
    def value(self):
        return self._default().value


class _HistogramChild:
    __slots__ = ("_counts", "_sum", "_count", "_bounds", "_lock")

    def __init__(self, bounds, lock):
        self._bounds = bounds
        self._counts = [0] * (len(bounds) + 1)   # last = +Inf overflow
        self._sum = 0.0
        self._count = 0
        self._lock = lock

    def observe(self, value):
        value = float(value)
        i = len(self._bounds)
        for j, b in enumerate(self._bounds):
            if value <= b:
                i = j
                break
        with self._lock:
            self._counts[i] += 1
            self._sum += value
            self._count += 1

    def _zero(self):
        self._counts = [0] * len(self._counts)   # guarded-by: _lock
        self._sum = 0.0                          # guarded-by: _lock
        self._count = 0                          # guarded-by: _lock

    @property
    def count(self):
        return self._count

    @property
    def sum(self):
        return self._sum

    def _snap(self):
        return {"counts": list(self._counts), "sum": self._sum,
                "count": self._count}


class Histogram(_Family):
    """Fixed-explicit-bucket histogram family (prometheus `histogram`).

    `buckets` are inclusive upper bounds; an implicit +Inf bucket
    catches the overflow. Bounds are part of the family identity:
    cross-rank merges require identical bounds and are then EXACT."""

    kind = "histogram"

    def __init__(self, registry, name, help, labelnames,
                 buckets=DEFAULT_BUCKETS):
        super().__init__(registry, name, help, labelnames)
        bounds = tuple(float(b) for b in buckets)
        if list(bounds) != sorted(set(bounds)):
            raise ValueError("bucket bounds must be strictly increasing")
        if bounds and math.isinf(bounds[-1]):
            bounds = bounds[:-1]         # +Inf is implicit
        if not bounds:                   # post-strip: (inf,) is empty too
            raise ValueError("histogram needs at least one finite "
                             "bucket bound")
        self.buckets = bounds

    def _new_child(self):
        return _HistogramChild(self.buckets, self._lock)

    def observe(self, value):
        self._default().observe(value)

    @property
    def count(self):
        return self._default().count

    @property
    def sum(self):
        return self._default().sum


class MetricsRegistry:
    """Named collection of metric families.

        reg = MetricsRegistry()
        reqs = reg.counter("requests_total", "Requests seen.",
                           labelnames=("verb",))
        reqs.labels(verb="GET").inc()
        reg.snapshot()            # JSON-able dict
        reg.render_prometheus()   # text exposition (format 0.0.4)

    Re-requesting an existing name returns the same family when the
    declaration matches, and raises when it conflicts — instrumentation
    can therefore be declared idempotently at call sites."""

    def __init__(self):
        self._lock = threading.RLock()
        self._families = {}

    def _get_or_create(self, cls, name, help, labelnames, **kw):
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if not isinstance(fam, cls) or \
                        fam.labelnames != tuple(labelnames):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{fam.kind}{fam.labelnames}, requested "
                        f"{cls.kind}{tuple(labelnames)}")
                if kw.get("buckets") is not None:
                    # normalize like Histogram.__init__ (trailing +Inf
                    # is implicit) so identical declarations stay
                    # idempotent
                    req = tuple(float(b) for b in kw["buckets"])
                    if req and math.isinf(req[-1]):
                        req = req[:-1]
                    if fam.buckets != req:
                        raise ValueError(
                            f"histogram {name!r} already registered "
                            f"with buckets {fam.buckets}")
                return fam
            fam = cls(self, name, help, labelnames, **kw)
            self._families[name] = fam
            return fam

    def counter(self, name, help="", labelnames=()):
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name, help="", labelnames=()):
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(self, name, help="", labelnames=(),
                  buckets=DEFAULT_BUCKETS):
        return self._get_or_create(Histogram, name, help, labelnames,
                                   buckets=buckets)

    def get(self, name):
        with self._lock:
            return self._families.get(name)

    def reset(self):
        """Zero every series (families stay registered) — bench harness
        use: drop warmup observations before the measured window."""
        with self._lock:
            for fam in self._families.values():
                fam._reset()

    # -- snapshots ---------------------------------------------------------
    def snapshot(self):
        """JSON-able view of every family: exact values, exact bucket
        counts — the wire format `aggregate()` folds across ranks."""
        with self._lock:
            fams = list(self._families.items())
        out = {}
        for name, fam in fams:
            entry = {"type": fam.kind, "help": fam.help,
                     "labelnames": list(fam.labelnames),
                     "series": fam._snapshot_series()}
            if fam.kind == "histogram":
                entry["buckets"] = list(fam.buckets)
            out[name] = entry
        return out

    def snapshot_json(self):
        """Strictly-valid JSON (non-finite floats stringified): Python's
        default would emit bare NaN/Infinity tokens that jq/JS parsers
        reject wholesale."""
        return json.dumps(json_sanitize(self.snapshot()),
                          sort_keys=True)

    def render_prometheus(self):
        from .exposition import render_prometheus

        return render_prometheus(self.snapshot())


# process-wide default registry: framework-internal instrumentation
# (nan/inf events, training telemetry) lands here unless told otherwise
_default_registry = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return _default_registry


def json_sanitize(obj):
    """Recursively replace non-finite floats with their string names so
    the result serializes to STRICT JSON. Used at external boundaries
    (snapshot_json, /metrics.json); the cross-rank aggregate wire stays
    raw (Python↔Python, tolerant loads, values must merge exactly)."""
    if isinstance(obj, float):
        if math.isnan(obj):
            return "NaN"
        if math.isinf(obj):
            return "Infinity" if obj > 0 else "-Infinity"
        return obj
    if isinstance(obj, dict):
        return {k: json_sanitize(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [json_sanitize(v) for v in obj]
    return obj


# ---------------------------------------------------------------------------
# snapshot algebra (host-side; aggregate() runs this after the gather)
# ---------------------------------------------------------------------------

def _series_key(entry):
    return tuple(sorted(entry["labels"].items()))


def label_snapshot(snap, **extra):
    """Copy of a `MetricsRegistry.snapshot()` with `extra` labels
    stamped onto every series (and appended to each family's
    labelnames). The host-side relabeling half of fleet-level folding:
    each replica engine keeps its own registry for counter exactness,
    the fleet stamps `replica=<id>` here and folds the stamped
    snapshots through `merge_snapshots` — identical label sets sum
    exactly, the replica label keeps per-replica series side-by-side
    (same semantics as the shard-labeled pool gauges). Raises on a
    label-name collision instead of silently shadowing a real label."""
    out = {}
    for name, fam in snap.items():
        clash = set(extra) & set(fam["labelnames"])
        if clash:
            raise ValueError(
                f"metric {name!r} already carries label(s) "
                f"{sorted(clash)} — relabeling would shadow them")
        f = {"type": fam["type"], "help": fam["help"],
             "labelnames": list(fam["labelnames"]) + sorted(extra),
             "series": [dict(entry, labels=dict(entry["labels"],
                                                **extra))
                        for entry in fam["series"]]}
        if fam["type"] == "histogram":
            f["buckets"] = list(fam["buckets"])
        out[name] = f
    return out


def merge_snapshots(snaps):
    """Fold per-rank `MetricsRegistry.snapshot()` dicts into one
    job-level snapshot: counters and histogram buckets/sum/count are
    summed EXACTLY per labeled series; gauges report min/max/mean (and
    carry the mean as `value`). Histogram bucket bounds must agree
    across ranks — fixed explicit buckets make the merge lossless."""
    merged = {}
    for snap in snaps:
        for name, fam in snap.items():
            m = merged.get(name)
            if m is None:
                m = merged[name] = {
                    "type": fam["type"], "help": fam["help"],
                    "labelnames": list(fam["labelnames"]),
                    "series": {},
                }
                if fam["type"] == "histogram":
                    m["buckets"] = list(fam["buckets"])
            if m["type"] != fam["type"]:
                raise ValueError(
                    f"metric {name!r}: type mismatch across ranks "
                    f"({m['type']} vs {fam['type']})")
            if fam["type"] == "histogram" and \
                    list(fam["buckets"]) != m["buckets"]:
                raise ValueError(
                    f"histogram {name!r}: bucket bounds differ across "
                    "ranks — declare fixed explicit buckets")
            for entry in fam["series"]:
                key = _series_key(entry)
                tgt = m["series"].get(key)
                if fam["type"] == "counter":
                    if tgt is None:
                        m["series"][key] = dict(entry)
                    else:
                        tgt["value"] += entry["value"]
                elif fam["type"] == "gauge":
                    if tgt is None:
                        v = entry["value"]
                        m["series"][key] = {
                            "labels": dict(entry["labels"]), "value": v,
                            "min": v, "max": v, "mean": v, "ranks": 1}
                    else:
                        tgt["min"] = min(tgt["min"], entry["value"])
                        tgt["max"] = max(tgt["max"], entry["value"])
                        n = tgt["ranks"] + 1
                        tgt["mean"] += (entry["value"] - tgt["mean"]) / n
                        tgt["ranks"] = n
                        tgt["value"] = tgt["mean"]
                else:                      # histogram
                    if tgt is None:
                        m["series"][key] = {
                            "labels": dict(entry["labels"]),
                            "counts": list(entry["counts"]),
                            "sum": entry["sum"],
                            "count": entry["count"]}
                    else:
                        if len(tgt["counts"]) != len(entry["counts"]):
                            raise ValueError(
                                f"histogram {name!r}: bucket count "
                                "mismatch across ranks")
                        tgt["counts"] = [a + b for a, b in
                                         zip(tgt["counts"],
                                             entry["counts"])]
                        tgt["sum"] += entry["sum"]
                        tgt["count"] += entry["count"]
    for fam in merged.values():
        fam["series"] = [fam["series"][k] for k in sorted(fam["series"])]
    return merged


def quantile_from_buckets(bounds, counts, q):
    """Approximate quantile q in [0, 1] from fixed-bucket counts by
    linear interpolation inside the containing bucket (the prometheus
    histogram_quantile rule). None on an empty histogram; observations
    past the last bound clamp to it."""
    total = sum(counts)
    if total == 0:
        return None
    target = q * total
    cum = 0
    lo = 0.0
    for bound, c in zip(bounds, counts):
        if cum + c >= target and c > 0:
            frac = (target - cum) / c
            return lo + (bound - lo) * frac
        cum += c
        lo = bound
    return float(bounds[-1])


def series_total(snapshot, name):
    """Sum of a counter family's series values (all labels) in a
    snapshot; 0.0 when the family is absent."""
    fam = snapshot.get(name)
    if fam is None:
        return 0.0
    return float(sum(s["value"] for s in fam["series"]))

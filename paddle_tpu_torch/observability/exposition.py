"""Prometheus text exposition (format 0.0.4) + a strict parser.

Copied from paddle_tpu/observability/exposition.py (standard library
only): the same snapshot renders to the same bytes in both packages.

`render_prometheus` turns a `MetricsRegistry.snapshot()` into the
`# HELP` / `# TYPE` / sample-line format any Prometheus-compatible
scraper ingests; `parse_prometheus` reads it back into sample dicts.
The parser exists so CI can prove the round-trip is lossless (golden
test) — it is NOT a general scraper (no timestamps, no exemplars,
no OpenMetrics extensions).
"""
from __future__ import annotations

import math
import re

__all__ = ["render_prometheus", "parse_prometheus", "CONTENT_TYPE"]

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def _escape_help(s):
    return s.replace("\\", r"\\").replace("\n", r"\n")


def _escape_label(s):
    return s.replace("\\", r"\\").replace('"', r'\"').replace("\n", r"\n")


def _fmt(v):
    """Integral values print as integers (bucket counts must not grow
    '.0' suffixes), everything else as shortest-repr float. NaN renders
    as the literal the text format defines — a diverged-loss gauge must
    not take the whole scrape down."""
    f = float(v)
    if math.isnan(f):
        return "NaN"
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _labelstr(labels, extra=()):
    items = list(labels.items()) + list(extra)
    if not items:
        return ""
    body = ",".join(f'{k}="{_escape_label(str(v))}"' for k, v in items)
    return "{" + body + "}"


def render_prometheus(snapshot):
    lines = []
    for name in sorted(snapshot):
        fam = snapshot[name]
        if fam["help"]:
            lines.append(f"# HELP {name} {_escape_help(fam['help'])}")
        lines.append(f"# TYPE {name} {fam['type']}")
        for s in fam["series"]:
            if fam["type"] in ("counter", "gauge"):
                lines.append(
                    f"{name}{_labelstr(s['labels'])} {_fmt(s['value'])}")
            else:                                       # histogram
                cum = 0
                for bound, c in zip(fam["buckets"], s["counts"]):
                    cum += c
                    lines.append(
                        f"{name}_bucket"
                        f"{_labelstr(s['labels'], [('le', _fmt(bound))])}"
                        f" {_fmt(cum)}")
                cum += s["counts"][-1]
                lines.append(
                    f"{name}_bucket"
                    f"{_labelstr(s['labels'], [('le', '+Inf')])}"
                    f" {_fmt(cum)}")
                lines.append(f"{name}_sum{_labelstr(s['labels'])}"
                             f" {_fmt(s['sum'])}")
                lines.append(f"{name}_count{_labelstr(s['labels'])}"
                             f" {_fmt(s['count'])}")
    return "\n".join(lines) + "\n"


_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>.*)\})?"
    r"\s+(?P<value>\S+)$")
_LABEL_PAIR_RE = re.compile(
    r'\s*(?P<k>[a-zA-Z_][a-zA-Z0-9_]*)="(?P<v>(?:[^"\\]|\\.)*)"\s*(?:,|$)')


_UNESCAPE_RE = re.compile(r"\\(.)")
_UNESCAPES = {"n": "\n", '"': '"', "\\": "\\"}


def _unescape(s):
    # single left-to-right pass: sequential str.replace would corrupt a
    # literal backslash followed by 'n' (r'\\n' -> '\' + newline)
    return _UNESCAPE_RE.sub(
        lambda m: _UNESCAPES.get(m.group(1), "\\" + m.group(1)), s)


def _parse_value(s):
    if s == "+Inf":
        return math.inf
    if s == "-Inf":
        return -math.inf
    return float(s)


def parse_prometheus(text):
    """text -> {"types": {name: type}, "help": {name: help},
    "samples": [(name, {label: value}, float)]}. Raises ValueError on a
    malformed line (the golden test's round-trip contract)."""
    types, helps, samples = {}, {}, []
    for lineno, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("# HELP "):
            name, _, h = line[len("# HELP "):].partition(" ")
            helps[name] = _unescape(h)
            continue
        if line.startswith("# TYPE "):
            name, _, t = line[len("# TYPE "):].partition(" ")
            types[name] = t
            continue
        if line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            raise ValueError(f"line {lineno}: malformed sample {line!r}")
        labels = {}
        raw = m.group("labels")
        if raw:
            pos = 0
            while pos < len(raw):
                lm = _LABEL_PAIR_RE.match(raw, pos)
                if not lm:
                    raise ValueError(
                        f"line {lineno}: malformed labels {raw!r}")
                labels[lm.group("k")] = _unescape(lm.group("v"))
                pos = lm.end()
        samples.append((m.group("name"), labels,
                        _parse_value(m.group("value"))))
    return {"types": types, "help": helps, "samples": samples}

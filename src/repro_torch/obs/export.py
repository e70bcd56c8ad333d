"""Exporter bridge: telemetry and traces out of the process, losslessly.

The :class:`~repro_torch.obs.metrics.TelemetryHub` and
:class:`~repro_torch.obs.trace.Tracer` keep everything in memory; production
observability needs the same data in formats real tooling reads. Modeled on
OpenFilter's OpenTelemetry bridge (PAPERS.md), two exporters plus an
aggregation layer:

* :class:`JsonlMetricExporter` — an OTLP-ish newline-delimited JSON metric
  exporter. Subscribe it to a hub and every emitted point is written as one
  JSON line (``{"t", "name", "value", "attrs"}``) at emit time — incremental
  export, no buffering, tail-able mid-run. ``load_jsonl_metrics`` reads the
  file back into the exact :class:`MetricPoint` stream (floats round-trip
  bit-exactly through JSON's repr-based encoding).
* :func:`chrome_trace` / :func:`spans_from_chrome_trace` — ``Tracer`` span
  trees as Chrome-trace-format JSON (the ``chrome://tracing`` / Perfetto
  ``traceEvents`` schema), using paired ``B``/``E`` duration events whose
  nesting *is* the span stack. Replan/recalibrate/solver spans become
  viewable in a real trace UI; the reader reconstructs the span tree
  losslessly (exact ``t``/``wall_ms``/attrs ride in ``args``).
* :class:`Counter` / :class:`Gauge` / :class:`Histogram` behind a
  :class:`MetricAggregator` — a pull-side aggregation layer registered on
  the hub: exact percentiles (p50/p95/p99 over e.g. solver ``wall_ms`` and
  per-tick SLO) without scraping the raw point stream.
"""
from __future__ import annotations

import json
import os
from typing import IO, Iterable, Mapping, Optional, Sequence, Union

from repro_torch.obs.metrics import MetricPoint, TelemetryHub
from repro_torch.obs.trace import Span, Tracer

# ---------------------------------------------------------------------------
# JSONL metric exporter (OTLP-ish newline-delimited points)
# ---------------------------------------------------------------------------

_esc = json.encoder.encode_basestring_ascii   # C string escaper


def _jnum(x) -> str:
    """A number exactly as ``json.dumps`` renders it (float repr; the
    non-finite spellings match Python's non-strict JSON dialect)."""
    if type(x) is int:
        return repr(x)
    x = float(x)
    if x != x:
        return "NaN"
    if x == float("inf"):
        return "Infinity"
    if x == float("-inf"):
        return "-Infinity"
    return repr(x)


class JsonlMetricExporter:
    """Hub subscriber writing one JSON line per :class:`MetricPoint`.

    ``hub.subscribe(exporter)`` streams points to ``path`` (or any writable
    file object) as they are emitted. The line schema mirrors
    ``TelemetryHub.to_rows()`` — ``{"t", "name", "value", "attrs"}`` — so the
    file is also directly loadable as JSONL by pandas/jq/OTel collectors.
    Use as a context manager, or ``close()`` explicitly; points written
    before a crash are already on disk (the export is incremental).
    """

    def __init__(self, sink: Union[str, os.PathLike, IO[str]]) -> None:
        if hasattr(sink, "write"):
            self._fh: IO[str] = sink            # caller-owned file object
            self._owns = False
        else:
            self._fh = open(sink, "w", encoding="utf-8")
            self._owns = True
        self.written = 0

    def __call__(self, point: MetricPoint) -> None:
        # hand-rolled line, byte-identical to
        # json.dumps({...}, sort_keys=True): this runs once per emitted
        # point on the event loop's critical path, and the generic encoder
        # is ~3x slower than escaping the four known fields directly
        # (point.attrs is already sorted; "attrs" < "name" < "t" < "value")
        a = point.attrs
        attrs = ("{" + ", ".join(
            _esc(k) + ": " + _esc(v) for k, v in a) + "}") if a else "{}"
        self._fh.write(
            '{"attrs": ' + attrs + ', "name": ' + _esc(point.name) +
            ', "t": ' + _jnum(point.t) +
            ', "value": ' + _jnum(point.value) + "}\n")
        self.written += 1

    def close(self) -> None:
        if self._owns and not self._fh.closed:
            self._fh.close()

    def __enter__(self) -> "JsonlMetricExporter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def load_jsonl_metrics(
        source: Union[str, os.PathLike, IO[str]]) -> list[MetricPoint]:
    """Read a :class:`JsonlMetricExporter` file back into points.

    The round trip is lossless: ``load_jsonl_metrics(path) == hub.points``
    for the hub the exporter was subscribed to (JSON floats are repr-encoded,
    so ``float → text → float`` is bit-exact)."""
    if hasattr(source, "read"):
        lines = source.read().splitlines()
    else:
        with open(source, "r", encoding="utf-8") as fh:
            lines = fh.read().splitlines()
    out: list[MetricPoint] = []
    for line in lines:
        if not line.strip():
            continue
        row = json.loads(line)
        out.append(MetricPoint(
            t=row["t"], name=row["name"], value=row["value"],
            attrs=tuple(sorted((k, str(v))
                               for k, v in row["attrs"].items()))))
    return out


# ---------------------------------------------------------------------------
# Chrome-trace-format exporter (chrome://tracing / Perfetto "traceEvents")
# ---------------------------------------------------------------------------

_TRACE_PID = 1          # one simulated fleet = one "process" in the UI


def _emit_span(span: Span, events: list[dict], cursor_us: float,
               tid: int) -> float:
    """Append the B/E event pair for ``span`` (children nested between),
    returning the cursor after the span. The synthesized ``ts`` timeline
    lays children out sequentially inside their parent — a span's recorded
    ``wall_ms`` includes its children's, so containment holds and the trace
    UI renders the tree; the *exact* values ride in ``args``."""
    dur_us = span.wall_ms * 1e3
    child_us = sum(c.wall_ms for c in span.children) * 1e3
    dur_us = max(dur_us, child_us)        # float-rounding guard: contain kids
    events.append({
        "ph": "B", "name": span.name, "pid": _TRACE_PID, "tid": tid,
        "ts": cursor_us, "cat": "replan",
        "args": {"t": span.t, "wall_ms": span.wall_ms,
                 "attrs": dict(span.attrs)},
    })
    child_cursor = cursor_us
    for child in span.children:
        child_cursor = _emit_span(child, events, child_cursor, tid)
    events.append({"ph": "E", "name": span.name, "pid": _TRACE_PID,
                   "tid": tid, "ts": cursor_us + dur_us, "cat": "replan"})
    return cursor_us + dur_us


def chrome_trace(tracer_or_spans: Union[Tracer, Sequence[Span]]) -> dict:
    """A ``chrome://tracing``-loadable document for a tracer's span trees.

    Root spans are laid out sequentially on one thread track; nesting uses
    paired ``B``/``E`` duration events, whose stack discipline mirrors the
    tracer's call stack exactly. Load the written file in
    ``chrome://tracing`` or https://ui.perfetto.dev to browse replan /
    recalibrate / solver spans on a zoomable timeline."""
    spans = (tracer_or_spans.spans if isinstance(tracer_or_spans, Tracer)
             else list(tracer_or_spans))
    events: list[dict] = []
    cursor = 0.0
    for root in spans:
        cursor = _emit_span(root, events, cursor, tid=1)
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        # the JAX package's tag, kept so both packages write the same bytes
        "otherData": {"source": "repro.obs", "spans": len(spans)},
    }


def write_chrome_trace(path: Union[str, os.PathLike],
                       tracer_or_spans: Union[Tracer, Sequence[Span]]) -> int:
    """Write :func:`chrome_trace` JSON to ``path``; returns the event count."""
    doc = chrome_trace(tracer_or_spans)
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(doc, fh, sort_keys=True)
    return len(doc["traceEvents"])


def spans_from_chrome_trace(
        source: Union[str, os.PathLike, Mapping, IO[str]]) -> list[Span]:
    """Reconstruct the span trees from a :func:`chrome_trace` document.

    Replays the ``B``/``E`` event stack in file order; ``name``, simulated
    ``t``, exact ``wall_ms``, attrs, and the child structure all round-trip
    losslessly (asserted by ``chip_smoke.py``'s observability phase)."""
    if hasattr(source, "read"):
        doc = json.load(source)
    elif isinstance(source, Mapping):
        doc = source
    else:
        with open(source, "r", encoding="utf-8") as fh:
            doc = json.load(fh)
    roots: list[Span] = []
    stack: list[Span] = []
    for e in doc["traceEvents"]:
        if e["ph"] == "B":
            args = e.get("args", {})
            sp = Span(name=e["name"], t=args.get("t", 0.0),
                      wall_ms=args.get("wall_ms", 0.0),
                      attrs=dict(args.get("attrs", {})))
            if stack:
                stack[-1].children.append(sp)
            else:
                roots.append(sp)
            stack.append(sp)
        elif e["ph"] == "E":
            if not stack or stack[-1].name != e["name"]:
                raise ValueError(
                    f"unbalanced trace: E {e['name']!r} does not close "
                    f"{stack[-1].name if stack else 'an empty stack'!r}")
            stack.pop()
    if stack:
        raise ValueError(f"unbalanced trace: {len(stack)} spans never closed")
    return roots


# ---------------------------------------------------------------------------
# Aggregation layer: Counter / Gauge / Histogram on the hub
# ---------------------------------------------------------------------------


class Counter:
    """Monotonic sum of observed values (e.g. preemption counts)."""

    def __init__(self, name: str) -> None:
        self.name = name
        self.total = 0.0
        self.n = 0

    def observe(self, value: float) -> None:
        self.total += value
        self.n += 1

    def summary(self) -> dict:
        return {"kind": "counter", "total": self.total, "points": self.n}


class Gauge:
    """Last-value-wins (e.g. live instance count)."""

    def __init__(self, name: str) -> None:
        self.name = name
        self.value: Optional[float] = None
        self.t: Optional[float] = None
        self.n = 0

    def observe(self, value: float, t: Optional[float] = None) -> None:
        self.value = value
        self.t = t
        self.n += 1

    def summary(self) -> dict:
        return {"kind": "gauge", "value": self.value, "t": self.t,
                "points": self.n}


class Histogram:
    """Exact distribution of observed values.

    Keeps every sample (fleet runs emit thousands of points, not millions),
    so percentiles are *exact* — the nearest-rank p50/p95/p99 the benchmark
    gates quote — rather than bucket-approximated."""

    def __init__(self, name: str) -> None:
        self.name = name
        self.values: list[float] = []

    def observe(self, value: float) -> None:
        self.values.append(value)

    def percentile(self, p: float) -> Optional[float]:
        """Exact nearest-rank percentile; None on an empty histogram."""
        if not self.values:
            return None
        ordered = sorted(self.values)
        k = max(0, min(len(ordered) - 1,
                       int(round(p * (len(ordered) - 1)))))
        return ordered[k]

    def summary(self) -> dict:
        if not self.values:
            return {"kind": "histogram", "count": 0}
        return {
            "kind": "histogram", "count": len(self.values),
            "sum": sum(self.values),
            "min": min(self.values), "max": max(self.values),
            "mean": sum(self.values) / len(self.values),
            "p50": self.percentile(0.50),
            "p95": self.percentile(0.95),
            "p99": self.percentile(0.99),
        }


class MetricAggregator:
    """Routes hub points into registered instruments by metric name.

    ``agg = MetricAggregator(hub)`` subscribes itself; register instruments
    (``agg.histogram("replan.wall_ms")``, ``agg.gauge("fleet.slo")``) and
    read ``agg.summary()`` at any time — including mid-run, since routing
    happens synchronously at emit time. Unregistered names pass through
    untouched (the raw stream still lives on the hub)."""

    def __init__(self, hub: Optional[TelemetryHub] = None) -> None:
        self.instruments: dict[str, Union[Counter, Gauge, Histogram]] = {}
        if hub is not None:
            hub.subscribe(self)

    def counter(self, name: str) -> Counter:
        return self._register(name, Counter(name))

    def gauge(self, name: str) -> Gauge:
        return self._register(name, Gauge(name))

    def histogram(self, name: str) -> Histogram:
        return self._register(name, Histogram(name))

    def _register(self, name, inst):
        if name in self.instruments:
            existing = self.instruments[name]
            if type(existing) is not type(inst):
                raise ValueError(
                    f"metric {name!r} already registered as "
                    f"{type(existing).__name__}")
            return existing
        self.instruments[name] = inst
        return inst

    def __call__(self, point: MetricPoint) -> None:
        inst = self.instruments.get(point.name)
        if inst is None:
            return
        if isinstance(inst, Gauge):
            inst.observe(point.value, point.t)
        else:
            inst.observe(point.value)

    def summary(self) -> dict:
        """JSON-ready per-instrument summaries (benchmark artifacts)."""
        return {name: inst.summary()
                for name, inst in sorted(self.instruments.items())}


def hub_with_exporters(
        jsonl_path: Optional[Union[str, os.PathLike]] = None,
        histograms: Iterable[str] = ("replan.wall_ms", "fleet.slo"),
) -> tuple[TelemetryHub, Optional[JsonlMetricExporter], MetricAggregator]:
    """Convenience wiring: a hub with a JSONL exporter (when ``jsonl_path``
    is given) and an aggregator with histograms over ``histograms``."""
    hub = TelemetryHub()
    exporter = None
    if jsonl_path is not None:
        exporter = JsonlMetricExporter(jsonl_path)
        hub.subscribe(exporter)
    agg = MetricAggregator(hub)
    for name in histograms:
        agg.histogram(name)
    return hub, exporter, agg

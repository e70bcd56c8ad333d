"""The exporter bridge on the port (the twin of ``test_obs_export.py``): JSONL
metric export, Chrome-trace export and the Counter/Gauge/Histogram layer,
every round trip lossless. Then the port against the reference: ``_jnum``
and the JSONL line over awkward numbers, exact percentiles on seeded
samples, and the JSONL and Chrome-trace files of whole runs byte for byte,
with one stepping clock in both packages' ``obs.trace`` (the span and
``replan.wall_ms`` times are the only inputs that differ between runs).
Tolerance: exact.
"""
import io
import json

import numpy as np
import pytest

pytest.importorskip("torch")

import repro.core as RC  # noqa: E402
import repro.obs as RO  # noqa: E402
import repro.obs.export as ref_export  # noqa: E402
import repro.obs.trace as ref_trace  # noqa: E402
import repro.sim as RS  # noqa: E402
import repro_torch.core as PC  # noqa: E402
import repro_torch.obs as PO  # noqa: E402
import repro_torch.obs.export as port_export  # noqa: E402
import repro_torch.obs.trace as port_trace  # noqa: E402
import repro_torch.sim as PS  # noqa: E402
from repro_torch.obs import (Counter, Gauge, Histogram,  # noqa: E402
                             JsonlMetricExporter, MetricAggregator,
                             TelemetryHub, Tracer, chrome_trace,
                             hub_with_exporters, load_jsonl_metrics,
                             spans_from_chrome_trace, write_chrome_trace)

SIDES = {"ref": (RC, RS, RO), "port": (PC, PS, PO)}


class SteppingClock:
    """Stands in for the ``time`` module of one package's ``obs.trace``:
    each ``perf_counter()`` call advances 0.25 ms."""

    def __init__(self) -> None:
        self.now = 0.0

    def perf_counter(self) -> float:
        self.now += 0.25e-3
        return self.now


@pytest.fixture
def same_clock(monkeypatch):
    monkeypatch.setattr(ref_trace, "time", SteppingClock())
    monkeypatch.setattr(port_trace, "time", SteppingClock())


# -- JSONL metric export -------------------------------------------------------

def _emit_some(hub):
    hub.emit(0.0, "fleet.cost.usd", 12.5)
    hub.emit(0.5, "drift.rel_error", 1 / 3, region="ap-northeast-1")
    hub.emit(1.0, "fleet.slo", 0.987654321012345678)
    hub.emit(1.0, "fleet.instances.live", 7.0, market="spot", region="x")


def test_jsonl_export_roundtrips_exactly(tmp_path):
    path = tmp_path / "metrics.jsonl"
    hub = TelemetryHub()
    exporter = JsonlMetricExporter(path)
    hub.subscribe(exporter)
    _emit_some(hub)
    exporter.close()
    assert exporter.written == 4
    assert load_jsonl_metrics(path) == hub.points
    rows = [json.loads(line) for line in path.read_text().splitlines()]
    assert rows[1]["attrs"] == {"region": "ap-northeast-1"}
    assert rows[2]["value"] == 0.987654321012345678


def test_jsonl_export_is_incremental_and_takes_file_objects():
    buf = io.StringIO()
    hub = TelemetryHub()
    hub.subscribe(JsonlMetricExporter(buf))
    hub.emit(0.0, "a", 1.0)
    assert buf.getvalue().count("\n") == 1
    hub.emit(1.0, "b", 2.0)
    assert load_jsonl_metrics(io.StringIO(buf.getvalue())) == hub.points


def test_jsonl_exporter_context_manager_closes_owned_file(tmp_path):
    path = tmp_path / "m.jsonl"
    hub = TelemetryHub()
    with JsonlMetricExporter(path) as exporter:
        hub.subscribe(exporter)
        hub.emit(0.0, "a", 1.0)
    assert exporter._fh.closed
    hub.emit(1.0, "b", 2.0)
    assert len(hub.subscriber_failures) == 1
    assert len(hub.points) == 2


# -- Chrome-trace export -------------------------------------------------------

def _traced(tracer_cls=Tracer):
    tr = tracer_cls()
    with tr.span("recalibrate", t=14.0, regions="ap-northeast-1") as sp:
        with tr.span("replan.decide", t=14.0) as inner:
            inner.attrs["action"] = "forced-replan"
            inner.attrs["migrations"] = 8
        sp.attrs["plan_cost_usd_per_h"] = 36.7
    with tr.span("replan.decide", t=15.0):
        pass
    return tr


def _spans_equal(a, b):
    return (a.name == b.name and a.t == b.t and a.wall_ms == b.wall_ms
            and a.attrs == b.attrs and len(a.children) == len(b.children)
            and all(_spans_equal(x, y)
                    for x, y in zip(a.children, b.children)))


def test_chrome_trace_roundtrips_span_trees(tmp_path):
    tr = _traced()
    path = tmp_path / "trace.json"
    n_events = write_chrome_trace(path, tr)
    assert n_events == 6
    rebuilt = spans_from_chrome_trace(path)
    assert len(rebuilt) == len(tr.spans)
    assert all(_spans_equal(x, y) for x, y in zip(rebuilt, tr.spans))


def test_chrome_trace_event_stream_is_viewer_valid():
    doc = chrome_trace(_traced())
    events = doc["traceEvents"]
    assert doc["displayTimeUnit"] == "ms"
    stack = []
    for e in events:
        if e["ph"] == "B":
            if stack:
                assert e["ts"] >= stack[-1][1]
            stack.append((e["name"], e["ts"]))
        else:
            name, ts_b = stack.pop()
            assert name == e["name"]
            assert e["ts"] >= ts_b
    assert not stack
    begins = [e["args"] for e in events if e["ph"] == "B"]
    assert begins[0]["t"] == 14.0
    assert begins[1]["attrs"]["migrations"] == 8


def test_chrome_trace_reader_rejects_unbalanced_documents():
    doc = chrome_trace(_traced())
    with pytest.raises(ValueError, match="unbalanced"):
        spans_from_chrome_trace({"traceEvents": doc["traceEvents"][:-1]})
    swapped = {"traceEvents": [
        {"ph": "B", "name": "a", "args": {}},
        {"ph": "E", "name": "b"}]}
    with pytest.raises(ValueError, match="unbalanced"):
        spans_from_chrome_trace(swapped)


# -- aggregation layer ---------------------------------------------------------

def test_histogram_percentiles_are_exact_nearest_rank():
    h = Histogram("replan.wall_ms")
    assert h.percentile(0.5) is None
    for v in [5.0, 1.0, 9.0, 3.0, 7.0]:
        h.observe(v)
    assert h.percentile(0.0) == 1.0
    assert h.percentile(0.5) == 5.0
    assert h.percentile(1.0) == 9.0
    s = h.summary()
    assert s["count"] == 5 and s["min"] == 1.0 and s["max"] == 9.0
    assert s["mean"] == pytest.approx(5.0)
    assert s["p50"] == 5.0 and s["p99"] == 9.0


def test_counter_and_gauge_semantics():
    c = Counter("fleet.preemptions")
    c.observe(2.0)
    c.observe(3.0)
    assert c.summary() == {"kind": "counter", "total": 5.0, "points": 2}
    g = Gauge("fleet.instances.live")
    g.observe(4.0, t=0.0)
    g.observe(6.0, t=1.0)
    assert g.summary() == {"kind": "gauge", "value": 6.0, "t": 1.0,
                           "points": 2}


def test_aggregator_routes_by_name_and_rejects_type_conflicts():
    hub = TelemetryHub()
    agg = MetricAggregator(hub)
    hist = agg.histogram("replan.wall_ms")
    gauge = agg.gauge("fleet.slo")
    hub.emit(0.0, "replan.wall_ms", 4.0)
    hub.emit(0.0, "fleet.slo", 0.99)
    hub.emit(0.0, "unregistered.metric", 1.0)
    hub.emit(1.0, "replan.wall_ms", 8.0)
    assert hist.values == [4.0, 8.0]
    assert gauge.value == 0.99
    assert agg.histogram("replan.wall_ms") is hist
    with pytest.raises(ValueError, match="already registered"):
        agg.counter("replan.wall_ms")
    summary = agg.summary()
    assert set(summary) == {"replan.wall_ms", "fleet.slo"}
    assert summary["replan.wall_ms"]["p50"] == 4.0
    assert summary["replan.wall_ms"]["p99"] == 8.0


def test_hub_with_exporters_wiring(tmp_path):
    path = tmp_path / "m.jsonl"
    hub, exporter, agg = hub_with_exporters(path)
    hub.emit(0.0, "replan.wall_ms", 2.5)
    hub.emit(0.0, "fleet.slo", 0.9)
    exporter.close()
    assert load_jsonl_metrics(path) == hub.points
    assert agg.instruments["replan.wall_ms"].values == [2.5]
    hub2, exporter2, agg2 = hub_with_exporters(None, histograms=("x",))
    assert exporter2 is None
    hub2.emit(0.0, "x", 1.0)
    assert agg2.instruments["x"].values == [1.0]


# -- the port against the reference --------------------------------------------

AWKWARD = [0, -3, 2 ** 70, 0.1, -0.0, 1e-320, 1.7976931348623157e308,
           1 / 3, 123456789.125, float("inf"), float("-inf"), float("nan"),
           True, np.float64(2.5), np.int64(7)]


@pytest.mark.parametrize("x", AWKWARD, ids=repr)
def test_jnum_renders_numbers_as_the_reference_and_json(x):
    assert port_export._jnum(x) == ref_export._jnum(x)
    if type(x) is int or isinstance(x, float):
        assert port_export._jnum(x) == json.dumps(x)


def _lines(obs, emits) -> str:
    buf = io.StringIO()
    hub = obs.TelemetryHub()
    hub.subscribe(obs.JsonlMetricExporter(buf))
    for t, name, value, attrs in emits:
        hub.emit(t, name, value, **attrs)
    return buf.getvalue()


def test_jsonl_lines_are_the_references_and_json_dumps():
    rng = np.random.default_rng(5)
    emits = [(float(t) / 7, name, float(rng.normal()) * 10 ** int(e), attrs)
             for t, (name, e, attrs) in enumerate([
                 ("fleet.cost.usd", 0, {}), ("drift.rel_error", -5,
                                              {"region": "ap-northeast-1"}),
                 ("x\"q\\uote", 12, {"kéy": "v☃", "a": "1"}),
                 ("fleet.slo", -300, {"market": "spot", "region": "x"})] * 3)]
    emits.append((1.0, "nan.metric", float("nan"), {}))
    got = _lines(PO, emits)
    assert got == _lines(RO, emits)
    hub = TelemetryHub()
    for t, name, value, attrs in emits:
        hub.emit(t, name, value, **attrs)
    assert got.splitlines() == [json.dumps(r, sort_keys=True)
                                for r in hub.to_rows()]


@pytest.mark.parametrize("n", [1, 2, 7, 100, 1001])
def test_histogram_percentiles_match_reference(n):
    values = list(np.random.default_rng(n).lognormal(size=n))
    port, ref = Histogram("h"), RO.Histogram("h")
    for v in values:
        port.observe(v)
        ref.observe(v)
    assert port.summary() == ref.summary()
    for p in (0.0, 0.01, 0.25, 0.5, 0.95, 0.99, 1.0):
        assert port.percentile(p) == ref.percentile(p)
    assert port.percentile(0.5) in values


def _regional_arm(side: str, regional: bool, jsonl):
    core, sim, obs = SIDES[side]
    sc = sim.SCENARIOS["regional_drift"](n_streams=96, duration_h=24.0,
                                         seed=0)
    cat = sc.catalog()
    inner = sim.RepairPolicy(core.ResourceManager(cat), migration_budget=12,
                             defrag_ratio=1.25)
    hub, exporter, agg = obs.hub_with_exporters(jsonl)
    if regional:
        policy = obs.RegionalRecalibratingPolicy(
            inner, sc.service, group_of=sc.groups.__getitem__,
            telemetry=hub, tracer=obs.Tracer())
    else:
        policy = obs.RecalibratingPolicy(
            inner, sc.service, probe=obs.WindowedServiceProbe(sc.service),
            telemetry=hub, tracer=obs.Tracer())
    sim.FleetSimulator(sc.demand, policy, cat, sc.config, service=sc.service,
                       telemetry=hub).run()
    exporter.close()
    return policy, agg


def _drift_arm(side: str, jsonl):
    core, sim, obs = SIDES[side]
    sc = sim.SCENARIOS["drifting_scene"](n_streams=72, duration_h=24.0,
                                         seed=0)
    cat = sc.catalog()
    hub, exporter, agg = obs.hub_with_exporters(jsonl)
    policy = obs.RecalibratingPolicy(
        sim.RepairPolicy(core.ResourceManager(cat), migration_budget=24,
                         defrag_ratio=1.25),
        sc.service, telemetry=hub, tracer=obs.Tracer())
    sim.FleetSimulator(sc.demand, policy, cat, sc.config, service=sc.service,
                       telemetry=hub).run()
    exporter.close()
    return policy, agg


@pytest.mark.parametrize("arm", ["drifting_scene", "regional fleet-wide",
                                 "regional per-group"])
def test_exported_files_are_the_references_byte_for_byte(same_clock,
                                                         tmp_path, arm):
    files = {}
    for side in ("ref", "port"):
        jsonl = tmp_path / f"{side}.jsonl"
        if arm == "drifting_scene":
            policy, agg = _drift_arm(side, jsonl)
        else:
            policy, agg = _regional_arm(side, arm.endswith("per-group"),
                                        jsonl)
        mod = SIDES[side][2]
        trace = tmp_path / f"{side}.trace.json"
        mod.write_chrome_trace(trace, policy.tracer)
        files[side] = (jsonl.read_bytes(), trace.read_bytes(),
                       agg.summary())
        assert len(mod.load_jsonl_metrics(jsonl)) == \
            len(policy.telemetry.points)
    assert files["port"][0] == files["ref"][0]
    assert files["port"][1] == files["ref"][1]
    assert files["port"][2] == files["ref"][2]
    assert files["port"][2]["replan.wall_ms"]["count"] == 24
    rebuilt = spans_from_chrome_trace(tmp_path / "port.trace.json")
    assert len(rebuilt) == 24

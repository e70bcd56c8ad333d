"""The observability layer on the port (the twin of ``test_obs.py``): the
telemetry hub, trace spans, the drift detector, the drifting service, the
cluster's telemetry hooks and the recalibrating policy closing the
profile→pack→observe loop through the port's ``FleetSimulator``. Then the
port against the reference on the same seeded inputs: the detector's verdict
histories, and ``drifting_scene`` (the reference test's 24 streams and the
benchmark's 72, stale and online) by recalibration times, ``float.hex`` of
the ledger, adaptive events and the hub's points under one stepping clock in
both packages' ``obs.trace``. Last, the import order of a fresh interpreter
and the public API. Tolerance: exact, as the reference's tests are, but where
they use ``approx``.
"""
import dataclasses
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

import repro.core as RC  # noqa: E402
import repro.obs as RO  # noqa: E402
import repro.obs.trace as ref_trace  # noqa: E402
import repro.sim as RS  # noqa: E402
import repro_torch.core as PC  # noqa: E402
import repro_torch.obs as PO  # noqa: E402
import repro_torch.obs.trace as port_trace  # noqa: E402
import repro_torch.sim as PS  # noqa: E402
from repro_torch.core import fig6_catalog  # noqa: E402
from repro_torch.core.manager import ResourceManager  # noqa: E402
from repro_torch.core.strategies import Plan  # noqa: E402
from repro_torch.core.workload import PROGRAMS, Stream  # noqa: E402
from repro_torch.obs import (DriftConfig, DriftDetector,  # noqa: E402
                             DriftingService, MetricPoint, RateShift,
                             RecalibratingPolicy, TelemetryHub, Tracer)
from repro_torch.sim import (SCENARIOS, FleetSimulator,  # noqa: E402
                             RepairPolicy, ServiceCalibration)
from repro_torch.sim.cluster import Cluster  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
SIDES = {"ref": (RC, RS, RO), "port": (PC, PS, PO)}


class SteppingClock:
    """Stands in for the ``time`` module of one package's ``obs.trace``:
    each ``perf_counter()`` call advances 0.25 ms, so span wall times are a
    function of the calls made, the same in both packages."""

    def __init__(self) -> None:
        self.now = 0.0

    def perf_counter(self) -> float:
        self.now += 0.25e-3
        return self.now


@pytest.fixture
def same_clock(monkeypatch):
    monkeypatch.setattr(ref_trace, "time", SteppingClock())
    monkeypatch.setattr(port_trace, "time", SteppingClock())


# -- telemetry hub -------------------------------------------------------------

def test_hub_emit_subscribe_and_series():
    hub = TelemetryHub()
    seen = []
    hub.subscribe(seen.append)
    hub.emit(0.0, "fleet.cost.usd", 1.5)
    hub.emit(1.0, "fleet.cost.usd", 2.5, market="spot")
    hub.emit(1.0, "fleet.slo", 0.99)
    assert [p.name for p in seen] == ["fleet.cost.usd", "fleet.cost.usd",
                                      "fleet.slo"]
    assert seen[1].attr("market") == "spot"
    assert seen[1].attr("missing") is None
    assert hub.latest("fleet.cost.usd") == 2.5
    assert hub.latest("never") is None
    assert hub.series("fleet.cost.usd") == [(0.0, 1.5), (1.0, 2.5)]
    assert hub.names() == ["fleet.cost.usd", "fleet.slo"]
    rows = hub.to_rows()
    assert rows[1] == {"t": 1.0, "name": "fleet.cost.usd", "value": 2.5,
                       "attrs": {"market": "spot"}}


def test_metric_points_are_frozen_and_hashable():
    p = MetricPoint(0.0, "x", 1.0, (("k", "v"),))
    assert p in {p}
    with pytest.raises(dataclasses.FrozenInstanceError):
        p.value = 2.0  # type: ignore[misc]


# -- tracer --------------------------------------------------------------------

def test_tracer_nests_spans_by_call_stack():
    tr = Tracer()
    with tr.span("recalibrate", t=14.0, rel_error=0.65):
        with tr.span("replan.decide", t=14.0) as inner:
            inner.attrs["action"] = "forced-replan"
    assert len(tr.spans) == 1
    root = tr.spans[0]
    assert root.name == "recalibrate"
    assert root.attrs["rel_error"] == 0.65
    assert [c.name for c in root.children] == ["replan.decide"]
    assert root.children[0].attrs["action"] == "forced-replan"
    assert root.wall_ms >= root.children[0].wall_ms >= 0.0
    assert len(tr.find("replan.decide")) == 1
    rows = tr.to_rows()
    assert [(r["name"], r["depth"]) for r in rows] == [
        ("recalibrate", 0), ("replan.decide", 1)]


# -- drift detector ------------------------------------------------------------

def _calib(rates, default=None):
    return ServiceCalibration(rates_tokens_per_s=rates, default_rate=default)


def test_detector_fires_after_hold_ticks_and_resets():
    det = DriftDetector(DriftConfig(rel_threshold=0.25, hold_ticks=3))
    cal = _calib({"a": 100.0})
    for k, t in enumerate((0.0, 1.0)):
        v = det.observe(t, {"a": 40.0}, cal)
        assert v.drifting and not v.fired and v.streak == k + 1
    v = det.observe(2.0, {"a": 40.0}, cal)
    assert v.fired and v.streak == 3
    assert v.rel_error == pytest.approx(0.6)
    det.reset()
    assert det.streak == 0
    v = det.observe(3.0, {"a": 100.0}, cal)
    assert not v.drifting and v.streak == 0
    assert len(det.history) == 4


def test_detector_streak_resets_on_healthy_window():
    det = DriftDetector(DriftConfig(rel_threshold=0.25, hold_ticks=3))
    cal = _calib({"a": 100.0})
    det.observe(0.0, {"a": 40.0}, cal)
    det.observe(1.0, {"a": 40.0}, cal)
    v = det.observe(2.0, {"a": 100.0}, cal)
    assert v.streak == 0
    v = det.observe(3.0, {"a": 40.0}, cal)
    assert v.streak == 1 and not v.fired


def test_detector_empty_measurement_is_no_evidence():
    det = DriftDetector(DriftConfig(rel_threshold=0.25, hold_ticks=2))
    cal = _calib({"a": 100.0})
    det.observe(0.0, {"a": 40.0}, cal)
    v = det.observe(1.0, {}, cal)
    assert v.n_streams == 0 and not v.fired
    assert v.streak == 1
    v = det.observe(2.0, {"a": 40.0}, cal)
    assert v.streak == 2 and v.fired


def test_detector_skips_unprofiled_and_tiny_rates():
    det = DriftDetector(DriftConfig(rel_threshold=0.25, hold_ticks=1))
    cal = _calib({"a": 100.0, "z": 0.0})
    v = det.observe(0.0, {"a": 100.0, "b": 5.0, "z": 7.0}, cal)
    assert v.n_streams == 1 and not v.drifting
    v = det.observe(1.0, {"b": 5.0}, _calib({}, default=50.0))
    assert v.n_streams == 1 and v.drifting


def test_detector_defaults_are_the_references():
    assert DriftConfig() == DriftConfig(rel_threshold=0.25, hold_ticks=3,
                                        min_rate=1e-9)
    assert dataclasses.astuple(DriftConfig()) == \
        dataclasses.astuple(RO.DriftConfig())


# -- drifting service (ground truth + probe) -----------------------------------

def test_drifting_service_shifts_compose_and_scope():
    svc = DriftingService(
        {"a": 80.0, "b": 80.0}, tokens_per_frame=8.0,
        shifts=(RateShift(at_h=6.0, factor=0.5),
                RateShift(at_h=12.0, factor=0.5, streams=frozenset({"a"}))))
    assert svc.measure(0.0) == {"a": 80.0, "b": 80.0}
    assert svc.measure(6.0) == {"a": 40.0, "b": 40.0}
    assert svc.measure(13.0) == {"a": 20.0, "b": 40.0}
    assert svc.frame_rate_cap("a", 13.0) == pytest.approx(2.5)
    assert svc.frame_rate_cap("unknown", 13.0) == math.inf
    cal0 = svc.initial_calibration()
    assert cal0.rates_tokens_per_s == {"a": 80.0, "b": 80.0}
    assert cal0.default_rate == pytest.approx(80.0)
    assert svc.calibration_at(13.0).rates_tokens_per_s["a"] == 20.0


# -- cluster telemetry hooks ---------------------------------------------------

def test_cluster_lifecycle_reaches_telemetry():
    hub = TelemetryHub()
    cl = Cluster(boot_delay_h=0.05, telemetry=hub)
    inst = cl._boot(1.0, "m4@us-east", "m4.xlarge", "us-east", 0.2)
    cl.terminate(inst.instance_id, 2.0)
    cl.terminate(inst.instance_id, 3.0)
    boots = [p for p in hub.points if p.name == "cluster.instance.boot"]
    terms = [p for p in hub.points if p.name == "cluster.instance.terminate"]
    assert len(boots) == 1 and len(terms) == 1
    assert boots[0].attr("location") == "us-east"
    assert terms[0].t == 2.0
    assert terms[0].attr("preempted") == "False"


# -- recalibrating policy end to end -------------------------------------------

def _drift_run(online: bool):
    sc = SCENARIOS["drifting_scene"](n_streams=24, duration_h=24.0, seed=0)
    cat = sc.catalog()
    inner = RepairPolicy(ResourceManager(cat), migration_budget=8,
                         defrag_ratio=1.25)
    cfg = DriftConfig() if online else DriftConfig(rel_threshold=math.inf)
    policy = RecalibratingPolicy(inner, sc.service,
                                 detector=DriftDetector(cfg))
    ledger = FleetSimulator(sc.demand, policy, cat, sc.config,
                            service=sc.service,
                            telemetry=policy.telemetry).run()
    return policy, ledger


def test_recalibration_closes_the_loop_on_drifting_scene():
    policy, ledger = _drift_run(online=True)
    assert len(policy.recalibrations) >= 1
    fired = policy.recalibrations[0]
    assert 12.0 <= fired <= 12.0 + policy.detector.config.hold_ticks
    assert ledger.recalibrations == len(policy.recalibrations)
    assert ledger.calib_max_rel_error > 0.25
    rec = next(r for r in ledger.records if r.recalibrations)
    assert rec.t >= fired
    flagged = [e for e in policy.adaptive.events if e.recalibration]
    assert len(flagged) == len(policy.recalibrations)
    assert all(e.action == "forced-replan" for e in flagged)
    assert policy.telemetry.latest("drift.recalibrations") == 1.0
    assert policy.telemetry.series("fleet.cost.usd")
    recal_spans = policy.tracer.find("recalibrate")
    assert len(recal_spans) == 1
    assert recal_spans[0].children[0].name == "replan.decide"
    assert policy.last_drift is not None
    assert policy.last_drift.rel_error < 0.01


def test_online_recalibration_beats_stale_profile():
    _, stale = _drift_run(online=False)
    _, online = _drift_run(online=True)
    assert stale.recalibrations == 0
    assert online.total_cost < stale.total_cost
    assert online.slo_attainment() >= stale.slo_attainment() - 0.005
    assert online.frames_demanded == pytest.approx(stale.frames_demanded)


def test_recalibrating_policy_clamps_planned_rates():
    svc = DriftingService({"cam": 16.0}, tokens_per_frame=8.0)
    cat = fig6_catalog()
    policy = RecalibratingPolicy(RepairPolicy(ResourceManager(cat)), svc)
    clamped = policy._clamped(
        [Stream("cam", PROGRAMS["ZF"], fps=6.0, camera="nyc"),
         Stream("slow", PROGRAMS["ZF"], fps=1.0, camera="nyc")])
    assert clamped[0].fps == pytest.approx(2.0)
    assert clamped[1].fps == pytest.approx(1.0)
    plan = policy.decide(0, clamped)
    assert isinstance(plan, Plan)


# -- subscriber isolation (hub) and error finalization (tracer) ----------------

def test_hub_isolates_raising_subscriber():
    hub = TelemetryHub()
    before, after = [], []

    def bomb(point):
        raise RuntimeError("closed file")

    hub.subscribe(before.append)
    hub.subscribe(bomb)
    hub.subscribe(after.append)
    p1 = hub.emit(0.0, "fleet.cost.usd", 1.0)
    p2 = hub.emit(1.0, "fleet.cost.usd", 2.0)
    assert before == [p1, p2]
    assert after == [p1, p2]
    assert hub.series("fleet.cost.usd") == [(0.0, 1.0), (1.0, 2.0)]
    assert len(hub.subscriber_failures) == 2
    t, who, err = hub.subscriber_failures[0]
    assert t == 0.0
    assert "bomb" in who
    assert "RuntimeError: closed file" in err


def test_tracer_finalizes_span_when_body_raises():
    tr = Tracer()
    with pytest.raises(ValueError, match="solver blew up"):
        with tr.span("recalibrate", t=3.0):
            with tr.span("replan.decide", t=3.0):
                raise ValueError("solver blew up")
    assert len(tr.spans) == 1
    root = tr.spans[0]
    assert root.name == "recalibrate"
    assert [c.name for c in root.children] == ["replan.decide"]
    assert root.children[0].attrs["error"] == "ValueError: solver blew up"
    assert root.attrs["error"] == "ValueError: solver blew up"
    assert root.wall_ms >= root.children[0].wall_ms >= 0.0
    with tr.span("replan.decide", t=4.0):
        pass
    assert [s.name for s in tr.spans] == ["recalibrate", "replan.decide"]
    assert tr.spans[1].children == []
    assert "error" not in tr.spans[1].attrs


def test_tracer_explicit_error_attr_wins_over_finalizer():
    tr = Tracer()
    with pytest.raises(RuntimeError):
        with tr.span("replan.decide") as sp:
            sp.attrs["error"] = "already diagnosed"
            raise RuntimeError("later failure")
    assert tr.spans[0].attrs["error"] == "already diagnosed"


def test_span_wall_ms_reads_the_trace_modules_clock(same_clock):
    """``wall_ms`` is two ``perf_counter`` reads of ``obs.trace``'s clock:
    with the stepping clock a leaf span is one step, its parent three."""
    tr = Tracer()
    with tr.span("recalibrate"):
        with tr.span("replan.decide"):
            pass
    assert tr.spans[0].children[0].wall_ms == pytest.approx(0.25)
    assert tr.spans[0].wall_ms == pytest.approx(0.75)


# -- the port against the reference ----------------------------------------------

def _verdicts(side: str, seed: int, cfg_args: dict) -> list:
    """A detector over 40 seeded windows of up to 6 streams, one of them
    unprofiled: healthy noise, a regression from window 15 to 29, and idle
    windows (no data) throughout; the streak is reset after every firing,
    as a recalibrating policy does."""
    _, sim, obs = SIDES[side]
    rng = np.random.default_rng(seed)
    cal = sim.ServiceCalibration(rates_tokens_per_s={
        f"s{i}": float(rng.uniform(20.0, 90.0)) for i in range(5)},
        default_rate=None if seed % 2 else 55.0)
    det = obs.DriftDetector(obs.DriftConfig(**cfg_args))
    for t in range(40):
        low = 0.2 if 15 <= t < 30 else 0.8
        measured = {} if rng.random() < 0.15 else {
            f"s{i}": float(cal.rates_tokens_per_s.get(f"s{i}", 55.0)
                           * rng.uniform(low, low + 0.4))
            for i in range(6) if rng.random() < 0.8}
        v = det.observe(float(t), measured, cal)
        if v.fired:
            det.reset()
    return [dataclasses.astuple(v) for v in det.history]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("cfg_args", [{}, {"rel_threshold": 0.1,
                                           "hold_ticks": 1},
                                      {"rel_threshold": 0.4,
                                       "hold_ticks": 2, "min_rate": 30.0}])
def test_detector_verdict_history_matches_reference(seed, cfg_args):
    got = _verdicts("port", seed, cfg_args)
    assert got == _verdicts("ref", seed, cfg_args)
    fired = [v[0] for v in got if v[5]]
    assert fired and all(15.0 <= t < 33.0 for t in fired) or \
        cfg_args.get("hold_ticks") == 1


def exact(ledger) -> dict:
    """A ledger in full: every tick record and the unrounded totals, each
    float as ``float.hex``."""
    def hexed(v):
        return v.hex() if isinstance(v, float) else v
    return {
        "records": [tuple(hexed(v) for v in dataclasses.astuple(r))
                    for r in ledger.records],
        "totals": {k: hexed(getattr(ledger, k)) for k in (
            "total_cost", "cost_ondemand", "cost_spot", "frames_demanded",
            "frames_analyzed", "frames_dropped", "migrations", "defrags",
            "recalibrations", "calib_max_rel_error")},
        "slo": ledger.slo_attainment().hex(),
    }


def points(hub) -> list:
    return [(p.t.hex() if isinstance(p.t, float) else p.t, p.name,
             p.value.hex(), p.attrs) for p in hub.points]


def _drift_side(side: str, n: int, online: bool):
    core, sim, obs = SIDES[side]
    sc = sim.SCENARIOS["drifting_scene"](n_streams=n, duration_h=24.0,
                                         seed=0)
    cat = sc.catalog()
    inner = sim.RepairPolicy(core.ResourceManager(cat),
                             migration_budget=n // 3, defrag_ratio=1.25)
    cfg = obs.DriftConfig() if online else \
        obs.DriftConfig(rel_threshold=math.inf)
    policy = obs.RecalibratingPolicy(inner, sc.service,
                                     detector=obs.DriftDetector(cfg),
                                     telemetry=obs.TelemetryHub(),
                                     tracer=obs.Tracer())
    ledger = sim.FleetSimulator(sc.demand, policy, cat, sc.config,
                                service=sc.service,
                                telemetry=policy.telemetry).run()
    return policy, ledger


@pytest.mark.parametrize("online", [False, True], ids=["stale", "online"])
@pytest.mark.parametrize("n", [24, 72])
def test_drifting_scene_matches_reference(same_clock, n, online):
    """The reference test's 24 streams and the benchmark's 72: the port's
    policy on the port's ``AdaptiveManager`` and ``FleetSimulator`` gives
    the reference's recalibrations, ledger, events, verdicts, spans and hub
    points."""
    port, pl = _drift_side("port", n, online)
    ref, rl = _drift_side("ref", n, online)
    assert isinstance(port.adaptive, PC.adaptive.AdaptiveManager)
    assert isinstance(port.calibration, PS.ServiceCalibration)
    assert port.recalibrations == ref.recalibrations
    assert bool(port.recalibrations) == online
    assert exact(pl) == exact(rl)
    assert [dataclasses.astuple(e) for e in port.adaptive.events] == \
        [dataclasses.astuple(e) for e in ref.adaptive.events]
    assert sum(e.recalibration for e in port.adaptive.events) == \
        len(port.recalibrations)
    assert [dataclasses.astuple(v) for v in port.detector.history] == \
        [dataclasses.astuple(v) for v in ref.detector.history]
    assert port.tracer.to_rows() == ref.tracer.to_rows()
    assert points(port.telemetry) == points(ref.telemetry)
    assert port.telemetry.names() == ref.telemetry.names()


# -- imports and the public API --------------------------------------------------

@pytest.mark.parametrize("first", ["repro_torch.obs", "repro_torch.sim",
                                   "repro_torch.obs.regional"])
def test_fresh_interpreter_imports_in_either_order(first):
    """``obs`` reaches ``sim.ledger`` (and so ``sim/__init__``) while
    ``sim.scenarios`` imports ``obs`` lazily: either package may be a fresh
    interpreter's first import, with jax and the reference blocked."""
    probe = (
        "import sys; sys.modules['jax'] = None; sys.modules['repro'] = None\n"
        f"import {first}\n"
        "import repro_torch.obs as obs, repro_torch.sim as sim\n"
        "sc = sim.SCENARIOS['regional_drift'](n_streams=6)\n"
        "assert isinstance(sc.service, obs.DriftingService)\n"
        "assert all(hasattr(obs, n) for n in obs.__all__)\n"
        "print(len(obs.__all__))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", probe], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) == len(RO.__all__)


def test_public_api_is_the_references():
    assert PO.__all__ == RO.__all__
    for name in PO.__all__:
        assert getattr(PO, name).__module__.startswith("repro_torch.obs")

"""Per-region live drift on the port (the twin of ``test_obs_regional.py``):
windowed probes, one detector streak per region, the partial calibration
merge and the repair scope that keeps healthy regions' placements out of the
blast radius. Then the port against the reference: windowed probes and
regional detectors on seeded inputs, ``camera_region_groups`` at every
camera, and both ``regional_drift`` arms at 96 streams by recalibration
times, recalibrated groups, ``float.hex`` of the ledger and adaptive events.
Last, ``chip_smoke.py``'s card loop in miniature with only the port loaded:
two reduced olmo-1b engines on the CPU, a load step in one region. Tolerance:
exact, as the reference's tests are, but where they use ``approx``.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

import repro.core as RC  # noqa: E402
import repro.obs as RO  # noqa: E402
import repro.sim as RS  # noqa: E402
import repro_torch.core as PC  # noqa: E402
import repro_torch.obs as PO  # noqa: E402
import repro_torch.sim as PS  # noqa: E402
from repro_torch.core.manager import ResourceManager  # noqa: E402
from repro_torch.core.repair import RepairConfig, repair_plan  # noqa: E402
from repro_torch.core.workload import PROGRAMS, Stream  # noqa: E402
from repro_torch.obs import (DriftConfig, DriftingService,  # noqa: E402
                             EngineWindowProbe, RateShift,
                             RegionalDriftDetector,
                             RegionalRecalibratingPolicy,
                             WindowedServiceProbe, camera_region_groups)
from repro_torch.sim import SCENARIOS, FleetSimulator, RepairPolicy  # noqa: E402
from repro_torch.sim.ledger import ServiceCalibration  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
SIDES = {"ref": (RC, RS, RO), "port": (PC, PS, PO)}


def _calib(rates, default=None):
    return ServiceCalibration(tokens_per_frame=8.0, rates_tokens_per_s=rates,
                              default_rate=default)


# -- windowed probe ------------------------------------------------------------

def test_windowed_probe_time_averages_over_the_poll_window():
    svc = DriftingService({"a": 64.0},
                          shifts=(RateShift(at_h=12.0, factor=0.25),))
    probe = WindowedServiceProbe(svc)
    assert probe.measure(11.0) == {"a": 64.0}
    assert probe.measure(11.5) == {"a": 64.0}
    assert probe.measure(12.5)["a"] == pytest.approx(40.0)
    assert probe.measure(13.5)["a"] == pytest.approx(16.0)


def test_windowed_probe_forwards_service_identity():
    svc = DriftingService({"a": 64.0}, tokens_per_frame=4.0)
    probe = WindowedServiceProbe(svc)
    assert probe.tokens_per_frame == 4.0
    assert probe.initial_calibration().rates_tokens_per_s == {"a": 64.0}


def test_mean_rates_integrates_piecewise_exactly():
    svc = DriftingService({"a": 100.0, "b": 10.0},
                          shifts=(RateShift(12.0, 0.5, frozenset({"a"})),
                                  RateShift(14.0, 0.2, frozenset({"a"}))))
    rates = svc.mean_rates(10.0, 15.0)
    assert rates["a"] == pytest.approx(62.0)
    assert rates["b"] == pytest.approx(10.0)
    assert svc.mean_rates(13.0, 13.0)["a"] == pytest.approx(50.0)


# -- engine bridge -------------------------------------------------------------

class _FakeEngine:
    def __init__(self, windowed, lifetime=None):
        self._windowed = windowed
        self._lifetime = lifetime if lifetime is not None else dict(windowed)

    def windowed_rates(self):
        return dict(self._windowed)

    def measured_rates(self):
        return dict(self._lifetime)


def test_engine_window_probe_merges_regions_and_tracks_groups():
    probe = EngineWindowProbe({
        "us-east-1": _FakeEngine({"cam-a": 60.0}),
        "ap-northeast-1": _FakeEngine({"cam-b": 12.0}),
    }, tokens_per_frame=8.0)
    measured = probe.measure(1.0)
    assert measured == {"cam-a": 60.0, "cam-b": 12.0}
    assert probe.group_of("cam-a") == "us-east-1"
    assert probe.group_of("cam-b") == "ap-northeast-1"
    assert probe.group_of("never-seen") == "unknown"
    calib = probe.initial_calibration()
    assert calib.rates_tokens_per_s == {"cam-a": 60.0, "cam-b": 12.0}
    assert calib.default_rate == pytest.approx(36.0)
    assert isinstance(calib, ServiceCalibration)


# -- per-group detection -------------------------------------------------------

def test_regional_detector_fires_only_the_drifted_group():
    det = RegionalDriftDetector(
        lambda sid: "tokyo" if sid.startswith("t") else "nyc",
        DriftConfig(rel_threshold=0.25, hold_ticks=2))
    calib = _calib({"t1": 64.0, "t2": 64.0, "n1": 64.0})
    healthy = {"n1": 64.0}
    drifted = {"t1": 12.8, "t2": 12.8}
    v1 = det.observe(0.0, {**healthy, **drifted}, calib)
    assert not v1.fired and v1.verdicts["tokyo"].streak == 1
    v2 = det.observe(1.0, {**healthy, **drifted}, calib)
    assert v2.fired_groups == ("tokyo",)
    assert v2.verdicts["nyc"].streak == 0
    assert v2.rel_error == pytest.approx(0.8 * 2 / 3)
    assert v2.max_rel_error == pytest.approx(0.8)
    assert v2.fired and v2.drifting and v2.streak == 2
    assert det.fired_groups() == ("tokyo",)
    det.reset("tokyo")
    v3 = det.observe(2.0, {**healthy, **drifted}, calib)
    assert v3.verdicts["tokyo"].streak == 1 and not v3.fired


def test_regional_detector_absent_group_keeps_its_streak():
    det = RegionalDriftDetector(lambda sid: sid[0],
                                DriftConfig(hold_ticks=3),
                                groups=("a", "b"))
    calib = _calib({"a1": 64.0, "b1": 64.0})
    det.observe(0.0, {"a1": 12.8}, calib)
    det.observe(1.0, {"a1": 12.8}, calib)
    v = det.observe(2.0, {"b1": 64.0}, calib)
    assert v.verdicts["a"].streak == 2 and v.verdicts["a"].n_streams == 0
    v = det.observe(3.0, {"a1": 12.8, "b1": 64.0}, calib)
    assert v.fired_groups == ("a",)


def test_regional_detector_dilution_vs_partition():
    from repro_torch.obs import DriftDetector
    cfg = DriftConfig(rel_threshold=0.3, hold_ticks=2)
    calib = _calib({f"{g}{i}": 64.0 for g in "abc" for i in range(4)})
    measured = {f"{g}{i}": (12.8 if g == "a" else 64.0)
                for g in "abc" for i in range(4)}
    fleet, regional = DriftDetector(cfg), RegionalDriftDetector(
        lambda sid: sid[0], cfg)
    for t in range(4):
        fv = fleet.observe(float(t), measured, calib)
        rv = regional.observe(float(t), measured, calib)
    assert not fv.fired and fv.rel_error == pytest.approx(0.8 / 3)
    assert rv.fired_groups == ("a",)


# -- scoped repair -------------------------------------------------------------

def _streams(n, camera, fps, prefix):
    return [Stream(f"{prefix}-{i}", PROGRAMS["ZF"], fps=fps, camera=camera)
            for i in range(n)]


def _moved(old, new):
    from repro_torch.core.repair import plan_assignment
    a, b = plan_assignment(old), plan_assignment(new)
    return {k for k, v in b.items() if k in a and a[k] != v}


def test_repair_scope_restricts_consolidation_and_defrag():
    from repro_torch.core import fig6_catalog
    cat = fig6_catalog()
    before = _streams(9, "nyc", 6.0, "ny") + _streams(9, "tokyo", 6.0, "tk")
    first = repair_plan(before, cat).plan
    after = _streams(9, "nyc", 6.0, "ny") + _streams(9, "tokyo", 0.5, "tk")
    scope = frozenset(s.stream_id for s in after if s.camera == "tokyo")
    cfg = RepairConfig(migration_budget=18, defrag_ratio=None)
    unscoped = repair_plan(after, cat, previous=first, config=cfg)
    scoped = repair_plan(after, cat, previous=first, config=cfg, scope=scope)
    assert scoped.plan.solution.cost <= unscoped.plan.solution.cost + 1e-9
    moved_scoped = _moved(first, scoped.plan)
    assert moved_scoped and moved_scoped <= scope
    assert _moved(first, unscoped.plan) >= moved_scoped


def test_repair_scope_skips_defrag_hatch():
    from repro_torch.core import fig6_catalog
    cat = fig6_catalog()
    before = _streams(12, "nyc", 6.0, "ny")
    first = repair_plan(before, cat).plan
    after = _streams(12, "nyc", 0.5, "ny")
    cfg = RepairConfig(migration_budget=None, defrag_ratio=1.05)
    unscoped = repair_plan(after, cat, previous=first, config=cfg)
    assert unscoped.defrag
    scoped = repair_plan(after, cat, previous=first, config=cfg,
                         scope=frozenset(s.stream_id for s in after))
    assert not scoped.defrag


# -- per-group recalibration end to end ----------------------------------------

def test_regional_policy_recalibrates_only_the_fired_group():
    sc = SCENARIOS["regional_drift"](n_streams=24, duration_h=24.0)
    cat = sc.catalog()
    policy = RegionalRecalibratingPolicy(
        RepairPolicy(ResourceManager(cat), migration_budget=6,
                     defrag_ratio=1.25),
        sc.service, group_of=sc.groups.__getitem__)
    ledger = FleetSimulator(sc.demand, policy, cat, sc.config,
                            service=sc.service,
                            telemetry=policy.telemetry).run()
    assert len(policy.recal_groups) == 1
    t_fired, groups = policy.recal_groups[0]
    assert groups == ("ap-northeast-1",)
    assert policy.regional.fired_groups() == ("ap-northeast-1",)
    for sid, g in sc.groups.items():
        rate = policy.calibration.rates_tokens_per_s[sid]
        truth = sc.service.rates_at(23.0)[sid]
        if g == "ap-northeast-1":
            assert rate == pytest.approx(truth)
        else:
            assert rate == pytest.approx(
                sc.service.initial_calibration().rates_tokens_per_s[sid])
    assert ledger.totals()["recalibrations"] == 1
    regions = {p.attr("region") for p in policy.telemetry.points
               if p.name == "drift.rel_error" and p.attr("region")}
    assert regions == set(sc.groups.values())


def test_camera_region_groups_maps_streams_by_camera():
    streams = [Stream("a", PROGRAMS["ZF"], fps=1.0, camera="nyc"),
               Stream("b", PROGRAMS["ZF"], fps=1.0, camera="tokyo"),
               Stream("c", PROGRAMS["ZF"], fps=1.0, camera=None)]
    groups = camera_region_groups(streams)
    assert groups["a"] == "us-east-1"
    assert groups["b"] == "ap-northeast-1"
    assert groups["c"] == "unknown"


def test_regional_drift_scenario_shape():
    sc = SCENARIOS["regional_drift"](n_streams=12)
    assert sc.groups is not None and len(sc.groups) == 12
    assert sorted(set(sc.groups.values())) == [
        "ap-northeast-1", "eu-west-1", "us-east-1"]
    drifted = {sid for sid, g in sc.groups.items()
               if g == "ap-northeast-1"}
    (shift,) = sc.service.shifts
    assert shift.streams == drifted
    post = sc.service.rates_at(shift.at_h)
    pre = sc.service.rates_at(0.0)
    for sid in sc.groups:
        if sid in drifted:
            assert post[sid] == pytest.approx(pre[sid] * shift.factor)
        else:
            assert post[sid] == pre[sid]


# -- the port against the reference --------------------------------------------

def test_windowed_probe_matches_reference_over_seeded_polls():
    rng = np.random.default_rng(11)
    base = {f"s{i}": float(rng.uniform(10, 90)) for i in range(6)}
    shifts = [(float(rng.uniform(0, 24)), float(rng.uniform(0.1, 0.9)),
               frozenset(f"s{i}" for i in range(6) if rng.random() < 0.5))
              for _ in range(3)]
    polls = sorted(float(x) for x in rng.uniform(0, 24, 30))
    polls[5] = polls[4]                       # a degenerate window
    out = {}
    for side in ("ref", "port"):
        obs = SIDES[side][2]
        svc = obs.DriftingService(base, shifts=tuple(
            obs.RateShift(at, f, s) for at, f, s in shifts))
        probe = obs.WindowedServiceProbe(svc)
        out[side] = [{k: v.hex() for k, v in probe.measure(t).items()}
                     for t in polls]
    assert out["port"] == out["ref"]


def _regional_history(side: str, seed: int) -> tuple:
    _, sim, obs = SIDES[side]
    rng = np.random.default_rng(seed)
    sids = [f"{g}{i}" for g in "abc" for i in range(4)]
    cal = sim.ServiceCalibration(rates_tokens_per_s={
        s: float(rng.uniform(20, 90)) for s in sids[:-2]}, default_rate=50.0)
    det = obs.RegionalDriftDetector(lambda s: s[0],
                                    obs.DriftConfig(hold_ticks=2),
                                    groups=("a", "z"))
    for t in range(30):
        drifting = "b" if 10 <= t < 20 else ""
        measured = {s: cal.rates_tokens_per_s.get(s, 50.0)
                    * float(rng.uniform(0.1, 0.4) if s[0] == drifting
                            else rng.uniform(0.85, 1.15))
                    for s in sids if rng.random() < 0.7}
        v = det.observe(float(t), measured, cal)
        for g in v.fired_groups:
            det.reset(g)
    return ([(v.t, v.fired_groups, v.rel_error.hex(),
              v.max_rel_error.hex(), v.n_streams,
              {g: dataclasses.astuple(x) for g, x in v.verdicts.items()})
             for v in det.history], det.firings, det.fired_groups())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_regional_detector_history_matches_reference(seed):
    got = _regional_history("port", seed)
    assert got == _regional_history("ref", seed)
    assert got[2] == ("b",)


def test_camera_region_groups_match_reference_at_every_camera():
    from repro_torch.core import geo
    assert sorted(geo.CAMERAS) == sorted(RC.geo.CAMERAS)
    streams = [Stream(f"s-{c}", PROGRAMS["ZF"], fps=1.0, camera=c)
               for c in sorted(geo.CAMERAS)]
    ref_streams = [RC.workload.Stream(s.stream_id, RC.workload.PROGRAMS["ZF"],
                                      fps=1.0, camera=s.camera)
                   for s in streams]
    for regions in (None, sorted(geo.DATACENTERS)[:3]):
        got = camera_region_groups(streams, regions=regions)
        assert got == RO.camera_region_groups(ref_streams, regions=regions)
        assert set(got) == {s.stream_id for s in streams}


def _regional_side(side: str, regional: bool):
    core, sim, obs = SIDES[side]
    sc = sim.SCENARIOS["regional_drift"](n_streams=96, duration_h=24.0,
                                         seed=0)
    cat = sc.catalog()
    inner = sim.RepairPolicy(core.ResourceManager(cat), migration_budget=12,
                             defrag_ratio=1.25)
    if regional:
        policy = obs.RegionalRecalibratingPolicy(
            inner, sc.service, group_of=sc.groups.__getitem__)
    else:
        policy = obs.RecalibratingPolicy(
            inner, sc.service, probe=obs.WindowedServiceProbe(sc.service))
    ledger = sim.FleetSimulator(sc.demand, policy, cat, sc.config,
                                service=sc.service,
                                telemetry=policy.telemetry).run()
    return policy, ledger


def _exact(ledger) -> tuple:
    def hexed(v):
        return v.hex() if isinstance(v, float) else v
    return ([tuple(hexed(v) for v in dataclasses.astuple(r))
             for r in ledger.records],
            {k: hexed(getattr(ledger, k)) for k in (
                "total_cost", "frames_demanded", "frames_analyzed",
                "frames_dropped", "migrations", "recalibrations",
                "calib_max_rel_error")},
            ledger.slo_attainment().hex())


@pytest.mark.parametrize("regional", [False, True],
                         ids=["fleet-wide", "per-group"])
def test_regional_drift_arms_match_reference(regional):
    port, pl = _regional_side("port", regional)
    ref, rl = _regional_side("ref", regional)
    assert isinstance(port.adaptive, PC.adaptive.AdaptiveManager)
    assert port.recalibrations == ref.recalibrations == [15.0]
    assert _exact(pl) == _exact(rl)
    assert [dataclasses.astuple(e) for e in port.adaptive.events] == \
        [dataclasses.astuple(e) for e in ref.adaptive.events]
    assert [e.action for e in port.adaptive.events if e.recalibration] == \
        ["forced-replan"]
    assert port.calibration.rates_tokens_per_s == \
        ref.calibration.rates_tokens_per_s
    assert [(p.t, p.name, p.attrs) for p in port.telemetry.points] == \
        [(p.t, p.name, p.attrs) for p in ref.telemetry.points]
    if regional:
        assert port.recal_groups == ref.recal_groups == \
            [(15.0, ("ap-northeast-1",))]
        assert port.regional.firings == ref.regional.firings
        assert port.regional.fired_groups() == ("ap-northeast-1",)
        assert pl.migrations == 8 < 12 == _regional_side("port", False)[1] \
            .migrations
        assert pl.total_cost <= _regional_side("port", False)[1].total_cost


# -- the card loop in miniature, port only --------------------------------------

_MINIATURE = """
import json, os, sys, tempfile
sys.modules["jax"] = None
sys.modules["repro"] = None
import torch
import chip_smoke
from repro_torch.checkpoint import init_params
from repro_torch.models.config import get_config
from repro_torch.serving import engine


class EngineClock:
    # a stand-in for the engines' time module: each monotonic() call is one
    # millisecond, so an engine's wall clock counts its steps and retires
    # and a window's rates depend on its load alone
    def __init__(self):
        self.calls = 0

    def monotonic(self):
        self.calls += 1
        return self.calls * 1e-3


engine.time = EngineClock()
cfg = get_config("olmo-1b", reduced=True)
params = init_params(cfg, torch.Generator().manual_seed(0), torch.float32,
                     device="cpu")
with tempfile.TemporaryDirectory() as tmp:
    loop = chip_smoke.obs_engine_loop(torch, cfg, params,
                                      os.path.join(tmp, "o.jsonl"),
                                      window_s=2.0)
    report = chip_smoke.check_obs_loop(loop, tmp)
leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "repro")
                and sys.modules[m] is not None)
assert not leaked, leaked
assert type(loop["policy"]).__module__ == "repro_torch.obs.regional"
print(json.dumps(report))
"""


def test_card_loop_in_miniature_fires_only_the_loaded_region():
    """Two reduced olmo-1b port engines on the CPU go through
    ``EngineWindowProbe`` (whose startup calibration must equal
    ``ServiceCalibration.from_engine`` over both engines, a check of the
    loop), ``RegionalRecalibratingPolicy`` over REPAIR and the exporters;
    ap-northeast-1 steps from 4 to 16 cameras at window 4. With the
    engines' clock counting their work, each window takes two rounds of
    slots before the step, so the startup profile (each stream's lifetime
    rate) must equal every healthy window's rate exactly, and each of the
    drifted region's streams falls to exactly a quarter: only that region
    fires, at window 6, and its re-profile and repair cover its 16
    streams."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", _MINIATURE], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    report = json.loads(res.stdout.strip().splitlines()[-1])
    assert report["fired_groups"] == ["ap-northeast-1"]
    assert report["fired_at_window"] == 6.0
    assert report["scoped_streams"] == 16
    assert [e[:2] for e in report["flagged_events"]] == [
        [6.0, "forced-replan"]]
    errors = [(w["us-east-1"]["rel_error"], w["ap-northeast-1"]["rel_error"])
              for w in report["windows"]]
    assert all(us < 1e-12 for us, _ in errors)
    assert all(ap < 1e-12 for _, ap in errors[:4] + errors[7:])
    assert errors[4][1] == pytest.approx(0.75, abs=1e-12)
    assert [w["ap-northeast-1"]["streams"] for w in report["windows"]] == \
        [4] * 4 + [16] * 6
    assert report["exports"]["trace_spans"] == 10
    assert report["prefills"] == 2 + 3 * 32 + 4 * 32 + 6 * 80

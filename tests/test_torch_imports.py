"""The port stands alone: ``repro_torch`` imports with jax blocked and loads
no module of the JAX package ``repro``; and its host layers (the resource
manager, the fleet simulator, the observability loop), run in a process
with jax and ``repro`` blocked, give what the reference gives in this one,
bit for bit (floats compared by ``float.hex``)."""
import dataclasses
import importlib
import json
import os
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

SRC = Path(__file__).resolve().parents[1] / "src"
PORT = SRC / "repro_torch"

_PROBE = """
import importlib, pkgutil, sys
sys.modules["jax"] = None            # any `import jax` now raises
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules if m == "repro" or m.startswith("repro."))
assert not leaked, leaked
assert "jax" not in {m.split(".")[0] for m, mod in sys.modules.items()
                     if mod is not None}
print(len(names))
"""


def test_port_imports_with_jax_blocked_and_loads_no_reference_module():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    res = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 15      # every module was imported


_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro(\.|\s|$)|"
    r"from\s+repro(\.|\s)|from\s+repro\s+import)", re.M)


def test_no_port_source_imports_jax_or_the_reference():
    files = sorted(PORT.rglob("*.py"))
    assert files
    bad = [str(f.relative_to(SRC)) for f in files
           if _FORBIDDEN.search(f.read_text())]
    assert not bad, bad


# -- the host layers with jax and the reference blocked ------------------------
# Each case takes a package name ("repro" or "repro_torch") and returns what
# it computes there; floats are compared as float.hex.

def _mods(pkg: str, *names: str) -> list:
    return [importlib.import_module(f"{pkg}.{n}") for n in names]


def _fig3(pkg: str) -> dict:
    """Fig. 3's nine cells: ST1-ST3 in its three scenarios."""
    (core,) = _mods(pkg, "core")
    mgr = core.ResourceManager(core.fig3_catalog())
    out = {}
    for sc in (1, 2, 3):
        for strat in ("ST1", "ST2", "ST3"):
            plan = mgr.plan_or_fail(core.make_streams(core.FIG3_SCENARIOS[sc]),
                                    strat)
            if plan is not None:
                core.validate(plan.problem, plan.solution)
            out[f"{strat} {sc}"] = (None if plan is None else
                                    (plan.signature(), plan.summary()))
    return out


def _rush_hour(pkg: str) -> dict:
    """The 48-hour rush-hour trace of ``AdaptiveManager`` over four ZF
    cameras (quiet nights at 0.2 fps, peaks at 6) in ST3 and REPAIR mode."""
    (core,) = _mods(pkg, "core")
    out = {}
    for strat in ("ST3", "REPAIR"):
        am = core.AdaptiveManager(core.ResourceManager(core.fig3_catalog()),
                                  strategy=strat)
        for t in range(48):
            fps = (6.0 if t % 24 in (8, 9, 17, 18) else
                   2.0 if t % 24 in (7, 10, 16, 19) else 0.2)
            am.step(t, [core.Stream(f"cam{i}", core.PROGRAMS["ZF"], fps=fps)
                        for i in range(4)])
        out[strat] = ([e.action for e in am.events], am.total_cost(),
                      am.total_migrations())
    return out


def _camera_fleet(core, geo, rng, n: int, replicas: int = 1,
                  tag: str = "") -> list:
    """``n`` seeded streams over Fig. 6's cameras, a quarter VGG16 and the
    rest ZF; with ``replicas`` > 1, groups of ``#k`` replicas."""
    cams = sorted(geo.CAMERAS)
    out = []
    for i in range(n // replicas):
        cam = cams[int(rng.integers(0, len(cams)))]
        prog = "VGG16" if rng.random() < 0.25 else "ZF"
        fps = round(float(rng.uniform(0.1, 1.5 if prog == "VGG16" else 6.0))
                    / replicas, 3)
        for k in range(replicas):
            sid = f"{prog.lower()}-{tag}{i}" + (f"#{k}" if replicas > 1 else "")
            out.append(core.Stream(sid, core.PROGRAMS[prog], fps, camera=cam))
    return out


def _repair_and_mixed(pkg: str) -> dict:
    """A REPAIR replan of a drifted 400-stream fleet against a fresh FFD,
    and ``plan_mixed`` of 400 replicated streams at seeded spot prices."""
    core, geo = _mods(pkg, "core", "core.geo")
    rng = np.random.default_rng(0)
    mgr = core.ResourceManager(core.fig6_catalog())
    fleet = _camera_fleet(core, geo, rng, 400)
    first = mgr.plan(fleet, "REPAIR")
    drifted = [dataclasses.replace(s, fps=round(min(s.fps * 1.5, 6.0), 3))
               if rng.random() < 0.3 else s
               for s in fleet if rng.random() > 0.1]
    drifted += _camera_fleet(core, geo, rng, 20, tag="new")
    repaired = mgr.plan(drifted, "REPAIR", previous=first)
    fresh = mgr.plan(drifted, "FFD")
    mixed = mgr.plan_mixed(
        _camera_fleet(core, geo, rng, 400, replicas=2),
        {r: round(float(rng.uniform(0.2, 0.9)), 4)
         for r in mgr.catalog.locations})
    for plan in (first, repaired, fresh, mixed.plan):
        core.validate(plan.problem, plan.solution)
    moved = core.count_plan_migrations(first, repaired)
    assert moved <= core.count_plan_migrations(first, fresh)
    assert not core.spot_affinity_violations(mixed.plan)
    return {"repaired": repaired.signature(), "migrations": moved,
            "ffd": fresh.signature(),
            "ffd_migrations": core.count_plan_migrations(first, fresh),
            "mixed": mixed.plan.signature(),
            "ondemand_cost": mixed.ondemand_cost}


def _golden_day(pkg: str) -> dict:
    """``tests/test_golden_ledgers.py``'s ``rush_hour`` day under REPAIR:
    108 streams, 24 h, seed 0, a 36-move budget, defrag ratio 2.0."""
    core, sim = _mods(pkg, "core", "sim")
    sc = sim.SCENARIOS["rush_hour"](n_streams=108, duration_h=24.0, seed=0)
    cat = sc.catalog()
    policy = sim.RepairPolicy(core.ResourceManager(cat), migration_budget=36,
                              defrag_ratio=2.0)
    return sim.FleetSimulator(sc.demand, policy, cat, sc.config).run().totals()


def _drifting_scene_online(pkg: str) -> dict:
    """``benchmarks/drift_recalibration.py``'s online arm: ``drifting_scene``
    at 72 streams, 24 h, seed 0, under ``RecalibratingPolicy`` over REPAIR."""
    core, sim, obs = _mods(pkg, "core", "sim", "obs")
    sc = sim.SCENARIOS["drifting_scene"](n_streams=72, duration_h=24.0, seed=0)
    cat = sc.catalog()
    policy = obs.RecalibratingPolicy(
        sim.RepairPolicy(core.ResourceManager(cat), migration_budget=72 // 3,
                         defrag_ratio=1.25),
        sc.service, detector=obs.DriftDetector(obs.DriftConfig()),
        telemetry=obs.TelemetryHub(), tracer=obs.Tracer())
    ledger = sim.FleetSimulator(sc.demand, policy, cat, sc.config,
                                service=sc.service,
                                telemetry=policy.telemetry).run()
    return {"recalibrations": policy.recalibrations,
            "points": len(policy.telemetry.points),
            "spans": len(policy.tracer.spans), "totals": ledger.totals()}


def _span_tree(span) -> tuple:
    return (span.name, span.t, span.wall_ms, span.attrs,
            [_span_tree(c) for c in span.children])


def _regional_drift_exports(pkg: str) -> dict:
    """``benchmarks/obs_export.py``'s per-group arm: ``regional_drift`` at
    96 streams, 24 h, seed 0, under ``RegionalRecalibratingPolicy``, its
    JSONL metrics and Chrome trace each read back equal to what was
    written (the wall times differ between processes, so the counts are
    compared across them)."""
    core, sim, obs = _mods(pkg, "core", "sim", "obs")
    sc = sim.SCENARIOS["regional_drift"](n_streams=96, duration_h=24.0, seed=0)
    cat = sc.catalog()
    with tempfile.TemporaryDirectory() as tmp:
        jsonl = os.path.join(tmp, "metrics.jsonl")
        trace = os.path.join(tmp, "trace.json")
        hub, exporter, _ = obs.hub_with_exporters(
            jsonl, histograms=("replan.wall_ms", "fleet.slo"))
        policy = obs.RegionalRecalibratingPolicy(
            sim.RepairPolicy(core.ResourceManager(cat),
                             migration_budget=96 // 8, defrag_ratio=1.25),
            sc.service, group_of=sc.groups.__getitem__, telemetry=hub,
            tracer=obs.Tracer())
        ledger = sim.FleetSimulator(sc.demand, policy, cat, sc.config,
                                    service=sc.service, telemetry=hub).run()
        exporter.close()
        assert obs.load_jsonl_metrics(jsonl) == hub.points
        events = obs.write_chrome_trace(trace, policy.tracer)
        assert [_span_tree(s) for s in obs.spans_from_chrome_trace(trace)] \
            == [_span_tree(s) for s in policy.tracer.spans]
    return {"recal_groups": policy.recal_groups,
            "fired_groups": policy.regional.fired_groups(),
            "points": len(hub.points), "spans": len(policy.tracer.spans),
            "trace_events": events, "totals": ledger.totals()}


CASES = {"fig3": _fig3, "rush_hour": _rush_hour,
         "repair_and_mixed": _repair_and_mixed, "golden_day": _golden_day,
         "drifting_scene_online": _drifting_scene_online,
         "regional_drift_exports": _regional_drift_exports}


def _hexed(x):
    """``x`` as JSON gives it back, its floats as ``float.hex``."""
    if isinstance(x, dict):
        return {str(k): _hexed(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_hexed(v) for v in x]
    return x.hex() if isinstance(x, float) else x


_CASE_PROBE = """
import importlib.util, json, sys
sys.modules["jax"] = None
sys.modules["repro"] = None
spec = importlib.util.spec_from_file_location("port_cases", sys.argv[1])
cases = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cases)
out = cases._hexed(cases.CASES[sys.argv[2]]("repro_torch"))
leaked = sorted(m for m, mod in sys.modules.items()
                if m.split(".")[0] in ("jax", "repro") and mod is not None)
assert not leaked, leaked
print(json.dumps(out))
"""


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_runs_with_jax_blocked(case):
    env = dict(os.environ, PYTHONPATH=str(SRC))
    res = subprocess.run([sys.executable, "-c", _CASE_PROBE, __file__, case],
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    got = json.loads(res.stdout.strip().splitlines()[-1])
    assert got == json.loads(json.dumps(_hexed(CASES[case]("repro"))))

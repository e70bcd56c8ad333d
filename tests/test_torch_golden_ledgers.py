"""The golden ledgers on the port: ``tests/test_golden_ledgers.py``'s days
(108 streams, ``mega_city`` at 1,000, 24 h, seed 0, REPAIR with a 36-move
budget and a 2.0 defrag ratio) through ``repro_torch.sim``, held to that
file's goldens to the cent and to the reference's run of the same day by
``float.hex``; the day that table lacks (``mega_city`` under REPAIR) against
the reference's run and the chip phase's derived totals; and the chip phase's
copies of the tables, and its host part run without jax.
"""
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

import repro.core as RC  # noqa: E402
import repro.sim as RS  # noqa: E402
import repro_torch.core as PC  # noqa: E402
import repro_torch.sim as PS  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF_TEST = _load("golden_ledgers_reference", ROOT / "tests" /
                 "test_golden_ledgers.py")
CHIP = _load("chip_smoke", ROOT / "chip_smoke.py")
DAYS = sorted(REF_TEST.GOLDEN) + [("mega_city", "repair")]


def hexed(totals: dict) -> dict:
    return {k: (hexed(v) if isinstance(v, dict) else
                v.hex() if isinstance(v, float) else v)
            for k, v in totals.items()}


def _run(core, sim, scenario, policy):
    sc = sim.SCENARIOS[scenario](
        n_streams=REF_TEST.N_OVERRIDE.get(scenario, REF_TEST.N_STREAMS),
        duration_h=REF_TEST.DURATION_H, seed=REF_TEST.SEED)
    cat = sc.catalog()
    if policy == "reactive":
        pol = sim.ReactivePolicy(core.ResourceManager(cat))
    else:
        pol = sim.RepairPolicy(core.ResourceManager(cat),
                               migration_budget=REF_TEST.N_STREAMS // 3,
                               defrag_ratio=2.0)
    return sim.FleetSimulator(sc.demand, pol, cat, sc.config).run()


@pytest.mark.parametrize("scenario,policy", DAYS)
def test_port_ledger_totals_match_golden_and_reference(scenario, policy):
    totals = _run(PC, PS, scenario, policy).totals()
    ref = _run(RC, RS, scenario, policy).totals()
    assert hexed(totals) == hexed(ref)
    golden = REF_TEST.GOLDEN.get((scenario, policy))
    if golden is None:
        n = REF_TEST.N_OVERRIDE[scenario]
        golden = CHIP.SIM_DERIVED[(scenario, policy, n)]
        assert {k: v for k, v in totals.items()
                if k != "instance_hours"} == golden
    mismatched = {k: (totals[k], v) for k, v in golden.items()
                  if totals[k] != v}
    assert not mismatched, mismatched
    assert totals["cost_ondemand"] + totals["cost_spot"] == \
        pytest.approx(totals["total_cost"], abs=5e-6)
    assert totals["outbids"] == totals["recalibrations"] == 0
    assert totals["calib_max_rel_error"] == 0.0
    assert totals["preboots"] == 0
    assert totals["forecast_max_rel_error"] == 0.0
    if (scenario, policy) in REF_TEST.GOLDEN_HOURS:
        assert totals["instance_hours"] == \
            REF_TEST.GOLDEN_HOURS[(scenario, policy)]


def test_chip_phase_tables_are_the_golden_files():
    """Phase 11 holds the card to copies of the golden file's tables, in
    its configuration."""
    assert CHIP.SIM_GOLDEN == REF_TEST.GOLDEN
    assert CHIP.SIM_GOLDEN_HOURS == REF_TEST.GOLDEN_HOURS
    assert (CHIP.SIM_STREAMS, CHIP.SIM_HOURS, CHIP.SIM_SEED) == \
        (REF_TEST.N_STREAMS, REF_TEST.DURATION_H, REF_TEST.SEED)
    assert CHIP.SIM_N_OVERRIDE == REF_TEST.N_OVERRIDE
    assert {(s, p) for s in CHIP.SIM_DAYS for p in CHIP.SIM_POLICIES} == \
        set(DAYS)
    assert set(CHIP.SIM_DERIVED) == {
        ("mega_city", "repair", 1000),
        ("mega_city", "reactive", CHIP.SIM_MEGA_CITY)}
    assert CHIP.SIM_MEGA_CITY == \
        RS.scenarios.mega_city.__defaults__[0] == 10_000


def test_chip_sim_phase_runs_without_jax():
    """Phase 11's host part (all but the day the card's engine calibrates)
    at 108 streams, in a process with jax blocked: every day equals its
    golden, and each timed day's decisions are counted."""
    probe = ("import sys, json; sys.modules['jax'] = None; "
             "import chip_smoke; "
             "print(json.dumps(chip_smoke.check_sim(full=False)))")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    report = json.loads(res.stdout.strip().splitlines()[-1])
    days = {f"{s} {p} {CHIP.SIM_STREAMS}" for s, p in REF_TEST.GOLDEN
            if s not in REF_TEST.N_OVERRIDE}
    assert set(report["compared"]) == set(report["host_s"]) == days
    assert set(report["compared"].values()) == {"golden, equal"}
    for (scenario, policy) in REF_TEST.GOLDEN:
        day = f"{scenario} {policy} {CHIP.SIM_STREAMS}"
        if day in days:
            got = report["totals"][day]
            assert {k: got[k] for k in REF_TEST.GOLDEN[(scenario, policy)]} \
                == REF_TEST.GOLDEN[(scenario, policy)]
    assert set(report["decide_ms"]) == {
        f"{s} {p} {CHIP.SIM_STREAMS}" for s, p in CHIP.SIM_TIMED}
    for d in report["decide_ms"].values():
        assert d["decisions"] == 24
        assert 0.0 < d["p50_ms"] <= d["max_ms"]

"""The golden ledgers on the port: ``tests/test_golden_ledgers.py``'s days
(108 streams, ``mega_city`` at 1,000, 24 h, seed 0, REPAIR with a 36-move
budget and a 2.0 defrag ratio) through ``repro_torch.sim``, held to that
file's goldens to the cent and to the reference's run of the same day by
``float.hex``; the day that table lacks (``mega_city`` under REPAIR) against
the reference's run and the totals derived from it below.
"""
import importlib.util
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
DAYS = sorted(REF_TEST.GOLDEN) + [("mega_city", "repair")]
# the day the golden table lacks, (scenario, policy, streams): its totals
# (all but instance_hours) from the reference on the columnar path.
# Regenerate:
#   PYTHONPATH=src python - <<'EOF'
#   from repro.core.manager import ResourceManager
#   from repro.sim import FleetSimulator, RepairPolicy, SCENARIOS
#   sc = SCENARIOS["mega_city"](n_streams=1000, duration_h=24.0, seed=0)
#   cat = sc.catalog()
#   pol = RepairPolicy(ResourceManager(cat), migration_budget=36,
#                      defrag_ratio=2.0)
#   tot = FleetSimulator(sc.demand, pol, cat, sc.config,
#                        columnar=True).run().totals()
#   tot.pop("instance_hours")
#   print(tot)
#   EOF
DERIVED = {
    ("mega_city", "repair", 1000): {
        "ticks": 24, "total_cost": 3059.7751, "cost_ondemand": 3059.7751,
        "cost_spot": 0.0, "frames_demanded": 62381354.4,
        "frames_analyzed": 61782912.9, "frames_dropped": 598441.5,
        "slo_attainment": 0.990407, "migrations": 2509, "preemptions": 0,
        "outbids": 0, "defrags": 1, "recalibrations": 0,
        "calib_max_rel_error": 0.0, "stage_items_peak": 0,
        "pooled_items_peak": 0, "preboots": 0, "forecast_max_rel_error": 0.0},
}


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
        golden = DERIVED[(scenario, policy, n)]
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

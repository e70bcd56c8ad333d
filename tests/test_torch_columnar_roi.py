"""``roi_day`` at 1,000 cameras for a whole day (the heaviest parity case,
kept in a file of its own so that it runs beside the others): the port's
columnar loop, its object loop and the reference's columnar loop give the
same ledger, stage items included. Tolerance: exact."""
import dataclasses

import pytest

pytest.importorskip("torch")

import repro.core as RC  # noqa: E402
import repro.sim as RS  # noqa: E402
import repro_torch.core as PC  # noqa: E402
import repro_torch.sim as PS  # noqa: E402


def _run(core, sim, columnar):
    sc = sim.SCENARIOS["roi_day"](n_streams=1000, duration_h=24.0)
    cat = sc.catalog()
    return sim.FleetSimulator(sc.demand,
                              sim.ReactivePolicy(core.ResourceManager(cat)),
                              cat, sc.config, columnar=columnar).run()


def test_roi_day_pipeline_parity_at_1000():
    led_c = _run(PC, PS, columnar=True)
    led_o = _run(PC, PS, columnar=False)
    assert led_c.stage_items_peak > 0
    assert led_c.signature() == led_o.signature()
    ref = _run(RC, RS, columnar=True)
    assert [dataclasses.astuple(r) for r in led_c.records] == \
        [dataclasses.astuple(r) for r in ref.records]
    assert led_c.totals() == ref.totals()

"""On the card: each cell's program within its limits and its control (the
reference in TF32 in the program's place) beyond one of them, at the cell's
own sizes, over a short window. Skips without a Hopper GPU."""
import json

import pytest

from conftest import ROOT
from harness import cell, check

CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_program_within_and_control_beyond_the_limits(workload, card,
                                                      monkeypatch):
    seen = {}
    serving, training = check.serving, check.training

    def serving_and_control(ctx, params, sample):
        seen["control"] = check.serving_control(ctx, params, sample, "tf32")
        return serving(ctx, params, sample)

    def training_and_control(ctx, prog, batches):
        ref = check.training_reference(ctx, batches)
        seen["control"] = check.training_readings(
            check.training_reference(ctx, batches, "tf32"), ref)
        return training(ctx, prog, batches)
    monkeypatch.setattr(check, "serving", serving_and_control)
    monkeypatch.setattr(check, "training", training_and_control)
    r = cell.run_cell(workload, 2**31 + 11, 8.0, False, root=ROOT)
    assert r["correct"], r["checks"]
    limits = {k: c["limit"] for k, c in r["checks"].items()}
    assert any(seen["control"][k] > limits[k] for k in limits), seen

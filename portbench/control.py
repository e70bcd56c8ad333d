"""The readings that the limits of ``correct`` are set from, many seeds in
one process, on the card:

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 \\
        --seconds 8 [--controls 3]

For each seed it runs the cell as ``run.py`` does (untraced, a window of
``--seconds`` at the cell's own load) and prints one JSON line: the
program's readings of every number compared, its end-to-end metrics, and,
for the first ``--controls`` seeds, the control's readings: the reference
computed in TF32 (the precision one step below the configurations' fp32
with TF32 off) in the program's place. For a training cell also a planted
fault's: the reference taking its loss over half of each batch's rows.
The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--controls", type=int, default=3)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(HERE), str(ROOT / "src")]
    import torch
    from harness import cell, check

    if not torch.cuda.is_available():
        print("the controls are read on a CUDA device", file=sys.stderr)
        return 2
    seeds = [int(s) for s in args.seeds.split(",")]
    extra = {}
    serving, training = check.serving, check.training

    def serving_and_control(ctx, params, sample):
        out = serving(ctx, params, sample)
        if extra["control"]:
            extra["tf32"] = check.serving_control(ctx, params, sample,
                                                  "tf32")
        return out

    def training_and_control(ctx, prog, batches):
        ref = check.training_reference(ctx, batches)
        out = {k: {"value": v, "limit": ctx.limits[k]} for k, v in
               check.training_readings(prog, ref).items()}
        if extra["control"]:
            extra["tf32"] = check.training_readings(
                check.training_reference(ctx, batches, "tf32"), ref)
            extra["half_batch"] = check.training_readings(
                check.training_reference(ctx, batches, half_batch=True), ref)
        return out

    check.serving, check.training = serving_and_control, training_and_control
    for i, seed in enumerate(seeds):
        extra.clear()
        extra["control"] = i < args.controls
        result = cell.run_cell(args.workload, seed, args.seconds, False,
                               root=ROOT)
        line = {"workload": args.workload, "seed": seed,
                "correct": result["correct"],
                "readings": {k: c["value"] for k, c in
                             result["checks"].items()},
                "metrics": {k: m["value"] for k, m in
                            result["metrics"].items()},
                "attempted": result["attempted"],
                "memory_peak_bytes": result["device"]["memory_peak_bytes"]}
        line.update({k: v for k, v in extra.items() if k != "control"})
        print(json.dumps(line), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

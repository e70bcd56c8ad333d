"""Run one cell of the port's benchmark once and print its result as the
last line of standard output (the numbers compared for ``correct``, each
with its limit, are the last lines of standard error):

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout. The cells are the ``workloads`` of
``BENCHMARK.json``. It runs on the machine it is started on and needs as
many CUDA devices as the cell asks for; otherwise, or if anything of JAX or
the JAX package is loaded once the window has closed, it exits non-zero and
prints no result.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BANNED = ("jax", "jaxlib", "flax", "repro")


def since_process_start() -> float:
    """Seconds since this process was started (by the kernel's record of
    its start, 10 ms ticks)."""
    with open("/proc/self/stat") as f:
        start = int(f.read().rsplit(")", 1)[1].split()[19])
    return time.clock_gettime(time.CLOCK_BOOTTIME) - \
        start / os.sysconf("SC_CLK_TCK")


def banned_modules() -> list:
    """Modules loaded whose top-level name is one of ``BANNED``, compared
    whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(BANNED))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(HERE), str(ROOT / "src")]
    import torch
    from harness import spec
    chips = spec.cell(spec.load(ROOT), args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); this machine "
              f"has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    from harness.cell import run_cell
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), root=ROOT,
                      since_start=since_process_start)
    found = banned_modules()
    if found:
        print(f"loaded after the window: {found}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

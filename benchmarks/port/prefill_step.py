#!/usr/bin/env python3
"""Time the serving prefill of one of the benchmark's configurations at full
width on one GPU, and with ``--shapes`` each of its dense products alone:

    python3 benchmarks/port/prefill_step.py --config olmo-1b [--src DIR]
        [--shapes]

The weights come from portbench's generator (seed 1) and the engine is the
benchmark cell's (16 slots of 640). Each of ``--steps`` prefills writes a
576-token frame into a slot (``steps.prefill_into_slot_step``, the engine's
admission), and the medians of:

- ``issue_ms``: host clock from the call to its return, the card idle at
  the call;
- ``synced_ms``: CUDA events around the call, so the prefill's device work
  and any wait for the host's launches;
- ``device_ms``: the union of the prefill's device intervals in
  ``torch.profiler``'s trace (kernels, copies, fills), over 3 prefills;

and the split-TF32 kernel's launches a prefill (``dense_gemm.launches``;
absent where the tree has no such kernel). ``--shapes`` adds, for each (K,
N) the prefill puts to the kernel's route, at 576 rows: the kernel's and
cuBLAS's fp32 ``x @ w`` times by CUDA events over 20 calls, and the bound,
the longer of three TF32 passes at 495 TFLOP/s and the bytes of x, w and
the output at 3.35 TB/s. ``--src DIR`` runs against the ``repro_torch``
under ``DIR`` (another commit's ``src/``, unpacked with ``git archive
<commit> src/repro_torch | tar -x -C build/parent``). Prints one JSON line
with the card's name and power limit. Needs a CUDA GPU; imports neither
jax nor the JAX package.
"""
from __future__ import annotations

import argparse
import importlib
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
SLOTS, CACHE_LEN, FRAME = 16, 640, 576
TF32_PEAK, HBM_BYTES_S = 495e12, 3.35e12


def _device_ms(torch, fn, n: int = 3) -> float:
    """Union of the device intervals of ``n`` calls, a call, in ms."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, reach = 0, None
    for s, e in spans:
        if reach is None or s > reach:
            busy += e - s
            reach = e
        elif e > reach:
            busy += e - reach
            reach = e
    return busy / 1e3 / n if spans else float("nan")


def _event_us(torch, fn, reps: int = 20) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps * 1e3


def _dense_shapes(dg, prefill) -> list[tuple[int, int]]:
    """(K, N) of each fp32 product of at least ``dg.MIN_ROWS`` rows that
    one prefill puts to the route (``dg.takes``), once each."""
    seen, takes = [], dg.takes

    def spy(x, w):
        if w.dim() == 2 and x.shape[-1] == w.shape[0] \
                and x.numel() // w.shape[0] >= dg.MIN_ROWS \
                and tuple(w.shape) not in seen:
            seen.append(tuple(w.shape))
        return takes(x, w)
    dg.takes = spy
    try:
        prefill()
    finally:
        dg.takes = takes
    return seen


def measure(config_name: str, n_steps: int, shapes: bool) -> dict:
    import torch
    sys.path[:0] = [os.path.join(ROOT, "portbench")]
    from harness import cell, spec, weights
    from repro_torch.models import model as M
    from repro_torch.models import steps
    from repro_torch.serving import ContinuousBatchingEngine
    try:
        from repro_torch.kernels import dense_gemm as dg
    except ImportError:
        dg = None

    bench = spec.load(spec.ROOT)
    config = spec.config(bench, spec.ROOT, config_name)
    ref = importlib.import_module("reference." + config["reference"])
    tf32 = bool(config["tf32"])
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    cfg = cell.arch_config(config)
    dev = torch.device("cuda")
    params = weights.make(ref.tree(config), 1, dev,
                          cell.DTYPES[config["dtype"]])
    opts = M.ModelOptions(use_kernels=config["use_kernels"], remat=False)
    eng = ContinuousBatchingEngine(cfg, params, max_slots=SLOTS,
                                   cache_len=CACHE_LEN, opts=opts)
    gen = torch.Generator(device=dev).manual_seed(1)
    frames = [torch.randint(0, cfg.vocab_size, (1, FRAME), device=dev,
                            generator=gen) for _ in range(4)]
    count = [0]

    def prefill():
        i = count[0] = count[0] + 1
        steps.prefill_into_slot_step(params, eng.cache,
                                     {"tokens": frames[i % 4]}, i % SLOTS,
                                     cfg, opts, CACHE_LEN)

    prefill()                                        # warm
    launches0 = dg.dense_gemm.launches if dg else None
    issue, synced = [], []
    for _ in range(n_steps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        e0.record()
        t0 = time.perf_counter()
        prefill()
        issue.append(time.perf_counter() - t0)
        e1.record()
        torch.cuda.synchronize()
        synced.append(e0.elapsed_time(e1) / 1e3)
    out = {"config": config_name,
           "issue_ms": statistics.median(issue) * 1e3,
           "synced_ms": statistics.median(synced) * 1e3}
    if dg is not None:
        out["dense_launches"] = (dg.dense_gemm.launches - launches0) / n_steps
    out["device_ms"] = _device_ms(torch, prefill)
    if shapes and dg is not None:
        rows = []
        for K, N in _dense_shapes(dg, prefill):
            x = torch.randn(FRAME, K, device=dev)
            w = torch.randn(K, N, device=dev) * 0.02
            flops = 2 * FRAME * K * N
            bound = max(3 * flops / TF32_PEAK,
                        4 * (FRAME * K + K * N + FRAME * N) / HBM_BYTES_S)
            kernel = _event_us(torch, lambda: dg.dense_gemm(x, w)) \
                if dg.takes(x, w) else None
            rows.append({"K": K, "N": N, "gflop": flops / 1e9,
                         "kernel_us": kernel,
                         "cublas_us": _event_us(torch, lambda: x @ w),
                         "bound_us": bound * 1e6})
        out["shapes"] = rows
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--shapes", action="store_true")
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.src))
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    out = measure(args.config, args.steps, args.shapes)
    out.update(src=args.src, card=card.strip())
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

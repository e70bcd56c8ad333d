#!/usr/bin/env python3
"""Time the serving decode step of one of the benchmark's configurations at
full width on one GPU, eagerly and, where the port has it, replayed from the
engine's CUDA graph (``steps.DecodeGraph``):

    python3 benchmarks/port/decode_step.py --config olmo-1b [--src DIR]

The weights come from portbench's generator (seed 1), the engine is the
benchmark cell's (16 slots of 640), and every slot is first prefilled with
a 576-token frame. Then ``--steps`` decode steps of each kind, the positions
advancing, and for each kind the medians of:

- ``issue_ms``: host clock from the call to its return, the card idle at
  the call;
- ``synced_ms``: CUDA events around the call, so the step's device work
  and any wait for the host's launches;
- ``device_ms``: the union of the step's device intervals in
  ``torch.profiler``'s trace (kernels, copies, fills), over 5 steps.

It also prints the engine's construction seconds (the capture, where there
is one) and the card's name and power limit. ``--src DIR`` runs against
the ``repro_torch`` under ``DIR`` (another commit's ``src/``, unpacked with
``git archive <commit> src/repro_torch | tar -x -C build/parent``), which
may have no graph; the eager step is then that commit's. Prints one JSON
line. Needs a CUDA GPU; imports neither jax nor the JAX package.
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


def _median_ms(xs) -> float:
    return statistics.median(xs) * 1e3


def _device_ms(torch, step, n: int = 5) -> float:
    """Union of the device intervals of ``n`` steps, a step, in ms."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            step()
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


def measure(config_name: str, n_steps: int) -> dict:
    import torch
    sys.path[:0] = [os.path.join(ROOT, "portbench")]
    from harness import cell, spec, weights
    from repro_torch.models import model as M
    from repro_torch.models import steps
    from repro_torch.serving import ContinuousBatchingEngine

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
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng = ContinuousBatchingEngine(cfg, params, max_slots=SLOTS,
                                   cache_len=CACHE_LEN, opts=opts)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    graph = getattr(eng, "_decode_graph", None)
    gen = torch.Generator(device=dev).manual_seed(1)
    for s in range(SLOTS):
        toks = torch.randint(0, cfg.vocab_size, (1, FRAME), device=dev,
                             generator=gen)
        steps.prefill_into_slot_step(params, eng.cache, {"tokens": toks}, s,
                                     cfg, opts, CACHE_LEN)
    tok = torch.randint(0, cfg.vocab_size, (SLOTS,), device=dev,
                        generator=gen)
    pos = torch.full((SLOTS,), FRAME, dtype=torch.long, device=dev)

    def step(kind):
        kw = {"graph": graph} if kind == "graph" else {}
        logits, _ = steps.decode_step(params, eng.cache,
                                      {"token": tok, "pos": pos}, cfg, opts,
                                      **kw)
        pos.add_(1).clamp_(max=CACHE_LEN - 1)
        return logits

    out = {"config": config_name, "build_s": build_s,
           "graph": graph is not None}
    for kind in ("eager", "graph") if graph is not None else ("eager",):
        step(kind)                                   # warm
        issue, synced = [], []
        for _ in range(n_steps):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            e0.record()
            t0 = time.perf_counter()
            step(kind)
            issue.append(time.perf_counter() - t0)
            e1.record()
            torch.cuda.synchronize()
            synced.append(e0.elapsed_time(e1) / 1e3)
        out[kind] = {"issue_ms": _median_ms(issue),
                     "synced_ms": _median_ms(synced),
                     "device_ms": _device_ms(torch, lambda: step(kind))}
        pos.fill_(FRAME)
    if graph is not None:
        out["replays"] = graph.replays
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--steps", type=int, default=20)
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
    out = measure(args.config, args.steps)
    out.update(src=args.src, card=card.strip())
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""One run of one cell: the cell's data by name, its traffic's runner, the
metrics' readers, and the result line's contents."""
from __future__ import annotations

import dataclasses
import gc
import importlib
import math
import sys
from pathlib import Path

import torch

from harness import serve, spec, train
from harness.trace import Profiler, Spans, read_events

RUNNERS = {"cameras": serve.measure, "train": train.measure}
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass
class Context:
    """What a runner needs: the cell's data, the program's configuration,
    the reference module, the device and the run's record."""
    config: dict
    traffic: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: str
    since_start: object
    run: spec.Run
    spans: Spans
    arch: object = None
    ref: object = None
    profiler: object = None

    @property
    def dtype(self):
        return DTYPES[self.config["dtype"]]

    def sync(self) -> None:
        if self.device == "cuda":
            torch.cuda.synchronize()

    def memory_peak(self) -> int:
        return torch.cuda.max_memory_allocated() if self.device == "cuda" \
            else 0

    def free(self) -> None:
        gc.collect()
        if self.device == "cuda":
            torch.cuda.empty_cache()


def arch_config(config: dict):
    """The program's ``ArchConfig`` from a configuration file's keys."""
    from repro_torch.models.config import ArchConfig
    names = {f.name for f in dataclasses.fields(ArchConfig)}
    kw = {k: v for k, v in config.items() if k in names}
    kw["block_pattern"] = tuple(tuple(b) for b in kw["block_pattern"])
    return ArchConfig(**kw)


def context(workload: str, seed: int, seconds: float, trace: bool, *,
            root: Path = spec.ROOT, device: str = "cuda",
            since_start=lambda: 0.0):
    """The context of a run, and the cell's metrics with their readers."""
    bench = spec.load(root)
    cell = spec.cell(bench, workload)
    config = spec.config(bench, root, cell["config"])
    traffic = spec.data(root, "traffic", cell["traffic"])
    run = spec.Run(cell=cell, config=config, traffic=traffic)
    ctx = Context(config=config, traffic=traffic,
                  limits=spec.data(root, "limits", workload), seed=seed,
                  seconds=seconds, trace=trace, device=device,
                  since_start=since_start, run=run,
                  spans=Spans(trace, sync=lambda: ctx.sync()))
    run.spans = ctx.spans
    ctx.arch = arch_config(config)
    ctx.ref = importlib.import_module("reference." + config["reference"])
    metrics = spec.metrics_of(bench, workload, per_layer=trace)
    readers = {m["name"]: spec.reader(root, m["name"]) for m in metrics}
    return ctx, metrics, readers


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             root: Path = spec.ROOT, device: str = "cuda",
             since_start=lambda: 0.0) -> dict:
    """Run ``workload`` once and return its result: correct, attempted,
    failed, metrics, device, with a trace the breakdown, and the numbers
    compared with their limits last."""
    ctx, metrics, readers = context(workload, seed, seconds, trace,
                                    root=root, device=device,
                                    since_start=since_start)
    tf32 = bool(ctx.config["tf32"])
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    if trace:
        wanted = {}
        for r in readers.values():
            wanted.update(getattr(r, "SPANS", {}))
        for name, s in wanted.items():
            ctx.spans.wrap(name, s["target"], s.get("sync", False))
        ctx.profiler = Profiler(cuda=device == "cuda")
    try:
        RUNNERS[ctx.traffic["kind"]](ctx)
    finally:
        ctx.spans.restore()
    run = ctx.run
    if trace:
        run.trace = read_events(ctx.profiler.events, ctx.spans,
                                ctx.spans.calls["window"][-1].mark)
        ctx.profiler = None
        print(f"trace: events by kind {run.trace['events']}; device seconds "
              f"launched inside each kind of span "
              f"{run.trace['device_s_by_span']}", file=sys.stderr)
    out = {}
    for m in metrics:
        value = readers[m["name"]].read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    device_info = {"platform": "gpu" if device == "cuda" else device,
                   "kind": torch.cuda.get_device_name(0)
                   if device == "cuda" else device,
                   "count": ctx.run.cell["chips"],
                   "memory_peak_bytes": run.memory_peak}
    result = {"correct": correct(run.checks), "attempted": run.attempted,
              "failed": run.failed, "metrics": out, "device": device_info}
    if trace:
        device_info["busy_s"] = run.trace["busy_s"]
        device_info["window_s"] = run.trace["window_s"]
        result["breakdown"] = {"device_ops": run.trace["device_ops"],
                               "idle_gaps": run.trace["idle_gaps"]}
    result["checks"] = run.checks
    return result


def correct(checks: dict) -> bool:
    """Every number compared is finite and within its limit."""
    return bool(checks) and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checks.values())

"""The benchmark's data, found by name under a checkout's root:
``BENCHMARK.json``; each configuration's file (its ``file``); each traffic
mix in ``portbench/traffic/<name>.json``; each cell's limits in
``portbench/limits/<cell>.json``; each metric's reader in
``portbench/metrics/<name>.py``. A cell, configuration, mix or metric is
added by adding files and entries: nothing here names one."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def load(root: Path = ROOT) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def cell(bench: dict, workload: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == workload:
            return w
    raise KeyError(f"no workload {workload!r}; the benchmark has "
                   f"{[w['name'] for w in bench['workloads']]}")


def config(bench: dict, root: Path, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return json.loads((Path(root) / c["file"]).read_text())
    raise KeyError(f"no configuration {name!r}")


def data(root: Path, folder: str, name: str) -> dict:
    return json.loads((Path(root) / "portbench" / folder /
                       f"{name}.json").read_text())


def metrics_of(bench: dict, workload: str, per_layer: bool) -> list:
    """The metrics a run of ``workload`` reports: with ``per_layer`` the
    per-layer ones, else the end-to-end ones. A metric without a
    ``workloads`` key is every cell's (a per-layer one: every cell that
    reports the end-to-end metric it moves)."""
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    if not per_layer:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (workload in m["workloads"] if "workloads" in m
                else m["moves"] in moved)]


def reader(root: Path, name: str):
    """The reader module of metric ``name``: ``read(run)`` returns the
    number or None (nothing to read); ``SPANS``, if it has one, names the
    program entries it needs spans around ({span: {"target":
    "module:attr", "sync": bool}})."""
    path = Path(root) / "portbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclasses.dataclass
class Run:
    """What one run of a cell measured, for the metrics' readers. Times are
    host seconds (``time.perf_counter``)."""
    cell: dict
    config: dict
    traffic: dict
    setup_s: float = 0.0
    window: tuple = (0.0, 0.0)          # (open, close)
    frames: list = dataclasses.field(default_factory=list)
    steps: list = dataclasses.field(default_factory=list)
    engine_report: dict = dataclasses.field(default_factory=dict)
    spans: object = None                # trace.Spans
    trace: dict | None = None           # trace.read_events's summary
    checks: dict = dataclasses.field(default_factory=dict)
    attempted: int = 0
    failed: int = 0
    memory_peak: int = 0

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

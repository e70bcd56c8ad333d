"""A run's last line, its refusals, and what it may import."""
import ast
import json
import os
import shutil
import subprocess
import sys

import pytest

from conftest import PORTBENCH, ROOT
from harness import cell

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("workload", ["olmo-1b.frames-576",
                                      "mamba2-2.7b.frames-576",
                                      "olmo-1b.train-2k"])
@pytest.mark.parametrize("trace", [False, True])
def test_result_line(workload, trace, tiny_root):
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    r = cell.run_cell(workload, 2**33 + 5, 1.0, trace, root=tiny_root,
                      device="cpu")
    assert list(r) == KEYS + (["breakdown"] if trace else []) + ["checks"]
    assert r["correct"] is True and r["attempted"] > 0 and r["failed"] == 0
    assert all(set(c) == {"value", "limit"} for c in r["checks"].values())
    if trace:
        assert {"busy_s", "window_s"} <= set(r["device"])
        assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
        listed = {m["name"] for m in bench["per_layer"]
                  if workload in m["workloads"]}
    else:
        listed = {m["name"] for m in bench["end_to_end"]
                  if workload in m.get("workloads", [workload])}
    # on the CPU the device's readers find nothing to read
    device_only = {m["name"] for m in bench["per_layer"]
                   if m["source"] == "device_trace"}
    assert listed - device_only <= set(r["metrics"]) <= listed
    units = {m["name"]: m["unit"] for m in bench["end_to_end"] +
             bench["per_layer"]}
    assert all(v["unit"] == units[k] for k, v in r["metrics"].items())


def _run(cwd, *extra):
    env = dict(os.environ, PYTHONPATH="")
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "olmo-1b.frames-576", "--seed", "1", "--seconds", "1",
         "--trace", "0", *extra], cwd=cwd, capture_output=True, text=True,
        env=env, timeout=300)


def test_no_result_without_the_devices_the_cell_asks_for():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is here")
    p = _run(ROOT)
    assert p.returncode != 0 and p.stdout == ""


def test_no_result_from_the_benchmark_files_alone(tmp_path):
    shutil.copytree(PORTBENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    p = _run(tmp_path)
    assert p.returncode != 0 and p.stdout == ""


def test_banned_modules_compare_whole_top_level_names(monkeypatch):
    sys.path.insert(0, str(PORTBENCH))
    import run
    for name in ("repro_torch", "repro_torch.models", "reproduce",
                 "jaxtyping"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert run.banned_modules() == []
    monkeypatch.setitem(sys.modules, "repro.models", sys)
    monkeypatch.setitem(sys.modules, "jax", sys)
    assert run.banned_modules() == ["jax", "repro"]


def test_a_run_loads_nothing_of_jax_or_the_jax_package(tiny_root):
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "from harness import cell\n"
        "r = cell.run_cell('mamba2-2.7b.frames-576', 9, 1.0, True, "
        "root=%r, device='cpu')\n"
        "import run\n"
        "print(r['correct'], run.banned_modules())\n"
    ) % (str(PORTBENCH), str(ROOT / "src"), str(tiny_root))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300,
                       env=dict(os.environ, PYTHONPATH=""))
    assert p.stdout.split("\n")[-2] == "True []", p.stderr[-2000:]


def test_the_references_import_nothing_of_the_program():
    for path in (PORTBENCH / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for n in names:
                assert n.split(".")[0] in {
                    "__future__", "contextlib", "dataclasses", "math",
                    "torch", "reference"}, (path.name, n)


def test_a_span_keeps_the_entrys_counters():
    """The kernels count their launches on their own function object; a
    span around the entry leaves the count right when it is put back."""
    from harness.trace import Spans
    from repro_torch.kernels import flash_attention as fa
    spans, before = Spans(False), fa.flash_attention.launches
    spans.wrap("flash", "repro_torch.kernels.flash_attention:flash_attention")
    fa.flash_attention.launches += 3          # as a launch inside it does
    spans.restore()
    assert fa.flash_attention.launches == before + 3
    assert fa.flash_attention.__name__ == "flash_attention"

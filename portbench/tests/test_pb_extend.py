"""A later change adds a configuration, a traffic mix, a per-layer metric
and a cell as new files and entries only; the harness finds each by
name."""
import hashlib
import json

from conftest import tiny_copy
from harness import cell


def _digests(root):
    return {p: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in (root / "portbench").rglob("*") if p.is_file()}


def test_new_files_and_entries_make_a_new_cell(tmp_path):
    root = tiny_copy(tmp_path)
    before = _digests(root)
    pb = root / "portbench"
    config = json.loads((pb / "configs" / "olmo-1b.json").read_text())
    config.update(name="olmo-gqa", num_kv_heads=2)
    (pb / "configs" / "olmo-gqa.json").write_text(json.dumps(config))
    traffic = json.loads((pb / "traffic" / "frames-576.json").read_text())
    traffic.update(cameras=3, fps=4.0, loop="open", frame_tokens=[[24, 1.0]])
    (pb / "traffic" / "frames-24-open.json").write_text(json.dumps(traffic))
    (pb / "limits" / "olmo-gqa.frames-24-open.json").write_text(
        (pb / "limits" / "olmo-1b.frames-576.json").read_text())
    (pb / "metrics" / "answered.serve.py").write_text(
        '"""Frames answered in the window."""\n\n\n'
        'def read(run):\n    return float(len(run.frames))\n')
    bench = json.loads((root / "BENCHMARK.json").read_text())
    name = "olmo-gqa.frames-24-open"
    bench["configs"].append({"name": "olmo-gqa", "source": "test",
                             "file": "portbench/configs/olmo-gqa.json",
                             "reduced": [], "why": "grouped-query heads"})
    bench["workloads"].append({"name": name, "config": "olmo-gqa",
                               "traffic": "frames-24-open", "chips": 1,
                               "why": "an open loop"})
    for m in bench["end_to_end"]:
        if "workloads" in m and "olmo-1b.frames-576" in m["workloads"]:
            m["workloads"].append(name)
    bench["per_layer"].append({"name": "answered.serve", "unit": "frames",
                               "better": "higher", "source": "host_clock",
                               "layer": "harness", "moves": "frames_per_s",
                               "workloads": [name]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    plain = cell.run_cell(name, 4, 1.5, False, root=root, device="cpu")
    traced = cell.run_cell(name, 4, 1.5, True, root=root, device="cpu")
    assert plain["correct"] and traced["correct"]
    assert set(plain["metrics"]) == {"frames_per_s", "frame_latency_p90_s",
                                     "setup_s"}
    assert traced["metrics"]["answered.serve"]["value"] == \
        traced["attempted"] > 0
    # the old cells are untouched and still run
    assert cell.run_cell("olmo-1b.frames-576", 4, 1.0, False, root=root,
                         device="cpu")["correct"]
    after = _digests(root)
    assert all(after[p] == d for p, d in before.items())

"""The reader of the prefill's dense products: ``dense_kernel_share.serve``,
the engine's share of the FLOPs of its fp32 dense products of many rows
that ran on the split-TF32 kernel, in %, None where the engine reports no
such share (a program without the kernel)."""
import pytest

from conftest import ROOT
from harness import cell, spec

NAME = "dense_kernel_share.serve"


def read(report):
    run = spec.Run(cell={}, config={}, traffic={})
    run.engine_report = report
    return spec.reader(ROOT, NAME).read(run)


@pytest.mark.parametrize("share", [0.0, 0.5, 0.9975, 1.0])
def test_reads_the_share_in_percent(share):
    assert read({"slot_occupancy": 1.0,
                 "dense_kernel_share": share}) == 100.0 * share


def test_none_without_the_key():
    assert read({"slot_occupancy": 1.0, "decode_graph_share": 1.0}) is None
    assert read({}) is None


def test_declared_for_the_serving_cells():
    bench = spec.load(ROOT)
    metric = next(m for m in bench["per_layer"] if m["name"] == NAME)
    assert metric["source"] == "program_counter"
    assert metric["moves"] == "frames_per_s"
    assert metric["workloads"] == [w["name"] for w in bench["workloads"]
                                   if w["traffic"] == "frames-576"]


def test_a_cpu_run_reads_no_kernel(tiny_root):
    """On the CPU every product is ``x @ w``: the traced run reads 0%."""
    r = cell.run_cell("olmo-1b.frames-576", 2**35 + 5, 1.0, True,
                      root=tiny_root, device="cpu")
    assert r["correct"]
    assert r["metrics"][NAME] == {"value": 0.0, "unit": "%"}

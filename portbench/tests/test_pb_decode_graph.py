"""The readers of the batched decode step's layer: ``decode_graph_share.
serve``, the engine's share of decode steps replayed from its CUDA graph,
in %, None where the engine reports no such share (a program without the
graph); and ``decode_roofline.serve``, the step's bound over the device
time launched inside it, pinned at the three serving cells' shapes."""
import json
import types

import pytest

from conftest import PORTBENCH, ROOT
from harness import cell, spec
from harness.trace import Call

NAME = "decode_graph_share.serve"
ROOFLINE = "decode_roofline.serve"


def read(report):
    run = spec.Run(cell={}, config={}, traffic={})
    run.engine_report = report
    return spec.reader(ROOT, NAME).read(run)


@pytest.mark.parametrize("share", [0.0, 0.25, 1.0])
def test_reads_the_share_in_percent(share):
    assert read({"slot_occupancy": 1.0,
                 "decode_graph_share": share}) == 100.0 * share


def test_none_without_the_key():
    assert read({"slot_occupancy": 1.0}) is None
    assert read({}) is None


def test_a_cpu_run_reads_no_replay(tiny_root):
    """On the CPU the engine decodes eagerly: the traced run reads 0%, and
    the decode roofline, with no device time to read, is left out."""
    r = cell.run_cell("olmo-1b.frames-576", 2**35 + 3, 1.0, True,
                      root=tiny_root, device="cpu")
    assert r["correct"]
    assert r["metrics"][NAME] == {"value": 0.0, "unit": "%"}
    assert ROOFLINE not in r["metrics"]


def _config(name):
    return json.loads((PORTBENCH / "configs" / f"{name}.json").read_text())


@pytest.mark.parametrize("name, flops, nbytes", [
    # olmo-1b: 4.71 GB of weights and the head, 2.42 GB of keys and values
    ("olmo-1b", 38_864_420_864, 7_122_976_768),
    # mamba2-2.7b: 10.8 GB of weights, the fp32 state read and written
    ("mamba2-2.7b", 89_095_536_640, 16_170_106_880),
    # granite-4.0-h-small: 16.35 of 18 held experts touched a layer
    ("granite-4.0-h-small", 194_053_668_864, 49_954_063_255),
])
def test_decode_step_counts_pinned_at_16_rows_of_576(name, flops, nbytes):
    step = spec.reader(ROOT, ROOFLINE).step
    got_flops, got_bytes = step(_config(name), 16, 576)
    assert got_flops == flops
    assert round(got_bytes) == nbytes


def test_decode_roofline_reads_the_decode_calls_of_the_window():
    run = spec.Run(cell={}, config=_config("olmo-1b"),
                   traffic={"max_slots": 16, "frame_tokens": [[576, 1.0]]})
    run.window = (10.0, 20.0)
    run.engine_report = {"slot_occupancy": 1.0}
    calls = [Call("decode", {}) for _ in range(3)]
    for c, t0, dev in zip(calls, (11.0, 12.0, 25.0), (10e-3, 12e-3, 1.0)):
        c.t0, c.device_s = t0, dev
    run.spans = types.SimpleNamespace(between=lambda name, t0, t1: [
        c for c in calls if name == "decode" and t0 <= c.t0 <= t1])
    bound = 7_122_976_768 / 3.35e12          # bytes bind
    got = spec.reader(ROOT, ROOFLINE).read(run)
    assert got == pytest.approx(100.0 * 2 * bound / 22e-3)
    # half the slots occupied: half the keys and values
    run.engine_report = {"slot_occupancy": 0.5}
    half = (7_122_976_768 - 2_415_919_104 / 2) / 3.35e12
    assert spec.reader(ROOT, ROOFLINE).read(run) == pytest.approx(
        100.0 * 2 * half / 22e-3)
    # untraced (no device time), or no decode step: None, not 0
    for c in calls:
        c.device_s = None
    assert spec.reader(ROOT, ROOFLINE).read(run) is None
    run.engine_report = {"slot_occupancy": 0.0}
    assert spec.reader(ROOT, ROOFLINE).read(run) is None
    run.engine_report = {}
    assert spec.reader(ROOT, ROOFLINE).read(run) is None

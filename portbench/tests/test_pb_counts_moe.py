"""The dropless MoE layer's yardstick (``metrics/counts_moe.py``) pinned at
granite-4.0-h-small's prefill (T = 576) and decode (T = 16) shapes, and the
three readers that use it or the program's MoE spans, on a synthetic run:
each reads None, never 0, where it finds nothing."""
import json
import sys
import types

import pytest

from conftest import PORTBENCH, ROOT
from harness import spec
from harness.trace import Call
from metrics import counts, counts_moe

READERS = ["moe_roofline.serve", "mfu_ep.serve", "moe_issue_ms.serve"]


@pytest.fixture(scope="module")
def granite():
    return json.loads((PORTBENCH / "configs" /
                       "granite-4.0-h-small.json").read_text())


def read(name, run):
    return spec.reader(ROOT, name).read(run)


def test_moe_call_pinned_at_prefill_and_decode(granite):
    # prefill: router 0.34 + routed 27.18 (1,440 entries expected on 18 of
    # 72 experts) + shared 21.74 GFLOP; all 18 experts' weights touched
    assert counts_moe.moe_flops(granite, 576) == 49_262_100_480
    assert counts_moe.moe_bytes(granite, 576) == pytest.approx(775_028_736)
    assert round(1e3 * counts.bound_s(counts_moe.moe_flops(granite, 576),
                                      counts_moe.moe_bytes(granite, 576)),
                 6) == 0.735255                       # operations bind
    # decode: 16.35 of 18 held experts touched, so bytes bind
    assert counts_moe.moe_flops(granite, 16) == 1_368_391_680
    assert round(counts_moe.moe_bytes(granite, 16)) == 694_574_308
    info = {"args": ["dict", (16, 1, 4096), "ArchConfig"], "kwargs": {},
            "dtype": "float32"}
    assert round(1e3 * counts_moe.moe_call(info, granite), 6) == 0.207336


def test_model_flops_of_a_frame_pinned(granite):
    assert counts_moe.model_flops_frame(granite, 576, 8) == \
        pytest.approx(6_587_281_571_840)
    # the prefill is all but 1.2% of it
    assert counts_moe._layer_flops(granite, 576, 576 * 577 // 2) == \
        pytest.approx(6_501_559_173_120)


def _run(granite, window=(10.0, 20.0)):
    run = spec.Run(cell={}, config=granite, traffic={})
    run.window = window
    return run


def test_roofline_and_mfu_read_their_calls_and_frames(granite):
    run = _run(granite)
    a, b = Call("moe", {"args": ["dict", (1, 576, 4096), "ArchConfig"],
                        "kwargs": {}, "dtype": "float32"}), \
        Call("moe", {"args": ["dict", (16, 1, 4096), "ArchConfig"],
                     "kwargs": {}, "dtype": "float32"})
    a.t0, a.device_s = 11.0, 1.5e-3
    b.t0, b.device_s = 12.0, 0.5e-3
    run.spans = types.SimpleNamespace(between=lambda name, t0, t1: [
        c for c in (a, b) if t0 <= c.t0 <= t1])
    want = 100.0 * (0.735255 + 0.207336) / 2.0
    assert read("moe_roofline.serve", run) == pytest.approx(want, rel=1e-5)
    run.frames = [(10.5, 15.0, 576, 8), (11.0, 19.0, 576, 8)]
    assert read("mfu_ep.serve", run) == pytest.approx(
        100.0 * 2 * 6_587_281_571_840 / 10.0 / 67e12)
    # nothing timed, nothing answered: None, not 0
    a.device_s = b.device_s = None
    run.frames = []
    assert read("moe_roofline.serve", run) is None
    assert read("mfu_ep.serve", run) is None


@pytest.fixture
def tracer():
    from repro_torch.obs.trace import program_tracer
    tr = program_tracer()
    tr.spans.clear()
    yield tr
    tr.spans.clear()


def test_moe_issue_reads_the_moe_span_of_each_decode_step(granite, tracer):
    from repro_torch.obs.trace import Span
    run = _run(granite)

    def call(t0, ms):
        c = Call("moe", {})
        c.t0, c.t1 = t0, t0 + ms / 1e3
        return c
    # two decode steps of 100 ms in the window, one after it; the calls of
    # a step are summed (6 = 2 + 4 ms, then 4 ms), a call outside every
    # step (a prefill's) is left out
    calls = [call(12.002, 2.0), call(12.050, 4.0), call(13.010, 4.0),
             call(14.0, 30.0), call(25.010, 50.0)]
    run.spans = types.SimpleNamespace(between=lambda name, t0, t1: [
        c for c in calls if name == "moe" and t0 <= c.t0 <= t1])
    tracer.spans.extend([
        Span("engine.step", 0.0, wall_ms=120.0, start_s=12.0, children=[
            Span("engine.decode", 0.0, wall_ms=110.0, start_s=12.0,
                 children=[Span("steps.decode", 0.0, wall_ms=100.0,
                                start_s=12.001)])]),
        Span("steps.decode", 0.0, wall_ms=100.0, start_s=13.0),
        Span("steps.decode", 0.0, wall_ms=100.0, start_s=25.0),
    ])
    assert read("moe_issue_ms.serve", run) == pytest.approx((6.0 + 4.0) / 2)
    # decode steps with no MoE call inside (a model without the layer): None
    calls.clear()
    assert read("moe_issue_ms.serve", run) is None


def test_readers_give_none_without_a_program_tracer(granite, monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch.obs.trace",
                        types.ModuleType("repro_torch.obs.trace"))
    run = _run(granite, (0.0, 1e12))
    run.spans = types.SimpleNamespace(between=lambda *a: [])
    assert [read(n, run) for n in READERS] == [None] * 3


def test_traced_tiny_granite_run_reads_the_program_metrics(tmp_path):
    """A traced run of the cell at a reduced size on the CPU: the host-clock
    and program-span metrics are finite and positive (the device readers
    find no device time here)."""
    from conftest import patch_json, tiny_copy
    from harness import cell
    from repro_torch.obs.trace import program_tracer
    program_tracer().spans.clear()
    root = tiny_copy(tmp_path)
    patch_json(root / "portbench" / "configs" / "granite-4.0-h-small.json",
               **TINY_GRANITE)
    r = cell.run_cell("granite-4.0-h-small.frames-576", 2**35 + 3, 1.0, True,
                      root=root, device="cpu")
    assert r["correct"]
    for name in ("mfu_ep.serve", "moe_issue_ms.serve"):
        assert r["metrics"][name]["value"] > 0.0, name
    assert "moe_roofline.serve" not in r["metrics"]
    program_tracer().spans.clear()


# every width cut, the block kinds kept: one attention and three SSD
# layers, each with a dropless MoE of which 4 of 8 experts are held
TINY_GRANITE = dict(
    num_layers=4, d_model=64, vocab_size=256,
    block_pattern=[["ssd", "moe"], ["attn", "moe"], ["ssd", "moe"],
                   ["ssd", "moe"]],
    num_heads=4, num_kv_heads=2, head_dim=16, attention_multiplier=1 / 16,
    num_experts=8, experts_per_token=3, moe_d_ff=32, experts_held=4,
    moe_shared_d_ff=48, ssm_state=16, ssm_head_dim=16, ssm_chunk=16)

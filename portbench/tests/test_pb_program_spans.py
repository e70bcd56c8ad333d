"""The readers of the program's own spans: finite in a traced run of each
serving cell, their arithmetic on spans placed by hand, and None where the
window holds no program span or the program keeps no program tracer."""
import math
import sys
import types

import pytest

from conftest import ROOT
from harness import cell, spec

SERVING = ["olmo-1b.frames-576", "mamba2-2.7b.frames-576"]
READERS = ["queue_wait_ms.serve", "decode_issue_ms.serve",
           "engine_self_ms.serve"]


def read(name, run):
    return spec.reader(ROOT, name).read(run)


@pytest.fixture
def tracer():
    from repro_torch.obs.trace import program_tracer
    tr = program_tracer()
    tr.spans.clear()
    yield tr
    tr.spans.clear()


@pytest.mark.parametrize("workload", SERVING)
def test_traced_serving_run_reads_every_program_metric(workload, tiny_root,
                                                       tracer):
    r = cell.run_cell(workload, 2**34 + 11, 1.0, True, root=tiny_root,
                      device="cpu")
    assert r["correct"]
    for name in READERS:
        value = r["metrics"][name]["value"]
        assert math.isfinite(value) and value > 0.0, name
    # an untraced run records no span
    tracer.spans.clear()
    cell.run_cell(workload, 2**34 + 11, 1.0, False, root=tiny_root,
                  device="cpu")
    assert not tracer.spans


def test_readers_take_only_the_window(tracer):
    from repro_torch.obs.trace import Span
    run = spec.Run(cell={}, config={}, traffic={})
    run.window = (10.0, 20.0)
    for i in range(10):                    # queue waits of 1..10 ms
        tracer.record("request.queue", 11.0 + i, 11.0 + i + (i + 1) / 1e3,
                      request_id=f"r{i}")
    tracer.record("request.queue", 9.0, 9.5)      # admitted before the window
    tracer.record("request.queue", 19.9, 20.5)    # admitted after it
    decode = Span("steps.decode", 0.0, wall_ms=4.0, start_s=12.001)
    tracer.spans.append(Span("engine.step", 0.0, wall_ms=6.0, start_s=12.0,
                             children=[Span("engine.decode", 0.0, wall_ms=5.0,
                                            start_s=12.0005,
                                            children=[decode])]))
    tracer.spans.append(Span("engine.step", 0.0, wall_ms=3.0, start_s=21.0))
    assert read("queue_wait_ms.serve", run) == pytest.approx(9.0)
    assert read("decode_issue_ms.serve", run) == pytest.approx(4.0)
    assert read("engine_self_ms.serve", run) == pytest.approx(1.0)
    run.window = (30.0, 40.0)
    assert [read(n, run) for n in READERS] == [None] * 3


def test_readers_give_none_without_a_program_tracer(monkeypatch):
    """The parent of the change that added the program tracer: the import
    fails, and each reader reads nothing."""
    monkeypatch.setitem(sys.modules, "repro_torch.obs.trace",
                        types.ModuleType("repro_torch.obs.trace"))
    run = spec.Run(cell={}, config={}, traffic={})
    run.window = (0.0, 1e12)
    assert [read(n, run) for n in READERS] == [None] * 3

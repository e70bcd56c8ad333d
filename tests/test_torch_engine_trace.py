"""The serving path's spans on the program tracer (``obs.trace``): nothing
recorded and nothing changed without a profiler; under one, each engine
step's tree, each request's queue wait, one ``repro_torch/<name>`` profiler
range a span; the Chrome export at real start times; and the self-time
arithmetic of the benchmark's ``engine_self_ms`` reader. Reduced olmo-1b and
mamba2-2.7b on the CPU, no JAX."""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import checkpoint  # noqa: E402
from repro_torch.models.config import get_config  # noqa: E402
from repro_torch.obs import (Tracer, chrome_trace,  # noqa: E402
                             spans_from_chrome_trace)
from repro_torch.obs import trace as trace_mod  # noqa: E402
from repro_torch.obs.trace import (RANGE_PREFIX, Span,  # noqa: E402
                                   program_tracer)
from repro_torch.serving import engine as engine_mod  # noqa: E402
from repro_torch.serving import ContinuousBatchingEngine, Request  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["olmo-1b", "mamba2-2.7b"]
CACHE_LEN, PROMPT_LEN, SLOTS, REQUESTS = 48, 16, 2, 5
ENGINE_SPANS = {"engine.step", "engine.admit", "engine.prefill",
                "engine.decode", "engine.readback", "engine.retire"}


class EngineClock:
    # a stand-in for the engine's time module: each monotonic() call is one
    # millisecond, so wall_s and the latencies depend on the calls alone
    def __init__(self):
        self.calls = 0

    def monotonic(self):
        self.calls += 1
        return self.calls * 1e-3


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    cfg = get_config(request.param, reduced=True)
    params = checkpoint.init_params(cfg, torch.Generator().manual_seed(0),
                                    device="cpu")
    return cfg, params


@pytest.fixture(autouse=True)
def empty_tracer():
    program_tracer().spans.clear()
    yield
    program_tracer().spans.clear()


def _drain(model, profiled: bool):
    """A fresh engine with ``REQUESTS`` requests of 2-4 new tokens, drained
    with or without a CPU profiler. Returns (engine, done, profile)."""
    cfg, params = model
    eng = ContinuousBatchingEngine(cfg, params, max_slots=SLOTS,
                                   cache_len=CACHE_LEN)
    rng = np.random.default_rng(1)
    for i in range(REQUESTS):
        eng.submit(Request(
            f"r{i}", rng.integers(0, cfg.vocab_size, PROMPT_LEN)
            .astype(np.int32), max_new_tokens=2 + i % 3,
            stream_id=f"cam-{i % 2}"))
    if not profiled:
        return eng, eng.drain(), None
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        done = eng.drain()
    return eng, done, prof


def _walk(span, depth=0):
    yield span, depth
    for c in span.children:
        yield from _walk(c, depth + 1)


def _end(span):
    return span.start_s + span.wall_ms / 1e3


def test_no_profiler_no_span_and_the_same_results(model, monkeypatch):
    """Off, a drained engine records nothing; on, its outputs, ``stats``,
    ``report()`` and rates equal the unprofiled run's exactly, and the
    engine read its clock as often."""
    runs = []
    for profiled in (False, True):
        clock = EngineClock()
        monkeypatch.setattr(engine_mod, "time", clock)
        eng, done, _ = _drain(model, profiled)
        runs.append(({r.request_id: r.output.tolist() for r in done},
                     dict(eng.stats), eng.report(), eng.measured_rates(),
                     clock.calls))
        if not profiled:
            assert not program_tracer().spans
    assert runs[0] == runs[1]
    assert program_tracer().find("engine.step")


def test_each_step_is_a_tree_and_each_queue_wait_ends_at_its_prefill(model):
    _, done, _ = _drain(model, profiled=True)
    roots = program_tracer().spans
    steps = [s for s in roots if s.name == "engine.step"]
    queues = [s for s in roots if s.name == "request.queue"]
    assert {s.name for s in roots} == {"engine.step", "request.queue"}
    for step in steps:
        for sp, _ in _walk(step):
            assert sp.start_s is not None
            for c in sp.children:         # children inside their parent
                assert sp.start_s <= c.start_s and _end(c) <= _end(sp)
        kids = [c.name for c in step.children]
        assert set(kids) <= ENGINE_SPANS - {"engine.step", "engine.prefill"}
    prefills = {}
    for admit in program_tracer().find("engine.admit"):
        for pf in admit.children:
            assert pf.name == "engine.prefill"
            assert [c.name for c in pf.children] == ["engine.readback"]
            assert set(pf.attrs) == {"request_id", "slot", "prompt_len",
                                     "queue_depth"}
            assert pf.attrs["prompt_len"] == PROMPT_LEN
            prefills[pf.attrs["request_id"]] = pf
    for dec in program_tracer().find("engine.decode"):
        (inner,) = dec.children
        assert inner.name == "steps.decode" and inner.children == []
        assert 1 <= dec.attrs["active_slots"] <= SLOTS
    assert sorted(prefills) == sorted(r.request_id for r in done)
    assert sorted(q.attrs["request_id"] for q in queues) == sorted(prefills)
    for q in queues:
        assert q.wall_ms >= 0.0 and q.children == []
        assert _end(q) == pytest.approx(
            prefills[q.attrs["request_id"]].start_s, abs=1e-9)
    retired = program_tracer().find("engine.retire")
    assert {r.attrs["request_id"]: r.attrs["latency_s"] for r in retired} \
        == {r.request_id: r.latency_s for r in done}


def test_each_span_is_a_profiler_range_in_the_same_order(model):
    """Every span of the call stack is a ``repro_torch/<name>`` range of the
    profiler, in the same order and nesting (``request.queue`` is recorded
    after the fact and is not one), each holding its span and longer by
    50 µs at most."""
    _, _, prof = _drain(model, profiled=True)
    spans = [(sp, d) for root in program_tracer().spans
             if root.name != "request.queue" for sp, d in _walk(root)]
    ranges = sorted((e for e in prof.events()
                     if e.name.startswith(RANGE_PREFIX)),
                    key=lambda e: e.time_range.start)
    assert [RANGE_PREFIX + sp.name for sp, _ in spans] == \
        [e.name for e in ranges]
    depth, open_ends = [], []
    for e in ranges:
        while open_ends and open_ends[-1] <= e.time_range.start:
            open_ends.pop()
        depth.append(len(open_ends))
        open_ends.append(e.time_range.end)
    assert depth == [d for _, d in spans]
    for (sp, _), e in zip(spans, ranges):
        # two clocks, kineto's and perf_counter: a few µs either way
        assert -5.0 <= e.time_range.elapsed_us() - 1e3 * sp.wall_ms <= 50.0


def test_tracer_record_and_timeline_spans():
    plain, timeline = Tracer(), Tracer(timeline=True)
    with plain.span("replan"):
        pass
    with timeline.span("engine.step", t=2.0, slot=1) as sp:
        pass
    assert plain.spans[0].start_s is None and "start_s" not in \
        plain.to_rows()[0]
    assert sp.start_s is not None and sp.t == 2.0
    assert timeline.to_rows()[0]["start_s"] == sp.start_s
    q = timeline.record("request.queue", 10.0, 10.25, request_id="r0")
    assert timeline.spans[-1] is q and q.children == []
    assert (q.start_s, q.wall_ms, q.attrs) == (10.0, 250.0,
                                               {"request_id": "r0"})


def test_timeline_tracer_keeps_its_last_roots():
    tracer = Tracer(timeline=True, max_roots=3)
    for i in range(5):
        with tracer.span("engine.step", step=i):
            pass
        tracer.record("request.queue", float(i), i + 0.5)
    assert [(s.name, s.attrs) for s in tracer.spans] == [
        ("request.queue", {}), ("engine.step", {"step": 4}),
        ("request.queue", {})]
    assert program_tracer().spans.maxlen == trace_mod.PROGRAM_ROOTS
    tracer.spans.clear()
    assert not tracer.spans and tracer.to_rows() == []


def test_a_torch_without_the_range_keeps_the_span(monkeypatch):
    """Where torch lacks its operator-scope range, a timeline span is still
    recorded, with its start, and only the profiler range is missing."""
    monkeypatch.setattr(trace_mod, "_range_type", lambda: None)
    tracer = Tracer(timeline=True)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tracer.span("engine.step"):
            with tracer.span("steps.decode"):
                torch.ones(4).sum()
    (step,) = tracer.spans
    assert step.start_s is not None and step.children[0].start_s is not None
    assert not [e for e in prof.events() if e.name.startswith(RANGE_PREFIX)]


def test_chrome_trace_places_program_spans_at_their_starts():
    """A span with a host start is placed there (µs), with its children at
    theirs; roots that overlap take separate tracks; the file reads back
    to the same trees, ``start_s`` included."""
    child = Span("steps.decode", 0.0, wall_ms=1.0, start_s=5.0002)
    step = Span("engine.step", 0.0, wall_ms=2.0, children=[child],
                start_s=5.0)
    later = Span("engine.step", 0.0, wall_ms=1.0, start_s=5.003)
    queue = Span("request.queue", 0.0, wall_ms=4.0, start_s=4.9995)
    doc = chrome_trace([step, later, queue])
    begins = [(e["name"], e["ts"], e["tid"], e["cat"])
              for e in doc["traceEvents"] if e["ph"] == "B"]
    assert begins == [
        ("engine.step", pytest.approx(5.0e6), 1, "program"),
        ("steps.decode", pytest.approx(5.0002e6), 1, "program"),
        ("engine.step", pytest.approx(5.003e6), 1, "program"),
        ("request.queue", pytest.approx(4.9995e6), 2, "program")]
    ends = {(e["name"], e["tid"]): e["ts"] for e in doc["traceEvents"]
            if e["ph"] == "E"}
    assert ends[("request.queue", 2)] == pytest.approx(5.0035e6)
    assert spans_from_chrome_trace(doc) == [step, later, queue]


def _self_time_reader(monkeypatch):
    portbench = ROOT / "portbench"
    monkeypatch.syspath_prepend(str(portbench))
    spec = importlib.util.spec_from_file_location(
        "engine_self_ms_serve", portbench / "metrics" /
        "engine_self_ms.serve.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("kids, want", [
    ([], 10.0),                                  # all its own
    ([(1.0, 2.0), (5.0, 3.0)], 5.0),             # two apart
    ([(1.0, 4.0), (3.0, 4.0)], 4.0),             # overlapping: a union
    ([(2.0, 3.0), (2.5, 1.0)], 7.0),             # one inside another
    ([(8.0, 5.0), (-1.0, 2.0)], 7.0),            # clipped to the parent
])
def test_engine_self_time_arithmetic(monkeypatch, kids, want):
    """``engine_self_ms``: a step's wall time less the union of its
    children's intervals inside it (ms from the step's start)."""
    reader = _self_time_reader(monkeypatch)
    t0 = 100.0
    step = Span("engine.step", 0.0, wall_ms=10.0, start_s=t0, children=[
        Span("engine.decode", 0.0, wall_ms=d, start_s=t0 + s / 1e3)
        for s, d in kids])
    assert reader.self_ms(step) == pytest.approx(want, abs=1e-9)

"""Trace spans: what the control loop decided, and what the serving path
did, as trees.

A replan is not one event but a small causal chain — drift fired, the
calibration was rebuilt, the repair planner ran, the defrag hatch maybe
fired. Spans capture that chain the way an OpenTelemetry trace would:
each span carries the *simulated* time it happened at, its *wall-clock*
duration (the real solver cost), free-form attributes, and child spans
(``recalibrate`` nests the ``replan`` it forces). The tracer keeps finished
root spans in order; tests and benchmark artifacts read them back.

The serving path writes into one more tracer, the process's
:func:`program_tracer`, and only while a ``torch.profiler`` records on the
calling thread: profiling the process is the switch, with no option or
environment variable besides. Each of its spans keeps its host start on
``time.perf_counter`` (``Span.start_s``) and is also a profiler range named
``repro_torch/<name>``, so it lands on the profiler's timeline among torch's
operators and the device's kernels. The range has the scope of torch's own
operators, not a user range's: a profile that records operators (as
``torch.profiler.profile`` does by default) shows it, one that records only
user ranges leaves it out, and it never becomes a device-side annotation,
which some torch releases' events cannot tell from a kernel. That range is
torch's private ``_RecordFunctionFast``; on a torch without it the spans are
kept, without their ranges. The spans:

* ``engine.step`` — one ``ContinuousBatchingEngine.step``, the root of each
  iteration; its time outside its children is the engine's own
  bookkeeping;
* ``engine.admit`` — the earliest-deadline-first sort and the admissions;
  each admission an ``engine.prefill`` (``request_id``, ``slot``,
  ``prompt_len``, ``queue_depth``: requests still queued behind it);
* ``engine.decode`` (``active_slots``) — the batched decode step's issue,
  and inside it ``steps.decode``, the host's issue of
  ``models.steps.decode_step`` alone, with no synchronise;
* ``engine.readback`` — the greedy tokens copied to the host, where the
  host waits for the card;
* ``engine.retire`` (``request_id``, ``latency_s``) — a finished request;
* ``request.queue`` (``request_id``) — from ``submit`` to the start of the
  request's prefill. It is recorded at admission (:meth:`Tracer.record`),
  as a root of its own, and is not a profiler range.

The program tracer keeps the last ``PROGRAM_ROOTS`` root spans (minutes of
serving at a few dozen steps and admissions a second); clear them with
``program_tracer().spans.clear()``. It keeps one stack of open spans, so one
thread at a time serves while a profiler records. Export the spans with
``obs.export.write_chrome_trace``, which places each at its real start.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import time
from typing import Iterator, Optional

RANGE_PREFIX = "repro_torch/"     # of a timeline tracer's profiler ranges
PROGRAM_ROOTS = 16384             # root spans the program tracer keeps


@dataclasses.dataclass
class Span:
    """One traced operation at simulated time ``t`` (hours).

    ``wall_ms`` is the real time spent inside the span (solver calls are
    the control loop's true cost); ``attrs`` may be set while the span is
    open (e.g. the replan action chosen); ``children`` are spans opened
    while this one was active. ``start_s`` is the host start on
    ``time.perf_counter``, kept by a timeline tracer only (None for the
    replan spans).
    """

    name: str
    t: float
    wall_ms: float = 0.0
    attrs: dict = dataclasses.field(default_factory=dict)
    children: list["Span"] = dataclasses.field(default_factory=list)
    start_s: Optional[float] = None


class Tracer:
    """Collects spans; nesting follows the runtime call stack.

    A ``timeline`` tracer also keeps each span's ``start_s`` and puts a
    profiler range named ``repro_torch/<name>`` around each span, of
    operator scope (the module docstring says why; torch is imported then,
    so the replan loop's tracer stays numpy and stdlib). With
    ``max_roots`` it keeps only the last ``max_roots`` root spans. One
    thread at a time opens its spans."""

    def __init__(self, timeline: bool = False,
                 max_roots: Optional[int] = None) -> None:
        # finished *root* spans, in order
        self.spans: list[Span] = ([] if max_roots is None else
                                  collections.deque(maxlen=max_roots))
        self._stack: list[Span] = []
        self.timeline = timeline

    @contextlib.contextmanager
    def span(self, name: str, t: float = 0.0, **attrs) -> Iterator[Span]:
        sp = Span(name=name, t=t, attrs=dict(attrs))
        parent = self._stack[-1] if self._stack else None
        self._stack.append(sp)
        rng = None
        if self.timeline:
            range_type = _range_type()
            if range_type is not None:
                rng = range_type(RANGE_PREFIX + name)
                rng.__enter__()
        t0 = time.perf_counter()
        if self.timeline:
            sp.start_s = t0
        try:
            yield sp
        except BaseException as e:
            # a failing body (a solver call blowing up mid-replan) still
            # finalizes: mark the span, let the finally clause attach it to
            # its parent, and re-raise — the rest of the trace survives
            sp.attrs.setdefault("error", f"{type(e).__name__}: {e}")
            raise
        finally:
            sp.wall_ms = (time.perf_counter() - t0) * 1e3
            if rng is not None:
                rng.__exit__(None, None, None)
            self._stack.pop()
            if parent is not None:
                parent.children.append(sp)
            else:
                self.spans.append(sp)

    def record(self, name: str, start_s: float, end_s: float,
               **attrs) -> Span:
        """A finished root span from ``start_s`` to ``end_s`` (host seconds
        on ``time.perf_counter``), for what does not follow the call stack,
        such as a request's wait in a queue. It is not a profiler range."""
        sp = Span(name=name, t=0.0, wall_ms=(end_s - start_s) * 1e3,
                  attrs=dict(attrs), start_s=start_s)
        self.spans.append(sp)
        return sp

    def find(self, name: str) -> list[Span]:
        """All finished spans with this name, depth-first."""
        out: list[Span] = []

        def walk(sp: Span) -> None:
            if sp.name == name:
                out.append(sp)
            for child in sp.children:
                walk(child)

        for sp in self.spans:
            walk(sp)
        return out

    def to_rows(self, spans: Optional[list[Span]] = None,
                depth: int = 0) -> list[dict]:
        """JSON-ready rows, depth-annotated (pre-order)."""
        rows: list[dict] = []
        for sp in (self.spans if spans is None else spans):
            row = {"name": sp.name, "t": sp.t,
                   "wall_ms": round(sp.wall_ms, 3),
                   "depth": depth, "attrs": dict(sp.attrs)}
            if sp.start_s is not None:
                row["start_s"] = sp.start_s
            rows.append(row)
            rows.extend(self.to_rows(sp.children, depth + 1))
        return rows


@functools.cache
def _range_type():
    """torch's operator-scope profiler range, or None on a torch that has
    none."""
    try:
        from torch._C._profiler import _RecordFunctionFast
    except ImportError:
        return None
    return _RecordFunctionFast


_PROGRAM = Tracer(timeline=True, max_roots=PROGRAM_ROOTS)


def program_tracer() -> Tracer:
    """The process's timeline tracer, into which the serving path writes
    while a torch profiler records on the calling thread."""
    return _PROGRAM

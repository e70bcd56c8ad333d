"""Per-replan trace spans: what the control loop decided, and why, as a tree.

A replan is not one event but a small causal chain — drift fired, the
calibration was rebuilt, the repair planner ran, the defrag hatch maybe
fired. Spans capture that chain the way an OpenTelemetry trace would:
each span carries the *simulated* time it happened at, its *wall-clock*
duration (the real solver cost), free-form attributes, and child spans
(``recalibrate`` nests the ``replan`` it forces). The tracer keeps finished
root spans in order; tests and benchmark artifacts read them back.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Iterator, Optional


@dataclasses.dataclass
class Span:
    """One traced operation at simulated time ``t`` (hours).

    ``wall_ms`` is the real time spent inside the span (solver calls are
    the control loop's true cost); ``attrs`` may be set while the span is
    open (e.g. the replan action chosen); ``children`` are spans opened
    while this one was active.
    """

    name: str
    t: float
    wall_ms: float = 0.0
    attrs: dict = dataclasses.field(default_factory=dict)
    children: list["Span"] = dataclasses.field(default_factory=list)


class Tracer:
    """Collects spans; nesting follows the runtime call stack."""

    def __init__(self) -> None:
        self.spans: list[Span] = []          # finished *root* spans, in order
        self._stack: list[Span] = []

    @contextlib.contextmanager
    def span(self, name: str, t: float = 0.0, **attrs) -> Iterator[Span]:
        sp = Span(name=name, t=t, attrs=dict(attrs))
        parent = self._stack[-1] if self._stack else None
        self._stack.append(sp)
        t0 = time.perf_counter()
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
            self._stack.pop()
            if parent is not None:
                parent.children.append(sp)
            else:
                self.spans.append(sp)

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
            rows.append({"name": sp.name, "t": sp.t,
                         "wall_ms": round(sp.wall_ms, 3),
                         "depth": depth, "attrs": dict(sp.attrs)})
            rows.extend(self.to_rows(sp.children, depth + 1))
        return rows

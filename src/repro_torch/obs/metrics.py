"""Streaming metric export: the event loop's live signal, not a post-hoc read.

The fleet simulator's :class:`~repro_torch.sim.ledger.Ledger` is a DataFrame-shaped
record you inspect *after* the run; a production fleet needs signals *during*
it. :class:`TelemetryHub` is that bridge, modeled on OpenFilter's
observability layer and its OpenTelemetry exporter: producers ``emit()``
named points as simulated time advances, and subscribers (dashboards, the
drift detector, a JSON exporter) receive every point synchronously at emit
time — incremental export, no buffering required to observe the run live.

Metric names follow OTel-ish dotted conventions; the full catalog exported
by the simulator is documented in docs/observability.md ("The hub and the
metric catalog"). Everything is plain data: points are frozen, the hub keeps
an append-only list, and ``series(name)`` gives the per-metric time series
for tests and plots.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional


@dataclasses.dataclass(frozen=True)
class MetricPoint:
    """One exported measurement at simulated time ``t`` (hours).

    ``attrs`` are sorted key/value labels (e.g. ``market="spot"``), kept as
    a tuple so points stay hashable and comparable in tests.
    """

    t: float
    name: str
    value: float
    attrs: tuple[tuple[str, str], ...] = ()

    def attr(self, key: str) -> Optional[str]:
        for k, v in self.attrs:
            if k == key:
                return v
        return None


Subscriber = Callable[[MetricPoint], None]


class TelemetryHub:
    """Append-only stream of :class:`MetricPoint` with push subscribers.

    ``emit()`` is the producer API (the fleet event loop, the cluster's
    boot/terminate hooks, the recalibrating policy); ``subscribe()`` is the
    consumer API — callbacks run synchronously in emit order, so a consumer
    observes the simulation *as it happens* rather than after ``run()``
    returns. ``latest``/``series`` are pull-side conveniences over the same
    stream.
    """

    def __init__(self) -> None:
        self.points: list[MetricPoint] = []
        self._latest: dict[str, MetricPoint] = {}
        self._subscribers: list[Subscriber] = []
        # (t, subscriber repr, error repr) per delivery failure — a raising
        # subscriber (an exporter hitting a closed file, a flaky dashboard
        # callback) must never abort the producer's event loop
        self.subscriber_failures: list[tuple[float, str, str]] = []

    def subscribe(self, fn: Subscriber) -> None:
        """Register a callback invoked synchronously on every emit."""
        self._subscribers.append(fn)

    def emit(self, t: float, name: str, value: float, **attrs: str) -> MetricPoint:
        point = MetricPoint(t=t, name=name, value=float(value),
                            attrs=tuple(sorted((k, str(v))
                                               for k, v in attrs.items()))
                            if attrs else ())
        self.points.append(point)
        self._latest[name] = point
        for fn in self._subscribers:
            # subscriber isolation: one raising consumer must not abort the
            # fleet event loop nor starve the remaining subscribers — record
            # the failure and keep delivering
            try:
                fn(point)
            except Exception as e:            # noqa: BLE001 - isolation point
                self.subscriber_failures.append(
                    (t, getattr(fn, "__qualname__", None) or repr(fn),
                     f"{type(e).__name__}: {e}"))
        return point

    # -- pull-side views ------------------------------------------------------

    def latest(self, name: str) -> Optional[float]:
        """Most recent value of a metric (None if never emitted)."""
        point = self._latest.get(name)
        return None if point is None else point.value

    def series(self, name: str) -> list[tuple[float, float]]:
        """The (t, value) time series of one metric, in emit order."""
        return [(p.t, p.value) for p in self.points if p.name == name]

    def names(self) -> list[str]:
        """Every metric name seen so far, sorted."""
        return sorted({p.name for p in self.points})

    def to_rows(self) -> list[dict]:
        """JSON-ready rows (benchmark artifacts serialize these)."""
        return [{"t": p.t, "name": p.name, "value": p.value,
                 "attrs": dict(p.attrs)} for p in self.points]

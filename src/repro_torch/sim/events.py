"""Discrete-event core of the fleet simulator.

A single priority queue orders everything that happens in simulated time:
control-loop ticks, spot preemptions (scheduled mid-interval by the market),
and the end of the horizon. Instance boots and price-walk updates are not
queue events — boots are modeled by each instance's ``ready_t`` window and
prices advance once per tick. Events at equal times break ties by insertion
sequence, which — together with seeded RNGs everywhere else — makes whole
simulations bit-for-bit deterministic (the acceptance criterion for the
ledger).
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Any, Optional

# Event kinds
TICK = "tick"                  # control-loop boundary: demand + plan + account
PREEMPT = "preempt"            # the spot market reclaimed an instance
                               # (hazard draw on a legacy spot rental)
OUTBID = "outbid"              # the spot price rose above an instance's bid
                               # — the deterministic reclaim of bid-carrying
                               # rentals (see SpotMarket.outbid)
END = "end"                    # end of simulation horizon


@dataclasses.dataclass(order=True, frozen=True)
class Event:
    """One simulation event at ``time`` (simulated hours since the start);
    ``seq`` is the insertion tie-breaker, ``kind`` one of TICK / PREEMPT /
    END, ``payload`` the instance id for preemptions."""

    time: float                   # simulated hours
    seq: int
    kind: str = dataclasses.field(compare=False)
    payload: Any = dataclasses.field(compare=False, default=None)


class EventQueue:
    """Min-heap of :class:`Event` ordered by (time, insertion sequence)."""

    def __init__(self) -> None:
        self._heap: list[Event] = []
        self._seq = 0

    def push(self, time: float, kind: str, payload: Any = None) -> Event:
        ev = Event(time=time, seq=self._seq, kind=kind, payload=payload)
        self._seq += 1
        heapq.heappush(self._heap, ev)
        return ev

    def pop(self) -> Event:
        return heapq.heappop(self._heap)

    def peek(self) -> Optional[Event]:
        return self._heap[0] if self._heap else None

    def __len__(self) -> int:
        return len(self._heap)

    def __bool__(self) -> bool:
        return bool(self._heap)

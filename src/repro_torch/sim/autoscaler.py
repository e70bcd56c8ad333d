"""Autoscaling policies over the paper's planning machinery.

Each policy answers one question per tick: *what should the fleet plan be
for the demand we see right now?* All of them delegate the actual packing to
:class:`~repro_torch.core.manager.ResourceManager` (via
:class:`~repro_torch.core.adaptive.AdaptiveManager` for the adaptive ones, whose
``replan_trigger`` hook and ``force`` flag this module exercises):

* ``StaticPeakPolicy`` — the baseline: plan once for the scanned peak
  demand, never touch it again. Maximum SLO, maximum cost.
* ``ReactivePolicy`` — replan when the current plan can't serve demand, or
  when a replan saves more than the hysteresis threshold.
* ``ScheduledPolicy`` — reactive, but voluntary (cost-saving) replans are
  only *considered* every ``every_h`` hours; infeasibility still forces.
* ``PredictiveEWMAPolicy`` — plans for an EWMA-extrapolated forecast of
  each stream's rate, so capacity boots *before* the ramp arrives instead
  of after it (trading a little cost for boot-window SLO).
* ``RepairPolicy`` — reactive, but replans run through the min-migration
  repair planner (``core/repair.py``): feasible placements stay put, only
  the delta re-packs, and a defrag escape hatch bounds the cost drift.

``SpotBidPolicy`` (in :mod:`repro_torch.sim.bidding`) extends the family with
mixed on-demand/spot planning: per-region bids against the price walk, an
on-demand floor per stream class, and replica anti-affinity across spot
markets.

A spot preemption reaches a policy as ``decide(..., preempted=True)``; the
adaptive policies force a replan, which replays the orphaned streams onto
live capacity.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

from repro_torch.core.adaptive import AdaptiveManager
from repro_torch.core.manager import ResourceManager
from repro_torch.core.repair import RepairConfig
from repro_torch.core.strategies import Plan
from repro_torch.core.workload import Stream


class StaticPeakPolicy:
    """Provision the scanned peak (each stream's maximum frames/s over the
    horizon) once; ignore demand thereafter. Maximum SLO, maximum $/hour."""

    def __init__(self, manager: ResourceManager, peak: Sequence[Stream],
                 strategy: str = "FFD") -> None:
        self.name = "static-peak"
        self._manager = manager
        self._peak = list(peak)
        self._strategy = strategy
        self._plan: Optional[Plan] = None

    def decide(self, t: float, streams: Sequence[Stream], *,
               preempted: bool = False) -> Plan:
        if self._plan is None:
            self._plan = self._manager.plan(self._peak, self._strategy)
        return self._plan


class ReactivePolicy:
    """Adaptive replanning with hysteresis (the paper's runtime manager):
    replan when the plan cannot serve the demanded frames/s, or when a
    replan saves more than ``savings_threshold`` (a fraction of the current
    plan's $/hour cost)."""

    def __init__(self, manager: ResourceManager, strategy: str = "FFD",
                 savings_threshold: float = 0.10, replan_trigger=None,
                 name: str = "reactive") -> None:
        self.name = name
        self.adaptive = AdaptiveManager(manager, strategy=strategy,
                                        savings_threshold=savings_threshold,
                                        replan_trigger=replan_trigger)

    def decide(self, t: float, streams: Sequence[Stream], *,
               preempted: bool = False) -> Plan:
        return self.adaptive.step(t, streams, force=preempted)


class RepairPolicy(ReactivePolicy):
    """Reactive control loop whose replans are min-migration repairs
    (demanded rates in frames/s, plan costs in $/hour).

    Preemption replays and demand-growth replans keep every still-feasible
    placement and re-pack only the orphaned/overflowing delta; cost drift is
    bounded by the defrag escape hatch (adopt a fresh FFD plan when repaired
    cost reaches ``defrag_ratio`` x the fresh cost). ``migration_budget``
    additionally lets each repair spend leftover moves on consolidation.
    """

    def __init__(self, manager: ResourceManager,
                 savings_threshold: float = 0.10,
                 migration_budget: Optional[int] = None,
                 defrag_ratio: Optional[float] = 1.25,
                 name: str = "repair") -> None:
        super().__init__(manager, strategy="REPAIR",
                         savings_threshold=savings_threshold, name=name)
        self.adaptive.repair = RepairConfig(migration_budget=migration_budget,
                                            defrag_ratio=defrag_ratio)


class ScheduledPolicy(ReactivePolicy):
    """Voluntary replans only on a fixed cadence (e.g. every 6 simulated
    hours); demand infeasibility and preemptions still replan immediately.

    The cadence phase — and the adaptive plan state — reset whenever
    simulated time moves backwards, i.e. when one policy object is reused
    across :class:`~repro_torch.sim.fleet.FleetSimulator` runs: the second run's
    first decision must behave exactly like a fresh policy's, not inherit
    the prior run's phase (or its final plan)."""

    def __init__(self, manager: ResourceManager, every_h: float = 6.0,
                 strategy: str = "FFD",
                 savings_threshold: float = 0.10) -> None:
        last = [None]

        def on_schedule(t, streams, plan) -> bool:
            # elapsed-time cadence, robust to tick sizes that do not divide
            # every_h (a modulo test would fire rarely or never for those)
            if last[0] is None or t - last[0] >= every_h - 1e-9:
                last[0] = t
                return True
            return False

        super().__init__(manager, strategy=strategy,
                         savings_threshold=savings_threshold,
                         replan_trigger=on_schedule, name="scheduled")
        self.every_h = every_h
        self._last_voluntary = last
        self._last_decide_t: Optional[float] = None

    def decide(self, t: float, streams: Sequence[Stream], *,
               preempted: bool = False) -> Plan:
        if self._last_decide_t is not None and t < self._last_decide_t - 1e-9:
            # a new run started: reset the cadence phase and the plan state
            # (the events list is replaced, not cleared, so a finished
            # simulator's view of the old trace stays intact)
            self._last_voluntary[0] = None
            self.adaptive.current = None
            self.adaptive.events = []
        self._last_decide_t = t
        return super().decide(t, streams, preempted=preempted)


class PredictiveEWMAPolicy(ReactivePolicy):
    """Plan for a ``lead_h``-hours-ahead forecast: EWMA-smoothed per-stream
    trend in frames/s **per hour**, floored at current demand so falling
    forecasts never under-provision, capped at ``cap_fps`` frames/s.

    Time units matter here. The observed trend is ``Δfps / Δt`` between
    decisions and the extrapolation horizon ``lead_h`` is in simulated
    hours, so the forecast is a function of the demand *path*, not of the
    control-loop period: halving ``dt_h`` (or running the fleet's fractional
    final tick) yields the same forecasts at the same times. The EWMA decay
    is time-based too — ``(1 - alpha)`` per hour of elapsed time — so the
    smoothing window is a wall-clock quantity. At the legacy 1-hour tick
    every expression reduces bit-for-bit to the historical per-observation
    form (``lead_ticks`` remains as a deprecated alias for that era's
    callers: one tick meant one hour).
    """

    def __init__(self, manager: ResourceManager, strategy: str = "FFD",
                 savings_threshold: float = 0.10, alpha: float = 0.3,
                 lead_h: Optional[float] = None, cap_fps: float = 12.0,
                 lead_ticks: Optional[float] = None) -> None:
        super().__init__(manager, strategy=strategy,
                         savings_threshold=savings_threshold,
                         name="predictive-ewma")
        self.alpha = alpha
        if lead_h is None:
            # deprecated alias: a "tick" of lead is interpreted at the
            # legacy 1-hour control period
            lead_h = float(lead_ticks) if lead_ticks is not None else 2.0
        self.lead_h = lead_h
        self.cap_fps = cap_fps
        self._prev_fps: dict[str, float] = {}
        self._trend: dict[str, float] = {}        # frames/s per hour
        self._last_t: Optional[float] = None

    @property
    def lead_ticks(self) -> float:
        """Deprecated alias for :attr:`lead_h` (ticks were hours)."""
        return self.lead_h

    @lead_ticks.setter
    def lead_ticks(self, value: float) -> None:
        self.lead_h = float(value)

    def forecast(self, streams: Sequence[Stream],
                 dt_h: float = 1.0) -> list[Stream]:
        """One observation + extrapolation pass. ``dt_h`` is the simulated
        time since the previous observation (the legacy default of 1.0
        reproduces the historical per-tick behavior exactly)."""
        if dt_h == 1.0:
            # bit-identical to the historical per-observation update
            decay, gain = 1.0 - self.alpha, self.alpha
        else:
            decay = (1.0 - self.alpha) ** dt_h
            gain = 1.0 - decay
        out = []
        present = set()
        for s in streams:
            present.add(s.stream_id)
            prev = self._prev_fps.get(s.stream_id, s.fps)
            trend = (s.fps - prev) / dt_h         # frames/s per hour
            ewma = decay * self._trend.get(s.stream_id, 0.0) + gain * trend
            self._trend[s.stream_id] = ewma
            self._prev_fps[s.stream_id] = s.fps
            f = max(s.fps, s.fps + ewma * self.lead_h)
            out.append(dataclasses.replace(
                s, fps=round(min(f, self.cap_fps), 3)))
        # evict state for departed streams: a churned-out camera that later
        # rejoins must start a fresh trend (not inherit a stale one), and
        # state must stay bounded by the live fleet under heavy churn
        for sid in list(self._prev_fps):
            if sid not in present:
                del self._prev_fps[sid]
                self._trend.pop(sid, None)
        return out

    def decide(self, t: float, streams: Sequence[Stream], *,
               preempted: bool = False) -> Plan:
        if self._last_t is not None and t < self._last_t - 1e-9:
            # the policy object was reused for a new run: trends observed
            # across the time jump would be garbage
            self._prev_fps.clear()
            self._trend.clear()
            self._last_t = None
        # the realized interval since the last decision (the fleet's
        # accumulation schedule keeps decisions at k*dt, but this stays correct even for
        # irregular calls); the first observation has no interval — its
        # trend is zero regardless, so any positive dt is equivalent
        dt_h = (t - self._last_t) if self._last_t is not None else 1.0
        if dt_h <= 0:
            dt_h = 1.0
        self._last_t = t
        return self.adaptive.step(t, self.forecast(streams, dt_h),
                                  force=preempted)

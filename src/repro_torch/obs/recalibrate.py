"""Online recalibration: re-profile on drift, repair-replan, move on.

:class:`RecalibratingPolicy` wraps any autoscaling policy and closes the
profile→pack→observe loop each tick:

1. **observe** — read the service probe's measured rates for this window
   and export them (plus the drift error) to the telemetry hub;
2. **detect** — feed the measurement to the :class:`DriftDetector` against
   the *active* calibration;
3. **recalibrate** — when the detector fires, adopt the measured rates as
   the new calibration (re-profiling) and force a replan, flagged on the
   adaptive event trace as recalibration-triggered; with a repair-mode
   inner policy the replan runs through ``core/repair.py`` — feasible
   placements stay put, the budget/defrag machinery converts the corrected
   belief into a cheaper packing;
4. **pack** — hand the inner policy the demanded streams with each rate
   clamped to the calibrated sustainable frames/s: capacity the serving
   layer cannot absorb is not worth renting.

The wrapper is transparent to the fleet simulator: it forwards ``name``,
``adaptive``, ``bids`` and ``attach_market``, and exposes ``last_drift``
(the verdict backing the ledger's calibration-error column).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

from repro_torch.core.strategies import Plan
from repro_torch.core.workload import Stream
from repro_torch.obs.drift import DriftDetector, DriftVerdict
from repro_torch.obs.metrics import TelemetryHub
from repro_torch.obs.trace import Tracer
from repro_torch.sim.ledger import ServiceCalibration


class RecalibratingPolicy:
    """Drift-aware wrapper over an autoscaling policy (module doc above).

    ``service`` is the ground truth (``tokens_per_frame``, the startup
    profile); ``probe`` is the measurement source — anything with
    ``measure(t) -> {stream_id: tokens/s}``. By default the service itself
    is the probe (the exact instantaneous read); pass a
    :class:`~repro_torch.obs.regional.WindowedServiceProbe` for live
    ``windowed_rates()`` delta-export semantics, or an adapter over real
    engines. The initial belief is ``calibration`` if given, else the
    service's startup profile (``initial_calibration()``).
    """

    def __init__(self, inner, service, *,
                 detector: Optional[DriftDetector] = None,
                 telemetry: Optional[TelemetryHub] = None,
                 tracer: Optional[Tracer] = None,
                 calibration: Optional[ServiceCalibration] = None,
                 probe=None) -> None:
        self.inner = inner
        self.name = f"recal-{inner.name}"
        self.service = service
        self.probe = probe if probe is not None else service
        self.detector = detector or DriftDetector()
        self.telemetry = telemetry or TelemetryHub()
        self.tracer = tracer or Tracer()
        self.calibration = (calibration if calibration is not None
                            else service.initial_calibration())
        self.last_drift: Optional[DriftVerdict] = None
        self.recalibrations: list[float] = []     # simulated hours fired at

    # -- fleet-simulator plumbing (forwarded to the wrapped policy) ----------

    @property
    def adaptive(self):
        return getattr(self.inner, "adaptive", None)

    @property
    def bids(self):
        return getattr(self.inner, "bids", None)

    def attach_market(self, market, dt_h: float, boot_delay_h: float) -> None:
        attach = getattr(self.inner, "attach_market", None)
        if attach is not None:
            attach(market, dt_h, boot_delay_h)

    # -- the loop ------------------------------------------------------------

    def _clamped(self, streams: Sequence[Stream]) -> list[Stream]:
        """Demanded streams with rates clamped to the calibrated sustainable
        frames/s (floored at 3 decimals so the cap stays a hard ceiling)."""
        out = []
        for s in streams:
            cap = self.calibration.frame_rate_cap(s.stream_id)
            if cap < s.fps:
                out.append(dataclasses.replace(
                    s, fps=math.floor(cap * 1000) / 1000))
            else:
                out.append(s)
        return out

    def _recalibrate(self, t: float, measured: dict) -> None:
        rates = dict(measured)
        default = (sum(rates.values()) / len(rates)) if rates else None
        self.calibration = ServiceCalibration(
            tokens_per_frame=self.service.tokens_per_frame,
            rates_tokens_per_s=rates, default_rate=default)
        self.detector.reset()
        self.recalibrations.append(t)
        if self.adaptive is not None:
            self.adaptive.flag_recalibration()

    def decide(self, t: float, streams: Sequence[Stream], *,
               preempted: bool = False) -> Plan:
        measured = self.probe.measure(t)
        verdict = self.detector.observe(t, measured, self.calibration)
        self.last_drift = verdict
        self.telemetry.emit(t, "drift.rel_error", verdict.rel_error)
        self.telemetry.emit(t, "drift.streak", verdict.streak)

        recalibrated = False
        if verdict.fired:
            with self.tracer.span("recalibrate", t=t,
                                  rel_error=round(verdict.rel_error, 6),
                                  streak=verdict.streak) as sp:
                self._recalibrate(t, measured)
                recalibrated = True
                self.telemetry.emit(t, "drift.recalibrations",
                                    len(self.recalibrations))
                plan = self._decide_inner(t, streams,
                                          preempted=preempted, force=True)
                sp.attrs["plan_cost_usd_per_h"] = round(plan.hourly_cost, 6)
        if not recalibrated:
            plan = self._decide_inner(t, streams, preempted=preempted)
        self.telemetry.emit(t, "plan.cost.usd_per_h", plan.hourly_cost)
        return plan

    def _decide_inner(self, t: float, streams: Sequence[Stream], *,
                      preempted: bool, force: bool = False) -> Plan:
        with self.tracer.span("replan.decide", t=t) as sp:
            plan = self.inner.decide(t, self._clamped(streams),
                                     preempted=preempted or force)
            events = getattr(self.adaptive, "events", None)
            if events:
                sp.attrs["action"] = events[-1].action
                sp.attrs["migrations"] = events[-1].migrations
        # the span's wall clock is the solver's true cost — export it so a
        # hub-side Histogram can report exact p50/p95/p99 per run
        self.telemetry.emit(t, "replan.wall_ms", sp.wall_ms)
        return plan

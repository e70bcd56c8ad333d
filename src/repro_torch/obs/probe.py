"""Ground-truth serving rates for the simulator, and the probe that reads them.

In a real deployment the "truth" is the serving fleet itself and the probe
is ``ContinuousBatchingEngine.windowed_rates()``. In the simulator the truth
must be modeled: :class:`DriftingService` holds each stream's sustainable
tokens/s as a piecewise-constant function of simulated time — a base
profile plus :class:`RateShift` events (a codec regression at noon, a noisy
neighbor on one camera group). The fleet simulator caps analyzed frames by
this *true* rate, while policies plan from whatever
:class:`~repro_torch.sim.ledger.ServiceCalibration` they believe — the gap
between the two is exactly what the drift detector measures.

Deliberately exact (no measurement noise): benchmark gates and golden
ledgers need determinism, and the detector's threshold/hold machinery is
what absorbs noise in a real deployment.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Optional, Sequence

from repro_torch.sim.ledger import ServiceCalibration


@dataclasses.dataclass(frozen=True)
class RateShift:
    """A step change in true serving rates at ``at_h`` (simulated hours):
    every affected stream's rate is multiplied by ``factor`` from then on.
    ``streams=None`` affects the whole fleet."""

    at_h: float
    factor: float
    streams: Optional[frozenset[str]] = None

    def applies_to(self, stream_id: str) -> bool:
        return self.streams is None or stream_id in self.streams


class DriftingService:
    """True per-stream serving rates over time (tokens/s), plus the probe.

    ``measure(t)`` is what a live engine's windowed export would report at
    ``t``; ``frame_rate_cap(sid, t)`` is the frames/s the serving layer
    actually sustains (rate ÷ tokens-per-frame) — the fleet simulator's
    accounting cap. ``initial_calibration()`` is the profile-once-at-startup
    belief every policy begins with.
    """

    def __init__(self, base_rates_tokens_per_s: Mapping[str, float], *,
                 tokens_per_frame: float = 8.0,
                 shifts: Sequence[RateShift] = (),
                 default_rate: Optional[float] = None) -> None:
        self.base_rates = dict(base_rates_tokens_per_s)
        self.tokens_per_frame = tokens_per_frame
        self.shifts = tuple(sorted(shifts, key=lambda s: s.at_h))
        self.default_rate = default_rate

    def _rate(self, stream_id: str, t_h: float) -> Optional[float]:
        rate = self.base_rates.get(stream_id, self.default_rate)
        if rate is None:
            return None
        for shift in self.shifts:
            if shift.at_h <= t_h and shift.applies_to(stream_id):
                rate *= shift.factor
        return rate

    def rates_at(self, t_h: float) -> dict[str, float]:
        """True tokens/s per known stream at simulated hour ``t_h``."""
        return {sid: self._rate(sid, t_h) for sid in sorted(self.base_rates)}

    def measure(self, t_h: float) -> dict[str, float]:
        """The exact probe: the instantaneous true rates at ``t_h``."""
        return self.rates_at(t_h)

    def mean_rates(self, t0_h: float, t1_h: float) -> dict[str, float]:
        """Time-averaged true tokens/s over the window ``[t0_h, t1_h]``.

        This is what a live engine's ``windowed_rates()`` delta export
        reports for the window: a shift landing mid-window shows up at its
        time-weighted magnitude (and at full magnitude one window later),
        unlike the instantaneous ``measure()`` probe. Piecewise-constant
        integration over the shift breakpoints — exact, no sampling."""
        if t1_h <= t0_h:
            return self.rates_at(t1_h)
        edges = [t0_h] + [s.at_h for s in self.shifts
                          if t0_h < s.at_h < t1_h] + [t1_h]
        span = t1_h - t0_h
        out: dict[str, float] = {}
        for sid in sorted(self.base_rates):
            total = 0.0
            for a, b in zip(edges, edges[1:]):
                rate = self._rate(sid, a)
                if rate is None:
                    total = None
                    break
                total += rate * (b - a)
            if total is not None:
                out[sid] = total / span
        return out

    def frame_rate_cap(self, stream_id: str, t_h: float) -> float:
        """Frames/s the serving layer sustains for this stream right now
        (inf for streams the service has never seen and has no default
        for — same convention as ``ServiceCalibration``)."""
        rate = self._rate(stream_id, t_h)
        if rate is None:
            return math.inf
        return rate / self.tokens_per_frame

    def calibration_at(self, t_h: float) -> ServiceCalibration:
        """A calibration profiled from the rates in force at ``t_h``."""
        rates = self.rates_at(t_h)
        default = (sum(rates.values()) / len(rates)) if rates else None
        return ServiceCalibration(tokens_per_frame=self.tokens_per_frame,
                                  rates_tokens_per_s=rates,
                                  default_rate=default)

    def initial_calibration(self) -> ServiceCalibration:
        """The startup profile (t = 0) — the belief a non-recalibrating
        policy keeps forever."""
        return self.calibration_at(0.0)

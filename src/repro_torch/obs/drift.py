"""Calibration drift detection: measured rates vs the active calibration.

The packing loop plans from a :class:`~repro_torch.sim.ledger.ServiceCalibration`
profiled at startup; the serving layer's *measured* rates move underneath it
(codec changes, scene load, noisy neighbors). The detector compares each
observation window's measured tokens/s per stream against the calibrated
rate and declares drift when the mean relative error exceeds
``rel_threshold`` for ``hold_ticks`` *consecutive* observations — one bad
window is noise, K held windows are a regression.

Two deliberate asymmetries guard against phantom drift (the failure modes
fixed alongside this detector):

* an **empty measurement** (idle engine — ``measured_rates()`` is ``{}``,
  the engine's ``report()`` SLO is ``None``) carries no drift evidence: the
  streak neither grows nor resets, and the verdict is "no data", never
  "no drift";
* streams absent from the calibration with no ``default_rate`` are skipped —
  an unprofiled stream cannot contradict a profile it is not part of.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping


@dataclasses.dataclass(frozen=True)
class DriftConfig:
    """Detection knobs.

    ``rel_threshold`` — mean |measured − calibrated| / calibrated above
    which a window counts as drifting. ``hold_ticks`` — consecutive
    drifting windows before the detector fires (K). ``min_rate`` —
    calibrated rates at or below this (tokens/s) are ignored rather than
    divided by.
    """

    rel_threshold: float = 0.25
    hold_ticks: int = 3
    min_rate: float = 1e-9


@dataclasses.dataclass(frozen=True)
class DriftVerdict:
    """One observation window's outcome.

    ``drifting`` — this window exceeded the threshold; ``fired`` — the
    streak reached ``hold_ticks`` and recalibration should trigger;
    ``n_streams`` — streams actually compared (0 = no evidence either way).
    """

    t: float
    rel_error: float
    max_rel_error: float
    streak: int
    drifting: bool
    fired: bool
    n_streams: int


class DriftDetector:
    """Streak-counting comparator of measured rates vs the calibration."""

    def __init__(self, config: DriftConfig = DriftConfig()) -> None:
        self.config = config
        self.streak = 0
        self.history: list[DriftVerdict] = []

    def observe(self, t: float, measured: Mapping[str, float],
                calibration) -> DriftVerdict:
        """Compare one measurement window against the active calibration.

        ``measured`` is a ``measured_rates()``-shaped dict (tokens/s per
        stream); ``calibration`` any object with ``rates_tokens_per_s`` and
        ``default_rate`` (i.e. :class:`~repro_torch.sim.ledger.ServiceCalibration`).
        """
        cfg = self.config
        errors: list[float] = []
        for sid in sorted(measured):
            cal = calibration.rates_tokens_per_s.get(
                sid, calibration.default_rate)
            if cal is None or cal <= cfg.min_rate:
                continue
            errors.append(abs(measured[sid] - cal) / cal)

        if not errors:
            # no evidence: an idle engine must not look like perfect health
            # (streak preserved) nor like drift (streak not grown)
            verdict = DriftVerdict(t=t, rel_error=0.0, max_rel_error=0.0,
                                   streak=self.streak, drifting=False,
                                   fired=False, n_streams=0)
        else:
            rel = sum(errors) / len(errors)
            drifting = rel > cfg.rel_threshold
            self.streak = self.streak + 1 if drifting else 0
            verdict = DriftVerdict(t=t, rel_error=rel,
                                   max_rel_error=max(errors),
                                   streak=self.streak, drifting=drifting,
                                   fired=self.streak >= cfg.hold_ticks,
                                   n_streams=len(errors))
        self.history.append(verdict)
        return verdict

    def reset(self) -> None:
        """Forget the streak (called after a recalibration adopts the
        measured rates — the error is zero by construction)."""
        self.streak = 0

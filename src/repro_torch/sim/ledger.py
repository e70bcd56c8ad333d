"""Cost/SLO ledger and the serving-measurement calibration path.

The ledger is the simulator's single source of truth for outcomes: per-tick
dollars, frames demanded vs analyzed vs dropped (conservation holds exactly:
``demanded == analyzed + dropped`` every tick), migrations, preemptions, and
instance-hours by (location, type, market). ``totals()`` is a deterministic
summary — the acceptance test runs a scenario twice under one seed and
asserts the dicts are equal.

``ServiceCalibration`` closes the loop with the serving layer: a
``ContinuousBatchingEngine``'s ``measured_rates()`` (tokens/sec per stream)
divided by tokens-per-frame bounds how many frames a simulated stream can
actually have analyzed per tick, and the same rates feed
``gpu_catalog.streams_from_measured`` to build H100 packing items — the
paper's profile-then-pack loop, replayed inside the simulator.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Optional


@dataclasses.dataclass(frozen=True)
class ServiceCalibration:
    """Measured serving rates mapped onto the simulator's frame accounting."""

    tokens_per_frame: float = 8.0
    rates_tokens_per_s: Mapping[str, float] = dataclasses.field(
        default_factory=dict)
    default_rate: Optional[float] = None     # for streams never measured

    @classmethod
    def from_engine(cls, engine,
                    tokens_per_frame: float = 8.0) -> "ServiceCalibration":
        """Calibrate from a serving engine's ``measured_rates()`` export; the
        mean measured rate covers streams the engine never saw."""
        rates = dict(engine.measured_rates())
        default = (sum(rates.values()) / len(rates)) if rates else None
        return cls(tokens_per_frame=tokens_per_frame,
                   rates_tokens_per_s=rates, default_rate=default)

    def frame_rate_cap(self, stream_id: str) -> float:
        """Frames/sec the serving layer sustains for this stream (inf if
        uncalibrated)."""
        rate = self.rates_tokens_per_s.get(stream_id, self.default_rate)
        if rate is None:
            return math.inf
        return rate / self.tokens_per_frame

    def packing_streams(self, arch: str, *, kv_seq: int = 32_768):
        """The same measurements as H100 packing items (profile-then-pack)."""
        from repro_torch.core.gpu_catalog import streams_from_measured
        return streams_from_measured(arch, dict(self.rates_tokens_per_s),
                                     kv_seq=kv_seq)


@dataclasses.dataclass(frozen=True)
class TickRecord:
    """One accounting interval of the simulation (the benchmark JSON
    artifacts serialize these; docs/simulator.md documents the schema).

    Frames are counts over the interval (frames/s x seconds); ``cost`` is
    dollars accrued over the interval; conservation holds exactly:
    ``frames_demanded == frames_analyzed + frames_dropped``.
    """

    t: float                      # interval start, simulated hours (UTC)
    cost: float                   # $ accrued this tick
    frames_demanded: float
    frames_analyzed: float
    frames_dropped: float
    migrations: int               # streams whose instance changed this tick
    preemptions: int              # spot reclaims that landed this tick
    instances_live: int           # live instances at the decision point
    streams: int                  # demanded streams at the decision point
    defrags: int = 0              # repair-mode full-replan escape hatches
    cost_ondemand: float = 0.0    # $ of `cost` billed at on-demand prices
    cost_spot: float = 0.0        # $ of `cost` billed at spot prices
    outbids: int = 0              # of `preemptions`: bids the price rose over
    calib_rel_error: float = 0.0  # mean |measured-calibrated|/calibrated rate
                                  # observed at this tick's decision (0 when
                                  # no drift detector is attached)
    recalibrations: int = 0       # drift-triggered re-profile + replans
    stage_items: int = 0          # of `streams`: pipeline *stage* items
                                  # (demand models with ``emits_stages``)
    pooled_items: int = 0         # of `stage_items`: consolidated pool chunks
                                  # serving many cameras' crops
    preboots: int = 0             # demand items planned above current demand
                                  # at this tick's decision: capacity booting
                                  # *ahead* of a forecast ramp (sim/mpc.py);
                                  # 0 for every non-predictive policy
    forecast_rel_error: float = 0.0   # |forecast - realized| / realized total
                                      # demand for the forecast this tick's
                                      # plan rode on (0 when no forecaster)


class Ledger:
    """Append-only account of everything the simulation spent and served."""

    def __init__(self) -> None:
        self.records: list[TickRecord] = []
        self.instance_hours: dict[tuple[str, str, str], float] = {}

    def add_tick(self, rec: TickRecord,
                 hours: Mapping[tuple[str, str, str], float]) -> None:
        if abs(rec.frames_demanded
               - (rec.frames_analyzed + rec.frames_dropped)) \
                > 1e-6 * max(1.0, rec.frames_demanded):
            raise ValueError(
                f"frame conservation violated at t={rec.t}: "
                f"{rec.frames_demanded} demanded != {rec.frames_analyzed} "
                f"analyzed + {rec.frames_dropped} dropped")
        self.records.append(rec)
        for k, h in hours.items():
            self.instance_hours[k] = self.instance_hours.get(k, 0.0) + h

    # -- aggregates ----------------------------------------------------------

    @property
    def total_cost(self) -> float:
        return sum(r.cost for r in self.records)

    @property
    def frames_demanded(self) -> float:
        return sum(r.frames_demanded for r in self.records)

    @property
    def frames_analyzed(self) -> float:
        return sum(r.frames_analyzed for r in self.records)

    @property
    def frames_dropped(self) -> float:
        return sum(r.frames_dropped for r in self.records)

    @property
    def migrations(self) -> int:
        return sum(r.migrations for r in self.records)

    @property
    def preemptions(self) -> int:
        return sum(r.preemptions for r in self.records)

    @property
    def defrags(self) -> int:
        return sum(r.defrags for r in self.records)

    @property
    def cost_ondemand(self) -> float:
        return sum(r.cost_ondemand for r in self.records)

    @property
    def cost_spot(self) -> float:
        return sum(r.cost_spot for r in self.records)

    @property
    def outbids(self) -> int:
        return sum(r.outbids for r in self.records)

    @property
    def recalibrations(self) -> int:
        return sum(r.recalibrations for r in self.records)

    @property
    def calib_max_rel_error(self) -> float:
        return max((r.calib_rel_error for r in self.records), default=0.0)

    @property
    def stage_items_peak(self) -> int:
        """Most pipeline stage items demanded at any one decision point."""
        return max((r.stage_items for r in self.records), default=0)

    @property
    def pooled_items_peak(self) -> int:
        """Most consolidated pool chunks live at any one decision point."""
        return max((r.pooled_items for r in self.records), default=0)

    @property
    def preboots(self) -> int:
        """Total demand items planned ahead of current demand (MPC)."""
        return sum(r.preboots for r in self.records)

    @property
    def forecast_max_rel_error(self) -> float:
        return max((r.forecast_rel_error for r in self.records), default=0.0)

    def slo_attainment(self) -> float:
        """Fraction of demanded frames actually analyzed on time.

        Zero-demand convention: with no frames demanded the attainment is
        vacuously ``1.0`` — nothing was asked for, so nothing was missed.
        This deliberately differs from the serving engine's ``report()``,
        whose ``slo_attainment`` is ``None`` on an empty *completion*
        sample: an idle engine has no evidence of health, but a ledger tick
        with zero demand has positive evidence that nothing was dropped.
        """
        d = self.frames_demanded
        return (self.frames_analyzed / d) if d > 0 else 1.0

    def signature(self) -> tuple:
        """Canonical comparable form: every tick record (exact floats) plus
        the rounded totals. Two simulation runs are bit-identical iff their
        signatures are equal — shared by the parity tests and the
        scale_sweep CI gate."""
        return (tuple(self.records), self.totals())

    def totals(self) -> dict:
        """Deterministic summary (rounded to stable precision) — equal across
        two runs of the same seeded scenario."""
        return {
            "ticks": len(self.records),
            "total_cost": round(self.total_cost, 6),
            "cost_ondemand": round(self.cost_ondemand, 6),
            "cost_spot": round(self.cost_spot, 6),
            "frames_demanded": round(self.frames_demanded, 6),
            "frames_analyzed": round(self.frames_analyzed, 6),
            "frames_dropped": round(self.frames_dropped, 6),
            "slo_attainment": round(self.slo_attainment(), 6),
            "migrations": self.migrations,
            "preemptions": self.preemptions,
            "outbids": self.outbids,
            "defrags": self.defrags,
            "recalibrations": self.recalibrations,
            "calib_max_rel_error": round(self.calib_max_rel_error, 6),
            "stage_items_peak": self.stage_items_peak,
            "pooled_items_peak": self.pooled_items_peak,
            "preboots": self.preboots,
            "forecast_max_rel_error": round(self.forecast_max_rel_error, 6),
            "instance_hours": {"/".join(k): round(v, 6)
                               for k, v in sorted(self.instance_hours.items())},
        }

"""Per-region live drift and per-group recalibration.

The loop of :mod:`~repro_torch.obs.recalibrate` is fleet-wide: one
detector over one probe, and a firing re-profiles and replans the *entire*
fleet. Jain et al.'s large-deployment argument (PAPERS.md) says drift is
regional — a codec rollout hits one city's cameras, a noisy neighbor one
zone's engines — so this module splits every stage of the loop by stream
group:

* **probe** — :class:`WindowedServiceProbe` adapts the simulator's ground
  truth into the *live* delta-export semantics of
  ``ContinuousBatchingEngine.windowed_rates()`` (time-averaged tokens/s
  since the previous poll), and :class:`EngineWindowProbe` is the
  real-deployment bridge: one serving engine per region, their
  ``windowed_rates()`` merged into a single measurement with the region
  remembered per stream.
* **detect** — :class:`RegionalDriftDetector` runs one
  :class:`~repro_torch.obs.drift.DriftDetector` streak per group, so a regression
  in one region fires only that region's detector; a healthy region's
  streak is never polluted (nor masked) by a drifting neighbor.
* **recalibrate** — :class:`RegionalRecalibratingPolicy` re-profiles *only
  the fired groups'* streams, merges the partial measurement into the
  active :class:`~repro_torch.sim.ledger.ServiceCalibration`, and forces a
  min-migration repair **scoped to the affected bins** (see
  ``core/repair.py``'s ``scope``) — the healthy regions' placements are
  never consolidation fodder and the defrag escape hatch (a global
  reshuffle) is out of scope for a partial recalibration.

``chip_smoke.py``'s observability phase checks the outcome on the
``regional_drift`` scenario: per-group recalibration matches or beats
fleet-wide recalibration on cost with strictly fewer migrations, and only
the drifted region's detector fires.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, Mapping, Optional, Sequence

from repro_torch.obs.drift import DriftConfig, DriftDetector, DriftVerdict
from repro_torch.obs.metrics import TelemetryHub
from repro_torch.obs.recalibrate import RecalibratingPolicy
from repro_torch.obs.trace import Tracer
from repro_torch.sim.ledger import ServiceCalibration

GroupFn = Callable[[str], str]


# ---------------------------------------------------------------------------
# Probes: the live windowed_rates() feed
# ---------------------------------------------------------------------------


class WindowedServiceProbe:
    """``windowed_rates()``-shaped probe over a ground-truth service.

    Wraps an :class:`~repro_torch.obs.probe.DriftingService` and reports, per
    poll, each stream's *time-averaged* tokens/s since the previous poll —
    exactly the delta-export semantics of a live engine's
    ``windowed_rates()``, rather than the instantaneous snapshot of the
    exact probe. A mid-window regression therefore appears at its
    time-weighted magnitude first and at full magnitude one poll later,
    which is what a real deployment's detector sees. The first poll (no
    window yet) reports the instantaneous rates.
    """

    def __init__(self, service) -> None:
        self.service = service
        self._last_poll: Optional[float] = None

    @property
    def tokens_per_frame(self) -> float:
        return self.service.tokens_per_frame

    def initial_calibration(self) -> ServiceCalibration:
        return self.service.initial_calibration()

    def measure(self, t: float) -> dict[str, float]:
        t0, self._last_poll = self._last_poll, t
        if t0 is None or t <= t0:
            return self.service.rates_at(t)
        return self.service.mean_rates(t0, t)


class EngineWindowProbe:
    """The real-deployment bridge: per-region serving engines, one probe.

    ``engines`` maps a region (group) name to anything exposing
    ``windowed_rates()`` and ``measured_rates()`` — a
    :class:`~repro_torch.serving.engine.ContinuousBatchingEngine` per region.
    ``measure(t)`` merges every engine's delta export into one
    ``{stream_id: tokens/s}`` measurement, remembering which region served
    each stream; ``group_of`` is then the grouping function a
    :class:`RegionalDriftDetector` partitions by. Streams idle in every
    engine this window are simply absent — no data, not zero throughput —
    so the per-group detectors treat silence as no evidence.
    """

    def __init__(self, engines: Mapping[str, object], *,
                 tokens_per_frame: float = 8.0) -> None:
        self.engines = dict(engines)
        self.tokens_per_frame = tokens_per_frame
        self._region_of: dict[str, str] = {}

    def measure(self, t: float) -> dict[str, float]:
        merged: dict[str, float] = {}
        for region in sorted(self.engines):
            for sid, rate in self.engines[region].windowed_rates().items():
                merged[sid] = rate
                self._region_of[sid] = region
        return merged

    def group_of(self, stream_id: str) -> str:
        return self._region_of.get(stream_id, "unknown")

    def initial_calibration(self) -> ServiceCalibration:
        """Startup profile from every engine's lifetime ``measured_rates()``
        (profile-once, the belief a non-recalibrating policy keeps)."""
        rates: dict[str, float] = {}
        for region in sorted(self.engines):
            for sid, rate in self.engines[region].measured_rates().items():
                rates[sid] = rate
                self._region_of[sid] = region
        default = (sum(rates.values()) / len(rates)) if rates else None
        return ServiceCalibration(tokens_per_frame=self.tokens_per_frame,
                                  rates_tokens_per_s=rates,
                                  default_rate=default)


# ---------------------------------------------------------------------------
# Per-group detection
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RegionalVerdict:
    """One observation window, partitioned by group.

    ``verdicts`` holds each group's own :class:`DriftVerdict` (independent
    streaks); ``fired_groups`` the groups whose streak reached the hold this
    window. The aggregate fields (``rel_error`` is the stream-weighted mean
    over groups with data) make the verdict a drop-in for the fleet-wide
    one where a single number is expected (ledger column, telemetry)."""

    t: float
    verdicts: Mapping[str, DriftVerdict]
    fired_groups: tuple[str, ...]
    rel_error: float
    max_rel_error: float
    n_streams: int

    @property
    def fired(self) -> bool:
        return bool(self.fired_groups)

    @property
    def drifting(self) -> bool:
        return any(v.drifting for v in self.verdicts.values())

    @property
    def streak(self) -> int:
        return max((v.streak for v in self.verdicts.values()), default=0)


class RegionalDriftDetector:
    """One independent drift streak per stream group (region).

    ``group_of`` maps a stream id to its group; measurements are partitioned
    by it and each partition feeds that group's own
    :class:`DriftDetector` — a regression in one region can neither fire a
    healthy region's detector nor be diluted below threshold by the healthy
    regions' zero error (the failure mode of a fleet-wide mean). Groups may
    be declared up front (``groups=...``) or discovered from measurements.
    """

    def __init__(self, group_of: GroupFn,
                 config: DriftConfig = DriftConfig(), *,
                 groups: Iterable[str] = ()) -> None:
        self.group_of = group_of
        self.config = config
        self.detectors: dict[str, DriftDetector] = {
            g: DriftDetector(config) for g in groups}
        self.history: list[RegionalVerdict] = []
        self.firings: list[tuple[float, str]] = []   # (t, group), in order

    def detector(self, group: str) -> DriftDetector:
        if group not in self.detectors:
            self.detectors[group] = DriftDetector(self.config)
        return self.detectors[group]

    def observe(self, t: float, measured: Mapping[str, float],
                calibration) -> RegionalVerdict:
        partitions: dict[str, dict[str, float]] = {}
        for sid in sorted(measured):
            partitions.setdefault(self.group_of(sid), {})[sid] = measured[sid]
        verdicts: dict[str, DriftVerdict] = {}
        fired: list[str] = []
        for group in sorted(set(self.detectors) | set(partitions)):
            # a group with no data this window still observes {}: no
            # evidence, streak preserved (same convention as fleet-wide)
            v = self.detector(group).observe(t, partitions.get(group, {}),
                                             calibration)
            verdicts[group] = v
            if v.fired:
                fired.append(group)
                self.firings.append((t, group))
        n = sum(v.n_streams for v in verdicts.values())
        rel = (sum(v.rel_error * v.n_streams for v in verdicts.values()) / n
               if n else 0.0)
        verdict = RegionalVerdict(
            t=t, verdicts=verdicts, fired_groups=tuple(fired),
            rel_error=rel,
            max_rel_error=max((v.max_rel_error for v in verdicts.values()),
                              default=0.0),
            n_streams=n)
        self.history.append(verdict)
        return verdict

    def reset(self, group: Optional[str] = None) -> None:
        """Forget the streak of one group (after its partial recalibration)
        or of every group (``group=None``)."""
        if group is None:
            for det in self.detectors.values():
                det.reset()
        elif group in self.detectors:
            self.detectors[group].reset()

    def fired_groups(self) -> tuple[str, ...]:
        """Every group that has ever fired, in first-firing order."""
        seen: list[str] = []
        for _, g in self.firings:
            if g not in seen:
                seen.append(g)
        return tuple(seen)


# ---------------------------------------------------------------------------
# Per-group recalibration
# ---------------------------------------------------------------------------


class RegionalRecalibratingPolicy(RecalibratingPolicy):
    """Drift-aware policy wrapper with per-group scope (module doc above).

    Differences from the fleet-wide :class:`RecalibratingPolicy`:

    * the measurement source defaults to a :class:`WindowedServiceProbe`
      over ``service`` — the live ``windowed_rates()`` semantics — and any
      object with ``measure(t)`` (e.g. an :class:`EngineWindowProbe` over
      real per-region engines) can be passed as ``probe``;
    * detection runs a :class:`RegionalDriftDetector`, so only the drifted
      group's streak fires;
    * a firing re-profiles *only the fired groups' streams*, merging the
      partial measurement into the active calibration (healthy groups keep
      their profile untouched), and the forced replan is a min-migration
      repair **scoped to the affected bins** via
      ``AdaptiveManager.flag_recalibration(scope=...)``.
    """

    def __init__(self, inner, service, *, group_of: GroupFn,
                 config: DriftConfig = DriftConfig(),
                 detector: Optional[RegionalDriftDetector] = None,
                 probe=None,
                 telemetry: Optional[TelemetryHub] = None,
                 tracer: Optional[Tracer] = None,
                 calibration: Optional[ServiceCalibration] = None,
                 groups: Iterable[str] = ()) -> None:
        probe = probe if probe is not None else WindowedServiceProbe(service)
        super().__init__(inner, service, detector=DriftDetector(config),
                         telemetry=telemetry, tracer=tracer,
                         calibration=calibration, probe=probe)
        self.name = f"regional-recal-{inner.name}"
        self.group_of = group_of
        self.regional = (detector if detector is not None
                         else RegionalDriftDetector(group_of, config,
                                                    groups=groups))
        # (t, fired groups) per recalibration — the benchmark's scoping gate
        self.recal_groups: list[tuple[float, tuple[str, ...]]] = []

    # -- the per-group loop --------------------------------------------------

    def _recalibrate_groups(self, t: float, measured: Mapping[str, float],
                            groups: Sequence[str]) -> frozenset[str]:
        """Partial re-profile: adopt the measured rates of the fired groups'
        streams only, merged into the active calibration. Returns the
        re-profiled stream ids (the repair scope)."""
        fired = set(groups)
        scoped = frozenset(sid for sid in measured
                           if self.group_of(sid) in fired)
        rates = dict(self.calibration.rates_tokens_per_s)
        for sid in scoped:
            rates[sid] = measured[sid]
        default = (sum(rates.values()) / len(rates)) if rates else None
        self.calibration = ServiceCalibration(
            tokens_per_frame=self.service.tokens_per_frame,
            rates_tokens_per_s=rates, default_rate=default)
        for g in groups:
            self.regional.reset(g)
        self.recalibrations.append(t)
        self.recal_groups.append((t, tuple(sorted(groups))))
        if self.adaptive is not None:
            self.adaptive.flag_recalibration(scope=scoped)
        return scoped

    def decide(self, t: float, streams, *, preempted: bool = False):
        measured = self.probe.measure(t)
        verdict = self.regional.observe(t, measured, self.calibration)
        self.last_drift = verdict
        self.telemetry.emit(t, "drift.rel_error", verdict.rel_error)
        for group, v in sorted(verdict.verdicts.items()):
            self.telemetry.emit(t, "drift.rel_error", v.rel_error,
                                region=group)
            self.telemetry.emit(t, "drift.streak", v.streak, region=group)

        recalibrated = False
        if verdict.fired_groups:
            with self.tracer.span(
                    "recalibrate", t=t,
                    regions=",".join(verdict.fired_groups),
                    rel_error=round(verdict.rel_error, 6)) as sp:
                scoped = self._recalibrate_groups(t, measured,
                                                 verdict.fired_groups)
                recalibrated = True
                sp.attrs["scoped_streams"] = len(scoped)
                self.telemetry.emit(t, "drift.recalibrations",
                                    len(self.recalibrations),
                                    regions=",".join(verdict.fired_groups))
                plan = self._decide_inner(t, streams,
                                          preempted=preempted, force=True)
                sp.attrs["plan_cost_usd_per_h"] = round(plan.hourly_cost, 6)
        if not recalibrated:
            plan = self._decide_inner(t, streams, preempted=preempted)
        self.telemetry.emit(t, "plan.cost.usd_per_h", plan.hourly_cost)
        return plan


def camera_region_groups(streams_or_specs, *,
                         regions=None) -> dict[str, str]:
    """stream_id -> nearest datacenter region, from each stream's camera.

    Convenience for building scenario group maps: anything with
    ``stream_id`` and ``camera`` attributes works (``Stream``,
    ``CameraSpec``)."""
    from repro_torch.core import geo
    regions = list(regions) if regions is not None \
        else sorted(geo.DATACENTERS)
    out: dict[str, str] = {}
    for s in streams_or_specs:
        cam = getattr(s, "camera", None)
        out[s.stream_id] = (geo.nearest_region(cam, regions)
                            if cam is not None else "unknown")
    return out

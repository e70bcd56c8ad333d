"""Scenario library: ready-to-run fleet days.

Each scenario bundles a demand model, a simulation config, and the catalog
to plan against. ``SCENARIOS`` maps names to zero-argument factories so
benchmarks and tests can run them by name; every factory takes optional
overrides (stream count, duration, seed) for scaling studies.

* ``steady``            — flat demand; sanity floor (adaptive ≈ static).
* ``rush_hour``         — US cameras, synchronized morning/evening peaks
                          (the paper's Fig. 5 shape at fleet scale).
* ``follow_the_sun``    — worldwide cameras, the same local curve: peaks
                          rotate around the globe; night cameras shift a
                          fraction of the fleet to a cheaper program.
* ``spot_heavy``        — rush hour with most capacity on the spot market:
                          cheap, but preemptions keep replaying streams.
* ``flash_crowd``       — steady fleet with Poisson camera churn and an
                          8x two-hour demand spike on European cameras.
* ``churn_storm``       — rush hour with Poisson camera churn *and* most
                          capacity on spot: every forced-replan source at
                          once (arrivals, departures, preemptions) — the
                          stress test for min-migration repair planning.
* ``drifting_scene``    — rush hour whose *serving capacity* regresses
                          mid-day (``service`` carries the ground truth, an
                          ``obs.DriftingService``): the drift-detection /
                          online-recalibration scenario.
* ``regional_drift``    — three-region fleet, the regression confined to
                          one region (``groups`` maps streams to regions):
                          the per-region drift / per-group recalibration
                          scenario.
* ``roi_day``           — content-aware pipelines: cameras capture at a
                          fixed rate, scene *density* swings sparse-night /
                          dense-rush, and downstream heavy stages activate
                          with it — the endogenous-demand scenario.
* ``consolidated_city`` — the consolidation gate: many co-located cameras
                          whose crop stages pool onto shared GPU workers
                          (``consolidate=True``); run with
                          ``consolidate=False`` for the unpooled arm.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, Optional, Sequence

import numpy as np

from repro_torch.core import geo
from repro_torch.core.catalog import Catalog, fig6_catalog
from repro_torch.core.workload import PROGRAMS
from repro_torch.sim.demand import (CameraSpec, DemandModel, DiurnalFleet,
                              FlashCrowd, MixShift, PipelineCameraSpec,
                              PipelineFleet, PoissonChurn, columnar_fleet,
                              peak_streams)
from repro_torch.sim.fleet import SimConfig

US_CAMERAS = ("nyc", "chicago", "la", "seattle")
EU_CAMERAS = ("london", "paris", "berlin")
ALL_CAMERAS = tuple(sorted(geo.CAMERAS))


@dataclasses.dataclass(frozen=True)
class Scenario:
    """A ready-to-run fleet day: demand model + sim config + catalog.

    Factories in :data:`SCENARIOS` build these by name with optional
    overrides (``n_streams``, ``duration_h`` in simulated hours, ``seed``);
    see docs/simulator.md for what each scenario stresses.
    """

    name: str
    demand: DemandModel
    config: SimConfig
    catalog_factory: Callable[[], Catalog] = fig6_catalog
    description: str = ""
    # ground-truth serving capacity (obs.DriftingService) for scenarios
    # whose service rates change over the day; None = unconstrained
    service: Optional[object] = None
    # stream_id -> group (region) for per-group drift detection
    # (obs.regional); None = no grouping defined
    groups: Optional[dict] = None

    def catalog(self) -> Catalog:
        return self.catalog_factory()

    def peak_streams(self, step_h: float = 0.5):
        """Peak demand over the horizon — the static baseline's plan input."""
        return peak_streams(self.demand, self.config.duration_h, step_h)


def _fleet(cameras: Sequence[str], n_streams: int, *, zf_peak: float = 6.0,
           zf_base: float = 0.2, vgg_every: int = 4) -> tuple[CameraSpec, ...]:
    """n_streams specs round-robined over cameras; every ``vgg_every``-th
    stream runs VGG16 at low rates (its CPU/GPU profiles top out ~2 fps),
    the rest run ZF with the full rush-hour swing."""
    specs = []
    cams = itertools.cycle(cameras)
    for i in range(n_streams):
        cam = next(cams)
        if vgg_every and i % vgg_every == vgg_every - 1:
            specs.append(CameraSpec(f"vgg-{cam}-{i}", cam, "VGG16",
                                    base_fps=0.1, peak_fps=1.5))
        else:
            specs.append(CameraSpec(f"zf-{cam}-{i}", cam, "ZF",
                                    base_fps=zf_base, peak_fps=zf_peak))
    return tuple(specs)


def steady(n_streams: int = 36, duration_h: float = 24.0,
           seed: int = 0) -> Scenario:
    specs = tuple(dataclasses.replace(c, peak_fps=c.base_fps)
                  for c in _fleet(ALL_CAMERAS, n_streams,
                                  zf_base=1.0, zf_peak=1.0))
    return Scenario(
        name="steady",
        demand=DiurnalFleet(specs),
        config=SimConfig(duration_h=duration_h, seed=seed),
        description="flat demand worldwide; adaptive should match static")


def rush_hour(n_streams: int = 108, duration_h: float = 24.0,
              seed: int = 0) -> Scenario:
    return Scenario(
        name="rush_hour",
        demand=DiurnalFleet(_fleet(US_CAMERAS, n_streams)),
        config=SimConfig(duration_h=duration_h, seed=seed),
        description="US fleet, synchronized diurnal peaks (paper Fig. 5)")


def follow_the_sun(n_streams: int = 108, duration_h: float = 24.0,
                   seed: int = 0) -> Scenario:
    demand = MixShift(DiurnalFleet(_fleet(ALL_CAMERAS, n_streams)),
                      night_program="VGG16", fraction=0.3)
    return Scenario(
        name="follow_the_sun",
        demand=demand,
        config=SimConfig(duration_h=duration_h, seed=seed),
        description="worldwide fleet; peaks rotate with local rush hours, "
                    "night cameras shift program mix")


def spot_heavy(n_streams: int = 108, duration_h: float = 24.0,
               seed: int = 0) -> Scenario:
    return Scenario(
        name="spot_heavy",
        demand=DiurnalFleet(_fleet(US_CAMERAS, n_streams)),
        config=SimConfig(duration_h=duration_h, seed=seed,
                         spot_fraction=0.85, preempt_hazard_per_h=0.12),
        description="rush hour mostly on spot: cheaper instance-hours, "
                    "preemptions replayed through replanning")


def flash_crowd(n_streams: int = 36, duration_h: float = 24.0,
                seed: int = 0) -> Scenario:
    base = DiurnalFleet(tuple(
        dataclasses.replace(c, peak_fps=max(c.base_fps, c.peak_fps / 3))
        for c in _fleet(ALL_CAMERAS, n_streams, zf_base=0.5)))
    churned = PoissonChurn(base, templates=_fleet(ALL_CAMERAS, 8,
                                                  zf_base=0.3, zf_peak=2.0),
                           rate_per_h=0.5, mean_lifetime_h=6.0,
                           horizon_h=duration_h, seed=seed + 7)
    demand = FlashCrowd(churned, start_h=12.0, duration_h=2.0,
                        multiplier=8.0, cameras=frozenset(EU_CAMERAS))
    return Scenario(
        name="flash_crowd",
        demand=demand,
        config=SimConfig(duration_h=duration_h, dt_h=0.5, seed=seed),
        description="camera churn plus an 8x two-hour European demand spike")


def churn_storm(n_streams: int = 72, duration_h: float = 24.0,
                seed: int = 0) -> Scenario:
    base = DiurnalFleet(_fleet(US_CAMERAS, n_streams, zf_peak=4.0))
    churned = PoissonChurn(base, templates=_fleet(US_CAMERAS, 12,
                                                  zf_base=0.3, zf_peak=2.0),
                           rate_per_h=1.0, mean_lifetime_h=4.0,
                           horizon_h=duration_h, seed=seed + 13)
    return Scenario(
        name="churn_storm",
        demand=churned,
        config=SimConfig(duration_h=duration_h, seed=seed,
                         spot_fraction=0.6, preempt_hazard_per_h=0.10),
        description="camera churn + spot preemptions: every forced-replan "
                    "source at once (min-migration stress test)")


def drifting_scene(n_streams: int = 72, duration_h: float = 24.0,
                   seed: int = 0, shift_at_h: float = 12.0,
                   shift_factor: float = 0.35) -> Scenario:
    """Rush-hour demand whose *serving* capacity regresses mid-day.

    The ground truth is an :class:`~repro_torch.obs.DriftingService`: every stream
    starts comfortably above its demanded rate (ZF sustains 8 frames/s, VGG
    2.8 against demand peaks of 6 and 1.5), then at ``shift_at_h`` a
    fleet-wide regression multiplies the true rates by ``shift_factor`` —
    after it, a ZF stream can only sustain 2.8 frames/s against a 6 frames/s
    peak. A policy packing from the startup profile keeps paying for
    capacity the service can no longer use; online recalibration
    (``obs.RecalibratingPolicy``) detects the drift, re-profiles, and
    re-packs to the measured rates. ``benchmarks/drift_recalibration.py``
    gates detection latency and the resulting cost savings.
    """
    # lazy import: obs depends on sim.ledger, so importing it at module
    # scope would cycle through sim/__init__ -> scenarios -> obs -> sim
    from repro_torch.obs import DriftingService, RateShift
    specs = _fleet(US_CAMERAS, n_streams)
    tokens_per_frame = 8.0
    base_rates = {c.stream_id: (22.4 if c.program == "VGG16" else 64.0)
                  for c in specs}
    service = DriftingService(base_rates,
                              tokens_per_frame=tokens_per_frame,
                              shifts=(RateShift(at_h=shift_at_h,
                                                factor=shift_factor),))
    return Scenario(
        name="drifting_scene",
        demand=DiurnalFleet(specs),
        config=SimConfig(duration_h=duration_h, seed=seed,
                         spot_fraction=0.0),
        description="rush-hour fleet whose true serving rates regress 65% "
                    "at mid-day: the drift-detection / online-recalibration "
                    "scenario",
        service=service)


def regional_drift(n_streams: int = 96, duration_h: float = 24.0,
                   seed: int = 0, shift_at_h: float = 12.0,
                   shift_factor: float = 0.2,
                   drifted_camera: str = "tokyo") -> Scenario:
    """Three-region fleet; the serving regression hits *one* region.

    Cameras round-robin over nyc / london / tokyo, which map to three
    distinct datacenter regions (us-east-1, eu-west-1, ap-northeast-1) —
    the scenario's ``groups`` field carries that stream → region map. At
    ``shift_at_h`` the true rates of the ``drifted_camera`` region's
    streams are multiplied by ``shift_factor``; the other two regions stay
    healthy. A per-region detector (``obs.RegionalDriftDetector``) should
    fire in exactly one region and a per-group recalibration re-profile
    only that third of the fleet; a fleet-wide detector sees the same
    regression diluted across all streams (mean error ≈ 0.27 with the
    defaults — still above the 0.25 threshold, so both designs fire and
    ``benchmarks/obs_export.py`` can compare their repairs head-to-head).

    Demand is deliberately *flat* (unlike ``drifting_scene``): with no
    diurnal churn, every migration in the ledger traces to the
    recalibration replan itself, so the benchmark's migration comparison
    measures the repair scope and nothing else.
    """
    from repro_torch.obs import DriftingService, RateShift
    cameras = ("nyc", "london", drifted_camera)
    specs = tuple(dataclasses.replace(c, base_fps=c.peak_fps)
                  for c in _fleet(cameras, n_streams))
    tokens_per_frame = 8.0
    base_rates = {c.stream_id: (22.4 if c.program == "VGG16" else 64.0)
                  for c in specs}
    groups = {c.stream_id: geo.nearest_region(c.camera, sorted(geo.DATACENTERS))
              for c in specs}
    drifted_region = geo.nearest_region(drifted_camera,
                                        sorted(geo.DATACENTERS))
    drifted = frozenset(sid for sid, g in groups.items()
                        if g == drifted_region)
    service = DriftingService(base_rates,
                              tokens_per_frame=tokens_per_frame,
                              shifts=(RateShift(at_h=shift_at_h,
                                                factor=shift_factor,
                                                streams=drifted),))
    return Scenario(
        name="regional_drift",
        demand=DiurnalFleet(specs),
        config=SimConfig(duration_h=duration_h, seed=seed,
                         spot_fraction=0.0),
        description="three-region fleet; one region's true serving rates "
                    "regress 80% at mid-day — the per-region drift / "
                    "per-group recalibration scenario",
        service=service,
        groups=groups)


def _pipeline_fleet(cameras: Sequence[str], n_streams: int, *,
                    fps: float = 2.0, plate_every: int = 3,
                    base_density: float = 0.05,
                    peak_density: float = 1.0
                    ) -> tuple[PipelineCameraSpec, ...]:
    """n_streams pipeline cameras round-robined over ``cameras``, capturing
    ``fps`` frames/s around the clock; every ``plate_every``-th runs the
    three-stage ``roi_plate`` pipeline, the rest two-stage ``roi_vehicle``.
    Scene density swings ``base_density`` -> ``peak_density`` diurnally."""
    specs = []
    cams = itertools.cycle(cameras)
    for i in range(n_streams):
        cam = next(cams)
        if plate_every and i % plate_every == plate_every - 1:
            specs.append(PipelineCameraSpec(
                f"plate-{cam}-{i}", cam, "roi_plate", fps=fps,
                base_density=base_density, peak_density=peak_density))
        else:
            specs.append(PipelineCameraSpec(
                f"veh-{cam}-{i}", cam, "roi_vehicle", fps=fps,
                base_density=base_density, peak_density=peak_density))
    return tuple(specs)


def roi_day(n_streams: int = 96, duration_h: float = 24.0,
            seed: int = 0) -> Scenario:
    """Content-aware pipelines over a US day: endogenous demand.

    Cameras capture at a constant 2 frames/s; what swings diurnally is the
    *scene density* (0.05 at night, 1.0 at rush hour), which drives the
    activation of the downstream crop stages — the detector watches every
    frame around the clock, the heavy classify/track/ocr stages fire almost
    never at 3am and on every candidate at 8:30. The planner sees one item
    per stage (``sid::stage``), so a scene getting busy IS a demand spike
    without any frame-rate knob turning."""
    return Scenario(
        name="roi_day",
        demand=PipelineFleet(_pipeline_fleet(US_CAMERAS, n_streams)),
        config=SimConfig(duration_h=duration_h, seed=seed),
        description="US pipeline fleet at fixed capture rate; scene density "
                    "swings sparse-night/dense-rush and heavy stages "
                    "activate with it (endogenous demand)")


def consolidated_city(n_streams: int = 120, duration_h: float = 24.0,
                      seed: int = 0, consolidate: bool = True) -> Scenario:
    """The crop-consolidation gate: one metro area, many co-located cameras.

    All cameras sit in four US cities (~30 per city) running ``roi_vehicle``;
    with ``consolidate=True`` each city's VGG16 crop-classify stages pool
    onto shared GPU workers (``pool::roi_vehicle.classify@nyc#k``) — one
    model load serves every camera's crops, capped at the stage's pooled
    frame-rate ceiling. The ``consolidate=False`` arm packs the same demand
    as per-camera stage items; ``benchmarks/pipeline_consolidation.py``
    gates the saving between the two arms."""
    return Scenario(
        name="consolidated_city",
        demand=PipelineFleet(
            _pipeline_fleet(US_CAMERAS, n_streams, plate_every=0),
            consolidate=consolidate),
        config=SimConfig(duration_h=duration_h, seed=seed),
        description="co-located pipeline cameras; crop-classify stages "
                    "consolidated onto shared GPU workers (on/off arms)")


def _replicated(specs: Sequence[CameraSpec], replicas: int = 2
                ) -> tuple[CameraSpec, ...]:
    """Each camera spec split into ``replicas`` load-sharing replicas
    (``sid#0``, ``sid#1``, ... at 1/replicas of the rate). Replica groups
    are what the mixed planner's anti-affinity rule keeps off any single
    spot market — one region's reclaim can only take one replica down."""
    out = []
    for c in specs:
        for k in range(replicas):
            out.append(dataclasses.replace(
                c, stream_id=f"{c.stream_id}#{k}",
                base_fps=round(c.base_fps / replicas, 6),
                peak_fps=round(c.peak_fps / replicas, 6)))
    return tuple(out)


def spot_bidder(n_streams: int = 108, duration_h: float = 24.0,
                seed: int = 0) -> Scenario:
    """Rush-hour demand served by 2x replicated streams with *no* random
    spot boots (``spot_fraction=0``): all spot capacity comes from a
    bidding policy's mixed plans, reclaimed exactly when the price walk
    rises above a bid. The scenario for ``SpotBidPolicy`` +
    ``benchmarks/spot_bidding.py`` — with a plain policy it runs fully
    on-demand (the cost baseline)."""
    base = _fleet(US_CAMERAS, max(1, n_streams // 2))
    return Scenario(
        name="spot_bidder",
        demand=DiurnalFleet(_replicated(base, replicas=2)),
        config=SimConfig(duration_h=duration_h, seed=seed,
                         spot_fraction=0.0),
        description="replicated rush-hour fleet; spot capacity only via "
                    "bids against the price walk (anti-affinity keeps a "
                    "stream's replicas off any one spot market)")


def mega_city(n_streams: int = 10_000, duration_h: float = 24.0,
              seed: int = 0) -> Scenario:
    """Fleet-scale stress test: 10k cameras worldwide (the 12 cities map to
    all 9 catalog regions), diurnal curves in local time, a night-time
    program-mix shift, and a 4x evening flash crowd on the European cameras
    landing on top of their rush-hour peak. Runs entirely on the vectorized
    demand + packed-planner path; ``benchmarks/scale_sweep.py`` gates its
    24 h wall-clock and its parity against the scalar planner."""
    base = DiurnalFleet(_fleet(ALL_CAMERAS, n_streams,
                               zf_base=0.2, zf_peak=2.5, vgg_every=3))
    shifted = MixShift(base, night_program="VGG16", fraction=0.25)
    demand = FlashCrowd(shifted, start_h=17.0, duration_h=2.0,
                        multiplier=4.0, cameras=frozenset(EU_CAMERAS),
                        cap_fps=8.0)
    return Scenario(
        name="mega_city",
        demand=demand,
        config=SimConfig(duration_h=duration_h, seed=seed),
        description="10k streams, 9 regions: diurnal + night mix shift + "
                    "4x EU evening flash crowd (vectorized-path stress test)")


def continent_scale(n_streams: int = 1_000_000, duration_h: float = 24.0,
                    seed: int = 0) -> Scenario:
    """Million-stream day: the columnar-path scale gate.

    The same fleet shape as ``_fleet(ALL_CAMERAS, n)`` — cameras round-robin
    over the 12 cities, every 4th stream runs VGG16 at low rates, the rest
    ZF with a modest swing — but built straight from numpy columns via
    :func:`~repro_torch.sim.demand.columnar_fleet`, so constructing the scenario
    never allocates a ``CameraSpec`` (or ``Stream``) per camera. Demand is
    pure diurnal (no churn/flash wrappers) and fully on-demand
    (``spot_fraction=0``), so the stable-id fast paths carry every tick:
    ``benchmarks/columnar_sweep.py`` gates the 24 h x 1M wall-clock and the
    columnar-vs-object ledger parity at smaller sizes of the same shape."""
    cams = ALL_CAMERAS
    nc = len(cams)
    idx = np.arange(n_streams, dtype=np.int64)
    cam_codes = idx % nc
    vgg = (idx % 4) == 3
    ids = [(f"vgg-{cams[i % nc]}-{i}" if i % 4 == 3
            else f"zf-{cams[i % nc]}-{i}") for i in range(n_streams)]
    demand = columnar_fleet(
        ids,
        utc_offset_h=np.array([geo.utc_offset_hours(c)
                               for c in cams])[cam_codes],
        base_fps=np.where(vgg, 0.1, 0.2),
        peak_fps=np.where(vgg, 1.5, 2.5),
        program_codes=vgg.astype(np.int64),
        programs_unique=(PROGRAMS["ZF"], PROGRAMS["VGG16"]),
        camera_codes=cam_codes,
        cameras_unique=cams)
    return Scenario(
        name="continent_scale",
        demand=demand,
        config=SimConfig(duration_h=duration_h, dt_h=1.0, seed=seed,
                         spot_fraction=0.0),
        description="1M streams, 12 cities, pure diurnal on-demand day: "
                    "the columnar fleet-state scale gate")


SCENARIOS: dict[str, Callable[..., Scenario]] = {
    "steady": steady,
    "rush_hour": rush_hour,
    "follow_the_sun": follow_the_sun,
    "spot_heavy": spot_heavy,
    "flash_crowd": flash_crowd,
    "churn_storm": churn_storm,
    "drifting_scene": drifting_scene,
    "regional_drift": regional_drift,
    "roi_day": roi_day,
    "consolidated_city": consolidated_city,
    "mega_city": mega_city,
    "spot_bidder": spot_bidder,
    "continent_scale": continent_scale,
}

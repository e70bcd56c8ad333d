"""Trace-driven fleet simulator (BEYOND-PAPER).

Drives the paper's planning/adaptive machinery end-to-end over simulated
days: diurnal demand per camera region (``demand``), a discrete-event loop
with instance boot delays, spot-price walks and preemptions (``events`` +
``cluster``), autoscaling policies over ``AdaptiveManager`` (``autoscaler``),
per-tick cost/SLO accounting calibrated from serving measurements
(``ledger``), and a scenario library (``scenarios``). See DESIGN.md.
"""
from repro_torch.sim.autoscaler import (PredictiveEWMAPolicy, ReactivePolicy,
                                  RepairPolicy, ScheduledPolicy,
                                  StaticPeakPolicy)
from repro_torch.sim.bidding import (FixedMarginBid, LookaheadBid, PercentileBid,
                               SpotBidPolicy, compute_bids)
from repro_torch.sim.cluster import Cluster, SimInstance, SpotMarket
from repro_torch.sim.demand import (CameraSpec, DiurnalFleet, FlashCrowd, MixShift,
                              PipelineCameraSpec, PipelineFleet, PoissonChurn,
                              peak_streams, rush_hour_fps)
from repro_torch.sim.events import Event, EventQueue
from repro_torch.sim.fleet import FleetSimulator, SimConfig
from repro_torch.sim.forecast import SeasonalForecaster
from repro_torch.sim.ledger import Ledger, ServiceCalibration, TickRecord
from repro_torch.sim.mpc import MPCConfig, MPCPolicy
from repro_torch.sim.scenarios import SCENARIOS, Scenario

__all__ = [
    "CameraSpec", "Cluster", "DiurnalFleet", "Event", "EventQueue",
    "FixedMarginBid", "FlashCrowd", "FleetSimulator", "Ledger",
    "LookaheadBid", "MPCConfig", "MPCPolicy", "MixShift", "PercentileBid",
    "PipelineCameraSpec", "PipelineFleet", "PoissonChurn",
    "PredictiveEWMAPolicy", "ReactivePolicy", "RepairPolicy", "SCENARIOS",
    "Scenario", "ScheduledPolicy", "SeasonalForecaster",
    "ServiceCalibration", "SimConfig",
    "SimInstance", "SpotBidPolicy", "SpotMarket", "StaticPeakPolicy",
    "TickRecord", "compute_bids", "peak_streams", "rush_hour_fps",
]

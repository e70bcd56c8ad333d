"""Model-predictive autoscaling over seasonal forecasts (BEYOND-PAPER).

:class:`MPCPolicy` supersedes the reactive/trend policies: every tick it
rolls a :class:`~repro_torch.sim.forecast.SeasonalForecaster` ahead of the boot
window and plans for the *envelope* — the elementwise max of current
demand and the forecast over the next ``lead_h`` hours — so capacity for a
ramp is already serving when the ramp lands, instead of dropping frames
for a boot-delay's worth of demand first.

The knobs the paper's operator would tune by hand are co-optimized from
the forecast itself, on a slow cadence (``reoptimize_every_h``):

* **boot lead** — for each candidate lead the policy simulates the next
  ``horizon_h`` hours of envelope plans (priced by the *existing*
  ``manager.plan``/packed machinery on forecast columns — no new solver),
  scores forecast dollars against a boot-window drop proxy, and keeps the
  cheapest lead meeting the SLO floor;
* **replan cadence** — from the same plan-cost series, holding capacity
  at the running window max and charging a fixed disruption cost per
  voluntary replan;
* **bid level** (spot mode) — the :class:`~repro_torch.sim.bidding.LookaheadBid`
  ``slo_weight`` whose bids minimize true expected effective price.

Pre-booted capacity must survive the dip in front of the peak it was
bought for: while any stream is planned above current demand the policy
sets ``AdaptiveManager.hold_until = t + lead_h``, which suppresses
voluntary cost-saving adoption (forced replans and mixed zero-migration
repricing still pass). When forecast coverage is below ``warm_coverage``
the envelope degenerates to current demand — the reactive path — so a
cold-started MPC behaves exactly like the baseline it supersedes.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import numpy as np

from repro_torch.core.adaptive import AdaptiveManager
from repro_torch.core.manager import ResourceManager
from repro_torch.core.markets import SPOT, MixedConfig, quotes
from repro_torch.core.strategies import Plan
from repro_torch.core.workload import Stream
from repro_torch.sim.bidding import LookaheadBid, compute_bids
from repro_torch.sim.demand import StreamColumns
from repro_torch.sim.forecast import SeasonalForecaster


@dataclasses.dataclass(frozen=True)
class MPCConfig:
    """Knobs of the model-predictive loop (hours and dollars)."""

    horizon_h: float = 4.0            # lookahead the co-optimizer scores over
    lead_candidates: tuple = (0.0, 1.0, 2.0)      # boot leads considered
    cadence_candidates: tuple = (1.0, 3.0, 6.0)   # voluntary-replan periods
    slo_floor: float = 0.97           # forecast SLO a lead must clear
    reoptimize_every_h: float = 6.0   # how often lead/cadence/bids re-pick
    replan_cost_usd: float = 2.0      # disruption proxy per voluntary replan
    warm_coverage: float = 0.5        # min forecast coverage to leave the
                                      # reactive path
    savings_threshold: float = 0.02   # adoption hysteresis (tight: cadence
                                      # already rate-limits replans)
    cap_fps: float = 12.0             # envelope rate ceiling per stream


class MPCPolicy:
    """Forecast-driven autoscaling that plans for the demand envelope.

    Drop-in fleet-simulator policy (``decide``/``adaptive``/``bids``): in
    on-demand mode it wraps a plain :class:`AdaptiveManager`; with
    ``spot=True`` it plans mixed-market (on-demand floor + spot burst) and
    recomputes per-region bids every decision like ``SpotBidPolicy``,
    using the slow-cadence-selected ``slo_weight``.
    """

    def __init__(self, manager: ResourceManager,
                 forecaster: Optional[SeasonalForecaster] = None,
                 config: Optional[MPCConfig] = None,
                 strategy: str = "FFD", spot: bool = False,
                 floor_frac: float = 0.5,
                 bidding: Optional[LookaheadBid] = None,
                 slo_weight_candidates: Sequence[float] = (0.5, 1.0, 2.0),
                 name: str = "mpc") -> None:
        self.name = name
        self.manager = manager
        self.config = config or MPCConfig()
        self.forecaster = forecaster or SeasonalForecaster()
        self.strategy = strategy
        self.spot = spot
        self.bidding = bidding or LookaheadBid()
        self.slo_weight_candidates = tuple(slo_weight_candidates)
        # None (not {}) outside spot mode: a non-None bids attribute flips
        # the cluster into market-aware reconciliation (bids gate spot
        # booking), which a pure on-demand/spot_fraction policy must not do
        self.bids: Optional[dict[tuple[str, str], float]] = {} if spot \
            else None
        self._market = None
        self._dt_h = 1.0
        self._boot_delay_h = 0.05
        self.adaptive = AdaptiveManager(
            manager, strategy=strategy,
            savings_threshold=self.config.savings_threshold,
            replan_trigger=self._cadence_trigger,
            mixed=MixedConfig(floor_frac=floor_frac) if spot else None,
            multipliers_fn=self._multipliers)
        # co-optimized each reoptimize_every_h from the forecast
        self.lead_h = max(self.config.lead_candidates)
        self.cadence_h = min(self.config.cadence_candidates)
        self._last_reopt: Optional[float] = None
        self._last_voluntary: Optional[float] = None
        self._last_t: Optional[float] = None
        # ledger plumbing (FleetSimulator._policy_interval_stats)
        self.last_preboot = 0
        self.last_forecast_error = 0.0
        self._pending: Optional[tuple[float, float]] = None

    # -- simulator plumbing --------------------------------------------------

    def attach_market(self, market, dt_h: float = 1.0,
                      boot_delay_h: Optional[float] = None) -> None:
        """Called by the fleet simulator: price walk (spot mode), control
        period (forecast sampling step), and the boot window the lead must
        cover and the drop proxy prices."""
        self._market = market
        self._dt_h = dt_h
        if boot_delay_h is not None:
            self._boot_delay_h = boot_delay_h
            if hasattr(self.bidding, "boot_delay_h"):
                self.bidding.boot_delay_h = boot_delay_h

    def attach_telemetry(self, hub) -> None:
        """Feed live fleet telemetry into the forecaster (live-scale
        correction) — typically the same hub the fleet simulator emits to."""
        self.forecaster.attach_hub(hub)

    def _multipliers(self) -> dict:
        return self._market.multipliers() if self._market is not None else {}

    def _cadence_trigger(self, t, streams, plan) -> bool:
        if self._last_voluntary is None \
                or t - self._last_voluntary >= self.cadence_h - 1e-9:
            self._last_voluntary = t
            return True
        return False

    def _reset_run(self) -> None:
        # same contract as ScheduledPolicy: a reused policy's second run is
        # bit-identical to a fresh one's. The *forecaster* persists — its
        # fitted curves are the learned model, not per-run state.
        self.adaptive.current = None
        self.adaptive.events = []
        self.adaptive.hold_until = float("-inf")
        self._last_reopt = None
        self._last_voluntary = None
        self._pending = None
        self.last_preboot = 0
        self.last_forecast_error = 0.0
        self.bids = {} if self.spot else None

    # -- envelope ------------------------------------------------------------

    def _fps_of(self, streams) -> np.ndarray:
        if isinstance(streams, StreamColumns):
            return streams.fps
        return np.array([s.fps for s in streams])

    def _caps(self, streams) -> np.ndarray:
        """Per-stream envelope ceiling: config cap ∧ the program's GPU
        feasibility ceiling (the FlashCrowd clamp — a forecast must never
        ask the packer for an infeasible rate)."""
        cap = self.config.cap_fps
        if isinstance(streams, StreamColumns):
            per_prog = np.array([min(cap, p.max_gpu_fps())
                                 for p in streams.programs_unique])
            return per_prog[streams.program_codes]
        return np.array([min(cap, s.program.max_gpu_fps())
                         for s in streams])

    def _envelope(self, t: float, streams, cur_fps: np.ndarray,
                  lead_h: float) -> tuple[np.ndarray, int]:
        """(envelope rates, #streams planned above current demand).

        Elementwise max of current demand and the forecast sampled over
        ``(t, t + lead_h]`` at the control period, capped at the
        feasibility ceiling and floored at current demand — the envelope
        never plans *below* what is demanded right now.
        """
        env = cur_fps.astype(float).copy()
        if lead_h > 1e-9 and len(env) > 0:
            dt = max(self._dt_h, 1e-6)
            n = max(1, int(math.ceil(lead_h / dt - 1e-9)))
            taus = [t + k * dt for k in range(1, n + 1)]
            if taus[-1] < t + lead_h - 1e-9:
                taus.append(t + lead_h)
            warm = True
            for tau in taus:
                f, known = self.forecaster.forecast_fps(tau, streams)
                if np.count_nonzero(known) \
                        < self.config.warm_coverage * len(known):
                    warm = False        # cold start: stay reactive
                    break
                env = np.maximum(env, np.where(known, f, cur_fps))
            if not warm:
                env = cur_fps.astype(float).copy()
        caps = self._caps(streams)
        env = np.minimum(env, np.maximum(caps, cur_fps))
        # milli-fps grid (the demand models' own granularity) above current
        # demand, exactly current demand elsewhere: forecast float jitter
        # neither perturbs feasibility checks nor fakes pre-boots
        env = np.where(env > cur_fps + 1e-9,
                       np.maximum(np.round(env, 3), cur_fps), cur_fps)
        n_pre = int(np.count_nonzero(env > cur_fps + 1e-9))
        return env, n_pre

    def _with_fps(self, streams, fps: np.ndarray):
        """The same fleet at different rates. Columnar input reuses the
        *same ids/codes objects*, so the packed-problem and feasibility
        fast paths (keyed on ids identity) stay hot."""
        if isinstance(streams, StreamColumns):
            return StreamColumns(streams.ids, fps, streams.program_codes,
                                 streams.programs_unique,
                                 streams.camera_codes, streams.cameras_unique)
        return [dataclasses.replace(s, fps=float(f)) if f != s.fps else s
                for s, f in zip(streams, fps.tolist())]

    # -- slow-cadence co-optimization ----------------------------------------

    def _plan_cost(self, streams, fps: np.ndarray) -> float:
        try:
            return self.manager.plan(self._with_fps(streams, fps),
                                     "FFD").hourly_cost
        except Exception:
            return float("inf")

    def _reoptimize(self, t: float, streams, cur_fps: np.ndarray) -> None:
        """Pick (lead_h, cadence_h[, slo_weight]) from the forecast.

        For each candidate lead, roll the envelope plans over the horizon:
        cost is forecast dollars; SLO is a boot-window proxy (demand that
        exceeds the previous step's envelope waits ``boot_delay_h`` for
        capacity). Cheapest lead meeting ``slo_floor`` wins; if none does,
        the max-SLO lead. Cadence re-scores the winner's cost series with
        window-max capacity holding plus a fixed cost per replan.
        """
        cfg = self.config
        dt = max(self._dt_h, 1e-6)
        k_n = max(1, int(math.ceil(cfg.horizon_h / dt - 1e-9)))
        taus = [t + k * dt for k in range(1, k_n + 1)]
        fc = [self.forecaster.forecast_fps(tau, streams) for tau in taus]
        if not fc or min(np.count_nonzero(kn) for _, kn in fc) \
                < cfg.warm_coverage * max(len(cur_fps), 1):
            return                      # cold forecast: keep current knobs
        caps = self._caps(streams)
        demand = [np.minimum(np.where(kn, f, cur_fps), caps) for f, kn in fc]
        sec = dt * 3600.0
        total_frames = sum(float(d.sum()) * sec for d in demand) or 1.0

        best = None                     # (cost, -slo, lead, cost_series)
        for lead in cfg.lead_candidates:
            prev_env, _ = self._envelope(t, streams, cur_fps, lead)
            dropped = 0.0
            costs = []
            for k, tau in enumerate(taus):
                env_k = prev_env
                for j in range(k, len(taus)):     # max over (tau, tau+lead]
                    if taus[j] > tau + lead + 1e-9:
                        break
                    env_k = np.maximum(env_k, demand[j]) if j > k \
                        else demand[j].copy()
                env_k = np.maximum(np.minimum(env_k, caps), demand[k])
                # demand beyond what the *previous* step planned boots late
                short = np.maximum(demand[k] - prev_env, 0.0)
                dropped += float(short.sum()) * self._boot_delay_h * 3600.0
                costs.append(self._plan_cost(streams, env_k))
                prev_env = env_k
            cost = sum(c * dt for c in costs)
            slo = 1.0 - dropped / total_frames
            key = (cost, -slo)
            if slo >= cfg.slo_floor:
                if best is None or best[3] is None or key < best[:2]:
                    best = (cost, -slo, lead, costs)
            elif best is None or best[3] is None and -slo < best[1]:
                best = (cost, -slo, lead, None)
        if best is None:
            return
        self.lead_h = best[2]

        if best[3] is not None:
            costs = best[3]
            best_c = None
            for cad in cfg.cadence_candidates:
                win = max(1, int(round(cad / dt)))
                held = 0.0
                for k in range(len(costs)):
                    w0 = (k // win) * win
                    held += max(costs[w0:k + 1]) * dt
                held += cfg.replan_cost_usd \
                    * math.ceil(len(costs) * dt / cad)
                if best_c is None or held < best_c[0]:
                    best_c = (held, cad)
            self.cadence_h = best_c[1]

        if self.spot and self._market is not None:
            self._pick_slo_weight()

    def _pick_slo_weight(self) -> None:
        """Choose the bid-aggressiveness whose bids minimize *true*
        expected effective price: candidate ``slo_weight`` shapes the bid,
        but every candidate is judged under the unweighted reclaim cost."""
        mults = self._market.multipliers()
        if not mults:
            return
        vol = getattr(self._market, "volatility", 0.15)
        qs = [q for q in quotes(self.manager.catalog, mults, volatility=vol)
              if q.market == SPOT]
        if not qs:
            return
        history = {r: [h[r] for h in self._market.price_history if r in h]
                   for r in mults}
        true_pen = LookaheadBid(boot_delay_h=self._boot_delay_h,
                                slo_weight=1.0)
        saved = self.bidding.slo_weight
        best = None
        for w in self.slo_weight_candidates:
            self.bidding.slo_weight = w
            score = 0.0
            for q in qs:
                b = self.bidding.bid(q, history.get(q.location, ()),
                                     self._dt_h)
                score += q.effective_price(
                    b, 1.0, preempt_penalty=true_pen.reclaim_cost(q))
            if best is None or score < best[0] - 1e-12:
                best = (score, w)
        self.bidding.slo_weight = best[1] if best else saved

    # -- the policy interface ------------------------------------------------

    def decide(self, t: float, streams, *, preempted: bool = False) -> Plan:
        if self._last_t is not None and t < self._last_t - 1e-9:
            self._reset_run()
        self._last_t = t
        cur_fps = self._fps_of(streams)

        # score the forecast the previous tick's plan rode on
        self.last_forecast_error = 0.0
        if self._pending is not None:
            target_t, predicted = self._pending
            if abs(t - target_t) <= 1e-6:
                realized = float(cur_fps.sum())
                self.last_forecast_error = (abs(predicted - realized)
                                            / max(realized, 1e-9))
            if t >= target_t - 1e-6:
                self._pending = None

        self.forecaster.observe(t, streams)

        if self._last_reopt is None \
                or t - self._last_reopt >= self.config.reoptimize_every_h \
                - 1e-9:
            self._last_reopt = t
            self._reoptimize(t, streams, cur_fps)

        if self.spot:
            self.bids = compute_bids(self.manager.catalog, self._market,
                                     self.bidding, self._dt_h)

        env, n_pre = self._envelope(t, streams, cur_fps, self.lead_h)
        self.last_preboot = n_pre
        self.adaptive.hold_until = (t + self.lead_h) if n_pre \
            else float("-inf")

        f_next, known = self.forecaster.forecast_fps(t + self._dt_h, streams)
        if len(known) and known.any():
            self._pending = (t + self._dt_h,
                             float(np.where(known, f_next, cur_fps).sum()))

        return self.adaptive.step(t, self._with_fps(streams, env),
                                  force=preempted)

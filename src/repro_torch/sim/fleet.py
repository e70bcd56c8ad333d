"""The fleet simulator: demand → policy → cluster → ledger, in event order.

One :class:`FleetSimulator` run replays a demand model against an
autoscaling policy over simulated days. The control loop interleaves
ticks with spot preemptions; every demanded frame ends the run either
analyzed or dropped (never silently lost), and every instance-hour is
billed — so policies are comparable on exactly the two axes the paper
cares about: dollars and service.

Per tick ``t`` (all times in simulated hours):

1. apply the preemptions that fired inside the interval that just ended
   (one vectorized batch in event order — equivalent to the historical
   one-heap-pop-per-event loop, and bit-identical in its ledgers);
2. account the interval, using the demand and stream→instance assignment
   that were in force, then retire long-terminated instances from the
   cluster's columns (their hours seal into an aggregate; billing is
   unchanged);
3. read the demand model, tell the policy whether a preemption hit since
   its last decision (``decide(..., preempted=True)`` forces adaptive
   replans, replaying orphaned streams), and reconcile the cluster to the
   new plan — missing instances boot with a delay, surplus ones drain;
4. advance the spot market's price walk and schedule the preemptions it
   draws for the coming interval.

The loop runs in one of two modes with bit-identical ledgers:

* **object** — per-tick ``Stream`` lists and ``{stream_id: instance_id}``
  dicts, the historical path; always used when a ground-truth service or
  calibration caps frames (those are keyed per stream id).
* **columnar** — demand stays a :class:`~repro_torch.sim.demand.StreamColumns`
  struct-of-arrays, placement is a per-stream instance-row array, and
  accounting is a handful of numpy passes. Chosen automatically when the
  demand model exposes ``columns_at`` and packed mode is on; this is the
  path that takes a 24 h × 1M-stream day from hours to minutes
  (benchmarks/columnar_sweep.py).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core import packed as packed_mod
from repro_torch.core.catalog import Catalog
from repro_torch.sim import events as ev
from repro_torch.sim.cluster import ONDEMAND, SPOT, Cluster, SpotMarket
from repro_torch.sim.demand import DemandModel
from repro_torch.sim.ledger import Ledger, ServiceCalibration, TickRecord


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Simulation knobs; every duration/rate is in simulated hours.

    ``spot_discount`` is the spot base price as a fraction of the on-demand
    $/hour price; ``preempt_hazard_per_h`` the per-instance reclaim hazard
    per simulated hour.
    """

    duration_h: float = 24.0
    dt_h: float = 1.0
    boot_delay_h: float = 0.05           # 3 minutes
    spot_fraction: float = 0.0           # fraction of boots on the spot market
    spot_discount: float = 0.35          # spot base price / on-demand price
    spot_volatility: float = 0.15
    preempt_hazard_per_h: float = 0.08
    seed: int = 0


class FleetSimulator:
    """Replay a demand model against an autoscaling policy (module doc above).

    ``run()`` returns the :class:`~repro_torch.sim.ledger.Ledger`: per-tick $
    spent, frames demanded/analyzed/dropped (frames = frames/s x seconds),
    migrations and preemptions — the two axes (dollars, service) every
    policy is compared on.

    ``columnar`` pins the loop mode: True/False force it, None (default)
    picks columnar when the demand model supports it (see module doc).
    """

    def __init__(self, demand: DemandModel, policy, catalog: Catalog,
                 config: SimConfig = SimConfig(),
                 calibration: Optional[ServiceCalibration] = None,
                 service=None, telemetry=None,
                 columnar: Optional[bool] = None) -> None:
        self.demand = demand
        self.policy = policy
        self.config = config
        self.calibration = calibration
        self.columnar = columnar
        # ``service`` is the *ground truth* serving capacity
        # (obs.DriftingService): when set, it caps analyzed frames instead of
        # the policy's believed calibration — the truth-vs-belief split that
        # lets a stale calibration overpay without over-serving.
        self.service = service
        # ``telemetry`` (obs.TelemetryHub) receives streaming per-tick metric
        # points from the event loop; None = zero overhead.
        self.telemetry = telemetry
        self.cluster = Cluster(boot_delay_h=config.boot_delay_h,
                               spot_fraction=config.spot_fraction,
                               seed=config.seed + 1,
                               telemetry=telemetry)
        self.market = SpotMarket(catalog.locations,
                                 discount=config.spot_discount,
                                 volatility=config.spot_volatility,
                                 hazard_per_h=config.preempt_hazard_per_h,
                                 seed=config.seed + 2)
        self.ledger = Ledger()
        # pipeline demand models (sim.demand.PipelineFleet) emit per-stage
        # items; the ledger then carries stage/pooled-chunk columns
        self._emits_stages = bool(getattr(demand, "emits_stages", False))
        self._pipe_counts: Optional[tuple] = None   # id-list-keyed cache
        # bidding policies observe the market (prices are exogenous: the
        # walk never depends on what any policy rents or bids) and the
        # control-loop timing their preemption-penalty models price against
        attach = getattr(policy, "attach_market", None)
        if attach is not None:
            attach(self.market, config.dt_h, config.boot_delay_h)

    def _tick_times(self) -> list[float]:
        """Decision boundaries ``k * dt`` strictly inside the horizon.

        Generated by accumulation, not ``round(duration / dt)``: a
        non-divisible horizon (2.5 h at dt=1.0) keeps its genuine final
        interval — demand is re-read at the last whole tick and the tail
        [2.0, 2.5) is accounted at END — instead of banker's-rounding the
        tail away."""
        cfg = self.config
        out: list[float] = []
        k = 0
        while True:
            t = k * cfg.dt_h
            if t >= cfg.duration_h - 1e-9:
                break
            out.append(t)
            k += 1
        return out

    def run(self) -> Ledger:
        use_columnar = self.columnar
        if use_columnar is None:
            use_columnar = (packed_mod.enabled()
                            and hasattr(self.demand, "columns_at")
                            and self.service is None
                            and self.calibration is None)
        if use_columnar:
            return self._run_columnar()
        return self._run_object()

    # -- shared event-batch plumbing ----------------------------------------
    #
    # Preemption/outbid events land mid-interval. The historical loop kept
    # them in a heap and popped one at a time; here each boundary drains its
    # batch in (time, push-order) — the exact heap pop order — through
    # Cluster.terminate_batch. An event timed exactly *at* a boundary is
    # applied at the next one, which is precisely when the old heap popped
    # it (ticks were pushed first, so at equal times the tick went first).

    @staticmethod
    def _due(pending: list, t: float) -> tuple[list, list]:
        due = sorted(e for e in pending if e[0] < t)
        if due:
            pending = [e for e in pending if not (e[0] < t)]
        return due, pending

    def _apply_batch(self, due: list) -> tuple[int, int]:
        """Apply one boundary's event batch; return (#applied, #outbids)."""
        applied = self.cluster.terminate_batch(
            (when, iid, kind) for (when, _seq, kind, iid) in due)
        outbids = sum(1 for kind in applied if kind == ev.OUTBID)
        return len(applied), outbids

    def _schedule_market(self, t: float, pending: list, seq: int) -> int:
        """Advance the price walk; push the coming interval's reclaims."""
        cfg = self.config
        self.market.step(cfg.dt_h)
        if cfg.spot_fraction > 0:
            for when, iid in self.market.draw_preemptions(
                    t, cfg.dt_h, self.cluster.live_spot()):
                pending.append((when, seq, ev.PREEMPT, iid))
                seq += 1
        # deterministic bid-based reclaims: the walk just set the price
        # for [t, t + dt); every bid now underwater is reclaimed when
        # the price path crosses it mid-interval. Consumes no RNG, so
        # legacy hazard draws and the walk stay policy-independent.
        for iid in self.market.outbid(self.cluster.live_spot()):
            pending.append((t + 0.5 * cfg.dt_h, seq, ev.OUTBID, iid))
            seq += 1
        return seq

    def _policy_interval_stats(self, adaptive, events_seen: int
                               ) -> tuple[int, int, int, float, int, float]:
        """(events_seen', defrags, recals, calib_err, preboots, fcast_err)
        after a decide()."""
        defrags = recals = 0
        if adaptive is not None:
            new_events = adaptive.events[events_seen:]
            events_seen = len(adaptive.events)
            defrags = sum(1 for e in new_events
                          if getattr(e, "defrag", False))
            recals = sum(1 for e in new_events
                         if getattr(e, "recalibration", False))
        # drift-aware policies publish the verdict of the probe they
        # just took; the ledger gets the calibration error column
        verdict = getattr(self.policy, "last_drift", None)
        calib_err = verdict.rel_error if verdict is not None else 0.0
        # forecast-driven policies (sim/mpc.py) publish how many items they
        # planned above current demand and the realized error of the
        # forecast the outgoing plan rode on; plain policies leave both 0
        preboots = int(getattr(self.policy, "last_preboot", 0) or 0)
        fcast_err = float(getattr(self.policy, "last_forecast_error", 0.0)
                          or 0.0)
        return events_seen, defrags, recals, calib_err, preboots, fcast_err

    # -- object-path loop ---------------------------------------------------

    def _run_object(self) -> Ledger:
        cfg = self.config
        ticks = self._tick_times()

        current_streams = []                 # demand in force this interval
        assignment: dict[str, str] = {}      # stream_id -> instance_id
        prev_assignment: dict[str, str] = {}
        prev_fps: dict[str, float] = {}
        prev_t = 0.0
        preempted_since_decide = 0
        preemptions_this_interval = 0
        migrations_this_interval = 0
        defrags_this_interval = 0
        calib_err_this_interval = 0.0
        recals_this_interval = 0
        outbids_this_interval = 0
        preboots_this_interval = 0
        fcast_err_this_interval = 0.0
        # adaptive policies expose their decision trace; the ledger records
        # when the repair planner's defrag escape hatch fired
        adaptive = getattr(self.policy, "adaptive", None)
        events_seen = 0
        pending: list = []                   # (when, seq, kind, instance_id)
        seq = 0

        for t in ticks + [cfg.duration_h]:
            due, pending = self._due(pending, t)
            if due:
                n_applied, n_outbids = self._apply_batch(due)
                preempted_since_decide += n_applied
                preemptions_this_interval += n_applied
                outbids_this_interval += n_outbids
            if t > prev_t:
                self._account(prev_t, t, current_streams, assignment,
                              prev_assignment, prev_fps,
                              preemptions_this_interval,
                              migrations_this_interval,
                              defrags_this_interval,
                              outbids_this_interval,
                              calib_err_this_interval,
                              recals_this_interval,
                              preboots_this_interval,
                              fcast_err_this_interval)
                preemptions_this_interval = 0
                outbids_this_interval = 0
                # rows terminated before the interval just billed can never
                # be billed, matched, or credited again — seal them off so
                # per-tick work tracks the live fleet, not every boot ever
                self.cluster.retire(prev_t)
                prev_t = t
            if t >= cfg.duration_h - 1e-9:
                break

            prev_assignment = assignment
            prev_fps = {s.stream_id: s.fps for s in current_streams}
            current_streams = self.demand.streams_at(t)
            plan = self.policy.decide(t, current_streams,
                                      preempted=preempted_since_decide > 0)
            preempted_since_decide = 0
            (events_seen, defrags_this_interval, recals_this_interval,
             calib_err_this_interval, preboots_this_interval,
             fcast_err_this_interval) = self._policy_interval_stats(
                adaptive, events_seen)
            assignment = self.cluster.reconcile(
                t, plan, drain_h=cfg.boot_delay_h,
                bids=getattr(self.policy, "bids", None))
            # physical migrations: streams whose instance changed, including
            # preemption replays that a plan-level diff cannot see (the new
            # plan may be structurally identical while the orphaned streams
            # land on freshly booted replacements). A stream with no previous
            # instance is an arrival — its first placement is a boot, not a
            # migration.
            migrations_this_interval = sum(
                1 for sid, iid in assignment.items()
                if sid in prev_assignment and prev_assignment[sid] != iid)

            seq = self._schedule_market(t, pending, seq)
        return self.ledger

    # -- columnar loop ------------------------------------------------------

    def _run_columnar(self) -> Ledger:
        cfg = self.config
        ticks = self._tick_times()
        cluster = self.cluster

        cur = None                            # StreamColumns in force
        cur_rows: Optional[np.ndarray] = None  # per-stream instance row
        pprev_ids = None                      # the decision before that
        pprev_rows: Optional[np.ndarray] = None
        pprev_fps: Optional[np.ndarray] = None
        prev_t = 0.0
        preempted_since_decide = 0
        preemptions_this_interval = 0
        migrations_this_interval = 0
        defrags_this_interval = 0
        calib_err_this_interval = 0.0
        recals_this_interval = 0
        outbids_this_interval = 0
        preboots_this_interval = 0
        fcast_err_this_interval = 0.0
        adaptive = getattr(self.policy, "adaptive", None)
        events_seen = 0
        pending: list = []
        seq = 0

        for t in ticks + [cfg.duration_h]:
            due, pending = self._due(pending, t)
            if due:
                n_applied, n_outbids = self._apply_batch(due)
                preempted_since_decide += n_applied
                preemptions_this_interval += n_applied
                outbids_this_interval += n_outbids
            if t > prev_t:
                self._account_cols(prev_t, t, cur, cur_rows,
                                   pprev_ids, pprev_rows, pprev_fps,
                                   preemptions_this_interval,
                                   migrations_this_interval,
                                   defrags_this_interval,
                                   outbids_this_interval,
                                   calib_err_this_interval,
                                   recals_this_interval,
                                   preboots_this_interval,
                                   fcast_err_this_interval)
                preemptions_this_interval = 0
                outbids_this_interval = 0
                # retire remaps cluster._prev_cols (our cur_rows array) in
                # place; pprev_rows is a different array, remapped here —
                # though rows it can reference are never old enough to drop
                remap = cluster.retire(prev_t)
                if remap is not None and pprev_rows is not None \
                        and pprev_rows is not cur_rows:
                    pprev_rows[:] = np.where(
                        pprev_rows >= 0,
                        remap[np.maximum(pprev_rows, 0)], -1)
                prev_t = t
            if t >= cfg.duration_h - 1e-9:
                break

            pprev_ids = cur.ids if cur is not None else None
            pprev_rows = cur_rows
            pprev_fps = cur.fps if cur is not None else None
            cur = self.demand.columns_at(t)
            plan = self.policy.decide(t, cur,
                                      preempted=preempted_since_decide > 0)
            preempted_since_decide = 0
            (events_seen, defrags_this_interval, recals_this_interval,
             calib_err_this_interval, preboots_this_interval,
             fcast_err_this_interval) = self._policy_interval_stats(
                adaptive, events_seen)
            cur_rows = cluster.reconcile_rows(
                t, plan, cur.ids, drain_h=cfg.boot_delay_h,
                bids=getattr(self.policy, "bids", None))
            prow = self._aligned_prev_rows(cur.ids, pprev_ids, pprev_rows)
            if prow is None:
                migrations_this_interval = 0
            else:
                migrations_this_interval = int(np.count_nonzero(
                    (cur_rows >= 0) & (prow >= 0) & (cur_rows != prow)))

            seq = self._schedule_market(t, pending, seq)
        return self.ledger

    def _aligned_prev_rows(self, ids, pids, prows) -> Optional[np.ndarray]:
        """Previous-decision instance rows re-aligned to stream id list
        ``ids`` (-1 = stream had no previous placement). Identity of the
        id list is the fast path — stable fleets reuse one list forever."""
        if prows is None or pids is None:
            return None
        if pids is ids:
            return prows
        index = {sid: k for k, sid in enumerate(pids)}
        out = np.full(len(ids), -1, dtype=np.int64)
        pl = prows.tolist()
        for k, sid in enumerate(ids):
            j = index.get(sid)
            if j is not None:
                out[k] = pl[j]
        return out

    def _aligned_prev_fps(self, ids, pids, pfps) -> Optional[np.ndarray]:
        if pfps is None or pids is None:
            return None
        if pids is ids:
            return pfps
        index = {sid: k for k, sid in enumerate(pids)}
        out = np.zeros(len(ids))
        pl = pfps.tolist()
        for k, sid in enumerate(ids):
            j = index.get(sid)
            if j is not None:
                out[k] = pl[j]
        return out

    # -- accounting ---------------------------------------------------------

    def _pipeline_counts(self, ids) -> tuple[int, int]:
        """(stage items, pooled chunks) among the demanded ids, following
        the id grammar of ``sim.demand.PipelineFleet`` (``sid::stage`` /
        ``pool::...#k``). Cached per id-list object — the columnar path
        reuses one list while the pool split is stable."""
        cached = self._pipe_counts
        if cached is not None and cached[0] is ids:
            return cached[1]
        stage = pooled = 0
        for sid in ids:
            if "::" in sid:
                stage += 1
                if sid.startswith("pool::"):
                    pooled += 1
        val = (stage, pooled)
        self._pipe_counts = (ids, val)
        return val

    def _account(self, t0: float, t1: float, streams, assignment,
                 prev_assignment, prev_fps, preemptions: int,
                 migrations: int, defrags: int = 0,
                 outbids: int = 0, calib_err: float = 0.0,
                 recals: int = 0, preboots: int = 0,
                 fcast_err: float = 0.0) -> None:
        """Frames and dollars for [t0, t1).

        While a stream's planned instance is still booting, its *previous*
        placement — kept alive by the reconcile drain window — continues to
        serve, but only up to the rate it was planned for (make-before-break
        migration: a scale-up drops only the incremental demand during the
        boot, unless the old instance was preempted away). The credit only
        applies when the old instance is *actually* draining — an instance
        the new plan reuses for other streams has no spare capacity to lend.
        """
        dt_s = (t1 - t0) * 3600.0           # frame counts are fps x seconds
        busy = set(assignment.values())     # instances serving the new plan
        demanded = analyzed = 0.0
        for s in streams:
            d = s.fps * dt_s
            demanded += d
            iid = assignment.get(s.stream_id)
            frac = (self.cluster.instances[iid].running_fraction(t0, t1)
                    if iid is not None else 0.0)
            a = d * frac
            old = prev_assignment.get(s.stream_id)
            if old is not None and old != iid and old not in busy:
                old_rate = min(s.fps, prev_fps.get(s.stream_id, 0.0))
                a = max(a, old_rate * dt_s
                        * self.cluster.instances[old].running_fraction(t0, t1))
            a = min(a, d)
            if self.service is not None:
                # ground truth caps what gets served, independent of what any
                # calibration *believes* — a stale belief overpays for
                # capacity the service cannot use, it never over-serves
                a = min(a, self.service.frame_rate_cap(s.stream_id, t0) * dt_s)
            elif self.calibration is not None:
                a = min(a, self.calibration.frame_rate_cap(s.stream_id) * dt_s)
            analyzed += a
        stage_n = pooled_n = 0
        if self._emits_stages:
            stage_n, pooled_n = self._pipeline_counts(
                [s.stream_id for s in streams])
        self._close_tick(t0, t1, len(streams), demanded, analyzed,
                         preemptions, migrations, defrags, outbids,
                         calib_err, recals, stage_n, pooled_n,
                         preboots, fcast_err)

    def _account_cols(self, t0: float, t1: float, cols, rows,
                      pids, prows, pfps, preemptions: int, migrations: int,
                      defrags: int, outbids: int, calib_err: float,
                      recals: int, preboots: int = 0,
                      fcast_err: float = 0.0) -> None:
        """Columnar twin of :meth:`_account`: the same per-stream float
        expressions as array ops, summed in stream order (cumsum) so the
        totals are bit-identical to the scalar loop."""
        if cols is None or len(cols) == 0:
            self._close_tick(t0, t1, 0, 0.0, 0.0, preemptions, migrations,
                             defrags, outbids, calib_err, recals,
                             preboots=preboots, fcast_err=fcast_err)
            return
        dt_s = (t1 - t0) * 3600.0
        c = self.cluster
        fps = cols.fps
        d = fps * dt_s
        has = rows >= 0
        r = np.maximum(rows, 0)
        ready = c._ready[r]
        term = c._term[r]
        span = t1 - t0
        frac = np.maximum(0.0, np.minimum(t1, term)
                          - np.maximum(t0, ready)) / span
        a = d * np.where(has, frac, 0.0)

        prow = self._aligned_prev_rows(cols.ids, pids, prows)
        if prow is not None:
            busy = np.zeros(c._n, dtype=bool)
            busy[rows[has]] = True
            pr = np.maximum(prow, 0)
            credit_mask = (prow >= 0) & (prow != rows) & ~busy[pr]
            if credit_mask.any():
                pready = c._ready[pr]
                pterm = c._term[pr]
                pfrac = np.maximum(0.0, np.minimum(t1, pterm)
                                   - np.maximum(t0, pready)) / span
                old_rate = np.minimum(
                    fps, self._aligned_prev_fps(cols.ids, pids, pfps))
                a = np.where(credit_mask,
                             np.maximum(a, old_rate * dt_s * pfrac), a)
        a = np.minimum(a, d)
        demanded = float(np.cumsum(d)[-1])
        analyzed = float(np.cumsum(a)[-1])
        stage_n = pooled_n = 0
        if self._emits_stages:
            stage_n, pooled_n = self._pipeline_counts(cols.ids)
        self._close_tick(t0, t1, len(cols), demanded, analyzed, preemptions,
                         migrations, defrags, outbids, calib_err, recals,
                         stage_n, pooled_n, preboots, fcast_err)

    def _close_tick(self, t0: float, t1: float, n_streams: int,
                    demanded: float, analyzed: float, preemptions: int,
                    migrations: int, defrags: int, outbids: int,
                    calib_err: float, recals: int,
                    stage_items: int = 0, pooled_items: int = 0,
                    preboots: int = 0, fcast_err: float = 0.0) -> None:
        cost, hours, by_market = self.cluster.accrue(t0, t1, self.market)
        live = self.cluster.live_count()
        self.ledger.add_tick(TickRecord(
            t=t0, cost=cost, frames_demanded=demanded,
            frames_analyzed=analyzed, frames_dropped=demanded - analyzed,
            migrations=migrations, preemptions=preemptions,
            instances_live=live, streams=n_streams,
            defrags=defrags,
            cost_ondemand=by_market.get(ONDEMAND, 0.0),
            cost_spot=by_market.get(SPOT, 0.0),
            outbids=outbids,
            calib_rel_error=calib_err,
            recalibrations=recals,
            stage_items=stage_items,
            pooled_items=pooled_items,
            preboots=preboots,
            forecast_rel_error=fcast_err,
        ), hours)
        if self.telemetry is not None:
            emit = self.telemetry.emit
            emit(t0, "fleet.cost.usd", cost)
            emit(t0, "fleet.frames.demanded", demanded)
            emit(t0, "fleet.frames.analyzed", analyzed)
            emit(t0, "fleet.frames.dropped", demanded - analyzed)
            emit(t0, "fleet.slo",
                 (analyzed / demanded) if demanded > 0 else 1.0)
            emit(t0, "fleet.instances.live", float(live))
            emit(t0, "fleet.migrations", float(migrations))
            emit(t0, "fleet.preemptions", float(preemptions))
            emit(t0, "fleet.calib.rel_error", calib_err)
            if recals:
                emit(t0, "fleet.recalibrations", float(recals))
            if stage_items:
                emit(t0, "fleet.stage_items", float(stage_items))
                emit(t0, "fleet.pooled_items", float(pooled_items))
            if preboots:
                emit(t0, "fleet.preboots", float(preboots))
            if fcast_err:
                emit(t0, "fleet.forecast.rel_error", fcast_err)

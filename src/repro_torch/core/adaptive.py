"""Adaptive runtime resource management [6,14].

Demands vary (rush hour, content complexity). The adaptive manager monitors
the demanded frame rates, re-solves when the current plan is infeasible or
when re-solving would save enough to justify migration, and applies
hysteresis so it does not thrash.

Replans come in two flavors. A **full** re-solve hands the whole fleet back
to the strategy (the default). **Repair** mode (``repair`` config, or
``strategy="REPAIR"``) routes replans through the incremental repair planner
instead: still-feasible placements stay put, only the delta — streams on
preempted/overloaded bins, plus arrivals — is re-packed, and a defrag escape
hatch falls back to a full plan when repaired cost drifts too far above a
fresh one (see core/repair.py). The event trace records per-event migration
counts and whether the defrag hatch fired.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np

from repro_torch.core.catalog import Catalog
from repro_torch.core.manager import ResourceManager
from repro_torch.core.packed import get_packed
from repro_torch.core.packing import EPS, Infeasible, fits
from repro_torch.core.workload import requirement_columns
from repro_torch.core.repair import (RepairConfig, RepairResult,
                               count_plan_migrations, repair_plan)
from repro_torch.core.strategies import Plan
from repro_torch.core.workload import Stream


@dataclasses.dataclass
class AdaptiveEvent:
    t: int
    action: str            # "keep" | "replan" | "forced-replan"
    hourly_cost: float
    migrations: int
    defrag: bool = False   # repair mode: the full-replan escape hatch fired
    recalibration: bool = False   # replan forced by a drift-triggered
                                  # re-profile (obs.RecalibratingPolicy)


# A replan trigger decides whether a *still-feasible* plan should even be
# re-evaluated this tick (computing a candidate plan costs a solver call).
# Signature: (t, streams, current_plan) -> bool. None = always evaluate.
ReplanTrigger = Callable[[int, Sequence[Stream], Plan], bool]


@dataclasses.dataclass
class AdaptiveManager:
    """Replans when demand drifts (rates in frames/s, costs in $/hour).

    ``savings_threshold``: fraction of current cost a replan must save to be
    worth the migration disruption (hysteresis). A plan that can no longer
    serve the demanded rates forces a replan regardless.

    ``replan_trigger`` makes the control loop pluggable: when the current
    plan is still feasible, the trigger decides whether to spend a solver
    call evaluating a cheaper candidate this tick (scheduled policies replan
    only at chosen hours; the default always evaluates). Infeasibility — or
    ``step(force=True)``, used by the fleet simulator to replay streams off
    preempted instances — bypasses the trigger.

    ``repair`` (or ``strategy="REPAIR"``) switches *replanning* to the
    min-migration repair planner; the config carries the migration budget
    and the defrag ratio. The first placement still uses the configured
    strategy (with no previous plan there is nothing to repair; the REPAIR
    strategy itself degrades to fresh FFD). Like FFD, the repair planner
    packs at each stream's own rate — ``target_fps`` does not apply to
    repaired replans.
    """

    manager: ResourceManager
    strategy: str = "ST3"
    savings_threshold: float = 0.10
    target_fps: Optional[float] = None
    replan_trigger: Optional[ReplanTrigger] = None
    repair: Optional[RepairConfig] = None
    # Mixed-market mode (core/markets.py): when ``mixed`` is set, planning
    # goes through ``manager.plan_mixed`` with the spot multipliers read
    # from ``multipliers_fn`` at every decision — plans carry on-demand and
    # spot bins, replans are min-migration mixed repairs.
    mixed: Optional[object] = None               # markets.MixedConfig
    multipliers_fn: Optional[Callable[[], dict]] = None

    # Capacity hold (model-predictive pre-booting, sim/mpc.py): while
    # ``t < hold_until`` voluntary cost-saving replans are *not adopted* —
    # capacity planned ahead of a forecast peak must survive the dip before
    # it instead of being drained as savings. Forced replans (infeasible
    # demand, preemption replays) and mixed-mode zero-migration repricing
    # are unaffected. The default never holds.
    hold_until: float = float("-inf")

    current: Optional[Plan] = None
    events: list = dataclasses.field(default_factory=list)
    # consumed by the next step(): marks its event as recalibration-forced
    recalibration_pending: bool = dataclasses.field(default=False,
                                                    repr=False)
    # consumed alongside the flag: restricts that replan's repair to bins
    # hosting these streams (per-group recalibration; None = unrestricted)
    recalibration_scope: Optional[frozenset] = dataclasses.field(
        default=None, repr=False)

    def __post_init__(self) -> None:
        if self.strategy == "REPAIR" and self.repair is None:
            self.repair = RepairConfig()

    def flag_recalibration(self,
                           scope: Optional[frozenset] = None) -> None:
        """Mark the *next* decision as recalibration-triggered (called by
        the observability layer's ``RecalibratingPolicy`` just before it forces a replan
        with the re-profiled calibration); the flag is consumed by the
        event that decision appends, so the trace records which replans
        the drift detector caused.

        ``scope`` (per-group recalibration, ``obs.regional``): restrict
        that replan's repair to bins hosting the given stream ids — healthy
        regions' placements are not consolidation fodder and the defrag
        escape hatch stays shut. Repair mode only; full re-solves and mixed
        plans have no bin identity to scope by, so it is ignored there."""
        self.recalibration_pending = True
        self.recalibration_scope = (frozenset(scope)
                                    if scope is not None else None)

    def _multipliers(self) -> dict:
        return self.multipliers_fn() if self.multipliers_fn is not None else {}

    @property
    def repair_mode(self) -> bool:
        return self.repair is not None or self.strategy == "REPAIR"

    def history(self) -> tuple[AdaptiveEvent, ...]:
        """The decision trace so far (immutable view for ledgers/reports)."""
        return tuple(self.events)

    def _plan_feasible_for(self, plan: Plan, streams: Sequence[Stream]) -> bool:
        """Can the already-rented instances serve the new demands in place?

        Each stream stays on its assigned instance; we recompute its
        requirement at the new fps and check capacities. A stream the plan
        has never placed (fleet churn: a camera that just came online) makes
        the plan infeasible — something must host it.
        """
        fast = self._plan_feasible_cols(plan, streams)
        if fast is not None:
            return fast
        by_key = {s.stream_id: s for s in streams}
        placed = {plan.problem.items[i].key
                  for b in plan.solution.bins for i in b.items}
        if any(s.stream_id not in placed for s in streams):
            return False
        for b in plan.solution.bins:
            ch = plan.problem.choices[b.choice]
            used = [0.0] * plan.problem.ndim
            for i in b.items:
                key = plan.problem.items[i].key
                s = by_key.get(key)
                if s is None:
                    continue
                itype = self.manager.catalog.get(ch.type_name)
                req = s.requirement_for(itype)
                if req is None:
                    return False
                if not fits(req, used, ch.capacity):
                    return False
                used = [u + r for u, r in zip(used, req)]
        return True

    def _plan_feasible_cols(self, plan: Plan, streams) -> Optional[bool]:
        """Columnar twin of the scalar walk above; None = preconditions not
        met, fall back to the per-item loop.

        Preconditions: the plan's problem carries packed arrays plus the
        ``packed_ids`` list, and ``streams`` is a StreamColumns built over
        *that same list object* — identity means the stream set is unchanged
        (only the fps column moved), so the "every stream placed" check
        reduces to the coverage the plan was validated with. Equivalence of
        the capacity check is exact, not approximate: the scalar ``fits``
        prefix sums are monotone nondecreasing (non-negative requirement
        vectors), so every per-item check passes iff the *final* per-bin
        per-dim total — accumulated in the same item order by ``bincount``,
        hence the same float — is within ``cap + EPS``."""
        pp = get_packed(plan.problem)
        ids = getattr(plan.problem, "packed_ids", None)
        if (pp is None or ids is None
                or getattr(streams, "ids", None) is not ids):
            return None
        bins = plan.solution.bins
        nb = len(bins)
        lengths = np.fromiter((len(b.items) for b in bins),
                              dtype=np.int64, count=nb)
        total = int(lengths.sum()) if nb else 0
        if total != len(ids):
            return None
        if total == 0:
            return True
        fps = streams.fps
        pcodes = streams.program_codes
        puniq = streams.programs_unique
        uf = np.unique(fps)
        combo = (pcodes.astype(np.int64) * len(uf)
                 + np.searchsorted(uf, fps))
        _, first, cls = np.unique(combo, return_index=True,
                                  return_inverse=True)

        choices = plan.problem.choices
        catalog = self.manager.catalog
        types: list = []
        tidx: dict[str, int] = {}
        tcode = np.empty(len(choices), dtype=np.int64)
        for c, ch in enumerate(choices):
            ti = tidx.get(ch.type_name)
            if ti is None:
                ti = len(types)
                tidx[ch.type_name] = ti
                types.append(catalog.get(ch.type_name))
            tcode[c] = ti
        D = pp.ndim
        reqmat = np.full((len(first), len(types), D), np.inf)
        for g, i0 in enumerate(first.tolist()):
            rep = Stream(stream_id="_feas",
                         program=puniq[int(pcodes[i0])],
                         fps=float(fps[i0]))
            for ti, r in enumerate(requirement_columns(rep, types, None)):
                if r is not None:
                    reqmat[g, ti] = r

        flat = np.fromiter((i for b in bins for i in b.items),
                           dtype=np.int64, count=total)
        item_bin = np.repeat(np.arange(nb, dtype=np.int64), lengths)
        bchoice = np.fromiter((b.choice for b in bins),
                              dtype=np.int64, count=nb)
        reqv = reqmat[cls[flat], tcode[bchoice[item_bin]]]   # (total, D)
        if not np.isfinite(reqv).all():
            return False                      # some stream lost compatibility
        used = np.empty((nb, D))
        for d in range(D):
            used[:, d] = np.bincount(item_bin, weights=reqv[:, d],
                                     minlength=nb)
        cap = pp.capacity[bchoice]
        return bool((used <= cap + EPS).all())

    def _candidate(self, streams: Sequence[Stream],
                   scope: Optional[frozenset] = None
                   ) -> tuple[Plan, int, bool]:
        """(candidate plan, migrations it would perform, defrag?)."""
        if self.mixed is not None:
            res = self.manager.plan_mixed(streams, self._multipliers(),
                                          previous=self.current,
                                          config=self.mixed)
            return res.plan, res.migrations, res.defrag
        if self.repair_mode:
            res: RepairResult = repair_plan(
                streams, self.manager.catalog, previous=self.current,
                config=self.repair or RepairConfig(), scope=scope)
            return res.plan, res.migrations, res.defrag
        candidate = self.manager.plan(streams, self.strategy, self.target_fps)
        migrations = (0 if self.current is None
                      else _count_migrations(self.current, candidate))
        return candidate, migrations, False

    def step(self, t: int, streams: Sequence[Stream], *,
             force: bool = False) -> Plan:
        """One control-loop tick with the current demanded streams.

        ``force=True`` treats the current plan as infeasible regardless of
        capacity (e.g. an instance it relies on was spot-preempted).
        """
        recal = self.recalibration_pending
        scope = self.recalibration_scope if recal else None
        self.recalibration_pending = False
        self.recalibration_scope = None
        if self.current is None:
            # first placement goes through the configured strategy — repair
            # mode only changes how *replans* are computed (with no previous
            # plan there is nothing to repair anyway); mixed mode plans the
            # initial floor/burst split fresh
            if self.mixed is not None:
                self.current = self.manager.plan_mixed(
                    streams, self._multipliers(), config=self.mixed).plan
            else:
                self.current = self.manager.plan(streams, self.strategy,
                                                 self.target_fps)
            # every stream is an arrival, nothing migrates
            self.events.append(AdaptiveEvent(t, "replan",
                                             self.current.hourly_cost,
                                             migrations=0,
                                             recalibration=recal))
            return self.current

        feasible = (not force) and self._plan_feasible_for(self.current, streams)
        if feasible and self.replan_trigger is not None \
                and not self.replan_trigger(t, streams, self.current):
            self.events.append(AdaptiveEvent(t, "keep",
                                             self.current.hourly_cost, 0,
                                             recalibration=recal))
            return self.current
        candidate, migrations, defrag = self._candidate(streams, scope)
        if not feasible:
            self.current = candidate
            self.events.append(AdaptiveEvent(t, "forced-replan",
                                             candidate.hourly_cost, migrations,
                                             defrag=defrag,
                                             recalibration=recal))
        elif (t >= self.hold_until
              and candidate.hourly_cost
              < self.current.hourly_cost * (1 - self.savings_threshold)) \
                or (self.mixed is not None and migrations == 0
                    and candidate.hourly_cost != self.current.hourly_cost):
            # mixed mode: a zero-migration candidate is the same placement
            # repriced at the current spot quotes — adopting it is free and
            # keeps the plan's $/hour honest as the price walk moves
            self.current = candidate
            self.events.append(AdaptiveEvent(t, "replan", candidate.hourly_cost,
                                             migrations, defrag=defrag,
                                             recalibration=recal))
        else:
            self.events.append(AdaptiveEvent(t, "keep",
                                             self.current.hourly_cost, 0,
                                             recalibration=recal))
        return self.current

    def total_cost(self) -> float:
        """Integrated cost over all ticks (1 tick = 1 hour)."""
        return sum(e.hourly_cost for e in self.events)

    def total_migrations(self) -> int:
        return sum(e.migrations for e in self.events)

    def defrags(self) -> int:
        return sum(1 for e in self.events if e.defrag)


def _count_migrations(old: Plan, new: Plan) -> int:
    """Streams that *moved* between plans. A newly arrived stream has no
    prior placement — placing it is a boot, not a migration — and a departed
    stream migrates nowhere either. Delegates to the ordinal-aware plan
    diff, which sees moves between two instances of one (type, location)
    but can over-count when a bin's position shifts within its key: a full
    re-solve has no bin identity to track, so this is an upper bound on the
    moves the cluster's sticky reconcile will actually perform. Repair-mode
    events carry exact counts (origin-tracked); the simulation ledger's
    per-tick physical count is the unbiased metric for comparing the two."""
    return count_plan_migrations(old, new)

"""Resource manager facade (Fig. 1 of the paper).

Inputs: the analysis programs and their per-stream requirements, desired frame
rates, camera locations, and the instance catalog. Output: a Plan — which
instances to rent where, and which streams run on each.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

from repro_torch.core import strategies
from repro_torch.core.catalog import Catalog
from repro_torch.core.packing import Infeasible
from repro_torch.core.strategies import Plan
from repro_torch.core.workload import Stream


@dataclasses.dataclass
class ResourceManager:
    """The paper's cloud resource manager (Fig. 1): plan instance rentals.

    Given streams (each demanding a frame rate in frames/s) and a
    :class:`~repro_torch.core.catalog.Catalog` of instance types priced in $/hour
    per location, ``plan`` runs the named strategy from
    :data:`~repro_torch.core.strategies.STRATEGIES` (exact packing, greedy
    baselines, FFD, or incremental REPAIR) and returns a
    :class:`~repro_torch.core.strategies.Plan` whose ``hourly_cost`` is the total
    rental price in $/hour.
    """

    catalog: Catalog
    default_strategy: str = "ST3"

    def plan(self, streams: Sequence[Stream], strategy: Optional[str] = None,
             target_fps: Optional[float] = None,
             previous: Optional[Plan] = None) -> Plan:
        name = strategy or self.default_strategy
        fn = strategies.STRATEGIES[name]
        if name in ("NL", "ARMVAC", "ARMVAC+", "GCL"):
            if target_fps is None:
                raise ValueError(f"{name} requires target_fps")
            return fn(streams, self.catalog, target_fps)
        if name == "REPAIR":
            # incremental: the previous plan is planner state, not a hint
            return fn(streams, self.catalog, previous=previous)
        return fn(streams, self.catalog)

    def plan_mixed(self, streams: Sequence[Stream], multipliers,
                   previous: Optional[Plan] = None, config=None):
        """Mixed on-demand/spot planning (see :mod:`repro_torch.core.markets`):
        pack under the per-class on-demand floor and the spot anti-affinity
        rule, at current spot prices (``multipliers`` maps region ->
        spot/on-demand price ratio). With ``previous``, replans are
        min-migration repairs of the mixed plan. Returns a
        :class:`~repro_torch.core.markets.MixedResult`."""
        from repro_torch.core.markets import MixedConfig, mixed_plan
        return mixed_plan(streams, self.catalog, multipliers,
                          previous=previous, config=config or MixedConfig())

    def plan_or_fail(self, streams: Sequence[Stream], strategy: str,
                     target_fps: Optional[float] = None):
        """Like plan() but returns None on infeasibility (Fig. 3 'Fail' cells)."""
        try:
            return self.plan(streams, strategy, target_fps)
        except Infeasible:
            return None

    def utilization(self, plan: Plan) -> list[dict]:
        """Per-instance utilization report; the 90% cap is already inside the
        usable capacities, so fractions here are of the *usable* envelope."""
        out = []
        for b in plan.solution.bins:
            ch = plan.problem.choices[b.choice]
            used = b.used(plan.problem)
            frac = tuple((u / c if c > 0 else 0.0) for u, c in zip(used, ch.capacity))
            out.append({
                "instance": ch.key,
                "streams": [plan.problem.items[i].key for i in b.items],
                "utilization_of_usable": tuple(round(f, 3) for f in frac),
            })
        return out

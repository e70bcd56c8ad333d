"""The paper's resource-management strategies.

Fig. 3 (instance-type selection, single location):
  ST1 — CPU-only instances; ST2 — GPU-only instances; ST3 — Kaseb's
  multiple-choice CPU/GPU packing (our exact solver).

Fig. 6 (type × location):
  NL     — Nearest Location: each stream goes to its nearest RTT-feasible
           region; per-region packing.
  ARMVAC — Mohan's adaptive greedy [6,8]: RTT-filter locations, then
           cheapest-cost-efficient instance first, fill it up, repeat.
  GCL    — Globally Cheapest Location [8]: full multi-dimensional
           multiple-choice packing over (type × location) choices with the
           RTT feasibility constraints (our exact solver).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

from repro_torch.core import geo
from repro_torch.core.catalog import Catalog, InstanceType, UTILIZATION_CAP
from repro_torch.core.heuristics import (cheapest_instance_first,
                                   first_fit_decreasing, lowest_price_first)
from repro_torch.core.packing import Choice, Infeasible, Item, Problem, Solution, validate
from repro_torch.core.solver import solve
from repro_torch.core.workload import Stream


@dataclasses.dataclass
class Plan:
    """A resource allocation: which instances to rent, what runs where.

    ``hourly_cost`` is in $/hour; each bin of ``solution`` is one rented
    instance holding the streams (frames/s demands) packed into it.
    """

    solution: Solution
    problem: Problem
    strategy: str

    @property
    def hourly_cost(self) -> float:
        """Total rental price of the planned instances, $/hour."""
        return self.solution.cost

    def signature(self) -> tuple:
        """Canonical comparable form: ordered (choice key, member stream
        keys) per bin plus the exact $/hour cost. Two plans are
        bit-identical iff their signatures are equal — the parity notion
        the packed-vs-scalar tests and the scale_sweep CI gate share."""
        return ([(self.problem.choices[b.choice].key,
                  [self.problem.items[i].key for i in b.items])
                 for b in self.solution.bins], self.solution.cost)

    def instance_counts(self) -> dict[str, int]:
        return self.solution.instance_counts(self.problem)

    def summary(self) -> dict:
        counts = self.instance_counts()
        n_gpu = sum(v for k, v in counts.items() if _key_is_gpu(self.problem, k))
        n_cpu = sum(counts.values()) - n_gpu
        return {
            "strategy": self.strategy,
            "hourly_cost": round(self.hourly_cost, 3),
            "non_gpu_instances": n_cpu,
            "gpu_instances": n_gpu,
            "instances": counts,
            "optimal": self.solution.optimal,
        }


def _key_is_gpu(problem: Problem, key: str) -> bool:
    """GPU-ness comes from the catalog's ``InstanceType.has_gpu``, carried on
    each Choice by build_problem — a name-prefix heuristic misclassifies any
    CPU type that happens to start with "g"/"p"/"NC" (and vice versa)."""
    for c in problem.choices:
        if c.key == key:
            return c.has_gpu
    return False


def build_problem(streams: Sequence[Stream], catalog: Catalog,
                  locations: Optional[Sequence[str]] = None,
                  target_fps: Optional[float] = None,
                  rtt_filter: bool = False,
                  gpu_only: bool = False, cpu_only: bool = False,
                  packed: Optional[bool] = None) -> Problem:
    """Assemble the packing problem from streams + catalog (+ geo constraints).

    With ``rtt_filter``, an item is compatible with a (type, location) choice
    only if the camera's RTT to that location sustains the stream's frame rate.

    ``packed`` selects between the columnwise (vectorized) item builder —
    the default, which groups streams into requirement classes and attaches
    the arrays the fast FFD path consumes — and the original per-stream
    scalar loop (``packed=False``, or anything inside
    ``repro_torch.core.packed.scalar_mode()``). Both produce the same Problem,
    bit for bit; the packed one does it in O(classes x choices) instead of
    O(streams x choices).
    """
    from repro_torch.core import packed as packed_mod

    choices: list[Choice] = []
    metas: list[tuple[InstanceType, str]] = []
    for t in catalog.types:
        if gpu_only and not t.has_gpu:
            continue
        if cpu_only and t.has_gpu:
            continue
        for loc, price in sorted(t.prices.items()):
            if locations is not None and loc not in locations:
                continue
            choices.append(Choice(
                key=f"{t.name}@{loc}", type_name=t.name, location=loc,
                capacity=t.usable(UTILIZATION_CAP), price=price,
                has_gpu=t.has_gpu))
            metas.append((t, loc))
    if not choices:
        raise Infeasible("catalog empty after strategy filters")

    if packed is None:
        packed = packed_mod.enabled()
    if packed:
        return packed_mod.build_packed_items(streams, choices, metas,
                                             target_fps, rtt_filter)

    items: list[Item] = []
    for s in streams:
        fps = target_fps if target_fps is not None else s.fps
        reqs: list[Optional[tuple[float, ...]]] = []
        for (t, loc) in metas:
            req = s.requirement_for(t, fps=target_fps)
            if req is not None and rtt_filter and s.camera is not None:
                if geo.max_fps(s.camera, loc) < fps:
                    req = None
            reqs.append(req)
        items.append(Item(key=s.stream_id, requirements=tuple(reqs)))
    return Problem(choices=tuple(choices), items=tuple(items))


# ----------------------------------------------------------------------
# Fig. 3 strategies (single-location, CPU vs GPU)
# ----------------------------------------------------------------------

def st1_cpu_only(streams: Sequence[Stream], catalog: Catalog) -> Plan:
    problem = build_problem(streams, catalog, cpu_only=True)
    sol, _ = solve(problem)
    validate(problem, sol)
    return Plan(sol, problem, "ST1")


def st2_gpu_only(streams: Sequence[Stream], catalog: Catalog) -> Plan:
    problem = build_problem(streams, catalog, gpu_only=True)
    sol, _ = solve(problem)
    validate(problem, sol)
    return Plan(sol, problem, "ST2")


def st3_multiple_choice(streams: Sequence[Stream], catalog: Catalog) -> Plan:
    """Kaseb et al. [7]: the paper's contribution for Fig. 3."""
    problem = build_problem(streams, catalog)
    sol, _ = solve(problem)
    validate(problem, sol)
    return Plan(sol, problem, "ST3")


# ----------------------------------------------------------------------
# Fig. 6 strategies (type × location)
# ----------------------------------------------------------------------

def nearest_location(streams: Sequence[Stream], catalog: Catalog,
                     target_fps: float) -> Plan:
    """NL: every camera ships to its nearest feasible region; pack per region."""
    groups: dict[str, list[Stream]] = {}
    for s in streams:
        assert s.camera is not None, "NL requires camera locations"
        feas = geo.feasible_regions(s.camera, target_fps, catalog.locations)
        if not feas:
            raise Infeasible(f"stream {s.stream_id}: no region within RTT budget")
        region = min(feas, key=lambda r: geo.rtt_ms(s.camera, r))
        groups.setdefault(region, []).append(s)

    bins_total = []
    cost = 0.0
    problems = []
    for region, group in sorted(groups.items()):
        problem = build_problem(group, catalog, locations=[region],
                                target_fps=target_fps)
        sol, _ = solve(problem)
        validate(problem, sol)
        problems.append((problem, sol))
        cost += sol.cost
    # merge into one plan over the union problem for uniform reporting
    union_problem = build_problem(streams, catalog, target_fps=target_fps,
                                  rtt_filter=True)
    merged = _merge_regional(union_problem, problems)
    return Plan(merged, union_problem, "NL")


def _merge_regional(union_problem: Problem, parts) -> Solution:
    from repro_torch.core.packing import Bin
    key_to_idx = {c.key: i for i, c in enumerate(union_problem.choices)}
    item_to_idx = {it.key: i for i, it in enumerate(union_problem.items)}
    bins = []
    cost = 0.0
    for problem, sol in parts:
        for b in sol.bins:
            ch = problem.choices[b.choice]
            nb = Bin(choice=key_to_idx[ch.key],
                     items=[item_to_idx[problem.items[i].key] for i in b.items])
            bins.append(nb)
            cost += ch.price
    return Solution(bins=bins, cost=cost, optimal=False, note="regional-merge")


def armvac(streams: Sequence[Stream], catalog: Catalog, target_fps: float) -> Plan:
    """ARMVAC [6,8]: RTT-filter, then lowest-price-instance-first greedy fill."""
    problem = build_problem(streams, catalog, target_fps=target_fps, rtt_filter=True)
    sol = lowest_price_first(problem)
    validate(problem, sol)
    return Plan(sol, problem, "ARMVAC")


def armvac_plus(streams: Sequence[Stream], catalog: Catalog, target_fps: float) -> Plan:
    """BEYOND-PAPER: ARMVAC with a price-per-held-stream greedy instead of the
    raw lowest-price rule — closes most of the mid-band gap at greedy cost."""
    problem = build_problem(streams, catalog, target_fps=target_fps, rtt_filter=True)
    sol = cheapest_instance_first(problem)
    validate(problem, sol)
    return Plan(sol, problem, "ARMVAC+")


def gcl(streams: Sequence[Stream], catalog: Catalog, target_fps: float) -> Plan:
    """GCL [8]: global multiple-choice packing over types × locations."""
    problem = build_problem(streams, catalog, target_fps=target_fps, rtt_filter=True)
    sol, _ = solve(problem, time_budget_s=30.0)
    validate(problem, sol)
    return Plan(sol, problem, "GCL")


# ----------------------------------------------------------------------
# Fleet-scale greedy (BEYOND-PAPER)
# ----------------------------------------------------------------------

def ffd_greedy(streams: Sequence[Stream], catalog: Catalog) -> Plan:
    """FFD: first-fit-decreasing over the full (type × location) choice set,
    at each stream's own frame rate. Linear-time planning for the fleet
    simulator, where the control loop replans hundreds of streams every
    simulated hour and an exact solve per tick is unaffordable. Streams with
    cameras are RTT-filtered to their Fig.-4 feasible regions.
    """
    has_cam = getattr(streams, "any_camera", None)
    rtt = has_cam() if has_cam is not None \
        else any(s.camera is not None for s in streams)
    problem = build_problem(streams, catalog, rtt_filter=rtt)
    sol = first_fit_decreasing(problem)
    validate(problem, sol)
    return Plan(sol, problem, "FFD")


def consolidated_ffd(streams: Sequence[Stream], catalog: Catalog,
                     pooled: Optional[Sequence[Stream]] = None) -> Plan:
    """Keep-the-cheaper stage consolidation (the mixed-market pattern from
    ``core.markets``): FFD-pack the per-camera stage items and, when a
    ``pooled`` view of the same demand is given (crop stages merged onto
    shared workers — e.g. the ``consolidate=True`` arm of
    ``sim.demand.PipelineFleet``), also pack that; return whichever plan is
    cheaper. Consolidating is therefore never worse than not consolidating,
    by construction — the property tests rely on this, the simulator gates
    the actual saving empirically."""
    base = ffd_greedy(streams, catalog)
    if pooled is None:
        return base
    alt = ffd_greedy(pooled, catalog)
    return alt if alt.hourly_cost <= base.hourly_cost else base


def repair_incremental(streams: Sequence[Stream], catalog: Catalog,
                       previous=None, config=None) -> Plan:
    """REPAIR (BEYOND-PAPER): min-migration incremental replanning. Keeps
    every still-feasible placement of ``previous`` in place, evicts only
    streams on lost/overloaded bins, and FFD-packs just that delta over
    residual capacity (see core/repair.py). With no previous plan it is a
    fresh FFD."""
    from repro_torch.core.repair import RepairConfig, repair_plan
    return repair_plan(streams, catalog, previous=previous,
                       config=config or RepairConfig()).plan


# The planner registry ResourceManager.plan dispatches on. Paper strategies:
# ST1/ST2/ST3 (Fig. 3 CPU/GPU selection, exact solver) and NL/ARMVAC/GCL
# (Fig. 6 type x location; ARMVAC+ is our improved greedy) — these take a
# target_fps in frames/s. Beyond-paper fleet strategies: FFD (linear-time
# first-fit-decreasing at each stream's own rate) and REPAIR (min-migration
# incremental replanning). Every strategy returns a Plan costed in $/hour.
STRATEGIES: dict[str, Callable] = {
    "ST1": st1_cpu_only, "ST2": st2_gpu_only, "ST3": st3_multiple_choice,
    "NL": nearest_location, "ARMVAC": armvac, "ARMVAC+": armvac_plus, "GCL": gcl,
    "FFD": ffd_greedy, "REPAIR": repair_incremental,
}

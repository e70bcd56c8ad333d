"""Min-migration incremental replanning: repair the plan, don't rebuild it.

Full replanning treats every control-loop tick as a fresh bin-packing
instance: ``ffd_greedy`` re-sorts and re-packs *all* streams, so one spot
preemption or one camera's ramp can reshuffle placements fleet-wide. The
fleet simulator bills every move as a boot-window SLO loss, which is the
hidden cost the paper's adaptive manager never accounts for. Jain et al. and
Rivas et al. both observe that placement *stability* is what makes
cross-camera consolidation real at fleet scale.

The repair planner treats the previous :class:`Plan` as state:

1. **Keep** every still-feasible (stream -> bin) placement exactly where it
   is, in the old bin order (bin order is what the cluster's reconcile maps
   onto physical instances, oldest-first).
2. **Evict** only what must move: streams on bins whose (type, location)
   choice disappeared from the new problem, streams whose new requirement is
   incompatible with their bin's choice, and — on overfull bins — the
   largest streams first, so the fewest streams move.
3. **Pack the delta** (evictions + new arrivals) first-fit-decreasing over
   the residual capacity of the kept bins, opening new instances only when
   nothing fits (same cost-efficiency opening rule as the full FFD).
4. **Migration budget** (optional): leftover budget after forced moves is
   spent on consolidation — close the emptiest bins by re-packing their
   streams into residual capacity elsewhere, clawing back cost without a
   fleet-wide reshuffle.
5. **Defrag escape hatch** (optional): when the repaired cost drifts to
   ``defrag_ratio`` x a fresh FFD plan's cost, adopt the fresh plan
   wholesale — one big migration buys back the accumulated fragmentation.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from repro_torch.core import packed as packed_mod
from repro_torch.core.catalog import Catalog
from repro_torch.core.heuristics import ffd_pack_into, first_fit_decreasing
from repro_torch.core.packing import Bin, Problem, Solution, fits, validate
from repro_torch.core.strategies import Plan, build_problem
from repro_torch.core.workload import Stream


@dataclasses.dataclass(frozen=True)
class RepairConfig:
    """Knobs for the repair planner.

    ``migration_budget``: total *real* moves the repair may spend per call
    (a stream whose final bin equals its old bin costs nothing, and
    arrivals are free). Forced moves (evictions) always happen —
    feasibility beats the budget — and consolidation only spends what they
    left over. ``None`` disables consolidation entirely: pure min-migration
    repair.

    ``defrag_ratio``: adopt a fresh FFD plan when the repaired plan costs at
    least this multiple of it. ``None`` never defrags.
    """

    migration_budget: Optional[int] = None
    defrag_ratio: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class RepairResult:
    """A repaired plan plus the migration ledger the event trace records."""

    plan: Plan
    migrations: int          # streams whose final bin differs from their old
                             # bin (arrivals and put-back evictions excluded)
    evicted: int             # forced evictions (lost/overfull/incompatible)
    consolidated: int        # budget spent on voluntary consolidation moves
    arrivals: int            # streams with no prior placement (not migrations)
    departures: int          # streams that left the fleet
    kept: int                # streams kept in place by the eviction pass
    defrag: bool = False
    fresh_cost: Optional[float] = None   # fresh-FFD reference, when computed


def plan_assignment(plan: Plan) -> dict[str, tuple[str, int]]:
    """stream key -> (choice key, ordinal among that key's bins).

    The ordinal mirrors how the simulated cluster maps bins onto live
    instances (per choice key, in bin order), so diffing two assignments
    counts the moves the fleet would physically perform — unlike a bare
    choice-key diff, which misses moves between two instances of one type.
    """
    out: dict[str, tuple[str, int]] = {}
    ordinal: dict[str, int] = {}
    # Packed problems carry item keys as a plain sequence; indexing it
    # directly skips materializing an Item object per stream.
    ids = getattr(plan.problem, "packed_ids", None)
    for b in plan.solution.bins:
        key = plan.problem.choices[b.choice].key
        n = ordinal.get(key, 0)
        ordinal[key] = n + 1
        if ids is not None:
            placed = (key, n)
            for i in b.items:
                out[ids[i]] = placed
        else:
            for i in b.items:
                out[plan.problem.items[i].key] = (key, n)
    return out


def count_plan_migrations(old: Plan, new: Plan) -> int:
    """Streams present in both plans whose (choice, ordinal) placement moved.
    Arrivals and departures are not migrations — nothing physically moves."""
    a, b = plan_assignment(old), plan_assignment(new)
    return sum(1 for k, v in b.items() if k in a and a[k] != v)


def _keep_and_evict(previous: Plan, problem: Problem):
    """Map the old plan's bins into the new problem.

    Returns (kept bins, their used vectors, their origin old-bin indices,
    {new item idx -> origin old-bin idx}, evicted item indices, departures).
    Kept bins preserve the old bin order; a bin whose members all departed is
    dropped (scale-down). Overfull bins evict their largest members first —
    each eviction frees the most room, so the fewest streams move.
    """
    key2choice = {c.key: i for i, c in enumerate(problem.choices)}
    key2item = {it.key: i for i, it in enumerate(problem.items)}
    kept: list[Bin] = []
    kept_used: list[list[float]] = []
    kept_origin: list[Optional[int]] = []
    old_bin_of: dict[int, int] = {}
    evicted: list[int] = []
    departures = 0

    # First pass: surviving members per old bin (choice mapped into the new
    # problem, departures counted, incompatible members marked for eviction;
    # the global eviction order — per bin, incompatible first, then overfull
    # — is assembled in the second pass, identical to the scalar loop).
    per_bin: list[tuple[int, Optional[int],
                        list[tuple[int, tuple[float, ...]]], list[int]]] = []
    for obi, b in enumerate(previous.solution.bins):
        c = key2choice.get(previous.problem.choices[b.choice].key)
        members: list[tuple[int, tuple[float, ...]]] = []
        pre_ev: list[int] = []
        for i in b.items:
            j = key2item.get(previous.problem.items[i].key)
            if j is None:
                departures += 1
                continue
            old_bin_of[j] = obi
            req = problem.items[j].requirements[c] if c is not None else None
            if req is None:
                pre_ev.append(j)
            else:
                members.append((j, req))
        per_bin.append((obi, c, members, pre_ev))

    # Residual-capacity screen on packed arrays: one vectorized pass totals
    # every kept bin's new requirements and flags bins that could be
    # overfull. numpy's pairwise summation can differ from the scalar
    # member-order sums by ~1 ulp, so the margin is generous (1e-6 vs the
    # 1e-9 decision threshold) and flagged bins re-check exactly below —
    # decisions are bit-identical to the scalar path.
    pp = packed_mod.get_packed(problem)
    survivors = [(n, c, members) for n, (_, c, members, _) in enumerate(per_bin)
                 if c is not None and members]
    maybe_over = {n: True for n, _, _ in survivors}
    if pp is not None and survivors:
        bin_id = np.concatenate([
            np.full(len(members), k, dtype=np.int64)
            for k, (_, _, members) in enumerate(survivors)])
        item_idx = np.fromiter(
            (j for _, _, members in survivors for j, _ in members),
            dtype=np.int64)
        choice_idx = np.concatenate([
            np.full(len(members), c, dtype=np.int64)
            for _, c, members in survivors])
        reqs = pp.class_req[pp.item_class[item_idx], choice_idx]
        totals = np.zeros((len(survivors), problem.ndim))
        np.add.at(totals, bin_id, reqs)
        caps = pp.capacity[[c for _, c, _ in survivors]]
        flags = np.any(totals > caps - 1e-6, axis=1)
        maybe_over = {n: bool(f) for (n, _, _), f in zip(survivors, flags)}

    for n, (obi, c, members, pre_ev) in enumerate(per_bin):
        evicted.extend(pre_ev)
        if c is None or not members:
            continue
        cap = problem.choices[c].capacity
        while members and maybe_over[n]:
            used = [sum(r[k] for _, r in members)
                    for k in range(problem.ndim)]
            over = [k for k in range(problem.ndim)
                    if used[k] > cap[k] + 1e-9]
            if not over:
                break
            # evict the member largest in the overflowing dimensions: each
            # eviction then frees the most of what is actually scarce, so
            # the fewest streams move
            worst = max(range(len(members)),
                        key=lambda m: max(
                            (members[m][1][k] / cap[k] if cap[k] > 0
                             else float("inf")) for k in over))
            evicted.append(members.pop(worst)[0])
        if members:
            kept.append(Bin(choice=c, items=[j for j, _ in members]))
            kept_used.append([sum(r[k] for _, r in members)
                              for k in range(problem.ndim)])
            kept_origin.append(obi)
    return kept, kept_used, kept_origin, old_bin_of, evicted, departures


# Public aliases: the mixed-market planner (core/markets.py) repairs mixed
# plans with exactly this keep/evict pass and migration accounting — the
# eviction order, origin tracking, and packed pre-screen are shared, only
# the delta packing differs (market floor + anti-affinity rules).
def keep_and_evict(previous: Plan, problem: Problem):
    """See :func:`_keep_and_evict` — the repair planner's keep/evict pass."""
    return _keep_and_evict(previous, problem)


def final_moves(bins: Sequence[Bin], origins: Sequence[Optional[int]],
                old_bin_of: dict[int, int]) -> int:
    """See :func:`_final_moves` — the true migration count of a repair."""
    return _final_moves(bins, origins, old_bin_of)


def _final_moves(bins: Sequence[Bin], origins: Sequence[Optional[int]],
                 old_bin_of: dict[int, int]) -> int:
    """Streams whose final bin differs from the old bin that held them —
    the true migration count. Arrivals (no old bin) never count, and an
    evicted stream that the delta pass put back where it came from does
    not count either."""
    moved = 0
    for b, org in zip(bins, origins):
        for i in b.items:
            obi = old_bin_of.get(i)
            if obi is not None and obi != org:
                moved += 1
    return moved


def _consolidate(problem: Problem, bins: list[Bin],
                 bin_used: list[list[float]],
                 origins: list[Optional[int]], budget: int,
                 free_movers: set[int],
                 scope: Optional[frozenset] = None) -> int:
    """Close the emptiest bins by re-packing their members into residual
    capacity elsewhere, spending at most ``budget`` moves. A member in
    ``free_movers`` (an arrival or an already-evicted stream — it is moving
    this tick anyway) costs no budget. ``scope`` (per-group recalibration)
    restricts which bins may *close*: only bins hosting a scoped stream, or
    bins opened this repair (origin ``None``) — a healthy region's
    placements are never consolidation fodder, though any bin may still
    *receive* movers. Returns the budget spent."""
    moved = 0
    while budget - moved >= 0:
        # emptiest first: fewest members, then highest price per member
        candidates = sorted(
            (n for n in range(len(bins))
             if scope is None or origins[n] is None
             or any(problem.items[i].key in scope for i in bins[n].items)),
            key=lambda n: (len(bins[n].items),
                           -problem.choices[bins[n].choice].price))
        closed = False
        for n in candidates:
            src = bins[n]
            charge = sum(1 for i in src.items if i not in free_movers)
            if not src.items or charge > budget - moved:
                continue
            trial_used = [list(u) for u in bin_used]
            landing: list[tuple[int, int, tuple[float, ...]]] = []
            for i in src.items:
                ok = False
                for m, (b, used) in enumerate(zip(bins, trial_used)):
                    if m == n:
                        continue
                    req = problem.items[i].requirements[b.choice]
                    if req is not None and fits(
                            req, used, problem.choices[b.choice].capacity):
                        landing.append((i, m, req))
                        for k in range(problem.ndim):
                            used[k] += req[k]
                        ok = True
                        break
                if not ok:
                    break
            if len(landing) == len(src.items):
                for i, m, req in landing:
                    bins[m].items.append(i)
                    for k in range(problem.ndim):
                        bin_used[m][k] += req[k]
                moved += charge
                del bins[n], bin_used[n], origins[n]
                closed = True
                break
        if not closed:
            break
    return moved


def repair_plan(streams: Sequence[Stream], catalog: Catalog,
                previous: Optional[Plan] = None,
                config: RepairConfig = RepairConfig(),
                scope: Optional[frozenset] = None) -> RepairResult:
    """Incrementally repair ``previous`` for the new stream set.

    With no previous plan this degrades to a fresh FFD plan (everything is
    an arrival; migrations are zero by definition).

    ``scope`` (per-group recalibration, ``obs.regional``): a set of stream
    ids whose calibration just changed. The keep/evict pass and delta
    packing run as usual — feasibility is global — but voluntary work is
    confined to the scope: consolidation may only close bins hosting a
    scoped stream (or bins opened this call), and the defrag escape hatch
    stays shut — a fleet-wide reshuffle is never the right response to a
    one-region re-profile.
    """
    rtt = any(s.camera is not None for s in streams)
    problem = build_problem(streams, catalog, rtt_filter=rtt)

    if previous is None:
        sol = first_fit_decreasing(problem)
        validate(problem, sol)
        return RepairResult(plan=Plan(sol, problem, "REPAIR"), migrations=0,
                            evicted=0, consolidated=0, arrivals=len(streams),
                            departures=0, kept=0)

    kept, kept_used, origins, old_bin_of, evicted, departures = \
        _keep_and_evict(previous, problem)
    placed = {i for b in kept for i in b.items} | set(evicted)
    arrivals = [i for i in range(len(problem.items)) if i not in placed]
    n_kept = sum(len(b.items) for b in kept)

    # FFD the delta over the kept bins' residual capacity first; new bins
    # append after them, preserving the order the cluster maps onto
    # instances
    ffd_pack_into(problem, kept, kept_used, evicted + arrivals)
    origins.extend([None] * (len(kept) - len(origins)))

    consolidated = 0
    if config.migration_budget is not None:
        left = config.migration_budget - _final_moves(kept, origins,
                                                      old_bin_of)
        if left >= 0:
            free = set(evicted) | set(arrivals)   # moving this tick anyway
            consolidated = _consolidate(problem, kept, kept_used, origins,
                                        left, free, scope)

    cost = sum(problem.choices[b.choice].price for b in kept)
    sol = Solution(bins=kept, cost=cost, optimal=False, note="repair")
    validate(problem, sol)
    plan = Plan(sol, problem, "REPAIR")

    fresh_cost: Optional[float] = None
    if config.defrag_ratio is not None and scope is None:
        fresh = first_fit_decreasing(problem)
        fresh_cost = fresh.cost
        if cost >= config.defrag_ratio * fresh.cost - 1e-9:
            validate(problem, fresh)
            fresh_plan = Plan(fresh, problem, "REPAIR")
            return RepairResult(
                plan=fresh_plan,
                migrations=count_plan_migrations(previous, fresh_plan),
                evicted=len(evicted), consolidated=0,
                arrivals=len(arrivals), departures=departures,
                kept=n_kept, defrag=True, fresh_cost=fresh_cost)

    # true moves: the final old-bin vs new-bin diff per stream. Arrivals
    # never count (no prior placement), an evicted stream packed back into
    # its own bin does not count, and streams whose bin merely shifted
    # position after an earlier same-key bin emptied do not count either —
    # the cluster's sticky reconcile keeps them on their instances.
    return RepairResult(
        plan=plan, migrations=_final_moves(kept, origins, old_bin_of),
        evicted=len(evicted), consolidated=consolidated,
        arrivals=len(arrivals), departures=departures,
        kept=n_kept, defrag=False, fresh_cost=fresh_cost)

"""Exact branch-and-bound solver for multi-dimensional multiple-choice VBP.

Replaces the Gurobi 5.0 branch-and-cut of the paper (offline environment).
Exact for the paper-scale inputs (tens of streams, dozens of choices); falls
back to the FFD incumbent with ``optimal=False`` when the node budget is hit.

Search: items in decreasing l_inf-size order; each node assigns the next item
either into one of the open bins (deduplicated by identical (choice, load))
or into a new bin of each compatible choice (deduplicated by choice, and
symmetry-broken: at most one *empty-equivalent* new bin per choice per node).

Bounds: dual per-dimension lower bound — for dimension d,
    LB_d = sum_i min_{c in compat(i)} price_c * req_{i,d}(c) / cap_{c,d}
is a valid lower bound on the remaining cost since each opened instance of
choice c contributes at most cap_{c,d} of dimension d at price price_c.
We take max_d LB_d minus a credit for free capacity already paid for in the
open bins (an item landing in open bin b of choice c consumes at most
price_c * free_{b,d} / cap_{c,d} of its unit bound in dimension d, so
subtracting the open bins' free-capacity value keeps the bound valid —
without the credit the bound over-estimates and prunes optimal branches).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

from repro_torch.core.heuristics import first_fit_decreasing
from repro_torch.core.packing import Bin, Infeasible, Problem, Solution, fits


@dataclasses.dataclass
class SolveStats:
    nodes: int = 0
    pruned_bound: int = 0
    pruned_memo: int = 0
    wall_s: float = 0.0
    optimal: bool = False


def _item_order(problem: Problem) -> list[int]:
    def size(i: int) -> float:
        item = problem.items[i]
        best = 0.0
        for c in item.compatible():
            req = item.requirements[c]
            cap = problem.choices[c].capacity
            best = max(best, max((r / k if k > 0 else 0.0) for r, k in zip(req, cap)))
        return best
    return sorted(range(len(problem.items)), key=size, reverse=True)


def _unit_costs(problem: Problem) -> list[list[float]]:
    """unit[i][d] = min over compatible c of price_c * req/cap (inf if no compat)."""
    nd = problem.ndim
    out: list[list[float]] = []
    for item in problem.items:
        best = [float("inf")] * nd
        compat = item.compatible()
        if not compat:
            raise Infeasible(f"item {item.key} has no compatible choice")
        for c in compat:
            req = item.requirements[c]
            ch = problem.choices[c]
            for d in range(nd):
                cap = ch.capacity[d]
                v = 0.0 if req[d] <= 0 else (ch.price * req[d] / cap if cap > 0 else float("inf"))
                best[d] = min(best[d], v)
        out.append([0.0 if v == float("inf") else v for v in best])
    return out


def solve(problem: Problem,
          node_budget: int = 2_000_000,
          time_budget_s: float = 60.0) -> tuple[Solution, SolveStats]:
    """Exact BnB; returns best solution found and whether it is proven optimal."""
    stats = SolveStats()
    t0 = time.monotonic()
    order = _item_order(problem)
    unit = _unit_costs(problem)
    nd = problem.ndim

    # per-dim suffix sums of the unit lower bounds over the ordered items
    n = len(order)
    suff = [[0.0] * nd for _ in range(n + 1)]
    for pos in range(n - 1, -1, -1):
        i = order[pos]
        for d in range(nd):
            suff[pos][d] = suff[pos + 1][d] + unit[i][d]

    try:
        incumbent = first_fit_decreasing(problem)
    except Infeasible:
        incumbent = None

    best_cost = incumbent.cost if incumbent is not None else float("inf")
    best_bins: Optional[list[Bin]] = (
        [Bin(b.choice, list(b.items)) for b in incumbent.bins] if incumbent else None)

    # open bins as parallel arrays
    bin_choice: list[int] = []
    bin_used: list[list[float]] = []
    bin_items: list[list[int]] = []
    memo: dict[tuple, float] = {}

    def state_key(pos: int) -> tuple:
        sig = tuple(sorted(
            (bin_choice[b], tuple(round(v, 6) for v in bin_used[b]))
            for b in range(len(bin_choice))))
        return (pos, sig)

    aborted = [False]

    def dfs(pos: int, cost: float) -> None:
        nonlocal best_cost, best_bins
        if aborted[0]:
            return
        stats.nodes += 1
        if stats.nodes > node_budget or (stats.nodes % 4096 == 0 and
                                         time.monotonic() - t0 > time_budget_s):
            aborted[0] = True
            return
        if pos == n:
            if cost < best_cost - 1e-9:
                best_cost = cost
                best_bins = [Bin(bin_choice[b], list(bin_items[b]))
                             for b in range(len(bin_choice))]
            return
        # credit[d]: value of free, already-paid capacity in the open bins
        credit = [0.0] * nd
        for b in range(len(bin_choice)):
            ch_b = problem.choices[bin_choice[b]]
            for d in range(nd):
                cap = ch_b.capacity[d]
                if cap > 0:
                    credit[d] += ch_b.price * (cap - bin_used[b][d]) / cap
        node_lb = max((suff[pos][d] - credit[d] for d in range(nd)),
                      default=0.0)
        if cost + max(node_lb, 0.0) >= best_cost - 1e-9:
            stats.pruned_bound += 1
            return
        key = state_key(pos)
        prev = memo.get(key)
        if prev is not None and prev <= cost + 1e-9:
            stats.pruned_memo += 1
            return
        memo[key] = cost

        i = order[pos]
        item = problem.items[i]

        # 1) place into an open bin (dedupe identical (choice, load) states)
        tried: set[tuple] = set()
        for b in range(len(bin_choice)):
            c = bin_choice[b]
            req = item.requirements[c]
            if req is None:
                continue
            sig = (c, tuple(round(v, 6) for v in bin_used[b]))
            if sig in tried:
                continue
            tried.add(sig)
            cap = problem.choices[c].capacity
            if fits(req, bin_used[b], cap):
                for d in range(nd):
                    bin_used[b][d] += req[d]
                bin_items[b].append(i)
                dfs(pos + 1, cost)
                bin_items[b].pop()
                for d in range(nd):
                    bin_used[b][d] -= req[d]

        # 2) open a new bin of each compatible choice (cheapest first)
        compat = sorted(item.compatible(), key=lambda c: problem.choices[c].price)
        for c in compat:
            req = item.requirements[c]
            ch = problem.choices[c]
            if not fits(req, [0.0] * nd, ch.capacity):
                continue
            child_lb = 0.0
            for d in range(nd):
                cap = ch.capacity[d]
                extra = ch.price * (cap - req[d]) / cap if cap > 0 else 0.0
                child_lb = max(child_lb, suff[pos + 1][d] - credit[d] - extra)
            if cost + ch.price + max(child_lb, 0.0) >= best_cost - 1e-9:
                continue
            bin_choice.append(c)
            bin_used.append(list(req))
            bin_items.append([i])
            dfs(pos + 1, cost + ch.price)
            bin_choice.pop()
            bin_used.pop()
            bin_items.pop()

    dfs(0, 0.0)
    stats.wall_s = time.monotonic() - t0
    stats.optimal = not aborted[0]

    if best_bins is None:
        raise Infeasible("no feasible assignment exists")
    sol = Solution(bins=[b for b in best_bins if b.items], cost=best_cost,
                   optimal=stats.optimal,
                   note="bnb" if stats.optimal else "bnb(budget hit; incumbent)")
    return sol, stats


def brute_force(problem: Problem, max_items: int = 7) -> Solution:
    """Exhaustive reference for property tests (tiny inputs only)."""
    n = len(problem.items)
    if n > max_items:
        raise ValueError("brute_force is for tiny instances")
    best: Optional[Solution] = None

    bin_choice: list[int] = []
    bin_used: list[list[float]] = []
    bin_items: list[list[int]] = []

    def rec(i: int, cost: float) -> None:
        nonlocal best
        if best is not None and cost >= best.cost - 1e-9:
            return
        if i == n:
            bins = [Bin(bin_choice[b], list(bin_items[b])) for b in range(len(bin_choice))]
            best = Solution(bins=bins, cost=cost, optimal=True, note="brute")
            return
        item = problem.items[i]
        for b in range(len(bin_choice)):
            req = item.requirements[bin_choice[b]]
            if req is None:
                continue
            if fits(req, bin_used[b], problem.choices[bin_choice[b]].capacity):
                for d in range(problem.ndim):
                    bin_used[b][d] += req[d]
                bin_items[b].append(i)
                rec(i + 1, cost)
                bin_items[b].pop()
                for d in range(problem.ndim):
                    bin_used[b][d] -= req[d]
        for c in item.compatible():
            req = item.requirements[c]
            ch = problem.choices[c]
            if not fits(req, [0.0] * problem.ndim, ch.capacity):
                continue
            bin_choice.append(c)
            bin_used.append(list(req))
            bin_items.append([i])
            rec(i + 1, cost + ch.price)
            bin_choice.pop()
            bin_used.pop()
            bin_items.pop()

    rec(0, 0.0)
    if best is None:
        raise Infeasible("no feasible assignment exists")
    return best

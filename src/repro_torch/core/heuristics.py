"""Greedy heuristics: first-fit-decreasing and cheapest-instance-first (ARMVAC core).

These provide (a) the incumbent for the exact branch-and-bound solver and
(b) the paper's greedy baselines.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.core.packing import (
    Bin, Choice, Infeasible, Item, Problem, Solution, fits,
)


def _norm_size(problem: Problem, item: Item) -> float:
    """Item size for the decreasing order: max normalized dim over the item's
    *cheapest-per-unit* compatible choice (standard l_inf FFD for VBP)."""
    best = 0.0
    any_ok = False
    for c in item.compatible():
        any_ok = True
        req = item.requirements[c]
        cap = problem.choices[c].capacity
        frac = max((r / k if k > 0 else (0.0 if r <= 0 else float("inf")))
                   for r, k in zip(req, cap))
        best = max(best, frac)
    if not any_ok:
        raise Infeasible(f"item {item.key} has no compatible choice")
    return best


def _cost_efficiency(problem: Problem, choice_idx: int, remaining_items: list[int]) -> float:
    """Price per unit of 'how many of the remaining items this choice could hold'
    — a greedy desirability score (lower is better)."""
    ch = problem.choices[choice_idx]
    count = 0
    used = [0.0] * problem.ndim
    for i in remaining_items:
        req = problem.items[i].requirements[choice_idx]
        if req is None:
            continue
        if fits(req, used, ch.capacity):
            used = [u + r for u, r in zip(used, req)]
            count += 1
    if count == 0:
        return float("inf")
    return ch.price / count


def ffd_pack_into(problem: Problem, bins: list[Bin],
                  bin_used: list[list[float]], items) -> None:
    """First-fit the given item indices (decreasing norm-size order) into
    ``bins``/``bin_used`` (mutated in place; new bins append), opening a new
    bin by the lowest price-per-held-items rule when nothing fits. Shared by
    :func:`first_fit_decreasing` (empty seed) and the repair planner's delta
    pass (seeded with the kept bins, so residual capacity fills first).

    Problems built by the packed (columnwise) ``build_problem`` path carry
    class-structured arrays and dispatch to the vectorized packer in
    :mod:`repro_torch.core.packed`, which produces bit-identical bins (see
    tests/test_packed_parity.py); hand-built problems take the scalar loop
    below.
    """
    from repro_torch.core import packed as _packed
    pp = _packed.get_packed(problem)
    if pp is not None:
        _packed.ffd_pack_packed(problem, pp, bins, bin_used, items)
        return
    _ffd_pack_into_scalar(problem, bins, bin_used, items)


def _ffd_pack_into_scalar(problem: Problem, bins: list[Bin],
                          bin_used: list[list[float]], items) -> None:
    """The original per-item FFD loop — the parity/speedup baseline."""
    order = sorted(items, key=lambda i: _norm_size(problem, problem.items[i]),
                   reverse=True)
    for pos, i in enumerate(order):
        item = problem.items[i]
        placed = False
        for b, used in zip(bins, bin_used):
            req = item.requirements[b.choice]
            if req is None:
                continue
            if fits(req, used, problem.choices[b.choice].capacity):
                b.items.append(i)
                for k in range(problem.ndim):
                    used[k] += req[k]
                placed = True
                break
        if not placed:
            rest = order[pos:]
            cands = item.compatible()
            if not cands:
                raise Infeasible(f"item {item.key} has no compatible choice")
            c = min(cands, key=lambda c: (_cost_efficiency(problem, c, rest),
                                          problem.choices[c].price))
            if _cost_efficiency(problem, c, rest) == float("inf"):
                raise Infeasible(f"item {item.key} fits no empty instance")
            bins.append(Bin(choice=c, items=[i]))
            bin_used.append(list(item.requirements[c]))


def first_fit_decreasing(problem: Problem) -> Solution:
    """FFD over items; for each item try open bins, else open the bin whose
    price-per-held-items is lowest among compatible choices."""
    bins: list[Bin] = []
    bin_used: list[list[float]] = []
    ffd_pack_into(problem, bins, bin_used, range(len(problem.items)))
    cost = sum(problem.choices[b.choice].price for b in bins)
    return Solution(bins=bins, cost=cost, optimal=False, note="ffd")


def lowest_price_first(problem: Problem) -> Solution:
    """The paper's literal ARMVAC packing rule [6,8]: "selects the lowest-cost
    instances from the remaining pool, and sends as many data streams to this
    instance" — i.e. pick the instance with the lowest *hourly price* that can
    still hold at least one remaining stream, fill it, repeat. This is exactly
    why ARMVAC underperforms in the 1–20 fps mid-band: it keeps renting cheap
    small instances where one bigger/GPU instance is cheaper per stream.
    """
    remaining = sorted(range(len(problem.items)),
                       key=lambda i: _norm_size(problem, problem.items[i]),
                       reverse=True)
    bins: list[Bin] = []
    cost = 0.0
    by_price = sorted(range(len(problem.choices)),
                      key=lambda c: (problem.choices[c].price, problem.choices[c].key))
    while remaining:
        chosen = None
        for c in by_price:
            ch = problem.choices[c]
            if any(problem.items[i].requirements[c] is not None and
                   fits(problem.items[i].requirements[c], [0.0] * problem.ndim,
                        ch.capacity)
                   for i in remaining):
                chosen = c
                break
        if chosen is None:
            raise Infeasible(f"no choice can hold any of {len(remaining)} remaining streams")
        ch = problem.choices[chosen]
        b = Bin(choice=chosen)
        used = [0.0] * problem.ndim
        still: list[int] = []
        for i in remaining:
            req = problem.items[i].requirements[chosen]
            if req is not None and fits(req, used, ch.capacity):
                b.items.append(i)
                for k in range(problem.ndim):
                    used[k] += req[k]
            else:
                still.append(i)
        bins.append(b)
        cost += ch.price
        remaining = still
    return Solution(bins=bins, cost=cost, optimal=False, note="lowest-price-first")


def cheapest_instance_first(problem: Problem) -> Solution:
    """ARMVAC's packing core [6,8]: repeatedly pick the most cost-efficient
    choice for the remaining streams, open one instance of it, and push as many
    remaining streams into it as fit (in decreasing size order)."""
    remaining = sorted(range(len(problem.items)),
                       key=lambda i: _norm_size(problem, problem.items[i]),
                       reverse=True)
    bins: list[Bin] = []
    cost = 0.0
    while remaining:
        best_c = min(range(len(problem.choices)),
                     key=lambda c: (_cost_efficiency(problem, c, remaining),
                                    problem.choices[c].price))
        if _cost_efficiency(problem, best_c, remaining) == float("inf"):
            raise Infeasible(f"no choice can hold any of {len(remaining)} remaining streams")
        ch = problem.choices[best_c]
        b = Bin(choice=best_c)
        used = [0.0] * problem.ndim
        still: list[int] = []
        for i in remaining:
            req = problem.items[i].requirements[best_c]
            if req is not None and fits(req, used, ch.capacity):
                b.items.append(i)
                for k in range(problem.ndim):
                    used[k] += req[k]
            else:
                still.append(i)
        bins.append(b)
        cost += ch.price
        remaining = still
    return Solution(bins=bins, cost=cost, optimal=False, note="cheapest-first")

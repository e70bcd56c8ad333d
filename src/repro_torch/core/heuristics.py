"""First-fit-decreasing, the incumbent of the exact solver: the port's copy
of ``repro.core.heuristics.first_fit_decreasing`` and the scalar packing
loop behind it."""
from __future__ import annotations

from repro_torch.core.packing import Bin, Infeasible, Item, Problem, Solution, fits


def _norm_size(problem: Problem, item: Item) -> float:
    """Item size for the decreasing order: max normalized dim over the
    item's compatible choices (standard l_inf FFD for VBP)."""
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
    """Price per unit of 'how many of the remaining items this choice could
    hold' — a greedy desirability score (lower is better)."""
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


def _ffd_pack_into_scalar(problem: Problem, bins: list[Bin],
                          bin_used: list[list[float]], items) -> None:
    """First-fit the given items (decreasing norm-size order) into
    ``bins``/``bin_used`` (mutated in place; new bins append), opening a
    new bin by the lowest price-per-held-items rule when nothing fits."""
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
    _ffd_pack_into_scalar(problem, bins, bin_used, range(len(problem.items)))
    cost = sum(problem.choices[b.choice].price for b in bins)
    return Solution(bins=bins, cost=cost, optimal=False, note="ffd")

"""Problem definition for multi-dimensional multiple-choice vector bin
packing: the port's copy of ``repro.core.packing`` with its scalar
``validate`` (the columnwise fast path of the reference is not needed by
the H100 planner's problems).

Items (streams) must each be assigned to exactly one bin. A bin is an
instance of a *choice* = (instance type, location); each choice has a usable
capacity vector (after the 90% head-room rule) and an hourly price. The
requirement vector of an item may differ per choice and may be None
(incompatible). Objective: minimize total hourly price.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

EPS = 1e-9


@dataclasses.dataclass(frozen=True)
class Choice:
    """One (instance type, location) option with its usable (90%-capped)
    capacity and its $/hour price."""

    key: str                      # e.g. "h100-8@us-east"
    type_name: str
    location: str
    capacity: tuple[float, ...]   # usable capacity (90%-capped)
    price: float                  # $/hour at this location
    has_gpu: bool = False


@dataclasses.dataclass(frozen=True)
class Item:
    """One stream; requirements[c] is its vector under choice c (None = incompatible)."""

    key: str
    requirements: tuple[Optional[tuple[float, ...]], ...]

    def compatible(self) -> list[int]:
        return [c for c, r in enumerate(self.requirements) if r is not None]


@dataclasses.dataclass(frozen=True)
class Problem:
    """One multiple-choice vector bin-packing instance: every item must land
    on exactly one bin of some choice, minimizing the summed $/hour."""

    choices: tuple[Choice, ...]
    items: tuple[Item, ...]

    def __post_init__(self) -> None:
        dims = {len(c.capacity) for c in self.choices}
        if len(dims) > 1:
            raise ValueError("inconsistent capacity dimensionality")
        (d,) = dims or {0}
        # items of one class share one requirements tuple: check each once
        seen: set[int] = set()
        for it in self.items:
            if id(it.requirements) in seen:
                continue
            seen.add(id(it.requirements))
            if len(it.requirements) != len(self.choices):
                raise ValueError(f"item {it.key}: requirements must align with choices")
            for r in it.requirements:
                if r is not None and len(r) != d:
                    raise ValueError(f"item {it.key}: bad vector length")

    @property
    def ndim(self) -> int:
        return len(self.choices[0].capacity)


@dataclasses.dataclass
class Bin:
    """An opened instance: which choice it is and what is packed inside."""

    choice: int
    items: list[int] = dataclasses.field(default_factory=list)

    def used(self, problem: Problem) -> tuple[float, ...]:
        d = problem.ndim
        tot = [0.0] * d
        for i in self.items:
            r = problem.items[i].requirements[self.choice]
            if r is None:
                raise ValueError(f"item {i} is incompatible with its bin")
            for k in range(d):
                tot[k] += r[k]
        return tuple(tot)


@dataclasses.dataclass
class Solution:
    """An assignment of every item to a bin; ``cost`` is the total rental
    price in $/hour. ``optimal`` marks exact-solver proofs."""

    bins: list[Bin]
    cost: float                   # $/hour
    optimal: bool = False
    note: str = ""

    def instance_counts(self, problem: Problem) -> dict[str, int]:
        out: dict[str, int] = {}
        for b in self.bins:
            k = problem.choices[b.choice].key
            out[k] = out.get(k, 0) + 1
        return out


class Infeasible(Exception):
    """No assignment exists."""


def validate(problem: Problem, sol: Solution) -> None:
    """Raise AssertionError unless every item is placed exactly once in a
    compatible bin, no bin is over capacity, and the cost adds up."""
    seen: set[int] = set()
    cost = 0.0
    for b in sol.bins:
        ch = problem.choices[b.choice]
        cost += ch.price
        for i in b.items:
            if i in seen:
                raise AssertionError(f"item {i} assigned twice")
            seen.add(i)
            if problem.items[i].requirements[b.choice] is None:
                raise AssertionError(f"item {i} incompatible with {ch.key}")
        used = b.used(problem)
        for k in range(problem.ndim):
            if used[k] > ch.capacity[k] + 1e-6:
                raise AssertionError(
                    f"bin {ch.key} overfull in dim {k}: {used[k]} > {ch.capacity[k]}")
    if seen != set(range(len(problem.items))):
        raise AssertionError(f"items not covered: {set(range(len(problem.items))) - seen}")
    if abs(cost - sol.cost) > 1e-6:
        raise AssertionError(f"cost mismatch: {cost} vs {sol.cost}")


def fits(req: Sequence[float], used: Sequence[float], cap: Sequence[float]) -> bool:
    return all(u + r <= c + EPS for r, u, c in zip(req, used, cap))

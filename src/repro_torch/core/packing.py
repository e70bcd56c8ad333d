"""Problem definition for multi-dimensional multiple-choice vector bin packing.

Items (streams) must each be assigned to exactly one bin. A bin is an instance
of a *choice* = (instance type, location); each choice has a usable capacity
vector (after the 90% head-room rule) and an hourly price. The requirement
vector of an item may differ per choice (CPU vs GPU execution profile) and may
be None (incompatible: program needs a GPU, or the camera's RTT circle
excludes the location). Objective: minimize total hourly price.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

EPS = 1e-9


@dataclasses.dataclass(frozen=True)
class Choice:
    """One (instance type, location) option — a truck model in the analogy.

    ``capacity`` is the usable (90%-capped) vector in the catalog's
    dimension units (cores, GiB, GPU fraction, GPU GiB for the paper
    catalogs; the H100 catalog names its own); ``price`` is $/hour.
    """

    key: str                      # e.g. "g2.2xlarge@us-east-1"
    type_name: str
    location: str
    capacity: tuple[float, ...]   # usable capacity (90%-capped)
    price: float                  # $/hour at this location
    has_gpu: bool = False         # carried from the catalog's InstanceType
    market: str = "ondemand"      # "ondemand", or "spot" for the market
                                  # twins built by core.markets (same
                                  # capacity, spot-walk price, reclaimable)


@dataclasses.dataclass(frozen=True)
class Item:
    """One stream; requirements[c] is its vector under choice c (None = incompatible)."""

    key: str
    requirements: tuple[Optional[tuple[float, ...]], ...]

    def compatible(self) -> list[int]:
        return [c for c, r in enumerate(self.requirements) if r is not None]


@dataclasses.dataclass(frozen=True)
class Problem:
    """One multiple-choice vector bin-packing instance: every item (stream)
    must land on exactly one bin (instance) of some choice, minimizing the
    summed $/hour price. Problems built by the packed ``build_problem``
    carry columnwise arrays (see :mod:`repro_torch.core.packed`) as a non-field
    attribute; the object API is unaffected."""

    choices: tuple[Choice, ...]
    items: tuple[Item, ...]

    def __post_init__(self) -> None:
        dims = {len(c.capacity) for c in self.choices}
        if len(dims) > 1:
            raise ValueError("inconsistent capacity dimensionality")
        (d,) = dims or {0}
        # the packed builder shares one requirements tuple across all items
        # of a class — validating each distinct tuple once keeps construction
        # O(classes x choices), not O(items x choices). A lazy item sequence
        # (packed._PackedItemSeq) hands us the per-class tuples directly so
        # no item object needs to exist at all.
        distinct = getattr(self.items, "distinct_requirements", None)
        if distinct is not None:
            for g, reqs in enumerate(distinct()):
                if len(reqs) != len(self.choices):
                    raise ValueError(
                        f"class {g}: requirements must align with choices")
                for r in reqs:
                    if r is not None and len(r) != d:
                        raise ValueError(f"class {g}: bad vector length")
            return
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
            assert r is not None
            for k in range(d):
                tot[k] += r[k]
        return tuple(tot)

    def residual(self, problem: Problem) -> tuple[float, ...]:
        """Capacity left in this bin (per dimension): what the repair
        planner's delta pass fills before opening new instances. Never
        negative (beyond float noise) in a valid solution."""
        cap = problem.choices[self.choice].capacity
        return tuple(c - u for c, u in zip(cap, self.used(problem)))


@dataclasses.dataclass
class Solution:
    """An assignment of every item to a bin; ``cost`` is the total rental
    price in $/hour. ``optimal`` marks exact-solver proofs (heuristics and
    repaired plans leave it False)."""

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
    """No assignment exists (e.g. Fig. 3 scenario 3 under CPU-only strategy)."""


def validate(problem: Problem, sol: Solution) -> None:
    """Assert solution invariants: coverage, capacity, cost accounting.

    Problems carrying packed arrays are checked with a handful of numpy
    passes (identical invariants, same 1e-6 tolerances) — the per-item loop
    below is O(N x D) Python work per replan, which at a million streams
    would dwarf the packing itself."""
    if getattr(problem, "packed", None) is not None:
        _validate_packed(problem, sol)
        return
    seen: set[int] = set()
    cost = 0.0
    for b in sol.bins:
        ch = problem.choices[b.choice]
        cost += ch.price
        used = b.used(problem)
        for k in range(problem.ndim):
            if used[k] > ch.capacity[k] + 1e-6:
                raise AssertionError(
                    f"bin {ch.key} overfull in dim {k}: {used[k]} > {ch.capacity[k]}")
        for i in b.items:
            if i in seen:
                raise AssertionError(f"item {i} assigned twice")
            seen.add(i)
            if problem.items[i].requirements[b.choice] is None:
                raise AssertionError(f"item {i} incompatible with {ch.key}")
    if seen != set(range(len(problem.items))):
        raise AssertionError(f"items not covered: {set(range(len(problem.items))) - seen}")
    if abs(cost - sol.cost) > 1e-6:
        raise AssertionError(f"cost mismatch: {cost} vs {sol.cost}")


def _validate_packed(problem: Problem, sol: Solution) -> None:
    """Vectorized :func:`validate` over the problem's packed arrays."""
    import numpy as np

    pp = problem.packed                       # attached by the packed builder
    n_items = len(pp.item_class)
    bins = sol.bins
    nb = len(bins)
    lengths = np.fromiter((len(b.items) for b in bins),
                          dtype=np.int64, count=nb)
    total = int(lengths.sum()) if nb else 0
    flat = np.fromiter((i for b in bins for i in b.items),
                       dtype=np.int64, count=total)
    binc = np.fromiter((b.choice for b in bins), dtype=np.int64, count=nb)
    item_bin = np.repeat(np.arange(nb, dtype=np.int64), lengths)

    counts = np.bincount(flat, minlength=n_items) if total \
        else np.zeros(n_items, dtype=np.int64)
    if (counts > 1).any():
        raise AssertionError(
            f"item {int(np.argmax(counts > 1))} assigned twice")
    if (counts == 0).any():
        missing = set(np.flatnonzero(counts == 0).tolist())
        raise AssertionError(f"items not covered: {missing}")

    if total:
        cls = pp.item_class[flat]
        ch = binc[item_bin]
        compat = pp.class_compat[cls, ch]
        if not compat.all():
            k = int(np.argmin(compat))
            key = problem.choices[int(ch[k])].key
            raise AssertionError(
                f"item {int(flat[k])} incompatible with {key}")
        reqv = pp.class_req[cls, ch]          # (total, D)
        D = pp.ndim
        used = np.empty((nb, D))
        for d in range(D):
            used[:, d] = np.bincount(item_bin, weights=reqv[:, d],
                                     minlength=nb)
        cap = pp.capacity[binc]
        over = used > cap + 1e-6
        if over.any():
            b, d = np.unravel_index(int(np.argmax(over)), over.shape)
            raise AssertionError(
                f"bin {problem.choices[int(binc[b])].key} overfull in dim "
                f"{int(d)}: {used[b, d]} > {cap[b, d]}")
    cost = float(np.sum(pp.prices[binc])) if nb else 0.0
    if abs(cost - sol.cost) > 1e-6:
        raise AssertionError(f"cost mismatch: {cost} vs {sol.cost}")


def fits(req: Sequence[float], used: Sequence[float], cap: Sequence[float]) -> bool:
    return all(u + r <= c + EPS for r, u, c in zip(req, used, cap))


def residuals(problem: Problem, bins: Sequence[Bin]) -> list[tuple[float, ...]]:
    """Residual capacity vector of every bin, in bin order."""
    return [b.residual(problem) for b in bins]

"""Spot markets and mixed on-demand/spot planning (BEYOND-PAPER).

The paper buys every instance at the posted on-demand price. Real clouds
also run a *spot* market per region: the same instance at a fluctuating
discount, reclaimable whenever the market price rises above the renter's
bid. This module models the market side in core terms — no simulator
imports — so the planner can price risk:

* :class:`MarketQuote` — one (instance type, location, market) offer:
  the price you pay now, the on-demand reference price, and the walk
  volatility, from which bid-vs-price preemption risk is derived
  (``preempt_probability``: the chance the next lognormal price step ends
  above the bid).
* :func:`quotes` — the quote sheet for a catalog given current per-region
  spot multipliers (the simulator's price walk, or any observed prices).
* :func:`mixed_plan` — preemption-aware packing producing *mixed* plans:
  every stream class keeps an **on-demand floor** (``floor_frac`` of its
  members on reclaim-proof capacity) while the rest may ride spot, under an
  **anti-affinity rule**: no two replicas of one stream may sit on the same
  spot market, so a single market reclaim never takes a whole replica group
  down. Replans are min-migration repairs of the previous mixed plan (kept
  placements stay put, only the delta re-packs) with the same defrag escape
  hatch as :mod:`repro_torch.core.repair`.

A mixed plan is an ordinary :class:`~repro_torch.core.strategies.Plan` whose
problem carries twin choices per (type, location): the on-demand choice at
the catalog price and a ``...!spot`` choice at the current spot price, with
``Choice.market`` telling the cluster which market to rent each bin on.
Because the mixed packer never costs spot above on-demand and falls back to
the pure on-demand packing whenever that is cheaper, a mixed plan's $/hour
cost never exceeds the on-demand-only plan's (property-tested in
``tests/test_markets_properties.py``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Mapping, Optional, Sequence

import numpy as np

from repro_torch.core.catalog import Catalog
from repro_torch.core.heuristics import _norm_size
from repro_torch.core.packing import (EPS, Bin, Infeasible, Problem, Solution,
                                fits, validate)
from repro_torch.core.strategies import Plan, build_problem
from repro_torch.core.workload import Stream

# Canonical market names; the simulator's cluster re-exports these.
ONDEMAND = "ondemand"
SPOT = "spot"

# Spot twin of choice "type@loc" is keyed "type@loc!spot" — "!" cannot occur
# in a type name or region id, so keys stay unambiguous across ticks.
SPOT_KEY_SUFFIX = "!spot"


def _phi(z: float) -> float:
    """Standard normal CDF."""
    return 0.5 * (1.0 + math.erf(z / math.sqrt(2.0)))


# ---------------------------------------------------------------------------
# Quotes
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MarketQuote:
    """One (instance type, location) offer on one market.

    ``price`` is the $/hour you pay *now* (the on-demand list price, or the
    current spot price); ``ondemand_price`` is always the list-price
    reference. ``volatility`` is the per-sqrt-hour sigma of the lognormal
    price step, from which the bid-vs-price preemption hazard derives: a
    spot instance is reclaimed exactly when the market price ends a step
    above its bid.
    """

    type_name: str
    location: str
    market: str                   # ONDEMAND or SPOT
    price: float                  # $/hour paid now
    ondemand_price: float         # $/hour list-price reference
    volatility: float = 0.15      # lognormal step sigma per sqrt(hour)

    @property
    def key(self) -> str:
        base = f"{self.type_name}@{self.location}"
        return base + (SPOT_KEY_SUFFIX if self.market == SPOT else "")

    def margin(self, bid: float) -> float:
        """Bid head-room over the current price (bid/price - 1)."""
        return bid / self.price - 1.0 if self.price > 0 else math.inf

    def _sigma(self, dt_h: float) -> float:
        return self.volatility * math.sqrt(max(dt_h, 1e-9))

    def preempt_probability(self, bid: float, dt_h: float = 1.0) -> float:
        """P(next price step ends above ``bid``) — the per-interval hazard
        as a function of the bid-vs-price margin. Zero margin means ~50%
        (the walk is symmetric in log space); large margins decay like the
        normal tail."""
        if self.market != SPOT:
            return 0.0
        if bid <= 0:
            return 1.0
        s = self._sigma(dt_h)
        return 1.0 - _phi(math.log(bid / self.price) / s)

    def expected_payment(self, bid: float, dt_h: float = 1.0) -> float:
        """E[next price | not reclaimed]: what surviving the interval is
        expected to cost per hour. Grows slowly with the bid — the classic
        reason high bids are cheap insurance on spot markets."""
        if self.market != SPOT:
            return self.price
        if bid <= 0:
            return self.price
        s = self._sigma(dt_h)
        z = math.log(bid / self.price) / s
        p_survive = _phi(z)
        if p_survive <= 1e-12:
            return self.price
        # E[P * 1{P <= bid}] for lognormal P = price * exp(N(0, s^2))
        truncated_mean = (self.price * math.exp(0.5 * s * s)
                          * _phi(z - s))
        return truncated_mean / p_survive

    def effective_price(self, bid: float, dt_h: float = 1.0,
                        preempt_penalty: float = 0.0) -> float:
        """Risk-adjusted $/hour of renting on this quote at ``bid``:
        expected payment while alive, plus — on reclaim — falling back to
        on-demand for the interval and eating ``preempt_penalty`` dollars
        of boot-window SLO loss."""
        if self.market != SPOT:
            return self.price
        p = self.preempt_probability(bid, dt_h)
        return ((1.0 - p) * self.expected_payment(bid, dt_h)
                + p * (self.ondemand_price + preempt_penalty))


def quotes(catalog: Catalog, multipliers: Mapping[str, float],
           *, volatility: float = 0.15) -> list[MarketQuote]:
    """The quote sheet: one on-demand quote per catalog (type, location),
    plus a spot quote wherever ``multipliers`` prices that region (spot
    price = list price x the region's current spot/on-demand multiplier)."""
    out: list[MarketQuote] = []
    for t, loc, price in catalog.choices():
        out.append(MarketQuote(t.name, loc, ONDEMAND, price, price,
                               volatility))
        m = multipliers.get(loc)
        if m is not None:
            out.append(MarketQuote(t.name, loc, SPOT, price * m, price,
                                   volatility))
    return out


# ---------------------------------------------------------------------------
# Replica groups and the anti-affinity invariant
# ---------------------------------------------------------------------------


def replica_group(stream_key: str, sep: str = "#") -> str:
    """The replica group of a stream key: ``cam-3#1`` -> ``cam-3``. Streams
    without the separator are singleton groups (trivially anti-affine)."""
    return stream_key.split(sep, 1)[0]


def spot_affinity_violations(plan: Plan, sep: str = "#") -> list[tuple]:
    """(group, location) pairs hosting two or more of a group's replicas on
    one spot market — empty iff the anti-affinity invariant holds."""
    count: dict[tuple[str, str], int] = {}
    for b in plan.solution.bins:
        ch = plan.problem.choices[b.choice]
        if getattr(ch, "market", ONDEMAND) != SPOT:
            continue
        for i in b.items:
            g = replica_group(plan.problem.items[i].key, sep)
            k = (g, ch.location)
            count[k] = count.get(k, 0) + 1
    return [k for k, n in sorted(count.items()) if n > 1]


# ---------------------------------------------------------------------------
# Mixed on-demand/spot packing
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MixedConfig:
    """Knobs for mixed planning.

    ``floor_frac``: fraction of every stream class kept on on-demand
    capacity (the reclaim-proof floor); the remainder is spot-eligible
    burst. ``class_fn`` buckets streams into classes (default: program x
    camera). ``replica_sep`` splits replica groups out of stream ids for
    the anti-affinity rule. ``defrag_ratio`` is the repair escape hatch:
    adopt a fresh mixed plan when the repaired one costs at least this
    multiple of it (``None`` never defrags).
    """

    floor_frac: float = 0.5
    class_fn: Optional[Callable[[Stream], tuple]] = None
    replica_sep: str = "#"
    defrag_ratio: Optional[float] = 1.25

    def stream_class(self, s: Stream) -> tuple:
        if self.class_fn is not None:
            return self.class_fn(s)
        return (s.program.name, s.camera)


@dataclasses.dataclass(frozen=True)
class MixedResult:
    """A mixed plan plus the repair ledger and the on-demand reference."""

    plan: Plan
    migrations: int              # streams whose bin differs from their old one
    evicted: int
    arrivals: int
    departures: int
    kept: int
    defrag: bool = False
    ondemand_cost: Optional[float] = None   # fresh on-demand-only $/hour


def spot_problem(streams: Sequence[Stream], catalog: Catalog,
                 multipliers: Mapping[str, float]) -> Problem:
    """The augmented packing problem: the ordinary (RTT-filtered) on-demand
    problem plus a spot twin of every choice whose region has a spot
    multiplier, priced at the current spot price. Item requirement tuples
    are extended preserving the packed builder's class sharing (see
    :func:`repro_torch.core.packed.augment_problem_with_spot`)."""
    from repro_torch.core import packed as packed_mod
    rtt = any(s.camera is not None for s in streams)
    base = build_problem(streams, catalog, rtt_filter=rtt)
    return packed_mod.augment_problem_with_spot(base, multipliers)


def _floor_spot_eligible(streams: Sequence[Stream],
                         config: MixedConfig) -> set[int]:
    """Item indices allowed on spot: everything past each class's on-demand
    floor. Within a class the floor takes the lexicographically first
    stream ids, so the floor/burst split is deterministic and stable across
    ticks for a stable fleet."""
    by_class: dict[tuple, list[int]] = {}
    for i, s in enumerate(streams):
        by_class.setdefault(config.stream_class(s), []).append(i)
    spot_ok: set[int] = set()
    for members in by_class.values():
        members.sort(key=lambda i: streams[i].stream_id)
        floor = math.ceil(config.floor_frac * len(members))
        spot_ok.update(members[floor:])
    return spot_ok


def _spot_locations(problem: Problem, bins: Sequence[Bin],
                    sep: str) -> dict[str, set[str]]:
    """group -> spot locations already holding one of its replicas."""
    taken: dict[str, set[str]] = {}
    for b in bins:
        ch = problem.choices[b.choice]
        if ch.market != SPOT:
            continue
        for i in b.items:
            g = replica_group(problem.items[i].key, sep)
            taken.setdefault(g, set()).add(ch.location)
    return taken


class _OpeningScorer:
    """Vectorized bin-opening scores for the mixed packer.

    The score of opening one bin of choice ``c`` is price / (how many of
    the remaining items a greedy fill of that bin would hold) — the same
    cost-efficiency rule as ``heuristics._cost_efficiency``, evaluated
    market-aware (a spot choice only counts spot-eligible items; the
    anti-affinity state is deliberately ignored — it is a per-item
    placement constraint, not a capacity one, and the score only ranks
    candidates deterministically).

    The fill is run-compressed: remaining items collapse to requirement
    *classes* (items sharing a requirements tuple **by value**, so the
    packed and scalar problem builders produce identical classes) taken in
    first-appearance order, and per class the copies that still fit come
    closed-form from the residual capacity — one (C, D) numpy pass per
    class instead of a Python fits() per (item, choice). This is what
    makes 1k-stream mixed replanning affordable (see
    ``benchmarks/spot_bidding.py``'s parity + wall-clock gates).
    """

    def __init__(self, problem: Problem, spot_ok: set[int]) -> None:
        self.problem = problem
        class_of_key: dict[tuple, int] = {}
        self.class_of = np.empty(len(problem.items), dtype=np.int64)
        reps: list[int] = []
        for i, it in enumerate(problem.items):
            g = class_of_key.setdefault(it.requirements, len(class_of_key))
            if g == len(reps):
                reps.append(i)
            self.class_of[i] = g
        C, D = len(problem.choices), problem.ndim
        self.req = np.full((len(reps), C, D), np.inf)
        for g, i in enumerate(reps):
            for c, r in enumerate(problem.items[i].requirements):
                if r is not None:
                    self.req[g, c] = r
        self.compat = np.isfinite(self.req).all(axis=2)
        self.capacity = np.array([c.capacity for c in problem.choices])
        self.prices = np.array([c.price for c in problem.choices])
        self.is_spot = np.array([c.market == SPOT for c in problem.choices])
        self.spot_ok = spot_ok

    def scores(self, rest: Sequence[int]) -> np.ndarray:
        """Cost-efficiency of opening one bin of every choice for the
        remaining items (``inf`` where nothing fits)."""
        counts: dict[int, list[float]] = {}     # class -> [total, spot_ok]
        blocks: list[int] = []                  # first-appearance order
        for i in rest:
            g = int(self.class_of[i])
            ent = counts.get(g)
            if ent is None:
                counts[g] = ent = [0.0, 0.0]
                blocks.append(g)
            ent[0] += 1.0
            if i in self.spot_ok:
                ent[1] += 1.0
        C, D = self.capacity.shape
        used = np.zeros((C, D))
        held = np.zeros(C)
        for g in blocks:
            total, n_spot = counts[g]
            n = np.where(self.is_spot, n_spot, total) * self.compat[g]
            if not n.any():
                continue
            req = self.req[g]
            resid = self.capacity + EPS - used
            with np.errstate(divide="ignore", invalid="ignore"):
                kd = np.floor(resid / req)
            kd = np.where(req > 0, kd, np.inf)
            k = np.maximum(np.minimum(kd.min(axis=1), n), 0.0)
            if k.any():
                used += k[:, None] * np.where(np.isfinite(req), req, 0.0)
                held += k
        with np.errstate(divide="ignore"):
            return np.where(held > 0, self.prices / np.maximum(held, 1.0),
                            np.inf)


def _mixed_pack_into(problem: Problem, bins: list[Bin],
                     bin_used: list[list[float]], items: Sequence[int],
                     spot_ok: set[int], sep: str) -> None:
    """First-fit-decreasing with the market rules. Floor items never enter
    spot bins. Spot-eligible items *prefer* the spot market — they first-fit
    over spot bins (and open spot bins) before touching on-demand capacity,
    so the burst actually rides the discount instead of back-filling the
    floor's residuals — under the anti-affinity rule: no spot bin at
    location L takes a second replica of a group already on the L spot
    market. Anything un-spottable (anti-affinity exhausted, no spot quote)
    falls back to on-demand. Mutates ``bins``/``bin_used`` in place (new
    bins append), mirroring ``heuristics.ffd_pack_into``; the fresh-plan
    caller keeps the cheaper of this and the pure on-demand packing, so
    the spot preference can never cost money overall."""
    taken = _spot_locations(problem, bins, sep)
    scorer = _OpeningScorer(problem, spot_ok)
    order = sorted(items, key=lambda i: _norm_size(problem, problem.items[i]),
                   reverse=True)

    def try_bins(i, item, g, market) -> bool:
        g_taken = taken.get(g, set())
        for b, used in zip(bins, bin_used):
            ch = problem.choices[b.choice]
            if ch.market != market:
                continue
            if ch.market == SPOT and ch.location in g_taken:
                continue
            req = item.requirements[b.choice]
            if req is None or not fits(req, used, ch.capacity):
                continue
            b.items.append(i)
            for k in range(problem.ndim):
                used[k] += req[k]
            if ch.market == SPOT:
                taken.setdefault(g, set()).add(ch.location)
            return True
        return False

    def try_open(i, item, g, market, eff) -> bool:
        g_taken = taken.get(g, set())
        cands = [c for c in item.compatible()
                 if problem.choices[c].market == market
                 and (market == ONDEMAND
                      or problem.choices[c].location not in g_taken)]
        if not cands:
            return False
        c = min(cands, key=lambda c: (
            float(eff[c]), problem.choices[c].price, problem.choices[c].key))
        if not math.isfinite(eff[c]):
            return False
        bins.append(Bin(choice=c, items=[i]))
        bin_used.append(list(item.requirements[c]))
        if problem.choices[c].market == SPOT:
            taken.setdefault(g, set()).add(problem.choices[c].location)
        return True

    for pos, i in enumerate(order):
        item = problem.items[i]
        g = replica_group(item.key, sep)
        markets = (SPOT, ONDEMAND) if i in spot_ok else (ONDEMAND,)
        eff = None
        placed = False
        for m in markets:
            if try_bins(i, item, g, m):
                placed = True
                break
            if eff is None:
                eff = scorer.scores(order[pos:])   # one pass per opening
            if try_open(i, item, g, m, eff):
                placed = True
                break
        if not placed:
            if not item.compatible():
                raise Infeasible(f"item {item.key} has no compatible choice")
            raise Infeasible(f"item {item.key} fits no empty instance")


def _pack_fresh(problem: Problem, spot_ok: set[int], sep: str) -> Solution:
    bins: list[Bin] = []
    bin_used: list[list[float]] = []
    _mixed_pack_into(problem, bins, bin_used, range(len(problem.items)),
                     spot_ok, sep)
    cost = sum(problem.choices[b.choice].price for b in bins)
    return Solution(bins=bins, cost=cost, optimal=False, note="mixed-ffd")


def _fresh_mixed(problem: Problem, spot_ok: set[int],
                 sep: str) -> tuple[Solution, float]:
    """Fresh mixed solution and the on-demand-only reference cost. The
    mixed packer falls back to the pure on-demand packing whenever that is
    cheaper, so mixed cost <= on-demand-only cost *by construction* (FFD is
    not monotone in the choice set, so this cannot be assumed)."""
    ondemand = _pack_fresh(problem, set(), sep)
    if not spot_ok:
        return ondemand, ondemand.cost
    mixed = _pack_fresh(problem, spot_ok, sep)
    best = mixed if mixed.cost <= ondemand.cost else ondemand
    return best, ondemand.cost


def mixed_plan(streams: Sequence[Stream], catalog: Catalog,
               multipliers: Mapping[str, float],
               previous: Optional[Plan] = None,
               config: MixedConfig = MixedConfig()) -> MixedResult:
    """Plan (or incrementally repair) a mixed on-demand/spot allocation.

    Fresh plans pack under the floor + anti-affinity rules and keep the
    cheaper of the mixed and pure on-demand packings. With ``previous``,
    replans are min-migration repairs: still-feasible placements stay on
    their bins (and markets), only evicted/arriving streams re-pack over
    residual capacity — at current spot prices — and the defrag escape
    hatch adopts a fresh mixed plan when the repaired cost drifts past
    ``config.defrag_ratio`` times it.
    """
    from repro_torch.core.repair import final_moves, keep_and_evict

    problem = spot_problem(streams, catalog, multipliers)
    spot_ok = _floor_spot_eligible(streams, config)
    sep = config.replica_sep

    if previous is None:
        sol, od_cost = _fresh_mixed(problem, spot_ok, sep)
        validate(problem, sol)
        return MixedResult(plan=Plan(sol, problem, "MIXED"), migrations=0,
                           evicted=0, arrivals=len(streams), departures=0,
                           kept=0, ondemand_cost=od_cost)

    kept, kept_used, origins, old_bin_of, evicted, departures = \
        keep_and_evict(previous, problem)

    # Re-establish the on-demand floor: churn can leave a *floored* stream
    # (not spot-eligible under the current class split) sitting on a kept
    # spot bin — e.g. its class shrank until the floor covers it. Such
    # placements are evicted like any other infeasibility, so the delta
    # pass puts them back on reclaim-proof capacity; spot-eligible members
    # on spot stay put, and the deterministic (lex-first) floor split keeps
    # this a no-op for a stable fleet.
    for n, b in enumerate(kept):
        if problem.choices[b.choice].market != SPOT:
            continue
        floored = [i for i in b.items if i not in spot_ok]
        if not floored:
            continue
        for i in floored:
            b.items.remove(i)
            req = problem.items[i].requirements[b.choice]
            for k in range(problem.ndim):
                kept_used[n][k] -= req[k]
        evicted.extend(floored)
    empties = [n for n, b in enumerate(kept) if not b.items]
    for n in reversed(empties):
        del kept[n], kept_used[n], origins[n]

    placed = {i for b in kept for i in b.items} | set(evicted)
    arrivals = [i for i in range(len(problem.items)) if i not in placed]
    n_kept = sum(len(b.items) for b in kept)

    _mixed_pack_into(problem, kept, kept_used, evicted + arrivals,
                     spot_ok, sep)
    origins.extend([None] * (len(kept) - len(origins)))
    cost = sum(problem.choices[b.choice].price for b in kept)
    sol = Solution(bins=kept, cost=cost, optimal=False, note="mixed-repair")
    validate(problem, sol)

    if config.defrag_ratio is not None:
        fresh, od_cost = _fresh_mixed(problem, spot_ok, sep)
        if cost >= config.defrag_ratio * fresh.cost - 1e-9:
            from repro_torch.core.repair import count_plan_migrations
            validate(problem, fresh)
            fresh_plan = Plan(fresh, problem, "MIXED")
            return MixedResult(
                plan=fresh_plan,
                migrations=count_plan_migrations(previous, fresh_plan),
                evicted=len(evicted), arrivals=len(arrivals),
                departures=departures, kept=n_kept, defrag=True,
                ondemand_cost=od_cost)

    return MixedResult(
        plan=Plan(sol, problem, "MIXED"),
        migrations=final_moves(kept, origins, old_bin_of),
        evicted=len(evicted), arrivals=len(arrivals),
        departures=departures, kept=n_kept)

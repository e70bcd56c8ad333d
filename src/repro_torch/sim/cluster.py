"""Simulated cluster: rented instances, boot delays, and the spot market.

The planner emits a :class:`~repro_torch.core.strategies.Plan` (bins of streams on
(type, location) choices); the cluster is the *physical* side of that plan —
instances take time to boot, keep running until terminated, and, when rented
on the spot market, can be reclaimed mid-tick by a preemption event. Capacity
accounting (instance-hours by region/type/market) feeds the ledger.

Instance state is stored *columnar* (struct-of-arrays): parallel
boot/ready/terminated/price arrays in boot order, with the classic
:class:`SimInstance` dataclass constructed lazily as a cached view at the
API edge (``cluster.instances[iid]``, ``live()``). Billing
(:meth:`Cluster.accrue`) and batch preemptions
(:meth:`Cluster.terminate_batch`) are single numpy passes over the columns,
and :meth:`Cluster.retire` seals long-terminated rows into a per-(location,
type, market) hours aggregate so per-tick work tracks the *live* fleet, not
every instance ever booted. All of it is bit-identical to the historical
per-object loops (tests/test_columnar_parity.py, tests/test_golden_ledgers).
"""
from __future__ import annotations

import dataclasses
import math
from collections.abc import Mapping
from typing import Iterable, Optional

import numpy as np

# canonical market names live in core (the planner labels bins with them)
from repro_torch.core.markets import ONDEMAND, SPOT, SPOT_KEY_SUFFIX
from repro_torch.core.strategies import Plan

_INF = math.inf


@dataclasses.dataclass
class SimInstance:
    """One rented instance over its lifetime in simulated hours."""

    instance_id: str
    type_name: str
    location: str
    price: float                      # on-demand $/h reference price
    market: str = ONDEMAND
    boot_t: float = 0.0               # when the rental started (billing start)
    ready_t: float = 0.0              # boot_t + boot delay (service start)
    terminated_t: Optional[float] = None
    preempted: bool = False
    bid: Optional[float] = None       # spot bid, $/h; None = legacy spot
                                      # (hazard-governed) or on-demand

    def _overlap(self, start: float, t0: float, t1: float) -> float:
        end = self.terminated_t if self.terminated_t is not None else math.inf
        return max(0.0, min(t1, end) - max(t0, start))

    def billed_hours(self, t0: float, t1: float) -> float:
        """Hours billed in [t0, t1): clouds charge from launch, not readiness."""
        return self._overlap(self.boot_t, t0, t1)

    def running_fraction(self, t0: float, t1: float) -> float:
        """Fraction of [t0, t1) the instance could actually serve streams."""
        if t1 <= t0:
            return 0.0
        return self._overlap(self.ready_t, t0, t1) / (t1 - t0)


class SpotMarket:
    """Per-region spot prices as a clamped multiplicative random walk, plus a
    constant preemption hazard for spot instances.

    ``multiplier(region)`` is the current spot/on-demand price ratio. The
    walk is seeded, so the whole price history is a pure function of the
    seed — two runs of a scenario see identical markets. The walk and the
    preemption draws use *separate* generators: the market is exogenous, so
    the price history must not depend on how many instances a policy happens
    to hold (otherwise two policies under one seed would face different
    prices and their ledgers would not be comparable).
    """

    def __init__(self, regions: Iterable[str], *, discount: float = 0.35,
                 volatility: float = 0.15, hazard_per_h: float = 0.08,
                 seed: int = 0, history_limit: Optional[int] = 4096) -> None:
        self.discount = discount
        self.volatility = volatility
        self.hazard_per_h = hazard_per_h
        self._walk = {r: 1.0 for r in sorted(regions)}
        self._rng = np.random.default_rng(seed)
        self._preempt_rng = np.random.default_rng(seed + 7919)
        # multiplier history, one snapshot per step(): the exogenous-prices
        # fixture — two policies under one seed must observe identical
        # series (tests/test_markets_properties.py). Bounded to the most
        # recent ``history_limit`` snapshots so an open-ended run does not
        # grow without bound (None = unbounded; bidding policies only look
        # back a few steps).
        self.history_limit = history_limit
        self.price_history: list[dict[str, float]] = [self.multipliers()]

    def multiplier(self, region: str) -> float:
        return self.discount * self._walk.get(region, 1.0)

    def multipliers(self) -> dict[str, float]:
        """Current spot/on-demand price ratio per region (the planner's
        view of the market; feeds ``core.markets.quotes``)."""
        return {r: self.discount * w for r, w in sorted(self._walk.items())}

    def spot_rate(self, inst: SimInstance) -> float:
        """Current spot $/hour for an instance (list price x multiplier)."""
        return inst.price * self.multiplier(inst.location)

    def step(self, dt_h: float) -> None:
        """Advance every region's price walk by dt hours."""
        sigma = self.volatility * math.sqrt(max(dt_h, 1e-9))
        for r in sorted(self._walk):
            self._walk[r] = float(np.clip(
                self._walk[r] * math.exp(self._rng.normal(0.0, sigma)),
                0.5, 2.5))
        self.price_history.append(self.multipliers())
        if self.history_limit is not None \
                and len(self.price_history) > self.history_limit:
            del self.price_history[:len(self.price_history)
                                   - self.history_limit]

    def draw_preemptions(self, t: float, dt_h: float,
                         spot_instances: Iterable[SimInstance]
                         ) -> list[tuple[float, str]]:
        """(time, instance_id) reclaim events inside [t, t + dt).

        Preemption probability over the interval follows an exponential
        hazard scaled by the price walk: when the region's spot price runs
        hot, reclaims are more likely — the classic spot failure mode.

        Bid-carrying instances are skipped entirely: their reclaims are a
        deterministic function of bid vs price (:meth:`outbid`) and must
        consume no randomness — otherwise how many bids a policy holds
        would shift the preemption draws of the legacy hazard instances,
        breaking ledger comparability across policies under one seed.
        """
        out: list[tuple[float, str]] = []
        for inst in spot_instances:
            if inst.bid is not None:
                continue
            hazard = self.hazard_per_h * self._walk.get(inst.location, 1.0)
            p = 1.0 - math.exp(-hazard * dt_h)
            if self._preempt_rng.random() < p:
                out.append((t + float(self._preempt_rng.uniform(0.0, dt_h)),
                            inst.instance_id))
        return out

    def outbid(self, spot_instances: Iterable[SimInstance]
               ) -> list[str]:
        """Instance ids whose bid the market just rose above.

        The market preempts *exactly* the underwater instances: bid >=
        current spot price means the instance survives the whole interval
        — guaranteed, not probabilistic (property-tested). Deterministic:
        consumes no randomness, so prices and preemption draws stay
        exogenous to the bidding policy."""
        return [inst.instance_id for inst in spot_instances
                if inst.bid is not None
                and self.spot_rate(inst) > inst.bid + 1e-12]


class _InstanceMap(Mapping):
    """Read-only ``{instance_id: SimInstance}`` view over the columns.

    Views are constructed lazily and cached; lifecycle mutations
    (terminate, drain-cancel) update cached views in place, so a held
    reference always reflects the columns. Retired instances disappear."""

    __slots__ = ("_c",)

    def __init__(self, cluster: "Cluster") -> None:
        self._c = cluster

    def __getitem__(self, instance_id: str) -> SimInstance:
        return self._c._view(self._c._row[instance_id])

    def get(self, instance_id: str, default=None):
        row = self._c._row.get(instance_id)
        return self._c._view(row) if row is not None else default

    def __contains__(self, instance_id) -> bool:
        return instance_id in self._c._row

    def __len__(self) -> int:
        return self._c._n

    def __iter__(self):
        return iter(list(self._c._ids))

    def values(self):
        c = self._c
        return [c._view(r) for r in range(c._n)]     # boot order

    def items(self):
        return [(v.instance_id, v) for v in self.values()]


class Cluster:
    """Tracks rented instances and reconciles them against each new plan."""

    def __init__(self, *, boot_delay_h: float = 0.05,
                 spot_fraction: float = 0.0, seed: int = 0,
                 telemetry=None) -> None:
        self.boot_delay_h = boot_delay_h
        self.spot_fraction = spot_fraction
        self._counter = 0
        self._rng = np.random.default_rng(seed)
        # previous stream->instance assignment, in exactly one of two
        # representations (the other is derived lazily at path changes):
        # a dict keyed by stream id (object path), or (ids list, row array)
        # aligned to a StreamColumns id list (columnar path).
        self._prev_assignment: Optional[dict[str, str]] = {}
        self._prev_cols: Optional[tuple[list, np.ndarray]] = None
        # optional obs.TelemetryHub: lifecycle events stream out as metric
        # points (cluster.instance.boot / .terminate); None = zero overhead
        self.telemetry = telemetry

        # -- columnar instance state (boot order; _n rows live in arrays of
        # capacity _cap, grown by doubling) ---------------------------------
        self._n = 0
        self._cap = 64
        self._boot_t = np.zeros(self._cap)
        self._ready = np.zeros(self._cap)
        self._term = np.full(self._cap, _INF)       # inf = never terminated
        self._price = np.zeros(self._cap)
        self._bid = np.full(self._cap, np.nan)      # nan = no bid
        self._preempt = np.zeros(self._cap, dtype=bool)
        self._spot = np.zeros(self._cap, dtype=bool)
        self._loc_c = np.zeros(self._cap, dtype=np.int64)
        self._key_c = np.zeros(self._cap, dtype=np.int64)
        self._ids: list[str] = []
        self._types: list[str] = []
        self._locs: list[str] = []
        self._markets: list[str] = []
        self._bkey: list[str] = []                  # "type@loc" per row
        self._row: dict[str, int] = {}
        self._views: dict[str, SimInstance] = {}
        self._loc_uniq: list[str] = []
        self._loc_of: dict[str, int] = {}
        self._key_uniq: list[tuple[str, str, str]] = []
        self._key_of: dict[tuple[str, str, str], int] = {}
        # sealed aggregate of retired instances: lifetime hours per
        # (location, type, market) — billing already accrued them tick by
        # tick; this keeps capacity reporting whole after rows are dropped
        self.retired_hours: dict[tuple[str, str, str], float] = {}
        self.retired_count = 0

    # -- columnar plumbing ---------------------------------------------------

    def _grow(self) -> None:
        self._cap *= 2
        for name in ("_boot_t", "_ready", "_term", "_price", "_bid",
                     "_preempt", "_spot", "_loc_c", "_key_c"):
            old = getattr(self, name)
            new = np.empty(self._cap, dtype=old.dtype)
            new[:self._n] = old[:self._n]
            if name == "_term":
                new[self._n:] = _INF
            setattr(self, name, new)

    def _view(self, row: int) -> SimInstance:
        iid = self._ids[row]
        v = self._views.get(iid)
        if v is None:
            term = self._term[row]
            bid = self._bid[row]
            v = SimInstance(
                instance_id=iid, type_name=self._types[row],
                location=self._locs[row], price=float(self._price[row]),
                market=self._markets[row], boot_t=float(self._boot_t[row]),
                ready_t=float(self._ready[row]),
                terminated_t=(float(term) if math.isfinite(term) else None),
                preempted=bool(self._preempt[row]),
                bid=(float(bid) if not math.isnan(bid) else None))
            self._views[iid] = v
        return v

    # -- queries -------------------------------------------------------------

    @property
    def instances(self) -> _InstanceMap:
        """``{instance_id: SimInstance}`` — lazy views over the columns."""
        return _InstanceMap(self)

    def live(self) -> list[SimInstance]:
        rows = np.flatnonzero(np.isinf(self._term[:self._n]))
        return [self._view(int(r)) for r in rows]

    def live_spot(self) -> list[SimInstance]:
        n = self._n
        rows = np.flatnonzero(np.isinf(self._term[:n]) & self._spot[:n])
        return [self._view(int(r)) for r in rows]

    def live_count(self) -> int:
        """``len(live())`` without materializing views."""
        return int(np.count_nonzero(np.isinf(self._term[:self._n])))

    def get(self, instance_id: str) -> SimInstance:
        return self._view(self._row[instance_id])

    # -- lifecycle -----------------------------------------------------------

    def _boot_row(self, t: float, choice_key: str, type_name: str,
                  location: str, price: float, market: Optional[str] = None,
                  bid: Optional[float] = None) -> int:
        if market is None:
            # legacy mode: the market is drawn per boot (spot_fraction);
            # market-aware plans pass it explicitly and consume no RNG
            market = SPOT if (self.spot_fraction > 0 and
                              self._rng.random() < self.spot_fraction) \
                else ONDEMAND
        self._counter += 1
        iid = f"{choice_key}#{self._counter}"
        if self._n == self._cap:
            self._grow()
        row = self._n
        self._n += 1
        self._boot_t[row] = t
        self._ready[row] = t + self.boot_delay_h
        self._term[row] = _INF
        self._price[row] = price
        self._bid[row] = np.nan if bid is None else bid
        self._preempt[row] = False
        self._spot[row] = market == SPOT
        loc_code = self._loc_of.get(location)
        if loc_code is None:
            loc_code = len(self._loc_uniq)
            self._loc_of[location] = loc_code
            self._loc_uniq.append(location)
        self._loc_c[row] = loc_code
        key = (location, type_name, market)
        key_code = self._key_of.get(key)
        if key_code is None:
            key_code = len(self._key_uniq)
            self._key_of[key] = key_code
            self._key_uniq.append(key)
        self._key_c[row] = key_code
        self._ids.append(iid)
        self._types.append(type_name)
        self._locs.append(location)
        self._markets.append(market)
        self._bkey.append(f"{type_name}@{location}")
        self._row[iid] = row
        if self.telemetry is not None:
            self.telemetry.emit(t, "cluster.instance.boot", 1.0,
                                instance=iid, type=type_name,
                                location=location, market=market)
        return row

    def _boot(self, t: float, choice_key: str, type_name: str, location: str,
              price: float, market: Optional[str] = None,
              bid: Optional[float] = None) -> SimInstance:
        return self._view(self._boot_row(t, choice_key, type_name, location,
                                         price, market, bid))

    def terminate(self, instance_id: str, t: float,
                  preempted: bool = False) -> None:
        """Schedule termination at ``t`` (which may be in the future, for
        drains). An earlier termination — e.g. a preemption landing during a
        drain — wins; a later one never extends a lifetime."""
        row = self._row[instance_id]
        cur = self._term[row]
        if t < cur:
            first = math.isinf(cur)
            self._term[row] = t
            if preempted:
                self._preempt[row] = True
            v = self._views.get(instance_id)
            if v is not None:
                v.terminated_t = t
                v.preempted = preempted or v.preempted
            if self.telemetry is not None and first:
                self.telemetry.emit(t, "cluster.instance.terminate", 1.0,
                                    instance=instance_id,
                                    type=self._types[row],
                                    location=self._locs[row],
                                    market=self._markets[row],
                                    preempted=str(bool(self._preempt[row])))

    def terminate_batch(self, events) -> list:
        """Apply one tick's preemption batch in event order.

        ``events`` is an iterable of ``(when, instance_id, tag)`` sorted the
        way the old per-event heap would have popped them. An event lands
        only if its target is still alive past ``when`` (the same aliveness
        check the event loop used to make per pop); applied events mark the
        instance preempted. Returns the tags of the applied events, in
        order — the event loop's preemption/outbid counters."""
        applied = []
        term = self._term
        for when, iid, tag in events:
            row = self._row.get(iid)
            if row is None:
                continue
            cur = term[row]
            if cur > when:
                fresh = math.isinf(cur)
                term[row] = when
                self._preempt[row] = True
                v = self._views.get(iid)
                if v is not None:
                    v.terminated_t = when
                    v.preempted = True
                if self.telemetry is not None and fresh:
                    self.telemetry.emit(when, "cluster.instance.terminate",
                                        1.0, instance=iid,
                                        type=self._types[row],
                                        location=self._locs[row],
                                        market=self._markets[row],
                                        preempted="True")
                applied.append(tag)
        return applied

    def _cancel_drain(self, row: int, t: float) -> None:
        """Reclaim a draining instance the new plan matched: cancel the
        scheduled termination instead of booting (and billing) a duplicate
        while the identical lame-duck is still running."""
        if math.isinf(self._term[row]):
            return
        self._term[row] = _INF
        iid = self._ids[row]
        v = self._views.get(iid)
        if v is not None:
            v.terminated_t = None
        if self.telemetry is not None:
            self.telemetry.emit(t, "cluster.instance.undrain", 1.0,
                                instance=iid, type=self._types[row],
                                location=self._locs[row],
                                market=self._markets[row])

    def retire(self, before_t: float) -> Optional[np.ndarray]:
        """Drop rows terminated strictly before ``before_t`` from the
        columns, sealing their lifetime hours into :attr:`retired_hours`.

        The caller (the fleet loop, after accounting [t0, t1) with
        ``before_t = t0``) guarantees nothing still references them: any
        instance a future accounting interval or reconcile vote can touch
        was assigned at some decision time >= t0 and therefore has
        ``terminated_t >= t0``. Billing is unaffected — a row with
        ``terminated_t < t0`` accrues exactly zero in every window from t0
        on. Returns the old->new row remap (-1 = dropped) so callers
        holding row arrays can update them (``_prev_cols`` is remapped in
        place here), or None if nothing was dropped."""
        n = self._n
        if n == 0:
            return None
        term = self._term[:n]
        drop = term < before_t
        if not drop.any():
            return None
        for r in np.flatnonzero(drop).tolist():
            key = (self._locs[r], self._types[r], self._markets[r])
            self.retired_hours[key] = (self.retired_hours.get(key, 0.0)
                                       + float(term[r] - self._boot_t[r]))
            iid = self._ids[r]
            del self._row[iid]
            self._views.pop(iid, None)
        keep = np.flatnonzero(~drop)
        m = int(keep.size)
        for name in ("_boot_t", "_ready", "_term", "_price", "_bid",
                     "_preempt", "_spot", "_loc_c", "_key_c"):
            arr = getattr(self, name)
            arr[:m] = arr[keep]
            if name == "_term":
                arr[m:n] = _INF
        kl = keep.tolist()
        self._ids = [self._ids[r] for r in kl]
        self._types = [self._types[r] for r in kl]
        self._locs = [self._locs[r] for r in kl]
        self._markets = [self._markets[r] for r in kl]
        self._bkey = [self._bkey[r] for r in kl]
        self._row = {iid: k for k, iid in enumerate(self._ids)}
        self.retired_count += int(n - m)
        self._n = m
        remap = np.full(n, -1, dtype=np.int64)
        remap[keep] = np.arange(m, dtype=np.int64)
        if self._prev_cols is not None:
            _, prows = self._prev_cols
            prows[:] = np.where(prows >= 0, remap[np.maximum(prows, 0)], -1)
        return remap

    # -- reconciliation ------------------------------------------------------

    def _candidates_by_key(self, t: float,
                           market_aware: bool) -> dict[str, list[int]]:
        """Rows a plan's bins can match at decision time ``t``, grouped by
        matching key and ordered (boot_t, instance_id) like the historical
        live-instance sort. Includes *draining* rows (terminated_t > t):
        the drain-reclaim fix — a scale-up inside the drain window re-uses
        the lame-duck instead of booting a duplicate."""
        n = self._n
        rows = np.flatnonzero(self._term[:n] > t)
        out: dict[str, list[int]] = {}
        bkey = self._bkey
        spot = self._spot
        for r in rows.tolist():
            key = bkey[r]
            if market_aware and spot[r]:
                key += SPOT_KEY_SUFFIX
            out.setdefault(key, []).append(r)
        boot = self._boot_t
        ids = self._ids
        for rws in out.values():
            rws.sort(key=lambda r: (boot[r], ids[r]))
        return out

    def _prev_rows_for_items(self, problem) -> Optional[np.ndarray]:
        """Per-item previous-instance row (-1 = none), aligned with
        ``problem.items`` — the vote-tally input, from whichever previous
        assignment representation is current."""
        ids = getattr(problem, "packed_ids", None)
        if (self._prev_cols is not None and ids is not None
                and self._prev_cols[0] is ids):
            return self._prev_cols[1]
        prev = self._prev_assignment
        if prev is None and self._prev_cols is not None:
            pids, prows = self._prev_cols
            prev = {}
            own = self._ids
            for sid, r in zip(pids, prows.tolist()):
                if r >= 0:
                    prev[sid] = own[r]
            self._prev_assignment = prev
        if not prev:
            return None
        keys = ids if ids is not None else [it.key for it in problem.items]
        pr = np.full(len(keys), -1, dtype=np.int64)
        row_of = self._row
        for k, sid in enumerate(keys):
            iid = prev.get(sid)
            if iid is not None:
                r = row_of.get(iid)
                if r is not None:
                    pr[k] = r
        return pr

    def _reconcile_impl(self, t: float, plan: Plan, drain_h: float,
                        bids: Optional[dict],
                        pr: Optional[np.ndarray]) -> dict[int, int]:
        """Shared matching core: returns {solution bin index: row}.

        Matching is *sticky*: per (type, location[, market]) key, each bin
        goes to the candidate instance already hosting the most of its
        streams (vote tally over ``pr``, the per-item previous rows), ties
        to earlier bins and older instances; leftovers pair oldest-first;
        missing instances boot; surplus ones drain for ``drain_h``. A
        matched candidate that was draining has its drain canceled."""
        market_aware = bids is not None
        problem = plan.problem
        choices = problem.choices
        ondemand_ref: dict[tuple[str, str], float] = {}
        if market_aware:
            for c in choices:
                if c.market == ONDEMAND:
                    ondemand_ref[(c.type_name, c.location)] = c.price

        bins = plan.solution.bins
        by_key: dict[str, list[int]] = {}
        for bi, b in enumerate(bins):
            by_key.setdefault(choices[b.choice].key, []).append(bi)

        cands = self._candidates_by_key(t, market_aware)

        # vote tally, vectorized over (bin, previous row) pairs: how many of
        # each bin's streams already live on each candidate of its key
        votes_by_key: dict[str, list[tuple[int, int, int]]] = {}
        if pr is not None and bins:
            lengths = np.fromiter((len(b.items) for b in bins),
                                  dtype=np.int64, count=len(bins))
            total = int(lengths.sum())
            if total:
                flat = np.fromiter((i for b in bins for i in b.items),
                                   dtype=np.int64, count=total)
                item_bin = np.repeat(
                    np.arange(len(bins), dtype=np.int64), lengths)
                p = pr[flat]
                ok = p >= 0
                if ok.any():
                    span = np.int64(max(self._n, 1))
                    pairs = item_bin[ok] * span + p[ok]
                    uniq, counts = np.unique(pairs, return_counts=True)
                    bin_local: dict[int, tuple[str, int]] = {}
                    for key, bl in by_key.items():
                        for nn, bi in enumerate(bl):
                            bin_local[bi] = (key, nn)
                    cand_local: dict[int, tuple[str, int]] = {}
                    for key, rws in cands.items():
                        for mm, r in enumerate(rws):
                            cand_local[r] = (key, mm)
                    for pair, c in zip(uniq.tolist(), counts.tolist()):
                        bi, r = divmod(pair, int(span))
                        kb, nn = bin_local[bi]
                        kc = cand_local.get(r)
                        if kc is None or kc[0] != kb:
                            continue
                        votes_by_key.setdefault(kb, []).append((-c, nn, kc[1]))

        bin_row: dict[int, int] = {}
        for key in sorted(by_key):
            bl = by_key[key]
            have = cands.get(key, [])
            votes = votes_by_key.get(key, [])
            votes.sort()
            matched: dict[int, int] = {}
            taken: set[int] = set()
            for _negc, nn, mm in votes:
                if nn in matched or mm in taken:
                    continue
                matched[nn] = have[mm]
                taken.add(mm)
            # leftovers pair oldest-first, then boot
            free = [r for mm, r in enumerate(have) if mm not in taken]
            for nn, bi in enumerate(bl):
                row = matched.get(nn)
                if row is None and free:
                    row = free.pop(0)
                if row is None:
                    ch = choices[bins[bi].choice]
                    if market_aware:
                        ref = ondemand_ref.get((ch.type_name, ch.location),
                                               ch.price)
                        row = self._boot_row(
                            t, ch.key, ch.type_name, ch.location, ref,
                            market=ch.market,
                            bid=(bids.get((ch.type_name, ch.location))
                                 if ch.market == SPOT else None))
                    else:
                        row = self._boot_row(t, ch.key, ch.type_name,
                                             ch.location, ch.price)
                else:
                    self._cancel_drain(row, t)
                bin_row[bi] = row
            for extra in free:
                self.terminate(self._ids[extra], t + drain_h)
        for key, rws in cands.items():
            if key not in by_key:
                for r in rws:
                    self.terminate(self._ids[r], t + drain_h)
        return bin_row

    def reconcile(self, t: float, plan: Plan,
                  drain_h: float = 0.0,
                  bids: Optional[dict] = None) -> dict[str, str]:
        """Make the physical fleet match the plan; map streams to instances.

        Matching is *sticky*: a bin goes to the live instance of its (type,
        location) choice that already hosts the most of its streams (by the
        previous reconcile's assignment), so stable plans produce stable
        placements — a single preemption no longer shifts every later bin of
        that key onto a different machine. Bins and instances left unmatched
        pair up oldest-first, so scale-down still retires the newest rentals.
        Missing instances boot now (ready after the boot delay); surplus ones
        drain for ``drain_h`` before terminating (make-before-break: the old
        placement keeps serving while replacements boot — billed, like any
        lame-duck VM). An instance still *draining* at decision time is a
        match candidate like any live one — matching it cancels the drain
        (no duplicate boot inside the drain window). Returns ``{stream_id:
        instance_id}`` for the ledger.

        ``bids`` switches on market-aware reconciliation for mixed plans
        (bins labeled via ``Choice.market``): instances are matched within
        their market (a spot rental never serves an on-demand bin), spot
        bins boot SPOT instances carrying the policy's ``(type_name,
        location)`` bid, and no boot consumes market RNG. The instance's
        ``price`` stays the on-demand list price — spot billing applies the
        market multiplier at accrual time, and the bid only controls
        reclaims.
        """
        pr = self._prev_rows_for_items(plan.problem)
        bin_row = self._reconcile_impl(t, plan, drain_h, bids, pr)
        ids = getattr(plan.problem, "packed_ids", None)
        items = plan.problem.items
        own = self._ids
        assignment: dict[str, str] = {}
        for bi, b in enumerate(plan.solution.bins):
            iid = own[bin_row[bi]]
            if ids is not None:
                for i in b.items:
                    assignment[ids[i]] = iid
            else:
                for i in b.items:
                    assignment[items[i].key] = iid
        self._prev_assignment = assignment
        self._prev_cols = None
        return assignment

    def reconcile_rows(self, t: float, plan: Plan, stream_ids,
                       drain_h: float = 0.0,
                       bids: Optional[dict] = None) -> np.ndarray:
        """Columnar reconcile: same matching as :meth:`reconcile`, returning
        the per-stream instance *row* array aligned with ``stream_ids``
        (-1 = unplaced) instead of a dict. Requires the plan's problem to
        carry ``packed_ids is stream_ids`` (the packed builder stamps it);
        otherwise it delegates to the object path and converts. The result
        array is also stored as the previous assignment for the next tick's
        vote tally (and is remapped in place by :meth:`retire`)."""
        if getattr(plan.problem, "packed_ids", None) is not stream_ids:
            assignment = self.reconcile(t, plan, drain_h, bids)
            rows = np.full(len(stream_ids), -1, dtype=np.int64)
            row_of = self._row
            for k, sid in enumerate(stream_ids):
                iid = assignment.get(sid)
                if iid is not None:
                    rows[k] = row_of[iid]
            self._prev_cols = (stream_ids, rows)
            return rows
        pr = self._prev_rows_for_items(plan.problem)
        bin_row = self._reconcile_impl(t, plan, drain_h, bids, pr)
        rows = np.full(len(stream_ids), -1, dtype=np.int64)
        bins = plan.solution.bins
        if bins:
            lengths = np.fromiter((len(b.items) for b in bins),
                                  dtype=np.int64, count=len(bins))
            flat = np.fromiter((i for b in bins for i in b.items),
                               dtype=np.int64, count=int(lengths.sum()))
            per_bin = np.fromiter((bin_row[bi] for bi in range(len(bins))),
                                  dtype=np.int64, count=len(bins))
            rows[flat] = np.repeat(per_bin, lengths)
        self._prev_cols = (stream_ids, rows)
        self._prev_assignment = None
        return rows

    # -- capacity / billing --------------------------------------------------

    def accrue(self, t0: float, t1: float,
               market: Optional[SpotMarket] = None
               ) -> tuple[float, dict[tuple[str, str, str], float],
                          dict[str, float]]:
        """Cost and instance-hours accrued over [t0, t1), as one numpy pass
        over the columns (retired rows would accrue exactly zero, so the
        scan really is O(live + recently-terminated) once the fleet loop
        retires old rows).

        Spot instances bill at the market's current multiplier (you pay the
        market price, never your bid); on-demand at the catalog price.
        Returns (dollars, {(location, type, market): hours},
        {market: dollars}) — the last is the ledger's spot vs on-demand
        spend split.

        Bit-parity with the historical per-instance loop: per-row hours and
        rates are the same float expressions, and every reduction
        (``cumsum``'s running sum, ``bincount``'s in-order accumulation)
        adds in boot order exactly like the old ``+=`` loop; rows with zero
        billed hours contribute ``+ 0.0``, which is an identity on floats.
        """
        n = self._n
        by_market: dict[str, float] = {ONDEMAND: 0.0, SPOT: 0.0}
        if n == 0:
            return 0.0, {}, by_market
        boot = self._boot_t[:n]
        term = self._term[:n]
        h = np.maximum(0.0, np.minimum(t1, term) - np.maximum(t0, boot))
        rate = self._price[:n].copy()
        spot = self._spot[:n]
        if market is not None and spot.any():
            mult = np.array([market.multiplier(loc)
                             for loc in self._loc_uniq])
            srows = np.flatnonzero(spot)
            rate[srows] *= mult[self._loc_c[srows]]
        contrib = rate * h
        cost = float(np.cumsum(contrib)[-1])
        ond = contrib[~spot]
        if ond.size:
            by_market[ONDEMAND] = float(np.cumsum(ond)[-1])
        sp = contrib[spot]
        if sp.size:
            by_market[SPOT] = float(np.cumsum(sp)[-1])
        hours: dict[tuple[str, str, str], float] = {}
        active = h > 0.0
        if active.any():
            kc = self._key_c[:n]
            totals = np.bincount(kc, weights=h, minlength=len(self._key_uniq))
            # key insertion mirrors the scalar loop: only keys that actually
            # billed hours this window appear
            for k in np.unique(kc[active]).tolist():
                hours[self._key_uniq[k]] = float(totals[k])
        return cost, hours, by_market

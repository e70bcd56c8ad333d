"""Spot bidding policies and the mixed-market autoscaling policy.

A *bidding strategy* turns a :class:`~repro_torch.core.markets.MarketQuote` into
a bid in $/hour — the price above which the market may reclaim the
instance. On this simulator's market (as on EC2's classic spot market) you
always *pay* the going spot price, never your bid, so the bid only sets
preemption risk: the classic result is that high bids are cheap insurance.
The strategies differ in how they pick the head-room:

* :class:`FixedMarginBid` — bid the current price times ``1 + margin``.
* :class:`PercentileBid` — bid the given percentile of the region's
  observed multiplier history (needs a few ticks of warm-up, then adapts
  to each region's realized volatility).
* :class:`LookaheadBid` — pick the margin minimizing the *expected
  effective price* of the next interval: expected payment while alive,
  plus — on reclaim — the on-demand fallback and the boot-window SLO loss
  (``MarketQuote.effective_price``). This is the policy that trades
  preemption SLO loss against spot savings explicitly.

:class:`SpotBidPolicy` is the fleet-simulator policy: an
:class:`~repro_torch.core.adaptive.AdaptiveManager` in mixed-market mode (plans
carry an on-demand floor per stream class plus spot burst bins under the
replica anti-affinity rule; replans are min-migration mixed repairs), with
per-(type, region) bids recomputed from the attached
:class:`~repro_torch.sim.cluster.SpotMarket` every decision.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

from repro_torch.core.adaptive import AdaptiveManager
from repro_torch.core.manager import ResourceManager
from repro_torch.core.markets import SPOT, MarketQuote, MixedConfig, quotes
from repro_torch.core.strategies import Plan
from repro_torch.core.workload import Stream


class FixedMarginBid:
    """Bid a constant multiplicative head-room over the current price."""

    def __init__(self, margin: float = 0.35) -> None:
        self.name = f"fixed-margin-{margin:g}"
        self.margin = margin

    def bid(self, quote: MarketQuote, history: Sequence[float],
            dt_h: float) -> float:
        # never bid above the on-demand list price: past it you would pay
        # more to keep a reclaimable instance than a guaranteed one costs
        return min(quote.price * (1.0 + self.margin), quote.ondemand_price)


class PercentileBid:
    """Bid the q-th percentile of the region's observed price history.

    ``history`` is the multiplier series the attached market exposes; the
    bid is that percentile of the last ``window`` observations times the
    on-demand price. Until enough history accumulates it falls back to a
    fixed margin."""

    def __init__(self, pct: float = 98.0, window: int = 12,
                 warmup_margin: float = 0.35) -> None:
        self.name = f"percentile-{pct:g}"
        self.pct = pct
        self.window = window
        self._warmup = FixedMarginBid(warmup_margin)

    def bid(self, quote: MarketQuote, history: Sequence[float],
            dt_h: float) -> float:
        if len(history) < 3:
            return self._warmup.bid(quote, history, dt_h)
        tail = sorted(history[-self.window:])
        # nearest-rank percentile, deterministic
        k = min(len(tail) - 1, int(math.ceil(self.pct / 100.0 * len(tail))) - 1)
        mult = tail[max(k, 0)]
        bid = quote.ondemand_price * mult
        # at least the current price (a bid below it would be reclaimed
        # immediately), at most the on-demand list price
        return min(max(bid, quote.price), quote.ondemand_price)


class LookaheadBid:
    """Pick the margin minimizing next-interval expected effective price.

    For each candidate margin the expected cost is
    ``MarketQuote.effective_price``: survive and pay the (slightly higher)
    expected market price, or get reclaimed and pay on-demand plus the
    dt-independent **dollar cost of one reclaim** —
    ``slo_weight * ondemand_price * boot_delay_h``, the on-demand dollars'
    worth of the boot window the replacement instance spends not serving.
    The expected-price model is evaluated over a fixed ``horizon_h``
    decision horizon (not the control-loop tick), so the same policy picks
    the same margins whether the simulator ticks hourly or every five
    minutes. Low margins save nothing (you pay the market either way) and
    risk the penalty, so the optimum sits high — but below the cap when
    the walk is calm."""

    def __init__(self, margins: Sequence[float] = (0.1, 0.2, 0.3, 0.4,
                                                   0.5, 0.75, 1.0),
                 boot_delay_h: float = 0.05, slo_weight: float = 1.0,
                 horizon_h: float = 1.0) -> None:
        self.name = "lookahead"
        self.margins = tuple(margins)
        # default matches SimConfig.boot_delay_h; SpotBidPolicy overwrites
        # it with the simulator's actual boot window on attach_market, so
        # the penalty model prices the outage the ledger will really charge
        self.boot_delay_h = boot_delay_h
        self.slo_weight = slo_weight
        self.horizon_h = horizon_h

    def reclaim_cost(self, quote: MarketQuote) -> float:
        """The dt-independent dollars one reclaim of this quote costs."""
        return self.slo_weight * quote.ondemand_price * self.boot_delay_h

    def bid(self, quote: MarketQuote, history: Sequence[float],
            dt_h: float) -> float:
        penalty = self.reclaim_cost(quote)
        best = min(
            self.margins,
            key=lambda m: (quote.effective_price(
                min(quote.price * (1.0 + m), quote.ondemand_price),
                self.horizon_h, preempt_penalty=penalty), m))
        return min(quote.price * (1.0 + best), quote.ondemand_price)


def compute_bids(catalog, market, bidding, dt_h: float
                 ) -> dict[tuple[str, str], float]:
    """One bid per (instance type, region) spot quote at the attached
    market's current multipliers — the shared bid-refresh step of
    :class:`SpotBidPolicy` and :class:`~repro_torch.sim.mpc.MPCPolicy`. Returns
    ``{}`` when no market is attached (pure on-demand operation)."""
    if market is None:
        return {}
    mults = market.multipliers()
    if not mults:
        return {}
    history = {r: [h[r] for h in market.price_history if r in h]
               for r in mults}
    vol = getattr(market, "volatility", 0.15)
    out: dict[tuple[str, str], float] = {}
    for q in quotes(catalog, mults, volatility=vol):
        if q.market != SPOT:
            continue
        out[(q.type_name, q.location)] = bidding.bid(
            q, history.get(q.location, ()), dt_h)
    return out


@dataclasses.dataclass
class SpotBidPolicy:
    """Mixed on-demand/spot autoscaling with per-region bids.

    Every decision: read the attached market's multipliers, recompute one
    bid per (instance type, region) spot quote with the bidding strategy,
    and plan through the mixed-market ``AdaptiveManager`` (on-demand floor
    per stream class, spot burst under replica anti-affinity,
    min-migration repairs). The fleet simulator reads ``bids`` when
    reconciling, so spot instances boot carrying exactly the bids the plan
    was made under; the market later reclaims exactly the bids it rises
    above.
    """

    manager: ResourceManager
    bidding: object = None                    # a *Bid strategy
    floor_frac: float = 0.5
    savings_threshold: float = 0.10
    defrag_ratio: Optional[float] = 1.25
    name: str = "spot-bidder"

    def __post_init__(self) -> None:
        if self.bidding is None:
            self.bidding = LookaheadBid()
        self.bids: dict[tuple[str, str], float] = {}
        self._market = None
        self._dt_h = 1.0
        self.adaptive = AdaptiveManager(
            self.manager, strategy="FFD",
            savings_threshold=self.savings_threshold,
            mixed=MixedConfig(floor_frac=self.floor_frac,
                              defrag_ratio=self.defrag_ratio),
            multipliers_fn=self._multipliers)

    # -- market plumbing -----------------------------------------------------

    def attach_market(self, market, dt_h: float = 1.0,
                      boot_delay_h: Optional[float] = None) -> None:
        """Called by the fleet simulator: the exogenous price walk this
        policy observes (and bids against), the control-loop period, and
        the boot window its preemption-penalty model should price."""
        self._market = market
        self._dt_h = dt_h
        if boot_delay_h is not None and hasattr(self.bidding, "boot_delay_h"):
            self.bidding.boot_delay_h = boot_delay_h

    def _multipliers(self) -> dict:
        return self._market.multipliers() if self._market is not None else {}

    def _refresh_bids(self) -> None:
        self.bids = compute_bids(self.manager.catalog, self._market,
                                 self.bidding, self._dt_h)

    # -- the policy interface ------------------------------------------------

    def decide(self, t: float, streams: Sequence[Stream], *,
               preempted: bool = False) -> Plan:
        self._refresh_bids()
        return self.adaptive.step(t, streams, force=preempted)

"""The port's replanning layer (``repro_torch.core``: repair, markets,
adaptive) against the reference's (``repro.core``): min-migration repairs
and migration counts on seeded drifts, mixed on-demand/spot plans and the
spot anti-affinity rule, and the 48-hour rush-hour trace of the
``AdaptiveManager`` event by event.

Each side builds its own streams from the same numbers. Tolerance: exact
(bins, counts and costs bit for bit via ``float.hex``), except one check:
``total_cost`` against a ``+=`` loop over the applied plans' costs, held
with ``math.isclose`` at rel 1e-12 — ``total_cost`` is ``sum()``, which
Python 3.12 compensates, so it may differ from the loop in the last ulp.
"""
import dataclasses
import inspect
import math

import numpy as np
import pytest

import repro.core as R
import repro_torch.core as P
from repro.core import geo as ref_geo
from repro.core import packing as ref_packing
from repro_torch.core import geo, packing

SIDES = {"ref": (R, ref_geo), "port": (P, geo)}
PACKING = {R: ref_packing, P: packing}
REPAIR_CONFIGS = {
    "pure": {},
    "budget": {"migration_budget": 6},
    "budget-defrag": {"migration_budget": 8, "defrag_ratio": 1.25},
    "defrag-always": {"defrag_ratio": 1.0},
}


def _random_fleet(ns, geo_mod, rng, n):
    cams = tuple(sorted(geo_mod.CAMERAS))
    out = []
    for i in range(n):
        cam = cams[int(rng.integers(0, len(cams)))]
        if rng.random() < 0.25:
            fps = round(float(rng.uniform(0.1, 1.5)), 3)
            out.append(ns.Stream(f"vgg-{i}", ns.PROGRAMS["VGG16"], fps,
                                 camera=cam))
        else:
            fps = round(float(rng.uniform(0.2, 6.0)), 3)
            out.append(ns.Stream(f"zf-{i}", ns.PROGRAMS["ZF"], fps,
                                 camera=cam))
    return out


def _churn(ns, geo_mod, rng, streams, *, drop_p, n_add, drift_p, tag):
    """Departures, fps drift and arrivals (the reference's repair tests')."""
    cams = tuple(sorted(geo_mod.CAMERAS))
    out = []
    for s in streams:
        if rng.random() < drop_p:
            continue
        if rng.random() < drift_p:
            hi = 1.5 if s.program.name == "VGG16" else 6.0
            fps = round(float(np.clip(s.fps * rng.uniform(0.5, 2.0),
                                      0.1, hi)), 3)
            s = dataclasses.replace(s, fps=fps)
        out.append(s)
    for j in range(n_add):
        cam = cams[int(rng.integers(0, len(cams)))]
        fps = round(float(rng.uniform(0.2, 4.0)), 3)
        out.append(ns.Stream(f"zf-new-{tag}-{j}", ns.PROGRAMS["ZF"], fps,
                             camera=cam))
    return out


def _repair_ledger(res):
    return (res.plan.signature(), res.plan.hourly_cost.hex(), res.migrations,
            res.evicted, res.consolidated, res.arrivals, res.departures,
            res.kept, res.defrag,
            None if res.fresh_cost is None else res.fresh_cost.hex())


def _repair_chain(ns, geo_mod, seed, config_kw, rounds=3):
    """A fresh plan, then ``rounds`` repairs of seeded drifts; each round's
    ledger, assignment and migration counts against the previous plan and
    against a fresh FFD of the same demand."""
    rng = np.random.default_rng(seed)
    cat = ns.fig6_catalog()
    streams = _random_fleet(ns, geo_mod, rng, int(rng.integers(20, 70)))
    plan = ns.repair_plan(streams, cat).plan
    out = [plan.signature()]
    for r in range(rounds):
        streams = _churn(ns, geo_mod, rng, streams, drop_p=0.1,
                         n_add=int(rng.integers(0, 8)), drift_p=0.3, tag=r)
        res = ns.repair_plan(streams, cat, previous=plan,
                             config=ns.RepairConfig(**config_kw))
        ns.validate(res.plan.problem, res.plan.solution)
        fresh = ns.repair_plan(streams, cat).plan
        out.append((_repair_ledger(res),
                    sorted(ns.plan_assignment(res.plan).items()),
                    ns.count_plan_migrations(plan, res.plan),
                    ns.count_plan_migrations(plan, fresh)))
        plan = res.plan
    return out


@pytest.mark.parametrize("config", sorted(REPAIR_CONFIGS))
@pytest.mark.parametrize("seed", range(5))
def test_repair_plan_matches_reference(seed, config):
    kw = REPAIR_CONFIGS[config]
    got = _repair_chain(P, geo, seed, kw)
    assert got == _repair_chain(R, ref_geo, seed, kw)
    for _, _, moved, ffd_moved in got[1:]:
        assert moved <= ffd_moved or "defrag_ratio" in kw


def test_scoped_repair_matches_reference():
    """A scoped repair (per-group recalibration) confines consolidation to
    the bins hosting the scope's streams."""
    per_side = []
    for ns, geo_mod in SIDES.values():
        rng = np.random.default_rng(11)
        cat = ns.fig6_catalog()
        streams = _random_fleet(ns, geo_mod, rng, 50)
        old = ns.repair_plan(streams, cat).plan
        new = _churn(ns, geo_mod, rng, streams, drop_p=0.2, n_add=3,
                     drift_p=0.4, tag="s")
        scope = frozenset(s.stream_id for s in new[:10])
        res = ns.repair_plan(new, cat, previous=old, scope=scope,
                             config=ns.RepairConfig(migration_budget=10,
                                                    defrag_ratio=1.1))
        per_side.append(_repair_ledger(res))
    assert per_side[0] == per_side[1]


# -- mixed on-demand/spot ------------------------------------------------------


def _replicated_fleet(ns, geo_mod, rng, n_groups, replicas=2, tag=""):
    cams = tuple(sorted(geo_mod.CAMERAS))
    out = []
    for i in range(n_groups):
        cam = cams[int(rng.integers(0, len(cams)))]
        prog = "VGG16" if rng.random() < 0.25 else "ZF"
        hi = 1.5 if prog == "VGG16" else 6.0
        fps = round(float(rng.uniform(0.2, hi)) / replicas, 3)
        for k in range(replicas):
            out.append(ns.Stream(f"{prog.lower()}-{tag}{i}#{k}",
                                 ns.PROGRAMS[prog], fps, camera=cam))
    return out


def _multipliers(rng, cat):
    return {r: round(float(rng.uniform(0.2, 0.9)), 4) for r in cat.locations}


def _mixed_ledger(res):
    return (res.plan.signature(), res.plan.hourly_cost.hex(), res.migrations,
            res.evicted, res.arrivals, res.departures, res.kept, res.defrag,
            None if res.ondemand_cost is None else res.ondemand_cost.hex())


def _mixed_chain(ns, geo_mod, seed):
    rng = np.random.default_rng(seed)
    cat = ns.fig6_catalog()
    cfg = ns.MixedConfig(floor_frac=float(rng.choice([0.0, 0.5, 1.0])))
    streams = _replicated_fleet(ns, geo_mod, rng, int(rng.integers(6, 20)))
    mult = _multipliers(rng, cat)
    res = ns.mixed_plan(streams, cat, mult, config=cfg)
    out = [_mixed_ledger(res), ns.spot_affinity_violations(res.plan),
           [dataclasses.astuple(q) for q in ns.quotes(cat, mult)]]
    assert ns.spot_affinity_violations(res.plan) == []
    assert res.plan.hourly_cost <= res.ondemand_cost + 1e-9
    for r in range(2):
        streams = [s for s in streams if rng.random() > 0.15] + \
            _replicated_fleet(ns, geo_mod, rng, 2, tag=f"new{r}-")
        mult = _multipliers(rng, cat)
        res = ns.mixed_plan(streams, cat, mult, previous=res.plan,
                            config=cfg)
        ns.validate(res.plan.problem, res.plan.solution)
        assert ns.spot_affinity_violations(res.plan) == []
        out.append(_mixed_ledger(res))
    return out


@pytest.mark.parametrize("seed", range(5))
def test_mixed_plan_matches_reference(seed):
    assert _mixed_chain(P, geo, seed) == _mixed_chain(R, ref_geo, seed)


def test_plan_mixed_through_the_manager():
    per_side = []
    for ns, geo_mod in SIDES.values():
        rng = np.random.default_rng(5)
        mgr = ns.ResourceManager(ns.fig6_catalog())
        streams = _replicated_fleet(ns, geo_mod, rng, 10)
        mult = _multipliers(rng, mgr.catalog)
        first = mgr.plan_mixed(streams, mult)
        again = mgr.plan_mixed(streams[2:], _multipliers(rng, mgr.catalog),
                               previous=first.plan)
        per_side.append((_mixed_ledger(first), _mixed_ledger(again),
                         mgr.utilization(again.plan)))
    assert per_side[0] == per_side[1]


def _planted_violation(ns):
    """Two replicas of one group on one spot bin, one on an on-demand bin."""
    pk = PACKING[ns]
    choices = (pk.Choice("t@x", "t", "x", (10.0,), 1.0),
               pk.Choice("t@x!spot", "t", "x", (10.0,), 0.3, market="spot"))
    keys = ("cam-1#0", "cam-1#1", "cam-2#0", "cam-2#1", "solo")
    items = tuple(pk.Item(k, ((1.0,), (1.0,))) for k in keys)
    sol = pk.Solution(bins=[pk.Bin(1, [0, 1, 2]), pk.Bin(0, [3, 4])],
                      cost=1.3)
    problem = pk.Problem(choices=choices, items=items)
    return ns.Plan(solution=sol, problem=problem, strategy="MIXED")


def test_spot_affinity_violations_and_replica_groups():
    got = P.spot_affinity_violations(_planted_violation(P))
    assert got == [("cam-1", "x")]
    assert got == R.spot_affinity_violations(_planted_violation(R))
    for key in ("cam-3#1", "cam-3", "a#b#c", ""):
        assert P.replica_group(key) == R.replica_group(key)


# -- the adaptive manager ------------------------------------------------------


def rush_hour_fps(t: int) -> float:
    """Demand profile: quiet nights (0.2 fps), rush-hour peaks (6 fps)."""
    if t % 24 in (8, 9, 17, 18):
        return 6.0
    if t % 24 in (7, 10, 16, 19):
        return 2.0
    return 0.2


def _cams(ns, fps):
    return [ns.Stream(f"cam{i}", ns.PROGRAMS["ZF"], fps=fps) for i in range(4)]


def _adaptive(ns, mode, clock):
    """An adaptive manager over Fig. 3's catalog; in mixed mode its spot
    multiplier walks with ``clock["t"]``."""
    mgr = ns.ResourceManager(ns.fig3_catalog())
    if mode == "ST3":
        return ns.AdaptiveManager(mgr, strategy="ST3")
    if mode == "REPAIR":
        return ns.AdaptiveManager(mgr, strategy="REPAIR")
    if mode == "REPAIR-budget-defrag":
        return ns.AdaptiveManager(mgr, strategy="ST3", repair=ns.RepairConfig(
            migration_budget=2, defrag_ratio=1.1))
    return ns.AdaptiveManager(mgr, mixed=ns.MixedConfig(), multipliers_fn=lambda:
                              {"us-east-1": 0.3 + 0.05 * (clock["t"] % 5)})


def _run_trace(ns, mode):
    clock = {"t": 0}
    am = _adaptive(ns, mode, clock)
    applied = []
    for t in range(48):
        clock["t"] = t
        if t == 30 and mode.startswith("REPAIR"):
            am.flag_recalibration(frozenset({"cam0", "cam1"}))
        plan = am.step(t, _cams(ns, rush_hour_fps(t)), force=(t == 40))
        applied.append(plan.hourly_cost)
    events = [(e.t, e.action, e.hourly_cost.hex(), e.migrations, e.defrag,
               e.recalibration) for e in am.history()]
    return am, applied, events


@pytest.mark.parametrize("mode", ("ST3", "REPAIR", "REPAIR-budget-defrag",
                                  "MIXED"))
def test_rush_hour_trace_matches_reference(mode):
    am, applied, events = _run_trace(P, mode)
    ref_am, _, ref_events = _run_trace(R, mode)
    assert len(events) == 48
    assert events == ref_events
    assert am.total_cost().hex() == ref_am.total_cost().hex()
    assert am.total_migrations() == ref_am.total_migrations()
    assert am.defrags() == ref_am.defrags()
    assert am.current.signature() == ref_am.current.signature()
    integral = 0.0
    for cost in applied:
        integral += cost
    assert math.isclose(am.total_cost(), integral, rel_tol=1e-12)
    kinds = {e[1] for e in events}
    assert "forced-replan" in kinds and "keep" in kinds
    if mode == "ST3":             # the reference's claim for ST3
        assert am.total_cost() < 0.6 * max(applied) * 48


def test_forced_replan_spike_and_hysteresis_on_port():
    am = _adaptive(P, "ST3", {})
    am.step(0, _cams(P, 0.2))
    plan = am.step(1, _cams(P, 6.0))
    assert [e.action for e in am.events] == ["replan", "forced-replan"]
    assert am.events[1].migrations > 0
    assert am._plan_feasible_for(plan, _cams(P, 6.0))
    calm = P.AdaptiveManager(P.ResourceManager(P.fig3_catalog()),
                             savings_threshold=0.10)
    calm.step(0, _cams(P, 1.0))
    calm.step(1, _cams(P, 0.98))
    assert calm.events[1].action == "keep"
    assert calm.current is calm.step(2, _cams(P, 0.98))


def _mini_plan(ns, assignment):
    pk = PACKING[ns]
    choices = (pk.Choice("cA", "tA", "x", (10.0,), 1.0),
               pk.Choice("cB", "tB", "x", (10.0,), 2.0))
    items = tuple(pk.Item(k, ((1.0,), (1.0,))) for k in assignment)
    bins = {}
    for i, c in enumerate(assignment.values()):
        bins.setdefault(c, pk.Bin(choice=c, items=[])).items.append(i)
    cost = sum(choices[b.choice].price for b in bins.values())
    sol = pk.Solution(bins=list(bins.values()), cost=cost, note="mini")
    return ns.Plan(solution=sol,
                   problem=pk.Problem(choices=choices, items=items),
                   strategy="ST3")


def test_count_plan_migrations_on_mini_plans():
    old = {"a": 0, "b": 0, "c": 1}
    cases = [({"a": 0, "b": 0, "c": 1}, 0), ({"a": 0, "b": 1, "c": 1}, 1),
             ({"a": 1, "b": 1, "c": 0}, 3),
             ({"a": 0, "b": 0, "c": 1, "d": 0}, 0),   # an arrival
             ({"a": 0, "b": 1, "c": 1, "d": 0}, 1),
             ({"a": 0, "b": 0}, 0)]                    # a departure
    for new, moved in cases:
        got = P.count_plan_migrations(_mini_plan(P, old), _mini_plan(P, new))
        assert got == moved
        assert got == R.count_plan_migrations(_mini_plan(R, old),
                                              _mini_plan(R, new))
        assert P.plan_assignment(_mini_plan(P, new)) == \
            R.plan_assignment(_mini_plan(R, new))


def _defaults(obj):
    """(name, default) of every parameter of ``obj``'s signature; classes
    and callables as defaults by name."""
    out = []
    for name, prm in inspect.signature(obj).parameters.items():
        d = prm.default
        if d is inspect.Parameter.empty:
            d = "<required>"
        elif callable(d) or dataclasses.is_dataclass(d):
            d = (type(d).__name__, repr(d))
        out.append((name, d))
    return out


@pytest.mark.parametrize("name", (
    "AdaptiveManager", "RepairConfig", "MixedConfig", "ResourceManager",
    "repair_plan", "mixed_plan", "build_problem", "quotes",
    "spot_affinity_violations", "make_streams", "scaled_program"))
def test_knobs_and_defaults_match_reference(name):
    """Every parameter and default (savings threshold, budgets, floor
    fraction, defrag ratios, ...) is the reference's."""
    assert _defaults(getattr(P, name)) == _defaults(getattr(R, name))

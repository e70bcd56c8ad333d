"""The simulator's halves of the reference's property files, on the port:
``test_packed_parity.py`` (batched demand and pipeline stages equal to the
scalar path, seeded ledgers packed vs scalar, ``mega_city``),
``test_markets_properties.py`` (outbids are exactly the underwater bids,
bids at the on-demand cap never reclaimed, anti-affinity and frame
conservation through preemption storms, an exogenous price walk),
``test_repair_properties.py`` (the repair policy through a preemption
storm) and ``test_pipeline_properties.py`` (consolidation never worse,
per-stage requirements on every bin, pooled chunks). Where a generator or a
day is seeded, the reference's output is compared too.

``hypothesis`` is optional, as in the reference's files: without it,
seeded cases check the same invariants. Tolerance: exact, but where the
reference's tests use ``approx``.
"""
import dataclasses

import numpy as np
import pytest

try:
    import hypothesis.strategies as st
    from hypothesis import given, settings
    HAVE_HYPOTHESIS = True
except ImportError:
    HAVE_HYPOTHESIS = False

pytest.importorskip("torch")

import repro.core as RC  # noqa: E402
import repro.sim as RS  # noqa: E402
import repro_torch.core as PC  # noqa: E402
import repro_torch.sim as PS  # noqa: E402
from repro.core import packed as ref_packed  # noqa: E402
from repro_torch.core import geo, packed, validate  # noqa: E402
from repro_torch.core.markets import (SPOT, mixed_plan,  # noqa: E402
                                      replica_group, spot_affinity_violations)
from repro_torch.core.strategies import (consolidated_ffd,  # noqa: E402
                                         ffd_greedy)
from repro_torch.core.workload import PIPELINES, requirement_for  # noqa: E402
from repro_torch.sim.cluster import SimInstance, SpotMarket  # noqa: E402
from repro_torch.sim.demand import (PipelineCameraSpec,  # noqa: E402
                                    PipelineFleet, rush_hour_fps)

SIDES = {"ref": (RC, RS, ref_packed), "port": (PC, PS, packed)}
CAMERAS = tuple(sorted(geo.CAMERAS))
CATALOG = PC.fig6_catalog()
TYPES = {t.name: t for t in CATALOG.types}


def rows(ledger):
    return ([dataclasses.astuple(r) for r in ledger.records],
            ledger.totals())


def streams_data(streams):
    return [(s.stream_id, s.program.name, s.fps, s.camera) for s in streams]


def _day(side, name, policy, n, scalar=False, **kw):
    core, sim, pk = SIDES[side]
    sc = sim.SCENARIOS[name](n_streams=n, **kw)
    cat = sc.catalog()
    pol = getattr(sim, policy)(core.ResourceManager(cat))
    if scalar:
        with pk.scalar_mode():
            return sim.FleetSimulator(sc.demand, pol, cat, sc.config).run()
    return sim.FleetSimulator(sc.demand, pol, cat, sc.config).run()


# -- test_packed_parity.py: batched demand, stages and ledgers ----------------

@pytest.mark.parametrize("name,n", [("mega_city", 200), ("roi_day", 60),
                                    ("consolidated_city", 60)])
def test_batched_demand_matches_scalar_and_reference(name, n):
    sc = PS.SCENARIOS[name](n_streams=n)
    ref = RS.SCENARIOS[name](n_streams=n)
    for t in np.arange(0.0, 24.0, 1.5):
        a = sc.demand.streams_at(float(t))
        with packed.scalar_mode():
            b = sc.demand.streams_at(float(t))
        assert a == b
        assert streams_data(a) == streams_data(ref.demand.streams_at(float(t)))


def _plan_rows(plan):
    return plan.signature(), plan.hourly_cost.hex()


def test_pipeline_stage_ffd_parity():
    for name, t_h in (("roi_day", 8.5), ("consolidated_city", 17.5),
                      ("consolidated_city", 3.0)):
        streams = PS.SCENARIOS[name](n_streams=48).demand.streams_at(t_h)
        fast = ffd_greedy(streams, CATALOG)
        with packed.scalar_mode():
            slow = ffd_greedy(streams, CATALOG)
        assert _plan_rows(fast) == _plan_rows(slow)
        ref_streams = RS.SCENARIOS[name](n_streams=48).demand.streams_at(t_h)
        ref = RC.strategies.ffd_greedy(ref_streams, RC.fig6_catalog())
        assert _plan_rows(fast) == _plan_rows(ref)


@pytest.mark.parametrize("name,policy", [
    ("rush_hour", "ReactivePolicy"),
    ("spot_heavy", "ReactivePolicy"),
    ("spot_heavy", "RepairPolicy"),
    ("roi_day", "ReactivePolicy"),
    ("consolidated_city", "ReactivePolicy"),
])
def test_ledger_parity_seeded_runs(name, policy):
    led_p = _day("port", name, policy, 48)
    assert led_p.signature() == _day("port", name, policy, 48,
                                     scalar=True).signature()
    assert rows(led_p) == rows(_day("ref", name, policy, 48))


def test_mega_city_scenario_smoke():
    sc = PS.SCENARIOS["mega_city"](n_streams=120, duration_h=6.0)
    regions = {geo.nearest_region(s.camera, CATALOG.locations)
               for s in sc.demand.streams_at(12.0)}
    assert len(regions) >= 6
    led = _day("port", "mega_city", "ReactivePolicy", 120)
    assert all(abs(r.frames_demanded - r.frames_analyzed - r.frames_dropped)
               < 1e-6 for r in led.records)
    assert led.slo_attainment() > 0.9
    assert rows(led) == rows(_day("ref", "mega_city", "ReactivePolicy", 120))


# -- test_markets_properties.py: the market-aware simulator --------------------

def _check_outbid_is_exactly_underwater(seed: int) -> None:
    rng = np.random.default_rng(seed)
    market = SpotMarket(CATALOG.locations, seed=seed)
    ref = RS.cluster.SpotMarket(CATALOG.locations, seed=seed)
    for _ in range(int(rng.integers(1, 8))):
        market.step(1.0)
        ref.step(1.0)
    assert market.price_history == ref.price_history
    insts, underwater = [], set()
    for j, region in enumerate(CATALOG.locations):
        price = round(float(rng.uniform(0.3, 3.0)), 3)
        inst = SimInstance(instance_id=f"i{j}", type_name="t",
                           location=region, price=price, market=SPOT)
        rate = market.spot_rate(inst)
        mode = int(rng.integers(0, 3))
        if mode == 0:
            inst.bid = rate
        elif mode == 1:
            inst.bid = rate * float(rng.uniform(1.0, 2.0))
        else:
            inst.bid = rate * float(rng.uniform(0.2, 0.999))
            underwater.add(inst.instance_id)
        insts.append(inst)
    assert set(market.outbid(insts)) == underwater


def test_outbid_reclaims_exactly_the_underwater_bids_seeded():
    for seed in range(25):
        _check_outbid_is_exactly_underwater(seed)


def _bidder_day(side, n, hours, seed, bidding):
    core, sim, _ = SIDES[side]
    sc = sim.SCENARIOS["spot_bidder"](n_streams=n, duration_h=hours,
                                      seed=seed)
    cat = sc.catalog()
    pol = sim.SpotBidPolicy(core.ResourceManager(cat),
                            bidding=getattr(sim, bidding[0])(*bidding[1:]))
    plans = []
    step = pol.adaptive.step

    def recording_step(t, streams, **kw):
        plan = step(t, streams, **kw)
        plans.append(plan)
        return plan

    pol.adaptive.step = recording_step
    return sim.FleetSimulator(sc.demand, pol, cat, sc.config).run(), plans


def test_bid_at_ondemand_cap_is_never_preempted_in_simulation():
    led, _ = _bidder_day("port", 24, 12.0, 3, ("FixedMarginBid", 10.0))
    assert led.outbids == 0 and led.preemptions == 0
    assert led.cost_spot > 0
    ref, _ = _bidder_day("ref", 24, 12.0, 3, ("FixedMarginBid", 10.0))
    assert rows(led) == rows(ref)


def test_anti_affinity_holds_through_preemption_storm():
    led, plans = _bidder_day("port", 32, 24.0, 5, ("FixedMarginBid", 0.0))
    assert led.outbids > 5
    assert plans
    for plan in plans:
        assert spot_affinity_violations(plan) == []
    assert led.slo_attainment() > 0.8
    ref, _ = _bidder_day("ref", 32, 24.0, 5, ("FixedMarginBid", 0.0))
    assert rows(led) == rows(ref)


def test_frames_conserved_under_mass_preemption():
    led, _ = _bidder_day("port", 24, 24.0, 9, ("FixedMarginBid", 0.0))
    assert led.outbids > 0 and led.preemptions >= led.outbids
    for r in led.records:
        assert r.frames_demanded == pytest.approx(
            r.frames_analyzed + r.frames_dropped)
        assert r.cost == pytest.approx(r.cost_ondemand + r.cost_spot)
    assert led.frames_analyzed > 0


def test_lookahead_bidder_day_matches_reference():
    led, _ = _bidder_day("port", 24, 12.0, 1, ("LookaheadBid",))
    ref, _ = _bidder_day("ref", 24, 12.0, 1, ("LookaheadBid",))
    assert rows(led) == rows(ref)


def test_price_series_identical_across_bidding_policies():
    sc = PS.SCENARIOS["spot_heavy"](n_streams=24, duration_h=12.0, seed=7)
    cat = sc.catalog()
    sims = [PS.FleetSimulator(sc.demand, pol, cat, sc.config)
            for pol in (PS.ReactivePolicy(PC.ResourceManager(cat)),
                        PS.RepairPolicy(PC.ResourceManager(cat)),
                        PS.SpotBidPolicy(PC.ResourceManager(cat),
                                         bidding=PS.LookaheadBid()))]
    for s in sims:
        s.run()
    histories = [s.market.price_history for s in sims]
    assert histories[0] == histories[1] == histories[2]
    assert len(histories[0]) == int(sc.config.duration_h) + 1


# -- test_repair_properties.py: the repair policy in a storm -------------------

def test_repair_policy_survives_preemption_storm():
    ffd = _day("port", "spot_heavy", "ReactivePolicy", 36, duration_h=12.0,
               seed=4)
    rep = _day("port", "spot_heavy", "RepairPolicy", 36, duration_h=12.0,
               seed=4)
    assert rep.preemptions > 0 or ffd.preemptions > 0
    for r in rep.records:
        assert r.frames_demanded == pytest.approx(
            r.frames_analyzed + r.frames_dropped)
    assert rep.migrations < ffd.migrations
    assert rep.slo_attainment() > 0.85
    assert rows(rep) == rows(_day("ref", "spot_heavy", "RepairPolicy", 36,
                                  duration_h=12.0, seed=4))


# -- test_pipeline_properties.py: pipeline fleets ------------------------------

def _random_specs(rng, n: int, spec_cls=PipelineCameraSpec):
    specs = []
    for i in range(n):
        cam = CAMERAS[int(rng.integers(0, len(CAMERAS)))]
        pipe = "roi_plate" if rng.random() < 0.35 else "roi_vehicle"
        lo, hi = sorted((round(float(rng.uniform(0.0, 1.0)), 3),
                         round(float(rng.uniform(0.0, 1.0)), 3)))
        specs.append(spec_cls(
            f"cam-{cam}-{i}", cam, pipe,
            fps=round(float(rng.uniform(0.5, 4.0)), 3),
            base_density=lo, peak_density=hi))
    return tuple(specs)


def _check_consolidation_never_worse(seed: int, n: int, t_h: float) -> None:
    specs = _random_specs(np.random.default_rng(seed), n)
    stages = PipelineFleet(specs, consolidate=False).streams_at(t_h)
    pooled = PipelineFleet(specs, consolidate=True).streams_at(t_h)
    plan = consolidated_ffd(stages, CATALOG, pooled)
    validate(plan.problem, plan.solution)
    assert plan.hourly_cost <= ffd_greedy(stages, CATALOG).hourly_cost + 1e-9
    ref_specs = _random_specs(np.random.default_rng(seed), n,
                              RS.PipelineCameraSpec)
    ref_stages = RS.PipelineFleet(ref_specs,
                                  consolidate=False).streams_at(t_h)
    ref_pooled = RS.PipelineFleet(ref_specs, consolidate=True).streams_at(t_h)
    assert streams_data(pooled) == streams_data(ref_pooled)
    ref = RC.strategies.consolidated_ffd(ref_stages, RC.fig6_catalog(),
                                         ref_pooled)
    assert _plan_rows(plan) == _plan_rows(ref)


def test_consolidation_never_worse_seeded():
    for seed in range(12):
        _check_consolidation_never_worse(seed, n=6 + seed % 10,
                                         t_h=float(seed % 24))


def _check_stage_requirements_on_bins(seed: int, t_h: float) -> None:
    specs = _random_specs(np.random.default_rng(seed), 10)
    by_sid = {s.stream_id: s for s in specs}
    streams = PipelineFleet(specs, consolidate=False).streams_at(t_h)
    plan = ffd_greedy(streams, CATALOG)
    validate(plan.problem, plan.solution)
    checked = 0
    for b in plan.solution.bins:
        choice = plan.problem.choices[b.choice]
        itype = TYPES[choice.type_name]
        for i in b.items:
            item = plan.problem.items[i]
            sid, _, stage_name = item.key.rpartition("::")
            spec = by_sid[sid]
            stage = next(s for s in PIPELINES[spec.pipeline].stages
                         if s.name == stage_name)
            dens = rush_hour_fps(geo.local_hour(t_h, spec.camera),
                                 spec.base_density, spec.peak_density,
                                 width_h=1.5)
            fps = round(stage.stage_fps(spec.fps, dens), 3)
            want = requirement_for(stage.resolved_program(), fps, itype)
            assert want is not None
            assert item.requirements[b.choice] == tuple(want)
            checked += 1
    assert checked == len(streams)


def test_stage_requirements_hold_on_every_bin_seeded():
    for seed, t_h in enumerate((0.0, 3.5, 8.25, 12.0, 17.75, 23.0)):
        _check_stage_requirements_on_bins(seed, t_h)


def _check_pool_invariants(seed: int) -> None:
    specs = _random_specs(np.random.default_rng(seed), 12)
    ids0 = None
    for t_h in (0.0, 6.5, 9.0, 13.25, 21.0):
        on = PipelineFleet(specs, consolidate=True).streams_at(t_h)
        off = PipelineFleet(specs, consolidate=False).streams_at(t_h)
        chunks = [s for s in on if s.stream_id.startswith("pool::")]
        ids = [s.stream_id for s in on]
        ids0 = ids0 or ids
        assert ids == ids0
        by_pool: dict = {}
        for s in chunks:
            by_pool.setdefault(replica_group(s.stream_id), []).append(s)
        pooled_total: dict = {}
        for s in off:
            sid, _, stage_name = s.stream_id.rpartition("::")
            spec = next(sp for sp in specs if sp.stream_id == sid)
            stage = next(x for x in PIPELINES[spec.pipeline].stages
                         if x.name == stage_name)
            if stage.consolidatable:
                key = f"pool::{spec.pipeline}.{stage_name}@{spec.camera}"
                pooled_total[key] = pooled_total.get(key, 0.0) + s.fps
        assert set(by_pool) == set(pooled_total)
        for key, members in by_pool.items():
            spec0 = next(sp for sp in specs
                         if key.endswith(f"@{sp.camera}")
                         and key.startswith(f"pool::{sp.pipeline}."))
            stage = next(x for x in PIPELINES[spec0.pipeline].stages
                         if f".{x.name}@" in key)
            total, got = pooled_total[key], sum(s.fps for s in members)
            assert total - len(members) * 1e-3 - 1e-6 <= got <= total + 1e-6
            for s in members:
                assert s.fps <= stage.cap_fps() + 1e-9
                assert s.program is stage.resolved_program()


def test_pool_invariants_seeded():
    for seed in range(10):
        _check_pool_invariants(seed)


def test_pool_chunks_respect_spot_anti_affinity():
    specs = tuple(PipelineCameraSpec(f"cam-nyc-{i}", "nyc", "roi_vehicle",
                                     fps=4.0, base_density=1.0,
                                     peak_density=1.0) for i in range(24))
    pooled = PipelineFleet(specs, consolidate=True).streams_at(9.0)
    chunks = [s for s in pooled if s.stream_id.startswith("pool::")]
    assert len(chunks) >= 2
    assert len({replica_group(s.stream_id) for s in chunks}) == 1
    res = mixed_plan(pooled, CATALOG,
                     multipliers={loc: 0.4 for loc in CATALOG.locations})
    assert spot_affinity_violations(res.plan) == []


def test_scaled_program_is_shared_across_stage_items():
    """Stage items of one pipeline stage carry one scaled program object,
    so the packed planner's ``id()``-keyed factorization groups them."""
    specs = _random_specs(np.random.default_rng(1), 16)
    streams = PipelineFleet(specs, consolidate=False).streams_at(9.0)
    by_stage: dict = {}
    for s in streams:
        by_stage.setdefault(s.stream_id.rpartition("::")[2],
                            set()).add(id(s.program))
    assert all(len(v) == 1 for v in by_stage.values())


if HAVE_HYPOTHESIS:
    @given(st.integers(0, 10_000))
    @settings(max_examples=30, deadline=None)
    def test_outbid_exactly_underwater(seed):
        _check_outbid_is_exactly_underwater(seed)

    @given(st.integers(0, 10_000), st.integers(2, 16),
           st.floats(0.0, 24.0, allow_nan=False))
    @settings(max_examples=25, deadline=None)
    def test_consolidation_never_worse(seed, n, t_h):
        _check_consolidation_never_worse(seed, n, t_h)

    @given(st.integers(0, 10_000), st.floats(0.0, 24.0, allow_nan=False))
    @settings(max_examples=20, deadline=None)
    def test_stage_requirements_hold_on_every_bin(seed, t_h):
        _check_stage_requirements_on_bins(seed, t_h)

    @given(st.integers(0, 10_000))
    @settings(max_examples=20, deadline=None)
    def test_pool_invariants(seed):
        _check_pool_invariants(seed)

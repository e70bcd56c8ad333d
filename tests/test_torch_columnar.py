"""The port's columnar event loop against its object loop, and each against
the reference's ledger (the twin of ``test_columnar_parity.py``): seeded
days at 100 and 1,000 streams under the reactive and repair policies,
preemption batches, the pooled and continent-scale scenarios, random seeds,
and the accounting fixes the reference pins (terminated rows retire,
bounded price history, a non-divisible horizon keeps its tail, a draining
instance is reclaimed, churn follows the fleet's rush-hour width).

Ledgers are compared as plain data (every tick record as a tuple, and
``totals()``); the port's two loops also by ``signature()``. Tolerance:
exact. ``roi_day`` at 1,000 streams is in ``test_torch_columnar_roi.py``.
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
from repro.obs import TelemetryHub  # noqa: E402
from repro_torch.core import geo, packed  # noqa: E402
from repro_torch.core.strategies import ffd_greedy  # noqa: E402
from repro_torch.core.workload import PROGRAMS  # noqa: E402
from repro_torch.sim.cluster import Cluster, SpotMarket  # noqa: E402
from repro_torch.sim.demand import (CameraSpec, DiurnalFleet,  # noqa: E402
                                    PoissonChurn, rush_hour_fps)

SIDES = {"ref": (RC, RS), "port": (PC, PS)}


def rows(ledger):
    return ([dataclasses.astuple(r) for r in ledger.records],
            ledger.totals())


def _run(side, name, policy, columnar=None, **kw):
    core, sim = SIDES[side]
    sc = sim.SCENARIOS[name](**kw)
    cat = sc.catalog()
    pol = getattr(sim, policy)(core.ResourceManager(cat))
    return sim.FleetSimulator(sc.demand, pol, cat, sc.config,
                              columnar=columnar).run()


def _three(name, policy="ReactivePolicy", **kw):
    """The port's columnar ledger, after asserting that its object loop
    gives the same signature and the reference's columnar loop the same
    rows."""
    led_c = _run("port", name, policy, columnar=True, **kw)
    led_o = _run("port", name, policy, columnar=False, **kw)
    assert led_c.signature() == led_o.signature()
    assert rows(led_c) == rows(_run("ref", name, policy, columnar=True, **kw))
    return led_c


# -- columnar vs object vs the reference, at 100 and 1,000 streams -------------

@pytest.mark.parametrize("policy", ["ReactivePolicy", "RepairPolicy"])
@pytest.mark.parametrize("n", [100, 1000])
@pytest.mark.parametrize("name", ["rush_hour", "spot_heavy", "mega_city",
                                  "consolidated_city"])
def test_columnar_ledger_matches_object_and_reference(name, n, policy):
    led = _three(name, policy, n_streams=n, duration_h=24.0)
    assert len(led.records) == 24


@pytest.mark.parametrize("policy", ["ReactivePolicy", "RepairPolicy"])
def test_roi_day_pipeline_parity_at_100(policy):
    led = _three("roi_day", policy, n_streams=100, duration_h=24.0)
    assert led.stage_items_peak > 0


def test_columnar_parity_includes_preemption_batches():
    led = _three("spot_heavy", n_streams=24, duration_h=24.0)
    assert led.preemptions > 0


def test_consolidated_city_pooled_parity():
    led = _three("consolidated_city", n_streams=60, duration_h=24.0)
    assert led.pooled_items_peak > 0


def test_continent_scale_scenario_parity():
    _three("continent_scale", n_streams=500, duration_h=6.0)


def _check_seed(seed):
    _three("spot_heavy", n_streams=12, duration_h=6.0, seed=seed)


if HAVE_HYPOTHESIS:
    @settings(max_examples=10, deadline=None)
    @given(st.integers(min_value=0, max_value=10_000))
    def test_columnar_parity_random_seeds(seed):
        _check_seed(seed)
else:
    @pytest.mark.parametrize("seed", [1, 17, 4242])
    def test_columnar_parity_random_seeds(seed):
        _check_seed(seed)


# -- the reference's accounting fixes, on the port -----------------------------

def test_terminated_instances_retire_without_changing_billing():
    sc = PS.SCENARIOS["spot_heavy"](n_streams=24, duration_h=24.0)
    cat = sc.catalog()
    sim = PS.FleetSimulator(sc.demand,
                            PS.ReactivePolicy(PC.ResourceManager(cat)), cat,
                            sc.config)
    led = sim.run()
    cl = sim.cluster
    assert cl.retired_count > 0
    assert len(cl.instances) < cl._counter
    assert len(cl.instances) == cl._counter - cl.retired_count

    sc2 = PS.SCENARIOS["spot_heavy"](n_streams=24, duration_h=24.0)
    sim2 = PS.FleetSimulator(sc2.demand,
                             PS.ReactivePolicy(PC.ResourceManager(cat)), cat,
                             sc2.config)
    sim2.cluster.retire = lambda before_t: None
    led2 = sim2.run()
    assert sim2.cluster.retired_count == 0
    assert led.signature() == led2.signature()


def test_spot_price_history_is_bounded_and_the_references():
    m = SpotMarket(["us-east-1"], seed=0, history_limit=16)
    ref = RS.cluster.SpotMarket(["us-east-1"], seed=0, history_limit=16)
    unbounded = SpotMarket(["us-east-1"], seed=0, history_limit=None)
    for _ in range(100):
        m.step(0.25)
        ref.step(0.25)
        unbounded.step(0.25)
    assert len(m.price_history) == 16
    assert len(unbounded.price_history) == 101
    assert m.price_history == unbounded.price_history[-16:]
    assert m.price_history == ref.price_history


def test_fractional_horizon_keeps_tail_interval():
    led = _three("rush_hour", n_streams=8, duration_h=2.5)
    assert len(led.records) == 3
    assert led.records[-1].t == 2.0
    sc = PS.SCENARIOS["rush_hour"](n_streams=8, duration_h=2.5)
    demand_fps = sum(s.fps for s in sc.demand.streams_at(2.0))
    assert led.records[-1].frames_demanded == pytest.approx(
        demand_fps * 0.5 * 3600.0)


def test_divisible_horizon_tick_count_unchanged():
    assert len(_three("rush_hour", n_streams=8, duration_h=4.0).records) == 4


def test_reconcile_reclaims_draining_instance():
    """Scale down, then back up inside the drain window: the drain is
    cancelled and the instance reused, on both packages alike."""
    seen = {}
    for side, (core, sim) in SIDES.items():
        cat = core.fig6_catalog()
        hub = TelemetryHub()
        cl = sim.Cluster(boot_delay_h=0.05, telemetry=hub)
        s0 = core.Stream("s0", core.PROGRAMS["ZF"], 6.0, camera="nyc")
        s1 = core.Stream("s1", core.PROGRAMS["ZF"], 6.0, camera="nyc")
        greedy = core.strategies.ffd_greedy
        assign = cl.reconcile(0.0, greedy([s0, s1], cat), drain_h=2.0)
        assert len(cl.instances) == 2
        iid1 = assign["s1"]
        cl.reconcile(1.0, greedy([s0], cat), drain_h=2.0)
        inst1 = cl.instances[iid1]
        assert inst1.terminated_t == pytest.approx(3.0)
        assign3 = cl.reconcile(1.5, greedy([s0, s1], cat), drain_h=2.0)
        assert assign3["s1"] == iid1
        assert inst1.terminated_t is None
        assert len(cl.instances) == 2
        undrains = [p for p in hub.points
                    if p.name == "cluster.instance.undrain"]
        assert len(undrains) == 1 and undrains[0].t == 1.5
        seen[side] = (assign, assign3, hub.points)
    assert seen["port"] == seen["ref"]


def test_fully_drained_instance_stays_dead():
    cat = PC.fig6_catalog()
    cl = Cluster(boot_delay_h=0.05)
    s0 = PC.Stream("s0", PROGRAMS["ZF"], 6.0, camera="nyc")
    s1 = PC.Stream("s1", PROGRAMS["ZF"], 6.0, camera="nyc")
    assign = cl.reconcile(0.0, ffd_greedy([s0, s1], cat), drain_h=0.5)
    iid1 = assign["s1"]
    cl.reconcile(1.0, ffd_greedy([s0], cat), drain_h=0.5)
    assign3 = cl.reconcile(2.0, ffd_greedy([s0, s1], cat), drain_h=0.5)
    assert assign3["s1"] != iid1
    assert cl.instances[iid1].terminated_t == pytest.approx(1.5)


def _churn(sim, **kw):
    base = sim.DiurnalFleet(
        (sim.CameraSpec("zf-nyc-0", "nyc", "ZF", 0.2, 6.0),), width_h=3.0)
    return sim.PoissonChurn(base, templates=(
        sim.CameraSpec("tpl", "nyc", "ZF", 0.3, 2.0),),
        rate_per_h=2.0, mean_lifetime_h=8.0, horizon_h=24.0, seed=3, **kw)


def test_churn_streams_inherit_diurnal_width():
    churn = _churn(PS)
    assert churn.effective_width_h() == 3.0
    arrive, _, spec = churn._schedule[0]
    t = arrive + 0.25
    got = {s.stream_id: s for s in churn.streams_at(t)}[spec.stream_id]
    want = rush_hour_fps(geo.local_hour(t, spec.camera), spec.base_fps,
                         spec.peak_fps, width_h=3.0)
    assert got.fps == round(want, 3)
    assert got.fps != round(rush_hour_fps(geo.local_hour(t, spec.camera),
                                          spec.base_fps, spec.peak_fps,
                                          width_h=1.5), 3)
    ref = _churn(RS)
    for t in np.arange(0.0, 24.0, 0.75):
        assert [(s.stream_id, s.fps) for s in churn.streams_at(float(t))] \
            == [(s.stream_id, s.fps) for s in ref.streams_at(float(t))]


def test_churn_width_explicit_override_wins():
    assert _churn(PS, width_h=0.8).effective_width_h() == 0.8


def test_churn_width_packed_scalar_parity():
    base = DiurnalFleet((CameraSpec("zf-nyc-0", "nyc", "ZF", 0.2, 6.0),),
                        width_h=2.25)

    def build():
        return PoissonChurn(base, templates=(
            CameraSpec("tpl", "paris", "ZF", 0.3, 2.0),),
            rate_per_h=2.0, mean_lifetime_h=8.0, horizon_h=24.0, seed=5)

    for t in (0.0, 6.5, 9.25, 17.5, 23.0):
        fast = [(s.stream_id, s.fps) for s in build().streams_at(t)]
        with packed.scalar_mode():
            slow = [(s.stream_id, s.fps) for s in build().streams_at(t)]
        assert fast == slow

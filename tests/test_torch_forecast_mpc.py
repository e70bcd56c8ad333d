"""Forecasting and MPC on the port (the twin of ``test_forecast_mpc.py``):
the EWMA policy's time units, ``LookaheadBid``'s dt invariance, the
scheduled policy's per-run reset, ``hold_until``, the seasonal forecaster
(exact on repeating days, cold-start fallback, object and columnar paths,
the live scale), and ``MPCPolicy`` (its envelope, its cold start equal to
the reactive policy's ledger, its warm run that pre-boots and resets per
run). The reference's runs are compared where its result does not hang on
heap layout: the warm run's forecaster cache does in the reference
(``SeasonalForecaster._class_index`` keys on ``id()``s of arrays it does not
keep), and the port's copy keeps them, which the last tests hold.
Tolerance: exact, as the reference's tests are, but where they use
``approx``.
"""
import dataclasses
import gc
import random
import weakref

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
from repro.sim import scenarios as ref_scenarios  # noqa: E402
from repro_torch.core import ResourceManager, Stream, fig6_catalog  # noqa: E402
from repro_torch.core.adaptive import AdaptiveManager  # noqa: E402
from repro_torch.core.markets import SPOT, MarketQuote  # noqa: E402
from repro_torch.core.workload import PROGRAMS  # noqa: E402
from repro_torch.sim import (FleetSimulator, LookaheadBid, MPCConfig,  # noqa: E402
                             MPCPolicy, PredictiveEWMAPolicy, ReactivePolicy,
                             ScheduledPolicy, SeasonalForecaster)
from repro_torch.sim.demand import (CameraSpec, DiurnalFleet,  # noqa: E402
                                    StreamColumns)
from repro_torch.sim.scenarios import follow_the_sun, rush_hour  # noqa: E402


def rows(ledger):
    return ([dataclasses.astuple(r) for r in ledger.records],
            ledger.totals())


# -- EWMA time units -----------------------------------------------------------

def _ramp(t: float) -> list[Stream]:
    return [Stream(stream_id="s0", program=PROGRAMS["ZF"], fps=2.0 + t)]


def test_ewma_forecast_is_dt_invariant():
    hourly = PredictiveEWMAPolicy(ResourceManager(fig6_catalog()))
    halved = PredictiveEWMAPolicy(ResourceManager(fig6_catalog()))
    for t in (0.0, 1.0, 2.0):
        out_h = hourly.forecast(_ramp(t), 1.0)
    for t in (0.0, 0.5, 1.0, 1.5, 2.0):
        out_2 = halved.forecast(_ramp(t), 0.5)
    assert halved._trend["s0"] == pytest.approx(hourly._trend["s0"],
                                                rel=1e-12)
    assert out_2[0].fps == pytest.approx(out_h[0].fps, abs=1e-3)
    assert 0.0 < hourly._trend["s0"] <= 1.0
    ref = RS.PredictiveEWMAPolicy(RC.ResourceManager(RC.fig6_catalog()))
    for t in (0.0, 0.5, 1.0, 1.5, 2.0):
        ref_out = ref.forecast([RC.Stream("s0", RC.PROGRAMS["ZF"],
                                          fps=2.0 + t)], 0.5)
    assert ref._trend["s0"].hex() == halved._trend["s0"].hex()
    assert ref_out[0].fps == out_2[0].fps


def test_ewma_dt_one_matches_legacy_form():
    pol = PredictiveEWMAPolicy(ResourceManager(fig6_catalog()), alpha=0.3)
    pol.forecast(_ramp(0.0), 1.0)
    pol.forecast(_ramp(1.0), 1.0)
    assert pol._trend["s0"] == 0.3


def test_ewma_lead_ticks_alias():
    pol = PredictiveEWMAPolicy(ResourceManager(fig6_catalog()), lead_ticks=3)
    assert pol.lead_h == 3.0 and pol.lead_ticks == 3.0
    pol.lead_ticks = 1.5
    assert pol.lead_h == 1.5
    pol2 = PredictiveEWMAPolicy(ResourceManager(fig6_catalog()),
                                lead_h=2.5, lead_ticks=4)
    assert pol2.lead_h == 2.5


def test_ewma_policy_resets_on_time_reversal():
    pol = PredictiveEWMAPolicy(ResourceManager(fig6_catalog()))
    for t in (0.0, 1.0, 2.0):
        pol.decide(t, _ramp(t))
    assert pol._trend["s0"] > 0
    pol.decide(0.0, _ramp(0.0))
    assert pol._trend.get("s0", 0.0) == 0.0


# -- LookaheadBid ----------------------------------------------------------------

def _spot_quote(price: float, vol: float) -> MarketQuote:
    return MarketQuote(type_name="g2.2xlarge", location="us-east",
                       market=SPOT, price=price, ondemand_price=1.0,
                       volatility=vol)


@pytest.mark.parametrize("price,vol", [(0.2, 0.1), (0.3, 0.3), (0.6, 0.5),
                                       (0.9, 0.15)])
def test_lookahead_bid_is_dt_invariant(price, vol):
    q = _spot_quote(price, vol)
    strat = LookaheadBid()
    assert strat.bid(q, (), 1.0) == strat.bid(q, (), 1.0 / 12.0)
    assert strat.bid(q, (), 1.0) == strat.bid(q, (), 4.0)
    ref_q = RC.markets.MarketQuote(type_name="g2.2xlarge",
                                   location="us-east", market=SPOT,
                                   price=price, ondemand_price=1.0,
                                   volatility=vol)
    assert strat.bid(q, (), 1.0).hex() == \
        RS.LookaheadBid().bid(ref_q, (), 1.0).hex()


def test_lookahead_reclaim_cost_is_flat_dollars():
    strat = LookaheadBid(boot_delay_h=0.1, slo_weight=2.0)
    assert strat.reclaim_cost(_spot_quote(0.3, 0.2)) == \
        pytest.approx(2.0 * 1.0 * 0.1)


# -- ScheduledPolicy run reset ---------------------------------------------------

def test_scheduled_policy_two_runs_are_deterministic():
    sc = rush_hour(36)
    cat = sc.catalog()
    reused = ScheduledPolicy(ResourceManager(cat), every_h=6.0)
    led1 = FleetSimulator(sc.demand, reused, cat, sc.config).run()
    led2 = FleetSimulator(sc.demand, reused, cat, sc.config).run()
    fresh = ScheduledPolicy(ResourceManager(cat), every_h=6.0)
    led_f = FleetSimulator(sc.demand, fresh, cat, sc.config).run()
    assert led2.signature() == led_f.signature() == led1.signature()
    rsc = ref_scenarios.rush_hour(36)
    ref_led = RS.FleetSimulator(
        rsc.demand, RS.ScheduledPolicy(RC.ResourceManager(rsc.catalog()),
                                       every_h=6.0),
        rsc.catalog(), rsc.config).run()
    assert rows(led_f) == rows(ref_led)


# -- hold_until ------------------------------------------------------------------

def _streams(fps: float) -> list[Stream]:
    return [Stream(stream_id=f"s{i}", program=PROGRAMS["ZF"], fps=fps)
            for i in range(6)]


def test_hold_until_suppresses_voluntary_adoption_only():
    am = AdaptiveManager(ResourceManager(fig6_catalog()), strategy="FFD")
    am.step(0, _streams(8.0))
    expensive = am.current.hourly_cost
    am.hold_until = 5.0
    am.step(1, _streams(0.5))
    assert am.events[-1].action == "keep"
    assert am.current.hourly_cost == expensive
    am.step(2, _streams(0.5), force=True)
    assert am.events[-1].action == "forced-replan"
    am.step(3, _streams(8.0))
    am.hold_until = 5.0
    am.step(4, _streams(0.5))
    assert am.events[-1].action == "keep"
    am.step(5, _streams(0.5))
    assert am.events[-1].action == "replan"
    assert am.current.hourly_cost < expensive


# -- the seasonal forecaster ------------------------------------------------------

def _tiny_fleet() -> DiurnalFleet:
    # one stream per (program, camera) class, so class means are exact
    return DiurnalFleet((CameraSpec("a", "nyc", "ZF", 0.5, 4.0),
                         CameraSpec("b", "london", "ZF", 0.3, 2.0),
                         CameraSpec("c", "nyc", "VGG16", 0.1, 1.5)))


def test_forecaster_reproduces_pure_seasonal_exactly():
    demand = _tiny_fleet()
    fc = SeasonalForecaster(period_h=24.0)
    fc.warmup(demand, 48.0)
    assert all(r == 0.0 for r in fc._resid.values())
    for t in (0.0, 5.0, 13.0, 23.0):
        cols = demand.columns_at(t)
        pred, known = fc.forecast_fps(t, cols)
        assert known.all()
        np.testing.assert_array_equal(pred, np.asarray(cols.fps))
        assert fc.coverage(t, cols) == 1.0


def test_forecaster_residuals_stay_near_zero_on_repeats():
    demand = _tiny_fleet()
    fc = SeasonalForecaster(period_h=24.0)
    fc.warmup(demand, 24.0 * 5)
    scale = max(float(np.max(demand.columns_at(t).fps))
                for t in range(24)) or 1.0
    assert all(abs(r) <= 1e-12 * scale for r in fc._resid.values())


def test_forecaster_cold_start_falls_back_to_current():
    fc = SeasonalForecaster()
    streams = [Stream(stream_id="x", program=PROGRAMS["ZF"], fps=3.3)]
    pred, known = fc.forecast_fps(5.0, streams)
    assert not known.any()
    assert pred[0] == 3.3
    assert fc.coverage(5.0, streams) == 0.0


def test_forecaster_object_and_columnar_paths_agree():
    demand = _tiny_fleet()
    fc_cols = SeasonalForecaster(period_h=24.0)
    fc_objs = SeasonalForecaster(period_h=24.0)
    for t in range(24):
        fc_cols.observe(float(t), demand.columns_at(float(t)))
        fc_objs.observe(float(t), list(demand.streams_at(float(t))))
    for t in (2.0, 11.0, 19.0):
        cols = demand.columns_at(t)
        objs = list(demand.streams_at(t))
        pc, kc = fc_cols.forecast_fps(t, cols)
        po, ko = fc_objs.forecast_fps(t, objs)
        order = np.argsort([s.stream_id for s in objs])
        corder = np.argsort(list(cols.ids))
        np.testing.assert_allclose(np.asarray(pc)[corder], po[order],
                                   rtol=1e-12)
        assert kc.all() and ko.all()


def test_forecaster_matches_reference_over_a_week():
    """Five days of follow_the_sun demand observed on both packages: every
    bucket's forecast at the next day's hours, bit for bit."""
    port_sc, ref_sc = follow_the_sun(24), ref_scenarios.follow_the_sun(24)
    fc, ref = SeasonalForecaster(), RS.SeasonalForecaster()
    fc.warmup(port_sc.demand, 24.0 * 5)
    ref.warmup(ref_sc.demand, 24.0 * 5)
    for t in np.arange(120.0, 144.0, 1.5):
        got = fc.forecast_fps(float(t), port_sc.demand.columns_at(float(t)))
        want = ref.forecast_fps(float(t), ref_sc.demand.columns_at(float(t)))
        assert got[0].tobytes() == want[0].tobytes()
        assert (got[1] == want[1]).all()


def test_forecaster_live_scale_tracks_hotter_day():
    class Hub:
        def __init__(self):
            self.fns = []

        def subscribe(self, fn):
            self.fns.append(fn)

    class Point:
        def __init__(self, t, name, value):
            self.t, self.name, self.value = t, name, value

    fc = SeasonalForecaster(period_h=24.0)
    demand = _tiny_fleet()
    fc.warmup(demand, 24.0)
    hub = Hub()
    fc.attach_hub(hub)
    base = [float(np.asarray(demand.columns_at(float(t)).fps).sum())
            for t in range(24)]
    for t in range(7):
        for fn in hub.fns:
            fn(Point(float(t), "fleet.frames.demanded", base[t] * 3600.0))
    assert fc.live_scale() == 1.0
    for t in range(24, 31):
        for fn in hub.fns:
            fn(Point(float(t), "fleet.frames.demanded",
                     base[t % 24] * 1.5 * 3600.0))
    assert fc.live_scale() == pytest.approx(1.5)


# -- MPC -------------------------------------------------------------------------

def test_mpc_envelope_never_below_current_demand():
    sc = follow_the_sun(24)
    fc = SeasonalForecaster()
    fc.warmup(sc.demand, 24.0)
    pol = MPCPolicy(ResourceManager(sc.catalog()), forecaster=fc)
    for t in (0.0, 6.0, 7.0, 12.0, 18.0, 23.0):
        cols = sc.demand.columns_at(t)
        cur = np.asarray(cols.fps)
        for lead in (0.0, 1.0, 2.0):
            env, n_pre = pol._envelope(t, cols, cur, lead)
            assert (env >= cur).all()
            caps = pol._caps(cols)
            assert (env <= np.maximum(caps, cur) + 1e-9).all()
            assert n_pre == int(np.count_nonzero(env > cur + 1e-9))
            if lead == 0.0:
                assert n_pre == 0 and (env == cur).all()


def test_mpc_cold_start_is_bit_identical_to_reactive():
    sc = rush_hour(36)
    cat = sc.catalog()
    led_r = FleetSimulator(sc.demand, ReactivePolicy(ResourceManager(cat)),
                           cat, sc.config).run()
    pol = MPCPolicy(ResourceManager(cat),
                    config=MPCConfig(savings_threshold=0.10,
                                     cadence_candidates=(1.0,)))
    led_m = FleetSimulator(sc.demand, pol, cat, sc.config).run()
    assert led_m.signature() == led_r.signature()
    assert led_m.totals()["preboots"] == 0
    rsc = ref_scenarios.rush_hour(36)
    ref = RS.FleetSimulator(
        rsc.demand, RS.MPCPolicy(
            RC.ResourceManager(rsc.catalog()),
            config=RS.MPCConfig(savings_threshold=0.10,
                                cadence_candidates=(1.0,))),
        rsc.catalog(), rsc.config).run()
    assert rows(led_m) == rows(ref)


def test_mpc_nonspot_exposes_no_bids():
    pol = MPCPolicy(ResourceManager(fig6_catalog()))
    assert pol.bids is None
    spot = MPCPolicy(ResourceManager(fig6_catalog()), spot=True)
    assert spot.bids == {}


def test_mpc_warm_run_prebooks_and_resets_per_run():
    sc = follow_the_sun(24)
    cat = sc.catalog()
    fc = SeasonalForecaster()
    fc.warmup(sc.demand, 24.0)
    pol = MPCPolicy(ResourceManager(cat), forecaster=fc,
                    config=MPCConfig(slo_floor=0.999))
    led1 = FleetSimulator(sc.demand, pol, cat, sc.config).run()
    assert led1.totals()["preboots"] > 0
    assert led1.totals()["forecast_max_rel_error"] >= 0.0
    led2 = FleetSimulator(sc.demand, pol, cat, sc.config).run()
    assert led2.signature() == led1.signature()


def test_mpc_warm_run_equals_a_fresh_policy_and_forecaster():
    """A second warm run of a reused policy equals a run of a new policy
    over a new forecaster warmed the same way (no state carries over, the
    class cache included)."""
    def warm_run(fc=None, pol=None):
        sc = follow_the_sun(24)
        cat = sc.catalog()
        if pol is None:
            fc = SeasonalForecaster()
            fc.warmup(sc.demand, 24.0)
            pol = MPCPolicy(ResourceManager(cat), forecaster=fc,
                            config=MPCConfig(slo_floor=0.999))
        return pol, FleetSimulator(sc.demand, pol, cat, sc.config).run()

    pol, _ = warm_run()
    _, second = warm_run(pol=pol)
    _, fresh = warm_run()
    assert second.signature() == fresh.signature()


# -- the class cache keeps what it keys on ----------------------------------------

PROGS = (PROGRAMS["ZF"], PROGRAMS["VGG16"])
CAMS = ("nyc", "london", "tokyo")


def _columns(pc, cc):
    n = len(pc)
    return StreamColumns([f"s{k}" for k in range(n)], np.full(n, 1.0),
                         np.array(pc), PROGS, np.array(cc), CAMS)


def _classes(pc, cc):
    return [(PROGS[p].name, CAMS[c] if c >= 0 else "") for p, c in zip(pc, cc)]


def test_class_cache_keeps_its_arrays_alive():
    """The cache holds the three arrays it is keyed on, so none can be
    freed and its address reused by a new fleet while the entry stands."""
    fc = SeasonalForecaster()
    cols = _columns([0, 1, 0], [0, 2, -1])
    refs = [weakref.ref(cols.program_codes), weakref.ref(cols.camera_codes)]
    ids_list = cols.ids
    fc._class_index(cols)
    del cols
    gc.collect()
    assert all(r() is not None for r in refs)
    assert fc._idx_cache[0][0] is ids_list
    assert fc._idx_cache[0][1] is refs[0]()


def test_class_index_stays_right_over_fleets_built_and_dropped():
    """Many fleets of the same size built, classed and dropped in a loop
    (addresses are reused): each gets its own classes, and a hit needs the
    same three objects."""
    rng = random.Random(3)
    fc = SeasonalForecaster()
    for _ in range(400):
        pc = [rng.randrange(2) for _ in range(8)]
        cc = [rng.randrange(-1, 3) for _ in range(8)]
        cols = _columns(pc, cc)
        keys, inv = fc._class_index(cols)
        assert [keys[i] for i in inv] == _classes(pc, cc)
        again = fc._class_index(cols)
        assert again[0] is keys and again[1] is inv      # a hit
        del cols, keys, inv, again
    stable = _columns([1, 0], [2, 2])
    first = fc._class_index(stable)
    copy = StreamColumns(list(stable.ids), stable.fps,
                         stable.program_codes.copy(), PROGS,
                         stable.camera_codes.copy(), CAMS)
    assert fc._class_index(copy)[0] is not first[0]       # equal, not same


# -- property-style ----------------------------------------------------------------

def _random_fps_cases():
    rng = random.Random(7)
    return [[round(rng.uniform(0.1, 8.0), 3) for _ in range(5)]
            for _ in range(20)]


def _check_constant_demand(fps):
    streams = [Stream(stream_id=f"s{i}", program=PROGRAMS["ZF"], fps=f,
                      camera=f"cam{i}") for i, f in enumerate(fps)]
    fc = SeasonalForecaster(period_h=24.0)
    fc.observe(3.0, streams)
    fc.observe(27.0, streams)
    pred, known = fc.forecast_fps(51.0, streams)
    assert known.all()
    assert pred.tolist() == [s.fps for s in streams]


if HAVE_HYPOTHESIS:
    @given(st.lists(st.floats(min_value=0.1, max_value=8.0,
                              allow_nan=False), min_size=1, max_size=8))
    @settings(max_examples=50, deadline=None)
    def test_forecaster_constant_demand_is_forecast_verbatim(fps):
        _check_constant_demand(fps)
else:
    @pytest.mark.parametrize("fps", _random_fps_cases())
    def test_forecaster_constant_demand_is_forecast_verbatim(fps):
        _check_constant_demand(fps)

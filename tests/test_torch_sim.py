"""The port's fleet simulator (``repro_torch.sim``) and its ground-truth probe
(``repro_torch.obs.probe``) against the reference's (``repro.sim``,
``repro.obs.probe``): every ``SCENARIOS`` factory for two ticks, the event
queue, the demand generators, the policies, frame conservation under
preemption, boot windows, the serving calibration; then the port alone
closing the profile → simulate → pack loop with its own engine.

Each side builds its own scenarios from the same seeds. Ledgers are
compared as plain data (every tick record as a tuple, and ``totals()``), a
port ``TickRecord`` not being a reference one. Tolerance: exact.
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as RC  # noqa: E402
import repro.obs as ROBS  # noqa: E402
import repro.obs.probe as RPROBE  # noqa: E402
import repro.sim as RS  # noqa: E402
import repro_torch.core as PC  # noqa: E402
import repro_torch.obs as POBS  # noqa: E402
import repro_torch.sim as PS  # noqa: E402
from repro.core import geo as ref_geo  # noqa: E402
from repro_torch.core import geo  # noqa: E402

SIDES = {"ref": (RC, RS), "port": (PC, PS)}


def rows(ledger):
    """A ledger as plain data: every tick record and the totals."""
    return ([dataclasses.astuple(r) for r in ledger.records],
            ledger.totals())


def streams_data(streams):
    return [(s.stream_id, getattr(s.program, "name", s.program), s.fps,
             s.camera) for s in streams]


def _run(side, name, policy="ReactivePolicy", service=False, **kw):
    """A scenario's day; with ``service``, capped by its ground truth."""
    core, sim = SIDES[side]
    sc = sim.SCENARIOS[name](**kw)
    cat = sc.catalog()
    mgr = core.ResourceManager(cat)
    if policy == "StaticPeakPolicy":
        pol = sim.StaticPeakPolicy(mgr, sc.peak_streams())
    else:
        pol = getattr(sim, policy)(mgr)
    return sim.FleetSimulator(sc.demand, pol, cat, sc.config,
                              service=sc.service if service else None).run()


def _both(name, policy="ReactivePolicy", **kw):
    """The port's ledger, after asserting it equals the reference's."""
    port = _run("port", name, policy, **kw)
    assert rows(port) == rows(_run("ref", name, policy, **kw))
    return port


# -- the package ---------------------------------------------------------------

def test_public_api_mirrors_reference():
    assert PS.__all__ == RS.__all__
    for name in PS.__all__:
        assert hasattr(PS, name), name
    assert set(POBS.__all__) <= set(ROBS.__all__)
    assert sorted(PS.SCENARIOS) == sorted(RS.SCENARIOS)


def test_packed_flags_are_separate():
    """``FleetSimulator.run`` picks the columnar loop from its own package's
    ``packed`` flag: the reference's ``scalar_mode()`` leaves the port's
    choice alone, and the other way round."""
    from repro.core import packed as ref_packed
    from repro_torch.core import packed

    def loop(side):
        core, sim = SIDES[side]
        sc = sim.SCENARIOS["rush_hour"](n_streams=8, duration_h=1.0)
        cat = sc.catalog()
        fs = sim.FleetSimulator(sc.demand,
                                sim.ReactivePolicy(core.ResourceManager(cat)),
                                cat, sc.config)
        fs._run_columnar = lambda: "columnar"
        fs._run_object = lambda: "object"
        return fs.run()

    with ref_packed.scalar_mode():
        assert loop("port") == "columnar"
        assert loop("ref") == "object"
    with packed.scalar_mode():
        assert loop("port") == "object"
        assert loop("ref") == "columnar"
    assert loop("port") == loop("ref") == "columnar"


# -- every scenario, two ticks -------------------------------------------------

@pytest.mark.parametrize("name", sorted(RS.SCENARIOS))
def test_every_scenario_matches_reference(name):
    """Each factory builds at a small size and runs two of its own ticks
    (flash_crowd's are half an hour); two port runs are identical, and
    equal to the reference's at the same seed."""
    dt_h = PS.SCENARIOS[name](n_streams=16, seed=11).config.dt_h
    kw = dict(n_streams=16, duration_h=2 * dt_h, seed=11)
    a, b = _run("port", name, **kw), _run("port", name, **kw)
    assert len(a.records) == 2
    assert a.signature() == b.signature()
    assert rows(a) == rows(_run("ref", name, **kw))


# -- event queue and demand ----------------------------------------------------

def test_event_queue_orders_by_time_then_insertion():
    kinds = {}
    for side, (_, sim) in SIDES.items():
        q = sim.EventQueue()
        q.push(2.0, "b")
        q.push(1.0, "a")
        q.push(1.0, "c")
        q.push(0.5, "d")
        kinds[side] = [q.pop().kind for _ in range(len(q))]
    assert kinds["port"] == kinds["ref"] == ["d", "a", "c", "b"]


@pytest.mark.parametrize("camera", sorted(ref_geo.CAMERAS))
def test_local_hour_and_its_day_boundaries(camera):
    """Local solar hour by longitude, through midnight UTC and back: in
    [0, 24) and bit-equal to the reference's at every quarter hour."""
    for t in np.arange(-24.0, 48.25, 0.25):
        got = geo.local_hour(float(t), camera)
        assert 0.0 <= got < 24.0
        assert got.hex() == ref_geo.local_hour(float(t), camera).hex()
    assert geo.utc_offset_hours(camera) == ref_geo.utc_offset_hours(camera)
    if camera == "tokyo":
        assert geo.local_hour(0.0, camera) == pytest.approx(139.69 / 15.0)
    if camera == "nyc":
        assert geo.local_hour(12.0, camera) < 12.0


def test_diurnal_curve_peaks_at_local_rush_hour():
    base, peak = 0.2, 6.0
    assert PS.rush_hour_fps(8.5, base, peak) == pytest.approx(peak)
    assert PS.rush_hour_fps(3.0, base, peak) < 0.3
    for h in np.linspace(0.0, 24.0, 97):
        assert PS.rush_hour_fps(float(h), base, peak).hex() == \
            RS.rush_hour_fps(float(h), base, peak).hex()
    fleet = PS.DiurnalFleet((PS.CameraSpec("s", "tokyo", "ZF", base, peak),))
    morning = (8.5 - geo.utc_offset_hours("tokyo")) % 24
    midday = (12.5 - geo.utc_offset_hours("tokyo")) % 24
    assert fleet.streams_at(morning)[0].fps > 5.5 > \
        fleet.streams_at(midday)[0].fps


def test_poisson_churn_is_seeded_and_bounded():
    seen = {}
    for side, (_, sim) in SIDES.items():
        base = sim.DiurnalFleet((sim.CameraSpec("s", "nyc", "ZF", 0.2, 2.0),))
        tpl = (sim.CameraSpec("extra", "london", "ZF", 0.3, 1.0),)
        a = sim.PoissonChurn(base, templates=tpl, horizon_h=24.0, seed=3)
        b = sim.PoissonChurn(base, templates=tpl, horizon_h=24.0, seed=3)
        runs = [[streams_data(m.streams_at(t)) for t in range(24)]
                for m in (a, b)]
        assert runs[0] == runs[1]
        seen[side] = runs[0]
    assert seen["port"] == seen["ref"]
    counts = [len(s) for s in seen["port"]]
    assert max(counts) > 1 and min(counts) >= 1


def test_flash_crowd_scales_only_matching_cameras_and_caps():
    base = PS.DiurnalFleet((PS.CameraSpec("a", "london", "ZF", 1.0, 1.0),
                            PS.CameraSpec("b", "nyc", "ZF", 1.0, 1.0)))
    fc = PS.FlashCrowd(base, start_h=10.0, duration_h=2.0, multiplier=100.0,
                       cameras=frozenset({"london"}), cap_fps=12.0)
    inside = {s.stream_id: s.fps for s in fc.streams_at(11.0)}
    outside = {s.stream_id: s.fps for s in fc.streams_at(13.0)}
    assert inside["a"] == 12.0 and inside["b"] == 1.0
    assert outside["a"] == 1.0


def test_flash_crowd_respects_program_feasibility_ceiling():
    base = PS.DiurnalFleet((PS.CameraSpec("v", "london", "VGG16", 1.0, 1.0),))
    fc = PS.FlashCrowd(base, start_h=10.0, duration_h=2.0, multiplier=8.0)
    boosted = fc.streams_at(11.0)[0]
    assert boosted.fps <= boosted.program.max_gpu_fps()
    PC.ResourceManager(PC.fig6_catalog()).plan([boosted], "FFD")


def test_mix_shift_swaps_program_at_night_only():
    views = {}
    for side, (_, sim) in SIDES.items():
        g = ref_geo if side == "ref" else geo
        base = sim.DiurnalFleet(tuple(
            sim.CameraSpec(f"s{i}", "london", "ZF", 0.2, 2.0)
            for i in range(20)))
        ms = sim.MixShift(base, night_program="VGG16", fraction=0.5)
        night = ms.streams_at((0.0 - g.utc_offset_hours("london")) % 24)
        noon = ms.streams_at((12.0 - g.utc_offset_hours("london")) % 24)
        views[side] = (streams_data(night), streams_data(noon))
    assert views["port"] == views["ref"]
    night, noon = views["port"]
    assert {p for _, p, _, _ in night} == {"VGG16", "ZF"}
    assert {p for _, p, _, _ in noon} == {"ZF"}


def test_peak_streams_scan_catches_the_rush_hour():
    fleet = PS.DiurnalFleet((PS.CameraSpec("s", "nyc", "ZF", 0.2, 6.0),))
    peaks = PS.peak_streams(fleet, 24.0, step_h=0.5)
    assert len(peaks) == 1 and peaks[0].fps > 5.5
    ref = RS.peak_streams(RS.DiurnalFleet(
        (RS.CameraSpec("s", "nyc", "ZF", 0.2, 6.0),)), 24.0, step_h=0.5)
    assert streams_data(peaks) == streams_data(ref)


# -- simulator core ------------------------------------------------------------

@pytest.mark.parametrize("name", ["rush_hour", "spot_heavy"])
def test_deterministic_ledger_under_fixed_seed(name):
    a = _both(name, n_streams=16, seed=11)
    assert a.totals() == _run("port", name, n_streams=16, seed=11).totals()


def test_adaptive_beats_static_peak_within_slo_budget():
    static = _both("rush_hour", "StaticPeakPolicy", n_streams=108)
    react = _both("rush_hour", n_streams=108)
    assert react.total_cost < 0.7 * static.total_cost
    assert static.slo_attainment() - react.slo_attainment() <= 0.02


def test_spot_preemptions_conserve_frames_and_replay_streams():
    led = _both("spot_heavy", n_streams=108)
    assert led.preemptions > 0
    for r in led.records:
        assert r.frames_demanded == pytest.approx(
            r.frames_analyzed + r.frames_dropped)
    assert led.slo_attainment() > 0.9


def test_flash_crowd_scenario_with_churn_runs_end_to_end():
    led = _both("flash_crowd", n_streams=12)
    sc = PS.SCENARIOS["flash_crowd"](n_streams=12)
    assert len(led.records) == int(sc.config.duration_h / sc.config.dt_h)
    assert max(r.streams for r in led.records) > 12


def test_steady_scenario_keeps_plan_stable():
    led = _both("steady", n_streams=12)
    assert sum(r.migrations for r in led.records[2:]) == 0
    assert led.slo_attainment() > 0.99


def _constant_demand(core):
    class Constant:
        def streams_at(self, t):
            return [core.Stream("cam", core.PROGRAMS["ZF"], fps=1.0,
                                camera="nyc")]
    return Constant()


def test_boot_delay_drops_only_the_boot_window():
    out = {}
    for side, (core, sim) in SIDES.items():
        cfg = sim.SimConfig(duration_h=3.0, dt_h=1.0, boot_delay_h=0.5,
                            seed=0)
        cat = core.fig6_catalog()
        out[side] = sim.FleetSimulator(
            _constant_demand(core),
            sim.ReactivePolicy(core.ResourceManager(cat)), cat, cfg).run()
    led = out["port"]
    assert rows(led) == rows(out["ref"])
    assert led.records[0].frames_dropped == pytest.approx(1800.0)
    assert led.records[1].frames_dropped == pytest.approx(0.0)
    assert led.records[2].frames_dropped == pytest.approx(0.0)


def test_ledger_rejects_nonconserving_ticks():
    led = PS.Ledger()
    bad = PS.TickRecord(t=0, cost=1.0, frames_demanded=2.0,
                        frames_analyzed=1.0, frames_dropped=0.5,
                        migrations=0, preemptions=0, instances_live=1,
                        streams=1)
    with pytest.raises(ValueError):
        led.add_tick(bad, {})
    assert led.records == [] and led.slo_attainment() == 1.0


def test_repair_policy_cuts_migrations_on_rush_hour():
    react = _both("rush_hour", n_streams=24)
    rep = _both("rush_hour", "RepairPolicy", n_streams=24)
    assert rep.migrations < react.migrations
    assert rep.total_cost < 1.25 * react.total_cost


def test_repair_defrags_reach_the_ledger():
    led = {}
    for side, (core, sim) in SIDES.items():
        sc = sim.SCENARIOS["rush_hour"](n_streams=24)
        cat = sc.catalog()
        led[side] = [sim.FleetSimulator(
            sc.demand, sim.RepairPolicy(core.ResourceManager(cat),
                                        defrag_ratio=ratio),
            cat, sc.config).run() for ratio in (1.0, None)]
    assert [rows(x) for x in led["port"]] == [rows(x) for x in led["ref"]]
    always, never = led["port"]
    assert always.defrags > 0
    assert sum(r.defrags for r in always.records) == \
        always.totals()["defrags"] == always.defrags
    assert never.defrags == 0


def test_churn_storm_scenario_runs_end_to_end():
    led = _both("churn_storm", "RepairPolicy", n_streams=18, duration_h=12.0)
    assert len(led.records) == 12
    assert max(r.streams for r in led.records) > 18
    assert led.slo_attainment() > 0.9


def test_scheduled_and_predictive_policies_match_reference():
    out = {}
    for side, (core, sim) in SIDES.items():
        sc = sim.SCENARIOS["rush_hour"](n_streams=8)
        cat = sc.catalog()
        out[side] = [sim.FleetSimulator(sc.demand, pol, cat, sc.config).run()
                     for pol in (sim.ScheduledPolicy(
                         core.ResourceManager(cat), every_h=6.0),
                         sim.PredictiveEWMAPolicy(core.ResourceManager(cat)))]
    assert [rows(x) for x in out["port"]] == [rows(x) for x in out["ref"]]
    assert all(x.total_cost > 0 for x in out["port"])


def test_ewma_policy_evicts_departed_stream_state():
    pol = PS.PredictiveEWMAPolicy(PC.ResourceManager(PC.fig6_catalog()))

    def s(fps):
        return PC.Stream("cam", PC.PROGRAMS["ZF"], fps=fps, camera="nyc")

    other = PC.Stream("other", PC.PROGRAMS["ZF"], fps=1.0, camera="nyc")
    for fps in (1.0, 3.0, 5.0):
        pol.forecast([s(fps), other])
    assert pol._trend["cam"] > 0
    pol.forecast([other])
    assert "cam" not in pol._prev_fps and "cam" not in pol._trend
    assert "other" in pol._prev_fps
    out = pol.forecast([s(1.0), other])
    rejoined = next(x for x in out if x.stream_id == "cam")
    assert rejoined.fps == pytest.approx(1.0)
    assert pol._trend["cam"] == pytest.approx(0.0)


# -- calibration and the ground-truth probe ------------------------------------

class _StubEngine:
    def __init__(self, rates):
        self._rates = rates

    def measured_rates(self):
        return dict(self._rates)


def test_calibration_caps_analyzed_frames():
    calib = PS.ServiceCalibration.from_engine(_StubEngine({"cam": 4.0}))
    assert calib.frame_rate_cap("cam") == pytest.approx(0.5)
    assert calib.frame_rate_cap("never-measured") == pytest.approx(0.5)
    out = {}
    for side, (core, sim) in SIDES.items():
        cat = core.fig6_catalog()
        out[side] = sim.FleetSimulator(
            _constant_demand(core),
            sim.ReactivePolicy(core.ResourceManager(cat)), cat,
            sim.SimConfig(duration_h=2.0, dt_h=1.0, boot_delay_h=0.0),
            calibration=sim.ServiceCalibration.from_engine(
                _StubEngine({"cam": 4.0}))).run()
    assert rows(out["port"]) == rows(out["ref"])
    for r in out["port"].records:
        assert r.frames_analyzed == pytest.approx(1800.0)
        assert r.frames_dropped == pytest.approx(1800.0)


def test_measured_rates_feed_gpu_packing_items():
    """``packing_streams`` gives the H100 catalog's items (the reference's
    gives TPU ones): the same ids and rates ``gpu_catalog`` builds."""
    from repro_torch.core import gpu_catalog
    eng = _StubEngine({"cam-1": 30.0, "cam-0": 60.0})
    calib = PS.ServiceCalibration.from_engine(eng)
    packed = calib.packing_streams("olmo-1b")
    want = gpu_catalog.streams_from_engine("olmo-1b", eng)
    assert all(isinstance(s, gpu_catalog.LLMStream) for s in packed)
    assert [(s.stream_id, s.tokens_per_s, s.kv_seq) for s in packed] == \
        [(s.stream_id, s.tokens_per_s, s.kv_seq) for s in want] == \
        [("cam-0", 60.0, 32_768), ("cam-1", 30.0, 32_768)]
    plan = gpu_catalog.plan_gpu_fleet(packed, strategy="packed")
    assert plan["hourly_cost"] > 0


def test_service_calibration_edge_conventions():
    bare = PS.ServiceCalibration()
    assert bare.default_rate is None
    assert bare.frame_rate_cap("anything") == math.inf
    with_default = PS.ServiceCalibration(rates_tokens_per_s={"cam": 16.0},
                                         default_rate=8.0)
    assert with_default.frame_rate_cap("cam") == pytest.approx(2.0)
    assert with_default.frame_rate_cap("unmeasured") == pytest.approx(1.0)
    idle = PS.ServiceCalibration.from_engine(_StubEngine({}))
    assert idle.rates_tokens_per_s == {} and idle.default_rate is None
    assert idle.frame_rate_cap("cam") == math.inf


def test_drifting_service_matches_reference():
    """The probe's rates, windowed means, caps and calibrations at times
    around each shift, stream for stream."""
    base = {"a": 64.0, "b": 22.4, "c": 40.0}
    services = {}
    for side, mod in (("ref", RPROBE), ("port", POBS)):
        shifts = (mod.RateShift(at_h=12.0, factor=0.35),
                  mod.RateShift(at_h=6.5, factor=1.5,
                                streams=frozenset({"b"})))
        services[side] = (mod.DriftingService(base, shifts=shifts),
                          mod.DriftingService(base, shifts=shifts,
                                              default_rate=10.0))
    for (ref, port) in zip(services["ref"], services["port"]):
        for t in (0.0, 6.5, 7.0, 11.99, 12.0, 18.0):
            assert port.measure(t) == ref.measure(t) == port.rates_at(t)
            for sid in ("a", "b", "c", "unknown"):
                assert port.frame_rate_cap(sid, t) == \
                    ref.frame_rate_cap(sid, t)
            cal = port.calibration_at(t)
            assert isinstance(cal, PS.ServiceCalibration)
            assert dataclasses.astuple(cal) == \
                dataclasses.astuple(ref.calibration_at(t))
        for t0, t1 in ((0.0, 1.0), (6.0, 7.0), (11.5, 12.5), (5.0, 13.0),
                       (3.0, 3.0)):
            assert port.mean_rates(t0, t1) == ref.mean_rates(t0, t1)
        assert dataclasses.astuple(port.initial_calibration()) == \
            dataclasses.astuple(ref.initial_calibration())
    assert services["port"][0].frame_rate_cap("unknown", 0.0) == math.inf
    assert services["port"][1].frame_rate_cap("unknown", 13.0) == \
        pytest.approx(10.0 * 0.35 / 8.0)


@pytest.mark.parametrize("name", ["drifting_scene", "regional_drift"])
def test_drift_scenarios_cap_by_the_true_service(name):
    """The two scenarios whose ground truth is a ``DriftingService``: a
    whole day capped by it, against the reference."""
    led = _both(name, n_streams=24, service=True)
    sc = PS.SCENARIOS[name](n_streams=24)
    assert isinstance(sc.service, POBS.DriftingService)
    late = [r for r in led.records if r.t >= 12.0]
    assert sum(r.frames_dropped for r in late) > 0


# -- profile → simulate → pack on the port alone --------------------------------

def test_port_engine_calibrates_a_simulated_day(monkeypatch):
    """A reduced olmo-1b port engine serves frames on the CPU; its measured
    rates cap a 2-tick day (every tick within the caps) and become H100
    packing items; the chip phase's calibrated day runs on them too."""
    import importlib.util
    from pathlib import Path

    from repro_torch.checkpoint import init_params
    from repro_torch.core import gpu_catalog
    from repro_torch.launch.serve import measure_and_plan
    from repro_torch.models.config import get_config
    from repro_torch.serving import ContinuousBatchingEngine

    cfg = get_config("olmo-1b", reduced=True)
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         torch.float32, device="cpu")
    eng = ContinuousBatchingEngine(cfg, params, max_slots=2, cache_len=64)
    report = measure_and_plan(eng, n_streams=2, fps=2, seconds=1)
    calib = PS.ServiceCalibration.from_engine(eng)
    assert set(calib.rates_tokens_per_s) == {"cam-0", "cam-1"}
    assert calib.rates_tokens_per_s == eng.measured_rates()
    assert set(report["measured_stream_tokens_per_s"]) == {"cam-0", "cam-1"}
    assert calib.default_rate == pytest.approx(
        sum(calib.rates_tokens_per_s.values()) / 2)

    sc = PS.SCENARIOS["rush_hour"](n_streams=8, duration_h=2.0)
    cat = sc.catalog()
    led = PS.FleetSimulator(sc.demand,
                            PS.ReactivePolicy(PC.ResourceManager(cat)), cat,
                            sc.config, calibration=calib).run()
    assert len(led.records) == 2
    for r in led.records:
        cap = sum(calib.frame_rate_cap(s.stream_id) * 3600.0
                  for s in sc.demand.streams_at(r.t))
        assert r.frames_analyzed <= cap
    items = calib.packing_streams("olmo-1b")
    assert [s.stream_id for s in items] == ["cam-0", "cam-1"]
    assert all(isinstance(s, gpu_catalog.LLMStream) for s in items)

    root = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  root / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    # this process holds the reference too, which the card's phase refuses
    monkeypatch.setattr(cs, "_no_reference_loaded", lambda phase: None)
    day = cs.check_calibrated_day(calib)
    assert day["totals"]["frames_analyzed"] <= \
        day["uncalibrated_frames_analyzed"]
    assert day["default_rate"] == calib.default_rate

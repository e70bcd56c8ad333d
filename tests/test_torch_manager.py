"""The port's resource manager (``repro_torch.core``) against the reference's
(``repro.core``): Fig. 3's nine cells, savings and headline on the port
alone; every strategy of ``STRATEGIES`` on the paper's inputs, plan for
plan; the three catalogs field for field; the public API.

Each side builds its own streams and catalogs from the same numbers, and
plans are compared through ``signature()``, ``summary()`` and
``instance_counts()`` (a port ``Plan`` is not a reference ``Plan``).
Tolerance: exact. Costs are held bit for bit (``float.hex``), since both
sides run the same statements on the same floats.
"""
import ast
from pathlib import Path

import pytest

import repro.core as R
import repro_torch.core as P
from repro.core import geo as ref_geo
from repro_torch.core import geo

EXPECTED = {
    # (scenario, strategy): (cost, non_gpu, gpu)  — None = Fail
    (1, "ST1"): (1.676, 4, 0),
    (1, "ST2"): (0.650, 0, 1),
    (1, "ST3"): (0.650, 0, 1),
    (2, "ST1"): (0.419, 1, 0),
    (2, "ST2"): (0.650, 0, 1),
    (2, "ST3"): (0.419, 1, 0),
    (3, "ST1"): None,
    (3, "ST2"): (7.150, 0, 11),
    (3, "ST3"): (6.919, 1, 10),
}
CAMERA_STRATEGIES = ("ST1", "ST2", "ST3", "FFD", "REPAIR")
LOCATION_STRATEGIES = ("NL", "ARMVAC", "ARMVAC+", "GCL")
# the frame rates of the reference's Fig. 6 tests (ordering and savings)
FIG6_FPS = (0.2, 1.0, 2.0, 5.0, 10.0, 20.0)
# the strategies whose plans the reference's tests require to be optimal
EXACT = ("ST1", "ST2", "ST3", "GCL")


@pytest.fixture(scope="module")
def managers():
    return R.ResourceManager(R.fig3_catalog()), P.ResourceManager(P.fig3_catalog())


@pytest.fixture(scope="module")
def fig6_managers():
    return R.ResourceManager(R.fig6_catalog()), P.ResourceManager(P.fig6_catalog())


def _fig6_streams(ns, geo_mod):
    return [ns.Stream(f"zf-{c}", ns.PROGRAMS["ZF"], fps=1.0, camera=c)
            for c in geo_mod.CAMERAS]


def assert_same_plan(ref_plan, port_plan, strategy):
    """Equal bins (choice key + member keys, in order), bit-equal cost,
    equal instance counts and summary; both optimal where the reference's
    tests require it, and equal ``optimal`` flags everywhere."""
    assert port_plan.signature() == ref_plan.signature()
    assert port_plan.hourly_cost.hex() == ref_plan.hourly_cost.hex()
    assert port_plan.instance_counts() == ref_plan.instance_counts()
    assert port_plan.summary() == ref_plan.summary()
    assert port_plan.strategy == ref_plan.strategy == strategy
    assert port_plan.solution.optimal == ref_plan.solution.optimal
    if strategy in EXACT:
        assert port_plan.solution.optimal and ref_plan.solution.optimal
    P.validate(port_plan.problem, port_plan.solution)


# -- Fig. 3 on the port alone -------------------------------------------------


@pytest.mark.parametrize("scenario,strategy", sorted(EXPECTED))
def test_fig3_cell(managers, scenario, strategy):
    _, mgr = managers
    plan = mgr.plan_or_fail(P.make_streams(P.FIG3_SCENARIOS[scenario]),
                            strategy)
    expected = EXPECTED[(scenario, strategy)]
    if expected is None:
        assert plan is None, "scenario 3 must be infeasible on CPUs only"
        return
    cost, n_cpu, n_gpu = expected
    s = plan.summary()
    assert s["hourly_cost"] == pytest.approx(cost, abs=1e-3)
    assert s["non_gpu_instances"] == n_cpu
    assert s["gpu_instances"] == n_gpu
    assert s["optimal"], "paper-scale instances must be solved to optimality"


def test_fig3_savings_and_headline(managers):
    _, mgr = managers

    def saving(scenario, base):
        streams = P.make_streams(P.FIG3_SCENARIOS[scenario])
        return 1 - (mgr.plan(streams, "ST3").hourly_cost
                    / mgr.plan(streams, base).hourly_cost)

    assert round(100 * saving(1, "ST1")) == 61
    assert round(100 * saving(2, "ST2")) == 36
    assert round(100 * saving(3, "ST2")) == 3
    assert saving(1, "ST1") > 0.50          # ">50% cost reduction"


# -- plan for plan against the reference ---------------------------------------


@pytest.mark.parametrize("strategy", CAMERA_STRATEGIES)
@pytest.mark.parametrize("scenario", (1, 2, 3))
def test_camera_strategy_matches_reference(managers, scenario, strategy):
    ref_mgr, mgr = managers
    ref_plan = ref_mgr.plan_or_fail(R.make_streams(R.FIG3_SCENARIOS[scenario]),
                                    strategy)
    plan = mgr.plan_or_fail(P.make_streams(P.FIG3_SCENARIOS[scenario]),
                            strategy)
    if ref_plan is None:
        assert plan is None
        return
    assert_same_plan(ref_plan, plan, strategy)
    assert mgr.utilization(plan) == ref_mgr.utilization(ref_plan)


@pytest.mark.parametrize("strategy", LOCATION_STRATEGIES)
@pytest.mark.parametrize("fps", FIG6_FPS)
def test_location_strategy_matches_reference(fig6_managers, fps, strategy):
    ref_mgr, mgr = fig6_managers
    ref_plan = ref_mgr.plan(_fig6_streams(R, ref_geo), strategy,
                            target_fps=fps)
    plan = mgr.plan(_fig6_streams(P, geo), strategy, target_fps=fps)
    assert_same_plan(ref_plan, plan, strategy)


def test_fig6_gcl_cheapest_and_savings_on_port(fig6_managers):
    """GCL <= min(ARMVAC, NL) at every fps; up to >=50% below NL and >=31%
    below ARMVAC in the 1-20 fps band (the reference's Fig. 6 claims)."""
    _, mgr = fig6_managers
    streams = _fig6_streams(P, geo)
    best_vs_nl = best_vs_armvac_mid = 0.0
    for fps in FIG6_FPS:
        nl = mgr.plan(streams, "NL", target_fps=fps).hourly_cost
        armvac = mgr.plan(streams, "ARMVAC", target_fps=fps).hourly_cost
        gcl = mgr.plan(streams, "GCL", target_fps=fps).hourly_cost
        assert gcl <= armvac + 1e-9 and gcl <= nl + 1e-9
        best_vs_nl = max(best_vs_nl, 1 - gcl / nl)
        if 1.0 <= fps <= 20.0:
            best_vs_armvac_mid = max(best_vs_armvac_mid, 1 - gcl / armvac)
    assert best_vs_nl >= 0.50
    assert best_vs_armvac_mid >= 0.31


def test_location_strategies_need_target_fps(fig6_managers):
    _, mgr = fig6_managers
    for name in LOCATION_STRATEGIES:
        with pytest.raises(ValueError):
            mgr.plan(_fig6_streams(P, geo), name)


# -- catalogs, programs, geo ---------------------------------------------------


def _catalog_fields(cat):
    return [(t.name, t.capacity, dict(t.prices), t.has_gpu, t.dimensions,
             t.usable(P.UTILIZATION_CAP), t.locations) for t in cat.types]


@pytest.mark.parametrize("name", ("fig3_catalog", "table1_catalog",
                                  "fig6_catalog"))
def test_catalog_field_for_field(name):
    ref_cat, cat = getattr(R, name)(), getattr(P, name)()
    assert _catalog_fields(cat) == _catalog_fields(ref_cat)
    assert cat.locations == ref_cat.locations
    assert [(t.name, loc, price) for t, loc, price in cat.choices()] == \
        [(t.name, loc, price) for t, loc, price in ref_cat.choices()]
    for loc in cat.locations:
        assert [t.name for t in cat.offered_at(loc)] == \
            [t.name for t in ref_cat.offered_at(loc)]
    assert P.UTILIZATION_CAP == R.UTILIZATION_CAP


def test_adversarial_has_gpu_catalog():
    """GPU-ness is read from the catalog's ``has_gpu``, not from the
    instance name: a CPU type named "granite" and a GPU type named "accel"
    give one of each in the optimal plan, on both sides."""
    summaries = []
    for ns in (R, P):
        cat = ns.Catalog(types=(
            ns.InstanceType("granite.2xl", (8.0, 15.0, 0.0, 0.0),
                            {"us-east-1": 0.419}, has_gpu=False),
            ns.InstanceType("accel.xl", (8.0, 15.0, 1.0, 4.0),
                            {"us-east-1": 0.650}, has_gpu=True),
        ))
        streams = [ns.Stream("cpu-cam", ns.PROGRAMS["VGG16"], fps=0.4),
                   ns.Stream("gpu-cam", ns.PROGRAMS["ZF"], fps=8.0)]
        summaries.append(ns.ResourceManager(cat).plan(streams, "ST3").summary())
    assert summaries[1]["gpu_instances"] == 1
    assert summaries[1]["non_gpu_instances"] == 1
    assert summaries[1] == summaries[0]


def test_gpu_speedup():
    """Up to ~16x at high frame rates, <5% at the lowest; every value equal
    to the reference's on a grid of rates."""
    assert 15.0 <= P.ZF.max_gpu_fps() / P.ZF.max_cpu_fps(7.2) <= 17.0
    assert P.ZF.gpu_speedup(0.2) - 1.0 < 0.05
    assert P.VGG16.gpu_speedup(0.25) - 1.0 < 0.05
    assert P.ZF.gpu_speedup(16.0) > 15.0
    for name in ("VGG16", "ZF"):
        ref_prog, prog = R.PROGRAMS[name], P.PROGRAMS[name]
        assert _program_fields(prog) == _program_fields(ref_prog)
        for fps in (0.05, 0.2, 0.25, 0.5, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0):
            assert prog.gpu_speedup(fps).hex() == ref_prog.gpu_speedup(fps).hex()
            assert prog.cpu_requirement(fps) == ref_prog.cpu_requirement(fps)
            assert prog.gpu_requirement(fps) == ref_prog.gpu_requirement(fps)


def _program_fields(prog):
    return tuple(getattr(prog, f) for f in (
        "name", "cpu_cores_per_fps", "cpu_mem_gib", "gpu_frac_per_fps",
        "gpu_mem_base_gib", "gpu_mem_per_fps_gib", "gpu_feed_cores",
        "supports_cpu", "supports_gpu"))


def test_scenarios_pipelines_and_geo():
    assert P.FIG3_SCENARIOS == R.FIG3_SCENARIOS
    assert sorted(P.PIPELINES) == sorted(R.PIPELINES)
    for name in P.PIPELINES:
        assert repr(P.PIPELINES[name]) == repr(R.PIPELINES[name])
    regions = list(geo.DATACENTERS)
    assert regions == list(ref_geo.DATACENTERS)
    assert tuple(geo.CAMERAS) == tuple(ref_geo.CAMERAS)
    for cam in geo.CAMERAS:
        for region in regions:
            assert geo.rtt_ms(cam, region).hex() == \
                ref_geo.rtt_ms(cam, region).hex()
        for fps in FIG6_FPS:
            assert geo.feasible_regions(cam, fps, regions) == \
                ref_geo.feasible_regions(cam, fps, regions)


# -- public API ----------------------------------------------------------------


def test_public_api_mirrors_reference():
    src = Path(R.__file__).read_text()
    tree = ast.parse(src)
    names = next(ast.literal_eval(node.value) for node in tree.body
                 if isinstance(node, ast.Assign)
                 and getattr(node.targets[0], "id", None) == "__all__")
    assert sorted(P.__all__) == sorted(names)
    missing = [n for n in names if not hasattr(P, n)]
    assert not missing, missing
    # every strategy the reference registers, and nothing else
    assert list(P.STRATEGIES) == list(R.STRATEGIES)

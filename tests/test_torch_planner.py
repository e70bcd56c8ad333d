"""The port's planner against the reference's: the exact solver on problems
built by the reference, the H100 catalog and fleet plans, and the serving
launcher's report."""
import pytest

pytest.importorskip("torch")

from repro.core import Stream, build_problem, fig3_catalog, fig6_catalog  # noqa: E402
from repro.core.packing import validate as ref_validate  # noqa: E402
from repro.core.solver import solve as ref_solve  # noqa: E402
from repro.core.tpu_catalog import LLMStream as TpuStream  # noqa: E402
from repro.core.tpu_catalog import build_tpu_problem, tpu_catalog  # noqa: E402
from repro.core.workload import FIG3_SCENARIOS, VGG16, ZF, make_streams  # noqa: E402
from repro.launch.serve import serve as ref_serve  # noqa: E402
from repro_torch.core import gpu_catalog as G  # noqa: E402
from repro_torch.core.heuristics import first_fit_decreasing  # noqa: E402
from repro_torch.core.packing import validate  # noqa: E402
from repro_torch.core.solver import solve  # noqa: E402
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.models.config import get_config  # noqa: E402


def _reference_problem(name):
    """A packing problem built by the reference's own builders."""
    if name.startswith("fig3-"):
        sc = FIG3_SCENARIOS[int(name[5:])]
        return build_problem(make_streams(sc), fig3_catalog(), packed=False)
    if name == "fig6-mixed":
        streams = [Stream(f"s{i}", (VGG16, ZF)[i % 2], 0.5 + 0.5 * (i % 3))
                   for i in range(6)]
        return build_problem(streams, fig6_catalog(), packed=False,
                             locations=["us-east-1", "eu-west-1"])
    llm = [TpuStream(f"llm{i}", "olmo-1b", tokens_per_s=50.0 * (i + 1))
           for i in range(5)]
    return build_tpu_problem(llm, tpu_catalog())


@pytest.mark.parametrize("name", ["fig3-1", "fig3-2", "fig3-3", "fig6-mixed",
                                  "tpu-olmo"])
def test_solve_matches_reference_cost(name):
    problem = _reference_problem(name)
    ref_sol, ref_stats = ref_solve(problem)
    sol, stats = solve(problem)
    assert sol.cost == pytest.approx(ref_sol.cost, abs=1e-9)
    assert sol.optimal == ref_sol.optimal
    ref_validate(problem, sol)                 # the reference accepts it
    assert first_fit_decreasing(problem).cost >= sol.cost - 1e-9


def test_h100_catalog_from_datasheet():
    cat = G.h100_catalog()
    assert [t.name for t in cat.types] == ["h100-1", "h100-2", "h100-4",
                                           "h100-8"]
    one, eight = cat.get("h100-1"), cat.get("h100-8")
    assert one.dimensions == ("tflops", "hbm_gib")
    assert one.capacity == pytest.approx((989.0, 80e9 / 2**30))
    assert eight.capacity == pytest.approx((8 * 989.0, 8 * 80e9 / 2**30))
    assert eight.cheapest_location()[0] == "us-east"


@pytest.mark.parametrize("rates", [
    {"cam-0": 43.8, "cam-1": 43.8, "cam-2": 43.8, "cam-3": 43.8},
    {f"cam-{i}": 20.0 + 37.0 * i for i in range(12)},
])
def test_plan_gpu_fleet_packed_beats_per_stream(rates):
    streams = G.streams_from_measured("olmo-1b", rates)
    plans = {s: G.plan_gpu_fleet(streams, strategy=s)
             for s in ("per-stream", "uniform-big", "packed")}
    assert plans["packed"]["hourly_cost"] <= plans["per-stream"]["hourly_cost"]
    assert plans["packed"]["hourly_cost"] <= plans["uniform-big"]["hourly_cost"]
    assert plans["packed"]["optimal"]
    assert set(plans["uniform-big"]["instances"]) == {"h100-8@us-east"}
    assert sum(plans["per-stream"]["instances"].values()) == len(rates)
    problem = G.build_gpu_problem(streams, G.h100_catalog())
    sol, _ = solve(problem)
    validate(problem, sol)
    ref_validate(problem, sol)
    assert round(sol.cost, 2) == plans["packed"]["hourly_cost"]


def test_requirement_closed_form():
    s = G.LLMStream("cam", "olmo-1b", tokens_per_s=100.0, kv_seq=1024)
    cfg = get_config("olmo-1b")
    tflops, hbm = s.requirement()
    assert tflops == pytest.approx(100.0 * 2 * cfg.param_count() / 1e12)
    kv = 16 * 2 * 1024 * 16 * 128 * 2
    assert hbm == pytest.approx((2 * cfg.param_count() + kv) / 2**30)


def test_serve_cpu_returns_reference_report_keys():
    out = serve("olmo-1b", device="cpu", reduced=True, seconds=1)
    want = ref_serve("olmo-1b", reduced=True, seconds=1)
    assert set(out) == set(want)
    # the port's engine adds the share of its decode steps replayed from
    # a CUDA graph and the share of its dense FLOPs on the split-TF32
    # kernel: none of either on the CPU
    assert set(out["serving_report"]) == set(want["serving_report"]) | {
        "decode_graph_share", "dense_kernel_share"}
    assert out["serving_report"]["decode_graph_share"] == 0.0
    assert out["serving_report"]["dense_kernel_share"] == 0.0
    assert set(out["fleet_plans"]) == set(want["fleet_plans"])
    for s, plan in out["fleet_plans"].items():
        assert set(plan) == set(want["fleet_plans"][s])
    assert out["frames_served"] == want["frames_served"] == 8
    assert out["packed_vs_per_stream_savings"] >= 0.0

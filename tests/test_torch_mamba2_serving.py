"""The port's serving path on reduced mamba2-2.7b against the JAX package:
the continuous-batching engine's greedy tokens and counters, static against
continuous batching, the H100 planner's requirement for a Mamba-2 stream,
and the serving launcher's report."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint.store import save_checkpoint  # noqa: E402
from repro.core.tpu_catalog import LLMStream as TpuStream  # noqa: E402
from repro.launch.serve import serve as ref_serve  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models.config import get_config as jget_config  # noqa: E402
from repro.serving import ContinuousBatchingEngine as JaxEngine  # noqa: E402
from repro.serving import Request as JaxRequest  # noqa: E402
from repro_torch import checkpoint  # noqa: E402
from repro_torch.core import gpu_catalog as G  # noqa: E402
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.models.config import get_config, list_archs  # noqa: E402
from repro_torch.serving import (ContinuousBatchingEngine, Request,  # noqa: E402
                                 ServingEngine)

ARCH = "mamba2-2.7b"
CACHE_LEN = 48
PROMPT_LEN = 16


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    jcfg = jget_config(ARCH, reduced=True)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    path = tmp_path_factory.mktemp("ckpt") / "mamba2-reduced.npz"
    save_checkpoint(str(path), jparams)
    cfg = get_config(ARCH, reduced=True)
    return jcfg, jparams, cfg, checkpoint.load_flat(path, cfg, device="cpu")


def _mixed_requests(cfg, n, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, cfg.vocab_size, PROMPT_LEN).astype(np.int32),
             3 + (i % 4)) for i in range(n)]


def test_same_tokens_and_counters_as_jax_engine(weights):
    jcfg, jparams, cfg, params = weights
    reqs = _mixed_requests(cfg, 6)
    jeng = JaxEngine(jcfg, jparams, max_slots=3, cache_len=CACHE_LEN)
    teng = ContinuousBatchingEngine(cfg, params, max_slots=3,
                                    cache_len=CACHE_LEN)
    assert teng.opts.use_kernels                     # the kernel path
    for i, (t, m) in enumerate(reqs):
        jeng.submit(JaxRequest(f"r{i}", t.copy(), max_new_tokens=m))
        teng.submit(Request(f"r{i}", t.copy(), max_new_tokens=m))
    jdone = {r.request_id: r.output for r in jeng.drain()}
    tdone = {r.request_id: r.output for r in teng.drain()}
    assert set(jdone) == set(tdone) == {f"r{i}" for i in range(6)}
    for k in jdone:
        np.testing.assert_array_equal(tdone[k], jdone[k])
    for key in ("requests", "tokens_generated", "prefills", "decode_steps"):
        assert teng.stats[key] == jeng.stats[key], key
    assert teng.cache[0]["state"].dtype == torch.float32


def test_static_engine_matches_continuous(weights):
    """Mirrors test_serving_engine.py::test_continuous_matches_static_greedy_
    tokens for mamba2-2.7b, on the port's two engines."""
    _, _, cfg, params = weights
    reqs = _mixed_requests(cfg, 6, seed=1)
    static = ServingEngine(cfg, params, max_batch=3, cache_len=CACHE_LEN)
    cont = ContinuousBatchingEngine(cfg, params, max_slots=3,
                                    cache_len=CACHE_LEN)
    for i, (t, m) in enumerate(reqs):
        static.submit(Request(f"r{i}", t.copy(), max_new_tokens=m))
        cont.submit(Request(f"r{i}", t.copy(), max_new_tokens=m))
    sdone = {r.request_id: r.output for r in static.drain()}
    cdone = {r.request_id: r.output for r in cont.drain()}
    assert set(sdone) == set(cdone)
    for k in sdone:
        np.testing.assert_array_equal(sdone[k], cdone[k])


@pytest.mark.parametrize("rate", [1.0, 43.8, 250.0])
def test_requirement_equals_reference_closed_form(rate):
    got = G.LLMStream("s", ARCH, tokens_per_s=rate).requirement()
    want = TpuStream("s", ARCH, tokens_per_s=rate).requirement()
    assert got == pytest.approx(want, rel=1e-12)
    cfg = get_config(ARCH)
    state = 64 * 80 * 64 * 128 * 4           # fp32 SSM state per layer
    assert got[0] == pytest.approx(rate * 2 * 2_830_788_096 / 1e12)
    assert got[1] == pytest.approx((2 * cfg.param_count() + state) / 2**30)


def test_plan_gpu_fleet_for_mamba2_streams():
    streams = G.streams_from_measured(ARCH, {f"cam-{i}": 30.0 + 10 * i
                                             for i in range(6)})
    plans = {s: G.plan_gpu_fleet(streams, strategy=s)
             for s in ("per-stream", "uniform-big", "packed")}
    assert plans["packed"]["hourly_cost"] <= plans["per-stream"]["hourly_cost"]
    assert plans["packed"]["optimal"]
    assert sum(plans["per-stream"]["instances"].values()) == 6


def test_serve_cpu_returns_reference_report_keys():
    assert ARCH in list_archs()
    out = serve(ARCH, device="cpu", reduced=True, seconds=1)
    want = ref_serve(ARCH, reduced=True, seconds=1)
    assert out["arch"] == want["arch"] == ARCH
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
    assert out["serving_report"]["requests"] == 8

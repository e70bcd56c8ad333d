"""The port's serving engines against the JAX engine on reduced olmo-1b with
the same weights, the stats semantics the planner and the observability
layer rely on, and the reference consumers those exports feed."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint.store import save_checkpoint  # noqa: E402
from repro.core.tpu_catalog import streams_from_engine  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models.config import get_config as jget_config  # noqa: E402
from repro.obs.regional import EngineWindowProbe  # noqa: E402
from repro.serving import ContinuousBatchingEngine as JaxEngine  # noqa: E402
from repro.serving import Request as JaxRequest  # noqa: E402
from repro.sim.ledger import ServiceCalibration  # noqa: E402
from repro_torch import checkpoint  # noqa: E402
from repro_torch.models.config import get_config  # noqa: E402
from repro_torch.serving import (ContinuousBatchingEngine, Request,  # noqa: E402
                                 ServingEngine, StreamSimulator)

CACHE_LEN = 48
PROMPT_LEN = 16


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    jcfg = jget_config("olmo-1b", reduced=True)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    path = tmp_path_factory.mktemp("ckpt") / "olmo-1b-reduced.npz"
    save_checkpoint(str(path), jparams)
    cfg = get_config("olmo-1b", reduced=True)
    return jcfg, jparams, cfg, checkpoint.load_flat(path, cfg, device="cpu")


def _engine(weights, slots=2):
    _, _, cfg, params = weights
    return ContinuousBatchingEngine(cfg, params, max_slots=slots,
                                    cache_len=CACHE_LEN)


def _toks(cfg, rng):
    return rng.integers(0, cfg.vocab_size, PROMPT_LEN).astype(np.int32)


def _mixed_requests(cfg, n, seed=0):
    rng = np.random.default_rng(seed)
    return [(_toks(cfg, rng), 3 + (i % 4)) for i in range(n)]


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


def test_static_engine_matches_continuous(weights):
    _, _, cfg, params = weights
    reqs = _mixed_requests(cfg, 4, seed=1)
    static = ServingEngine(cfg, params, max_batch=2, cache_len=CACHE_LEN)
    cont = _engine(weights, slots=2)
    for i, (t, m) in enumerate(reqs):
        static.submit(Request(f"r{i}", t.copy(), max_new_tokens=m))
        cont.submit(Request(f"r{i}", t.copy(), max_new_tokens=m))
    sdone = {r.request_id: r.output for r in static.drain()}
    cdone = {r.request_id: r.output for r in cont.drain()}
    assert set(sdone) == set(cdone)
    for k in sdone:
        np.testing.assert_array_equal(sdone[k], cdone[k])


def test_static_engine_rejects_unequal_prompts(weights):
    _, _, cfg, params = weights
    static = ServingEngine(cfg, params, max_batch=2, cache_len=CACHE_LEN)
    static.submit(Request("a", np.zeros(8, np.int32), max_new_tokens=2))
    static.submit(Request("b", np.zeros(9, np.int32), max_new_tokens=2))
    with pytest.raises(ValueError):
        static.step()


@pytest.mark.parametrize("engine", ["static", "continuous"])
def test_request_past_cache_len_is_refused_at_submit(weights, engine):
    """A 16-token prompt with 8 new tokens does not fit a cache of 20: both
    engines refuse it at ``submit`` and queue nothing (the reference's
    static engine takes it and clamps the last writes), and a request that
    just fits is taken."""
    _, _, cfg, params = weights
    cls = ServingEngine if engine == "static" else ContinuousBatchingEngine
    size = {"max_batch" if engine == "static" else "max_slots": 2}
    eng = cls(cfg, params, cache_len=20, **size)
    toks = _toks(cfg, np.random.default_rng(3))
    with pytest.raises(ValueError, match="cache_len 20"):
        eng.submit(Request("long", toks, max_new_tokens=8))
    assert eng.queue == []
    assert eng.drain() == []
    eng.submit(Request("fits", toks, max_new_tokens=4))
    (done,) = eng.drain()
    assert done.request_id == "fits" and len(done.output) == 4


def test_finished_slot_reused_and_edf_admission(weights):
    _, _, cfg, _ = weights
    rng = np.random.default_rng(0)
    eng = _engine(weights, slots=2)
    eng.submit(Request("short", _toks(cfg, rng), max_new_tokens=2))
    eng.submit(Request("long", _toks(cfg, rng), max_new_tokens=8))
    eng.submit(Request("queued", _toks(cfg, rng), max_new_tokens=4))
    assert [r.request_id for r in eng.step()] == ["short"]
    freed = eng._slot_req.index(None)
    eng.step()
    assert eng._slot_req[freed].request_id == "queued"
    eng.drain()
    assert eng.stats["prefills"] == 3

    eng = _engine(weights, slots=1)
    eng.submit(Request("lazy", _toks(cfg, rng), max_new_tokens=2,
                       deadline_s=60.0))
    eng.submit(Request("urgent", _toks(cfg, rng), max_new_tokens=2,
                       deadline_s=0.01))
    assert [r.request_id for r in eng.drain()] == ["urgent", "lazy"]
    with pytest.raises(ValueError):
        eng.submit(Request("big", np.zeros(40, np.int32), max_new_tokens=9))


def test_report_with_no_completions(weights):
    eng = _engine(weights)
    rep = eng.report()
    assert rep["requests"] == 0 and rep["tokens_per_s"] == 0.0
    assert rep["p50_latency_s"] is None and rep["p99_latency_s"] is None
    assert rep["slo_attainment"] is None           # no evidence, not 1.0
    assert rep["slot_occupancy"] == 0.0
    assert eng.measured_rates() == {}
    assert eng.windowed_rates() == {}              # empty window is {}


def test_measured_rates_late_joiner_not_diluted(weights):
    _, _, cfg, _ = weights
    rng = np.random.default_rng(11)
    eng = _engine(weights)
    eng.submit(Request("r0", _toks(cfg, rng), max_new_tokens=12,
                       stream_id="early"))
    eng.drain()
    wall_before_join = eng.stats["wall_s"]
    eng.submit(Request("r1", _toks(cfg, rng), max_new_tokens=12,
                       stream_id="late"))
    eng.drain()
    rates = eng.measured_rates()
    first, last = eng._stream_window["late"]
    assert first >= wall_before_join
    late_tokens = eng._stream_tokens["late"]
    assert rates["late"] == pytest.approx(late_tokens / (last - first))
    assert rates["late"] > late_tokens / eng.stats["wall_s"]


def test_windowed_rates_partition_exactly_and_idle_window_is_empty(weights):
    _, _, cfg, _ = weights
    rng = np.random.default_rng(21)
    eng = _engine(weights)
    eng.submit(Request("r0", _toks(cfg, rng), max_new_tokens=6,
                       stream_id="cam-0"))
    eng.drain()
    wall_0 = eng._rate_snapshot[0]
    first = eng.windowed_rates()
    wall_1, tokens_1 = eng._rate_snapshot
    assert eng.windowed_rates() == {}              # idle window: {}
    eng.submit(Request("r1", _toks(cfg, rng), max_new_tokens=4,
                       stream_id="cam-0"))
    eng.submit(Request("r2", _toks(cfg, rng), max_new_tokens=5,
                       stream_id="cam-1"))
    eng.drain()
    second = eng.windowed_rates()
    wall_2, tokens_2 = eng._rate_snapshot
    span_1, span_2 = wall_1 - wall_0, wall_2 - wall_1
    assert set(first) == {"cam-0"} and set(second) == {"cam-0", "cam-1"}
    for sid in ("cam-0", "cam-1"):
        assert (first.get(sid, 0.0) * span_1 + second.get(sid, 0.0) * span_2
                == pytest.approx(tokens_2[sid]))


def test_stream_simulator_and_report(weights):
    eng = _engine(weights)
    sim = StreamSimulator(eng, prompt_len=PROMPT_LEN, new_tokens=3)
    for _ in range(2):
        sim.tick({"fast": 2.0, "slow": 0.5}, dt_s=1.0)
        eng.drain()
    rep = eng.report()
    assert rep["requests"] == eng.stats["requests"] == 5
    assert 0.0 <= rep["slo_attainment"] <= 1.0
    assert 0.0 <= rep["p50_latency_s"] <= rep["p99_latency_s"]
    assert 0.0 < rep["slot_occupancy"] <= 1.0
    assert set(eng.measured_rates()) == {"fast", "slow"}


def test_plugs_into_reference_consumers(weights):
    """ServiceCalibration.from_engine, EngineWindowProbe and
    streams_from_engine take the port's engine unchanged."""
    _, _, cfg, _ = weights
    rng = np.random.default_rng(31)
    engines = {"nyc": _engine(weights), "tokyo": _engine(weights)}
    for region, eng in engines.items():
        eng.submit(Request(f"{region}-r0", _toks(cfg, rng), max_new_tokens=4,
                           stream_id=f"{region}-cam"))
        eng.drain()

    calib = ServiceCalibration.from_engine(engines["nyc"])
    assert set(calib.rates_tokens_per_s) == {"nyc-cam"}
    assert calib.frame_rate_cap("nyc-cam") == pytest.approx(
        engines["nyc"].measured_rates()["nyc-cam"] / 8.0)

    probe = EngineWindowProbe(engines)
    assert set(probe.initial_calibration().rates_tokens_per_s) == {
        "nyc-cam", "tokyo-cam"}
    window = probe.measure(0.0)
    assert set(window) == {"nyc-cam", "tokyo-cam"}
    assert probe.group_of("tokyo-cam") == "tokyo"
    assert probe.measure(1.0) == {}                # idle: no evidence

    streams = streams_from_engine("olmo-1b", engines["tokyo"])
    assert [s.stream_id for s in streams] == ["tokyo-cam"]
    assert streams[0].tokens_per_s > 0

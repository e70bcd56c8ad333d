"""The port's GQA decoders, reduced yi-9b and nemotron-4-15b (relu2 MLP,
layernorm), against the JAX package with the same weights (JAX initialises
them, ``save_checkpoint`` writes the flat npz, ``load_flat`` reads it):
prefill into slots and per-row decode with the kernels off and on (on: the
reference's Pallas kernel in interpret mode, the port's plain flash
version), the ``window_override`` option with a ring and with a full cache,
the serving engines, ``serve("yi-9b")`` and the H100 plan from its measured
rates. fp32 at 2e-5."""
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
from repro.models.steps import (make_jitted_decode,  # noqa: E402
                                make_jitted_prefill_into_slot)
from repro.serving import ContinuousBatchingEngine as JaxEngine  # noqa: E402
from repro.serving import Request as JaxRequest  # noqa: E402
from repro_torch import checkpoint  # noqa: E402
from repro_torch.core import gpu_catalog as G  # noqa: E402
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import steps  # noqa: E402
from repro_torch.models.config import get_config, list_archs  # noqa: E402
from repro_torch.serving import (ContinuousBatchingEngine, Request,  # noqa: E402
                                 ServingEngine)

ARCHS = ("yi-9b", "nemotron-4-15b")
CACHE_LEN = 48
TOL = dict(atol=2e-5, rtol=2e-5)


@pytest.fixture(scope="module", params=ARCHS)
def weights(request, tmp_path_factory):
    arch = request.param
    jcfg = jget_config(arch, reduced=True)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    path = tmp_path_factory.mktemp("ckpt") / f"{arch}.npz"
    save_checkpoint(str(path), jparams)
    cfg = get_config(arch, reduced=True)
    return jcfg, jparams, cfg, checkpoint.load_flat(path, cfg, device="cpu")


def _slots_then_decode(weights, opts_kw, use_kernels, lengths, n_steps):
    """Prompts of ``lengths`` prefilled into slots 0.., then ``n_steps``
    decode steps of all rows at per-row positions, through both packages;
    logits compared at every step. Returns the port's cache."""
    jcfg, jparams, cfg, params = weights
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in lengths]
    B = len(prompts)
    jopts = JM.ModelOptions(use_kernels=use_kernels, remat=False, **opts_kw)
    jslot = make_jitted_prefill_into_slot(jcfg, jopts, CACHE_LEN)
    jdecode = make_jitted_decode(jcfg, jopts)
    jcache = JM.init_cache(jcfg, B, CACHE_LEN, jnp.float32, jopts)
    opts = M.ModelOptions(use_kernels=use_kernels, **opts_kw)
    cache = M.init_cache(cfg, B, CACHE_LEN, torch.float32, opts, device="cpu")
    first = []
    for slot, toks in enumerate(prompts):
        jl, jcache = jslot(jparams, jcache,
                           {"tokens": jnp.asarray(toks[None])}, slot)
        tl, cache = steps.prefill_into_slot_step(
            params, cache, {"tokens": torch.from_numpy(toks[None]).long()},
            slot, cfg, opts, CACHE_LEN)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        first.append(int(np.argmax(np.asarray(jl))))
    tok = np.asarray(first, np.int32)
    pos = np.array(lengths, np.int32)
    for _ in range(n_steps):
        jl, jcache = jdecode(jparams, jcache, {"token": jnp.asarray(tok),
                                               "pos": jnp.asarray(pos)})
        tl, cache = steps.decode_step(
            params, cache, {"token": torch.from_numpy(tok).long(),
                            "pos": torch.from_numpy(pos).long()}, cfg, opts)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        np.testing.assert_array_equal(tl.argmax(-1).numpy(),
                                      np.asarray(jl).argmax(-1))
        tok = np.asarray(jl).argmax(-1).astype(np.int32)
        pos = pos + 1
    for layer, c in enumerate(cache):
        np.testing.assert_allclose(c["k"].numpy(),
                                   np.asarray(jcache["scan"][0]["k"][layer]),
                                   **TOL)
    return cache


@pytest.mark.parametrize("use_kernels", [False, True])
def test_prefill_and_per_row_decode_match_reference(weights, use_kernels):
    """Two prompts of 12 and 16 tokens into slots 0 and 1, then 4 decode
    steps together at per-row positions."""
    _slots_then_decode(weights, {}, use_kernels, (12, 16), 4)


@pytest.mark.parametrize("ring", [False, True])
def test_window_override_matches_reference(weights, ring):
    """The long-context option on a dense model: every layer attends over a
    window of 8. Prompts of 10 and 14 tokens pass it in prefill; 5 decode
    steps pass it again from the ring (8 rows) or from the full cache with
    the window mask."""
    cache = _slots_then_decode(weights, {"window_override": 8,
                                         "ring_cache": ring}, False,
                               (10, 14), 5)
    assert cache[0]["k"].shape[1] == (8 if ring else CACHE_LEN)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_gqa_expand_kv_forward_hidden_matches_reference(weights, use_kernels):
    """``gqa_expand_kv`` on the one path that takes it, ``forward_hidden``:
    the same hidden states as the reference with the option, and as the
    port without it."""
    jcfg, jparams, cfg, params = weights
    toks = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 16)).astype(np.int32)
    want, _ = JM.forward_hidden(jparams, {"tokens": jnp.asarray(toks)}, jcfg,
                                JM.ModelOptions(use_kernels=use_kernels,
                                                remat=False,
                                                gqa_expand_kv=True))
    batch = {"tokens": torch.from_numpy(toks).long()}
    with torch.no_grad():
        got, _ = M.forward_hidden(params, batch, cfg, M.ModelOptions(
            use_kernels=use_kernels, gqa_expand_kv=True))
        plain, _ = M.forward_hidden(params, batch, cfg,
                                    M.ModelOptions(use_kernels=use_kernels))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    torch.testing.assert_close(got, plain, atol=1e-5, rtol=1e-5)


def test_gqa_expand_kv_is_refused_where_a_cache_is_filled(weights):
    """A prefill with ``gqa_expand_kv`` would return H-head K/V for a
    K-head decode cache: ``prefill``, the slot step and both engines'
    constructors refuse it before any work."""
    _, _, cfg, params = weights
    assert cfg.num_kv_heads < cfg.num_heads
    opts = M.ModelOptions(use_kernels=False, gqa_expand_kv=True)
    batch = {"tokens": torch.zeros((1, 8), dtype=torch.long)}
    cache = M.init_cache(cfg, 2, CACHE_LEN, torch.float32,
                         M.ModelOptions(use_kernels=False), device="cpu")
    with pytest.raises(ValueError, match="gqa_expand_kv"):
        M.prefill(params, batch, cfg, opts, CACHE_LEN)
    with pytest.raises(ValueError, match="gqa_expand_kv"):
        steps.prefill_into_slot_step(params, cache, batch, 0, cfg, opts,
                                     CACHE_LEN)
    for engine in (ServingEngine, ContinuousBatchingEngine):
        with pytest.raises(ValueError, match="gqa_expand_kv"):
            engine(cfg, params, cache_len=CACHE_LEN, opts=opts)


def _mixed_requests(cfg, n, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, cfg.vocab_size, 14 + i % 3).astype(np.int32),
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
    assert teng.cache[0]["k"].shape == (3, CACHE_LEN, cfg.num_kv_heads,
                                        cfg.head_dim)


def test_static_engine_matches_continuous(weights):
    _, _, cfg, params = weights
    rng = np.random.default_rng(1)
    reqs = [(rng.integers(0, cfg.vocab_size, 16).astype(np.int32), 3 + i % 4)
            for i in range(6)]
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


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("rate", [1.0, 64.0])
def test_requirement_equals_reference_closed_form(arch, rate):
    got = G.LLMStream("s", arch, tokens_per_s=rate).requirement()
    want = TpuStream("s", arch, tokens_per_s=rate).requirement()
    assert got == pytest.approx(want, rel=1e-12)
    cfg = get_config(arch)
    kv = 2 * 32_768 * cfg.num_kv_heads * cfg.head_dim * 2 * cfg.num_layers
    assert got[1] == pytest.approx((2 * cfg.param_count() + kv) / 2**30)


def test_serve_yi9b_cpu_and_plan_from_measured_rates():
    assert set(ARCHS) | {"internvl2-1b", "hubert-xlarge"} <= set(list_archs())
    out = serve("yi-9b", device="cpu", reduced=True, seconds=1)
    want = ref_serve("yi-9b", reduced=True, seconds=1)
    assert out["arch"] == want["arch"] == "yi-9b"
    assert set(out) == set(want)
    assert set(out["serving_report"]) == set(want["serving_report"])
    assert out["frames_served"] == want["frames_served"] == 8
    for s, plan in out["fleet_plans"].items():
        assert set(plan) == set(want["fleet_plans"][s])
    streams = G.streams_from_measured("yi-9b",
                                      out["measured_stream_tokens_per_s"])
    plans = {s: G.plan_gpu_fleet(streams, strategy=s)
             for s in ("per-stream", "uniform-big", "packed")}
    assert plans["packed"]["hourly_cost"] <= plans["per-stream"]["hourly_cost"]
    assert sum(plans["per-stream"]["instances"].values()) == 4


@pytest.mark.parametrize("arch", ["internvl2-1b", "hubert-xlarge"])
def test_serve_refuses_frontend_and_encoder_archs_before_drawing_weights(
        arch, monkeypatch):
    """A request carries tokens only, so a vision or audio model (and an
    encoder, which has no decode) cannot be served; ``serve`` refuses it
    before any weights are drawn. The reference fails later, in prefill."""
    from repro_torch.launch import serve as serve_mod

    def no_weights(*a, **kw):
        raise AssertionError("weights drawn")

    monkeypatch.setattr(serve_mod, "init_params", no_weights)
    with pytest.raises(ValueError, match="does not serve token requests"):
        serve(arch, device="cpu", reduced=True, seconds=1)
    with pytest.raises(KeyError):
        ref_serve(arch, reduced=True, seconds=1)

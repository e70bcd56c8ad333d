"""The port's MoE family (``repro_torch.models.moe`` and the ``("attn",
"moe")`` blocks) against the JAX package with the same weights: the three
MoE configurations; ``apply_moe`` in fp32 and bf16 at the default
capacity, at one where tokens drop and at an ample one; top-k ties; three
of the reference's MoE property tests (the fourth, local against global
dispatch, comes with the distributed layer) and batch-global capacity;
reduced qwen3-moe prefill and decode, ``forward_hidden``'s aux, both
engines, ``serve`` and ``measure_and_plan`` with bf16 weights; the weight
bridge's MoE leaves. Module tolerances fp32 2e-5 and bf16 2e-2; model
logits fp32 2e-5."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint.store import save_checkpoint  # noqa: E402
from repro.launch.serve import serve as ref_serve  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import moe as JMoE  # noqa: E402
from repro.models.config import get_config as jget_config  # noqa: E402
from repro.serving import ContinuousBatchingEngine as JaxEngine  # noqa: E402
from repro.serving import Request as JaxRequest  # noqa: E402
from repro.serving import ServingEngine as JaxStaticEngine  # noqa: E402
from repro_torch import checkpoint  # noqa: E402
from repro_torch.core import gpu_catalog as G  # noqa: E402
from repro_torch.launch.serve import measure_and_plan, serve  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.config import get_config  # noqa: E402
from repro_torch.serving import (ContinuousBatchingEngine, Request,  # noqa: E402
                                 ServingEngine)

ARCHS = ("qwen3-moe-30b-a3b", "moonshot-v1-16b-a3b", "grok-1-314b")
QWEN = ARCHS[0]
TOL = {"float32": dict(atol=2e-5, rtol=2e-5),
       "bfloat16": dict(atol=2e-2, rtol=2e-2)}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
CACHE_LEN = 48


def _cfgs(arch, capacity_factor=None):
    jcfg, cfg = jget_config(arch, reduced=True), get_config(arch, reduced=True)
    if capacity_factor is not None:
        jcfg = dataclasses.replace(jcfg, capacity_factor=capacity_factor)
        cfg = dataclasses.replace(cfg, capacity_factor=capacity_factor)
    return jcfg, cfg


def _to_torch(tree, dtype):
    return {k: torch.tensor(np.asarray(v.astype(jnp.float32)), dtype=dtype)
            for k, v in tree.items()}


def _moe_weights(jcfg, dtype_name, seed=0):
    jdt, tdt = DTYPES[dtype_name]
    jp = JMoE.init_moe(jcfg, jax.random.PRNGKey(seed), jdt)
    return jp, _to_torch(jp, tdt)


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# ---------------- configs ----------------

@pytest.mark.parametrize("arch", ARCHS)
def test_config_and_param_counts_equal_the_reference(arch):
    for reduced in (False, True):
        cfg, jcfg = get_config(arch, reduced), jget_config(arch, reduced)
        ours, theirs = dataclasses.asdict(cfg), dataclasses.asdict(jcfg)
        # every field of the reference's equal; the port's own fields
        # (held and shared experts, multipliers, eps) at their defaults
        assert {k: ours[k] for k in theirs} == theirs
        defaults = dataclasses.asdict(dataclasses.replace(
            cfg, **{f.name: f.default for f in dataclasses.fields(cfg)
                    if f.name not in theirs}))
        assert ours == defaults
        assert cfg.param_count() == jcfg.param_count()
        assert cfg.active_param_count() == jcfg.active_param_count()
        assert ("attn", "moe") in M.KINDS
        assert set(cfg.layer_kinds) == {("attn", "moe")}
    assert get_config(QWEN).param_count() == 30_532_110_336
    assert get_config(ARCHS[1]).param_count() == 28_057_995_264


# ---------------- the MoE layer ----------------

@pytest.mark.parametrize("batch", [(2, 16), (3, 7)], ids=["2x16", "3x7"])
@pytest.mark.parametrize("capacity_factor", [None, 0.5, 8.0],
                         ids=["cf-default", "cf-0.5", "cf-8"])
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_apply_moe_matches_reference(arch, dtype_name, capacity_factor,
                                     batch):
    """Output and aux on (B, S, D) tokens, S a multiple of 4 or not; at a
    capacity factor of 0.5 some entries drop (checked)."""
    jcfg, cfg = _cfgs(arch, capacity_factor)
    jp, tp = _moe_weights(jcfg, dtype_name)
    jdt, tdt = DTYPES[dtype_name]
    x = _x((*batch, cfg.d_model))
    want, jaux = JMoE.apply_moe(jp, jnp.asarray(x, jdt), jcfg)
    xt = torch.tensor(x, dtype=tdt)
    got, aux = moe.apply_moe(tp, xt, cfg)
    assert got.dtype == tdt and got.shape == xt.shape
    assert aux.dtype == torch.float32 and aux.shape == ()
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               **TOL[dtype_name])
    np.testing.assert_allclose(aux.item(), float(jaux), rtol=1e-6)
    if capacity_factor == 0.5:
        tokens = xt.reshape(-1, cfg.d_model)
        _, _, ids = moe._route(tp["router"], tokens, cfg)
        _, within = moe._slots(ids, moe.capacity(tokens.shape[0], cfg), cfg)
        assert not within.all()                    # some entries dropped


@pytest.mark.parametrize("capacity_factor", [0.5, 8.0])
def test_top_k_ties_go_to_the_lower_expert(capacity_factor):
    """A router whose columns 1 and 3 are equal gives every token equal
    probabilities for experts 1 and 3. The port picks expert 1, as
    ``jax.lax.top_k`` does (``torch.topk`` need not), so the experts, the
    slot positions and the output equal the reference's."""
    jcfg, cfg = _cfgs(QWEN, capacity_factor)
    jp, _ = _moe_weights(jcfg, "float32")
    router = np.asarray(jp["router"]).copy()
    router[:, 3] = router[:, 1]
    jp = dict(jp, router=jnp.asarray(router))
    tp = _to_torch(jp, torch.float32)
    x = _x((1, 32, cfg.d_model), seed=5)
    K = cfg.experts_per_token

    jprobs = jax.nn.softmax((jnp.asarray(x[0]) @ jp["router"]), axis=-1)
    _, jids = jax.lax.top_k(jprobs, K)
    probs, _, ids = moe._route(tp["router"], torch.tensor(x[0]), cfg)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    # the tie decides: one of experts 1, 3 is in the top K, the other not
    p = probs.numpy()
    kth = np.sort(p, axis=-1)[:, ::-1][:, K - 1]
    at_boundary = (p[:, 1] == p[:, 3]) & (p[:, 1] == kth) & \
        (np.sort(p, axis=-1)[:, ::-1][:, K] == kth)
    assert at_boundary.sum() >= 3
    assert (ids.numpy()[at_boundary] != 3).all()

    # slot positions as the reference counts them (row-major (t, k))
    T, E = x.shape[1], cfg.num_experts
    C = moe.capacity(T, cfg)
    oh = jax.nn.one_hot(jids, E).reshape(T * K, E)
    jpos = jnp.sum((jnp.cumsum(oh, axis=0) - oh) * oh, axis=-1)
    jdest = jnp.where(jpos < C, jids.reshape(-1) * C + jpos, E * C)
    dest, _ = moe._slots(ids, C, cfg)
    np.testing.assert_array_equal(dest.numpy(), np.asarray(jdest))

    want, _ = JMoE.apply_moe(jp, jnp.asarray(x), jcfg)
    got, _ = moe.apply_moe(tp, torch.tensor(x), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **TOL["float32"])


def test_moe_balance_loss_bounds():
    jcfg, cfg = _cfgs(QWEN)
    _, tp = _moe_weights(jcfg, "float32")
    x = torch.tensor(_x((2, 32, cfg.d_model)))
    out, aux = moe.apply_moe(tp, x, cfg)
    assert out.shape == x.shape
    assert aux.item() >= 1.0 - 1e-3        # perfectly balanced aux == 1.0


def test_moe_capacity_drops_tokens():
    """With capacity_factor -> 0+ the capacity is its floor of 4 slots an
    expert, so most of 64 tokens drop."""
    jcfg, cfg = _cfgs(QWEN, 1e-9)
    _, tp = _moe_weights(jcfg, "float32")
    x = torch.tensor(_x((1, 64, cfg.d_model)))
    out, _ = moe.apply_moe(tp, x, cfg)
    assert moe.capacity(64, cfg) == 4
    assert out.abs().mean() < x.abs().mean()
    assert (out.abs().sum(-1) == 0).sum() >= 64 - 4 * cfg.num_experts


def test_moe_is_token_independent():
    """At ample capacity, permuting tokens permutes outputs."""
    jcfg, cfg = _cfgs(QWEN, 8.0)
    _, tp = _moe_weights(jcfg, "float32")
    x = torch.tensor(_x((1, 16, cfg.d_model)))
    out1, _ = moe.apply_moe(tp, x, cfg)
    perm = torch.as_tensor(np.random.default_rng(2).permutation(16))
    out2, _ = moe.apply_moe(tp, x[:, perm], cfg)
    torch.testing.assert_close(out1[:, perm], out2, atol=2e-5, rtol=2e-5)


def test_moe_capacity_is_counted_over_the_whole_batch():
    """Where tokens drop, a sequence's output depends on the sequences
    beside it (capacity and slot positions count every token of the
    batch), in the port as in the reference: the first sequence alone and
    beside another both equal the reference's."""
    jcfg, cfg = _cfgs(QWEN, 0.5)
    jp, tp = _moe_weights(jcfg, "float32")
    x = _x((2, 32, cfg.d_model))
    alone, _ = moe.apply_moe(tp, torch.tensor(x[:1]), cfg)
    beside, _ = moe.apply_moe(tp, torch.tensor(x), cfg)
    assert not torch.allclose(alone[0], beside[0], atol=1e-3)
    for xs, got in ((x[:1], alone), (x, beside)):
        want, _ = JMoE.apply_moe(jp, jnp.asarray(xs), jcfg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **TOL["float32"])


@pytest.mark.parametrize("T,want", [(8, 4), (32, 4), (64, 8), (100, 8),
                                    (1000, 80)])
def test_capacity_is_the_reference_formula(T, want):
    """qwen3-moe's 8 decode slots and 32-token prefill both give 4 slots
    an expert (T·K/E·1.25 = 0.625 and 2.5)."""
    assert moe.capacity(T, get_config(QWEN)) == want


# ---------------- the model ----------------

@pytest.fixture(scope="module")
def qwen(tmp_path_factory):
    jcfg = jget_config(QWEN, reduced=True)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    path = tmp_path_factory.mktemp("ckpt") / "qwen.npz"
    save_checkpoint(str(path), jparams)
    cfg = get_config(QWEN, reduced=True)
    return jcfg, jparams, cfg, checkpoint.load_flat(path, cfg, device="cpu"), \
        path


def _routing_margin(recorded, K):
    """The least gap, over every token the recorded MoE layers routed,
    between the K-th and (K+1)-th router probabilities, computed by the
    reference's ops (jnp softmax of the fp32 logits)."""
    least = np.inf
    for x, router in recorded:
        logits = (jnp.asarray(x) @ jnp.asarray(router)).astype(jnp.float32)
        top, _ = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), K + 1)
        least = min(least, float(jnp.min(top[..., K - 1] - top[..., K])))
    return least


@pytest.mark.parametrize("use_kernels", [False, True])
def test_prefill_and_decode_match_reference(qwen, use_kernels, monkeypatch):
    """Two 12-token prompts prefilled together, then 4 decode steps; the
    logits at every step within 2e-5. The reference's routing margin at
    the inputs each MoE layer saw is far above that, so no routing flip
    can pass for a fault (or hide one)."""
    jcfg, jparams, cfg, params, _ = qwen
    recorded = []
    plain = moe.apply_moe

    def record(p, x, cfg_, **kw):
        recorded.append((x.float().numpy().reshape(-1, x.shape[-1]),
                         p["router"].numpy()))
        return plain(p, x, cfg_, **kw)

    monkeypatch.setattr(moe, "apply_moe", record)
    toks = np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, 12)).astype(np.int32)
    jopts = JM.ModelOptions(use_kernels=use_kernels, remat=False)
    opts = M.ModelOptions(use_kernels=use_kernels)
    jl, jcache = JM.prefill(jparams, {"tokens": jnp.asarray(toks)}, jcfg,
                            jopts, CACHE_LEN)
    with torch.no_grad():
        tl, cache = M.prefill(params,
                              {"tokens": torch.from_numpy(toks).long()},
                              cfg, opts, CACHE_LEN)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   **TOL["float32"])
        tok = np.asarray(jl).argmax(-1).astype(np.int32)
        for i in range(4):
            jl, jcache = JM.decode_step(jparams, jnp.asarray(tok), 12 + i,
                                        jcache, jcfg, jopts)
            tl, cache = M.decode_step(params, torch.from_numpy(tok).long(),
                                      12 + i, cache, cfg, opts)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                       **TOL["float32"])
            tok = np.asarray(jl).argmax(-1).astype(np.int32)
    assert len(recorded) == cfg.num_layers * 5
    # the two packages' router probabilities differ by ~1e-7 here
    assert _routing_margin(recorded, cfg.experts_per_token) > 10 * 2e-5


@pytest.mark.parametrize("use_kernels", [False, True])
def test_forward_hidden_aux_matches_reference(qwen, use_kernels):
    jcfg, jparams, cfg, params, _ = qwen
    toks = np.random.default_rng(7).integers(
        0, cfg.vocab_size, (3, 10)).astype(np.int32)
    want, jaux = JM.forward_hidden(
        jparams, {"tokens": jnp.asarray(toks)}, jcfg,
        JM.ModelOptions(use_kernels=use_kernels, remat=False))
    with torch.no_grad():
        got, aux = M.forward_hidden(
            params, {"tokens": torch.from_numpy(toks).long()}, cfg,
            M.ModelOptions(use_kernels=use_kernels))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **TOL["float32"])
    assert aux.dtype == torch.float32 and aux.shape == ()
    np.testing.assert_allclose(aux.item(), float(jaux), rtol=1e-6)
    assert aux.item() >= cfg.num_layers * (1.0 - 1e-3)


def test_forward_hidden_aux_is_zero_without_moe():
    cfg = get_config("olmo-1b", reduced=True)
    params = checkpoint.init_params(cfg, torch.Generator().manual_seed(0),
                                    device="cpu")
    with torch.no_grad():
        hidden, aux = M.forward_hidden(
            params, {"tokens": torch.zeros((1, 8), dtype=torch.long)}, cfg,
            M.ModelOptions())
    assert hidden.shape == (1, 8, cfg.d_model)
    assert aux.dtype == torch.float32 and aux.item() == 0.0


def _requests(cfg, n, equal_len, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, cfg.vocab_size,
                          16 if equal_len else 14 + i % 3).astype(np.int32),
             3 + i % 4) for i in range(n)]


@pytest.mark.parametrize("engine", ["continuous", "static"])
def test_engines_give_the_reference_engines_tokens(qwen, engine):
    """Both packages' engines take the same requests in the same order
    (deadlines inf, so EDF keeps it): the same batches, so the same
    batch-global routing and the same greedy tokens."""
    jcfg, jparams, cfg, params, _ = qwen
    if engine == "continuous":
        jeng = JaxEngine(jcfg, jparams, max_slots=3, cache_len=CACHE_LEN)
        teng = ContinuousBatchingEngine(cfg, params, max_slots=3,
                                        cache_len=CACHE_LEN)
    else:
        jeng = JaxStaticEngine(jcfg, jparams, max_batch=3,
                               cache_len=CACHE_LEN)
        teng = ServingEngine(cfg, params, max_batch=3, cache_len=CACHE_LEN)
    reqs = _requests(cfg, 7, equal_len=engine == "static")
    for i, (t, m) in enumerate(reqs):
        jeng.submit(JaxRequest(f"r{i}", t.copy(), max_new_tokens=m))
        teng.submit(Request(f"r{i}", t.copy(), max_new_tokens=m))
    jdone = {r.request_id: r.output for r in jeng.drain()}
    tdone = {r.request_id: r.output for r in teng.drain()}
    assert set(jdone) == set(tdone) == {f"r{i}" for i in range(7)}
    for k in jdone:
        np.testing.assert_array_equal(tdone[k], jdone[k])
    for key in teng.stats:
        if key != "wall_s":
            assert teng.stats[key] == jeng.stats[key], key


def test_serve_qwen3_moe_cpu_and_plan_from_measured_rates():
    out = serve(QWEN, device="cpu", reduced=True, seconds=1)
    want = ref_serve(QWEN, reduced=True, seconds=1)
    assert out["arch"] == want["arch"] == QWEN
    assert set(out) == set(want)
    # the port's engine adds the share of its decode steps replayed from
    # a CUDA graph and the share of its dense FLOPs on the split-TF32
    # kernel: none of either on the CPU
    assert set(out["serving_report"]) == set(want["serving_report"]) | {
        "decode_graph_share", "dense_kernel_share"}
    assert out["serving_report"]["decode_graph_share"] == 0.0
    assert out["serving_report"]["dense_kernel_share"] == 0.0
    assert out["frames_served"] == want["frames_served"] == 8
    streams = G.streams_from_measured(QWEN,
                                      out["measured_stream_tokens_per_s"])
    plans = {s: G.plan_gpu_fleet(streams, strategy=s)     # each validates
             for s in ("per-stream", "uniform-big", "packed")}
    assert plans["packed"]["hourly_cost"] <= plans["per-stream"]["hourly_cost"]
    assert sum(plans["per-stream"]["instances"].values()) == 4


@pytest.mark.parametrize("arch,refused", [
    (QWEN, True), ("moonshot-v1-16b-a3b", True), ("grok-1-314b", True),
    ("yi-9b", False), ("nemotron-4-15b", False)])
def test_serve_refuses_fp32_weights_larger_than_the_device(arch, refused,
                                                          monkeypatch):
    """On an 80 GB card the MoE models' fp32 weights (122.1, 112.2 and
    1,266 GB) do not fit: ``serve`` refuses them before drawing weights
    and names ``measure_and_plan``. yi-9b (35.3 GB) and nemotron-4-15b
    (62.5 GB) go on to draw theirs."""
    from repro_torch.launch import serve as serve_mod

    class Drawn(Exception):
        pass

    def no_weights(*a, **kw):
        raise Drawn

    monkeypatch.setattr(serve_mod, "_device_bytes", lambda device: 80 * 2**30)
    monkeypatch.setattr(serve_mod, "init_params", no_weights)
    if refused:
        with pytest.raises(ValueError, match="measure_and_plan"):
            serve(arch, device="cpu", reduced=False, seconds=1)
    else:
        with pytest.raises(Drawn):
            serve(arch, device="cpu", reduced=False, seconds=1)


def test_measure_and_plan_serves_a_bf16_engine(qwen):
    """The second half of ``serve`` on an engine built with bf16 weights:
    the cache takes the weights' dtype, and the report has ``serve``'s
    keys."""
    _, _, cfg, _, path = qwen
    params = checkpoint.load_flat(path, cfg, device="cpu",
                                  dtype=torch.bfloat16)
    eng = ContinuousBatchingEngine(cfg, params, max_slots=8, cache_len=128)
    assert eng.cache[0]["k"].dtype == torch.bfloat16
    out = measure_and_plan(eng, seconds=1)
    assert out["arch"] == QWEN and out["engine"] == "continuous"
    assert out["frames_served"] == 8
    assert set(out) == set(serve(QWEN, device="cpu", reduced=True,
                                 seconds=1))
    assert out["serving_report"]["requests"] == 8


# ---------------- the weight bridge ----------------

@pytest.mark.parametrize("arch", ARCHS)
def test_weight_bridge_loads_every_moe_leaf(arch, tmp_path):
    jcfg = jget_config(arch, reduced=True)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(1), jnp.float32)
    save_checkpoint(str(tmp_path / "w.npz"), jparams)
    flat = np.load(tmp_path / "w.npz")
    cfg = get_config(arch, reduced=True)
    params = checkpoint.load_flat(tmp_path / "w.npz", cfg, device="cpu")
    E, D, Fe = cfg.num_experts, cfg.d_model, cfg.moe_d_ff
    shapes = {"router": (D, E), "w1": (E, D, Fe), "w2": (E, Fe, D),
              "w3": (E, D, Fe)}
    seen = set()
    for layer, block in enumerate(params["layers"]):
        assert set(block["ffn"]) == set(shapes)
        for name, t in block["ffn"].items():
            assert tuple(t.shape) == shapes[name]
            np.testing.assert_array_equal(
                t.numpy(), flat[f"scan/[0]/ffn/{name}"][layer])
            seen.add(f"scan/[0]/ffn/{name}")
    assert seen == {k for k in flat.files if "/ffn/" in k}


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_moe_stds_are_the_reference_ones(arch):
    """router, w1, w3: 1/√D; w2: 1/√moe_d_ff/√(2L) (d_ff is 0 on every
    MoE config). Each against the formula and the reference's own draw."""
    jcfg, cfg = _cfgs(arch)
    D, F, L = cfg.d_model, cfg.moe_d_ff, cfg.num_layers
    want = {"router": D ** -0.5, "w1": D ** -0.5, "w3": D ** -0.5,
            "w2": F ** -0.5 / np.sqrt(2 * L)}
    assert cfg.d_ff == 0
    params = checkpoint.init_params(cfg, torch.Generator().manual_seed(0),
                                    device="cpu")
    jp = JMoE.init_moe(jcfg, jax.random.PRNGKey(0), jnp.float32)
    for name, std in want.items():
        assert checkpoint._init_std(cfg, f"layers/0/ffn/{name}") == \
            pytest.approx(std)
        got = params["layers"][0]["ffn"][name].std().item()
        assert got == pytest.approx(std, rel=0.05), name
        assert float(jnp.std(jp[name])) == pytest.approx(std, rel=0.05)

"""The port's RecurrentGemma path against the JAX package on reduced
recurrentgemma-9b (RG-LRU blocks and local attention with a ring cache), with
the same weights: JAX initialises them, ``save_checkpoint`` writes the flat
npz, and ``repro_torch.checkpoint.load_flat`` reads it. Block parts (causal
conv, gates, ``rglru_forward``, ``rglru_step``, the prefill cache, windowed
attention, the ring cache and ring decode) and the whole model's prefill and
per-row decode logits are compared in fp32 at 2e-5, the model with the
reference's jnp path (``use_kernels=False``) and with its Pallas flash and
RG-LRU kernels in interpret mode (``use_kernels=True``; the port then runs the
kernels' plain versions on the CPU). The reference's own RG-LRU and
sliding-window tests are mirrored on the port."""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint.store import save_checkpoint  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import rglru as JR  # noqa: E402
from repro.models.config import get_config as jget_config  # noqa: E402
from repro.models.steps import (make_jitted_decode,  # noqa: E402
                                make_jitted_prefill_into_slot)
from repro_torch import checkpoint  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import rglru  # noqa: E402
from repro_torch.models import steps  # noqa: E402
from repro_torch.models.config import get_config  # noqa: E402

ARCH = "recurrentgemma-9b"
CACHE_LEN = 128                      # > window 64: the attention cache is a ring
TOL = dict(atol=2e-5, rtol=2e-5)


def _save(tmp_path_factory, jcfg, name):
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    path = tmp_path_factory.mktemp("ckpt") / name
    save_checkpoint(str(path), jparams)
    return jparams, path


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    jcfg = jget_config(ARCH, reduced=True)
    jparams, path = _save(tmp_path_factory, jcfg, "rg-reduced.npz")
    cfg = get_config(ARCH, reduced=True)
    return jcfg, jparams, cfg, checkpoint.load_flat(path, cfg, device="cpu"), path


@pytest.fixture(scope="module")
def block():
    """One RG-LRU mixer's parameters from the reference's ``init_rglru``, as
    JAX arrays and as the port's tensors."""
    cfg = get_config(ARCH, reduced=True)
    jp = JR.init_rglru(jget_config(ARCH, reduced=True), jax.random.PRNGKey(1),
                       jnp.float32)
    # a random conv_b so its use is checked too
    rng = np.random.default_rng(9)
    jp = dict(jp, conv_b=jnp.asarray(
        0.1 * rng.standard_normal(jp["conv_b"].shape), jnp.float32))
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    return cfg, jp, tp


@pytest.fixture(scope="module")
def attn():
    """One attention mixer's parameters from the reference's
    ``init_attention``."""
    cfg = get_config(ARCH, reduced=True)
    jp = JL.init_attention(jget_config(ARCH, reduced=True),
                           jax.random.PRNGKey(2), jnp.float32)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    return cfg, jp, tp


def _x(cfg, shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(
        (*shape, cfg.d_model))).astype(np.float32)


# ---------------- RG-LRU block parts against the reference ----------------

def test_causal_conv_matches_reference(block):
    cfg, jp, tp = block
    x = np.random.default_rng(2).standard_normal(
        (2, 11, cfg.rnn_width)).astype(np.float32)
    want = JR._causal_conv(jnp.asarray(x), jp["conv_w"], jp["conv_b"])
    got = rglru._causal_conv(torch.from_numpy(x), tp["conv_w"], tp["conv_b"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_gates_match_reference(block):
    cfg, jp, tp = block
    xc = np.random.default_rng(3).standard_normal(
        (2, 9, cfg.rnn_width)).astype(np.float32)
    ja, jg = JR._gates(jp, jnp.asarray(xc))
    a, g = rglru._gates(tp, torch.from_numpy(xc))
    assert a.dtype == g.dtype == torch.float32
    np.testing.assert_allclose(a.numpy(), np.asarray(ja), **TOL)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), **TOL)


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("S", [7, 40])
def test_rglru_forward_matches_reference(block, S, use_kernel):
    cfg, jp, tp = block
    x = _x(cfg, (2, S), seed=S)
    want = JR.rglru_forward(jp, jnp.asarray(x), cfg, use_kernel=use_kernel)
    got = rglru.rglru_forward(tp, torch.from_numpy(x), cfg,
                              use_kernel=use_kernel)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_prefill_cache_matches_reference(block):
    """The port takes the cache from the block's own scan; the reference
    recomputes the projection, conv and gates and reruns its scan."""
    cfg, jp, tp = block
    x = _x(cfg, (2, 21), seed=5)
    want = JM._rglru_cache_from_prefill(jp, jnp.asarray(x), cfg)
    out, got = rglru.rglru_forward(tp, torch.from_numpy(x), cfg,
                                   want_cache=True)
    torch.testing.assert_close(out, rglru.rglru_forward(
        tp, torch.from_numpy(x), cfg), atol=0, rtol=0)
    assert got["h"].dtype == torch.float32
    for name in ("h", "conv"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   **TOL)


def test_rglru_step_matches_reference(block):
    cfg, jp, tp = block
    rng = np.random.default_rng(6)
    jcache = JR.rglru_init_cache(cfg, 3, jnp.float32)
    cache = rglru.rglru_init_cache(cfg, 3, torch.float32, "cpu")
    assert cache["h"].dtype == torch.float32
    for name in ("h", "conv"):
        assert tuple(cache[name].shape) == tuple(jcache[name].shape)
    for _ in range(3):
        x = rng.standard_normal((3, 1, cfg.d_model)).astype(np.float32)
        jy, jcache = JR.rglru_step(jp, jnp.asarray(x), jcache, cfg)
        y, cache = rglru.rglru_step(tp, torch.from_numpy(x), cache, cfg)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    for name in ("h", "conv"):
        np.testing.assert_allclose(cache[name].numpy(),
                                   np.asarray(jcache[name]), **TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rglru_step_kernel_path_matches_reference(block, dtype):
    """``rglru_step(use_kernel=True)`` (on the CPU: the fused kernel's plain
    version) against the reference's ``rglru_step``; the state is updated in
    place, in the cache's own fp32 buffer."""
    cfg, jp, tp = block
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jp = {k: v if k == "lam" else v.astype(jdt) for k, v in jp.items()}
    tp = {k: v if k == "lam" else v.to(tdt) for k, v in tp.items()}
    rng = np.random.default_rng(12)
    jcache = JR.rglru_init_cache(cfg, 3, jdt)
    cache = rglru.rglru_init_cache(cfg, 3, tdt, "cpu")
    state = cache["h"]
    tol = TOL if dtype == "float32" else dict(atol=2e-2, rtol=2e-2)
    for _ in range(3):
        x = rng.standard_normal((3, 1, cfg.d_model)).astype(np.float32)
        jy, jcache = JR.rglru_step(jp, jnp.asarray(x).astype(jdt), jcache, cfg)
        y, cache = rglru.rglru_step(tp, torch.from_numpy(x).to(tdt), cache,
                                    cfg, use_kernel=True)
        assert y.dtype == tdt and cache["h"] is state
        assert state.dtype == torch.float32
        np.testing.assert_allclose(y.float().numpy(),
                                   np.asarray(jy.astype(jnp.float32)), **tol)
    for name in ("h", "conv"):
        np.testing.assert_allclose(
            cache[name].float().numpy(),
            np.asarray(jcache[name].astype(jnp.float32)), **tol)


@pytest.mark.parametrize("S", [7, 40])
def test_rglru_forward_kernel_path_matches_plain(block, S):
    """The fused call and the plain ops give the same block output and
    decode cache (fp32, 2e-5)."""
    cfg, _, tp = block
    x = torch.from_numpy(_x(cfg, (2, S), seed=20 + S))
    out_k, cache_k = rglru.rglru_forward(tp, x, cfg, use_kernel=True,
                                         want_cache=True)
    out_p, cache_p = rglru.rglru_forward(tp, x, cfg, use_kernel=False,
                                         want_cache=True)
    torch.testing.assert_close(out_k, out_p, **TOL)
    assert cache_k["h"].is_contiguous() and cache_k["h"].dtype == torch.float32
    for name in ("h", "conv"):
        torch.testing.assert_close(cache_k[name], cache_p[name], **TOL)


def test_rglru_decode_matches_forward(block):
    """Mirrors test_model_parts.py::test_rglru_decode_matches_forward:
    step-by-step rglru_step == full-sequence rglru_forward, at 2e-4."""
    cfg, _, tp = block
    S = 12
    x = torch.from_numpy(_x(cfg, (2, S), seed=8))
    full = rglru.rglru_forward(tp, x, cfg)
    cache = rglru.rglru_init_cache(cfg, 2, torch.float32, "cpu")
    got = []
    for t in range(S):
        y, cache = rglru.rglru_step(tp, x[:, t:t + 1], cache, cfg)
        got.append(y[:, 0])
    torch.testing.assert_close(torch.stack(got, 1), full, atol=2e-4,
                               rtol=2e-4)


def test_rglru_gate_stability(block):
    """Mirrors test_model_parts.py::test_rglru_gate_stability: 0 <= a <= 1
    and the mean below 1, for inputs of scale 10."""
    cfg, _, tp = block
    x = torch.from_numpy(_x(cfg, (1, 32), seed=11, scale=10.0))
    xc = rglru._causal_conv(x @ tp["wx"], tp["conv_w"], tp["conv_b"])
    a, _ = rglru._gates(tp, xc)
    assert a.max().item() <= 1.0
    assert a.mean().item() < 1.0
    assert a.min().item() >= 0.0


# ---------------- local attention and the ring cache ----------------

@pytest.mark.parametrize("use_flash", [False, True])
def test_attention_full_window_matches_reference(attn, use_flash):
    """S = 96 > window 64, so the window masks: the port's einsum path and
    its flash path's plain version against the reference's jnp path and its
    Pallas flash kernel in interpret mode."""
    cfg, jp, tp = attn
    x = _x(cfg, (2, 96), seed=12)
    got, (k, v) = layers.attention_full(tp, torch.from_numpy(x), cfg,
                                        window=cfg.window,
                                        use_flash=use_flash)
    for ref_flash in (False, True):
        want, (jk, jv) = JL.attention_full(jp, jnp.asarray(x), cfg,
                                           window=cfg.window,
                                           use_flash=ref_flash)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(k.numpy(), np.asarray(jk), **TOL)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), **TOL)
    nowin, _ = layers.attention_full(tp, torch.from_numpy(x), cfg,
                                     use_flash=use_flash)
    assert (nowin - got)[:, cfg.window:].abs().max().item() > 1e-3


def test_sliding_window_masks_past(attn):
    """Mirrors test_model_parts.py::test_sliding_window_masks_past: moving
    the distant past does not change the last position's output."""
    cfg, _, tp = attn
    S = 96
    x1 = _x(cfg, (1, S), seed=13)
    x2 = x1.copy()
    x2[0, :16] += 10.0
    o1, _ = layers.attention_full(tp, torch.from_numpy(x1), cfg,
                                  window=cfg.window)
    o2, _ = layers.attention_full(tp, torch.from_numpy(x2), cfg,
                                  window=cfg.window)
    np.testing.assert_allclose(o1.numpy()[0, -1], o2.numpy()[0, -1],
                               atol=1e-4)


@pytest.mark.parametrize("S", [5, 64, 70, 150])
def test_ring_from_prefill_matches_reference(S):
    L = 64
    k = np.random.default_rng(S).standard_normal((2, S, 1, 8)).astype(
        np.float32)
    want = np.asarray(JM._ring_from_prefill(jnp.asarray(k), L, S))
    got = M._ring_from_prefill(torch.from_numpy(k), L, S)
    assert tuple(got.shape) == want.shape == (2, L, 1, 8)
    np.testing.assert_array_equal(got.numpy(), want)
    if S > L:                        # position p sits in slot p % L
        for p in range(S - L, S):
            np.testing.assert_array_equal(got.numpy()[:, p % L], k[:, p])


def test_attention_decode_ring_per_row_pos(attn):
    """Per-row positions on both sides of the ring's length, three steps."""
    cfg, jp, tp = attn
    rng = np.random.default_rng(14)
    L = cfg.window
    ck = rng.standard_normal((3, L, 1, cfg.head_dim)).astype(np.float32)
    cv = rng.standard_normal((3, L, 1, cfg.head_dim)).astype(np.float32)
    jk, jv = jnp.asarray(ck), jnp.asarray(cv)
    tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    pos = np.array([3, 63, 130], np.int32)
    for _ in range(3):
        x = rng.standard_normal((3, 1, cfg.d_model)).astype(np.float32)
        want, jk, jv = JL.attention_decode_ring(jp, jnp.asarray(x), jk, jv,
                                                jnp.asarray(pos), cfg)
        got, tk, tv = layers.attention_decode_ring(
            tp, torch.from_numpy(x), tk, tv, torch.from_numpy(pos).long(), cfg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        pos = pos + 1
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)


# ---------------- the weight bridge ----------------

def test_load_flat_splits_scan_stacked_leaves(tmp_path_factory):
    """8 layers of a 3-block pattern: scan/[j] holds 2 repeats of pattern
    slot j (layers j and 3 + j), rem/[0] and rem/[1] are layers 6 and 7."""
    jcfg = dataclasses.replace(jget_config(ARCH, reduced=True), num_layers=8)
    _, path = _save(tmp_path_factory, jcfg, "rg-8.npz")
    cfg = dataclasses.replace(get_config(ARCH, reduced=True), num_layers=8)
    params = checkpoint.load_flat(path, cfg, device="cpu")
    flat = np.load(path)
    assert flat["scan/[0]/mixer/lam"].shape == (2, cfg.rnn_width)
    assert len(params["layers"]) == 8
    where = {0: ("scan/[0]", 0), 1: ("scan/[1]", 0), 2: ("scan/[2]", 0),
             3: ("scan/[0]", 1), 4: ("scan/[1]", 1), 5: ("scan/[2]", 1),
             6: ("rem/[0]", None), 7: ("rem/[1]", None)}
    for layer, (prefix, rep) in where.items():
        kind = cfg.layer_kinds[layer]
        got = params["layers"][layer]
        assert set(got) == {"norm1", "mixer", "norm2", "ffn"}
        names = (("wx", "wgate", "conv_w", "conv_b", "wr", "wi", "lam", "wo")
                 if kind[0] == "rglru" else ("wq", "wk", "wv", "wo"))
        assert set(got["mixer"]) == set(names)
        for scope, name in [("mixer", n) for n in names] + [
                ("ffn", "w1"), ("ffn", "w2"), ("ffn", "w3"),
                ("norm2", "scale")]:
            want = flat[f"{prefix}/{scope}/{name}"]
            np.testing.assert_array_equal(
                got[scope][name].numpy(), want if rep is None else want[rep])


def test_load_flat_bf16_keeps_lam_fp32(weights):
    _, _, cfg, _, path = weights
    params = checkpoint.load_flat(path, cfg, device="cpu",
                                  dtype=torch.bfloat16)
    mixer = params["layers"][0]["mixer"]
    assert mixer["lam"].dtype == torch.float32
    for name in ("wx", "wgate", "conv_w", "conv_b", "wr", "wi", "wo"):
        assert mixer[name].dtype == torch.bfloat16, name
    np.testing.assert_array_equal(mixer["lam"].numpy(),
                                  np.load(path)["scan/[0]/mixer/lam"][0])


def test_init_params_shapes_and_distributions():
    """At rnn_width 512 against H·hd = 256 and rnn_conv 3 against ssm_conv 4,
    each mixer's ``wo`` and ``conv_w`` must take its own std."""
    cfg = dataclasses.replace(get_config(ARCH, reduced=True), rnn_width=512,
                              rnn_conv=3)
    params = checkpoint.init_params(cfg, torch.Generator().manual_seed(0),
                                    dtype=torch.bfloat16, device="cpu")
    jcfg = dataclasses.replace(jget_config(ARCH, reduced=True), rnn_width=512,
                               rnn_conv=3)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    for j in range(3):
        for scope in ("mixer", "ffn"):
            for name, leaf in jparams["scan"][j][scope].items():
                assert tuple(params["layers"][j][scope][name].shape) == \
                    leaf.shape[1:], (j, name)
    rg, at = params["layers"][0]["mixer"], params["layers"][2]["mixer"]
    D, W, L = cfg.d_model, cfg.rnn_width, cfg.num_layers
    out = (2 * L) ** -0.5
    for mixer, name, std in (
            (rg, "wx", D ** -0.5), (rg, "wgate", D ** -0.5),
            (rg, "wr", W ** -0.5), (rg, "wi", W ** -0.5),
            (rg, "wo", W ** -0.5 * out), (rg, "conv_w", 3 ** -0.5),
            (at, "wo", (cfg.num_heads * cfg.head_dim) ** -0.5 * out)):
        assert abs(mixer[name].float().std().item() / std - 1) < 0.07, name
    assert rg["lam"].dtype == torch.float32
    a = torch.exp(-rglru.RG_C * torch.nn.functional.softplus(rg["lam"]))
    assert a.min().item() >= 0.9 - 1e-6 and a.max().item() <= 0.999 + 1e-6
    assert a.max().item() - a.min().item() > 0.09     # spread over the range
    assert bool((rg["conv_b"] == 0).all())


def test_param_count_is_the_references():
    """Kept exactly as the reference counts it (no RG-LRU conv_b), so fleet
    plans size HBM as the reference does."""
    cfg = get_config(ARCH)
    assert cfg.param_count() == jget_config(ARCH).param_count() \
        == 10_444_664_832
    n = sum(math.prod(s) for s in _shape_leaves(checkpoint.param_shapes(cfg)))
    assert n == 10_444_771_328 == cfg.param_count() + 26 * cfg.rnn_width
    assert sum(1 for m, _ in cfg.layer_kinds if m == "rglru") == 26
    assert sum(1 for m, _ in cfg.layer_kinds if m == "attn_window") == 12


def _shape_leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _shape_leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _shape_leaves(v)
    else:
        yield tree


# ---------------- the whole model ----------------

@pytest.mark.parametrize("use_kernels", [False, True])
def test_prefill_and_per_row_decode_match_reference(weights, use_kernels):
    """Prompts of 12 and 96 tokens are prefilled into slots 0 and 1 of a
    cache of 128 positions (a ring of 64 for the window), then decode 4 steps
    together at per-row positions; the 96-token prompt wraps the ring."""
    jcfg, jparams, cfg, params, _ = weights
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (12, 96)]

    jopts = JM.ModelOptions(use_kernels=use_kernels, remat=False)
    jslot = make_jitted_prefill_into_slot(jcfg, jopts, CACHE_LEN)
    jdecode = make_jitted_decode(jcfg, jopts)
    jcache = JM.init_cache(jcfg, 2, CACHE_LEN, jnp.float32, jopts)

    opts = M.ModelOptions(use_kernels=use_kernels)
    cache = M.init_cache(cfg, 2, CACHE_LEN, torch.float32, opts, device="cpu")
    assert tuple(cache[2]["k"].shape) == (2, cfg.window, 1, cfg.head_dim)

    first = []
    for slot, toks in enumerate(prompts):
        jl, jcache = jslot(jparams, jcache, {"tokens": jnp.asarray(toks[None])},
                           slot)
        tl, cache = steps.prefill_into_slot_step(
            params, cache, {"tokens": torch.from_numpy(toks[None]).long()},
            slot, cfg, opts, CACHE_LEN)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        first.append(int(np.argmax(np.asarray(jl))))

    tok = np.asarray(first, np.int32)
    pos = np.array([len(p) for p in prompts], np.int32)
    for _ in range(4):
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
    # the caches agree too (the reference's carry a leading repeat axis)
    for layer, c in enumerate(cache):
        for name, t in c.items():
            np.testing.assert_allclose(
                t.numpy(), np.asarray(jcache["scan"][layer][name][0]), **TOL)
    assert cache[0]["h"].dtype == torch.float32


def test_prefill_and_decode_kernels_match_plain(weights, monkeypatch):
    """A reduced recurrentgemma prefill into two slots and five decode steps
    with ``use_kernels=True`` (the fused RG-LRU in prefill and decode; the
    plain versions on the CPU) against ``use_kernels=False``: logits, greedy
    tokens and every cache row, fp32 at 2e-5. Every tensor the model hands
    the fused call is contiguous, as the CUDA kernel requires."""
    from repro_torch.kernels import ops
    _, _, cfg, params, _ = weights
    calls = []
    fused = ops.rglru_gated_scan

    def checked(*args, **kw):
        calls.append(all(t.is_contiguous() for t in (*args, *kw.values())
                         if t is not None))
        return fused(*args, **kw)

    monkeypatch.setattr(ops, "rglru_gated_scan", checked)
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (20, 70)]
    runs = {}
    for use_kernels in (True, False):
        opts = M.ModelOptions(use_kernels=use_kernels)
        cache = M.init_cache(cfg, 2, CACHE_LEN, torch.float32, opts,
                             device="cpu")
        logits = []
        for slot, toks in enumerate(prompts):
            lg, cache = steps.prefill_into_slot_step(
                params, cache, {"tokens": torch.from_numpy(toks[None])},
                slot, cfg, opts, CACHE_LEN)
            logits.append(lg)
        tok = torch.stack(logits).argmax(-1)
        pos = torch.tensor([len(p) for p in prompts])
        for _ in range(5):
            lg, cache = steps.decode_step(params, cache,
                                          {"token": tok, "pos": pos}, cfg,
                                          opts)
            logits.append(lg)
            tok, pos = lg.argmax(-1), pos + 1
        runs[use_kernels] = (logits, cache)
    (lk, ck), (lp, cp) = runs[True], runs[False]
    n_rglru = sum(1 for m, _ in cfg.layer_kinds if m == "rglru")
    assert len(calls) == n_rglru * (2 + 5) and all(calls)
    for got, want in zip(lk, lp):
        torch.testing.assert_close(got, want, **TOL)
        assert torch.equal(got.argmax(-1), want.argmax(-1))
    for got, want in zip(ck, cp):
        for name in got:
            torch.testing.assert_close(got[name], want[name], **TOL)


def test_prefill_into_slot_matches_batched_prefill(weights):
    """Admitting requests one by one into a pooled cache produces the same
    logits and caches as prefilling them together as one batch."""
    _, _, cfg, params, _ = weights
    opts = M.ModelOptions()
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 80)))
    logits_b, cache_b = steps.prefill_step(params, {"tokens": toks}, cfg,
                                           opts, CACHE_LEN)
    cache = M.init_cache(cfg, 2, CACHE_LEN, torch.float32, opts, device="cpu")
    for row in range(2):
        logits, cache = steps.prefill_into_slot_step(
            params, cache, {"tokens": toks[row:row + 1]}, row, cfg, opts,
            CACHE_LEN)
        torch.testing.assert_close(logits_b[row], logits, atol=1e-5,
                                   rtol=1e-5)
    for got, want in zip(cache, cache_b):
        for name in got:
            torch.testing.assert_close(got[name], want[name], atol=1e-5,
                                       rtol=1e-5)


def test_prompt_shorter_than_conv_history_is_refused(weights):
    """A 2-token prompt leaves 1 conv-history row where a slot holds
    rnn_conv - 1 = 3 (the reference slices S - 3 from the end); the port
    raises instead of broadcasting the one row."""
    _, _, cfg, params, _ = weights
    opts = M.ModelOptions()
    cache = M.init_cache(cfg, 2, CACHE_LEN, torch.float32, opts, device="cpu")
    toks = torch.tensor([[5, 9]])
    _, one = steps.prefill_step(params, {"tokens": toks}, cfg, opts,
                                CACHE_LEN)
    assert one[0]["conv"].shape[1] == 1 < cfg.rnn_conv - 1
    with pytest.raises(ValueError):
        steps.prefill_into_slot_step(params, cache, {"tokens": toks}, 0, cfg,
                                     opts, CACHE_LEN)

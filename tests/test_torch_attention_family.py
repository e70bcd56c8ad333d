"""The port's attention options against the JAX package on the same inputs:
``attention_full`` with GQA, ``expand_kv``, ``blockwise`` (with and without
a window), non-causal and flash (the port's plain version against the
Pallas kernel in interpret mode), ``attention_decode(window=)``, and the
sliding-window option of dense models (``window_override``) with a ring
cache against the full-length cache with the window mask. Inputs and
weights are drawn with numpy (or by JAX and carried over by
``save_checkpoint``/``load_flat``); fp32 at 2e-5."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint.store import save_checkpoint  # noqa: E402
from repro.data.pipeline import InputShape as JShape  # noqa: E402
from repro.data.pipeline import make_batch as jmake_batch  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models.config import get_config as jget_config  # noqa: E402
from repro_torch import checkpoint  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.config import get_config  # noqa: E402

TOL = dict(atol=2e-5, rtol=2e-5)


def _attn_params(cfg, seed):
    rng = np.random.default_rng(seed)
    D, H, K, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    shapes = {"wq": (D, H * hd), "wk": (D, K * hd), "wv": (D, K * hd),
              "wo": (H * hd, D)}
    return {n: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
            for n, s in shapes.items()}


def _both(p, x):
    return ({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
            {k: torch.from_numpy(v) for k, v in p.items()},
            torch.from_numpy(x))


@pytest.mark.parametrize("arch,S,kw", [
    ("yi-9b", 48, {}),                                   # GQA 4 over 2
    ("yi-9b", 48, {"expand_kv": True}),
    ("yi-9b", 128, {"blockwise": 32}),
    ("yi-9b", 128, {"blockwise": 32, "window": 24}),
    ("yi-9b", 64, {"window": 16}),
    ("yi-9b", 64, {"use_flash": True}),                  # Pallas, interpret
    ("yi-9b", 64, {"use_flash": True, "expand_kv": True}),
    ("nemotron-4-15b", 40, {}),
    ("internvl2-1b", 64, {"use_flash": True}),
    ("hubert-xlarge", 50, {}),                           # encoder
    ("hubert-xlarge", 64, {"blockwise": 16}),
    ("hubert-xlarge", 64, {"use_flash": True}),
])
def test_attention_full_matches_reference(arch, S, kw):
    cfg = get_config(arch, reduced=True)
    p = _attn_params(cfg, 1)
    x = np.random.default_rng(2).standard_normal(
        (2, S, cfg.d_model)).astype(np.float32)
    jp, jx, tp, tx = _both(p, x)
    want, (jk, jv) = JL.attention_full(jp, jx, jget_config(arch, reduced=True),
                                       **kw)
    got, (k, v) = TL.attention_full(tp, tx, cfg, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(k.numpy(), np.asarray(jk), **TOL)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), **TOL)
    if kw.get("expand_kv"):
        assert k.shape[2] == cfg.num_heads


@pytest.mark.parametrize("window", [0, 5, 64])
def test_attention_decode_window_matches_reference(window):
    """Per-row positions over a full-length cache, masked to the window."""
    cfg = get_config("yi-9b", reduced=True)
    p = _attn_params(cfg, 3)
    rng = np.random.default_rng(4)
    B, L = 3, 24
    x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    ck, cv = (rng.standard_normal((B, L, cfg.num_kv_heads, cfg.head_dim))
              .astype(np.float32) for _ in range(2))
    pos = np.array([3, 11, 20], np.int32)
    jp, jx, tp, tx = _both(p, x)
    want, jk, jv = JL.attention_decode(jp, jx, jnp.asarray(ck), jnp.asarray(cv),
                                       jnp.asarray(pos), cfg, window=window)
    got, k, v = TL.attention_decode(tp, tx, torch.from_numpy(ck.copy()),
                                    torch.from_numpy(cv.copy()),
                                    torch.from_numpy(pos).long(), cfg,
                                    window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(k.numpy(), np.asarray(jk), **TOL)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), **TOL)


def test_decode_window_ignores_keys_before_it():
    """With window w, changing a key older than pos - w + 1 changes
    nothing; without the window it does."""
    cfg = get_config("yi-9b", reduced=True)
    tp = {k: torch.from_numpy(v) for k, v in _attn_params(cfg, 5).items()}
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal((1, 1, cfg.d_model))
                         .astype(np.float32))
    ck, cv = (torch.from_numpy(rng.standard_normal(
        (1, 32, cfg.num_kv_heads, cfg.head_dim)).astype(np.float32))
        for _ in range(2))
    outs = {}
    for window in (8, 0):
        for bump in (0.0, 10.0):
            k2, v2 = ck.clone(), cv.clone()
            k2[:, 2] += bump                       # position 2 < 20 - 8 + 1
            outs[window, bump] = TL.attention_decode(tp, x, k2, v2, 20, cfg,
                                                     window=window)[0]
    torch.testing.assert_close(outs[8, 0.0], outs[8, 10.0])
    assert not torch.allclose(outs[0, 0.0], outs[0, 10.0])


def test_gqa_matches_mha_when_repeated():
    """Mirrors test_model_parts.py::test_gqa_matches_mha_when_repeated: GQA
    with its KV projections repeated onto every head is MHA."""
    cfg = get_config("yi-9b", reduced=True)
    p = {k: torch.from_numpy(v) for k, v in _attn_params(cfg, 7).items()}
    G, hd = cfg.num_heads // cfg.num_kv_heads, cfg.head_dim
    rep = lambda w: w.reshape(cfg.d_model, cfg.num_kv_heads, hd) \
        .repeat_interleave(G, dim=1).reshape(cfg.d_model, -1)
    p_mha = dict(p, wk=rep(p["wk"]), wv=rep(p["wv"]))
    cfg_mha = dataclasses.replace(cfg, num_kv_heads=cfg.num_heads)
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (2, 16, cfg.d_model)).astype(np.float32))
    out_gqa, _ = TL.attention_full(p, x, cfg)
    out_mha, _ = TL.attention_full(p_mha, x, cfg_mha)
    out_exp, _ = TL.attention_full(p, x, cfg, expand_kv=True)
    torch.testing.assert_close(out_gqa, out_mha, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(out_exp, out_mha, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("arch,window", [("yi-9b", 0),
                                         ("recurrentgemma-9b", 64)])
def test_blockwise_attention_matches_plain(arch, window):
    """Mirrors test_model_parts.py::test_blockwise_attention_matches_reference
    (yi-9b, blocks of 32, 64 and 128) and test_blockwise_attention_window
    (recurrentgemma-9b's window, blocks of 32), in the port."""
    cfg = get_config(arch, reduced=True)
    p = {k: torch.from_numpy(v) for k, v in _attn_params(cfg, 9).items()}
    x = torch.from_numpy(np.random.default_rng(10).standard_normal(
        (2, 128, cfg.d_model)).astype(np.float32))
    o_ref, _ = TL.attention_full(p, x, cfg, window=window)
    for block in ((32, 64, 128) if window == 0 else (32,)):
        o_bw, _ = TL.attention_full(p, x, cfg, window=window, blockwise=block)
        torch.testing.assert_close(o_bw, o_ref, atol=2e-5, rtol=2e-5)


def test_blockwise_refuses_keys_that_are_not_whole_blocks():
    cfg = get_config("yi-9b", reduced=True)
    q = torch.zeros((1, 48, cfg.num_heads, cfg.head_dim))
    k = torch.zeros((1, 48, cfg.num_kv_heads, cfg.head_dim))
    with pytest.raises(ValueError, match="multiple"):
        TL.attention_blockwise(q, k, k, cfg, block=32)


def test_blockwise_attention_option_needs_the_kernels_off():
    """With the kernels on, the flash kernel runs full-sequence attention,
    so ``blockwise_attention`` would be ignored: the options refuse it."""
    with pytest.raises(ValueError, match="use_kernels=False"):
        M.ModelOptions(blockwise_attention=32)
    assert M.ModelOptions(use_kernels=False,
                          blockwise_attention=32).blockwise_attention == 32


@pytest.fixture(scope="module")
def yi(tmp_path_factory):
    jcfg = jget_config("yi-9b", reduced=True)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    path = tmp_path_factory.mktemp("ckpt") / "yi.npz"
    save_checkpoint(str(path), jparams)
    cfg = get_config("yi-9b", reduced=True)
    return jcfg, jparams, cfg, checkpoint.load_flat(path, cfg, device="cpu")


def _prefill_both(yi, tokens, opts_kw, cache_len):
    jcfg, jparams, cfg, params = yi
    jopts = JM.ModelOptions(remat=False, **opts_kw)
    opts = M.ModelOptions(use_kernels=False, **opts_kw)
    jl, jc = JM.prefill(jparams, {"tokens": jnp.asarray(tokens)}, jcfg, jopts,
                        cache_len=cache_len)
    with torch.no_grad():
        tl, tc = M.prefill(params, {"tokens": torch.tensor(
            np.asarray(tokens), dtype=torch.long)}, cfg, opts, cache_len)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for layer, c in enumerate(tc):
        np.testing.assert_allclose(c["k"].numpy(),
                                   np.asarray(jc["scan"][0]["k"][layer]),
                                   **TOL)
    return (jopts, jc), (opts, tc)


def test_sliding_window_ring_cache_matches_full(yi):
    """Mirrors test_archs_smoke.py::test_sliding_window_ring_cache_matches_
    full: with ``window_override``, one decode step from a ring cache equals
    one from the full-length cache with the window mask; each equals the
    reference's on the same weights."""
    jcfg, jparams, cfg, params = yi
    S, W = 40, 16
    batch = jmake_batch(jcfg, JShape("t", S, 2, "prefill"), seed=5)
    pre, last = batch["tokens"][:, :-1], batch["tokens"][:, -1]
    logits = {}
    for ring in (False, True):
        (jopts, jc), (opts, tc) = _prefill_both(
            yi, pre, {"window_override": W, "ring_cache": ring}, S + 8)
        assert tc[0]["k"].shape[1] == (W if ring else S + 8)
        jl, _ = JM.decode_step(jparams, last, jnp.asarray(S - 1), jc, jcfg,
                               jopts)
        with torch.no_grad():
            tl, _ = M.decode_step(params, torch.tensor(
                np.asarray(last), dtype=torch.long), S - 1, tc, cfg, opts)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        logits[ring] = tl
    torch.testing.assert_close(logits[True], logits[False], atol=5e-4,
                               rtol=5e-4)


def test_multi_step_decode_ring(yi):
    """Mirrors test_archs_smoke.py::test_multi_step_decode_ring (slow in the
    reference; fast here): six ring-cache decode steps stay with the
    full-cache window decode and with the reference, whose greedy tokens
    both follow."""
    jcfg, jparams, cfg, params = yi
    S, W, steps = 24, 8, 6
    batch = jmake_batch(jcfg, JShape("t", S, 2, "prefill"), seed=7)
    runs = {}
    for ring in (False, True):
        (jopts, jc), (opts, tc) = _prefill_both(
            yi, batch["tokens"], {"window_override": W, "ring_cache": ring},
            S + steps)
        tok = np.array(batch["tokens"][:, -1])
        out = []
        for i in range(steps):
            jl, jc = JM.decode_step(jparams, jnp.asarray(tok),
                                    jnp.asarray(S + i), jc, jcfg, jopts)
            with torch.no_grad():
                tl, tc = M.decode_step(params, torch.from_numpy(tok).long(),
                                       S + i, tc, cfg, opts)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
            out.append(tl)
            tok = np.asarray(jl).argmax(-1).astype(np.int32)
        runs[ring] = out
    for lr, lf in zip(runs[True], runs[False]):
        torch.testing.assert_close(lr, lf, atol=1e-3, rtol=1e-3)


def test_window_override_caches_follow_the_reference():
    """Which mixer gets a ring, and of how many rows (reference
    ``init_block_cache``)."""
    cfg = get_config("yi-9b", reduced=True)
    rg = get_config("recurrentgemma-9b", reduced=True)
    rows = lambda c, kind, opts: M.init_block_cache(
        c, kind, 1, 100, torch.float32, opts, "cpu")["k"].shape[1]
    attn, win = ("attn", "mlp"), ("attn_window", "mlp")
    assert rows(cfg, attn, M.ModelOptions()) == 100
    assert rows(cfg, attn, M.ModelOptions(window_override=16)) == 100
    assert rows(cfg, attn, M.ModelOptions(window_override=16,
                                          ring_cache=True)) == 16
    assert rows(cfg, attn, M.ModelOptions(window_override=400,
                                          ring_cache=True)) == 100
    assert rows(rg, win, M.ModelOptions()) == rg.window
    assert M.effective_window(cfg, "attn", M.ModelOptions()) == 0
    assert M.effective_window(rg, "attn_window",
                              M.ModelOptions(window_override=8)) == rg.window
    jopts = JM.ModelOptions()
    for f in ("window_override", "ring_cache", "remat", "blockwise_attention",
              "gqa_expand_kv"):
        assert getattr(M.ModelOptions(), f) == getattr(jopts, f), f


@pytest.mark.parametrize("window", [0, 16])
def test_prefill_longer_than_a_full_cache_is_refused(yi, window):
    """A full-length cache of 32 rows cannot take a 40-token prefill (the
    reference's pad to cache_len fails as well); a ring of 16 can."""
    _, _, cfg, params = yi
    toks = torch.zeros((1, 40), dtype=torch.long)
    with torch.no_grad(), pytest.raises(ValueError, match="cache of 32"):
        M.prefill(params, {"tokens": toks}, cfg, M.ModelOptions(
            use_kernels=False, window_override=window), 32)
    if window:
        with torch.no_grad():
            _, cache = M.prefill(params, {"tokens": toks}, cfg, M.ModelOptions(
                use_kernels=False, window_override=window, ring_cache=True),
                32)
        assert cache[0]["k"].shape[1] == window

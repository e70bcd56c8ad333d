"""The port's model against the JAX model on reduced olmo-1b, with the same
weights: JAX initialises them, ``save_checkpoint`` writes the flat npz, and
``repro_torch.checkpoint.load_flat`` reads it. Prefill logits and per-row
decode steps are compared at fp32 2e-5 with the reference's jnp path
(``use_kernels=False``) and with its Pallas kernel in interpret mode
(``use_kernels=True``; the port then runs its plain flash attention)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint.store import save_checkpoint  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models.config import get_config as jget_config  # noqa: E402
from repro.models.steps import (make_jitted_decode,  # noqa: E402
                                make_jitted_prefill_into_slot)
from repro_torch import checkpoint  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import steps  # noqa: E402
from repro_torch.models.config import get_config  # noqa: E402

CACHE_LEN = 48
TOL = dict(atol=2e-5, rtol=2e-5)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    jcfg = jget_config("olmo-1b", reduced=True)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    path = tmp_path_factory.mktemp("ckpt") / "olmo-1b-reduced.npz"
    save_checkpoint(str(path), jparams)
    cfg = get_config("olmo-1b", reduced=True)
    return jcfg, jparams, cfg, checkpoint.load_flat(path, cfg, device="cpu"), path


def test_load_flat_splits_scan_stacked_leaves(weights):
    jcfg, jparams, cfg, params, path = weights
    flat = np.load(path)
    assert "scan/[0]/mixer/wq" in flat.files
    assert flat["scan/[0]/mixer/wq"].shape[0] == cfg.num_layers
    assert not any(k.startswith(("scan/[0]/norm", "final_norm"))
                   for k in flat.files)             # nonparam_ln: no leaves
    assert len(params["layers"]) == cfg.num_layers
    for layer in range(cfg.num_layers):
        for group, name in (("mixer", "wq"), ("mixer", "wo"),
                            ("ffn", "w1"), ("ffn", "w3")):
            np.testing.assert_array_equal(
                params["layers"][layer][group][name].numpy(),
                flat[f"scan/[0]/{group}/{name}"][layer])
    np.testing.assert_array_equal(params["embed"]["embedding"].numpy(),
                                  flat["embed/embedding"])
    with pytest.raises(ValueError):      # widths must match the config
        checkpoint.load_flat(path, dataclasses.replace(cfg, d_ff=256), "cpu")


def test_load_flat_takes_a_mapping_or_a_path_without_suffix(weights):
    _, _, cfg, params, path = weights
    from_map = checkpoint.load_flat(dict(np.load(path)), cfg, device="cpu")
    from_stem = checkpoint.load_flat(str(path)[:-len(".npz")], cfg,
                                     device="cpu", dtype=torch.bfloat16)
    torch.testing.assert_close(from_map["layers"][1]["ffn"]["w2"],
                               params["layers"][1]["ffn"]["w2"])
    assert from_stem["embed"]["embedding"].dtype == torch.bfloat16
    with pytest.raises(KeyError):
        checkpoint.load_flat({}, cfg, device="cpu")


def test_init_params_shapes_and_scales():
    cfg = get_config("olmo-1b", reduced=True)
    gen = torch.Generator().manual_seed(0)
    params = checkpoint.init_params(cfg, gen, device="cpu")
    shapes = checkpoint.param_shapes(cfg)
    assert params["embed"]["embedding"].shape == shapes["embed"]["embedding"]
    layer = params["layers"][0]
    D, L = cfg.d_model, cfg.num_layers
    for name, std in (("wq", D ** -0.5),
                      ("wo", (cfg.num_heads * cfg.head_dim) ** -0.5 / (2 * L) ** 0.5)):
        w = layer["mixer"][name]
        assert tuple(w.shape) == shapes["layers"][0]["mixer"][name]
        assert abs(w.std().item() / std - 1) < 0.05
    assert abs(layer["ffn"]["w2"].std().item()
               / (cfg.d_ff ** -0.5 / (2 * L) ** 0.5) - 1) < 0.05
    assert abs(params["embed"]["embedding"].std().item() / 0.02 - 1) < 0.05
    assert layer["norm1"] == {} and params["final_norm"] == {}


@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm", "nonparam_ln"])
def test_apply_norm_matches_reference(norm):
    cfg = dataclasses.replace(get_config("olmo-1b", reduced=True), norm=norm)
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((2, 5, cfg.d_model)) * 3 + 1).astype(np.float32)
    p = {}
    if norm != "nonparam_ln":
        p["scale"] = rng.standard_normal(cfg.d_model).astype(np.float32)
    if norm == "layernorm":
        p["bias"] = rng.standard_normal(cfg.d_model).astype(np.float32)
    want = JL.apply_norm({k: jnp.asarray(v) for k, v in p.items()},
                         jnp.asarray(x), cfg)
    got = TL.apply_norm({k: torch.from_numpy(v) for k, v in p.items()},
                        torch.from_numpy(x), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_rope_rotates_halves_like_reference():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 1, 4, 64)).astype(np.float32)
    pos = np.array([[0], [7], [31]], np.int32)           # per-row positions
    want = JL.rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0)
    got = TL.rope(torch.from_numpy(x), torch.from_numpy(pos), 10_000.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("activation,gated", [("silu", True), ("gelu", False),
                                              ("relu2", False)])
def test_apply_mlp_matches_reference(activation, gated):
    cfg = dataclasses.replace(get_config("olmo-1b", reduced=True),
                              activation=activation, gated=gated)
    rng = np.random.default_rng(5)
    D, F = cfg.d_model, cfg.d_ff
    p = {"w1": rng.standard_normal((D, F)) / D ** 0.5,
         "w2": rng.standard_normal((F, D)) / F ** 0.5,
         "w3": rng.standard_normal((D, F)) / D ** 0.5}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.standard_normal((2, 3, D)).astype(np.float32)
    want = JL.apply_mlp({k: jnp.asarray(v) for k, v in p.items()},
                        jnp.asarray(x), cfg)
    got = TL.apply_mlp({k: torch.from_numpy(v) for k, v in p.items()},
                       torch.from_numpy(x), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_prefill_and_per_row_decode_match_reference(weights, use_kernels):
    """Two prompts of different lengths are prefilled into slots 0 and 1,
    then decode 4 steps together at per-row positions."""
    jcfg, jparams, cfg, params, _ = weights
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (12, 16)]

    jopts = JM.ModelOptions(use_kernels=use_kernels, remat=False)
    jslot = make_jitted_prefill_into_slot(jcfg, jopts, CACHE_LEN)
    jdecode = make_jitted_decode(jcfg, jopts)
    jcache = JM.init_cache(jcfg, 2, CACHE_LEN, jnp.float32, jopts)

    opts = M.ModelOptions(use_kernels=use_kernels)
    cache = M.init_cache(cfg, 2, CACHE_LEN, torch.float32, opts, device="cpu")

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
        np.testing.assert_allclose(c["k"].numpy(),
                                   np.asarray(jcache["scan"][0]["k"][layer]),
                                   **TOL)


def test_prefill_into_slot_matches_batched_prefill(weights):
    """Admitting requests one by one into a pooled cache produces the same
    logits and cache as prefilling them together as one batch."""
    _, _, cfg, params, _ = weights
    opts = M.ModelOptions()
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 16)))
    logits_b, cache_b = steps.prefill_step(params, {"tokens": toks}, cfg,
                                           opts, CACHE_LEN)
    cache = M.init_cache(cfg, 2, CACHE_LEN, torch.float32, opts, device="cpu")
    logits0, cache = steps.prefill_into_slot_step(
        params, cache, {"tokens": toks[:1]}, 0, cfg, opts, CACHE_LEN)
    logits1, cache = steps.prefill_into_slot_step(
        params, cache, {"tokens": toks[1:]}, 1, cfg, opts, CACHE_LEN)
    torch.testing.assert_close(logits_b[0], logits0, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(logits_b[1], logits1, atol=1e-5, rtol=1e-5)
    for got, want in zip(cache, cache_b):
        for name in ("k", "v"):
            torch.testing.assert_close(got[name], want[name], atol=1e-5,
                                       rtol=1e-5)


def test_unsupported_block_kind_raises():
    # ("attn", "moe") runs since the MoE slice; a windowed MoE block does not
    cfg = dataclasses.replace(get_config("olmo-1b", reduced=True),
                              block_pattern=(("attn_window", "moe"),),
                              window=4, num_experts=4, experts_per_token=2)
    with pytest.raises(NotImplementedError):
        M.init_cache(cfg, 1, 8, torch.float32, M.ModelOptions(), device="cpu")

"""The port's frontends against the JAX package: reduced internvl2-1b (a
vision prefix of patch embeddings before the tokens, then decode) and
reduced hubert-xlarge (the bidirectional encoder over audio frame
embeddings with sinusoidal positions, ``forward_hidden``), with the same
weights (``save_checkpoint`` then ``load_flat``, every leaf checked for the
four architectures of this slice), and ``data.pipeline.make_batch`` equal
to the reference's array for array. fp32 at 2e-5."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint.store import save_checkpoint  # noqa: E402
from repro.data import pipeline as JP  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models.config import get_config as jget_config  # noqa: E402
from repro_torch import checkpoint  # noqa: E402
from repro_torch.data import pipeline as TP  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.config import get_config  # noqa: E402

TOL = dict(atol=2e-5, rtol=2e-5)
SLICE = ("yi-9b", "nemotron-4-15b", "internvl2-1b", "hubert-xlarge")


def _weights(arch, tmp_path):
    jcfg = jget_config(arch, reduced=True)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    path = tmp_path / f"{arch}.npz"
    save_checkpoint(str(path), jparams)
    cfg = get_config(arch, reduced=True)
    return jcfg, jparams, cfg, path


def _torch_batch(jbatch):
    return {k: torch.tensor(np.asarray(v)) for k, v in jbatch.items()}


@pytest.mark.parametrize("arch", SLICE)
def test_config_and_param_count_equal_the_reference(arch):
    for reduced in (False, True):
        cfg, jcfg = get_config(arch, reduced), jget_config(arch, reduced)
        for f in ("num_layers", "d_model", "vocab_size", "block_pattern",
                  "num_heads", "num_kv_heads", "head_dim", "d_ff",
                  "activation", "gated", "norm", "causal", "frontend",
                  "num_patches", "tie_embeddings", "source"):
            assert getattr(cfg, f) == getattr(jcfg, f), (arch, reduced, f)
        assert cfg.param_count() == jcfg.param_count()
        for prop in ("is_encoder", "has_attention", "attention_is_quadratic"):
            assert getattr(cfg, prop) == getattr(jcfg, prop), prop
    assert get_config("hubert-xlarge").is_encoder
    assert get_config("yi-9b").param_count() == 8_829_407_232


@pytest.mark.parametrize("arch", SLICE)
def test_weight_bridge_loads_every_leaf(arch, tmp_path):
    """Every array of the reference's npz lands in the port's tree (scan
    leaves split by layer), lm_head and layernorm biases included."""
    _, _, cfg, path = _weights(arch, tmp_path)
    flat = np.load(path)
    params = checkpoint.load_flat(path, cfg, device="cpu")
    seen = set()

    def check(key, got, index=None):
        want = flat[key] if index is None else flat[key][index]
        np.testing.assert_array_equal(got.numpy(), want)
        seen.add(key)

    for name, t in params["embed"].items():
        check(f"embed/{name}", t)
    for name, t in params["final_norm"].items():
        check(f"final_norm/{name}", t)
    for layer, block in enumerate(params["layers"]):
        for group, leaves in block.items():
            for name, t in leaves.items():
                check(f"scan/[0]/{group}/{name}", t, layer)
    assert seen == set(flat.files)
    assert "embed/lm_head" in seen
    assert ("scan/[0]/norm1/bias" in seen) == (cfg.norm == "layernorm")
    assert ("scan/[0]/ffn/w3" in seen) == cfg.gated


@pytest.mark.parametrize("use_kernels", [False, True])
def test_internvl_vision_prefill_then_decode_match_reference(use_kernels,
                                                             tmp_path):
    """16 patch embeddings and 12 tokens from ``make_batch``, prefilled as
    one 28-position sequence, then 4 decode steps; on: the reference's
    Pallas kernel in interpret mode, the port's plain flash version."""
    jcfg, jparams, cfg, path = _weights("internvl2-1b", tmp_path)
    params = checkpoint.load_flat(path, cfg, device="cpu")
    shape = JP.InputShape("t", cfg.num_patches + 12, 2, "prefill")
    jbatch = JP.make_batch(jcfg, shape, seed=3)
    jopts = JM.ModelOptions(use_kernels=use_kernels, remat=False)
    opts = M.ModelOptions(use_kernels=use_kernels)
    cache_len = shape.seq_len + 8
    jl, jc = JM.prefill(jparams, jbatch, jcfg, jopts, cache_len=cache_len)
    with torch.no_grad():
        tl, tc = M.prefill(params, _torch_batch(jbatch), cfg, opts, cache_len)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    tok = np.asarray(jl).argmax(-1).astype(np.int32)
    for i in range(4):
        pos = shape.seq_len + i
        jl, jc = JM.decode_step(jparams, jnp.asarray(tok), jnp.asarray(pos), jc,
                                jcfg, jopts)
        with torch.no_grad():
            tl, tc = M.decode_step(params, torch.from_numpy(tok).long(), pos,
                                   tc, cfg, opts)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        tok = np.asarray(jl).argmax(-1).astype(np.int32)
    for layer, c in enumerate(tc):
        np.testing.assert_allclose(c["v"].numpy(),
                                   np.asarray(jc["scan"][0]["v"][layer]),
                                   **TOL)


@pytest.mark.parametrize("opts_kw", [{"use_kernels": False},
                                     {"use_kernels": True},
                                     {"use_kernels": False,
                                      "blockwise_attention": 16}])
def test_hubert_forward_hidden_matches_reference(opts_kw, tmp_path):
    """The encoder over 64 audio frames from ``make_batch``: bidirectional
    attention, layernorm, gelu MLP, sinusoidal positions."""
    jcfg, jparams, cfg, path = _weights("hubert-xlarge", tmp_path)
    params = checkpoint.load_flat(path, cfg, device="cpu")
    jbatch = JP.make_batch(jcfg, JP.InputShape("t", 64, 2, "prefill"), seed=4)
    want, jaux = JM.forward_hidden(jparams, jbatch, jcfg,
                                   JM.ModelOptions(remat=False, **opts_kw))
    with torch.no_grad():
        got = M.forward_hidden(params, _torch_batch(jbatch), cfg,
                               M.ModelOptions(**opts_kw))
    assert got.shape == (2, 64, cfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert float(jaux) == 0.0                    # no MoE block: no aux loss


@pytest.mark.parametrize("S,D", [(7, 256), (50, 1280)])
def test_sin_positions_match_reference(S, D):
    want = JM._sin_positions(S, D, jnp.float32)
    got = M._sin_positions(S, D, torch.float32, "cpu")
    # XLA's and torch's fp32 exp differ by an ulp in the frequencies, which
    # the angle multiplies: ~4e-6 at position 48
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("arch", SLICE)
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_make_batch_equals_reference(arch, kind):
    """The same draws in the same order: every array equal, dtype for
    dtype."""
    shape = JP.InputShape("t", 40, 3, kind)
    want = JP.make_batch(jget_config(arch, reduced=True), shape, seed=11)
    got = TP.make_batch(get_config(arch, reduced=True),
                        TP.InputShape("t", 40, 3, kind), seed=11,
                        device="cpu")
    assert set(got) == set(want)
    for k in want:
        w = np.asarray(want[k])
        g = got[k].numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w)


def test_input_shapes_equal_the_reference():
    assert {n: dataclasses.astuple(s) for n, s in TP.SHAPES.items()} == \
        {n: dataclasses.astuple(s) for n, s in JP.SHAPES.items()}

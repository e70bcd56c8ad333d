"""The port's Mamba-2 SSD block and model against the JAX package on reduced
mamba2-2.7b, with the same weights: JAX initialises them, ``save_checkpoint``
writes the flat npz, and ``repro_torch.checkpoint.load_flat`` reads it.
Block parts (causal conv, ``ssd_forward``, ``ssd_step``, the prefill cache)
and the whole model's prefill and per-row decode logits are compared in fp32
at 2e-5, the model with the reference's jnp path (``use_kernels=False``) and
with its Pallas SSD kernel in interpret mode (``use_kernels=True``; the port
then runs its plain scan on the CPU). The reference's own SSD block tests
are mirrored on the port."""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint.store import save_checkpoint  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro.models.config import get_config as jget_config  # noqa: E402
from repro.models.steps import (make_jitted_decode,  # noqa: E402
                                make_jitted_prefill_into_slot)
from repro_torch import checkpoint  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.models import steps  # noqa: E402
from repro_torch.models.config import get_config  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

aten = torch.ops.aten
ARCH = "mamba2-2.7b"
CACHE_LEN = 48
TOL = dict(atol=2e-5, rtol=2e-5)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    jcfg = jget_config(ARCH, reduced=True)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    path = tmp_path_factory.mktemp("ckpt") / "mamba2-reduced.npz"
    save_checkpoint(str(path), jparams)
    cfg = get_config(ARCH, reduced=True)
    return jcfg, jparams, cfg, checkpoint.load_flat(path, cfg, device="cpu"), path


@pytest.fixture(scope="module")
def block():
    """One SSD mixer's parameters from the reference's ``init_ssd``, as JAX
    arrays and as the port's tensors."""
    cfg = get_config(ARCH, reduced=True)
    jp = JS.init_ssd(jget_config(ARCH, reduced=True), jax.random.PRNGKey(1),
                     jnp.float32)
    # random norm_scale and conv_b so their use is checked too
    rng = np.random.default_rng(9)
    jp = dict(jp, norm_scale=jnp.asarray(
        1 + 0.1 * rng.standard_normal(jp["norm_scale"].shape), jnp.float32),
        conv_b=jnp.asarray(0.1 * rng.standard_normal(jp["conv_b"].shape),
                           jnp.float32))
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    return cfg, jp, tp


def _x(cfg, shape, seed):
    return np.random.default_rng(seed).standard_normal(
        (*shape, cfg.d_model)).astype(np.float32)


# ---------------- block parts against the reference ----------------

def test_causal_conv_matches_reference(block):
    cfg, jp, tp = block
    C = jp["conv_w"].shape[1]
    x = np.random.default_rng(2).standard_normal((2, 11, C)).astype(np.float32)
    want = JS._causal_conv(jnp.asarray(x), jp["conv_w"], jp["conv_b"])
    got = ssm._causal_conv(torch.from_numpy(x), tp["conv_w"], tp["conv_b"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("S", [40, 64])          # padded to 64; a multiple
def test_ssd_forward_matches_reference(block, S, use_kernel):
    cfg, jp, tp = block
    x = _x(cfg, (2, S), seed=S)
    want = JS.ssd_forward(jp, jnp.asarray(x), cfg, use_kernel=use_kernel)
    got = ssm.ssd_forward(tp, torch.from_numpy(x), cfg, use_kernel=use_kernel)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_prefill_cache_matches_reference(block):
    cfg, jp, tp = block
    x = _x(cfg, (2, 21), seed=5)
    want = JM._ssd_cache_from_prefill(jp, jnp.asarray(x), cfg)
    got = ssm.ssd_cache_from_prefill(tp, torch.from_numpy(x), cfg)
    assert got["state"].dtype == torch.float32
    for name in ("state", "conv"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   **TOL)


def _cache_by_second_projection(params, h, cfg):
    """The prefill cache as the port built it before ``ssd_forward`` gave
    it: ``h @ in_proj`` formed again, the conv, SiLU and discretisation
    again, then the state sum."""
    B, S, D = h.shape
    di, H, P, N = cfg.d_inner, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    G = ssm.N_GROUPS
    zxbcdt = h @ params["in_proj"]
    xBC_raw = zxbcdt[..., di: di + di + 2 * G * N]
    dt = zxbcdt[..., di + di + 2 * G * N:]
    xBC = torch.nn.functional.silu(
        ssm._causal_conv(xBC_raw, params["conv_w"], params["conv_b"]))
    xin = xBC[..., :di].reshape(B, S, H, P).float()
    Bm = xBC[..., di: di + G * N].reshape(B, S, G, N).float()
    dt = torch.nn.functional.softplus(dt.float() + params["dt_bias"])
    A = -torch.exp(params["A_log"])
    cs = torch.cumsum(dt * A, dim=1)
    w = dt * torch.exp(cs[:, -1:, :] - cs)
    xw = (xin * w[..., None]).reshape(B, S, G, H // G, P)
    state = torch.einsum("bsgn,bsgrp->bgrpn", Bm, xw).reshape(B, H, P, N)
    return {"state": state, "conv": xBC_raw[:, S - (cfg.ssm_conv - 1):, :]}


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("S", [64, 21, 3])   # 2 chunks, ragged, ssm_conv - 1
def test_forward_cache_is_the_second_projections_bit_for_bit(block, S,
                                                             use_kernel):
    """The cache that ``ssd_forward(want_cache=True)`` takes from its own
    projection is, tensor for tensor, the one a second ``h @ in_proj`` gave;
    its output is the cacheless call's."""
    cfg, _, tp = block
    x = torch.from_numpy(_x(cfg, (2, S), seed=30 + S))
    y, got = ssm.ssd_forward(tp, x, cfg, use_kernel=use_kernel,
                             want_cache=True)
    want = _cache_by_second_projection(tp, x, cfg)
    assert got["state"].dtype == torch.float32
    assert tuple(got["conv"].shape) == (2, cfg.ssm_conv - 1,
                                        want["conv"].shape[-1])
    for name in ("state", "conv"):
        assert torch.equal(got[name], want[name]), name
    assert torch.equal(y, ssm.ssd_forward(tp, x, cfg, use_kernel=use_kernel))


def test_ssd_step_matches_reference(block):
    cfg, jp, tp = block
    rng = np.random.default_rng(6)
    jcache = JS.ssd_init_cache(cfg, 3, jnp.float32)
    cache = ssm.ssd_init_cache(cfg, 3, torch.float32, "cpu")
    assert cache["state"].dtype == torch.float32
    assert tuple(cache["state"].shape) == tuple(jcache["state"].shape)
    assert tuple(cache["conv"].shape) == tuple(jcache["conv"].shape)
    for _ in range(3):
        x = rng.standard_normal((3, 1, cfg.d_model)).astype(np.float32)
        jy, jcache = JS.ssd_step(jp, jnp.asarray(x), jcache, cfg)
        y, cache = ssm.ssd_step(tp, torch.from_numpy(x), cache, cfg)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    for name in ("state", "conv"):
        np.testing.assert_allclose(cache[name].numpy(),
                                   np.asarray(jcache[name]), **TOL)


def test_bf16_cache_keeps_fp32_state(block):
    cfg, _, _ = block
    cache = M.init_cache(cfg, 2, CACHE_LEN, torch.bfloat16, M.ModelOptions(),
                         device="cpu")
    assert cache[0]["state"].dtype == torch.float32
    assert cache[0]["conv"].dtype == torch.bfloat16


# ---------------- the reference's block tests, on the port ----------------

def test_ssd_block_causality(block):
    """Mirrors test_model_parts.py::test_ssd_block_causality."""
    cfg, _, tp = block
    S = 64
    x1 = _x(cfg, (1, S), seed=7)
    x2 = x1.copy()
    x2[0, S // 2:] += 5.0                    # mutate the future
    y1 = ssm.ssd_forward(tp, torch.from_numpy(x1), cfg)
    y2 = ssm.ssd_forward(tp, torch.from_numpy(x2), cfg)
    np.testing.assert_allclose(y1.numpy()[0, : S // 2],
                               y2.numpy()[0, : S // 2], atol=1e-4)


def test_ssd_decode_matches_forward(block):
    """Mirrors test_model_parts.py::test_ssd_decode_matches_forward:
    step-by-step ssd_step == full-sequence ssd_forward, at 2e-4."""
    cfg, _, tp = block
    S = 16
    x = torch.from_numpy(_x(cfg, (2, S), seed=8))
    full = ssm.ssd_forward(tp, x, cfg)
    cache = ssm.ssd_init_cache(cfg, 2, torch.float32, "cpu")
    got = []
    for t in range(S):
        y, cache = ssm.ssd_step(tp, x[:, t:t + 1], cache, cfg)
        got.append(y[:, 0])
    torch.testing.assert_close(torch.stack(got, 1), full, atol=2e-4,
                               rtol=2e-4)


@pytest.mark.parametrize("chunk", [16, 64])
def test_ssd_forward_chunk_invariance(block, chunk):
    """The block's output does not depend on the chunk size (the scan's
    chunk-invariance, through the padding of ssd_forward)."""
    cfg, _, tp = block
    x = torch.from_numpy(_x(cfg, (2, 40), seed=10))
    want = ssm.ssd_forward(tp, x, cfg)
    got = ssm.ssd_forward(tp, x, dataclasses.replace(cfg, ssm_chunk=chunk))
    torch.testing.assert_close(got, want, atol=3e-5, rtol=3e-5)


# ---------------- the weight bridge ----------------

def test_load_flat_splits_scan_stacked_leaves(weights):
    jcfg, jparams, cfg, params, path = weights
    flat = np.load(path)
    assert flat["scan/[0]/mixer/in_proj"].shape[0] == cfg.num_layers
    assert len(params["layers"]) == cfg.num_layers
    for layer in range(cfg.num_layers):
        got = params["layers"][layer]
        assert set(got) == {"norm1", "mixer"}           # no norm2, no ffn
        for name in ("in_proj", "conv_w", "conv_b", "A_log", "D", "dt_bias",
                     "norm_scale", "out_proj"):
            np.testing.assert_array_equal(
                got["mixer"][name].numpy(),
                flat[f"scan/[0]/mixer/{name}"][layer])
        np.testing.assert_array_equal(got["norm1"]["scale"].numpy(),
                                      flat["scan/[0]/norm1/scale"][layer])
    np.testing.assert_array_equal(params["embed"]["lm_head"].numpy(),
                                  flat["embed/lm_head"])


def test_load_flat_bf16_keeps_ssm_scalars_fp32(weights):
    _, _, cfg, _, path = weights
    params = checkpoint.load_flat(path, cfg, device="cpu",
                                  dtype=torch.bfloat16)
    mixer = params["layers"][0]["mixer"]
    for name in ("A_log", "D", "dt_bias"):
        assert name in checkpoint.FP32_LEAVES
        assert mixer[name].dtype == torch.float32, name
    for name in ("in_proj", "conv_w", "conv_b", "norm_scale", "out_proj"):
        assert mixer[name].dtype == torch.bfloat16, name
    np.testing.assert_array_equal(mixer["dt_bias"].numpy(),
                                  np.load(path)["scan/[0]/mixer/dt_bias"][0])


def test_init_params_shapes_and_distributions():
    cfg = get_config(ARCH, reduced=True)
    params = checkpoint.init_params(cfg, torch.Generator().manual_seed(0),
                                    dtype=torch.bfloat16, device="cpu")
    jparams = JM.init_params(jget_config(ARCH, reduced=True),
                             jax.random.PRNGKey(0), jnp.float32)
    for name, leaf in jparams["scan"][0]["mixer"].items():
        assert tuple(params["layers"][0]["mixer"][name].shape) == \
            leaf.shape[1:], name
    mixer = params["layers"][0]["mixer"]
    D, di, L = cfg.d_model, cfg.d_inner, cfg.num_layers
    for name, std in (("in_proj", D ** -0.5),
                      ("conv_w", cfg.ssm_conv ** -0.5),
                      ("out_proj", di ** -0.5 / (2 * L) ** 0.5)):
        assert abs(mixer[name].float().std().item() / std - 1) < 0.1, name
    np.testing.assert_allclose(mixer["A_log"].numpy(),
                               np.asarray(jparams["scan"][0]["mixer"]["A_log"][0]),
                               rtol=1e-6)
    dt_bias = mixer["dt_bias"].numpy()
    assert dt_bias.min() >= math.log(1e-3) and dt_bias.max() <= math.log(1e-1)
    assert mixer["D"].dtype == mixer["A_log"].dtype == torch.float32
    assert bool((mixer["D"] == 1).all()) and bool((mixer["conv_b"] == 0).all())
    assert bool((mixer["norm_scale"] == 1).all())
    assert abs(params["embed"]["embedding"].float().std().item() / 0.02 - 1) \
        < 0.05
    assert abs(params["embed"]["lm_head"].float().std().item() * D ** 0.5
               - 1) < 0.05


def test_param_count_is_the_references():
    """Kept exactly as the reference counts it (2L + 1 norms, no conv_b or
    norm_scale), so fleet plans size HBM as the reference does."""
    cfg = get_config(ARCH)
    assert cfg.param_count() == jget_config(ARCH).param_count() == 2_830_788_096
    n = sum(math.prod(s) for s in _shape_leaves(checkpoint.param_shapes(cfg)))
    assert n == 2_831_296_000            # what the port actually allocates


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
    """Two prompts of different lengths are prefilled into slots 0 and 1,
    then decode 4 steps together at per-row positions."""
    jcfg, jparams, cfg, params, _ = weights
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (12, 40)]

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
        assert c["state"].dtype == torch.float32
        for name in ("state", "conv"):
            np.testing.assert_allclose(
                c[name].numpy(), np.asarray(jcache["scan"][0][name][layer]),
                **TOL)


def test_prefill_into_slot_matches_batched_prefill(weights):
    """Admitting requests one by one into a pooled cache produces the same
    logits and state as prefilling them together as one batch."""
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
        for name in ("state", "conv"):
            torch.testing.assert_close(got[name], want[name], atol=1e-5,
                                       rtol=1e-5)


def test_prompt_shorter_than_conv_history_is_refused(weights):
    """A 2-token prompt leaves 1 conv-history row where a slot holds
    ssm_conv - 1 = 3 (the reference slices S - 3 from the end, and its slot
    update then keeps 2 stale rows); the port raises instead of
    broadcasting the one row."""
    _, _, cfg, params, _ = weights
    opts = M.ModelOptions()
    cache = M.init_cache(cfg, 2, CACHE_LEN, torch.float32, opts, device="cpu")
    toks = torch.tensor([[5, 9]])
    _, one = steps.prefill_step(params, {"tokens": toks}, cfg, opts,
                                CACHE_LEN)
    assert one[0]["conv"].shape[1] == 1 < cfg.ssm_conv - 1
    with pytest.raises(ValueError):
        steps.prefill_into_slot_step(params, cache, {"tokens": toks}, 0, cfg,
                                     opts, CACHE_LEN)


def test_decode_rows_are_independent(weights):
    """A free slot riding along in the batched decode touches only its own
    row: the other rows' logits and caches are what they would be alone."""
    _, _, cfg, params, _ = weights
    opts = M.ModelOptions()
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (1, 16)))
    alone = M.init_cache(cfg, 1, CACHE_LEN, torch.float32, opts, device="cpu")
    _, alone = steps.prefill_into_slot_step(params, alone, {"tokens": toks},
                                            0, cfg, opts, CACHE_LEN)
    pool = M.init_cache(cfg, 3, CACHE_LEN, torch.float32, opts, device="cpu")
    for c in pool:                          # garbage in the free rows
        c["state"].normal_()
        c["conv"].normal_()
    _, pool = steps.prefill_into_slot_step(params, pool, {"tokens": toks}, 1,
                                           cfg, opts, CACHE_LEN)
    tok = torch.tensor([7])
    la, alone = steps.decode_step(params, alone, {"token": tok, "pos": 16},
                                  cfg, opts)
    lp, pool = steps.decode_step(params, pool,
                                 {"token": torch.tensor([3, 7, 11]),
                                  "pos": torch.tensor([0, 16, 5])}, cfg, opts)
    torch.testing.assert_close(lp[1], la[0], atol=1e-5, rtol=1e-5)
    for a, p in zip(alone, pool):
        for name in ("state", "conv"):
            torch.testing.assert_close(p[name][1], a[name][0], atol=1e-5,
                                       rtol=1e-5)


class _InProjProducts(TorchDispatchMode):
    """Counts the matrix products whose right-hand operand has ``in_proj``'s
    shape (d_model, d_in_proj)."""

    def __init__(self, shape):
        super().__init__()
        self.shape, self.n = tuple(shape), 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        rhs = {aten.mm: 1, aten.bmm: 1, aten.addmm: 2}.get(
            func.overloadpacket)
        if rhs is not None and tuple(args[rhs].shape[-2:]) == self.shape:
            self.n += 1
        return func(*args, **(kwargs or {}))


def test_prefill_forms_in_proj_once_a_layer(weights):
    """A serving prefill forms ``h @ in_proj`` once an SSD layer: its decode
    cache comes from the forward's own projection, not a second one. A
    cacheless forward forms it once too."""
    _, _, cfg, params, _ = weights
    mixer = params["layers"][0]["mixer"]
    shape = (cfg.d_model, mixer["in_proj"].shape[1])
    opts = M.ModelOptions()
    cache = M.init_cache(cfg, 2, CACHE_LEN, torch.float32, opts, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(8).integers(
        0, cfg.vocab_size, (1, 40)))
    with _InProjProducts(shape) as count:
        steps.prefill_into_slot_step(params, cache, {"tokens": toks}, 1, cfg,
                                     opts, CACHE_LEN)
    assert count.n == cfg.num_layers
    h = torch.from_numpy(_x(cfg, (1, 40), seed=11))
    with _InProjProducts(shape) as count:
        ssm.ssd_forward(mixer, h, cfg)
    assert count.n == 1

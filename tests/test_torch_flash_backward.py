"""Flash attention's gradient in the port: the backward's plain version
(``ref.flash_attention_bwd_ref``, the function the CUDA backward kernel
computes) against ``torch.autograd`` through ``ref.flash_attention_ref`` and
against ``jax.vjp`` of the reference's ``repro.kernels.ref.
flash_attention_ref``; ``torch.autograd.gradcheck`` of ``ops.FlashAttention``
on fp64 CPU inputs; the forward's log-sum-exp; the backward wrapper's checks
that need no GPU; and the bf16 kernel's rounding points (P and dS rounded to
bf16 before the products that take them) emulated in torch against the fp32
gradient. The kernel itself is held against the plain version on the GPU in
tests/test_torch_cuda_kernels.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

# fp32 sums in other orders: the reference's gradient tolerance
# (test_model_parts.py::test_blockwise_attention_grad_matches)
TOL = dict(atol=5e-5, rtol=5e-5)

SHAPES = [
    # B, S, H, hd, K, T, causal, window
    (2, 64, 4, 64, 2, 64, True, 0),       # GQA causal
    (1, 96, 4, 64, 1, 96, True, 24),      # MQA, window inside a tile
    (1, 80, 2, 80, 2, 80, False, 0),      # hd 80 encoder (hubert-xlarge)
    (2, 40, 4, 128, 4, 40, True, 0),      # hd 128 MHA (olmo-1b)
    (1, 37, 6, 32, 3, 37, True, 0),       # ragged, 2-way GQA
    (1, 33, 4, 64, 2, 33, False, 16),     # encoder with a window
    (1, 24, 4, 64, 2, 50, True, 20),      # T > S (the plain version's own)
]


def _inputs(shape, seed=0):
    B, S, H, hd, K, T, _, _ = shape
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, hd)).astype(np.float32),
            rng.standard_normal((B, T, K, hd)).astype(np.float32),
            rng.standard_normal((B, T, K, hd)).astype(np.float32),
            rng.standard_normal((B, S, H, hd)).astype(np.float32))


@pytest.mark.parametrize("shape", SHAPES)
def test_backward_plain_version_matches_autograd_and_jax(shape):
    causal, window = shape[6], shape[7]
    q, k, v, do = _inputs(shape)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = ref.flash_attention_fwd_ref(tq, tk, tv, causal=causal,
                                         window=window)
    got = ref.flash_attention_bwd_ref(tq, tk, tv, o, lse, tdo,
                                      causal=causal, window=window)

    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    out = ref.flash_attention_ref(*leaves, causal=causal, window=window)
    torch.testing.assert_close(out.detach(), o, atol=0, rtol=0)
    by_autograd = torch.autograd.grad(out, leaves, tdo)

    f = lambda a, b, c: jref.flash_attention_ref(a, b, c, causal=causal,
                                                 window=window)
    _, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    by_jax = vjp(jnp.asarray(do))
    for name, g, a, j in zip("qkv", got, by_autograd, by_jax):
        assert g.shape == a.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), a.numpy(), **TOL,
                                   err_msg=f"d{name} vs autograd")
        np.testing.assert_allclose(g.numpy(), np.asarray(j), **TOL,
                                   err_msg=f"d{name} vs jax")


@pytest.mark.parametrize("shape", SHAPES[:3])
def test_forward_lse_is_the_logsumexp_of_the_masked_scores(shape):
    causal, window = shape[6], shape[7]
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(shape, seed=1))
    o, lse = ref.flash_attention_fwd_ref(q, k, v, causal=causal,
                                         window=window)
    B, S, H, hd = q.shape
    assert lse.shape == (B, H, S) and lse.dtype == torch.float32
    torch.testing.assert_close(
        o, ref.flash_attention_ref(q, k, v, causal=causal, window=window))
    # the row-wise softmax of the same masked scores sums to 1 with lse
    G = H // k.shape[2]
    scores = torch.einsum("bshd,bthd->bhst", q,
                          k.repeat_interleave(G, dim=2)) / hd ** 0.5
    p = torch.exp(scores - lse[..., None])
    t, s = torch.arange(k.shape[1]), torch.arange(S) + k.shape[1] - S
    vis = torch.ones(S, k.shape[1], dtype=torch.bool)
    if causal:
        vis &= t[None] <= s[:, None]
    if window:
        vis &= t[None] > s[:, None] - window
    torch.testing.assert_close((p * vis).sum(-1), torch.ones(B, H, S))


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 3), (False, 0)])
def test_flash_function_gradcheck(causal, window):
    """The autograd Function's wiring (saved tensors, lse, the backward's
    order of outputs, None for causal and window) with the plain versions,
    in fp64."""
    rng = np.random.default_rng(2)
    mk = lambda *s: torch.tensor(rng.standard_normal(s), dtype=torch.float64,
                                 requires_grad=True)
    q, k, v = mk(1, 7, 4, 8), mk(1, 7, 2, 8), mk(1, 7, 2, 8)
    fn = lambda a, b, c: ops.flash_attention(a, b, c, causal=causal,
                                             window=window)
    assert torch.autograd.gradcheck(fn, (q, k, v))
    out = fn(q, k, v)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"


def test_dispatch_takes_the_function_only_under_grad():
    q, k, v = (torch.randn(1, 8, 2, 32) for _ in range(3))
    assert ops.flash_attention(q, k, v).grad_fn is None
    q.requires_grad_()
    assert ops.flash_attention(q, k, v).grad_fn is not None
    with torch.no_grad():
        assert ops.flash_attention(q, k, v).grad_fn is None


def test_backward_wrapper_checks_without_a_gpu():
    q, k, v, do = (torch.from_numpy(a) for a in
                   _inputs((1, 64, 4, 64, 2, 64, True, 0)))
    o = torch.zeros_like(q)
    tfa.check_bwd_shapes(q, k, v, o, do)
    with pytest.raises(ValueError, match="T == S"):
        tfa.check_bwd_shapes(q[:, :32].contiguous(), k, v,
                             o[:, :32].contiguous(), do[:, :32].contiguous())
    with pytest.raises(ValueError):
        tfa.check_bwd_shapes(q, k, v, o.bfloat16(), do)
    with pytest.raises(ValueError):
        tfa.check_bwd_shapes(q, k, v, o, do.transpose(1, 2))
    with pytest.raises(ValueError):                 # the CUDA wrapper itself
        tfa.flash_attention_bwd(q, k, v, o, torch.zeros(1, 4, 64), do)
    # every instantiation fits a block: the fp32 dq block at hd 128 (q, dO,
    # a ring of two 64-key k/v tiles of padded rows, dSᵀ, lse and Δ) is the
    # largest of all
    assert tfa.smem_bytes_bwd(128) == 220_672
    assert max(map(tfa.smem_bytes_bwd, tfa.HEAD_DIMS)) == 220_672 \
        <= tfa.MAX_SMEM_BYTES


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [32, 64, 80, 128, 256])
def test_backward_shared_memory_fits_a_block(hd, dtype):
    """Every head dim in both dtypes fits one block's 227 KB, and the
    wrapper's checks pass for it; bf16 tiles are staged as bf16, so they
    take less than fp32's at the same head dim."""
    assert hd in tfa.HEAD_DIMS
    need = tfa.smem_bytes_bwd(hd, dtype)
    assert 0 < need <= tfa.MAX_SMEM_BYTES
    if dtype == torch.bfloat16:
        assert need < tfa.smem_bytes_bwd(hd, torch.float32)
    q, k, v, do = (torch.from_numpy(a).to(dtype) for a in
                   _inputs((1, 8, 2, hd, 1, 8, True, 0)))
    tfa.check_bwd_shapes(q, k, v, torch.zeros_like(q), do)


def _bf16_kernel_arithmetic(q, k, v, o, lse, do, causal, window):
    """The bf16 backward kernel's arithmetic written out in torch: the bf16
    inputs' products summed in fp32 (S, dP and Δ exact as the tensor cores'
    fp32 accumulation of bf16 products), P = exp(S·scale − lse) and
    dS = P ∘ (dP − Δ) in fp32, then P and dS rounded to bf16 before
    dV = Pᵀ·dO, dK = dSᵀ·q·scale and dQ = dS·k·scale, the outputs rounded to
    bf16."""
    B, S, H, hd = q.shape
    K = k.shape[2]
    G = H // K
    scale = hd ** -0.5
    qg, og, dog = (t.float().reshape(B, S, K, G, hd) for t in (q, o, do))
    delta = (dog * og).sum(-1).permute(0, 2, 3, 1)
    p = torch.exp(ref._masked_scores(q, k, causal, window)
                  - lse.reshape(B, K, G, S)[..., None])
    dp = torch.einsum("bskgh,btkh->bkgst", dog, v.float())
    ds = p * (dp - delta[..., None])
    p16, ds16 = p.bfloat16().float(), ds.bfloat16().float()
    dv = torch.einsum("bkgst,bskgh->btkh", p16, dog)
    dq = torch.einsum("bkgst,btkh->bskgh", ds16, k.float()) * scale
    dk = torch.einsum("bkgst,bskgh->btkh", ds16, qg) * scale
    return (dq.reshape(B, S, H, hd).bfloat16(), dk.bfloat16(),
            dv.bfloat16())


# small versions of each family of chip_smoke.py's BWD_SHAPES:
# B, S, H, hd, K, causal, window
BF16_FAMILIES = [
    (2, 64, 4, 128, 4, True, 0),       # olmo-1b: MHA causal
    (1, 64, 16, 128, 2, True, 0),      # yi-9b: 8-way GQA
    (1, 72, 7, 64, 1, True, 0),        # internvl2-1b: 7-way GQA, ragged
    (1, 96, 4, 256, 1, True, 24),      # hd 256 MQA with a window
    (1, 100, 4, 80, 4, False, 0),      # hubert-xlarge: encoder, hd 80
    (2, 37, 4, 32, 2, True, 0),        # ragged causal at hd 32
]


@pytest.mark.parametrize("shape", BF16_FAMILIES)
def test_bf16_rounding_points_stay_within_tolerance(shape):
    """Rounding P and dS to bf16 before dV, dK and dQ (as the bf16 kernel
    does on the tensor cores) keeps the gradient within the bf16 tolerance
    (2e-2 absolute plus relative) of the fp32 gradient of the same bf16
    inputs, at a small version of each shape family the card checks."""
    B, S, H, hd, K, causal, window = shape
    q, k, v, do = (torch.from_numpy(a).bfloat16() for a in
                   _inputs((B, S, H, hd, K, S, causal, window), seed=3))
    o, lse = ref.flash_attention_fwd_ref(q, k, v, causal=causal,
                                         window=window)
    want = ref.flash_attention_bwd_ref(q.float(), k.float(), v.float(),
                                       o.float(), lse, do.float(),
                                       causal=causal, window=window)
    got = _bf16_kernel_arithmetic(q, k, v, o, lse, do, causal, window)
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        err = (g.float() - w).abs()
        assert bool((err <= 2e-2 + 2e-2 * w.abs()).all()), \
            f"d{name}: max |err| {err.max().item():.3e}"
        assert err.max().item() > 0          # the rounding is there

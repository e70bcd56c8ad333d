"""Flash attention's gradient in the port: the backward's plain version
(``ref.flash_attention_bwd_ref``, the function the CUDA backward kernel
computes) against ``torch.autograd`` through ``ref.flash_attention_ref`` and
against ``jax.vjp`` of the reference's ``repro.kernels.ref.
flash_attention_ref``; ``torch.autograd.gradcheck`` of ``ops.FlashAttention``
on fp64 CPU inputs; the forward's log-sum-exp; and the backward wrapper's
checks that need no GPU. The kernel itself is held against the plain
version on the GPU in tests/test_torch_cuda_kernels.py."""
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
    # every instantiation fits a block: 4 fp32 tiles of 32 padded rows, the
    # P and dS tiles, lse and delta
    assert tfa.smem_bytes_bwd(128) == 76_288
    assert max(map(tfa.smem_bytes_bwd, tfa.HEAD_DIMS)) == 141_824 \
        <= tfa.MAX_SMEM_BYTES

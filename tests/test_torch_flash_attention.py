"""The port's plain flash attention (the CPU path of ``kernels.ops``) against
the JAX Pallas kernel in interpret mode (through the reference's jitted
``kernels.ops`` wrapper, which interprets it off the TPU) and the JAX oracle, and the
dispatch rules of ``kernels.ops``. The CUDA kernel itself is held against
the plain version on the GPU in tests/test_torch_cuda_kernels.py."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _inputs(seed, B, S, H, hd, K, T):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, hd)).astype(np.float32),
            rng.standard_normal((B, T, K, hd)).astype(np.float32),
            rng.standard_normal((B, T, K, hd)).astype(np.float32))


def _port(arrs, tdtype, **kw):
    q, k, v = (torch.from_numpy(a).to(tdtype) for a in arrs)
    return ops.flash_attention(q, k, v, **kw).float().numpy()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("B,S,H,hd,K,T,causal,window", [
    (2, 128, 4, 64, 2, 128, True, 0),      # GQA causal
    (1, 256, 4, 64, 1, 256, True, 64),     # MQA sliding window
    (2, 128, 4, 64, 4, 256, True, 0),      # T > S
    (1, 128, 2, 32, 2, 128, False, 0),     # encoder (bidirectional)
    (1, 64, 4, 64, 4, 32, True, 0),        # T < S: rows with no visible key
    (1, 128, 2, 80, 2, 128, False, 0),     # hd 80 (hubert-xlarge), encoder
    (2, 128, 4, 80, 2, 128, True, 0),      # hd 80, causal GQA
])
def test_plain_matches_pallas_and_oracle(dtype, B, S, H, hd, K, T, causal,
                                         window):
    jdtype, tdtype, tol = DTYPES[dtype]
    arrs = _inputs(B * S + T, B, S, H, hd, K, T)
    got = _port(arrs, tdtype, causal=causal, window=window)
    jq, jk, jv = (jnp.asarray(a, jdtype) for a in arrs)
    pallas = jops.flash_attention(jq, jk, jv, causal=causal, window=window)
    oracle = jref.flash_attention_ref(jq, jk, jv, causal=causal, window=window)
    for want in (pallas, oracle):
        np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                   atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("B,S,H,hd,K,T,causal,window", [
    (1, 500, 4, 80, 4, 500, False, 0),     # hubert's length: ragged tiles
    (2, 77, 8, 80, 2, 77, True, 0),        # ragged causal GQA
    (1, 37, 4, 80, 2, 90, True, 24),       # T > S with a window
])
def test_plain_matches_oracle_at_head_dim_80(dtype, B, S, H, hd, K, T,
                                             causal, window):
    """Shapes the Pallas kernel does not take (above 128, S and T must be
    multiples of its block): against the jnp oracle only."""
    jdtype, tdtype, tol = DTYPES[dtype]
    arrs = _inputs(S + T, B, S, H, hd, K, T)
    got = _port(arrs, tdtype, causal=causal, window=window)
    jq, jk, jv = (jnp.asarray(a, jdtype) for a in arrs)
    want = jref.flash_attention_ref(jq, jk, jv, causal=causal, window=window)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_hubert_at_head_dim_80_forward_hidden_matches_reference(
        use_kernels, tmp_path):
    """Reduced hubert-xlarge with 2 heads of 80 (the full model's head
    dim): the encoder's hidden states against the reference's, whose
    kernel path is the Pallas kernel in interpret mode."""
    import dataclasses

    import jax
    from repro.checkpoint.store import save_checkpoint
    from repro.data.pipeline import InputShape, make_batch
    from repro.models import model as JM
    from repro.models.config import get_config as jget_config
    from repro_torch.checkpoint import load_flat
    from repro_torch.models import model as M
    from repro_torch.models.config import get_config

    hd80 = dict(num_heads=2, num_kv_heads=2, head_dim=80)
    jcfg = dataclasses.replace(jget_config("hubert-xlarge", reduced=True),
                               **hd80)
    cfg = dataclasses.replace(get_config("hubert-xlarge", reduced=True),
                              **hd80)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(1), jnp.float32)
    save_checkpoint(str(tmp_path / "hubert80.npz"), jparams)
    params = load_flat(tmp_path / "hubert80.npz", cfg, device="cpu")
    batch = make_batch(jcfg, InputShape("t", 64, 2, "prefill"), seed=2)
    want, _ = JM.forward_hidden(jparams, batch, jcfg, JM.ModelOptions(
        use_kernels=use_kernels, remat=False))
    with torch.no_grad():
        got = M.forward_hidden(
            params, {"frames": torch.tensor(np.asarray(batch["frames"]))},
            cfg, M.ModelOptions(use_kernels=use_kernels))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


def test_row_with_no_visible_key_is_mean_of_v():
    arrs = _inputs(5, 1, 48, 2, 32, 2, 16)
    got = _port(arrs, torch.float32, causal=True)
    mean_v = arrs[2].mean(axis=1, keepdims=True)          # (1, 1, K, hd)
    np.testing.assert_allclose(got[:, :32], np.broadcast_to(
        mean_v, (1, 32, 2, 32)), atol=1e-6, rtol=1e-6)
    assert np.isfinite(got).all()


def test_dispatch_plain_on_cpu_and_raises_elsewhere():
    q, k, v = (torch.from_numpy(a) for a in _inputs(0, 1, 16, 2, 32, 2, 16))
    before = tfa.flash_attention.launches
    out = ops.flash_attention(q, k, v, causal=True)
    torch.testing.assert_close(out, ref.flash_attention_ref(q, k, v))
    assert tfa.flash_attention.launches == before      # no kernel launched
    with pytest.raises(ValueError):
        ops.flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))
    with pytest.raises(ValueError):                    # mixed devices
        ops.flash_attention(q, k.to("meta"), v)


def test_cuda_wrapper_refuses_cpu_tensors():
    q, k, v = (torch.from_numpy(a) for a in _inputs(0, 1, 16, 2, 32, 2, 16))
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention(q, k, v)


@pytest.mark.parametrize("hd,dtype,want", [
    (32, torch.float32, 18_560), (64, torch.float32, 35_968),
    (80, torch.float32, 44_672), (80, torch.bfloat16, 33_792),
    (128, torch.float32, 70_784), (256, torch.float32, 140_416),
    (128, torch.bfloat16, 52_224), (256, torch.bfloat16, 101_376),
])
def test_smem_bytes_follow_the_kernels_layout(hd, dtype, want):
    """A ring of two 32-key K/V tiles beside the block's query rows (8 in
    fp32, 64 in bf16); every head dim fits a Hopper block."""
    assert tfa.smem_bytes(hd, dtype) == want <= tfa.MAX_SMEM_BYTES


def test_shape_checks_refuse_what_the_kernel_does_not_take():
    """The device-independent checks, on CPU tensors."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(0, 1, 32, 4, 64, 4, 32))
    tfa.check_shapes(q, k, v)                            # the good case
    q80, k80, v80 = (torch.from_numpy(a)
                     for a in _inputs(1, 1, 500, 16, 80, 16, 500))
    tfa.check_shapes(q80, k80, v80)                      # hubert's, hd 80
    tfa.check_shapes(*(t.bfloat16() for t in (q80, k80, v80)))
    assert 80 in tfa.HEAD_DIMS
    bad = [
        (q.half(), k.half(), v.half()),                  # dtype
        (q, k.bfloat16(), v),                            # mixed dtypes
        (q[0], k, v),                                    # not 4-d
        (q, k, v[:, :16]),                               # k, v differ
        (q[..., :48].contiguous(), k[..., :48].contiguous(),
         v[..., :48].contiguous()),                      # head dim 48
        (q, k[:, :, :3].contiguous(), v[:, :, :3].contiguous()),  # 4 % 3
        (q[:, :0], k, v),                                # empty
        (q.transpose(1, 2).contiguous().transpose(1, 2), k, v),  # layout
    ]
    for args in bad:
        with pytest.raises(ValueError):
            tfa.check_shapes(*args)
    off = torch.empty(q.numel() + 1)[1:].view(q.shape)  # 4 bytes off
    with pytest.raises(ValueError, match="16 bytes"):
        tfa.check_shapes(off, k, v)

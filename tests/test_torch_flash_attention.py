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

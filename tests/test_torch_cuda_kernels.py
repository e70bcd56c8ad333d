"""The CUDA flash-attention kernel against its plain PyTorch version, on the
GPU. Every test here needs a CUDA device of compute capability >= 9.0
(Hopper) and skips without one; this file imports no jax, so it runs on a
machine that has only PyTorch and the CUDA toolkit:

    python -m pytest -q tests/test_torch_cuda_kernels.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

# fp32: the kernel and the plain version sum in different orders on the
# card; bf16: both round the fp32 result once, so they may land one bf16
# step apart
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}

SHAPES = [
    # B, S, H, hd, K, T, causal, window
    (2, 128, 4, 64, 2, 128, True, 0),      # GQA causal
    (1, 256, 4, 64, 1, 256, True, 64),     # MQA sliding window
    (2, 128, 4, 64, 4, 256, True, 0),      # T > S
    (1, 128, 2, 32, 2, 128, False, 0),     # encoder (bidirectional)
    (1, 512, 8, 128, 2, 512, True, 128),   # bigger window
    (1, 32, 16, 128, 16, 32, True, 0),     # olmo-1b prefill of 32 tokens
    (2, 100, 4, 64, 2, 100, True, 0),      # ragged: no tile divides 100
    (1, 37, 8, 128, 2, 90, True, 24),      # ragged T > S with a window
    (1, 64, 4, 64, 4, 48, True, 0),        # T < S: rows with no visible key
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available() or \
            torch.cuda.get_device_capability() < (9, 0):
        pytest.skip("needs a CUDA GPU of compute capability >= 9.0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(shape, dtype, device, seed=0):
    B, S, H, hd, K, T, _, _ = shape
    rng = np.random.default_rng(seed)
    mk = lambda *s: torch.as_tensor(rng.standard_normal(s), dtype=torch.float32
                                    ).to(device=device, dtype=dtype)
    return mk(B, S, H, hd), mk(B, T, K, hd), mk(B, T, K, hd)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
def test_kernel_matches_plain_version(cuda, shape, dtype):
    q, k, v = _inputs(shape, dtype, cuda)
    causal, window = shape[6], shape[7]
    got = fa.flash_attention(q, k, v, causal=causal, window=window)
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    tol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


def test_row_with_no_visible_key_is_mean_of_v(cuda):
    shape = (1, 64, 4, 64, 4, 48, True, 0)
    q, k, v = _inputs(shape, torch.float32, cuda, seed=1)
    got = fa.flash_attention(q, k, v, causal=True)
    blind = shape[1] - shape[5]              # rows q < S - T see no key
    want = v.mean(dim=1, keepdim=True).expand(-1, blind, -1, -1)
    torch.testing.assert_close(got[:, :blind], want, atol=1e-5, rtol=1e-5)


def test_dispatch_launches_kernel_and_counts(cuda):
    q, k, v = _inputs((1, 32, 16, 128, 16, 32, True, 0), torch.float32, cuda)
    before = fa.flash_attention.launches
    ops.flash_attention(q, k, v, causal=True)
    assert fa.flash_attention.launches == before + 1


def test_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    q, k, v = _inputs((1, 32, 4, 64, 4, 32, True, 0), torch.float32, cuda)
    with pytest.raises(ValueError):
        fa.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError):
        fa.flash_attention(q.transpose(1, 2), k, v)
    with pytest.raises(ValueError):
        fa.flash_attention(q[..., :48].contiguous(), k[..., :48].contiguous(),
                           v[..., :48].contiguous())


def test_reduced_model_prefill_kernel_matches_einsum(cuda):
    from repro_torch.checkpoint import init_params
    from repro_torch.models import model as M
    from repro_torch.models.config import get_config
    cfg = get_config("olmo-1b", reduced=True)
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = init_params(cfg, gen, device=cuda)
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 16)), device=cuda)
    with torch.no_grad():
        lk, ck = M.prefill(params, {"tokens": toks}, cfg,
                           M.ModelOptions(use_kernels=True), 48)
        lp, cp = M.prefill(params, {"tokens": toks}, cfg,
                           M.ModelOptions(use_kernels=False), 48)
    torch.testing.assert_close(lk, lp, atol=1e-4, rtol=1e-4)

"""The CUDA kernels (flash attention, SSD chunked scan, RG-LRU scan) against
their plain PyTorch versions, on the GPU. Every test here needs a CUDA device of compute capability >= 9.0
(Hopper) and skips without one; this file imports no jax, so it runs on a
machine that has only PyTorch and the CUDA toolkit:

    python -m pytest -q tests/test_torch_cuda_kernels.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import rglru_scan as rg  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402

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
    (1, 32, 16, 256, 1, 32, True, 2048),   # recurrentgemma-9b prefill (MQA)
    (1, 300, 16, 256, 1, 300, True, 128),  # hd 256, ragged, the window bites
    (2, 40, 4, 256, 1, 100, True, 48),     # hd 256, T > S with a window
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
    assert fa.smem_bytes(256) == 73_856 <= fa.MAX_SMEM_BYTES


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


# ---------------- SSD chunked scan ----------------

SSD_SHAPES = [
    # b, s, h, p, g, n, chunk, dt range
    (2, 128, 4, 32, 1, 32, 32, (0.001, 0.1)),      # test_kernels.py grid
    (1, 256, 2, 64, 1, 64, 64, (0.001, 0.1)),
    (1, 64, 4, 16, 2, 16, 16, (0.001, 0.1)),       # 2 B/C groups
    (1, 256, 8, 64, 1, 128, 128, (0.001, 0.1)),    # production-like state
    (1, 128, 80, 64, 1, 128, 128, (0.001, 0.1)),   # mamba2-2.7b serving
    (2, 512, 80, 64, 1, 128, 128, (0.001, 0.1)),   # carries the state
    (2, 300, 8, 64, 2, 128, 128, (0.001, 0.1)),    # ragged last chunk
    (1, 256, 8, 64, 1, 128, 128, (0.5, 2.0)),      # large dt
]


def _ssd_inputs(shape, dtype, device, seed=0):
    b, s, h, p, g, n, _, (lo, hi) = shape
    rng = np.random.default_rng(seed)
    mk = lambda a, dt=dtype: torch.as_tensor(a, dtype=torch.float32).to(
        device=device, dtype=dt)
    return (mk(rng.standard_normal((b, s, h, p))),
            mk(rng.uniform(lo, hi, (b, s, h)), torch.float32),
            mk(-rng.uniform(0.5, 2.0, (h,)), torch.float32),
            mk(rng.standard_normal((b, s, g, n))),
            mk(rng.standard_normal((b, s, g, n))))


def _ssd_plain(x, dt, A, B, C, chunk):
    """The plain version; a ragged s is zero-padded to a chunk multiple, as
    ``ssd_forward`` pads, and the padding's rows are dropped."""
    s = x.shape[1]
    pad = (-s) % chunk
    padf = lambda a: torch.nn.functional.pad(
        a, (0, 0) * (a.dim() - 2) + (0, pad))
    return ref.ssd_scan_ref(padf(x), padf(dt), A, padf(B), padf(C),
                            chunk)[:, :s]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SSD_SHAPES)
def test_ssd_kernel_matches_plain_version(cuda, shape, dtype):
    x, dt, A, B, C = _ssd_inputs(shape, dtype, cuda)
    got = ssd.ssd_scan(x, dt, A, B, C, shape[6])
    want = _ssd_plain(x, dt, A, B, C, shape[6])
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == x.shape
    assert bool(got.isfinite().all())
    tol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


def test_ssd_dispatch_launches_kernel_and_counts(cuda):
    args = _ssd_inputs(SSD_SHAPES[4], torch.float32, cuda)
    before = ssd.ssd_scan.launches
    ops.ssd_scan(*args, 128)
    assert ssd.ssd_scan.launches == before + 1


def test_ssd_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    x, dt, A, B, C = _ssd_inputs(SSD_SHAPES[0], torch.float32, cuda)
    bad = [
        (x.half(), dt, A, B.half(), C.half(), 32),            # dtype
        (x, dt.double(), A, B, C, 32),                        # dt not fp32
        (x.transpose(1, 2), dt, A, B, C, 32),                 # layout
        (x[..., :24].contiguous(), dt, A, B, C, 32),          # head dim 24
        (x, dt, A, B[..., :30].contiguous(), C[..., :30].contiguous(), 32),
        (x, dt, A[:3], B, C, 32),                             # A's shape
        (x, dt, A, B, C, 30),                                 # chunk % 4
        (x, dt, A, B, C, 4096),                               # shared memory
        (x, dt.cpu(), A, B, C, 32),                           # device
    ]
    before = ssd.ssd_scan.launches
    for args in bad:
        with pytest.raises(ValueError):
            ssd.ssd_scan(*args)
    assert ssd.ssd_scan.launches == before


def test_reduced_mamba2_prefill_kernel_matches_plain(cuda):
    from repro_torch.checkpoint import init_params
    from repro_torch.models import model as M
    from repro_torch.models.config import get_config
    cfg = get_config("mamba2-2.7b", reduced=True)
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                         device=cuda)
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 40)), device=cuda)
    before = ssd.ssd_scan.launches
    with torch.no_grad():
        lk, ck = M.prefill(params, {"tokens": toks}, cfg,
                           M.ModelOptions(use_kernels=True), 48)
        lp, cp = M.prefill(params, {"tokens": toks}, cfg,
                           M.ModelOptions(use_kernels=False), 48)
    assert ssd.ssd_scan.launches == before + cfg.num_layers
    torch.testing.assert_close(lk, lp, atol=1e-4, rtol=1e-4)


def test_reduced_recurrentgemma_prefill_kernels_match_plain(cuda):
    from repro_torch.checkpoint import init_params
    from repro_torch.models import model as M
    from repro_torch.models.config import get_config
    cfg = get_config("recurrentgemma-9b", reduced=True)
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                         device=cuda)
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 96)), device=cuda)        # past the window
    before = (rg.rglru_scan.launches, fa.flash_attention.launches)
    with torch.no_grad():
        lk, ck = M.prefill(params, {"tokens": toks}, cfg,
                           M.ModelOptions(use_kernels=True), 128)
        lp, cp = M.prefill(params, {"tokens": toks}, cfg,
                           M.ModelOptions(use_kernels=False), 128)
    assert (rg.rglru_scan.launches, fa.flash_attention.launches) == (
        before[0] + 2, before[1] + 1)
    torch.testing.assert_close(lk, lp, atol=1e-4, rtol=1e-4)
    for got, want in zip(ck, cp):
        for name in got:
            torch.testing.assert_close(got[name], want[name], atol=1e-4,
                                       rtol=1e-4)


# ---------------- RG-LRU scan ----------------

RGLRU_SHAPES = [
    # B, S, W, a range
    (2, 128, 512, (0.7, 0.999)),           # test_kernels.py grid
    (1, 256, 256, (0.7, 0.999)),
    (3, 64, 128, (0.7, 0.999)),
    (1, 512, 1024, (0.7, 0.999)),
    (1, 32, 4096, (0.7, 0.999)),           # recurrentgemma-9b serving
    (2, 37, 300, (0.7, 0.999)),            # ragged
    (1, 2048, 4096, (0.99, 0.9999)),       # long, slow decay: h ~ 100·|b|
]


def _rg_inputs(shape, device, seed=0):
    B, S, W, (lo, hi) = shape
    rng = np.random.default_rng(seed)
    mk = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    return mk(rng.uniform(lo, hi, (B, S, W))), mk(rng.standard_normal(
        (B, S, W)))


@pytest.mark.parametrize("shape", RGLRU_SHAPES)
def test_rglru_kernel_matches_plain_version(cuda, shape):
    a, b = _rg_inputs(shape, cuda)
    got = rg.rglru_scan(a, b)
    want = ref.rglru_scan_ref(a, b)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == a.shape
    assert bool(got.isfinite().all())
    tol = TOL[torch.float32]
    torch.testing.assert_close(got, want, atol=tol, rtol=tol)


def test_rglru_dispatch_launches_kernel_and_counts(cuda):
    a, b = _rg_inputs(RGLRU_SHAPES[4], cuda)
    before = rg.rglru_scan.launches
    ops.rglru_scan(a, b)
    assert rg.rglru_scan.launches == before + 1


def test_rglru_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    a, b = _rg_inputs(RGLRU_SHAPES[2], cuda)
    bad = [
        (a.bfloat16(), b.bfloat16()),                       # dtype
        (a.transpose(1, 2), b.transpose(1, 2)),             # layout
        (a, b[:, :10].contiguous()),                        # shapes disagree
        (a[0], b[0]),                                       # not 3-d
        (a, b.cpu()),                                       # device
        (a.cpu(), b.cpu()),                                 # CPU
    ]
    before = rg.rglru_scan.launches
    for args in bad:
        with pytest.raises(ValueError):
            rg.rglru_scan(*args)
    assert rg.rglru_scan.launches == before

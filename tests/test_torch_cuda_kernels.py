"""The CUDA kernels (flash attention and its backward, SSD chunked scan,
RG-LRU scan) against their plain PyTorch versions, on the GPU, the MoE
layer's determinism there, and the refusal of the kernels that have no
backward under grad. Every test here needs a CUDA device of compute capability >= 9.0
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
    (1, 1024, 16, 128, 16, 1024, True, 0),   # many KV tiles: causal skipping
    (1, 1024, 16, 256, 1, 1024, True, 256),  # many KV tiles: window skipping
    (2, 200, 8, 64, 2, 333, False, 0),     # many tiles, ragged, encoder
    (1, 32, 32, 128, 4, 32, True, 0),      # yi-9b prefill: 8-way GQA
    (1, 32, 48, 128, 8, 32, True, 0),      # nemotron-4-15b prefill
    (1, 288, 14, 64, 2, 288, True, 0),     # internvl2-1b: 256 patches + 32
    (1, 500, 16, 80, 16, 500, False, 0),   # hubert-xlarge: hd 80, encoder,
                                           # ragged last KV tile (20 keys)
    (1, 128, 2, 80, 2, 128, False, 0),     # hd 80, encoder, whole tiles
    (1, 300, 16, 80, 4, 300, True, 0),     # hd 80, ragged causal GQA
    (2, 37, 4, 80, 2, 90, True, 24),       # hd 80, T > S with a window
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


@pytest.mark.parametrize("shape", [
    (8, 256, 16, 128, 16, 256, True, 0),   # olmo-1b training: 64-row items
    (1, 288, 14, 64, 2, 288, True, 0),     # internvl2-1b: 32-row items
    (1, 500, 16, 80, 16, 500, False, 0),   # hubert-xlarge
    (2, 160, 16, 64, 4, 100, True, 0),     # T < S: blind rows, 2 KV tiles
    (1, 300, 32, 128, 4, 300, True, 128),  # yi-9b's windowed prompt
])
def test_long_query_design_with_lse_matches_plain_version(cuda, shape):
    """The fp32 long-query design (``fa.design``: f32_rows) and its
    log-sum-exp against the plain version, and the shared memory of its
    block against the wrapper's mirror."""
    B, S, H, hd, K, T, causal, window = shape
    assert fa.design(B, S, H, torch.float32) == "f32_rows"
    q, k, v = _inputs(shape, torch.float32, cuda, seed=2)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=cuda)
    got = fa.flash_attention(q, k, v, causal=causal, window=window, lse=lse)
    want, want_lse = ref.flash_attention_fwd_ref(q, k, v, causal=causal,
                                                 window=window)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-4)
    assert fa.built_smem_bytes(hd, B, S, H, torch.float32) == \
        fa.smem_bytes_rows(hd, fa.rows_per_item(B, S, H))


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
    assert fa.smem_bytes(256) == 140_416 <= fa.MAX_SMEM_BYTES
    assert fa.smem_bytes(256, torch.bfloat16) == 101_376


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


def test_reduced_hubert_at_head_dim_80_kernel_matches_plain(cuda):
    """The encoder's forward_hidden (non-causal, sinusoidal positions) at
    head_dim 80 with the kernel against the plain path."""
    import dataclasses
    from repro_torch.checkpoint import init_params
    from repro_torch.data.pipeline import InputShape, make_batch
    from repro_torch.models import model as M
    from repro_torch.models.config import get_config
    cfg = dataclasses.replace(get_config("hubert-xlarge", reduced=True),
                              num_heads=2, num_kv_heads=2, head_dim=80)
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                         device=cuda)
    batch = make_batch(cfg, InputShape("t", 100, 2, "prefill"), seed=1,
                       device=cuda)
    before = fa.flash_attention.launches
    with torch.no_grad():
        hk, _ = M.forward_hidden(params, batch, cfg,
                                 M.ModelOptions(use_kernels=True))
        hp, _ = M.forward_hidden(params, batch, cfg,
                                 M.ModelOptions(use_kernels=False))
    assert fa.flash_attention.launches == before + cfg.num_layers
    torch.testing.assert_close(hk, hp, atol=1e-4, rtol=1e-4)


# the MoE models' prefill shapes, the first time flash runs in bf16 on a
# served path: qwen3-moe-30b-a3b (8-way GQA) and moonshot-v1-16b-a3b (MHA)
MOE_PREFILL_SHAPES = [(1, 32, 32, 128, 4, 32, True, 0),
                      (1, 32, 16, 128, 16, 32, True, 0)]


@pytest.mark.parametrize("shape", MOE_PREFILL_SHAPES,
                         ids=["qwen3-moe", "moonshot"])
def test_bf16_flash_at_moe_prefill_shapes(cuda, shape):
    q, k, v = _inputs(shape, torch.bfloat16, cuda, seed=3)
    got = fa.flash_attention(q, k, v, causal=True)
    want = ref.flash_attention_ref(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2e-2)


def test_moe_is_deterministic_on_the_card(cuda):
    """qwen3-moe's routing (128 experts, top 8) at a narrow width: two bf16
    runs on the card are bit-equal (the dispatch writes each slot once,
    the combine sums over K without atomics), and fp32 on the card agrees
    with fp32 on the CPU."""
    import dataclasses
    from repro_torch.models import moe
    from repro_torch.models.config import get_config
    cfg = dataclasses.replace(get_config("qwen3-moe-30b-a3b"), d_model=256,
                              moe_d_ff=128)
    rng = np.random.default_rng(0)
    shapes = {"router": (256, 128), "w1": (128, 256, 128),
              "w3": (128, 256, 128), "w2": (128, 128, 256)}
    params = {k: torch.as_tensor(rng.standard_normal(s) / np.sqrt(s[-2]),
                                 dtype=torch.float32)
              for k, s in shapes.items()}
    x = torch.as_tensor(rng.standard_normal((8, 32, 256)),
                        dtype=torch.float32)
    on_card = {k: v.to(cuda) for k, v in params.items()}
    want, want_aux = moe.apply_moe(params, x, cfg)
    got, aux = moe.apply_moe(on_card, x.to(cuda), cfg)
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(aux.cpu(), want_aux, atol=1e-6, rtol=1e-6)
    bf16 = {k: v.bfloat16() for k, v in on_card.items()}
    xb = x.to(cuda, torch.bfloat16)
    runs = [moe.apply_moe(bf16, xb, cfg)[0] for _ in range(3)]
    assert all(torch.equal(runs[0], r) for r in runs[1:])


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
    (1, 2048, 16, 64, 2, 128, 128, (0.001, 0.1)),  # 16 chunks, 2 groups
    (1, 100, 4, 32, 2, 36, 32, (0.001, 0.1)),      # n % 8 = 4: 8-byte copies
    (1, 50, 4, 32, 2, 16, 20, (0.001, 0.1)),       # chunk 20: 16-row tiles
]                                                  # do not divide it; 20, 20, 10


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
    # a multi-chunk call launches four kernels and counts once
    ops.ssd_scan(*_ssd_inputs(SSD_SHAPES[5], torch.float32, cuda), 128)
    assert ssd.ssd_scan.launches == before + 2


@pytest.mark.parametrize("p,n,chunk", [(16, 16, 16), (32, 36, 32),
                                       (64, 128, 128), (128, 128, 128),
                                       (64, 128, 256)])
def test_ssd_smem_sizing_agrees_with_the_kernels(cuda, p, n, chunk):
    """The wrapper's refusal rests on its own copy of the kernels' shared
    memory layout; the C library reports the same bytes."""
    lib = ssd._library()
    for esize in (4, 2):
        for chunks in (1, 3):
            assert lib.ssd_scan_smem_bytes(p, n, chunk, esize, chunks) == \
                ssd.smem_bytes(p, n, chunk, esize, chunks)


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
    counters = (rg.rglru_gated_scan, rg.rglru_scan, fa.flash_attention)
    before = [fn.launches for fn in counters]
    with torch.no_grad():
        lk, ck = M.prefill(params, {"tokens": toks}, cfg,
                           M.ModelOptions(use_kernels=True), 128)
        lp, cp = M.prefill(params, {"tokens": toks}, cfg,
                           M.ModelOptions(use_kernels=False), 128)
    # one fused RG-LRU launch per recurrent layer (2), one flash launch per
    # local-attention layer (1); the scan-only kernel is not on this path
    assert [fn.launches - n for fn, n in zip(counters, before)] == [2, 0, 1]
    torch.testing.assert_close(lk, lp, atol=1e-4, rtol=1e-4)
    for got, want in zip(ck, cp):
        for name in got:
            torch.testing.assert_close(got[name], want[name], atol=1e-4,
                                       rtol=1e-4)

    # decode steps: one fused launch per recurrent layer and step, the
    # state updated in place in the cache's own buffer
    tok = lk.argmax(-1)
    states = [c["h"] for c in ck if "h" in c]
    before = rg.rglru_gated_scan.launches
    with torch.no_grad():
        for i in range(3):
            pos = 96 + i
            lk, ck = M.decode_step(params, tok, pos, ck, cfg,
                                   M.ModelOptions(use_kernels=True))
            lp, cp = M.decode_step(params, tok, pos, cp, cfg,
                                   M.ModelOptions(use_kernels=False))
            torch.testing.assert_close(lk, lp, atol=1e-4, rtol=1e-4)
            tok = lk.argmax(-1)
    assert rg.rglru_gated_scan.launches == before + 2 * 3
    assert all(c["h"] is h for c, h in zip([c for c in ck if "h" in c],
                                           states))
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


# ---------------- RG-LRU, the fused gates-and-scan form ----------------

GATED_SHAPES = [
    # B, S, W, with h0
    (1, 32, 4096, False),                  # recurrentgemma-9b prefill
    (8, 1, 4096, True),                    # decode of 8 slots
    (2, 37, 300, False),                   # ragged
    (1, 2048, 4096, False),                # long
    (3, 100, 302, True),                   # 8-step chunks, W % 4 = 2
    (1, 5, 7, True),                       # odd W: one channel a thread
]


def _gated_inputs(shape, dtype, device, seed=0):
    """r_pre, i_pre, xc, gate_pre ~ N(0, 1) in ``dtype``, lam as
    ``init_rglru`` draws it, h0 ~ N(0, 1) fp32 (or None)."""
    B, S, W, with_h0 = shape
    rng = np.random.default_rng(seed)
    mk = lambda *s: torch.as_tensor(rng.standard_normal(s), dtype=torch.float32
                                    ).to(device=device, dtype=dtype)
    u = rng.uniform(0.9 ** 2, 0.999 ** 2, W)
    lam = torch.as_tensor(np.log(np.expm1(-np.log(u) / 16)),
                          dtype=torch.float32, device=device)
    h0 = mk(B, W).float() if with_h0 else None
    return mk(B, S, W), mk(B, S, W), mk(B, S, W), mk(B, S, W), lam, h0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", GATED_SHAPES)
def test_rglru_gated_kernel_matches_plain_version(cuda, shape, dtype):
    *ins, lam, h0 = _gated_inputs(shape, dtype, cuda)
    y, h = rg.rglru_gated_scan(*ins, lam, h0)
    want_y, want_h = ref.rglru_gated_scan_ref(*ins, lam, h0)
    torch.cuda.synchronize()
    assert y.dtype == dtype and y.shape == ins[2].shape
    assert h.dtype == torch.float32 and h.shape == (shape[0], shape[2])
    assert bool(y.isfinite().all()) and bool(h.isfinite().all())
    tol = TOL[dtype]
    torch.testing.assert_close(y.float(), want_y.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(h, want_h, atol=TOL[torch.float32],
                               rtol=TOL[torch.float32])


def test_rglru_gated_kernel_updates_state_in_place(cuda):
    *ins, lam, h0 = _gated_inputs((8, 1, 4096, True), torch.float32, cuda,
                                  seed=3)
    want_y, want_h = ref.rglru_gated_scan_ref(*ins, lam, h0.clone())
    ptr = h0.data_ptr()
    before = rg.rglru_gated_scan.launches
    y, h = ops.rglru_gated_scan(*ins, lam, h0=h0, state_out=h0)
    torch.cuda.synchronize()
    assert h is h0 and h0.data_ptr() == ptr
    assert rg.rglru_gated_scan.launches == before + 1
    torch.testing.assert_close(y, want_y, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(h0, want_h, atol=1e-4, rtol=1e-4)


def test_rglru_gated_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    *ins, lam, h0 = _gated_inputs((2, 5, 64, True), torch.float32, cuda)
    r, i, xc, g = ins
    bad = [
        ((r.half(), i.half(), xc.half(), g.half(), lam), {}),     # dtype
        ((r, i, xc, g.bfloat16(), lam), {}),                      # mixed
        ((r.transpose(1, 2), i, xc, g, lam), {}),                 # layout
        ((r, i, xc, g[:, :3].contiguous(), lam), {}),             # shapes
        ((r, i, xc, g, lam.bfloat16()), {}),                      # lam
        ((r, i, xc, g, lam), {"h0": h0[:1].contiguous()}),        # h0 shape
        ((r, i, xc, g, lam), {"h0": h0.cpu()}),                   # device
        ((r.cpu(), i.cpu(), xc.cpu(), g.cpu(), lam.cpu()), {}),   # CPU
    ]
    before = rg.rglru_gated_scan.launches
    for args, kw in bad:
        with pytest.raises(ValueError):
            rg.rglru_gated_scan(*args, **kw)
    assert rg.rglru_gated_scan.launches == before


BWD_SHAPES = [
    # B, S, H, hd, K, causal, window
    (8, 256, 16, 128, 16, True, 0),    # olmo-1b's training shape
    (2, 256, 32, 128, 4, True, 0),     # yi-9b: 8-way GQA
    (1, 512, 4, 256, 1, True, 128),    # hd 256 MQA, the window bites
    (1, 500, 4, 80, 4, False, 0),      # hd 80 encoder, ragged last tile
    (2, 37, 4, 32, 2, True, 0),        # ragged causal at hd 32
    (2, 100, 4, 64, 2, True, 24),      # window smaller than a tile
]


def _bwd_inputs(shape, dtype, device, seed=0):
    B, S, H, hd, K, _, _ = shape
    rng = np.random.default_rng(seed)
    mk = lambda *s: torch.as_tensor(rng.standard_normal(s), dtype=torch.float32
                                    ).to(device=device, dtype=dtype)
    return mk(B, S, H, hd), mk(B, S, K, hd), mk(B, S, K, hd), mk(B, S, H, hd)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", BWD_SHAPES)
def test_flash_backward_kernel_matches_plain_version(cuda, shape, dtype):
    """The forward's lse and the backward's dq, dk, dv against the plain
    versions on the same inputs, and two backward runs bit-equal. bf16:
    both sides compute in fp32 from the same bf16 inputs and round once."""
    q, k, v, do = _bwd_inputs(shape, dtype, cuda)
    causal, window = shape[5], shape[6]
    B, S, H = q.shape[:3]
    lse = torch.empty((B, H, S), dtype=torch.float32, device=cuda)
    o = fa.flash_attention(q, k, v, causal=causal, window=window, lse=lse)
    _, lse_ref = ref.flash_attention_fwd_ref(q, k, v, causal=causal,
                                             window=window)
    torch.testing.assert_close(lse, lse_ref, atol=1e-4, rtol=1e-4)
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                 window=window)
    want = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, causal=causal,
                                       window=window)
    again = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                   window=window)
    torch.cuda.synchronize()
    tol = TOL[dtype]
    for g, w, a in zip(got, want, again):
        assert g.dtype == dtype and g.shape == w.shape
        assert bool(g.isfinite().all())
        torch.testing.assert_close(g.float(), w.float(), atol=tol, rtol=tol)
        assert torch.equal(g, a)


def test_flash_autograd_launches_both_kernels(cuda):
    """``ops.flash_attention`` under grad goes through the Function: one
    forward launch (with lse) and one backward launch, and its gradients
    are the plain versions'."""
    q, k, v, do = _bwd_inputs((2, 64, 4, 64, 2, True, 0), torch.float32,
                              cuda)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    fwd, bwd = fa.flash_attention.launches, fa.flash_attention_bwd.launches
    out = ops.flash_attention(*leaves, causal=True)
    grads = torch.autograd.grad(out, leaves, do)
    assert fa.flash_attention.launches == fwd + 1
    assert fa.flash_attention_bwd.launches == bwd + 1
    o, lse = ref.flash_attention_fwd_ref(q, k, v, causal=True)
    want = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, causal=True)
    for g, w in zip(grads, want):
        torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4)
    with torch.no_grad():                 # the serving path: forward only
        ops.flash_attention(*leaves, causal=True)
    assert fa.flash_attention_bwd.launches == bwd + 1


def test_flash_backward_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    q, k, v, do = _bwd_inputs((1, 64, 4, 64, 2, True, 0), torch.float32,
                              cuda)
    lse = torch.empty((1, 4, 64), dtype=torch.float32, device=cuda)
    o = fa.flash_attention(q, k, v, lse=lse)
    before = fa.flash_attention_bwd.launches
    bad = [
        (q[:, :32].contiguous(), k, v, o[:, :32].contiguous(), lse,
         do[:, :32].contiguous()),                          # T != S
        (q, k, v, o, lse[:, :2].contiguous(), do),          # lse shape
        (q, k, v, o, lse.double(), do),                     # lse dtype
        (q, k, v, o.bfloat16(), lse, do),                   # o dtype
        (q, k, v, o, lse, do.transpose(1, 2)),              # dO layout
        (q.cpu(), k.cpu(), v.cpu(), o.cpu(), lse.cpu(), do.cpu()),  # CPU
    ]
    for args in bad:
        with pytest.raises(ValueError):
            fa.flash_attention_bwd(*args)
    assert fa.flash_attention_bwd.launches == before


def test_kernels_without_backward_refuse_grad(cuda):
    """The SSD and RG-LRU kernels have no backward kernel: under grad their
    dispatch raises on CUDA inputs that require grad (and still runs under
    no_grad or when nothing requires grad)."""
    x, dt, A, Bm, Cm = _ssd_inputs(SSD_SHAPES[0], torch.float32, cuda)
    a, b = _rg_inputs(RGLRU_SHAPES[2], cuda)
    *gated, lam, _ = _gated_inputs((2, 5, 64, False), torch.float32, cuda)
    calls = [
        (ops.ssd_scan, (x, dt, A, Bm, Cm, 32)),
        (ops.rglru_scan, (a, b)),
        (ops.rglru_gated_scan, (*gated, lam)),
    ]
    for fn, args in calls:
        fn(*args)                                  # nothing requires grad
        wanting = [t.requires_grad_() if i == 0 else t
                   for i, t in enumerate(args)]
        with pytest.raises(ValueError, match="use_kernels=False"):
            fn(*wanting)
        with torch.no_grad():
            fn(*wanting)

"""The split-TF32 dense product's CPU side (``kernels.dense_gemm``): the
route's rule and its counters, the work's schedule (whole tiles, then
stream-K), the plain version, and the kernel's arithmetic written out in
torch (``ref.dense_gemm_split_tf32``) against fp64, fp32 and a single TF32
pass. The kernel itself runs on the card:
``tests/test_torch_dense_gemm_cuda.py``."""

import numpy as np
import pytest
import torch

from repro_torch import checkpoint
from repro_torch.kernels import dense_gemm as dg
from repro_torch.kernels import ops, ref
from repro_torch.models import layers
from repro_torch.models.config import get_config
from repro_torch.serving import ContinuousBatchingEngine, Request

# (K, N) of the serving cells' prefill products (the router's last)
MAIN_PATH = [(2048, 2048), (2048, 8192), (8192, 2048), (2560, 10576),
             (5120, 2560), (4096, 16768), (8192, 4096), (4096, 4096),
             (4096, 1024), (4096, 1536), (1536, 4096), (4096, 72)]


class _OnCard:
    """A CPU tensor that reports a CUDA device, for the rule alone."""

    def __init__(self, t: torch.Tensor):
        self.t = t
        self.device = torch.device("cuda", 0)
        self.dtype, self.shape, self.requires_grad = (t.dtype, t.shape,
                                                      t.requires_grad)

    def dim(self):
        return self.t.dim()

    def numel(self):
        return self.t.numel()

    def is_contiguous(self):
        return self.t.is_contiguous()

    def data_ptr(self):
        return 0 if self.t.is_contiguous() else 4


def _counts():
    return dg.dense_gemm.flops_taken, dg.dense_gemm.flops_declined


@pytest.mark.parametrize("rows, K, N, dtype, grad, contiguous, taken", [
    (576, 2048, 2048, torch.float32, False, True, True),
    (dg.MIN_ROWS, 2048, 8192, torch.float32, False, True, True),
    (577, 2052, 1028, torch.float32, False, True, True),
    (16, 2048, 2048, torch.float32, False, True, False),      # decode
    (dg.MIN_ROWS - 1, 2048, 2048, torch.float32, False, True, False),
    (576, 2048, 2048, torch.float32, True, True, False),      # training
    (576, 2048, 2048, torch.bfloat16, False, True, False),    # bf16
    (576, 2048, 2048, torch.float32, False, False, False),    # w strided
    (576, 4096, 72, torch.float32, False, True, False),       # a router
    (576, 2046, 2048, torch.float32, False, True, False),     # K % 4
    (576, 2048, 2050, torch.float32, False, True, False),     # N % 4
])
def test_rule(rows, K, N, dtype, grad, contiguous, taken):
    """Which products the route sends to the kernel; an fp32 one of
    ``MIN_ROWS`` rows or more that it declines counts its FLOPs as
    declined, any other counts nothing."""
    x = torch.zeros(1, rows, K, dtype=dtype, requires_grad=grad)
    w = torch.zeros(N, K, dtype=dtype).t() if not contiguous else \
        torch.zeros(K, N, dtype=dtype)
    before = _counts()
    assert dg.takes(_OnCard(x), _OnCard(w)) == taken
    declined = not taken and dtype == torch.float32 and rows >= dg.MIN_ROWS
    assert _counts() == (before[0], before[1]
                         + (2 * rows * K * N if declined else 0))


def test_rule_leaves_cpu_products_alone():
    """On the CPU ``ops.matmul`` and ``layers.linear`` are ``x @ w`` bit for
    bit, and nothing is counted; the CUDA wrapper refuses CPU tensors."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 300, 64, generator=g)
    w = torch.randn(64, 256, generator=g)
    before = (dg.dense_gemm.launches, *_counts())
    assert not dg.takes(x, w)
    assert torch.equal(ops.matmul(x, w), x @ w)
    assert torch.equal(layers.linear(x, w), x @ w)
    assert torch.equal(ref.dense_gemm_ref(x, w), x @ w)
    assert (dg.dense_gemm.launches, *_counts()) == before
    with pytest.raises(ValueError):
        dg.dense_gemm(x, w)


@pytest.mark.parametrize("M,K,N,sms", [
    (576, K, N, 132) for K, N in MAIN_PATH if N >= dg.TILE_N] + [
    (577, 2052, 1028, 132), (192, 32, 128, 132), (1, 4, 4, 132),
    (1000, 132, 260, 132), (576, 2048, 2048, 7), (576, 2048, 2048, 5),
    (5000, 256, 4096, 132)])
def test_segments_cover_every_stage_once(M, K, N, sms):
    """Whole tiles first, each to one block in turn; then stream-K: every
    other (tile, stage) falls to exactly one block, a block's segments
    follow each other through the run, a tile's parts are its segments in
    block order, numbered 0..parts-1, only a block's first or last
    stream-K segment is a part of a split tile, and its slots hold one
    partial each; the last of ``plan`` means no tile is split; stream-K
    shares differ by at most one stage; no block has fewer than
    ``MIN_SHARE`` stages where there are enough."""
    blocks, whole, unsplit = dg.plan(M, N, K, sms)
    stages, n = -(-K // dg.TILE_K), dg.tiles(M, N)
    total = (n - whole) * stages
    assert 1 <= blocks <= sms and 0 <= whole <= n
    assert n * stages // blocks >= min(dg.MIN_SHARE, n * stages)
    if whole < n:
        assert n - whole < 2 * blocks
    segs = dg.segments(M, N, K, blocks, whole)
    seen, by_tile, run = set(), {}, 0
    for b, block in enumerate(segs):
        dp = [s for s in block if s[0] < whole]
        assert [s[0] for s in dp] == list(range(b, whole, blocks))
        assert all(s[1:] == (0, stages, 0, 1, 0) for s in dp)
        sk = block[len(dp):]
        share = sum(s[2] for s in sk)
        assert total // blocks <= share <= -(-total // blocks)
        slots = [s[5] for s in sk if s[4] > 1]
        assert len(slots) == len(set(slots))
        for s in dp:
            seen.update((s[0], k) for k in range(stages))
        for j, (tile, kb0, nk, part, parts, slot) in enumerate(sk):
            assert (tile - whole) * stages + kb0 == run
            run += nk
            assert slot == (0 if j == 0 else 1)
            if parts > 1:
                assert j in (0, len(sk) - 1)
            for k in range(kb0, kb0 + nk):
                assert (tile, k) not in seen
                seen.add((tile, k))
            by_tile.setdefault(tile, []).append((b, part, parts))
    assert len(seen) == n * stages and run == total
    for tile, parts in by_tile.items():
        assert [p[1] for p in parts] == list(range(len(parts)))
        assert all(p[2] == len(parts) for p in parts)
        assert [p[0] for p in parts] == list(range(parts[0][0],
                                                   parts[0][0] + len(parts)))
    if unsplit:
        assert all(len(p) == 1 for p in by_tile.values())


def _tile_ranges(M, K, N, tile):
    """[k0, k1) of each part of ``tile`` at the plan's blocks on 132 SMs."""
    blocks, whole, _ = dg.plan(M, N, K, 132)
    out = []
    for block in dg.segments(M, N, K, blocks, whole):
        for t, kb0, nk, *_ in block:
            if t == tile:
                out.append((kb0 * dg.TILE_K, min(K, (kb0 + nk) * dg.TILE_K)))
    return out


def test_tf32_roundings():
    """rna: 10 mantissa bits, to nearest, ties away from zero, signs kept;
    trunc: the low 13 bits dropped."""
    one = 1.0
    ulp = 2.0 ** -10
    v = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 2 * 0.99,
                      one + ulp * 1.5, 3.0, 0.0], dtype=torch.float32)
    want = torch.tensor([one + ulp, -(one + ulp), one, one + 2 * ulp, 3.0,
                         0.0])
    assert torch.equal(ref.tf32_rna(v), want)
    assert torch.equal(ref.tf32_trunc(v),
                       torch.tensor([one, -one, one, one + ulp, 3.0, 0.0]))
    x = torch.randn(10000, generator=torch.Generator().manual_seed(1))
    for hi in (ref.tf32_rna(x), ref.tf32_trunc(x)):
        assert torch.all(hi.view(torch.int32) & 0x1FFF == 0)
        lo = ref.tf32_rna(x - hi)
        miss = (x.double() - hi.double() - lo.double()).abs()
        assert torch.all(miss <= 2.0 ** -21 * x.double().abs())


@pytest.mark.parametrize("M,K,N", [(64, 2048, 64), (96, 4096, 48),
                                   (40, 8192, 32), (33, 100, 20)])
def test_split_tf32_arithmetic_is_fp32s(M, K, N):
    """The kernel's arithmetic (K in the parts the plan gives the first
    tile at 576 rows) against fp64: its largest error is at most that of fp32 multiply-adds
    in sequence and twice that of ``x @ w`` in fp32, and a single TF32
    pass's is at least 100 times it. Inputs as a layer's: x ~ N(0, 1), w ~
    N(0, 0.02²)."""
    g = torch.Generator().manual_seed(M + K + N)
    x = torch.randn(M, K, generator=g, dtype=torch.float64).float()
    w = (torch.randn(K, N, generator=g, dtype=torch.float64) * 0.02).float()
    truth = x.double() @ w.double()
    err = lambda c: (c.double() - truth).abs().max().item()
    ranges = _tile_ranges(576, K, max(N, dg.TILE_N), 0)
    split = err(ref.dense_gemm_split_tf32(x, w, ranges))
    seq = torch.zeros(M, N)
    for k in range(K):
        seq = torch.addcmul(seq, x[:, k:k + 1], w[k:k + 1])
    one_pass = (ref.tf32_rna(x).double() @ ref.tf32_rna(w).double()).float()
    assert split <= err(seq)
    assert split <= 2 * err(x @ w)
    assert err(one_pass) >= 100 * split


def test_engine_reports_the_kernels_share_since_reset():
    """``dense_kernel_share``: 0 with no such products (the CPU), then the
    FLOPs taken over taken plus declined since ``reset_stats``."""
    cfg = get_config("olmo-1b", reduced=True)
    params = checkpoint.init_params(cfg, torch.Generator().manual_seed(0),
                                    device="cpu")
    eng = ContinuousBatchingEngine(cfg, params, max_slots=2, cache_len=48)
    eng.submit(Request("r", np.arange(8, dtype=np.int32), max_new_tokens=2))
    eng.drain()
    assert eng.report()["dense_kernel_share"] == 0.0
    dg.dense_gemm.flops_taken += 5
    eng.reset_stats()
    assert eng.report()["dense_kernel_share"] == 0.0
    dg.dense_gemm.flops_taken += 300
    dg.dense_gemm.flops_declined += 100
    assert eng.report()["dense_kernel_share"] == 0.75
    eng.reset_stats()
    assert eng.report()["dense_kernel_share"] == 0.0

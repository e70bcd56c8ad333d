"""The split-TF32 dense product (``csrc/dense_gemm.cu``) on the GPU: its
error against an fp64 product at every shape a served prefill multiplies,
set beside cuBLAS's fp32 sgemm and a single TF32 pass; ragged edges in M,
N and K; the route (``dense_gemm.takes`` through ``ops.matmul``): which
products keep ``x @ w``; the counters and the absence of a host
synchronise; and reduced olmo-1b, mamba2-2.7b and granite-4.0-h-small
engines, prefilled on the kernel and decoded, against the same engines on
cuBLAS. Every test here needs a CUDA device of compute capability >= 9.0
(Hopper) and skips without one; this file imports no jax:

    python -m pytest -q tests/test_torch_dense_gemm_cuda.py
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import checkpoint  # noqa: E402
from repro_torch.kernels import dense_gemm as dg  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models.config import get_config  # noqa: E402
from repro_torch.serving import ContinuousBatchingEngine, Request  # noqa: E402

# (K, N) of every dense product a served prefill runs: olmo-1b's q/k/v/o,
# SwiGLU up and down; mamba2-2.7b's in_proj and out_proj; granite-4.0-h-
# small's in_proj, out_proj, attention q/o and k/v, shared expert up and
# down, and router
MAIN_PATH = [(2048, 2048), (2048, 8192), (8192, 2048),
             (2560, 10576), (5120, 2560),
             (4096, 16768), (8192, 4096), (4096, 4096), (4096, 1024),
             (4096, 1536), (1536, 4096), (4096, 72)]
ROWS = [576, 577, dg.MIN_ROWS]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available() or \
            torch.cuda.get_device_capability() < (9, 0):
        pytest.skip("needs a CUDA GPU of compute capability >= 9.0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _operands(M, K, N, device, seed=0):
    """x ~ N(0, 1) and w ~ N(0, 0.02²), as a layer's input and weights,
    drawn in fp64 and rounded to fp32; the fp64 product of the rounded
    values is the truth."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(M, K, generator=g, dtype=torch.float64)
    w = torch.randn(K, N, generator=g, dtype=torch.float64) * 0.02
    x, w = x.float().to(device), w.float().to(device)
    return x, w, x.double() @ w.double()


def _err(got, truth):
    return (got.double() - truth).abs().max().item()


@pytest.mark.parametrize("M", ROWS)
@pytest.mark.parametrize("K,N", MAIN_PATH)
def test_error_is_fp32s_not_tf32s(cuda, M, K, N):
    """The kernel's largest error against fp64 is at most twice cuBLAS's
    fp32 sgemm's, and a single TF32 pass's is at least 100 times it."""
    x, w, truth = _operands(M, K, N, cuda)
    kernel = _err(dg.dense_gemm(x, w), truth)
    sgemm = _err(x @ w, truth)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32 = _err(x @ w, truth)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    assert kernel <= 2 * sgemm, (kernel, sgemm)
    assert tf32 >= 100 * kernel, (kernel, tf32)


# ragged in M, N and K against the tiles (192 rows, 128 columns, K by 32),
# tiles split between blocks or not, x with rows apart wider than K, x of
# three dims
RAGGED = [(1, 4, 4), (130, 100, 20), (200, 36, 136), (577, 2052, 1028),
          (1000, 132, 260), (191, 4096, 12), (193, 64, 2052)]


@pytest.mark.parametrize("M,K,N", RAGGED)
def test_ragged_edges(cuda, M, K, N):
    """Every row and column past a tile's edge is right, and none outside C
    is written; the error is within a few fp32 roundings of the largest
    output (the tensor cores sum each 32-deep slice, then fp32 adds)."""
    x, w, truth = _operands(M, K, N, cuda, seed=M + K + N)
    c = dg.dense_gemm(x, w)
    assert c.shape == (M, N)
    assert _err(c, truth) <= 2e-6 * truth.abs().max().item()
    wide = torch.full((M, K + 12), float("nan"), device=cuda)
    wide[:, :K] = x
    c2 = dg.dense_gemm(wide[:, :K], w)          # rows K + 12 apart
    assert torch.equal(c2, c)
    c3 = dg.dense_gemm(x.reshape(1, M, K), w)
    assert c3.shape == (1, M, N) and torch.equal(c3[0], c)


def test_k_split_sum_does_not_depend_on_arrival(cuda):
    """Where a tile's stages fall to several blocks, the last of them to
    finish adds the partials in block order: repeated calls give the same
    bits."""
    x, w, _ = _operands(576, 2048, 2048, cuda)
    assert not dg.plan(576, 2048, 2048, dg._sms(0))[2]
    first = dg.dense_gemm(x, w)
    for _ in range(5):
        assert torch.equal(dg.dense_gemm(x, w), first)


def test_route_keeps_x_at_w(cuda):
    """16 rows, a gradient, bf16, a non-contiguous w and a DTensor each keep
    ``x @ w`` (bit for bit, no launch); a prefill's product takes the
    kernel."""
    x, w, _ = _operands(576, 256, 512, cuda)
    before = dg.dense_gemm.launches
    kept = [(x[:16], w), (x.bfloat16(), w.bfloat16()),
            (x, w.t().contiguous().t())]
    for a, b in kept:
        assert not dg.takes(a, b)
        assert torch.equal(ops.matmul(a, b), a @ b)
    wg = w.clone().requires_grad_(True)
    out = ops.matmul(x, wg)
    assert out.requires_grad and torch.equal(out, x @ wg)
    with torch.no_grad():
        assert dg.takes(x, wg)                  # no gradient wanted
    assert dg.dense_gemm.launches == before

    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import Replicate, distribute_tensor
    from repro_torch.launch.dryrun import init_fake_world
    owned = not dist.is_initialized()
    init_fake_world(1)
    try:
        mesh = DeviceMesh("cuda", [0], mesh_dim_names=("data",))
        xd = distribute_tensor(x, mesh, [Replicate()])
        wd = distribute_tensor(w, mesh, [Replicate()])
        assert not dg.takes(xd, wd)
        out = layers.linear(xd, wd)
        assert torch.equal(out.to_local(), x @ w)
    finally:
        if owned:
            dist.destroy_process_group()
    assert dg.dense_gemm.launches == before
    assert torch.equal(layers.linear(x, w), dg.dense_gemm(x, w))
    assert dg.dense_gemm.launches == before + 2


def test_counters_and_no_host_sync(cuda):
    """``launches`` and ``flops_taken`` count each kernel call,
    ``flops_declined`` each fp32 CUDA product of ``MIN_ROWS`` rows or more
    that the route sent to cuBLAS; small products count in neither. No
    call synchronises with the host, tiles split between blocks or not."""
    x, w, _ = _operands(600, 2048, 2048, cuda)
    w_nc = w.t().contiguous().t()
    x2, w2 = x[:200, :2044], w[:2044, :1024].contiguous()
    for a, b in ((x, w), (x2, w2)):
        ops.matmul(a, b)                         # the first call's setup
    torch.cuda.synchronize()
    n0, t0, d0 = (dg.dense_gemm.launches, dg.dense_gemm.flops_taken,
                  dg.dense_gemm.flops_declined)
    torch.cuda.set_sync_debug_mode("error")
    try:
        ops.matmul(x, w)                         # tiles split
        ops.matmul(x2, w2)                       # x's rows 2048 apart
        ops.matmul(x, w_nc)                      # declined
        ops.matmul(x[:16], w)                    # too few rows
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert dg.dense_gemm.launches == n0 + 2
    assert dg.dense_gemm.flops_taken == t0 + 2 * 600 * 2048 * 2048 \
        + 2 * 200 * 2044 * 1024
    assert dg.dense_gemm.flops_declined == d0 + 2 * 600 * 2048 * 2048


def _engine_logits(cfg, params, prompts, max_new):
    """Each request's prefill logits and greedy tokens through a
    continuous-batching engine, the decode steps replayed from its graph."""
    eng = ContinuousBatchingEngine(cfg, params, max_slots=2,
                                   cache_len=prompts.shape[1] + max_new + 8)
    seen = []
    real = eng._admit

    def admit(req, slot, span):
        tokens = torch.as_tensor(req.tokens[None, :], dtype=torch.long,
                                 device=eng.device)
        from repro_torch.models import steps
        logits, _ = steps.prefill_step(params, {"tokens": tokens}, cfg,
                                       eng.opts, eng.cache_len)
        seen.append(logits[0])
        real(req, slot, span)
    eng._admit = admit
    for i, p in enumerate(prompts):
        eng.submit(Request(f"r{i}", p.astype(np.int32), max_new_tokens=max_new))
    done = eng.drain()
    outs = {r.request_id: r.output for r in done}
    return torch.stack(seen), [outs[f"r{i}"] for i in range(len(prompts))], \
        eng.report()


@pytest.mark.parametrize("arch", ["olmo-1b", "mamba2-2.7b",
                                  "granite-4.0-h-small"])
def test_reduced_engine_on_kernel_matches_cublas(cuda, arch, monkeypatch):
    """Reduced models prefilled (200-token prompts: the route takes their
    products) and decoded through the engine: the prefill logits on the
    kernel are within 1e-4 of the largest logit of those on cuBLAS (each
    product's error is ~1e-6 of its largest output, kernel or cuBLAS), the
    greedy tokens agree, and the engine reports the kernel's share of the
    FLOPs its route saw."""
    cfg = get_config(arch, reduced=True)
    if arch == "granite-4.0-h-small":
        # widths of 64, which the grouped expert kernels take
        cfg = dataclasses.replace(cfg, d_model=128, head_dim=32,
                                  moe_d_ff=64, experts_held=4)
    params = checkpoint.init_params(cfg, torch.Generator().manual_seed(0),
                                    device=cuda)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, (3, 200))
    before = dg.dense_gemm.launches
    t0, d0 = dg.dense_gemm.flops_taken, dg.dense_gemm.flops_declined
    lg_k, toks_k, rep_k = _engine_logits(cfg, params, prompts, 4)
    taken = dg.dense_gemm.flops_taken - t0
    declined = dg.dense_gemm.flops_declined - d0
    assert dg.dense_gemm.launches > before and taken > declined
    # the reduced widths leave some products narrower than a tile (N < 128)
    assert rep_k["dense_kernel_share"] == taken / (taken + declined)
    monkeypatch.setattr(dg, "MIN_ROWS", 10 ** 9)
    before = dg.dense_gemm.launches
    lg_c, toks_c, rep_c = _engine_logits(cfg, params, prompts, 4)
    assert dg.dense_gemm.launches == before
    assert rep_c["dense_kernel_share"] == 0.0
    err = (lg_k - lg_c).abs().max().item()
    assert err <= 1e-4 * lg_c.abs().max().item()
    for a, b in zip(toks_k, toks_c):
        np.testing.assert_array_equal(a, b)

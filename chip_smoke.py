#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one Hopper GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (non-zero exit, no ``ok`` line):

1. Require a CUDA device of compute capability >= 9.0; print the card's
   name and power limit as ``nvidia-smi`` reports them.
2. Build the CUDA kernels (flash attention, SSD chunked scan, RG-LRU scan)
   from ``src/repro_torch/kernels/csrc`` with nvcc, one compiler per
   source, all started together (cached under ``build/``), and print their
   reports.
3. Hold the flash kernel against its plain PyTorch version on seeded inputs:
   the reference's kernel test grid in fp32 and bf16, olmo-1b's and
   recurrentgemma-9b's prefill shapes (head_dim 128 MHA; head_dim 256 MQA
   with a window), ragged shapes (one at head_dim 256 where the window
   bites), T > S shapes with a window and a T < S shape (whose blind rows
   must be mean(v)). Time it, the plain version and
   ``scaled_dot_product_attention`` (a yardstick only; the port never calls
   it) at both serving paths' shapes.
4. Hold the SSD kernel against its plain version: the reference's kernel
   test grid (g = 2 and the production-like state among it), the serving
   shape (one 128-chunk, 80 heads), a multi-chunk multi-batch shape that
   carries the state, a large-dt shape whose upper triangle would overflow
   if it were not masked, and a ragged shape (against the plain version of
   the zero-padded inputs). Every output must be finite. Time the kernel
   and the plain version at the serving shape. No single PyTorch call
   computes SSD, so it has no library yardstick.
   Hold the RG-LRU kernel against its plain version: the reference's kernel
   test grid, the serving shape (1, 32, 4096), a ragged shape and a long
   (1, 2048, 4096) one with a ~ U(0.99, 0.9999), where h grows to ~100·|b|.
   Every output must be finite. Time the kernel and the plain version at
   the serving shape; no single PyTorch call computes the recurrence.
   Tolerances for every kernel: fp32 1e-4 (summation order differs on the
   card), bf16 2e-2 (both sides round once to bf16), each absolute plus
   relative to the plain value.
5. Full-width olmo-1b, mamba2-2.7b and recurrentgemma-9b in fp32, weights
   from a seeded generator on the card: prefill a 32-token prompt with and
   without the kernels, compare the logits (within 1e-3: fp32 logits of
   unit scale after 16, 64 or 38 layers whose sums run in another order on
   each path), and decode 8 greedy tokens from each; the tokens must match.
6. The main paths: ``serve(arch, reduced=False, ...)`` with the continuous-
   batching engine for each model in turn. Every kernel's launch count is
   set to 0 just before each run and read just after; each must equal (the
   served config's layers of the kernel's kind) x (prefills), so olmo-1b
   launches only the flash kernel, mamba2-2.7b only the SSD kernel, and
   recurrentgemma-9b the RG-LRU kernel in its 26 recurrent layers and the
   flash kernel in its 12 local-attention layers. The H100 fleet is planned
   again from each run's measured rates (every plan is validated).
7. Profile one drain of 8 requests on each model with ``torch.profiler``:
   wall time with and without tracing, the device's busy time and idle
   share, and device time by kernel (each port kernel's per call).
8. Print ``{"kernels": [...]}`` on one line, then the last line
   ``{"ok": true, "device": {...}}``.

TF32 is off throughout, so fp32 matrix products are full fp32.
"""
from __future__ import annotations

import concurrent.futures
import gc
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12       # H100 SXM datasheet
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}   # non-tensor fp32; bf16
FP32_TOL, BF16_TOL = 1e-4, 2e-2
LOGIT_TOL = 1e-3                # fp32 logits of unit scale after 16-64 layers
MAIN_SHAPE = (1, 32, 16, 128, 16, 32, True, 0)   # B, S, H, hd, K, T, causal, window
RG_FLASH_SHAPE = (1, 32, 16, 256, 1, 32, True, 2048)  # recurrentgemma-9b prefill
SHAPES = [
    (2, 128, 4, 64, 2, 128, True, 0),      # tests/test_kernels.py grid
    (1, 256, 4, 64, 1, 256, True, 64),
    (2, 128, 4, 64, 4, 256, True, 0),
    (1, 128, 2, 32, 2, 128, False, 0),
    (1, 512, 8, 128, 2, 512, True, 128),
    MAIN_SHAPE,                            # olmo-1b prefill of 32 tokens
    (2, 100, 4, 64, 2, 100, True, 0),      # ragged
    (1, 37, 8, 128, 2, 90, True, 24),      # ragged, T > S, window
    (1, 64, 4, 64, 4, 48, True, 0),        # T < S: 16 rows see no key
    RG_FLASH_SHAPE,                        # hd 256, MQA, window 2048
    (1, 300, 16, 256, 1, 300, True, 128),  # hd 256, ragged, the window bites
    (2, 40, 4, 256, 1, 100, True, 48),     # hd 256, T > S with a window
]
# b, s, h, p, g, n, chunk
SSD_MAIN_SHAPE = (1, 128, 80, 64, 1, 128, 128)   # mamba2-2.7b prefill, padded
SSD_SHAPES = [
    (2, 128, 4, 32, 1, 32, 32),            # tests/test_kernels.py grid
    (1, 256, 2, 64, 1, 64, 64),
    (1, 64, 4, 16, 2, 16, 16),             # 2 B/C groups
    (1, 256, 8, 64, 1, 128, 128),          # production-like state size
    SSD_MAIN_SHAPE,
    (2, 512, 80, 64, 1, 128, 128),         # 4 chunks x 2 rows: carries state
    (2, 300, 8, 64, 2, 128, 128),          # ragged: chunks of 128, 128, 44
]
SSD_LARGE_DT = (1, 256, 8, 64, 1, 128, 128)      # dt ~ U(0.5, 2)
# B, S, W, a range
RGLRU_MAIN_SHAPE = (1, 32, 4096, (0.7, 0.999))   # recurrentgemma-9b prefill
RGLRU_SHAPES = [
    (2, 128, 512, (0.7, 0.999)),           # tests/test_kernels.py grid
    (1, 256, 256, (0.7, 0.999)),
    (3, 64, 128, (0.7, 0.999)),
    (1, 512, 1024, (0.7, 0.999)),
    RGLRU_MAIN_SHAPE,
    (2, 37, 300, (0.7, 0.999)),            # ragged
    (1, 2048, 4096, (0.99, 0.9999)),       # long, slow decay: h ~ 100·|b|
]
# the mixers whose layers launch each kernel once per prefill
KERNEL_MIXERS = {"flash_attention": ("attn", "attn_window"),
                 "ssd_scan": ("ssd",), "rglru_scan": ("rglru",)}
# each served model and the kernels its main path runs
SERVED = {"olmo-1b": ["flash_attention"], "mamba2-2.7b": ["ssd_scan"],
          "recurrentgemma-9b": ["rglru_scan", "flash_attention"]}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(torch, fn, iters: int = 200, warmup: int = 20) -> float:
    """Mean device time of one call, by CUDA events over ``iters`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _bound(nbytes: float, flops: float, dtype_name: str) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def attention_bound_ms(shape, dtype_name: str) -> tuple[float, str]:
    """Least time for one attention call: each input read once and the
    output written once at the HBM rate, against the multiply-adds of the
    visible (query, key) pairs of these inputs at the dtype's peak rate."""
    B, S, H, hd, K, T, causal, window = shape
    esize = 4 if dtype_name == "float32" else 2
    nbytes = esize * (2 * B * S * H * hd + 2 * B * T * K * hd)
    q_pos = np.arange(S)[:, None] + (T - S)
    t = np.arange(T)[None, :]
    vis = np.ones((S, T), bool)
    if causal:
        vis &= t <= q_pos
    if window > 0:
        vis &= t > q_pos - window
    flops = 4.0 * hd * B * H * int(vis.sum())       # q·k and p·v
    return _bound(nbytes, flops, dtype_name)


def ssd_bound_ms(shape, dtype_name: str) -> tuple[float, str]:
    """Least time for one SSD scan: x, B, C, dt and A read once and y
    written once at the HBM rate, against the multiply-adds the function
    needs at the fp32 rate outside the tensor cores (the kernel's
    arithmetic is fp32): per (batch, head) row and chunk of Lc positions,
    C·Bᵀ and scores·x over the Lc(Lc+1)/2 pairs j <= i, C·state (Lc·n·p)
    after the first chunk, and the state update (Lc·n·p) before the last."""
    b, s, h, p, g, n, L = shape
    esize = 4 if dtype_name == "float32" else 2
    nbytes = esize * (2 * b * s * h * p + 2 * b * s * g * n) + 4 * (b * s * h
                                                                   + h)
    chunks = [min(L, s - c) for c in range(0, s, L)]
    macs = 0
    for i, lc in enumerate(chunks):
        macs += lc * (lc + 1) // 2 * (n + p)
        macs += lc * n * p * ((i > 0) + (i < len(chunks) - 1))
    return _bound(nbytes, 2.0 * macs * b * h, "float32")


def _compare(name: str, shape, dtype, got, want, tol: float) -> float:
    if got.dtype != want.dtype or got.shape != want.shape:
        fail(f"{name} {shape} {dtype}: got {got.dtype} {tuple(got.shape)}, "
             f"want {want.dtype} {tuple(want.shape)}")
    if not bool(got.isfinite().all()):
        fail(f"{name} {shape} {dtype}: non-finite output")
    err = (got.float() - want.float()).abs()
    if bool((err > tol + tol * want.float().abs()).any()):
        fail(f"{name} {shape} {dtype}: max |err| {err.max().item():.3e} "
             f"over tolerance {tol}")
    print(f"{name} {shape} {str(dtype)[6:]}: max |err| "
          f"{err.max().item():.3e} (tol {tol})")
    return err.max().item()


def check_flash(torch, fa, ref) -> dict:
    """Phase 3. Returns the kernel's record for the final JSON line."""
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        tol = FP32_TOL if dtype == torch.float32 else BF16_TOL
        for i, shape in enumerate(SHAPES):
            B, S, H, hd, K, T, causal, window = shape
            gen = torch.Generator(device="cuda").manual_seed(100 + i)
            q, k, v = (torch.randn(s, generator=gen, device="cuda").to(dtype)
                       for s in ((B, S, H, hd), (B, T, K, hd), (B, T, K, hd)))
            got = fa.flash_attention(q, k, v, causal=causal, window=window)
            want = ref.flash_attention_ref(q, k, v, causal=causal,
                                           window=window)
            torch.cuda.synchronize()
            worst[(shape, str(dtype))] = _compare("flash_attention", shape,
                                                  dtype, got, want, tol)
            if T < S and dtype == torch.float32:
                blind = v.mean(dim=1, keepdim=True).expand(-1, S - T, -1, -1)
                blind_err = (got[:, :S - T] - blind).abs().max().item()
                if blind_err > FP32_TOL:
                    fail(f"T < S rows are not mean(v): {blind_err:.3e}")

    # time at each serving path's shape, fp32 (the dtype it serves in)
    times = {shape: time_flash(torch, fa, ref, shape)
             for shape in (MAIN_SHAPE, RG_FLASH_SHAPE)}
    rec = {"name": "flash_attention", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
           "replaces": "src/repro/kernels/flash_attention.py:70",
           "shape": list(MAIN_SHAPE[:6]), "dtype": "float32",
           "max_abs_err": worst[(MAIN_SHAPE, "torch.float32")],
           "max_abs_err_all_shapes": max(worst.values()),
           **times[MAIN_SHAPE]}
    rec["hd256"] = {"shape": list(RG_FLASH_SHAPE[:6]),
                    "window": RG_FLASH_SHAPE[7], "dtype": "float32",
                    "max_abs_err": worst[(RG_FLASH_SHAPE, "torch.float32")],
                    **times[RG_FLASH_SHAPE]}
    return rec


def time_flash(torch, fa, ref, shape) -> dict:
    """The kernel, its plain version and ``scaled_dot_product_attention`` (a
    yardstick only, with k and v expanded to the query heads) at one causal
    fp32 shape, by CUDA events."""
    B, S, H, hd, K, T, causal, window = shape
    gen = torch.Generator(device="cuda").manual_seed(7)
    q, k, v = (torch.randn(s, generator=gen, device="cuda")
               for s in ((B, S, H, hd), (B, T, K, hd), (B, T, K, hd)))
    run = lambda: fa.flash_attention(q, k, v, causal=True, window=window)
    ms = cuda_ms(torch, run)
    plain_ms = cuda_ms(torch, lambda: ref.flash_attention_ref(
        q, k, v, causal=True, window=window))
    qt = q.transpose(1, 2)
    kt, vt = (x.transpose(1, 2).expand(B, H, T, hd) for x in (k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = cuda_ms(torch, lambda: sdpa(qt, kt, vt, is_causal=True))
    lib_err = (sdpa(qt, kt, vt, is_causal=True).transpose(1, 2)
               - run()).abs().max().item()      # the window is >= T here
    bound_ms, bound_by = attention_bound_ms(shape, "float32")
    print(f"flash_attention {shape} float32: kernel {ms:.5f} ms, plain "
          f"{plain_ms:.5f} ms, sdpa {library_ms:.5f} ms (|diff| {lib_err:.2e}),"
          f" bound {bound_ms:.6f} ms ({bound_by})")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms}


def ssd_inputs(torch, shape, dtype, seed: int, dt_range=(0.001, 0.1)):
    """x, dt, A, B, C as ``tests/test_kernels.py`` draws them, on the card:
    x, B, C ~ N(0, 1) in ``dtype``; dt ~ U(dt_range); A ~ -U(0.5, 2)."""
    b, s, h, p, g, n, _ = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((b, s, h, p), generator=gen, device="cuda").to(dtype)
    lo, hi = dt_range
    dt = torch.rand((b, s, h), generator=gen, device="cuda") * (hi - lo) + lo
    A = -(torch.rand((h,), generator=gen, device="cuda") * 1.5 + 0.5)
    B = torch.randn((b, s, g, n), generator=gen, device="cuda").to(dtype)
    C = torch.randn((b, s, g, n), generator=gen, device="cuda").to(dtype)
    return x, dt, A, B, C


def ssd_plain(torch, ref, x, dt, A, B, C, chunk: int):
    """The plain version; a ragged s is zero-padded to a chunk multiple, as
    the model does, and the padding's rows are dropped."""
    s = x.shape[1]
    pad = (-s) % chunk
    if not pad:
        return ref.ssd_scan_ref(x, dt, A, B, C, chunk)
    padf = lambda a: torch.nn.functional.pad(
        a, (0, 0) * (a.dim() - 2) + (0, pad))
    return ref.ssd_scan_ref(padf(x), padf(dt), A, padf(B), padf(C),
                            chunk)[:, :s]


def check_ssd(torch, ssd, ref) -> dict:
    """Phase 4. Returns the kernel's record for the final JSON line."""
    worst = {}
    cases = [(shape, (0.001, 0.1)) for shape in SSD_SHAPES]
    cases.append((SSD_LARGE_DT, (0.5, 2.0)))
    for dtype in (torch.float32, torch.bfloat16):
        tol = FP32_TOL if dtype == torch.float32 else BF16_TOL
        for i, (shape, dt_range) in enumerate(cases):
            x, dt, A, B, C = ssd_inputs(torch, shape, dtype, 200 + i,
                                        dt_range)
            got = ssd.ssd_scan(x, dt, A, B, C, shape[6])
            want = ssd_plain(torch, ref, x, dt, A, B, C, shape[6])
            torch.cuda.synchronize()
            label = "ssd_scan" + (" dt~U(0.5,2)" if dt_range[0] >= 0.5
                                  else "")
            worst[(shape, dt_range, str(dtype))] = _compare(
                label, shape, dtype, got, want, tol)

    # time at the serving shape, fp32 (the dtype it serves in)
    x, dt, A, B, C = ssd_inputs(torch, SSD_MAIN_SHAPE, torch.float32, 7)
    L = SSD_MAIN_SHAPE[6]
    ms = cuda_ms(torch, lambda: ssd.ssd_scan(x, dt, A, B, C, L))
    plain_ms = cuda_ms(torch, lambda: ref.ssd_scan_ref(x, dt, A, B, C, L),
                       iters=50)
    bound_ms, bound_by = ssd_bound_ms(SSD_MAIN_SHAPE, "float32")
    print(f"ssd_scan {SSD_MAIN_SHAPE} float32: kernel {ms:.5f} ms, plain "
          f"{plain_ms:.5f} ms, bound {bound_ms:.6f} ms ({bound_by}); no "
          "single PyTorch call computes SSD")
    return {"name": "ssd_scan", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
            "replaces": "src/repro/kernels/ssd_scan.py:65",
            "shape": list(SSD_MAIN_SHAPE), "dtype": "float32",
            "max_abs_err": worst[(SSD_MAIN_SHAPE, (0.001, 0.1),
                                  "torch.float32")],
            "max_abs_err_all_shapes": max(worst.values()),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None}


def rglru_bound_ms(shape) -> tuple[float, str]:
    """Least time for one RG-LRU scan: a and b read once and h written once
    (fp32) at the HBM rate, against one multiply and one add per element at
    the fp32 rate outside the tensor cores."""
    B, S, W = shape[:3]
    return _bound(12.0 * B * S * W, 2.0 * B * S * W, "float32")


def rglru_inputs(torch, shape, seed: int):
    """a ~ U(a range) and b ~ N(0, 1), fp32 on the card, as
    ``tests/test_kernels.py`` draws them."""
    B, S, W, (lo, hi) = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    a = torch.rand((B, S, W), generator=gen, device="cuda") * (hi - lo) + lo
    b = torch.randn((B, S, W), generator=gen, device="cuda")
    return a, b


def check_rglru(torch, rg, ref) -> dict:
    """Phase 4, RG-LRU. Returns the kernel's record for the final JSON
    line."""
    worst = {}
    for i, shape in enumerate(RGLRU_SHAPES):
        a, b = rglru_inputs(torch, shape, 300 + i)
        got = rg.rglru_scan(a, b)
        want = ref.rglru_scan_ref(a, b)
        torch.cuda.synchronize()
        worst[shape] = _compare("rglru_scan", shape, torch.float32, got,
                                want, FP32_TOL)
    a, b = rglru_inputs(torch, RGLRU_MAIN_SHAPE, 7)
    ms = cuda_ms(torch, lambda: rg.rglru_scan(a, b))
    plain_ms = cuda_ms(torch, lambda: ref.rglru_scan_ref(a, b), iters=50)
    bound_ms, bound_by = rglru_bound_ms(RGLRU_MAIN_SHAPE)
    print(f"rglru_scan {RGLRU_MAIN_SHAPE[:3]} float32: kernel {ms:.5f} ms, "
          f"plain {plain_ms:.5f} ms, bound {bound_ms:.6f} ms ({bound_by}); "
          "no single PyTorch call computes the recurrence")
    return {"name": "rglru_scan", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/rglru_scan.cu",
            "replaces": "src/repro/kernels/rglru_scan.py:40",
            "shape": list(RGLRU_MAIN_SHAPE[:3]), "dtype": "float32",
            "max_abs_err": worst[RGLRU_MAIN_SHAPE],
            "max_abs_err_all_shapes": max(worst.values()),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None}


def _params(torch, cfg):
    from repro_torch.checkpoint import init_params
    gc.collect()                         # the last model's weights, if any
    torch.cuda.empty_cache()
    return init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                       torch.float32, device="cuda")


def check_full_model(torch, arch: str) -> None:
    """Phase 5: a full-width model, kernel path against the plain path."""
    from repro_torch.models import model as M
    from repro_torch.models import steps
    from repro_torch.models.config import get_config

    cfg = get_config(arch)
    t0 = time.perf_counter()
    params = _params(torch, cfg)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in _leaves(params))
    print(f"{arch} full width: {n_params} parameters (fp32) initialised in "
          f"{time.perf_counter() - t0:.2f} s")
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (1, 32)), device="cuda")
    results = {}
    for use_kernels in (True, False):
        opts = M.ModelOptions(use_kernels=use_kernels)
        logits, cache = steps.prefill_step(params, {"tokens": toks}, cfg,
                                           opts, 128)
        first = logits
        tokens = []
        tok = torch.argmax(logits, -1)
        for i in range(8):
            tokens.append(int(tok[0]))
            logits, cache = steps.decode_step(
                params, cache, {"token": tok, "pos": 32 + i}, cfg, opts)
            tok = torch.argmax(logits, -1)
        torch.cuda.synchronize()
        # time one prefill and one decode step (host clock, synchronised)
        t0 = time.perf_counter()
        for _ in range(5):
            steps.prefill_step(params, {"tokens": toks}, cfg, opts, 128)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) / 5 * 1e3
        t0 = time.perf_counter()
        for _ in range(5):
            steps.decode_step(params, cache, {"token": tok, "pos": 40}, cfg,
                              opts)
        torch.cuda.synchronize()
        decode_ms = (time.perf_counter() - t0) / 5 * 1e3
        results[use_kernels] = (first, tokens)
        print(f"{arch} prefill(1x32) use_kernels={use_kernels}: "
              f"{prefill_ms:.3f} ms; decode step (B=1): {decode_ms:.3f} ms; "
              f"greedy tokens {tokens}")
    (lk, tk), (lp, tp) = results[True], results[False]
    if lk.shape != (1, cfg.vocab_size) or not torch.isfinite(lk).all():
        fail(f"{arch} prefill logits: shape {tuple(lk.shape)} or non-finite "
             "values")
    diff = (lk - lp).abs().max().item()
    print(f"{arch} prefill logits, kernels vs plain: max |diff| {diff:.3e} "
          f"(tol {LOGIT_TOL})")
    if diff > LOGIT_TOL:
        fail(f"{arch} prefill logits differ by {diff:.3e}")
    if tk != tp:
        fail(f"{arch} greedy tokens differ: kernels {tk} vs plain {tp}")
    del params, results, cache, logits, first
    gc.collect()
    torch.cuda.empty_cache()


def expected_launches(cfg, kernel: str, prefills: int) -> int:
    """Launches of ``kernel`` in ``prefills`` prefills of ``cfg``: one per
    layer whose mixer the kernel carries."""
    layers = sum(1 for mixer, _ in cfg.layer_kinds
                 if mixer in KERNEL_MIXERS[kernel])
    return layers * prefills


def serve_path(torch, arch: str, wrappers: dict) -> dict:
    """Phase 6 for one model: serve it at full width with every launch
    count set to 0 just before and read just after, check each count, and
    plan the H100 fleet again from the measured rates. Returns the counts."""
    from repro_torch.core.gpu_catalog import (plan_gpu_fleet,
                                              streams_from_measured)
    from repro_torch.launch.serve import serve
    from repro_torch.models.config import get_config

    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    report = serve(arch, reduced=False, n_streams=4, fps=2, seconds=3,
                   engine="continuous")
    torch.cuda.synchronize()
    counts = {name: fn.launches for name, fn in wrappers.items()}
    wall = time.perf_counter() - t0
    print(json.dumps(report, sort_keys=True))
    print(f"serve {arch} wall time {wall:.2f} s; launches {counts}")
    frames = report["frames_served"]
    if frames <= 0:
        fail(f"{arch}: served no frames")
    if report["serving_report"]["requests"] != frames:
        fail(f"{arch}: engine request count disagrees with frames served")
    # every served frame is one prefill, plus the one warmup request that
    # serve() runs before it resets the stats
    cfg = get_config(arch)
    for name, got in counts.items():
        want = expected_launches(cfg, name, frames + 1)
        if got != want:
            fail(f"{arch}: {name} launched {got} times; expected {want} "
                 f"({want // (frames + 1)} layers x {frames + 1} prefills)")
    for name in SERVED[arch]:
        if counts[name] == 0:
            fail(f"{arch}: its kernel {name} never launched")
    streams = streams_from_measured(arch,
                                    report["measured_stream_tokens_per_s"])
    plans = {s: plan_gpu_fleet(streams, strategy=s)      # each validates
             for s in ("per-stream", "uniform-big", "packed")}
    if plans["packed"]["hourly_cost"] > plans["per-stream"]["hourly_cost"]:
        fail(f"{arch}: packed plan costs more than per-stream")
    print(f"{arch} fleet plans (re-planned, validated): " + json.dumps(
        {s: (p["hourly_cost"], p["instances"]) for s, p in plans.items()}))
    torch.cuda.empty_cache()
    return counts


def profile_serving(torch, arch: str) -> dict:
    """Phase 7: one drain of 8 frame requests on a full-width model, timed
    without and then with ``torch.profiler``; from the traced run, the
    device's busy time (sum of kernel intervals on its one stream), its idle
    share of the wall time, and device time by kernel."""
    from repro_torch.models.config import get_config
    from repro_torch.serving import ContinuousBatchingEngine, StreamSimulator

    cfg = get_config(arch)
    params = _params(torch, cfg)
    eng = ContinuousBatchingEngine(cfg, params, max_slots=8, cache_len=128)
    sim = StreamSimulator(eng, prompt_len=32, new_tokens=8, seed=1)
    streams = {f"cam-{i}": 2.0 for i in range(4)}
    sim.tick(streams)
    eng.drain()                                      # warm
    sim.tick(streams)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.drain()
    torch.cuda.synchronize()
    wall_plain = time.perf_counter() - t0
    sim.tick(streams)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.drain()
        torch.cuda.synchronize()
        wall_traced = time.perf_counter() - t0
    by_name: dict[str, list] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            rec = by_name.setdefault(e.name, [0.0, 0])
            rec[0] += e.time_range.elapsed_us() / 1e3
            rec[1] += 1
    busy_ms = sum(v[0] for v in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    per_call = {}
    for kernel in KERNEL_MIXERS:
        hits = [v for k, v in by_name.items() if f"{kernel}_kernel" in k]
        per_call[kernel] = (sum(v[0] for v in hits) / sum(v[1] for v in hits)
                            if hits else None)
    out = {"arch": arch, "requests": 8, "wall_ms": wall_plain * 1e3,
           "wall_traced_ms": wall_traced * 1e3,
           "device_busy_ms": busy_ms if by_name else None,
           "device_idle_share": (1 - busy_ms / (wall_traced * 1e3))
           if by_name else None,
           "device_ms_per_call": per_call,
           "top_device_kernels_ms": [(k[:80], round(v[0], 4), v[1])
                                     for k, v in top]}
    print(f"serving profile (8 requests, full {arch}): " + json.dumps(out))
    del eng, sim, params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def build_kernels(modules: dict) -> None:
    """Phase 2: one nvcc per source, all started together."""
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(modules)) as pool:
        for fut in [pool.submit(_build.build, name) for name in modules]:
            fut.result()
    for name, mod in modules.items():
        mod.build()                       # load the built library
        log = _build.library_path(name).with_suffix(".log")
        print(f"built {_build.library_path(name).name}")
        if log.exists():
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line or \
                        "Compiling" in line or "smem" in line:
                    print(f"  nvcc {name}:", line.strip())
    print(f"built {len(modules)} kernels in {time.perf_counter() - t0:.1f} s")


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device: the port's smoke run needs an H100")
    if torch.cuda.get_device_capability(0) < (9, 0):
        fail(f"compute capability {torch.cuda.get_device_capability(0)} < 9.0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.kernels import rglru_scan as rg
    from repro_torch.kernels import ssd_scan as ssd

    # 2) build
    build_kernels({"flash_attention": fa, "ssd_scan": ssd, "rglru_scan": rg})
    wrappers = {"flash_attention": fa.flash_attention,
                "ssd_scan": ssd.ssd_scan, "rglru_scan": rg.rglru_scan}

    # 3-4) each kernel against its plain version, and its times
    records = {"flash_attention": check_flash(torch, fa, ref),
               "ssd_scan": check_ssd(torch, ssd, ref),
               "rglru_scan": check_rglru(torch, rg, ref)}

    # 5) full-width models, kernel path against the plain path
    for arch in SERVED:
        check_full_model(torch, arch)

    # 6) the main paths: serve, then plan from the measured rates; a kernel
    # on two paths records the sum of its launches and each path's count
    for rec in records.values():
        rec["launches"], rec["launches_by_path"] = 0, {}
    for arch in SERVED:
        counts = serve_path(torch, arch, wrappers)
        for name, n in counts.items():
            records[name]["launches"] += n
            records[name]["launches_by_path"][arch] = n

    # 7) where the time goes on the serving paths (after the counts are
    # read); a kernel's device_ms is its time a call on its first path
    for arch, kernels in SERVED.items():
        prof = profile_serving(torch, arch)
        for name in kernels:
            per_call = prof["device_ms_per_call"][name]
            records[name].setdefault("device_ms", per_call)
            records[name].setdefault("device_ms_by_path", {})[arch] = per_call
    print(card, flush=True)
    print(json.dumps({"kernels": list(records.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

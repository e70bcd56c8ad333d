#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one Hopper GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (non-zero exit, no ``ok`` line):

1. Require a CUDA device of compute capability >= 9.0; print the card's
   name and power limit as ``nvidia-smi`` reports them.
2. Build the CUDA flash-attention kernel from ``src/repro_torch/kernels/
   csrc`` with nvcc (cached under ``build/``) and print the compiler report.
3. Hold the kernel against its plain PyTorch version on seeded inputs: the
   reference's kernel test grid in fp32 and bf16, the serving path's shape,
   ragged shapes and a T < S shape (whose blind rows must be mean(v)).
   Tolerances: fp32 1e-4 (summation order differs on the card), bf16 2e-2
   (both sides round once to bf16). Time the kernel, the plain version and
   ``scaled_dot_product_attention`` (a yardstick only; the port never calls
   it) at the serving path's shape, beside the least time the card could
   take for the same bytes and operations.
4. Full-width olmo-1b in fp32, weights from a seeded generator on the card:
   prefill a 32-token prompt with and without the kernel, compare the
   logits, and decode 8 greedy tokens from each; the tokens must match.
5. ``serve("olmo-1b", reduced=False, ...)`` with the continuous-batching
   engine; the kernel's launch count must be 16 x the prefills it ran, and
   the H100 fleet is planned again from the measured rates (every plan is
   validated).
6. Profile one drain of 8 requests with ``torch.profiler``: wall time
   with and without tracing, the device's busy time and idle share, and
   device time by kernel (the flash kernel's per call among them).
7. Print ``{"kernels": [...]}`` on one line, then the last line
   ``{"ok": true, "device": {...}}``.

TF32 is off throughout, so fp32 matrix products are full fp32.
"""
from __future__ import annotations

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
LOGIT_TOL = 1e-3                # fp32 logits of unit scale after 16 layers
MAIN_SHAPE = (1, 32, 16, 128, 16, 32, True, 0)   # B, S, H, hd, K, T, causal, window
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
]


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
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_kernel(torch, fa, ref) -> dict:
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
            err = (got.float() - want.float()).abs()
            if not torch.isfinite(got).all():
                fail(f"flash_attention {shape} {dtype}: non-finite output")
            if (err > tol + tol * want.float().abs()).any():
                fail(f"flash_attention {shape} {dtype}: max |err| "
                     f"{err.max().item():.3e} over tolerance {tol}")
            if T < S and dtype == torch.float32:
                blind = v.mean(dim=1, keepdim=True).expand(-1, S - T, -1, -1)
                blind_err = (got[:, :S - T] - blind).abs().max().item()
                if blind_err > FP32_TOL:
                    fail(f"T < S rows are not mean(v): {blind_err:.3e}")
            worst[(shape, str(dtype))] = err.max().item()
            print(f"flash_attention {shape} {str(dtype)[6:]}: max |err| "
                  f"{err.max().item():.3e} (tol {tol})")

    # time at the serving path's shape, fp32 (the dtype it serves in)
    B, S, H, hd, K, T, causal, window = MAIN_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(7)
    q, k, v = (torch.randn(s, generator=gen, device="cuda")
               for s in ((B, S, H, hd), (B, T, K, hd), (B, T, K, hd)))
    ms = cuda_ms(torch, lambda: fa.flash_attention(q, k, v, causal=True))
    plain_ms = cuda_ms(torch, lambda: ref.flash_attention_ref(q, k, v,
                                                              causal=True))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = cuda_ms(torch, lambda: sdpa(qt, kt, vt, is_causal=True))
    lib_err = (sdpa(qt, kt, vt, is_causal=True).transpose(1, 2)
               - fa.flash_attention(q, k, v, causal=True)).abs().max().item()
    bound_ms, bound_by = attention_bound_ms(MAIN_SHAPE, "float32")
    print(f"flash_attention {MAIN_SHAPE} float32: kernel {ms:.5f} ms, plain "
          f"{plain_ms:.5f} ms, sdpa {library_ms:.5f} ms (|diff| {lib_err:.2e}),"
          f" bound {bound_ms:.6f} ms ({bound_by})")
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:70",
            "shape": list(MAIN_SHAPE[:6]), "dtype": "float32",
            "max_abs_err": worst[(MAIN_SHAPE, "torch.float32")],
            "max_abs_err_all_shapes": max(worst.values()),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms}


def check_full_model(torch) -> None:
    """Phase 4: full-width olmo-1b, kernel path against the einsum path."""
    from repro_torch.checkpoint import init_params
    from repro_torch.models import model as M
    from repro_torch.models import steps
    from repro_torch.models.config import get_config

    cfg = get_config("olmo-1b")
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         torch.float32, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in _leaves(params))
    print(f"olmo-1b full width: {n_params} parameters (fp32) initialised in "
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
        print(f"olmo-1b prefill(1x32) use_kernels={use_kernels}: "
              f"{prefill_ms:.3f} ms; decode step (B=1): {decode_ms:.3f} ms; "
              f"greedy tokens {tokens}")
    (lk, tk), (lp, tp) = results[True], results[False]
    if lk.shape != (1, cfg.vocab_size) or not torch.isfinite(lk).all():
        fail(f"prefill logits: shape {tuple(lk.shape)} or non-finite values")
    diff = (lk - lp).abs().max().item()
    print(f"olmo-1b prefill logits, kernel vs einsum: max |diff| {diff:.3e} "
          f"(tol {LOGIT_TOL})")
    if diff > LOGIT_TOL:
        fail(f"prefill logits differ by {diff:.3e}")
    if tk != tp:
        fail(f"greedy tokens differ: kernel {tk} vs einsum {tp}")
    del params, results
    torch.cuda.empty_cache()


def profile_serving(torch) -> dict:
    """Phase 6: one drain of 8 frame requests on full-width olmo-1b, timed
    without and then with ``torch.profiler``; from the traced run, the
    device's busy time (sum of kernel intervals on its one stream), its idle
    share of the wall time, and device time by kernel."""
    from repro_torch.checkpoint import init_params
    from repro_torch.models.config import get_config
    from repro_torch.serving import ContinuousBatchingEngine, StreamSimulator

    cfg = get_config("olmo-1b")
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         torch.float32, device="cuda")
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
    flash = [v for k, v in by_name.items() if "flash_attention_kernel" in k]
    out = {"requests": 8, "wall_ms": wall_plain * 1e3,
           "wall_traced_ms": wall_traced * 1e3,
           "device_busy_ms": busy_ms if by_name else None,
           "device_idle_share": (1 - busy_ms / (wall_traced * 1e3))
           if by_name else None,
           "flash_device_ms_per_call": (sum(v[0] for v in flash)
                                        / sum(v[1] for v in flash))
           if flash else None,
           "top_device_kernels_ms": [(k[:80], round(v[0], 4), v[1])
                                     for k, v in top]}
    print("serving profile (8 requests, full olmo-1b): " + json.dumps(out))
    del eng, params
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
    print(smi.stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    # 2) build
    t0 = time.perf_counter()
    fa.build()
    log = _build.library_path("flash_attention").with_suffix(".log")
    print(f"built {_build.library_path('flash_attention').name} in "
          f"{time.perf_counter() - t0:.1f} s")
    if log.exists():
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print("  nvcc:", line.strip())

    # 3) kernel against its plain version, and its times
    record = check_kernel(torch, fa, ref)

    # 4) full-width model, kernel path against the plain path
    check_full_model(torch)

    # 5) the main path: serve, then plan from the measured rates
    from repro_torch.core.gpu_catalog import (plan_gpu_fleet,
                                              streams_from_measured)
    from repro_torch.launch.serve import serve
    fa.flash_attention.launches = 0
    t0 = time.perf_counter()
    report = serve("olmo-1b", reduced=False, n_streams=4, fps=2, seconds=3,
                   engine="continuous")
    torch.cuda.synchronize()
    launches = fa.flash_attention.launches
    print(json.dumps(report, sort_keys=True))
    print(f"serve wall time {time.perf_counter() - t0:.2f} s")
    frames = report["frames_served"]
    if frames <= 0:
        fail("served no frames")
    if report["serving_report"]["requests"] != frames:
        fail("engine request count disagrees with frames served")
    # every served frame is one prefill, plus the one warmup request that
    # serve() runs before it resets the stats; 16 layers launch per prefill
    want = 16 * (frames + 1)
    if launches != want:
        fail(f"flash_attention launched {launches} times; expected {want} "
             f"(16 x {frames + 1} prefills)")
    streams = streams_from_measured("olmo-1b",
                                    report["measured_stream_tokens_per_s"])
    plans = {s: plan_gpu_fleet(streams, strategy=s)      # each validates
             for s in ("per-stream", "uniform-big", "packed")}
    if plans["packed"]["hourly_cost"] > plans["per-stream"]["hourly_cost"]:
        fail("packed plan costs more than per-stream")
    print("fleet plans (re-planned, validated): " + json.dumps(
        {s: (p["hourly_cost"], p["instances"]) for s, p in plans.items()}))

    record["launches"] = launches

    # 6) where the time goes on the serving path (after the counts are read)
    prof = profile_serving(torch)
    record["device_ms"] = prof["flash_device_ms_per_call"]
    print(json.dumps({"kernels": [record]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

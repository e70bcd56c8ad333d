#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one Hopper GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (non-zero exit, no ``ok`` line):

1. Require a CUDA device of compute capability >= 9.0; print the card's
   name and power limit as ``nvidia-smi`` reports them.
2. Build the CUDA kernels (flash attention, SSD chunked scan, RG-LRU: the
   scan and the fused gates-and-scan form, one source) from
   ``src/repro_torch/kernels/csrc`` with nvcc, one compiler per source, all
   started together (cached under ``build/``), and print their reports.
3. Hold the flash kernel against its plain PyTorch version on seeded inputs:
   the reference's kernel test grid in fp32 and bf16, olmo-1b's and
   recurrentgemma-9b's prefill shapes (head_dim 128 MHA; head_dim 256 MQA
   with a window), ragged shapes (one at head_dim 256 where the window
   bites), T > S shapes with a window, a T < S shape (whose blind rows
   must be mean(v)), two 1024-token shapes that cross 32 KV tiles, one
   causal at head_dim 128 and one windowed at head_dim 256 (bf16 there runs
   on the tensor cores), the attention family's prefill shapes (yi-9b's
   8-way, nemotron-4-15b's 6-way and internvl2-1b's 7-way GQA) and head_dim
   80: hubert-xlarge's non-causal (1, 500, 16, 80, 16, 500), whose last KV
   tile holds 20 keys, a whole-tile encoder shape, a ragged causal GQA one
   and one with T > S and a window. At each model path's shape (olmo-1b,
   recurrentgemma-9b, yi-9b, nemotron-4-15b, internvl2-1b and
   hubert-xlarge), time the kernel issued back to back
   (CUDA events), its device time alone (profiler), its host enqueue time
   (host clock, no synchronise), the plain version and
   ``scaled_dot_product_attention`` (a yardstick only; the port never calls
   it), and print the bound. In bf16 also at the MoE models' prefill
   shapes, qwen3-moe-30b-a3b's (1, 32, 32, 128, 4, 32) (yi-9b's) and
   moonshot-v1-16b-a3b's (1, 32, 16, 128, 16, 32) (olmo-1b's), with bf16
   SDPA and the bound in bf16 bytes.
4. Hold the SSD kernels against their plain version: the reference's
   kernel test grid (g = 2 and the production-like state among it), the
   serving shape (one 128-chunk, 80 heads), a multi-chunk multi-batch shape
   that carries the state, a large-dt shape whose upper triangle would
   overflow if it were not masked, a ragged shape (against the plain version
   of the zero-padded inputs) and a 16-chunk shape with 2 groups. Every
   output must be finite. At the serving shape, time one call (its two to
   four kernels) back to back, on the device (summed over its kernels, each
   named) and its host enqueue, and the plain version; the 16-chunk shape's
   device time by kernel too. No single PyTorch call computes SSD, so it has
   no library yardstick.
   Hold the RG-LRU scan against its plain version: the reference's kernel
   test grid, the serving shape (1, 32, 4096), a ragged shape and a long
   (1, 2048, 4096) one with a ~ U(0.99, 0.9999), where h grows to ~100·|b|.
   Hold the fused RG-LRU (gates, scan, gelu gating; y and the final state)
   against its plain version in fp32 and bf16 at the prefill (1, 32, 4096),
   the 8-slot decode (8, 1, 4096) from a non-zero state, a ragged (2, 37,
   300) and the long (1, 2048, 4096). Every output must be finite. Time
   both forms at their main shapes, the fused form also at the decode's,
   and both at the long one (back to back, device alone, host enqueue),
   and their plain versions; no single PyTorch call computes the
   recurrence.
   Tolerances for every kernel: fp32 1e-4 (summation order differs on the
   card), bf16 2e-2 (both sides round once to bf16), each absolute plus
   relative to the plain value.
5. Full-width olmo-1b, mamba2-2.7b, recurrentgemma-9b, yi-9b,
   nemotron-4-15b and internvl2-1b in fp32, weights from a seeded generator
   on the card, one model on the card at a time: prefill a 32-token prompt
   (after 256 patch embeddings for internvl2-1b) with and without the
   kernels, compare the logits (within 1e-3: fp32 logits of unit scale
   after 16-64 layers whose sums run in another order on each path), and
   decode 8 greedy tokens from each; the tokens must match. yi-9b once more
   with ``window_override=128`` on a 300-token prompt, so that the window
   masks in prefill and decode: the kernels with a ring cache of 128 slots
   against the plain path over the full cache with the window mask.
   hubert-xlarge's ``forward_hidden`` over (1, 500, 1280) frames, the
   hidden states within 1e-3 (and its MoE aux 0). qwen3-moe-30b-a3b at
   full width cut to 8 layers, so that it fits in fp32: kernels against
   plain within 1e-3, identical greedy tokens; the same model in bf16,
   each path against the fp32 logits, and the routed tokens whose experts
   differ (a witness of where bf16 paths part). Then the MoE models,
   qwen3-moe-30b-a3b and moonshot-v1-16b-a3b, at full width in bf16 (61.1
   and 56.1 GB of weights; fp32 would not fit the card), one at a time:
   prefill a 32-token prompt and decode 8 greedy tokens with the kernels,
   twice (identical tokens and logits: the kernel path is deterministic),
   then the plain path fed the kernel path's tokens (teacher forcing:
   bf16 greedy runs may legitimately part), its logits within
   ``BF16_LOGIT_TOL`` (abs + rel) and ``BF16_REL_RMS_TOL`` (rms(diff) /
   rms(plain)) of the kernel path's at the prefill and every step; every
   flash call of a kernel-path prefill against the plain version in fp32
   on its own q, k, v within 2e-2; a control run with a planted fault
   (the middle layer's last 4 flash rows zeroed) that both checks must
   see; peak memory beside the weights' bytes. Each path's flash
   launches, counted from 0, must be its attention layers x its
   kernel-path prefills (6) or forwards (1).
6. The main paths: ``serve(arch, reduced=False, ...)`` with the continuous-
   batching engine for each model in turn; qwen3-moe-30b-a3b with bf16
   weights, through an engine built here and ``serve``'s second half,
   ``launch.serve.measure_and_plan``. Every kernel's launch count is
   set to 0 just before each run and read just after; each must equal (the
   served config's layers of the kernel's kind) x (prefills, and for the
   fused RG-LRU also the decode steps), the engine's own counts with the
   warmup's: olmo-1b, yi-9b and qwen3-moe-30b-a3b launch only the flash
   kernel (16, 48 and 48 layers), mamba2-2.7b only the SSD kernel, and recurrentgemma-9b the
   fused RG-LRU kernel in its 26 recurrent layers in every prefill and
   decode step and the flash kernel in its 12 local-attention layers in
   every prefill; the scan-only RG-LRU kernel is on no served path. The H100 fleet is planned again from each
   run's measured rates (every plan is validated).
7. Profile one drain of 8 requests on each model with ``torch.profiler``:
   wall time with and without tracing, the device's busy time and idle
   share, and device time by kernel (each port kernel's per wrapper call,
   summed over the device kernels it launches; the fused RG-LRU kernel is
   named ``rglru_gated_scan_kernel`` in the trace). For the MoE model, a
   second traced drain with each step of ``models.moe`` (routing,
   dispatch, the experts, combine) in a ``record_function`` range: the
   device time under each step and the expert ``bmm``s' part. The idle
   share is the unannotated drain's, for every model.
8. The paper's analysis programs, VGG16 and ZF, at 224 px (reference
   head: 512 wide, 1000 classes), batch 1 and 8, weights from a seeded
   generator: the card's fp32 logits against the same model on the CPU
   within 1e-4 (absolute plus relative); frames/s (CUDA events),
   ``flops_per_frame`` and TFLOP/s against the 67 TFLOP/s fp32 peak; bf16
   timed too, with its largest deviation from fp32. One ``{"vgg": ...}``
   line.
9. Print ``{"kernels": [...]}`` on one line (a kernel's ``launches`` sums
   its served paths; ``launches_by_path`` also holds the phase-5 paths),
   then the last line ``{"ok": true, "device": {...}}``.

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
# bf16 logits after 48 layers, abs + rel: a loose sanity bound; the first
# chip run of these paths gave up to 0.36. Both bf16 paths are as far from
# fp32 as from each other, a quarter of the routed tokens changing experts
# (check_moe_witness; PERF.md)
BF16_LOGIT_TOL = 0.5
# bf16 logits after 48 layers, rms(kernels - plain) / rms(plain) at the
# prefill and every step: between the sound runs' largest reading and a
# planted fault's, both of which the run reads again (PERF.md)
BF16_REL_RMS_TOL = 0.12
# the planted fault of the bf16 check's control: the flash output of the
# middle layer's prefill loses its last 4 query rows (zeroed)
FAULT_ROWS = 4
MOE_WITNESS_LAYERS = 8          # qwen3-moe at full width, cut to 8 layers
MAIN_SHAPE = (1, 32, 16, 128, 16, 32, True, 0)   # B, S, H, hd, K, T, causal, window
RG_FLASH_SHAPE = (1, 32, 16, 256, 1, 32, True, 2048)  # recurrentgemma-9b prefill
YI_FLASH_SHAPE = (1, 32, 32, 128, 4, 32, True, 0)     # yi-9b prefill, 8-way GQA
NEMOTRON_FLASH_SHAPE = (1, 32, 48, 128, 8, 32, True, 0)   # 6-way GQA
INTERNVL_FLASH_SHAPE = (1, 288, 14, 64, 2, 288, True, 0)  # 256 patches + 32
HUBERT_FLASH_SHAPE = (1, 500, 16, 80, 16, 500, False, 0)  # hubert-xlarge, hd 80
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
    (1, 1024, 16, 128, 16, 1024, True, 0),   # many KV tiles, causal skipping
    (1, 1024, 16, 256, 1, 1024, True, 256),  # many KV tiles, window skipping
    YI_FLASH_SHAPE,                        # yi-9b prefill of 32 tokens
    NEMOTRON_FLASH_SHAPE,                  # nemotron-4-15b prefill
    INTERNVL_FLASH_SHAPE,                  # internvl2-1b prefill, 7-way GQA
    HUBERT_FLASH_SHAPE,                    # encoder, last KV tile of 20 keys
    (1, 128, 2, 80, 2, 128, False, 0),     # hd 80, encoder, whole tiles
    (1, 300, 16, 80, 4, 300, True, 0),     # hd 80, ragged causal GQA
    (2, 37, 4, 80, 2, 90, True, 24),       # hd 80, T > S with a window
]
# the flash kernel's timed shapes: each model path's prefill or forward;
# "hd256" (recurrentgemma-9b) keeps its key of earlier runs
FLASH_TIMED = {"olmo-1b": MAIN_SHAPE, "hd256": RG_FLASH_SHAPE,
               "yi-9b": YI_FLASH_SHAPE, "nemotron-4-15b": NEMOTRON_FLASH_SHAPE,
               "internvl2-1b": INTERNVL_FLASH_SHAPE,
               "hubert-xlarge hd80": HUBERT_FLASH_SHAPE}
# the MoE models' prefill shapes, timed in bf16, the dtype they serve in:
# qwen3-moe-30b-a3b's is yi-9b's (8-way GQA), moonshot-v1-16b-a3b's
# olmo-1b's (MHA); both are in SHAPES, so held in fp32 and bf16 above
FLASH_TIMED_BF16 = {"qwen3-moe-30b-a3b bf16": YI_FLASH_SHAPE,
                    "moonshot-v1-16b-a3b bf16": MAIN_SHAPE}
# b, s, h, p, g, n, chunk
SSD_MAIN_SHAPE = (1, 128, 80, 64, 1, 128, 128)   # mamba2-2.7b prefill, padded
SSD_MANY_CHUNKS = (1, 2048, 16, 64, 2, 128, 128)  # 16 chunks: all four kernels
SSD_SHAPES = [
    (2, 128, 4, 32, 1, 32, 32),            # tests/test_kernels.py grid
    (1, 256, 2, 64, 1, 64, 64),
    (1, 64, 4, 16, 2, 16, 16),             # 2 B/C groups
    (1, 256, 8, 64, 1, 128, 128),          # production-like state size
    SSD_MAIN_SHAPE,
    (2, 512, 80, 64, 1, 128, 128),         # 4 chunks x 2 rows: carries state
    (2, 300, 8, 64, 2, 128, 128),          # ragged: chunks of 128, 128, 44
    SSD_MANY_CHUNKS,                       # 16 chunks, 2 groups
    (1, 50, 4, 32, 2, 16, 20),             # chunks of 20, 20, 10: 16-row
]                                          # tiles do not divide them
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
RGLRU_LONG_SHAPE = RGLRU_SHAPES[-1]
# B, S, W, with an initial state h0
GATED_MAIN_SHAPE = (1, 32, 4096, False)          # recurrentgemma-9b prefill
GATED_DECODE_SHAPE = (8, 1, 4096, True)          # its decode of 8 slots
GATED_LONG_SHAPE = (1, 2048, 4096, False)
GATED_SHAPES = [GATED_MAIN_SHAPE, GATED_DECODE_SHAPE,
                (2, 37, 300, False),             # ragged
                GATED_LONG_SHAPE]
# the mixers whose layers launch each kernel, and whether a decode step
# launches it too (once per such layer) or only a prefill does; the
# scan-only RG-LRU kernel is on no served path since the fused one replaced
# it there
KERNEL_MIXERS = {"flash_attention": (("attn", "attn_window"), False),
                 "ssd_scan": (("ssd",), False), "rglru_scan": ((), False),
                 "rglru_gated_scan": (("rglru",), True)}
# each served model and the kernels its main path runs
SERVED = {"olmo-1b": ["flash_attention"], "mamba2-2.7b": ["ssd_scan"],
          "recurrentgemma-9b": ["rglru_gated_scan", "flash_attention"],
          "yi-9b": ["flash_attention"],
          "qwen3-moe-30b-a3b": ["flash_attention"]}
# the MoE models run in bf16: 61.1 and 56.1 GB of weights, which would not
# fit the card's 80 GB in fp32; qwen3-moe-30b-a3b is also served
BF16_ARCHS = ("qwen3-moe-30b-a3b", "moonshot-v1-16b-a3b")
# phase 5 beyond the served models: full-width paths the launcher does not
# serve (nemotron-4-15b could be; the others need frames or patches)
VGG_HW = 224                    # the canonical VGG16/ZF frame size
YI_WINDOW = 128                 # window_override of yi-9b's long-prompt check
YI_WINDOW_PROMPT = 300


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


def host_enqueue_ms(torch, fn, iters: int = 200, warmup: int = 20) -> float:
    """Host time to enqueue one call: a host clock over ``iters`` calls with
    no synchronise inside (the device may still be running when it stops)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    ms = (time.perf_counter() - t0) / iters * 1e3
    torch.cuda.synchronize()
    return ms


def device_ms(torch, fn, kernel: str, calls: int = 50) -> tuple[float, dict]:
    """Device time of one call, from ``torch.profiler``: the intervals of
    every device kernel whose name holds ``kernel`` over ``calls`` calls,
    summed and divided by ``calls`` (a call that launches several kernels
    counts them all). Also returns each such kernel's ms per call. A trace
    that holds no such kernel is taken again, twice at most (one such empty
    trace was seen on the card, once, in a process that had traced other
    kernels before)."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        by_name: dict[str, float] = {}
        seen = set()
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                seen.add(e.name[:80])
                if kernel in e.name:
                    by_name[e.name] = by_name.get(e.name, 0.0) + \
                        e.time_range.elapsed_us() / 1e3
        if by_name:
            break
        print(f"device_ms: no device kernel named like {kernel} among "
              f"{len(seen)} traced: {sorted(seen)[:6]}", file=sys.stderr)
    if not by_name:
        fail(f"the profiler saw no device kernel named like {kernel}")
    per = {k[:90]: v / calls for k, v in by_name.items()}
    return sum(per.values()), per


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
    arithmetic is fp32). Per chunk of Lc positions: C·Bᵀ over the
    Lc(Lc+1)/2 pairs j <= i once per (batch, group), since the h/g heads of
    a group share it; scores·x over the same pairs per (batch, head); and
    per (batch, head) C·state (Lc·n·p) after the first chunk and the state
    update (Lc·n·p) before the last."""
    b, s, h, p, g, n, L = shape
    esize = 4 if dtype_name == "float32" else 2
    nbytes = esize * (2 * b * s * h * p + 2 * b * s * g * n) + 4 * (b * s * h
                                                                   + h)
    chunks = [min(L, s - c) for c in range(0, s, L)]
    macs = 0
    for i, lc in enumerate(chunks):
        pairs = lc * (lc + 1) // 2
        macs += b * g * pairs * n + b * h * pairs * p
        macs += b * h * lc * n * p * ((i > 0) + (i < len(chunks) - 1))
    return _bound(nbytes, 2.0 * macs, "float32")


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

    # time at each path's shape, in the dtype the path runs in
    times = {shape: time_flash(torch, fa, ref, shape)
             for shape in FLASH_TIMED.values()}
    times_bf16 = {key: time_flash(torch, fa, ref, shape, torch.bfloat16)
                  for key, shape in FLASH_TIMED_BF16.items()}
    rec = {"name": "flash_attention", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
           "replaces": "src/repro/kernels/flash_attention.py:70",
           "shape": list(MAIN_SHAPE[:6]), "dtype": "float32",
           "max_abs_err": worst[(MAIN_SHAPE, "torch.float32")],
           "max_abs_err_all_shapes": max(worst.values()),
           **times[MAIN_SHAPE]}
    for key, shape in FLASH_TIMED.items():
        if shape != MAIN_SHAPE:
            rec[key] = {"shape": list(shape[:6]), "causal": shape[6],
                        "window": shape[7], "dtype": "float32",
                        "max_abs_err": worst[(shape, "torch.float32")],
                        "max_abs_err_bf16": worst[(shape, "torch.bfloat16")],
                        **times[shape]}
    for key, shape in FLASH_TIMED_BF16.items():
        rec[key] = {"shape": list(shape[:6]), "causal": shape[6],
                    "window": shape[7], "dtype": "bfloat16",
                    "max_abs_err": worst[(shape, "torch.bfloat16")],
                    **times_bf16[key]}
    return rec


def time_flash(torch, fa, ref, shape, dtype=None) -> dict:
    """The kernel, its plain version and ``scaled_dot_product_attention`` (a
    yardstick only, with each KV head expanded onto its query heads) at one
    shape whose window, if any, is >= T, in ``dtype`` (fp32 by default), by
    CUDA events."""
    B, S, H, hd, K, T, causal, window = shape
    dtype = dtype or torch.float32
    gen = torch.Generator(device="cuda").manual_seed(7)
    q, k, v = (torch.randn(s, generator=gen, device="cuda").to(dtype)
               for s in ((B, S, H, hd), (B, T, K, hd), (B, T, K, hd)))
    run = lambda: fa.flash_attention(q, k, v, causal=causal, window=window)
    ms = cuda_ms(torch, run)
    host_ms = host_enqueue_ms(torch, run)
    dev_ms, _ = device_ms(torch, run, "flash_attention_kernel")
    plain_ms = cuda_ms(torch, lambda: ref.flash_attention_ref(
        q, k, v, causal=causal, window=window))
    qt = q.transpose(1, 2)
    # (B, K, T, hd) -> (B, H, T, hd): a view for MHA and MQA, a copy for GQA
    kt, vt = (x.transpose(1, 2)[:, :, None].expand(B, K, H // K, T, hd)
              .reshape(B, H, T, hd) for x in (k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library = lambda: sdpa(qt, kt, vt, is_causal=causal)
    library_ms = cuda_ms(torch, library)
    lib_err = (library().transpose(1, 2).float() - run().float()).abs(
    ).max().item()
    dtype_name = str(dtype)[6:]
    bound_ms, bound_by = attention_bound_ms(shape, dtype_name)
    sdpa_host_ms = host_enqueue_ms(torch, library)
    print(f"flash_attention {shape} {dtype_name}: kernel {ms:.5f} ms back "
          f"to back (device {dev_ms:.6f} ms, host enqueue {host_ms:.6f} ms), "
          f"plain {plain_ms:.5f} ms, sdpa {library_ms:.5f} ms back to back "
          f"(host enqueue {sdpa_host_ms:.6f} ms, |diff| {lib_err:.2e}), bound "
          f"{bound_ms:.6f} ms ({bound_by})")
    return {"ms": ms, "device_ms_alone": dev_ms, "host_enqueue_ms": host_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "library_host_enqueue_ms": sdpa_host_ms}


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
    run = lambda: ssd.ssd_scan(x, dt, A, B, C, L)
    ms = cuda_ms(torch, run)
    host_ms = host_enqueue_ms(torch, run)
    dev_ms, per_kernel = device_ms(torch, run, "ssd_scan_kernel")
    plain_ms = cuda_ms(torch, lambda: ref.ssd_scan_ref(x, dt, A, B, C, L),
                       iters=50)
    bound_ms, bound_by = ssd_bound_ms(SSD_MAIN_SHAPE, "float32")
    print(f"ssd_scan {SSD_MAIN_SHAPE} float32: kernels {ms:.5f} ms back to "
          f"back (device {dev_ms:.6f} ms = {json.dumps(per_kernel)}, host "
          f"enqueue {host_ms:.6f} ms), plain {plain_ms:.5f} ms, bound "
          f"{bound_ms:.6f} ms ({bound_by}); no single PyTorch call computes "
          "SSD")
    # the 16-chunk shape runs all four kernels: their device times
    big = SSD_MANY_CHUNKS
    xb, dtb, Ab, Bb, Cb = ssd_inputs(torch, big, torch.float32, 8)
    big_ms, big_per = device_ms(torch, lambda: ssd.ssd_scan(
        xb, dtb, Ab, Bb, Cb, big[6]), "ssd_scan_kernel", calls=20)
    print(f"ssd_scan {big} float32: device {big_ms:.6f} ms = "
          f"{json.dumps(big_per)}, bound "
          f"{ssd_bound_ms(big, 'float32')[0]:.6f} ms")
    return {"name": "ssd_scan", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
            "replaces": "src/repro/kernels/ssd_scan.py:65",
            "shape": list(SSD_MAIN_SHAPE), "dtype": "float32",
            "max_abs_err": worst[(SSD_MAIN_SHAPE, (0.001, 0.1),
                                  "torch.float32")],
            "max_abs_err_all_shapes": max(worst.values()),
            "ms": ms, "device_ms_alone": dev_ms,
            "device_ms_by_kernel": per_kernel, "host_enqueue_ms": host_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
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


def time_kernel(torch, run, kernel: str) -> dict:
    """One call's times: back to back (CUDA events), device alone (the
    profiler's intervals of the device kernels named like ``kernel``) and
    host enqueue (host clock, no synchronise)."""
    return {"ms": cuda_ms(torch, run),
            "device_ms_alone": device_ms(torch, run, kernel)[0],
            "host_enqueue_ms": host_enqueue_ms(torch, run)}


def check_rglru(torch, rg, ref) -> dict:
    """Phase 4, the RG-LRU scan. Returns the kernel's record for the final
    JSON line."""
    worst = {}
    for i, shape in enumerate(RGLRU_SHAPES):
        a, b = rglru_inputs(torch, shape, 300 + i)
        got = rg.rglru_scan(a, b)
        want = ref.rglru_scan_ref(a, b)
        torch.cuda.synchronize()
        worst[shape] = _compare("rglru_scan", shape, torch.float32, got,
                                want, FP32_TOL)
    times = {}
    for shape in (RGLRU_MAIN_SHAPE, RGLRU_LONG_SHAPE):
        a, b = rglru_inputs(torch, shape, 7)
        t = time_kernel(torch, lambda: rg.rglru_scan(a, b),
                        "rglru_scan_kernel")
        t["plain_ms"] = cuda_ms(torch, lambda: ref.rglru_scan_ref(a, b),
                                iters=50 if shape[1] < 1024 else 3,
                                warmup=3)
        t["bound_ms"], t["bound_by"] = rglru_bound_ms(shape)
        times[shape] = t
        print(f"rglru_scan {shape[:3]} float32: kernel {t['ms']:.5f} ms back "
              f"to back (device {t['device_ms_alone']:.6f} ms, host enqueue "
              f"{t['host_enqueue_ms']:.6f} ms), plain {t['plain_ms']:.5f} ms, "
              f"bound {t['bound_ms']:.6f} ms ({t['bound_by']}); no single "
              "PyTorch call computes the recurrence")
    long = times[RGLRU_LONG_SHAPE]
    return {"name": "rglru_scan", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/rglru_scan.cu",
            "replaces": "src/repro/kernels/rglru_scan.py:40",
            "shape": list(RGLRU_MAIN_SHAPE[:3]), "dtype": "float32",
            "max_abs_err": worst[RGLRU_MAIN_SHAPE],
            "max_abs_err_all_shapes": max(worst.values()),
            **times[RGLRU_MAIN_SHAPE], "library_ms": None,
            "long": {"shape": list(RGLRU_LONG_SHAPE[:3]),
                     "max_abs_err": worst[RGLRU_LONG_SHAPE], **long}}


def gated_bound_ms(shape, dtype_name: str) -> tuple[float, str]:
    """Least time for one fused RG-LRU call: r_pre, i_pre, xc and gate_pre
    read and y written once in the inputs' dtype, lam (and h0 when given)
    read and the final state written once in fp32, at the HBM rate; against
    27 operations an element (two sigmoids, the gate's exp and
    multiplies, a·a, 1 -, clamp, sqrt, the scan's multiply and add, gelu
    with tanh and the gating product; a transcendental counts as one) at
    the fp32 rate outside the tensor cores."""
    B, S, W, with_h0 = shape
    esize = 4 if dtype_name == "float32" else 2
    n = B * S * W
    nbytes = 5 * n * esize + 4 * W + 4 * B * W * (1 + with_h0)
    return _bound(nbytes, 27.0 * n, "float32")


def gated_inputs(torch, shape, dtype, seed: int):
    """r_pre, i_pre, xc, gate_pre ~ N(0, 1) in ``dtype``, lam as
    ``init_rglru`` draws it (a in [0.9, 0.999] at r = 1) and h0 ~ N(0, 1)
    fp32 (or None), on the card."""
    B, S, W, with_h0 = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    ins = [torch.randn((B, S, W), generator=gen, device="cuda").to(dtype)
           for _ in range(4)]
    u = torch.rand((W,), generator=gen, device="cuda") * (
        0.999 ** 2 - 0.9 ** 2) + 0.9 ** 2
    lam = torch.log(torch.expm1(-torch.log(u) / 16.0))
    h0 = (torch.randn((B, W), generator=gen, device="cuda") if with_h0
          else None)
    return ins, lam, h0


def check_rglru_gated(torch, rg, ref) -> dict:
    """Phase 4, the fused RG-LRU: y and the final state against the plain
    version (gates, loop scan, gelu gating) in fp32 and bf16 on every shape
    of ``GATED_SHAPES``, the decode's from a non-zero h0; then the times of
    one call and of the plain version in fp32 at the prefill, decode and
    long shapes. Returns the kernel's record."""
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        tol = FP32_TOL if dtype == torch.float32 else BF16_TOL
        for i, shape in enumerate(GATED_SHAPES):
            ins, lam, h0 = gated_inputs(torch, shape, dtype, 400 + i)
            y, h = rg.rglru_gated_scan(*ins, lam, h0)
            want_y, want_h = ref.rglru_gated_scan_ref(*ins, lam, h0)
            torch.cuda.synchronize()
            worst[(shape, str(dtype))] = max(
                _compare("rglru_gated_scan", shape, dtype, y, want_y, tol),
                _compare("rglru_gated_scan state", shape, dtype, h, want_h,
                         FP32_TOL))
    times = {}
    for shape in (GATED_MAIN_SHAPE, GATED_DECODE_SHAPE, GATED_LONG_SHAPE):
        ins, lam, h0 = gated_inputs(torch, shape, torch.float32, 7)
        state = None if h0 is None else h0.clone()
        run = lambda: rg.rglru_gated_scan(*ins, lam, state, state)
        t = time_kernel(torch, run, "rglru_gated_scan_kernel")
        plain = lambda: ref.rglru_gated_scan_ref(*ins, lam, h0)
        long = shape[1] >= 1024
        t["plain_ms"] = cuda_ms(torch, plain, iters=3 if long else 50,
                                warmup=3)
        t["bound_ms"], t["bound_by"] = gated_bound_ms(shape, "float32")
        times[shape] = t
        print(f"rglru_gated_scan {shape} float32: kernel {t['ms']:.5f} ms "
              f"back to back (device {t['device_ms_alone']:.6f} ms, host "
              f"enqueue {t['host_enqueue_ms']:.6f} ms), plain "
              f"{t['plain_ms']:.5f} ms, bound {t['bound_ms']:.6f} ms "
              f"({t['bound_by']}); no single PyTorch call computes the "
              "recurrence")
    key = lambda shape: (shape, "torch.float32")
    return {"name": "rglru_gated_scan", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/rglru_scan.cu",
            "replaces": "src/repro/models/rglru.py:58 + "
                        "src/repro/kernels/rglru_scan.py:40",
            "shape": list(GATED_MAIN_SHAPE[:3]), "dtype": "float32",
            "max_abs_err": worst[key(GATED_MAIN_SHAPE)],
            "max_abs_err_all_shapes": max(worst.values()),
            **times[GATED_MAIN_SHAPE], "library_ms": None,
            "by_shape": {str(s): {"max_abs_err": worst[key(s)], **t}
                         for s, t in times.items() if s != GATED_MAIN_SHAPE}}


def _params(torch, cfg, dtype=None):
    """Weights from a seeded generator on the card, fp32 unless told."""
    from repro_torch.checkpoint import init_params
    gc.collect()                         # the last model's weights, if any
    torch.cuda.empty_cache()
    return init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                       dtype or torch.float32, device="cuda")


def _prompt(torch, cfg, prompt_len: int) -> dict:
    """One request's prefill inputs on the card: ``prompt_len`` tokens from
    a seeded generator, after ``num_patches`` patch embeddings for a vision
    model (both from ``data.pipeline.make_batch``)."""
    if cfg.frontend == "vision":
        from repro_torch.data.pipeline import InputShape, make_batch
        return make_batch(cfg, InputShape(
            "smoke", cfg.num_patches + prompt_len, 1, "prefill"), seed=0)
    return {"tokens": torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (1, prompt_len)), device="cuda")}


def check_full_model(torch, arch: str, fa, *, prompt_len: int = 32,
                     cache_len: int = 128, window: int = 0) -> int:
    """Phase 5: a full-width decoder, the kernel path against the plain
    path: prefill one prompt (with its patch prefix for a vision model),
    compare the logits, decode 8 greedy tokens from each (they must match)
    and time a prefill and a decode step. With ``window > 0`` both paths
    run ``window_override=window``, the kernel path from a ring cache of
    ``window`` slots and the plain one from the full cache masked to the
    window. Returns the flash kernel's launches in the kernel path's 6
    prefills (counted from 0), which must be the attention layers x 6."""
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
    batch = _prompt(torch, cfg, prompt_len)
    S = prompt_len + (cfg.num_patches if cfg.frontend == "vision" else 0)
    label = f"{arch} prefill(1x{S})" + (
        f" window_override={window}" if window else "")
    results = {}
    for use_kernels in (True, False):
        opts = M.ModelOptions(use_kernels=use_kernels, window_override=window,
                              ring_cache=use_kernels and window > 0)
        if use_kernels:
            fa.flash_attention.launches = 0
        logits, cache = steps.prefill_step(params, batch, cfg, opts,
                                           cache_len)
        first = logits
        tokens = []
        tok = torch.argmax(logits, -1)
        for i in range(8):
            tokens.append(int(tok[0]))
            logits, cache = steps.decode_step(
                params, cache, {"token": tok, "pos": S + i}, cfg, opts)
            tok = torch.argmax(logits, -1)
        torch.cuda.synchronize()
        # time one prefill and one decode step (host clock, synchronised)
        t0 = time.perf_counter()
        for _ in range(5):
            steps.prefill_step(params, batch, cfg, opts, cache_len)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) / 5 * 1e3
        if use_kernels:
            launches = fa.flash_attention.launches
        t0 = time.perf_counter()
        for _ in range(5):
            steps.decode_step(params, cache, {"token": tok, "pos": S + 8},
                              cfg, opts)
        torch.cuda.synchronize()
        decode_ms = (time.perf_counter() - t0) / 5 * 1e3
        results[use_kernels] = (first, tokens)
        cache_rows = cache[0]["k"].shape[1] if "k" in cache[0] else None
        print(f"{label} use_kernels={use_kernels}: {prefill_ms:.3f} ms; "
              f"decode step (B=1): {decode_ms:.3f} ms; greedy tokens "
              f"{tokens}" + (f"; cache rows {cache_rows}" if window else ""))
    (lk, tk), (lp, tp) = results[True], results[False]
    if lk.shape != (1, cfg.vocab_size) or not torch.isfinite(lk).all():
        fail(f"{label} logits: shape {tuple(lk.shape)} or non-finite values")
    diff = (lk - lp).abs().max().item()
    print(f"{label} logits, kernels vs plain: max |diff| {diff:.3e} "
          f"(tol {LOGIT_TOL})")
    if diff > LOGIT_TOL:
        fail(f"{label} logits differ by {diff:.3e}")
    if tk != tp:
        fail(f"{label} greedy tokens differ: kernels {tk} vs plain {tp}")
    want = expected_launches(cfg, "flash_attention", 6, 0)
    if launches != want:
        fail(f"{label}: flash launched {launches} times in 6 prefills; "
             f"expected {want}")
    del params, results, cache, logits, first
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def check_encoder(torch, arch: str, fa, frames: int = 500) -> int:
    """Phase 5, an encoder: ``forward_hidden`` over (1, frames, d_model)
    frame embeddings from ``data.pipeline.make_batch`` with the kernel
    against the plain path, the hidden states within ``LOGIT_TOL``, and
    each path timed. Returns the flash kernel's launches in one forward
    (counted from 0), which must be the attention layers."""
    from repro_torch.data.pipeline import InputShape, make_batch
    from repro_torch.models import model as M
    from repro_torch.models.config import get_config

    cfg = get_config(arch)
    params = _params(torch, cfg)
    batch = make_batch(cfg, InputShape("smoke", frames, 1, "prefill"), seed=0)
    hidden = {}
    for use_kernels in (True, False):
        opts = M.ModelOptions(use_kernels=use_kernels)
        fa.flash_attention.launches = 0
        with torch.no_grad():
            hidden[use_kernels], aux = M.forward_hidden(params, batch, cfg,
                                                        opts)
            torch.cuda.synchronize()
            if aux.item() != 0.0:
                fail(f"{arch}: MoE aux {aux.item()} of a model without MoE")
            if use_kernels:
                launches = fa.flash_attention.launches
            t0 = time.perf_counter()
            for _ in range(5):
                M.forward_hidden(params, batch, cfg, opts)
            torch.cuda.synchronize()
        print(f"{arch} forward_hidden(1x{frames}) use_kernels={use_kernels}: "
              f"{(time.perf_counter() - t0) / 5 * 1e3:.3f} ms")
    hk, hp = hidden[True], hidden[False]
    if hk.shape != (1, frames, cfg.d_model) or not torch.isfinite(hk).all():
        fail(f"{arch} hidden states: shape {tuple(hk.shape)} or non-finite")
    diff = (hk - hp).abs().max().item()
    print(f"{arch} hidden states, kernels vs plain: max |diff| {diff:.3e} "
          f"(tol {LOGIT_TOL})")
    if diff > LOGIT_TOL:
        fail(f"{arch} hidden states differ by {diff:.3e}")
    want = expected_launches(cfg, "flash_attention", 1, 0)
    if launches != want:
        fail(f"{arch}: flash launched {launches} times in one forward; "
             f"expected {want}")
    del params, hidden, hk, hp
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def _greedy(torch, steps, params, batch, cfg, opts, cache_len: int,
            S: int, forced=None):
    """Prefill ``batch`` and decode 8 tokens from it: greedy, or, with
    ``forced``, feeding those 8 tokens (teacher forcing). Returns (the
    prefill's and each step's logits, the 8 tokens fed, the cache)."""
    logits, cache = steps.prefill_step(params, batch, cfg, opts, cache_len)
    seen, fed = [logits], []
    for i in range(8):
        tok = (torch.argmax(logits, -1) if forced is None else
               torch.as_tensor(forced[i:i + 1], device=logits.device))
        fed.append(int(tok[0]))
        logits, cache = steps.decode_step(
            params, cache, {"token": tok, "pos": S + i}, cfg, opts)
        seen.append(logits)
    torch.cuda.synchronize()
    return seen, fed, cache


def _cast(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cast(v, dtype) for v in tree]
    return tree.to(dtype)


def _rel_rms(got, want) -> float:
    """rms(got - want) / rms(want) of two logit rows."""
    return ((got.float() - want.float()).square().mean()
            / want.float().square().mean()).sqrt().item()


def _hook_flash(errs: list, fault_call: int = -1):
    """Wrap ``kernels.ops.flash_attention``, the op the model calls, for
    one run: each call's output is held against the plain version in fp32
    on the same q, k, v, and its max |kernel - plain| / (1 + |plain|) is
    appended to ``errs``; call ``fault_call`` (counted from 0) first has
    its last ``FAULT_ROWS`` query rows zeroed, a planted fault. Returns the
    function that restores the op."""
    from repro_torch.kernels import ops, ref
    real = ops.flash_attention

    def run(q, k, v, *, causal=True, window=0):
        out = real(q, k, v, causal=causal, window=window)
        if len(errs) == fault_call:
            out = out.clone()
            out[:, -FAULT_ROWS:] = 0
        want = ref.flash_attention_ref(q.float(), k.float(), v.float(),
                                       causal=causal, window=window)
        errs.append(((out.float() - want).abs() / (1 + want.abs())).max()
                    .item())
        return out

    ops.flash_attention = run
    return lambda: setattr(ops, "flash_attention", real)


def _record_routing(seen: list):
    """Wrap ``models.moe._route`` for one run: each call's chosen experts,
    sorted per token, go to ``seen``. Returns the function that restores
    it."""
    from repro_torch.models import moe
    real = moe._route

    def run(router, x, cfg):
        probs, top_w, top_ids = real(router, x, cfg)
        seen.append(top_ids.sort(dim=-1).values.cpu())
        return probs, top_w, top_ids

    moe._route = run
    return lambda: setattr(moe, "_route", real)


def _routing_departures(a: list, b: list) -> tuple[int, int]:
    """(routed tokens whose chosen experts differ, routed tokens) between
    two runs' ``_record_routing`` lists."""
    differ = sum(int((x != y).any(dim=-1).sum()) for x, y in zip(a, b))
    return differ, sum(x.shape[0] for x in a)


def check_moe_witness(torch, fa, arch: str = "qwen3-moe-30b-a3b", *,
                      prompt_len: int = 32, cache_len: int = 128) -> int:
    """Phase 5, the witness for the bf16 MoE checks: ``arch`` at full width
    cut to ``MOE_WITNESS_LAYERS`` layers, so that it fits in fp32. Weights
    are drawn in bf16 and also widened to fp32, one model in both dtypes.
    In fp32 the kernel path is held against the plain path as every fp32
    model is: logits within ``LOGIT_TOL`` at the prefill and each of 8
    greedy steps, identical tokens. Then each bf16 path is fed the fp32
    tokens, and its logits' rms(diff) / rms(fp32) and its routed tokens
    whose experts differ from fp32's are printed: where the bf16 gap
    between the kernel and the plain path comes from. Returns the flash
    launches in the fp32 kernel path's prefill, which must be the layers."""
    import dataclasses

    from repro_torch.models import model as M
    from repro_torch.models import steps
    from repro_torch.models.config import get_config

    cfg = dataclasses.replace(get_config(arch), num_layers=MOE_WITNESS_LAYERS)
    params16 = _params(torch, cfg, torch.bfloat16)
    params32 = _cast(params16, torch.float32)
    batch = _prompt(torch, cfg, prompt_len)
    label = f"{arch} cut to {cfg.num_layers} layers, prefill(1x{prompt_len})"
    runs, routes = {}, {}
    for dtype, params in (("fp32", params32), ("bf16", params16)):
        for use_kernels in (True, False):
            opts = M.ModelOptions(use_kernels=use_kernels)
            forced = None if dtype == "fp32" else runs["fp32", True][1]
            routes[dtype, use_kernels] = []
            restore = _record_routing(routes[dtype, use_kernels])
            fa.flash_attention.launches = 0
            try:
                runs[dtype, use_kernels] = _greedy(
                    torch, steps, params, batch, cfg, opts, cache_len,
                    prompt_len, forced=forced)
            finally:
                restore()
            if dtype == "fp32" and use_kernels:
                launches = fa.flash_attention.launches   # decode runs none
    (lk, tk, _), (lp, tp, _) = runs["fp32", True], runs["fp32", False]
    diffs = [(a - b).abs().max().item() for a, b in zip(lk, lp)]
    print(f"{label} fp32, kernels vs plain: max |diff| by step "
          f"{[f'{d:.3e}' for d in diffs]} (tol {LOGIT_TOL}); greedy tokens "
          f"{tk}")
    if any(not torch.isfinite(a).all() for a in lk):
        fail(f"{label} fp32: non-finite logits")
    if max(diffs) > LOGIT_TOL:
        fail(f"{label} fp32 logits differ by {max(diffs):.3e}")
    if tk != tp:
        fail(f"{label} fp32 greedy tokens differ: kernels {tk} vs plain {tp}")
    if launches != cfg.num_layers:
        fail(f"{label}: flash launched {launches} times in a prefill; "
             f"expected {cfg.num_layers}")
    for use_kernels in (True, False):
        seen = runs["bf16", use_kernels][0]
        flips, routed = _routing_departures(routes["bf16", use_kernels],
                                            routes["fp32", True])
        print(f"{label} bf16 use_kernels={use_kernels} against fp32 "
              f"(teacher-forced): rms(diff) / rms(fp32) by step "
              f"{[f'{_rel_rms(a, b):.3e}' for a, b in zip(seen, lk)]}"
              f"; routed tokens whose experts differ from fp32's: {flips} "
              f"of {routed}")
    flips, routed = _routing_departures(routes["bf16", True],
                                        routes["bf16", False])
    gap = max(_rel_rms(a, b) for a, b in zip(runs["bf16", True][0],
                                                    runs["bf16", False][0]))
    print(f"{label} bf16, kernels vs plain: rms(diff) / rms(plain) "
          f"{gap:.3e}; routed tokens whose experts differ: {flips} of "
          f"{routed}")
    del params16, params32, runs
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def check_bf16_model(torch, arch: str, fa, *, prompt_len: int = 32,
                     cache_len: int = 128) -> int:
    """Phase 5, an MoE model at full width in bf16 (the weights would not
    fit the card in fp32): prefill one prompt and decode 8 greedy tokens on
    the kernel path, twice (the tokens and logits must be identical: the
    kernel path is deterministic); then the plain path fed the kernel
    path's 8 tokens (teacher forcing, since bf16 logits may legitimately
    part two greedy runs), its logits held against the kernel path's at the
    prefill and every step within ``BF16_LOGIT_TOL`` (abs + rel) and
    ``BF16_REL_RMS_TOL`` (rms(diff) / rms(plain)); each path's prefill
    and decode step timed, and peak memory printed beside the weights'
    bytes. Then the kernel path fed the same tokens twice more with each
    flash call of the model held against the plain version in fp32 on its
    own q, k, v within ``BF16_TOL``: once as it is (its logits must equal
    the first run's), once with a planted fault in the middle layer's
    flash output (``_hook_flash``), which both checks must see. Returns
    the flash kernel's launches in the kernel path's first 6 prefills
    (counted from 0), which must be the attention layers x 6."""
    from repro_torch.models import model as M
    from repro_torch.models import steps
    from repro_torch.models.config import get_config

    cfg = get_config(arch)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = _params(torch, cfg, torch.bfloat16)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in _leaves(params))
    weight_gb = sum(p.numel() * p.element_size()
                    for p in _leaves(params)) / 1e9
    print(f"{arch} full width: {n_params} parameters (bf16, {weight_gb:.2f} "
          f"GB) initialised in {time.perf_counter() - t0:.2f} s")
    batch = _prompt(torch, cfg, prompt_len)
    label = f"{arch} bf16 prefill(1x{prompt_len})"
    kernel_opts = M.ModelOptions(use_kernels=True)
    plain_opts = M.ModelOptions(use_kernels=False)
    fa.flash_attention.launches = 0
    runs = [_greedy(torch, steps, params, batch, cfg, kernel_opts, cache_len,
                    prompt_len)]
    timed = {}
    for name, opts in (("kernels", kernel_opts), ("plain", plain_opts)):
        t0 = time.perf_counter()
        for _ in range(5):
            steps.prefill_step(params, batch, cfg, opts, cache_len)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) / 5 * 1e3
        if name == "kernels":
            launches = fa.flash_attention.launches
        cache = runs[0][2]
        tok = torch.as_tensor(runs[0][1][-1:], device="cuda")
        t0 = time.perf_counter()
        for _ in range(5):
            steps.decode_step(params, cache, {"token": tok,
                                              "pos": prompt_len + 8},
                              cfg, opts)
        torch.cuda.synchronize()
        timed[name] = (prefill_ms, (time.perf_counter() - t0) / 5 * 1e3)
    runs.append(_greedy(torch, steps, params, batch, cfg, kernel_opts,
                        cache_len, prompt_len))
    tokens = runs[0][1]
    plain = _greedy(torch, steps, params, batch, cfg, plain_opts, cache_len,
                    prompt_len, forced=tokens)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for name, (p_ms, d_ms) in timed.items():
        print(f"{label} {name}: {p_ms:.3f} ms; decode step (B=1): "
              f"{d_ms:.3f} ms")
    print(f"{label}: greedy tokens (kernels) {tokens}; peak memory "
          f"{peak_gb:.2f} GB for {weight_gb:.2f} GB of weights")
    if runs[1][1] != tokens:
        fail(f"{label}: a second kernel-path run gave tokens {runs[1][1]}, "
             f"the first {tokens}")
    if any(not torch.equal(a, b) for a, b in zip(runs[0][0], runs[1][0])):
        fail(f"{label}: a second kernel-path run gave other logits")
    diffs, scaled, rel_rms = [], [], []
    for step, (lk, lp) in enumerate(zip(runs[0][0], plain[0])):
        if lk.shape != (1, cfg.vocab_size) or not torch.isfinite(lk).all():
            fail(f"{label} step {step}: logits of shape {tuple(lk.shape)} or "
                 "non-finite")
        err = (lk - lp).abs()
        diffs.append(err.max().item())
        scaled.append((err / (1 + lp.abs())).max().item())
        rel_rms.append(_rel_rms(lk, lp))
        if bool((err > BF16_LOGIT_TOL * (1 + lp.abs())).any()):
            fail(f"{label} step {step}: kernel and plain logits differ by "
                 f"{diffs[-1]:.3e} (tol {BF16_LOGIT_TOL} abs + rel)")
    agree = sum(int(torch.argmax(lp, -1)[0]) == t
                for lp, t in zip(plain[0][:8], tokens))
    print(f"{label} logits, kernels vs plain (teacher-forced): max |diff| "
          f"by step {[f'{d:.3e}' for d in diffs]}, max |diff| / (1 + |plain|)"
          f" {max(scaled):.3e} (tol {BF16_LOGIT_TOL}), rms(diff) / "
          f"rms(plain) by step {[f'{r:.3e}' for r in rel_rms]} (tol "
          f"{BF16_REL_RMS_TOL}); the plain path's argmax is the "
          f"kernel path's token at {agree} of 8 steps; the kernel path is "
          "deterministic (two runs, identical tokens and logits)")
    if max(rel_rms) > BF16_REL_RMS_TOL:
        fail(f"{label}: kernel and plain logits differ by rms(diff) / "
             f"rms(plain) {max(rel_rms):.3e} (tol {BF16_REL_RMS_TOL})")
    layers = expected_launches(cfg, "flash_attention", 1, 0)
    calls, faulted = [], []
    restore = _hook_flash(calls)
    try:
        checked = _greedy(torch, steps, params, batch, cfg, kernel_opts,
                          cache_len, prompt_len, forced=tokens)
    finally:
        restore()
    restore = _hook_flash(faulted, fault_call=layers // 2)
    try:
        fault = _greedy(torch, steps, params, batch, cfg, kernel_opts,
                        cache_len, prompt_len, forced=tokens)
    finally:
        restore()
    fault_rms = [_rel_rms(a, b) for a, b in zip(fault[0], plain[0])]
    at = layers // 2
    print(f"{label}: the model's {len(calls)} flash calls against the plain "
          f"version in fp32 on their own q, k, v: max |diff| / (1 + |plain|)"
          f" {max(calls):.3e} (tol {BF16_TOL}); control, the last "
          f"{FAULT_ROWS} rows of call {at} zeroed: that call "
          f"{faulted[at]:.3e}, the others "
          f"{max(faulted[:at] + faulted[at + 1:]):.3e}; its logits' "
          f"rms(diff) / rms(plain) by step "
          f"{[f'{r:.3e}' for r in fault_rms]} (tol {BF16_REL_RMS_TOL})")
    if len(calls) != layers or max(calls) > BF16_TOL:
        fail(f"{label}: {len(calls)} flash calls in a prefill, max |diff| / "
             f"(1 + |plain|) {max(calls):.3e} against the plain version")
    if any(not torch.equal(a, b) for a, b in zip(checked[0], runs[0][0])):
        fail(f"{label}: holding each flash call against the plain version "
             "changed the kernel path's logits")
    if faulted[at] <= BF16_TOL:
        fail(f"{label}: the per-call check did not see the planted fault")
    if max(fault_rms) <= BF16_REL_RMS_TOL:
        fail(f"{label}: the bound {BF16_REL_RMS_TOL} on rms(diff) / "
             f"rms(plain) did not see the planted fault "
             f"({max(fault_rms):.3e})")
    want = expected_launches(cfg, "flash_attention", 6, 0)
    if launches != want:
        fail(f"{label}: flash launched {launches} times in 6 prefills; "
             f"expected {want}")
    del params, runs, plain, cache, checked, fault
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def expected_launches(cfg, kernel: str, prefills: int,
                      decode_steps: int) -> int:
    """Launches of ``kernel`` in ``prefills`` prefills and ``decode_steps``
    decode steps of ``cfg``: one per layer whose mixer the kernel carries,
    in each prefill and, for a kernel that decode runs too, in each step."""
    mixers, in_decode = KERNEL_MIXERS[kernel]
    layers = sum(1 for mixer, _ in cfg.layer_kinds if mixer in mixers)
    return layers * (prefills + (decode_steps if in_decode else 0))


def _counting_engine():
    """A subclass of the continuous-batching engine that keeps the prefills
    and decode steps it ran before each ``reset_stats`` (``serve()`` resets
    them after its warmup request), and the list of its instances."""
    from repro_torch.serving import ContinuousBatchingEngine

    class CountingEngine(ContinuousBatchingEngine):
        built = []

        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            self.before_reset = {"prefills": 0, "decode_steps": 0}
            CountingEngine.built.append(self)

        def reset_stats(self) -> None:
            for k in self.before_reset:
                self.before_reset[k] += self.stats[k]
            super().reset_stats()

        def totals(self) -> dict:
            return {k: v + self.stats[k] for k, v in self.before_reset.items()}

    return CountingEngine


def serve_path(torch, arch: str, wrappers: dict) -> dict:
    """Phase 6 for one model: serve it at full width with every launch
    count set to 0 just before and read just after, check each count
    against the prefills and decode steps the engine ran (warmup included),
    and plan the H100 fleet again from the measured rates. An fp32 model
    goes through ``serve()``; a bf16 one (``BF16_ARCHS``) through an engine
    built here on bf16 weights and ``serve``'s second half,
    ``measure_and_plan``. Returns the counts."""
    from repro_torch.core.gpu_catalog import (plan_gpu_fleet,
                                              streams_from_measured)
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models.config import get_config

    engine_cls = _counting_engine()
    plain_cls = serve_mod.ContinuousBatchingEngine
    serve_mod.ContinuousBatchingEngine = engine_cls
    try:
        if arch in BF16_ARCHS:
            eng = engine_cls(get_config(arch), _params(
                torch, get_config(arch), torch.bfloat16), max_slots=8,
                cache_len=128)
            torch.cuda.synchronize()
        for fn in wrappers.values():
            fn.launches = 0
        t0 = time.perf_counter()
        if arch in BF16_ARCHS:
            report = serve_mod.measure_and_plan(eng, n_streams=4, fps=2,
                                                seconds=3)
            del eng
        else:
            report = serve_mod.serve(arch, reduced=False, n_streams=4, fps=2,
                                     seconds=3, engine="continuous")
        torch.cuda.synchronize()
        counts = {name: fn.launches for name, fn in wrappers.items()}
        wall = time.perf_counter() - t0
    finally:
        serve_mod.ContinuousBatchingEngine = plain_cls
    ran = engine_cls.built[-1].totals()
    engine_cls.built.clear()             # free the served model's weights
    print(json.dumps(report, sort_keys=True))
    print(f"serve {arch} wall time {wall:.2f} s; launches {counts}; engine "
          f"ran {ran['prefills']} prefills and {ran['decode_steps']} decode "
          "steps, warmup included")
    frames = report["frames_served"]
    if frames <= 0:
        fail(f"{arch}: served no frames")
    if report["serving_report"]["requests"] != frames:
        fail(f"{arch}: engine request count disagrees with frames served")
    # every served frame is one prefill, plus the one warmup request that
    # serve() runs before it resets the stats
    if ran["prefills"] != frames + 1:
        fail(f"{arch}: {ran['prefills']} prefills for {frames} frames and "
             "one warmup request")
    cfg = get_config(arch)
    for name, got in counts.items():
        want = expected_launches(cfg, name, ran["prefills"],
                                 ran["decode_steps"])
        if got != want:
            fail(f"{arch}: {name} launched {got} times; expected {want} for "
                 f"{ran['prefills']} prefills and {ran['decode_steps']} "
                 "decode steps")
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
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def profile_serving(torch, arch: str, wrappers: dict) -> dict:
    """Phase 7: one drain of 8 frame requests on a full-width model, timed
    without and then with ``torch.profiler``; from the traced run, the
    device's busy time (sum of kernel intervals on its one stream), its idle
    share of the wall time, and device time by kernel. A port kernel's time
    per call is the time of every device kernel named after it (the SSD
    scan launches two to four per call) over its wrapper's calls in the
    traced drain. For an MoE model a second traced drain, with each step
    of ``models.moe`` in a ``record_function`` range, gives the device time
    by MoE step against that drain's own busy time; the idle share, as for
    every model, is the first (unannotated) drain's."""
    from repro_torch.models.config import get_config
    from repro_torch.serving import ContinuousBatchingEngine, StreamSimulator

    cfg = get_config(arch)
    params = _params(torch, cfg,
                     torch.bfloat16 if arch in BF16_ARCHS else None)
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
    before = {name: fn.launches for name, fn in wrappers.items()}
    prof, wall_traced = _traced_drain(torch, eng)
    by_name = _device_kernels(torch, prof)
    busy_ms = sum(v[0] for v in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    per_call, port = {}, {}
    for kernel, fn in wrappers.items():
        calls = fn.launches - before[kernel]
        hits = {k: v for k, v in by_name.items() if f"{kernel}_kernel" in k}
        per_call[kernel] = (sum(v[0] for v in hits.values()) / calls
                            if hits and calls else None)
        port.update({k[:90]: (round(v[0], 4), v[1]) for k, v in hits.items()})
    out = {"arch": arch, "requests": 8, "wall_ms": wall_plain * 1e3,
           "wall_traced_ms": wall_traced * 1e3,
           "device_busy_ms": busy_ms if by_name else None,
           "device_idle_share": (1 - busy_ms / (wall_traced * 1e3))
           if by_name else None,
           "device_ms_per_call": per_call,
           "port_kernels_ms": port,
           "top_device_kernels_ms": [(k[:80], round(v[0], 4), v[1])
                                     for k, v in top]}
    if cfg.num_experts:
        sim.tick(streams)
        restore = _label_moe_parts(torch)
        try:
            prof, wall_labelled = _traced_drain(torch, eng)
        finally:
            restore()
        labelled_busy = sum(v[0] for v in _device_kernels(torch, prof)
                            .values())
        out["moe_drain"] = {"wall_traced_ms": wall_labelled * 1e3,
                            "device_busy_ms": labelled_busy}
        out["moe_device_ms"] = _moe_device_ms(torch, prof, labelled_busy)
    print(f"serving profile (8 requests, full {arch}): " + json.dumps(out))
    del eng, sim, params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _traced_drain(torch, eng):
    """Drain ``eng`` under ``torch.profiler``. Returns (the profile, the
    drain's wall seconds)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.drain()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return prof, wall


def _device_kernels(torch, prof) -> dict:
    """Device kernels of a profile by name: [ms, calls]."""
    by_name: dict[str, list] = {}
    for e in prof.events():
        # a record_function range also shows on the device's timeline, as a
        # span over its kernels: not a kernel of its own
        if e.device_type == torch.autograd.DeviceType.CUDA and not (
                e.is_user_annotation or e.name in MOE_PARTS.values()):
            rec = by_name.setdefault(e.name, [0.0, 0])
            rec[0] += e.time_range.elapsed_us() / 1e3
            rec[1] += 1
    return by_name


MOE_PARTS = {"_route": "moe.route", "_aux_loss": "moe.route",
             "_slots": "moe.route", "_dispatch": "moe.dispatch",
             "_experts": "moe.experts", "_combine": "moe.combine"}


def _label_moe_parts(torch):
    """Wrap each step of ``models.moe`` (routing, dispatch, the experts'
    products, combine) in a ``record_function`` range named after it, for
    one traced drain; returns the function that restores them."""
    from repro_torch.models import moe

    plain = {name: getattr(moe, name) for name in MOE_PARTS}

    def labelled(fn, label):
        def run(*args, **kw):
            with torch.profiler.record_function(label):
                return fn(*args, **kw)
        return run

    for name, label in MOE_PARTS.items():
        setattr(moe, name, labelled(plain[name], label))
    return lambda: [setattr(moe, n, f) for n, f in plain.items()]


def _moe_device_ms(torch, prof, busy_ms: float) -> dict:
    """Device time under each MoE range of a traced drain (the kernels its
    ops launched), its share of the device's busy time, and the part of
    ``moe.experts`` that its ``aten::bmm`` calls (the expert products)
    take."""
    totals: dict[str, float] = {}
    bmm_ms = 0.0
    for e in prof.events():
        if e.name in MOE_PARTS.values() and \
                e.device_type == torch.autograd.DeviceType.CPU:
            totals[e.name] = totals.get(e.name, 0.0) + \
                e.device_time_total / 1e3
            if e.name == "moe.experts":
                bmm_ms += sum(c.device_time_total for c in e.cpu_children
                              if c.name == "aten::bmm") / 1e3
    out = {k: {"ms": v, "share_of_busy": v / busy_ms}
           for k, v in sorted(totals.items())}
    out["expert bmm"] = {"ms": bmm_ms, "share_of_busy": bmm_ms / busy_ms}
    return out


def check_vgg(torch) -> dict:
    """Phase 8: VGG16 and ZF at 224 px with the reference's 512-wide head
    and 1000 classes, weights from a seeded generator: the card's logits
    (fp32, TF32 off) against the same model on the CPU with the same
    weights, within ``FP32_TOL`` absolute plus relative, at batch 1 and 8;
    frames/s by CUDA events, and the achieved TFLOP/s from
    ``flops_per_frame`` against the fp32 peak; then bf16 weights and
    frames, timed, and their logits' largest deviation from fp32."""
    from repro_torch.models import vgg

    def to(tree, **kw):
        return {k: [{n: t.to(**kw) for n, t in p.items()} for p in v]
                for k, v in tree.items()}

    report = {}
    for net, layout in (("vgg16", vgg.VGG16_LAYOUT), ("zf", vgg.ZF_LAYOUT)):
        cpu = vgg.init_convnet(layout, torch.Generator().manual_seed(0),
                               input_hw=VGG_HW, device="cpu")
        params = to(cpu, device="cuda")
        params16 = to(params, dtype=torch.bfloat16)
        flops = vgg.flops_per_frame(layout, VGG_HW)
        for batch in (1, 8):
            x = torch.as_tensor(np.random.default_rng(batch).standard_normal(
                (batch, VGG_HW, VGG_HW, 3)), dtype=torch.float32)
            xc, x16 = x.to("cuda"), x.to("cuda", torch.bfloat16)
            with torch.no_grad():
                want = vgg.apply_convnet(cpu, x, layout)
                got = vgg.apply_convnet(params, xc, layout)
                got16 = vgg.apply_convnet(params16, x16, layout)
                torch.cuda.synchronize()
                err = _compare(f"{net} logits, card vs CPU",
                               (batch, VGG_HW, VGG_HW, 3), torch.float32,
                               got.cpu(), want, FP32_TOL)
                if got.shape != (batch, 1000):
                    fail(f"{net}: logits of shape {tuple(got.shape)}")
                if not torch.isfinite(got16).all():
                    fail(f"{net} bf16: non-finite logits")
                dev16 = (got16.float() - got).abs().max().item()
                ms = cuda_ms(torch, lambda: vgg.apply_convnet(
                    params, xc, layout), iters=30, warmup=5)
                ms16 = cuda_ms(torch, lambda: vgg.apply_convnet(
                    params16, x16, layout), iters=30, warmup=5)
            rec = {"flops_per_frame": flops, "max_abs_err_vs_cpu": err,
                   "fp32_ms": ms, "fp32_frames_per_s": batch / ms * 1e3,
                   "fp32_tflops": flops * batch / ms / 1e9,
                   "fp32_peak_share": flops * batch / ms / 1e9 / 67.0,
                   "bf16_ms": ms16, "bf16_frames_per_s": batch / ms16 * 1e3,
                   "bf16_tflops": flops * batch / ms16 / 1e9,
                   "bf16_max_abs_dev_from_fp32": dev16,
                   "logit_max_abs": want.abs().max().item()}
            report[f"{net} batch {batch}"] = rec
            print(f"{net} {VGG_HW} px batch {batch}: {flops / 1e9:.4f} "
                  f"GFLOP a frame; fp32 {ms:.4f} ms = "
                  f"{rec['fp32_frames_per_s']:.1f} frames/s, {rec['fp32_tflops']:.2f} TFLOP/s "
                  f"({rec['fp32_peak_share']:.3f} of 67); bf16 {ms16:.4f} ms "
                  f"= {rec['bf16_frames_per_s']:.1f} frames/s, "
                  f"{rec['bf16_tflops']:.2f} TFLOP/s, max |bf16 - fp32| "
                  f"{dev16:.3e} (logits up to {rec['logit_max_abs']:.3e})")
    return report


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
                "ssd_scan": ssd.ssd_scan, "rglru_scan": rg.rglru_scan,
                "rglru_gated_scan": rg.rglru_gated_scan}

    # 3-4) each kernel against its plain version, and its times
    records = {"flash_attention": check_flash(torch, fa, ref),
               "ssd_scan": check_ssd(torch, ssd, ref),
               "rglru_scan": check_rglru(torch, rg, ref),
               "rglru_gated_scan": check_rglru_gated(torch, rg, ref)}

    # 5) full-width models, kernel path against the plain path; the flash
    # launches of the paths no served model runs are kept by path
    model_paths = {}
    for arch in SERVED:
        if arch not in BF16_ARCHS:
            check_full_model(torch, arch, fa)
    for arch in ("nemotron-4-15b", "internvl2-1b"):
        model_paths[f"{arch} prefill x6 (phase 5)"] = check_full_model(
            torch, arch, fa, cache_len=512)
    model_paths[f"yi-9b window_override={YI_WINDOW} ring prefill x6 "
                "(phase 5)"] = check_full_model(
        torch, "yi-9b", fa, prompt_len=YI_WINDOW_PROMPT, cache_len=512,
        window=YI_WINDOW)
    model_paths["hubert-xlarge forward_hidden (phase 5)"] = check_encoder(
        torch, "hubert-xlarge", fa)
    model_paths[f"qwen3-moe-30b-a3b {MOE_WITNESS_LAYERS} layers fp32 "
                "prefill (phase 5)"] = check_moe_witness(torch, fa)
    for arch in BF16_ARCHS:
        model_paths[f"{arch} bf16 prefill x6 (phase 5)"] = check_bf16_model(
            torch, arch, fa)

    # 8) the paper's analysis programs
    vgg_report = check_vgg(torch)

    # 6) the main paths: serve, then plan from the measured rates; a kernel
    # on two paths records the sum of its served launches and each path's
    # count, the phase-5 paths' too (not in the sum)
    for rec in records.values():
        rec["launches"], rec["launches_by_path"] = 0, {}
    records["flash_attention"]["launches_by_path"].update(model_paths)
    for arch in SERVED:
        counts = serve_path(torch, arch, wrappers)
        for name, n in counts.items():
            records[name]["launches"] += n
            records[name]["launches_by_path"][arch] = n

    # 7) where the time goes on the serving paths (after the counts are
    # read); a kernel's device_ms is its time a call on its first path
    for arch, kernels in SERVED.items():
        prof = profile_serving(torch, arch, wrappers)
        for name in kernels:
            per_call = prof["device_ms_per_call"][name]
            records[name].setdefault("device_ms", per_call)
            records[name].setdefault("device_ms_by_path", {})[arch] = per_call
    print(json.dumps({"vgg": vgg_report}))
    print(card, flush=True)
    print(json.dumps({"kernels": list(records.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

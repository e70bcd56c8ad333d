#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one Hopper GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (non-zero exit, no ``ok`` line):

1. Require a CUDA device of compute capability >= 9.0; print the card's
   name and power limit as ``nvidia-smi`` reports them.
2. Build the CUDA kernels (flash attention and its backward, SSD chunked
   scan, RG-LRU: the scan and the fused gates-and-scan form, one source;
   the grouped MoE expert products; the split-TF32 dense product) from
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
   and one with T > S and a window; then olmo-1b's training shape (8, 256,
   16, 128) causal with the log-sum-exp, the output within fp32 1e-4 and
   the lse within ``LSE_TOL``. The fp32 shapes of at least 64 query rows
   and 96 items of 32 rows run the long-query design
   (``flash_attention_kernel_f32_rows``; two more T < S shapes, one with
   64-row items, for its blind rows), the smaller ones and bf16 the others
   (``fa.design`` names each, printed beside its error). Each forward
   instantiation's registers and spills from nvcc's report (a spill fails)
   and its shared memory against the wrapper's ``smem_bytes`` /
   ``smem_bytes_rows``. At each model path's
   shape (olmo-1b, recurrentgemma-9b, yi-9b, nemotron-4-15b, internvl2-1b,
   hubert-xlarge and olmo-1b's training forward with lse), time the kernel
   issued back to back
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
   hidden states within 1e-3 (and its MoE aux 0), and one traced forward
   whose 48 flash kernels must all be the long-query design.
   qwen3-moe-30b-a3b at
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
   ``launch.serve.measure_and_plan``. Every decode step after the warmup
   must replay the engine's CUDA graph (``decode_graph_share`` 1). Every
   kernel's launch count is set to 0 just before each run and read just
   after; where the model's decode step launches a port kernel (the fused
   RG-LRU), which a replay runs without calling its wrapper, the run is
   profiled from the engine's construction on and the counts are the calls
   that ran on the card, by the trace. Each must equal (the
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
   share, and device time by kernel (each port kernel's per call that ran
   on the card, summed over the device kernels it launches; the calls are
   counted in the trace, since a replayed decode step calls no wrapper,
   and printed beside the kernel's layers x the drain's prefills and, for
   the fused RG-LRU, decode steps; the fused RG-LRU kernel is
   named ``rglru_gated_scan_kernel`` in the trace; every flash kernel of a
   served drain must be the 32-token prefill's design, never the
   long-query one). For the MoE model, a
   second traced drain with each step of ``models.moe`` (routing,
   dispatch, the experts, combine) in a ``record_function`` range: the
   device time under each step and the expert ``bmm``s' part; that drain
   decodes eagerly, the engine's CUDA graph set aside, since a replay runs
   no Python for a range to label. The idle
   share is the unannotated drain's, for every model.
8. The paper's analysis programs, VGG16 and ZF, at 224 px (reference
   head: 512 wide, 1000 classes), batch 1 and 8, weights from a seeded
   generator: the card's fp32 logits against the same model on the CPU
   within 1e-4 (absolute plus relative); frames/s (CUDA events),
   ``flops_per_frame`` and TFLOP/s against the 67 TFLOP/s fp32 peak; bf16
   timed too, with its largest deviation from fp32. One ``{"vgg": ...}``
   line.
9. Training. (a) The flash backward kernel (built in phase 2 from
   ``csrc/flash_attention_bwd.cu``) against its plain version in fp32 and
   bf16 at olmo-1b's training shape (8, 256, 16, 128), yi-9b's GQA (2,
   256, 32, 128, K = 4), internvl2-1b's (2, 288, 14, 64, K = 2), hd 256
   MQA with a window of 128 at S = 512, hubert-xlarge's non-causal (1,
   500, 16, 80) and a ragged causal S = 37 at hd 32: dq, dk, dv within
   fp32 1e-4 / bf16 2e-2, the forward's lse within 1e-4 of the plain
   log-sum-exp, every output finite, two runs bit-equal, and a control
   (dv with a key tile zeroed) that must fail the comparison; each of the
   10 instantiations' registers and spills from nvcc's report (a spill
   fails) and its shared memory against the wrapper's ``smem_bytes_bwd``;
   at olmo-1b's shape, in fp32 and in bf16, its times (back to back,
   device alone by kernel, host enqueue, the plain version, the bound and
   its share), the forward with lse (back to back, device alone, its
   bound) and, as a yardstick only, ``scaled_dot_product_attention``'s
   forward and backward device times in the same dtype. (b)
   Full-width olmo-1b in fp32 (batch 8 × 256, remat), the served models
   freed: each gradient leaf at the first step, kernels against plain;
   the main path ``launch.train.train`` for 4 steps with every count set
   to 0 just before and read just after (exactly 32 flash forwards and 16
   backwards a step, nothing else), then 4 steps with
   ``use_kernels=False`` from the same weights and batches (loss and
   grad_norm by step); step time, tokens/s and peak memory beside the
   18.8 GB of state; one step profiled (busy, idle share, device time by
   kernel group; its 32 flash forwards must all be the long-query
   design); the train state through the port's checkpoint and back,
   equal. (c) ``ops.ssd_scan``, ``ops.rglru_scan`` and
   ``ops.rglru_gated_scan`` refuse CUDA inputs that require grad.
10. No phase: the host-only port of the resource manager, the simulator's
   golden days and the observability benchmarks need no card, and the
   tier-1 tests hold them to the reference bit for bit, also with ``jax``
   and ``repro`` blocked (``tests/test_torch_manager.py``,
   ``tests/test_torch_golden_ledgers.py``, ``tests/test_torch_obs*.py``,
   ``tests/test_torch_imports.py``).
11. The fleet simulator (``repro_torch.sim``) with ``jax`` and ``repro``
   absent from ``sys.modules``: a ``rush_hour`` day of 108 streams capped
   by ``ServiceCalibration.from_engine`` over phase 6's olmo-1b engine
   (every tick within the sum of its streams' frame-rate caps, no more
   frames than the uncalibrated day) and the calibration's rates planned
   on the H100 catalog. A card line, then one ``{"sim": ...}`` line.
12. The observability loop (``repro_torch.obs``) on the card, with ``jax``
   and ``repro`` absent from ``sys.modules``: two continuous-batching
   engines on one set of full-width fp32 olmo-1b weights, the kernels on,
   one per region (us-east-1: 4 ``nyc`` cameras; ap-northeast-1: 4
   ``tokyo`` ones) at 2 frames/s, profiled, then 10
   windows in which each region's cameras enqueue 16 s of frames (a frame
   each, every half second), its engine drains and a
   ``RegionalRecalibratingPolicy`` over REPAIR decides, with
   an ``EngineWindowProbe`` over both engines' ``windowed_rates()``, a
   ``hub_with_exporters`` hub and a ``Tracer``; at window 4 ap-northeast-1
   steps to 16 cameras. Only that region may fire, within ``hold_ticks`` +
   1 windows, its re-profile and repair scoped to its streams, one
   adaptive event flagged ``recalibration`` (a forced replan),
   ``camera_region_groups`` equal to the probe's groups, both exports
   round-tripping, and the flash launches, counted from 0, 16 a prefill of
   the two engines (warmup included). Each window's per-region
   ``rel_error``, the ``replan.wall_ms`` p50/p99, a card line, then one
   ``{"obs": ...}`` line.
13. The distributed layer (``launch.mesh``, ``launch.sharding``, the
   sharded MoE forms, ``launch.dryrun``), with ``jax`` and ``repro`` absent
   from ``sys.modules``. A default process group of one NCCL rank over a
   ``FileStore`` and ``make_smoke_mesh()`` on the card. (a) The main path:
   phase 9's full-width olmo-1b training through ``launch.train.train(...,
   mesh=...)``, the state and batches DTensors placed by the sharding rules,
   4 steps with every launch count set to 0 just before and read just after
   (32 flash forwards and 16 backwards a step, through the local-heads
   boundary of ``layers._heads_local``, nothing else), then the same steps from
   the same weights without the mesh: each step's loss and grad_norm within
   ``TRAIN_REL_TOL``; again at 2 microbatches (``batch_axes`` the data
   axes) for 2 steps against the unmeshed 2-microbatch run; each run's host
   seconds a step (the DTensor dispatch's cost shows there). (b) One
   qwen3-moe-30b-a3b MoE layer at its published widths in bf16 (1.2 GB of
   experts), capacity factor 8, T = 32 and 128: ``apply_moe_local``, the
   ``expert_shard_constraint`` path and ``apply_moe_shard_map`` on the mesh
   against the global dispatch, within bf16 2e-2, aux within 1e-6; the
   process group destroyed. (c) On the host, in subprocesses started
   together, each with a timeout: ``python -m repro_torch.launch.dryrun``
   for olmo-1b and qwen3-moe-30b-a3b at ``decode_32k`` and olmo-1b at
   ``train_4k`` on ``pod1`` (a fake process group of 256 ranks, meta
   tensors): per-device FLOPs, bytes, collective counts, trace seconds;
   then ``plan_gpu_fleet`` over phase 6's measured olmo-1b rates without
   and with the records (the per-token FLOPs, $/hour and instances of
   each). A card line, then one ``{"dist": ...}`` line.
14. The paper's loop through both launchers, with ``jax`` and ``repro``
   absent: (a) ``python -m repro_torch.launch.dryrun`` for olmo-1b at
   ``decode_32k`` on ``pod1`` into a temporary directory D, in a
   subprocess with a timeout; ``LLMStream.requirement(D)`` must carry the
   record's per-token FLOPs (per-device FLOPs × 256 / 128), not the closed
   form's. (b) ``serve("olmo-1b", reduced=False, dryrun_dir=D)`` on the
   card (phase 6's traffic), every launch count set to 0 just before and
   read just after: 24 frames, flash 16 a prefill × 25 prefills; the
   report's three plans must equal ``plan_gpu_fleet`` of its measured
   rates with D; the model freed. (c) ``python -m repro_torch.launch.serve
   --arch olmo-1b --full --dryrun-dir D`` on the card in a subprocess with
   a timeout: 24 frames and its plans held the same way. Each plan's
   $/hour and instances printed with the closed form's beside them; a
   card line, then one ``{"loop": ...}`` line.
15. granite-4.0-h-small at full width in fp32 (18 of its 72 experts held,
   47.3 GB), weights from a seeded generator on the card, through
   ``ContinuousBatchingEngine`` with the kernels on, at its benchmark
   cell's shapes: 16 frames of 576 tokens, 8 answered each, in 16 slots of
   640, under ``torch.profiler``. Every decode step must replay the
   engine's CUDA graph, which calls no wrapper; the kernels' calls that ran
   on the card, counted in the trace: the grouped expert kernels
   (``csrc/moe_experts.cu``) once a layer in every prefill and decode step
   (40 layers), the SSD kernel in the 36 Mamba-2 layers and flash in the 4
   attention layers of every prefill, nothing else; and the split-TF32
   dense product (``csrc/dense_gemm.cu``) ``DENSE_PER_PREFILL`` wrapper
   calls a prefill, its kernels in the trace within ``DENSE_TRACE_MISS``
   below that (phase 16). The grouped product's
   first call at each shape (the drain's prefill of 576 tokens with the
   large tiles; the decode step's 16 with the small ones, from one eager
   step on the drain's last state, since a replay calls no wrapper) is
   kept, inputs and all, and the kernels held
   against ``ref.moe_experts_ref`` on them within ``MOE_TOL`` of the
   largest |output|; there they are timed (back to back, device alone by
   kernel, host enqueue, the plain version) beside their bound.
16. The split-TF32 dense product (``csrc/dense_gemm.cu``): at 576 rows and
   each (K, N) of ``DENSE_SHAPES`` (every dense product of the three
   serving cells' prefills), seeded x ~ N(0, 1) and w ~ N(0, 0.02²), the
   kernel's largest error against an fp64 product must be at most twice
   its plain version's (``ref.dense_gemm_ref``, fp32 ``x @ w`` on cuBLAS);
   a product the route declines (the router's N of 72) is timed on cuBLAS
   only. Each is timed (CUDA events, device alone by the profiler, host
   enqueue, the plain version) beside its bound (three TF32 passes at 495
   TFLOP/s, or the bytes of x, w and the output). Then olmo-1b and
   mamba2-2.7b at full width in fp32 through ``ContinuousBatchingEngine``:
   ``DENSE_FRAMES`` frames of 576 tokens each, under ``torch.profiler``;
   the kernel's wrapper calls must be ``DENSE_PER_PREFILL`` x the prefills
   and its kernels in the trace no more, and fewer by at most
   ``DENSE_TRACE_MISS`` (a long process's trace has dropped records)
   (granite-4.0-h-small's are counted so in phase 15's drain), and the
   engine's ``dense_kernel_share`` 1.
17. Print ``{"kernels": [...]}`` on one line (a kernel's ``launches`` sums
   its calls that ran on the card on its main paths, served, trained, the
   observability loop's, the meshed training's, phase 14's serve and phase
   15's: its wrapper's calls, or, on a path whose replayed decode steps
   launch it, its calls counted in the trace; ``launches_by_path``
   also holds the phase-5 paths; the grouped expert kernels' record is
   phase 15's, the dense product's phase 16's with phase 15's launches),
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
sys.path[:0] = [os.path.join(ROOT, "src"), os.path.join(ROOT, "portbench")]
from metrics import counts as pb_counts  # noqa: E402  (portbench's)
from metrics import peaks as pb_peaks  # noqa: E402

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
# olmo-1b's training forward (batch 8 × 256), timed and held with its lse
TRAIN_FLASH_SHAPE = (8, 256, 16, 128, 16, 256, True, 0)
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
    (2, 64, 32, 64, 4, 48, True, 0),       # T < S, long-query design
    (2, 160, 16, 64, 4, 100, True, 0),     # T < S: 60 blind rows, 2 KV tiles
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
               "hubert-xlarge hd80": HUBERT_FLASH_SHAPE,
               "olmo-1b train, with lse": TRAIN_FLASH_SHAPE}
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
                 "rglru_gated_scan": (("rglru",), True),
                 "flash_attention_bwd": ((), False)}   # training only
# the device kernel that one call of each port kernel's wrapper launches,
# as a trace names it, and how many of them a call launches (the SSD scan's
# first kernel, once whatever else the call launches; the grouped expert
# products' gated and plain forms)
CALL_KERNELS = {"flash_attention": ("flash_attention_kernel_", 1),
                "flash_attention_bwd": ("flash_attention_bwd_dq", 1),
                "ssd_scan": ("ssd_scan_kernel_prep", 1),
                "rglru_scan": ("rglru_scan_kernel", 1),
                "rglru_gated_scan": ("rglru_gated_scan_kernel", 1),
                "moe_experts": ("moe_grouped_kernel", 2),
                "dense_gemm": ("dense_gemm_kernel", 1)}
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
# the training phase (9): the flash backward's shapes (B, S, H, hd, K,
# causal, window; T == S), olmo-1b's training shape first
BWD_MAIN_SHAPE = (8, 256, 16, 128, 16, True, 0)
BWD_SHAPES = [
    BWD_MAIN_SHAPE,
    (2, 256, 32, 128, 4, True, 0),         # yi-9b: 8-way GQA
    (2, 288, 14, 64, 2, True, 0),          # internvl2-1b: 7-way GQA
    (1, 512, 16, 256, 1, True, 128),       # hd 256 MQA, window 128
    (1, 500, 16, 80, 16, False, 0),        # hubert-xlarge: encoder, hd 80
    (2, 37, 4, 32, 2, True, 0),            # ragged causal at hd 32
]
# lse against the plain log-sum-exp, abs + rel: both are fp32 sums of the
# same scores (the bf16 products are exact in fp32), in other orders
LSE_TOL = 1e-4
TRAIN_ARCH, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = "olmo-1b", 8, 256, 4
# kernels against plain, full-width olmo-1b in fp32: each step's loss and
# grad_norm, |a - b| / |b|. Both paths sum in fp32 in other orders through
# 16 layers, forward and backward (expected ~1e-5); a gradient lost at the
# attention layers moves the loss by far more by step 2
TRAIN_REL_TOL = 1e-4
# each gradient leaf at the first step, ‖g_kernels − g_plain‖ / ‖g_plain‖:
# the same fp32 reordering, compounded through 16 layers' backward
# (expected ~1e-5); a wrong or missing wq/wk/wv gradient reads ~1
GRAD_REL_TOL = 1e-3
VGG_HW = 224                    # the canonical VGG16/ZF frame size
YI_WINDOW = 128                 # window_override of yi-9b's long-prompt check
YI_WINDOW_PROMPT = 300
# phase 11: a rush_hour day of 108 streams, 24 h, seed 0 (the golden
# days' configuration), capped by the rates phase 6 measured
SIM_STREAMS, SIM_HOURS, SIM_SEED = 108, 24.0, 0
SIM_CALIBRATED_ARCH = "olmo-1b"  # phase 6's engine whose rates cap a day
# phase 12, the observability loop on the card: two regions, each one
# olmo-1b engine serving its cameras at 2 frames/s (32-token prompts, 8 new
# tokens, as phase 6); at window OBS_STEP_AT the drifted region's load steps
# from 4 to 16 cameras
OBS_DRIFTED_REGION = "ap-northeast-1"
OBS_REGIONS = (("us-east-1", "nyc"), (OBS_DRIFTED_REGION, "tokyo"))
OBS_CAMERAS, OBS_LOADED_CAMERAS, OBS_FPS = 4, 16, 2.0
# seconds of frames a window enqueues: a healthy window's drain varies by
# ±20% on the card's host at 2 s and by ±11% at 8 s (PERF.md §6)
OBS_WINDOW_S = 16.0
OBS_PROFILE_WINDOWS, OBS_WINDOWS, OBS_STEP_AT = 3, 10, 4
OBS_PATH = "olmo-1b obs loop, two regions (phase 12)"
# phase 13, the distributed layer: phase 9's training on a 1x1 NCCL mesh
# (4 steps; 2 more at 2 microbatches), one qwen3-moe-30b-a3b MoE layer at its
# published widths in bf16 with ample capacity (so no form drops a token),
# and the dry run's records on this machine's host
DIST_PATH = "olmo-1b train, 1×1 NCCL mesh (phase 13)"
DIST_MB_PATH = "olmo-1b train, 2 microbatches, 1×1 NCCL mesh (phase 13)"
DIST_MB_STEPS = 2
DIST_MOE_ARCH, DIST_MOE_TOKENS, DIST_MOE_CF = "qwen3-moe-30b-a3b", (32, 128), 8.0
DIST_AUX_TOL = 1e-6
DIST_DRYRUN = (("olmo-1b", "decode_32k"), ("qwen3-moe-30b-a3b", "decode_32k"),
               ("olmo-1b", "train_4k"))
DIST_DRYRUN_TIMEOUT_S = 300
# phase 14, the paper's loop through both launchers: the dry run's record,
# then full-width olmo-1b served with it in this process and from the
# command line in another
LOOP_ARCH = "olmo-1b"
LOOP_PATH = "olmo-1b serve --dryrun-dir (phase 14)"
LOOP_SERVE_TIMEOUT_S = 600
STRATEGIES = ("per-stream", "uniform-big", "packed")
# phase 15, granite-4.0-h-small at full width in fp32 (18 of its 72 experts
# held, 47.3 GB of weights) at its benchmark cell's shapes: 576-token frames
# answered with 8 tokens in 16 slots of 640, one wave of 16 frames
GRANITE_ARCH = "granite-4.0-h-small"
GRANITE_PATH = "granite-4.0-h-small serve (phase 15)"
GRANITE_FRAMES, GRANITE_PROMPT, GRANITE_NEW = 16, 576, 8
GRANITE_SLOTS, GRANITE_CACHE = 16, 640
# the grouped expert kernels against their plain version, of the largest
# |output|: fp32 sums of 4,096 and 768 products in another order (the
# card's first reading, against torch._grouped_mm, was 2.0e-6)
MOE_TOL = 1e-5
# phase 16, the split-TF32 dense product: (K, N) of every dense product of
# the serving cells' prefills (olmo-1b's q/k/v/o, SwiGLU up and down;
# mamba2-2.7b's in_proj and out_proj; granite-4.0-h-small's in_proj,
# out_proj, attention q/o and k/v, shared expert up and down, router), at
# 576 rows; and the products a 576-token prefill puts on the kernel: 7 a
# layer in olmo-1b, 2 in mamba2-2.7b, in granite 2 a Mamba-2 layer, 4 an
# attention layer and 3 a shared expert (the router's N of 72 is declined)
DENSE_SHAPES = [(2048, 2048), (2048, 8192), (8192, 2048), (2560, 10576),
                (5120, 2560), (4096, 16768), (8192, 4096), (4096, 4096),
                (4096, 1024), (4096, 1536), (1536, 4096), (4096, 72)]
DENSE_ROWS = 576
DENSE_PER_PREFILL = {"olmo-1b": 16 * 7, "mamba2-2.7b": 64 * 2,
                     GRANITE_ARCH: 36 * 2 + 4 * 4 + 40 * 3}
DENSE_FRAMES = 8
DENSE_TRACE_MISS = 0.01
DENSE_PATH = "{arch} 576-token frames (phase 16)"


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
    per: dict[str, float] = {}
    for k, v in by_name.items():         # instantiations whose names share
        per[k[:90]] = per.get(k[:90], 0.0) + v / calls    # 90 chars: summed
    return sum(by_name.values()) / calls, per


def _bound(nbytes: float, flops: float, dtype_name: str) -> tuple[float, str]:
    """portbench's ``counts.bound_s`` in ms, and which of the two binds."""
    t = pb_counts.bound_s(flops, nbytes, dtype_name)
    return t * 1e3, ("bytes" if t == nbytes / pb_peaks.HBM_BYTES_PER_S
                     else "operations")


def attention_bound_ms(shape, dtype_name: str) -> tuple[float, str]:
    """Least time for one attention call (``counts.attention_fwd``)."""
    B, S, H, hd, K, T, causal, window = shape
    flops, nbytes = pb_counts.attention_fwd(B, S, H, hd, K, T, causal,
                                            window, dtype_name)
    return _bound(nbytes, flops, dtype_name)


def attention_bwd_bound_ms(shape, dtype_name: str) -> tuple[float, str]:
    """Least time for one flash backward (``counts.attention_bwd``)."""
    flops, nbytes = pb_counts.attention_bwd(*shape, dtype_name)
    return _bound(nbytes, flops, dtype_name)


def ssd_bound_ms(shape, dtype_name: str) -> tuple[float, str]:
    """Least time for one SSD scan (``counts.ssd_scan``); its arithmetic is
    fp32 whatever the inputs' type."""
    flops, nbytes = pb_counts.ssd_scan(*shape, dtype_name)
    return _bound(nbytes, flops, "float32")


def _within(got, want, tol: float) -> bool:
    """|got - want| <= tol + tol·|want| everywhere, and got finite."""
    err = (got.float() - want.float()).abs()
    return bool(got.isfinite().all()) and not bool(
        (err > tol + tol * want.float().abs()).any())


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
    ptxas = fwd_ptxas(torch)
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
            worst[(shape, str(dtype))] = _compare(
                f"flash_attention {fa.design(B, S, H, dtype)}", shape, dtype,
                got, want, tol)
            if T < S and dtype == torch.float32:
                # query head h reads KV head h // (H / K)
                blind = v.mean(dim=1, keepdim=True).repeat_interleave(
                    H // K, dim=2).expand(-1, S - T, -1, -1)
                blind_err = (got[:, :S - T] - blind).abs().max().item()
                if blind_err > FP32_TOL:
                    fail(f"T < S rows are not mean(v): {blind_err:.3e}")
    # the training forward, with the log-sum-exp the backward reads
    B, S, H, hd, K, T, causal, window = TRAIN_FLASH_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(99)
    q, k, v = (torch.randn(s, generator=gen, device="cuda")
               for s in ((B, S, H, hd), (B, T, K, hd), (B, T, K, hd)))
    lse = torch.empty((B, H, S), dtype=torch.float32, device="cuda")
    got = fa.flash_attention(q, k, v, causal=causal, window=window, lse=lse)
    want, want_lse = ref.flash_attention_fwd_ref(q, k, v, causal=causal,
                                                 window=window)
    torch.cuda.synchronize()
    worst[(TRAIN_FLASH_SHAPE, "torch.float32")] = _compare(
        f"flash_attention {fa.design(B, S, H, q.dtype)}", TRAIN_FLASH_SHAPE,
        q.dtype, got, want, FP32_TOL)
    lse_err = _compare("flash_attention lse", TRAIN_FLASH_SHAPE, q.dtype,
                       lse, want_lse, LSE_TOL)

    # time at each path's shape, in the dtype the path runs in
    times = {shape: time_flash(torch, fa, ref, shape,
                               lse=shape == TRAIN_FLASH_SHAPE)
             for shape in FLASH_TIMED.values()}
    times_bf16 = {key: time_flash(torch, fa, ref, shape, torch.bfloat16)
                  for key, shape in FLASH_TIMED_BF16.items()}
    rec = {"name": "flash_attention", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
           "replaces": "src/repro/kernels/flash_attention.py:70",
           "shape": list(MAIN_SHAPE[:6]), "dtype": "float32",
           "max_abs_err": worst[(MAIN_SHAPE, "torch.float32")],
           "max_abs_err_all_shapes": max(worst.values()),
           "design": fa.design(*MAIN_SHAPE[:3], torch.float32),
           **times[MAIN_SHAPE], "ptxas": ptxas}
    for key, shape in FLASH_TIMED.items():
        if shape != MAIN_SHAPE:
            rec[key] = {"shape": list(shape[:6]), "causal": shape[6],
                        "window": shape[7], "dtype": "float32",
                        "design": fa.design(*shape[:3], torch.float32),
                        "max_abs_err": worst[(shape, "torch.float32")],
                        **times[shape]}
            if (shape, "torch.bfloat16") in worst:
                rec[key]["max_abs_err_bf16"] = worst[(shape,
                                                      "torch.bfloat16")]
    rec["olmo-1b train, with lse"]["lse_max_abs_err"] = lse_err
    for key, shape in FLASH_TIMED_BF16.items():
        rec[key] = {"shape": list(shape[:6]), "causal": shape[6],
                    "window": shape[7], "dtype": "bfloat16",
                    "design": fa.design(*shape[:3], torch.bfloat16),
                    "max_abs_err": worst[(shape, "torch.bfloat16")],
                    **times_bf16[key]}
    return rec


def time_flash(torch, fa, ref, shape, dtype=None, lse: bool = False) -> dict:
    """The kernel, its plain version and ``scaled_dot_product_attention`` (a
    yardstick only, with each KV head expanded onto its query heads) at one
    shape whose window, if any, is >= T, in ``dtype`` (fp32 by default), by
    CUDA events; with ``lse`` the kernel also writes the log-sum-exp (as in
    training) and the plain version is ``flash_attention_fwd_ref``."""
    B, S, H, hd, K, T, causal, window = shape
    dtype = dtype or torch.float32
    gen = torch.Generator(device="cuda").manual_seed(7)
    q, k, v = (torch.randn(s, generator=gen, device="cuda").to(dtype)
               for s in ((B, S, H, hd), (B, T, K, hd), (B, T, K, hd)))
    lse_out = (torch.empty((B, H, S), dtype=torch.float32, device="cuda")
               if lse else None)
    run = lambda: fa.flash_attention(q, k, v, causal=causal, window=window,
                                     lse=lse_out)
    plain = ref.flash_attention_fwd_ref if lse else ref.flash_attention_ref
    ms = cuda_ms(torch, run)
    host_ms = host_enqueue_ms(torch, run)
    dev_ms, _ = device_ms(torch, run, "flash_attention_kernel")
    plain_ms = cuda_ms(torch, lambda: plain(q, k, v, causal=causal,
                                            window=window))
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
    print(f"flash_attention {fa.design(B, S, H, dtype)} {shape} {dtype_name}"
          f"{' with lse' if lse else ''}: kernel {ms:.5f} ms back "
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
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with torch.no_grad():
            M.forward_hidden(params, batch, cfg, M.ModelOptions())
        torch.cuda.synchronize()
    designs = _flash_designs(_device_kernels(torch, prof))
    want_design = fa.design(1, frames, cfg.num_heads, torch.float32)
    if designs != {want_design: want}:
        fail(f"{arch}: a traced forward's flash kernels are {designs}; want "
             f"{want_design} {want}")
    print(f"{arch} forward_hidden, traced: flash kernels {designs}")
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
    them after its warmup request), and the list of its instances; its
    ``on_built``, if set, runs once each engine is built."""
    from repro_torch.serving import ContinuousBatchingEngine

    class CountingEngine(ContinuousBatchingEngine):
        built = []
        on_built = None                  # called once an engine is built

        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            self.before_reset = {"prefills": 0, "decode_steps": 0}
            CountingEngine.built.append(self)
            if CountingEngine.on_built is not None:
                CountingEngine.on_built()

        def reset_stats(self) -> None:
            for k in self.before_reset:
                self.before_reset[k] += self.stats[k]
            super().reset_stats()

        def totals(self) -> dict:
            return {k: v + self.stats[k] for k, v in self.before_reset.items()}

    return CountingEngine


def serve_path(torch, arch: str, wrappers: dict, dryrun_dir=None) -> tuple:
    """Phase 6 for one model: serve it at full width with every launch
    count set to 0 just before and read just after, check each count
    against the prefills and decode steps the engine ran (warmup included),
    and plan the H100 fleet again from the measured rates. Every decode
    step after the warmup must replay the engine's CUDA graph. Where the
    model's decode step launches a port kernel, a replay runs it without
    calling the wrapper: that run is profiled from the engine's
    construction on, and its counts are the calls that ran on the card, by
    the trace (``_device_calls``). An fp32 model
    goes through ``serve()`` (with ``dryrun_dir``, phase 14); a bf16 one
    (``BF16_ARCHS``) through an engine built here on bf16 weights and
    ``serve``'s second half, ``measure_and_plan``. Returns the counts, for
    ``SIM_CALIBRATED_ARCH`` the served engine's ``ServiceCalibration``
    (phase 11's cap; None for the other models), and the report."""
    from repro_torch.core.gpu_catalog import (plan_gpu_fleet,
                                              streams_from_measured)
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models.config import get_config
    from repro_torch.sim import ServiceCalibration

    engine_cls = _counting_engine()
    traced = any(KERNEL_MIXERS[name][1] for name in SERVED[arch])
    prof = _profiler() if traced else None
    engine_cls.on_built = prof.start if traced else None
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
                                     seconds=3, dryrun_dir=dryrun_dir,
                                     engine="continuous")
        torch.cuda.synchronize()
        calls = {name: fn.launches for name, fn in wrappers.items()}
        wall = time.perf_counter() - t0
    finally:
        serve_mod.ContinuousBatchingEngine = plain_cls
        if traced and engine_cls.built:
            prof.stop()
    counts = _device_calls(torch, prof, wrappers) if traced else calls
    ran = engine_cls.built[-1].totals()
    calibration = (ServiceCalibration.from_engine(engine_cls.built[-1])
                   if arch == SIM_CALIBRATED_ARCH else None)
    engine_cls.built.clear()             # free the served model's weights
    print(json.dumps(report, sort_keys=True))
    print(f"serve {arch} wall time {wall:.2f} s; launches {counts}"
          + (f" by the trace, wrapper calls {calls}" if traced else "")
          + f"; engine ran {ran['prefills']} prefills and "
          f"{ran['decode_steps']} decode steps, warmup included")
    frames = report["frames_served"]
    if frames <= 0:
        fail(f"{arch}: served no frames")
    if report["serving_report"]["requests"] != frames:
        fail(f"{arch}: engine request count disagrees with frames served")
    share = report["serving_report"]["decode_graph_share"]
    if share != 1.0:
        fail(f"{arch}: {share} of the decode steps replayed the engine's "
             "CUDA graph; expected all")
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
    return counts, calibration, report


def profile_serving(torch, arch: str, wrappers: dict) -> dict:
    """Phase 7: one drain of 8 frame requests on a full-width model, timed
    without and then with ``torch.profiler``; from the traced run, the
    device's busy time (sum of kernel intervals on its one stream), its idle
    share of the wall time, and device time by kernel. Each port kernel's
    calls that ran on the card, by the trace (``_device_calls``: the decode
    steps replay the engine's CUDA graph and call no wrapper), printed
    beside its layers x the drain's prefills (and decode steps, for the
    fused RG-LRU), which phases 6 and 15 check; its time per call is the
    time of every device kernel named after it (the SSD scan launches two
    to four per call) over those calls. For an MoE model a second traced drain, with each step of
    ``models.moe`` in a ``record_function`` range, gives the device time by
    MoE step against that drain's own busy time; it decodes eagerly, the
    engine's graph set aside, since a replay runs no Python for a range to
    label (the kernels are the same). The idle share, as for every model,
    is the first (unannotated) drain's."""
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
    before = dict(eng.stats)
    prof, wall_traced, _ = _traced_drain(torch, eng)
    prefills = eng.stats["prefills"] - before["prefills"]
    decode_steps = eng.stats["decode_steps"] - before["decode_steps"]
    device_calls = _device_calls(torch, prof, wrappers)
    by_name = _device_kernels(torch, prof)
    busy_ms = sum(v[0] for v in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    from repro_torch.kernels.flash_attention import design
    flash = _flash_designs(by_name)
    want = design(1, 32, cfg.num_heads, torch.bfloat16
                  if arch in BF16_ARCHS else torch.float32)  # the prefills
    if set(flash) - {want}:
        fail(f"{arch}: the drain's flash kernels are {flash}; its 32-token "
             f"prefills take {want} only")
    per_call, port = {}, {}
    expected = {kernel: expected_launches(cfg, kernel, prefills,
                                          decode_steps)
                for kernel in device_calls}
    for kernel, calls in device_calls.items():
        hits = {k: v for k, v in by_name.items() if f"{kernel}_kernel" in k}
        per_call[kernel] = (sum(v[0] for v in hits.values()) / calls
                            if hits and calls else None)
        port.update({k[:90]: (round(v[0], 4), v[1]) for k, v in hits.items()})
    out = {"arch": arch, "requests": 8, "wall_ms": wall_plain * 1e3,
           "wall_traced_ms": wall_traced * 1e3,
           "device_busy_ms": busy_ms if by_name else None,
           "device_idle_share": (1 - busy_ms / (wall_traced * 1e3))
           if by_name else None,
           "device_calls": device_calls, "expected_calls": expected,
           "device_ms_per_call": per_call,
           "port_kernels_ms": port, "flash_designs": flash,
           "top_device_kernels_ms": [(k[:80], round(v[0], 4), v[1])
                                     for k, v in top]}
    if cfg.num_experts:
        sim.tick(streams)
        graph, eng._decode_graph = eng._decode_graph, None
        restore = _label_moe_parts(torch)
        try:
            prof, wall_labelled, _ = _traced_drain(torch, eng)
        finally:
            restore()
            eng._decode_graph = graph
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


def _profiler():
    """A ``torch.profiler`` of the host and the card."""
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def _traced_drain(torch, eng):
    """Drain ``eng`` under ``torch.profiler``. Returns (the profile, the
    drain's wall seconds, the requests it answered)."""
    with _profiler() as prof:
        t0 = time.perf_counter()
        done = eng.drain()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return prof, wall, done


def _device_calls(torch, prof, names) -> dict:
    """Calls of each port kernel in ``names`` that ran on the card, by a
    profile: its device kernels named as ``CALL_KERNELS`` says, over those
    one call launches. A decode step replayed from an engine's CUDA graph
    runs its kernels without calling their wrappers, so they count here and
    not in a wrapper's ``launches``."""
    by_name = _device_kernels(torch, prof)
    out = {}
    for name in names:
        marker, per_call = CALL_KERNELS[name]
        n = sum(calls for k, (_, calls) in by_name.items() if marker in k)
        if n % per_call:
            fail(f"{name}: {n} device kernels {marker}, not {per_call} a "
                 "call")
        out[name] = n // per_call
    return out


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


def _flash_designs(by_name: dict) -> dict:
    """Calls of each flash forward design among a profile's device kernels
    by name (``_device_kernels``): {"f32" | "f32_rows" | "bf16": calls}."""
    import re
    out: dict[str, int] = {}
    for name, (_, calls) in by_name.items():
        m = re.search(r"flash_attention_kernel_(f32_rows|f32|bf16)<", name)
        if m:
            out[m.group(1)] = out.get(m.group(1), 0) + calls
    return out


MOE_PARTS = {"_route": "moe.route", "_expert_stats": "moe.route",
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


def _ptxas(name: str, pattern: str, key) -> dict:
    """Registers and spill bytes of each kernel of ``csrc/<name>.cu``, from
    the compiler's ``-Xptxas -v`` report of the build: {group: {kernel:
    [registers, spill bytes]}}, ``key`` mapping the match of ``pattern`` in
    a kernel's mangled name to (group, kernel)."""
    import re

    from repro_torch.kernels import _build
    log = _build.library_path(name).with_suffix(".log")
    found, cur = {}, None
    for line in log.read_text().splitlines():
        m = re.search(pattern, line)
        if "Compiling entry" in line:
            cur = key(m) if m else None
        elif cur is not None:
            rec = found.setdefault(cur[0], {}).setdefault(cur[1], [0, 0])
            if (r := re.search(r"Used (\d+) registers", line)):
                rec[0] = int(r.group(1))
            if (r := re.search(r"(\d+) bytes spill stores, (\d+) bytes "
                               r"spill loads", line)):
                rec[1] = int(r.group(1)) + int(r.group(2))
    return found


# (B, S, H) query arrays whose forward takes each design and row count
FWD_SMEM_CASES = {"f32": (1, 32, 16), "f32_rows32": (1, 288, 14),
                  "f32_rows64": (8, 256, 16)}


def fwd_ptxas(torch) -> dict:
    """Phase 3: each forward instantiation's registers and spill bytes (the
    f32 and bf16 kernels and f32_rows at 32 and 64 rows an item, at each
    head dim). Fails if a kernel spills, or if the shared memory of the
    block the built library launches differs from what the wrapper's
    ``smem_bytes`` / ``smem_bytes_rows`` say for ``design``'s and
    ``rows_per_item``'s choice."""
    from repro_torch.kernels import flash_attention as fa
    by_hd = _ptxas("flash_attention",
                   r"flash_attention_kernel_(f32_rows|f32|bf16)ILi(\d+)E"
                   r"(?:Li(\d+)E)?",
                   lambda m: (int(m[2]), m[1] + (m[3] or "")))
    kinds = sorted(["bf16", *FWD_SMEM_CASES])
    if sorted(by_hd) != sorted(fa.HEAD_DIMS) or any(
            sorted(ks) != kinds for ks in by_hd.values()):
        fail(f"flash_attention: the ptxas report lists {by_hd}, not "
             f"{kinds} at each head dim")
    for hd, ks in sorted(by_hd.items()):
        smem = {}
        for kind, (B, S, H) in [("bf16", (1, 32, 16)),
                                *FWD_SMEM_CASES.items()]:
            dtype = torch.bfloat16 if kind == "bf16" else torch.float32
            design = fa.design(B, S, H, dtype)
            want = (fa.smem_bytes_rows(hd, fa.rows_per_item(B, S, H))
                    if design == "f32_rows" else fa.smem_bytes(hd, dtype))
            built = fa.built_smem_bytes(hd, B, S, H, dtype)
            if built != want or not kind.startswith(design):
                fail(f"flash_attention {kind} hd {hd}: the kernel uses "
                     f"{built} B of shared memory for {(B, S, H)}, the "
                     f"wrapper says {want} ({design})")
            smem[kind] = built
        print(f"ptxas flash_attention hd {hd}: " + ", ".join(
            f"{k} {r} registers {sp} B spilled, {smem[k]} B shared"
            for k, (r, sp) in sorted(ks.items())))
        if any(sp for _, sp in ks.values()):
            fail(f"flash_attention hd {hd} spills: {ks}")
    return {f"hd{hd}": ks for hd, ks in sorted(by_hd.items())}


def bwd_ptxas(torch) -> dict:
    """Phase 9a: each backward instantiation's registers and spill bytes
    (the Δ, dkdv and dq kernels at each dtype and head dim), read from the
    compiler's ``-Xptxas -v`` report of the build. Fails if a kernel
    spills, or if the built kernels' shared memory differs from what the
    wrapper's ``smem_bytes_bwd`` says."""
    from repro_torch.kernels import flash_attention as fa
    found = _ptxas("flash_attention_bwd",
                   r"flash_attention_bwd_(delta|dkdv|dq)I(f|13__nv_bfloat16)"
                   r"Li(\d+)E",
                   lambda m: (("float32" if m[2] == "f" else "bfloat16",
                               int(m[3])), m[1]))
    if len(found) != 2 * len(fa.HEAD_DIMS) or any(
            len(k) != 3 for k in found.values()):
        fail(f"flash_attention_bwd: the ptxas report lists {sorted(found)}, "
             "not the 10 instantiations of 3 kernels")
    for (dtype, hd), ks in sorted(found.items()):
        smem = fa.smem_bytes_bwd(hd, getattr(torch, dtype))
        built = fa.built_smem_bytes_bwd(hd, getattr(torch, dtype))
        print(f"ptxas flash_attention_bwd {dtype} hd {hd}: " + ", ".join(
            f"{k} {r} registers {sp} B spilled"
            for k, (r, sp) in sorted(ks.items())) +
            f"; shared memory {built} B")
        if any(sp for _, sp in ks.values()):
            fail(f"flash_attention_bwd {dtype} hd {hd} spills: {ks}")
        if built != smem:
            fail(f"flash_attention_bwd {dtype} hd {hd}: the kernel uses "
                 f"{built} B of shared memory, smem_bytes_bwd says {smem}")
    return {f"{d} hd{h}": ks for (d, h), ks in sorted(found.items())}


def time_flash_bwd(torch, fa, ref, dtype) -> dict:
    """Phase 9a: at olmo-1b's training shape in ``dtype``, the backward's
    time back to back, alone on the device (by kernel) and its host
    enqueue; the forward with lse back to back and alone, and its bound;
    the plain backward; the bound; and, as a yardstick only,
    ``scaled_dot_product_attention``'s forward and backward."""
    B, S, H, hd, K, causal, window = BWD_MAIN_SHAPE
    name = str(dtype)[6:]
    gen = torch.Generator(device="cuda").manual_seed(7)
    q, do = (torch.randn((B, S, H, hd), generator=gen,
                         device="cuda").to(dtype) for _ in range(2))
    k, v = (torch.randn((B, S, K, hd), generator=gen,
                        device="cuda").to(dtype) for _ in range(2))
    lse = torch.empty((B, H, S), dtype=torch.float32, device="cuda")
    fwd = lambda: fa.flash_attention(q, k, v, causal=causal, window=window,
                                     lse=lse)
    o = fwd()
    run = lambda: fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                         window=window)
    ms = cuda_ms(torch, run, iters=50, warmup=5)
    host_ms = host_enqueue_ms(torch, run, iters=50, warmup=5)
    dev_ms, per_kernel = device_ms(torch, run, "flash_attention_bwd",
                                   calls=20)
    fwd_lse_ms = cuda_ms(torch, fwd, iters=50, warmup=5)
    fwd_dev_ms, _ = device_ms(torch, fwd, "flash_attention_kernel", calls=20)
    fwd_bound_ms, fwd_bound_by = attention_bound_ms(
        (B, S, H, hd, K, S, causal, window), name)
    plain_ms = cuda_ms(torch, lambda: ref.flash_attention_bwd_ref(
        q, k, v, o, lse, do, causal=causal, window=window), iters=10,
        warmup=2)
    bound_ms, bound_by = attention_bwd_bound_ms(BWD_MAIN_SHAPE, name)
    sdpa = sdpa_fwd_bwd_ms(torch, q, k, v, do)
    print(f"flash_attention_bwd {BWD_MAIN_SHAPE} {name}: kernel {ms:.5f} ms "
          f"back to back (device {dev_ms:.6f} ms: "
          f"{json.dumps({k[:60]: round(t, 6) for k, t in per_kernel.items()})}"
          f"; host enqueue {host_ms:.6f} ms), plain {plain_ms:.5f} ms, bound "
          f"{bound_ms:.6f} ms ({bound_by}), {bound_ms / dev_ms:.1%} of it; "
          f"the forward with lse {fwd_lse_ms:.5f} ms back to back, "
          f"{fwd_dev_ms:.6f} device, bound {fwd_bound_ms:.6f} ms "
          f"({fwd_bound_by}); sdpa (yardstick) {json.dumps(sdpa)}")
    return {"ms": ms, "device_ms_alone": dev_ms,
            "device_ms_by_kernel": per_kernel, "host_enqueue_ms": host_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": sdpa["backward_device_ms"],
            "library_fwd_bwd_ms": sdpa["fwd_bwd_ms"],
            "forward_with_lse_ms": fwd_lse_ms,
            "forward_with_lse_device_ms": fwd_dev_ms,
            "forward_bound_ms": fwd_bound_ms,
            "library_forward_device_ms": sdpa["forward_device_ms"]}


def check_flash_bwd(torch, fa, ref) -> dict:
    """Phase 9a: the flash backward kernel against its plain version at
    ``BWD_SHAPES`` in fp32 and bf16 (dq, dk, dv within fp32 1e-4 / bf16
    2e-2: fp32 sums in other orders; in bf16 the kernel rounds P and dS to
    bf16 before the products that take them, the plain version computes
    in fp32 from the same bf16 inputs, and both round their outputs once),
    the forward's lse against the plain log-sum-exp, every output finite,
    two runs bit-equal, and a control: dv with one key tile zeroed must
    fail the same comparison. Each instantiation's registers and spills
    (none allowed). Times at olmo-1b's training shape in fp32 and bf16.
    Returns the kernel's record for the final JSON line."""
    ptxas = bwd_ptxas(torch)
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        tol = FP32_TOL if dtype == torch.float32 else BF16_TOL
        for i, shape in enumerate(BWD_SHAPES):
            B, S, H, hd, K, causal, window = shape
            gen = torch.Generator(device="cuda").manual_seed(300 + i)
            q, do = (torch.randn((B, S, H, hd), generator=gen,
                                 device="cuda").to(dtype) for _ in range(2))
            k, v = (torch.randn((B, S, K, hd), generator=gen,
                                device="cuda").to(dtype) for _ in range(2))
            lse = torch.empty((B, H, S), dtype=torch.float32, device="cuda")
            o = fa.flash_attention(q, k, v, causal=causal, window=window,
                                   lse=lse)
            _, lse_ref = ref.flash_attention_fwd_ref(q, k, v, causal=causal,
                                                     window=window)
            if not _within(lse, lse_ref, LSE_TOL):
                fail(f"flash lse {shape} {dtype}: max |err| "
                     f"{(lse - lse_ref).abs().max().item():.3e}")
            got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                         window=window)
            again = fa.flash_attention_bwd(q, k, v, o, lse, do,
                                           causal=causal, window=window)
            want = ref.flash_attention_bwd_ref(q, k, v, o, lse, do,
                                               causal=causal, window=window)
            torch.cuda.synchronize()
            errs = [_compare(f"flash_attention_bwd d{n}", shape, dtype, g, w,
                             tol) for n, g, w in zip("qkv", got, want)]
            if not all(torch.equal(g, a) for g, a in zip(got, again)):
                fail(f"flash_attention_bwd {shape} {dtype}: two runs differ")
            planted = got[2].clone()
            planted[:, :32] = 0                      # the first key tile
            if _within(planted, want[2], tol):
                fail(f"flash_attention_bwd {shape} {dtype}: the control "
                     "(dv with its first key tile zeroed) passed the check")
            worst[(shape, str(dtype))] = max(errs)
    print("flash_attention_bwd: every shape within tolerance, bit-equal on "
          "repeat; each control (a zeroed key tile of dv) failed the check")

    # times at olmo-1b's training shape
    t32 = time_flash_bwd(torch, fa, ref, torch.float32)
    t16 = time_flash_bwd(torch, fa, ref, torch.bfloat16)
    return {"name": "flash_attention_bwd", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
            "replaces": "src/repro/kernels/flash_attention.py:70",
            "differentiates": "src/repro/kernels/ref.py:13",
            "shape": list(BWD_MAIN_SHAPE[:5]), "causal": True,
            "dtype": "float32",
            "max_abs_err": worst[(BWD_MAIN_SHAPE, "torch.float32")],
            "max_abs_err_all_shapes": max(worst.values()),
            **t32,
            "bf16": {"max_abs_err": worst[(BWD_MAIN_SHAPE,
                                           "torch.bfloat16")], **t16},
            "ptxas": ptxas}


def sdpa_fwd_bwd_ms(torch, q, k, v, do) -> dict:
    """``scaled_dot_product_attention`` (a yardstick only; the port never
    calls it) forward and backward on the same MHA inputs (fp32 or bf16),
    causal: the pair back to back (CUDA events), the forward's device time,
    and the backward's, the profiler's kernels of a forward-and-backward
    call that a forward alone does not launch."""
    from torch.profiler import ProfilerActivity, profile
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    dot = do.transpose(1, 2)

    def fwd():
        return sdpa(qt, kt, vt, is_causal=True)

    def fwd_bwd():
        torch.autograd.grad(fwd(), (qt, kt, vt), dot)

    fwd_bwd_ms = cuda_ms(torch, fwd_bwd, iters=20, warmup=3)
    kernels = {}
    for fn in (fwd, fwd_bwd):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                fn()
            torch.cuda.synchronize()
        kernels[fn.__name__] = _device_kernels(torch, prof)
    bwd = {k: t[0] / 10 for k, t in kernels["fwd_bwd"].items()
           if k not in kernels["fwd"]}
    return {"fwd_bwd_ms": fwd_bwd_ms,
            "forward_device_ms": sum(t[0] for t in kernels["fwd"].values())
            / 10,
            "backward_device_ms": sum(bwd.values()) if bwd else None,
            "backward_kernels": sorted(k[:60] for k in bwd)}


def _train_batch(torch, seed: int):
    from repro_torch.data.pipeline import InputShape, make_batch
    from repro_torch.models.config import get_config
    return make_batch(get_config(TRAIN_ARCH), InputShape(
        "custom_train", TRAIN_SEQ, TRAIN_BATCH, "train"), seed=seed)


def check_training(torch, fa, wrappers: dict) -> dict:
    """Phase 9b: full-width olmo-1b training in fp32 on the card, the model
    alone there. (1) Each gradient leaf at the first step, kernels against
    plain (``GRAD_REL_TOL``). (2) The main path: ``launch.train.train`` for
    ``TRAIN_STEPS`` steps with the kernels, every launch count set to 0
    just before and read just after: 32 flash forwards (16 layers, again in
    remat's recompute) and 16 backwards a step, nothing else. (3) The same
    with ``use_kernels=False`` from the same weights and batches: each
    step's loss and grad_norm within ``TRAIN_REL_TOL``. (4) Step time,
    tokens/s and peak memory over timed steps; one step profiled (busy,
    idle share, device time by kernel; every flash forward in it the
    long-query design). (5) The train state saved with the
    port's ``save_checkpoint``, restored and equal. Prints the training
    report; returns the main path's launch counts."""
    import tempfile

    from repro_torch import checkpoint
    from repro_torch.launch.train import train
    from repro_torch.models import model as M
    from repro_torch.models import steps as ST
    from repro_torch.models.config import get_config
    from repro_torch.tree import items, leaves

    cfg = get_config(TRAIN_ARCH)
    kernels_on, plain = M.ModelOptions(), M.ModelOptions(use_kernels=False)
    topts = ST.TrainOptions()
    gc.collect()
    torch.cuda.empty_cache()

    # (1) the gradient of every leaf at the first step
    params = _params(torch, cfg)
    batch = _train_batch(torch, 0)
    loss_k, _, g_k = ST.compute_grads(params, batch, cfg, kernels_on, topts)
    loss_p, _, g_p = ST.compute_grads(params, batch, cfg, plain, topts)
    names = [p for p, _ in items(params)]
    rel = {n: (torch.linalg.vector_norm(a - b) /
               torch.linalg.vector_norm(b)).item()
           for n, a, b in zip(names, leaves(g_k), leaves(g_p))}
    if not all(np.isfinite(x) for x in rel.values()):
        fail("training: a gradient leaf is not finite")
    worst_leaf = max(rel, key=rel.get)
    attn = {n: r for n, r in rel.items() if n.split("/")[-1] in
            ("wq", "wk", "wv")}
    print(f"training: first-step gradients, kernels vs plain: loss "
          f"{loss_k.item():.6f} / {loss_p.item():.6f}; worst leaf {worst_leaf}"
          f" {rel[worst_leaf]:.3e}; wq/wk/wv worst "
          f"{max(attn.values()):.3e} (tol {GRAD_REL_TOL})")
    if rel[worst_leaf] > GRAD_REL_TOL:
        fail(f"training: gradient {worst_leaf} kernels vs plain "
             f"{rel[worst_leaf]:.3e} > {GRAD_REL_TOL}")
    del params, g_k, g_p, batch
    gc.collect()
    torch.cuda.empty_cache()

    # (2) the main path, counted; (3) the plain path from the same start
    for fn in wrappers.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    rec_k = train(TRAIN_ARCH, reduced=False, steps=TRAIN_STEPS,
                  batch=TRAIN_BATCH, seq=TRAIN_SEQ, log_every=1,
                  device="cuda", opts=kernels_on)
    counts = {name: fn.launches for name, fn in wrappers.items()}
    peak_train = torch.cuda.max_memory_allocated()
    want = {"flash_attention": 2 * cfg.num_layers * TRAIN_STEPS,
            "flash_attention_bwd": cfg.num_layers * TRAIN_STEPS}
    for name, n in counts.items():
        if n != want.get(name, 0):
            fail(f"training: {name} launched {n} times in {TRAIN_STEPS} "
                 f"steps, want {want.get(name, 0)}")
    gc.collect()
    torch.cuda.empty_cache()
    rec_p = train(TRAIN_ARCH, reduced=False, steps=TRAIN_STEPS,
                  batch=TRAIN_BATCH, seq=TRAIN_SEQ, log_every=1,
                  device="cuda", opts=plain)
    gc.collect()
    torch.cuda.empty_cache()
    by_step = []
    for key in ("loss_history", "grad_norm_history"):
        for a, b in zip(rec_k[key], rec_p[key]):
            if not (np.isfinite(a) and np.isfinite(b)):
                fail(f"training: {key} not finite: {a}, {b}")
            by_step.append(abs(a - b) / abs(b))
            if by_step[-1] > TRAIN_REL_TOL:
                fail(f"training: {key} kernels {rec_k[key]} vs plain "
                     f"{rec_p[key]}: {by_step[-1]:.3e} > {TRAIN_REL_TOL}")

    # (4) step time, tokens/s, peak memory, one step profiled
    from torch.profiler import ProfilerActivity, profile
    gen = torch.Generator(device="cuda").manual_seed(0)
    state = ST.init_train_state(cfg, gen, torch.float32, topts,
                                device="cuda")
    # params, m and v; the gradients (params' size) exist during a step
    state_bytes = 4 * sum(p.numel() for p in leaves(state))
    grad_bytes = 4 * sum(p.numel() for p in leaves(state["params"]))
    batches = [_train_batch(torch, i) for i in range(4)]
    state, _ = ST.train_step(state, batches[0], cfg, kernels_on, topts)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for b in batches[1:]:
        state, m = ST.train_step(state, b, cfg, kernels_on, topts)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / (len(batches) - 1)
    peak_step = torch.cuda.max_memory_allocated()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, m = ST.train_step(state, batches[0], cfg, kernels_on, topts)
        torch.cuda.synchronize()
        wall_traced = time.perf_counter() - t0
    by_name = _device_kernels(torch, prof)
    designs = _flash_designs(by_name)
    if designs != {"f32_rows": 2 * cfg.num_layers}:
        fail(f"training: the traced step's flash forwards are {designs}; "
             f"want f32_rows {2 * cfg.num_layers} (a forward and remat's "
             "recompute a layer)")
    busy = sum(v[0] for v in by_name.values())
    groups = {"flash forward": "flash_attention_kernel",
              "flash backward": "flash_attention_bwd"}
    by_group = {g: sum(v[0] for k, v in by_name.items() if pat in k)
                for g, pat in groups.items()}
    gemm = [k for k in by_name if any(w in k.lower() for w in (
        "gemm", "xmma", "cutlass", "nvjet", "sm90_"))
        and not any(pat in k for pat in groups.values())]
    by_group["GEMMs"] = sum(by_name[k][0] for k in gemm)
    by_group["other"] = busy - sum(by_group.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    report = {
        "arch": TRAIN_ARCH, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
        "dtype": "float32", "remat": True, "steps": TRAIN_STEPS,
        "loss_kernels": rec_k["loss_history"],
        "loss_plain": rec_p["loss_history"],
        "grad_norm_kernels": rec_k["grad_norm_history"],
        "grad_norm_plain": rec_p["grad_norm_history"],
        "max_rel_diff_by_step": max(by_step),
        "first_step_grad_rel": {"worst": [worst_leaf, rel[worst_leaf]],
                                "wq_wk_wv_worst": max(attn.values())},
        "launches_in_main_path": counts,
        "train_wall_s": [rec_k["wall_s"], rec_p["wall_s"]],
        "step_s": step_s, "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / step_s,
        "state_bytes": state_bytes, "grad_bytes": grad_bytes,
        "peak_bytes_train_run": peak_train,
        "peak_bytes_timed_steps": peak_step,
        "traced_step_wall_ms": wall_traced * 1e3, "device_busy_ms": busy,
        "device_idle_share": 1 - busy / (wall_traced * 1e3),
        "device_ms_by_group": by_group, "flash_forward_designs": designs,
        "top_device_kernels_ms": [(k[:70], round(v[0], 4), v[1])
                                  for k, v in top]}

    # (5) the train state through the port's checkpoint and back
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "state.npz")
        t0 = time.perf_counter()
        checkpoint.save_checkpoint(path, state, cfg,
                                   meta={"arch": TRAIN_ARCH})
        t1 = time.perf_counter()
        back = checkpoint.restore_checkpoint(path, state, cfg)
        t2 = time.perf_counter()
        report["checkpoint"] = {"bytes": os.path.getsize(path),
                                "save_s": t1 - t0, "restore_s": t2 - t1}
    if not all(torch.equal(a, b) for a, b in zip(leaves(state),
                                                 leaves(back))):
        fail("training: the restored train state differs from the saved")
    print("training report: " + json.dumps(report))
    del state, back, batches
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def check_refusals(torch, wrappers: dict) -> None:
    """Phase 9c: the SSD and RG-LRU kernels have no backward kernel, so
    their dispatch refuses CUDA inputs that require grad (and launches
    nothing)."""
    from repro_torch.kernels import ops
    mk = lambda *s: torch.randn(s, device="cuda", requires_grad=True)
    calls = {"ssd_scan": lambda: ops.ssd_scan(
                 mk(1, 32, 2, 16), mk(1, 32, 2).abs(), -mk(2).abs(),
                 mk(1, 32, 1, 16), mk(1, 32, 1, 16), 32),
             "rglru_scan": lambda: ops.rglru_scan(mk(1, 8, 64), mk(1, 8, 64)),
             "rglru_gated_scan": lambda: ops.rglru_gated_scan(
                 mk(1, 8, 64), mk(1, 8, 64), mk(1, 8, 64), mk(1, 8, 64),
                 mk(64))}
    for name, call in calls.items():
        before = wrappers[name].launches
        try:
            call()
        except ValueError as e:
            if "use_kernels=False" not in str(e):
                fail(f"{name} under grad: unexpected refusal {e}")
        else:
            fail(f"{name} ran on CUDA inputs that require grad")
        if wrappers[name].launches != before:
            fail(f"{name} launched while refusing grad")
    print("ssd_scan, rglru_scan and rglru_gated_scan refuse grad on the card")


def _no_reference_loaded(phase: str) -> None:
    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "repro")
                    and sys.modules[m] is not None)
    if leaked:
        fail(f"the {phase} phase found reference modules loaded: {leaked}")


def _sim_day(**kw):
    """A 24-hour ``rush_hour`` day of ``SIM_STREAMS`` streams, seed
    ``SIM_SEED``, under ``ReactivePolicy``: (the simulator, its ledger, host
    s)."""
    from repro_torch.core import ResourceManager
    from repro_torch.sim import SCENARIOS, FleetSimulator, ReactivePolicy
    sc = SCENARIOS["rush_hour"](n_streams=SIM_STREAMS, duration_h=SIM_HOURS,
                                seed=SIM_SEED)
    cat = sc.catalog()
    sim = FleetSimulator(sc.demand, ReactivePolicy(ResourceManager(cat)), cat,
                         sc.config, **kw)
    t0 = time.perf_counter()
    ledger = sim.run()
    return sim, ledger, time.perf_counter() - t0


def check_calibrated_day(calibration) -> dict:
    """Phase 11, profile then simulate: a ``rush_hour`` day of 108 streams
    capped by ``calibration`` (a served engine's ``ServiceCalibration``; the
    cap forces the object loop). Every tick must analyse no more frames than
    its streams' caps allow over the tick, and the day no more than the
    uncalibrated day; the calibration's rates are planned on the H100
    catalog, each plan validated. Returns the report."""
    arch = SIM_CALIBRATED_ARCH
    _no_reference_loaded("simulator")
    if calibration is None:
        fail(f"no calibration: {arch} was not served")
    from repro_torch.core.gpu_catalog import plan_gpu_fleet
    print(f"calibration from {arch}: tokens/s by stream "
          f"{calibration.rates_tokens_per_s}, default_rate "
          f"{calibration.default_rate}, tokens/frame "
          f"{calibration.tokens_per_frame}")
    if not calibration.rates_tokens_per_s:
        fail(f"{arch}: the engine measured no rates")
    sim, ledger, host = _sim_day(calibration=calibration)
    _, plain, _ = _sim_day(columnar=False)
    dt_s = sim.config.dt_h * 3600.0
    capped = 0
    for rec in ledger.records:
        cap = sum(calibration.frame_rate_cap(s.stream_id) * dt_s
                  for s in sim.demand.streams_at(rec.t))
        if rec.frames_analyzed > cap * (1 + 1e-12):
            fail(f"calibrated day, tick {rec.t}: {rec.frames_analyzed} "
                 f"frames analysed over the caps' {cap}")
        capped += cap < rec.frames_demanded
    if ledger.frames_analyzed > plain.frames_analyzed:
        fail(f"calibrated day analysed {ledger.frames_analyzed} frames, "
             f"more than the uncalibrated day's {plain.frames_analyzed}")
    streams = calibration.packing_streams(arch)
    plans = {s: plan_gpu_fleet(streams, strategy=s)      # each validates
             for s in ("per-stream", "uniform-big", "packed")}
    if plans["packed"]["hourly_cost"] > plans["per-stream"]["hourly_cost"]:
        fail(f"{arch} calibration: packed plan costs more than per-stream")
    report = {"arch": arch, "rates_tokens_per_s":
              dict(calibration.rates_tokens_per_s),
              "default_rate": calibration.default_rate,
              "totals": ledger.totals(),
              "uncalibrated_frames_analyzed": plain.frames_analyzed,
              "ticks_capped": capped, "host_s": host,
              "plans": {s: (p["hourly_cost"], p["instances"])
                        for s, p in plans.items()}}
    print(f"calibrated rush_hour day: {ledger.frames_analyzed} of "
          f"{ledger.frames_demanded} frames analysed ({plain.frames_analyzed}"
          f" uncalibrated), every tick within its caps; H100 plans "
          f"{report['plans']}")
    return report


def _spans_equal(a, b) -> bool:
    return (a.name == b.name and a.t == b.t and a.wall_ms == b.wall_ms
            and a.attrs == b.attrs and len(a.children) == len(b.children)
            and all(_spans_equal(x, y)
                    for x, y in zip(a.children, b.children)))


def _obs_round_trips(what: str, hub, tracer, jsonl_path: str,
                     trace_path: str) -> dict:
    """The JSONL file read back must equal the hub's points, and the
    tracer's Chrome trace, written and read back, its span trees."""
    from repro_torch.obs import (load_jsonl_metrics, spans_from_chrome_trace,
                                 write_chrome_trace)
    loaded = load_jsonl_metrics(jsonl_path)
    if loaded != hub.points:
        fail(f"{what}: the JSONL export does not read back as the hub's "
             f"{len(hub.points)} points ({len(loaded)} read)")
    events = write_chrome_trace(trace_path, tracer)
    rebuilt = spans_from_chrome_trace(trace_path)
    if len(rebuilt) != len(tracer.spans) or not all(
            _spans_equal(x, y) for x, y in zip(rebuilt, tracer.spans)):
        fail(f"{what}: the Chrome trace does not rebuild the span trees")
    return {"jsonl_points": len(loaded), "trace_spans": len(rebuilt),
            "trace_events": events}


def obs_engine_loop(torch, cfg, params, jsonl_path: str, *,
                    window_s: float = OBS_WINDOW_S) -> dict:
    """Phase 12's loop over two engines on ``params`` (one per region of
    ``OBS_REGIONS``, wherever the weights live): warm each engine, profile
    ``OBS_PROFILE_WINDOWS`` windows, take the startup calibration from
    ``EngineWindowProbe.initial_calibration()`` (which must equal the
    engines' ``ServiceCalibration.from_engine``), poll once, then run
    ``OBS_WINDOWS`` windows in which each region's ``StreamSimulator``
    enqueues ``window_s`` seconds of frames, its engine drains, and a
    ``RegionalRecalibratingPolicy`` over REPAIR decides over the cameras'
    streams, its hub writing JSONL to ``jsonl_path``; from window
    ``OBS_STEP_AT`` the drifted region serves ``OBS_LOADED_CAMERAS``
    cameras. Returns what ``check_obs_loop`` reads."""
    from repro_torch.core import ResourceManager, fig6_catalog
    from repro_torch.core.workload import PROGRAMS, Stream
    from repro_torch.launch.serve import NEW_TOKENS, PROMPT_LEN
    from repro_torch.obs import (EngineWindowProbe,
                                 RegionalRecalibratingPolicy, Tracer,
                                 hub_with_exporters)
    from repro_torch.serving import (ContinuousBatchingEngine, Request,
                                     StreamSimulator)
    from repro_torch.sim import RepairPolicy, ServiceCalibration

    class RecordingProbe(EngineWindowProbe):
        """The engines' probe, keeping each poll's merged measurement."""

        def __init__(self, engines):
            super().__init__(engines, tokens_per_frame=float(NEW_TOKENS))
            self.windows = []

        def measure(self, t):
            rates = super().measure(t)
            self.windows.append((t, rates))
            return rates

    cameras = dict(OBS_REGIONS)
    engines = {region: ContinuousBatchingEngine(cfg, params, max_slots=8,
                                                cache_len=128)
               for region in cameras}
    sims = {region: StreamSimulator(engines[region], prompt_len=PROMPT_LEN,
                                    new_tokens=NEW_TOKENS, seed=i)
            for i, region in enumerate(cameras)}

    def demand(region: str, loaded: bool) -> dict:
        n = (OBS_LOADED_CAMERAS if loaded and region == OBS_DRIFTED_REGION
             else OBS_CAMERAS)
        return {f"{cameras[region]}-{i}": OBS_FPS for i in range(n)}

    def window(loaded: bool) -> dict:
        """One window: each camera's frames arrive a frame period apart, so
        the queue interleaves the cameras and every round of slots serves
        each of them, as the lifetime profile assumes; returns each
        region's drain seconds."""
        drain_s = {}
        for region in cameras:
            for _ in range(round(window_s * OBS_FPS)):
                sims[region].tick(demand(region, loaded), dt_s=1.0 / OBS_FPS)
            t = time.perf_counter()
            engines[region].drain()
            drain_s[region] = time.perf_counter() - t
        return drain_s

    # the first calls of each engine, outside the profile; their prefills
    # and decode steps are kept for the launch count
    ran = {"prefills": 0, "decode_steps": 0}
    for eng in engines.values():
        eng.submit(Request("warmup", np.zeros(PROMPT_LEN, np.int32),
                           max_new_tokens=NEW_TOKENS))
        eng.drain()
        for k in ran:
            ran[k] += eng.stats[k]
        eng.reset_stats()
    t0 = time.perf_counter()
    for _ in range(OBS_PROFILE_WINDOWS):
        window(False)
    probe = RecordingProbe(engines)
    calibration = probe.initial_calibration()
    from_engines = {}
    for eng in engines.values():
        from_engines.update(ServiceCalibration.from_engine(
            eng, tokens_per_frame=float(NEW_TOKENS)).rates_tokens_per_s)
    if from_engines != calibration.rates_tokens_per_s:
        fail("EngineWindowProbe.initial_calibration() differs from the "
             "engines' ServiceCalibration.from_engine")
    probe.measure(-1.0)          # the first window must not span the profile
    probe.windows.clear()
    hub, exporter, agg = hub_with_exporters(jsonl_path)
    policy = RegionalRecalibratingPolicy(
        RepairPolicy(ResourceManager(fig6_catalog())), probe,
        group_of=probe.group_of, probe=probe, calibration=calibration,
        telemetry=hub, tracer=Tracer())
    drains = []
    for w in range(OBS_WINDOWS):
        loaded = w >= OBS_STEP_AT
        drains.append(window(loaded))
        streams = [Stream(sid, PROGRAMS["ZF"], fps=fps, camera=cameras[r])
                   for r in cameras for sid, fps in demand(r, loaded).items()]
        policy.decide(float(w), streams)
    exporter.close()
    for eng in engines.values():
        for k in ran:
            ran[k] += eng.stats[k]
    return {"policy": policy, "probe": probe, "calibration": calibration,
            "hub": hub, "agg": agg, "streams": streams, "ran": ran,
            "drain_s": drains,
            "loop_s": time.perf_counter() - t0, "jsonl_path": jsonl_path}


def check_obs_loop(loop: dict, workdir: str) -> dict:
    """Phase 12's checks on ``obs_engine_loop``'s result: only the drifted
    region fires, once, within ``hold_ticks`` + 1 windows of the load step;
    its re-profile covers exactly that region's streams and leaves every
    other stream's startup rate; exactly one adaptive event is flagged
    ``recalibration``, a forced replan; ``camera_region_groups`` agrees
    with the probe's groups; both exports round-trip. Returns the report."""
    from repro_torch.obs import camera_region_groups
    policy, probe = loop["policy"], loop["probe"]
    calibration, streams = loop["calibration"], loop["streams"]
    hold = policy.regional.config.hold_ticks
    per_window = []
    for verdict, (t, rates), drain_s in zip(policy.regional.history,
                                            probe.windows, loop["drain_s"]):
        row = {"t": t, "drain_s": drain_s}
        for region in dict(OBS_REGIONS):
            v = verdict.verdicts.get(region)
            sids = [s for s in rates if probe.group_of(s) == region]
            row[region] = {
                "rel_error": None if v is None else v.rel_error,
                "streak": None if v is None else v.streak,
                "streams": len(sids),
                "mean_tokens_per_s": (sum(rates[s] for s in sids) / len(sids)
                                      if sids else None)}
        per_window.append(row)
        print(f"obs window {t:g}: " + "; ".join(
            f"{r} rel_error {row[r]['rel_error']} streak {row[r]['streak']}"
            f" ({row[r]['streams']} streams, mean "
            f"{row[r]['mean_tokens_per_s']} tokens/s, drain "
            f"{drain_s[r]:.3f} s)"
            for r in dict(OBS_REGIONS)), flush=True)
    fired = policy.regional.fired_groups()
    if fired != (OBS_DRIFTED_REGION,):
        fail(f"regions fired {fired}; only {OBS_DRIFTED_REGION} should")
    if len(policy.recal_groups) != 1 or \
            policy.recal_groups[0][1] != (OBS_DRIFTED_REGION,):
        fail(f"recalibrations {policy.recal_groups}; expected one, of "
             f"{OBS_DRIFTED_REGION}")
    t_fired = policy.recal_groups[0][0]
    if not 0 <= t_fired - OBS_STEP_AT <= hold + 1:
        fail(f"fired at window {t_fired:g}, the load step at {OBS_STEP_AT}"
             f" (at most hold_ticks + 1 = {hold + 1} windows after it)")
    measured = dict(probe.windows)[t_fired]
    scope = {sid for sid in measured
             if probe.group_of(sid) == OBS_DRIFTED_REGION}
    drifted = {s.stream_id for s in streams
               if probe.group_of(s.stream_id) == OBS_DRIFTED_REGION}
    if scope != drifted or len(drifted) != OBS_LOADED_CAMERAS:
        fail(f"re-profiled {sorted(scope)}; the drifted region serves "
             f"{sorted(drifted)}")
    (span,) = policy.tracer.find("recalibrate")
    if span.attrs["scoped_streams"] != len(scope):
        fail(f"the repair's scope holds {span.attrs['scoped_streams']} "
             f"streams, not the {len(scope)} re-profiled")
    before = calibration.rates_tokens_per_s
    after = policy.calibration.rates_tokens_per_s
    if set(after) != set(before) | scope or any(
            after[s] != (measured[s] if s in scope else before[s])
            for s in after):
        fail("the recalibration changed rates outside the drifted region, "
             "or did not adopt its measured ones")
    flagged = [e for e in policy.adaptive.events if e.recalibration]
    if len(flagged) != 1 or flagged[0].action != "forced-replan":
        fail(f"adaptive events flagged as recalibrations: {flagged}")
    groups = camera_region_groups(streams)
    if groups != {s.stream_id: probe.group_of(s.stream_id)
                  for s in streams}:
        fail(f"camera_region_groups {groups} differs from the probe's")
    exports = _obs_round_trips("the engines' loop", loop["hub"],
                               policy.tracer, loop["jsonl_path"],
                               os.path.join(workdir, "obs_trace.json"))
    wall = loop["agg"].instruments["replan.wall_ms"].summary()
    print(f"obs: {OBS_DRIFTED_REGION} fired at window {t_fired:g} (load "
          f"step at {OBS_STEP_AT}, hold_ticks {hold}), scope "
          f"{len(scope)} streams; replan.wall_ms p50 {wall['p50']:.3f} p99 "
          f"{wall['p99']:.3f} over {wall['count']}; exports {exports}")
    return {"windows": per_window, "fired_groups": list(fired),
            "fired_at_window": t_fired, "step_at_window": OBS_STEP_AT,
            "hold_ticks": hold, "scoped_streams": len(scope),
            "calibration_tokens_per_s": dict(before),
            "recalibrated_tokens_per_s": {s: after[s] for s in sorted(scope)},
            "flagged_events": [(e.t, e.action, e.migrations)
                               for e in flagged],
            "replan_wall_ms": {k: wall.get(k)
                               for k in ("count", "p50", "p95", "p99")},
            "exports": exports, "prefills": loop["ran"]["prefills"],
            "decode_steps": loop["ran"]["decode_steps"],
            "loop_s": loop["loop_s"]}


def check_obs_engines(torch, wrappers: dict) -> tuple:
    """Phase 12 on the card: ``obs_engine_loop`` over two full-width
    olmo-1b engines on one set of fp32 weights, with every launch count set
    to 0 just before and read just after (flash: 16 a prefill, warmup
    included; nothing else), then ``check_obs_loop``. Returns (report,
    counts)."""
    import tempfile
    from repro_torch.models.config import get_config
    _no_reference_loaded("observability")
    cfg = get_config("olmo-1b")
    params = _params(torch, cfg)
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        for fn in wrappers.values():
            fn.launches = 0
        loop = obs_engine_loop(torch, cfg, params,
                               os.path.join(tmp, "obs.jsonl"))
        torch.cuda.synchronize()
        counts = {name: fn.launches for name, fn in wrappers.items()}
        report = check_obs_loop(loop, tmp)
    ran = loop["ran"]
    for name, got in counts.items():
        want = expected_launches(cfg, name, ran["prefills"],
                                 ran["decode_steps"])
        if got != want:
            fail(f"obs loop: {name} launched {got} times; expected {want} "
                 f"for {ran['prefills']} prefills")
    if counts["flash_attention"] == 0:
        fail("obs loop: the flash kernel never launched")
    print(f"obs loop: launches {counts} for {ran['prefills']} prefills and "
          f"{ran['decode_steps']} decode steps, warmup included "
          f"({report['loop_s']:.2f} s)")
    report["launches"] = counts
    del loop, params
    gc.collect()
    torch.cuda.empty_cache()
    return report, counts


def _train_match(what: str, got: dict, want: dict) -> float:
    """The largest relative difference, step by step, of ``got``'s loss and
    grad_norm from ``want``'s; fails past ``TRAIN_REL_TOL``."""
    worst = 0.0
    for key in ("loss_history", "grad_norm_history"):
        for a, b in zip(got[key], want[key], strict=True):
            if not (np.isfinite(a) and np.isfinite(b)):
                fail(f"{what}: {key} not finite: {a}, {b}")
            worst = max(worst, abs(a - b) / abs(b))
            if abs(a - b) / abs(b) > TRAIN_REL_TOL:
                fail(f"{what}: {key} {got[key]} vs unmeshed {want[key]}: "
                     f"{abs(a - b) / abs(b):.3e} > {TRAIN_REL_TOL}")
    return worst


def check_dist_train(torch, wrappers: dict, mesh) -> tuple:
    """Phase 13a, the main path: ``launch.train.train`` of full-width
    olmo-1b (phase 9's batch, fp32, remat, the kernels on) on ``mesh`` (1x1
    over NCCL) for ``TRAIN_STEPS`` steps, every launch count set to 0 just
    before and read just after (32 flash forwards and 16 backwards a step,
    nothing else); the same steps from the same weights without the mesh,
    each step's loss and grad_norm within ``TRAIN_REL_TOL``; then
    ``DIST_MB_STEPS`` steps at 2 microbatches (``batch_axes`` the mesh's
    data axes) against the unmeshed 2-microbatch run, counted too. Each
    run's host seconds a step. Returns (report, counts by path)."""
    from repro_torch.launch.train import train
    from repro_torch.models import model as M
    from repro_torch.models.config import get_config

    n_layers = get_config(TRAIN_ARCH).num_layers
    kw = dict(reduced=False, batch=TRAIN_BATCH, seq=TRAIN_SEQ, log_every=1,
              device="cuda", opts=M.ModelOptions())
    runs, counts = {}, {}
    for label, steps, mb in ((DIST_PATH, TRAIN_STEPS, 1),
                             (DIST_MB_PATH, DIST_MB_STEPS, 2)):
        gc.collect()
        torch.cuda.empty_cache()
        for fn in wrappers.values():
            fn.launches = 0
        meshed = train(TRAIN_ARCH, steps=steps, microbatches=mb, mesh=mesh,
                       **kw)
        counts[label] = {name: fn.launches for name, fn in wrappers.items()}
        want = {"flash_attention": 2 * n_layers * steps * mb,
                "flash_attention_bwd": n_layers * steps * mb}
        for name, n in counts[label].items():
            if n != want.get(name, 0):
                fail(f"{label}: {name} launched {n} times in {steps} steps, "
                     f"want {want.get(name, 0)}")
        gc.collect()
        torch.cuda.empty_cache()
        plain = train(TRAIN_ARCH, steps=steps, microbatches=mb, **kw)
        runs[label] = {
            "microbatches": mb, "steps": steps,
            "loss_meshed": meshed["loss_history"],
            "loss_unmeshed": plain["loss_history"],
            "grad_norm_meshed": meshed["grad_norm_history"],
            "grad_norm_unmeshed": plain["grad_norm_history"],
            "max_rel_diff": _train_match(label, meshed, plain),
            "step_s_meshed": meshed["step_s_history"],
            "step_s_unmeshed": plain["step_s_history"],
            "launches": counts[label]}
        print(f"{label}: loss {meshed['loss_history']} (unmeshed "
              f"{plain['loss_history']}); step s meshed "
              f"{meshed['step_s_history']}, unmeshed "
              f"{plain['step_s_history']}; launches {counts[label]}",
              flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    return runs, counts


def check_dist_moe(torch, mesh) -> dict:
    """Phase 13b: one qwen3-moe-30b-a3b MoE layer at its published widths
    in bf16 (128 experts of 768, top 8, d_model 2048; weights from a seeded
    generator), capacity factor ``DIST_MOE_CF`` so no form drops a token,
    at T = 32 (1 × 32) and 128 (4 × 32) tokens: on ``mesh``,
    ``apply_moe_local``, ``apply_moe(expert_shard_constraint=True)`` and
    ``apply_moe_shard_map`` against the global dispatch on plain tensors,
    the output within bf16 2e-2 and the aux within ``DIST_AUX_TOL``."""
    import dataclasses
    from repro_torch.launch import sharding as SH
    from repro_torch.models import moe
    from repro_torch.models.config import get_config

    cfg = dataclasses.replace(get_config(DIST_MOE_ARCH),
                              capacity_factor=DIST_MOE_CF)
    D, E, F = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    gen = torch.Generator(device="cuda").manual_seed(0)
    draw = lambda shape, std: (torch.randn(shape, generator=gen,
                                           device="cuda") * std).to(
        torch.bfloat16)
    params = {"router": draw((D, E), D ** -0.5),
              "w1": draw((E, D, F), D ** -0.5),
              "w3": draw((E, D, F), D ** -0.5),
              "w2": draw((E, F, D), F ** -0.5)}
    policy = SH.ShardingPolicy.for_arch(cfg)
    placed = {k: SH.distribute(v, SH.param_spec(f"layers/0/ffn/{k}", v, mesh,
                                                policy), mesh)
              for k, v in params.items()}
    forms = {
        "apply_moe_local": lambda x: moe.apply_moe_local(placed, x, cfg),
        "apply_moe(expert_shard_constraint=True)": lambda x: moe.apply_moe(
            placed, x, cfg, expert_shard_constraint=True),
        "apply_moe_shard_map": lambda x: moe.apply_moe_shard_map(
            placed, x, cfg, mesh, dp_axes=("data",))}
    report = {"weights_bytes": sum(v.numel() * 2 for v in params.values())}
    for T in DIST_MOE_TOKENS:
        B = T // 32
        x = draw((B, 32, D), 1.0)
        with torch.no_grad():
            want, aux_want = moe.apply_moe(params, x, cfg)
            dx = SH.distribute(x, (("data",), None, None), mesh)
            for name, form in forms.items():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out, aux = form(dx)
                out, aux = out.full_tensor(), aux.full_tensor()
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
                err = _compare(f"{name} T={T}", (B, 32, D), torch.bfloat16,
                               out, want, BF16_TOL)
                aux_err = abs(aux.item() - aux_want.item())
                if not aux_err <= DIST_AUX_TOL:
                    fail(f"{name} T={T}: aux {aux.item()} vs "
                         f"{aux_want.item()}")
                report[f"{name} T={T}"] = {"max_abs_err": err,
                                           "aux_abs_err": aux_err,
                                           "host_ms": ms}
                print(f"moe on the mesh: {name} T={T} max|err| {err:.3e}, "
                      f"aux err {aux_err:.1e}, {ms:.2f} ms", flush=True)
    del params, placed
    gc.collect()
    torch.cuda.empty_cache()
    return report


def check_dryrun(calibration) -> dict:
    """Phase 13c on this machine's host: ``python -m
    repro_torch.launch.dryrun`` for each of ``DIST_DRYRUN`` on ``pod1``, in
    subprocesses started together (one fake process group each), each with
    a timeout; each record's per-device FLOPs, bytes, collective counts and
    trace seconds. Then the H100 fleet planned from phase 6's measured
    olmo-1b rates without and with the records (``dryrun_dir``): the
    per-token FLOPs and each plan's $/hour and instances; the dry run's
    per-token FLOPs must exceed the closed form's (attention over the
    32k-token cache)."""
    import tempfile
    from repro_torch.core.gpu_catalog import (LLMStream, plan_gpu_fleet,
                                              streams_from_measured)
    from repro_torch.models.config import get_config

    report = {}
    with tempfile.TemporaryDirectory() as out:
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
        procs = {(a, sh): subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", a,
             "--shape", sh, "--mesh", "pod1", "--out", out], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for a, sh in DIST_DRYRUN}
        logs = {}
        try:
            for key, proc in procs.items():
                logs[key], _ = proc.communicate(
                    timeout=DIST_DRYRUN_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            logs = None
        finally:
            for proc in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.communicate()
        if logs is None:
            fail(f"dry run: no end in {DIST_DRYRUN_TIMEOUT_S} s")
        for (a, sh), proc in procs.items():
            if proc.returncode != 0:
                fail(f"dry run {a} x {sh} exited {proc.returncode}: "
                     f"{logs[(a, sh)][-2000:]}")
            with open(os.path.join(out, f"{a}_{sh}_pod1.json")) as f:
                rec = json.load(f)
            keep = {k: rec[k] for k in (
                "flops_per_device", "bytes_per_device",
                "collective_bytes_per_device", "collectives", "memory",
                "trace_s", "mesh_shape")}
            if not keep["flops_per_device"] > 0:
                fail(f"dry run {a} x {sh}: no FLOPs")
            report[f"{a} x {sh} x pod1"] = keep
            print(f"dry run {a} x {sh} x pod1: {keep['flops_per_device']:.6g}"
                  f" FLOP, {keep['bytes_per_device']:.6g} B a device, "
                  f"collectives {keep['collectives']['counts']}, "
                  f"{keep['trace_s']} s", flush=True)
        streams = streams_from_measured(
            SIM_CALIBRATED_ARCH, dict(calibration.rates_tokens_per_s))
        cfg = get_config(SIM_CALIBRATED_ARCH)
        closed = 2.0 * cfg.active_param_count()
        rec = report[f"{SIM_CALIBRATED_ARCH} x decode_32k x pod1"]
        traced = rec["flops_per_device"] * 256 / 128
        req = LLMStream("s", SIM_CALIBRATED_ARCH, 1.0)
        for d, want in ((out, traced), (None, closed)):
            if abs(req.requirement(d)[0] * 1e12 - want) > 1e-9 * want:
                fail(f"LLMStream.requirement({d}) is not {want:.6g} FLOP "
                     "a token")
        if not traced > closed:
            fail(f"dry run per-token FLOPs {traced:.4g} <= closed form "
                 f"{closed:.4g}")
        plans = {}
        for label, d in (("closed form", None), ("dry run", out)):
            plans[label] = {s: plan_gpu_fleet(streams, d, strategy=s)
                            for s in ("per-stream", "uniform-big", "packed")}
    report["planner"] = {
        "streams_tokens_per_s": dict(calibration.rates_tokens_per_s),
        "flops_per_token": {"closed form": closed, "dry run": traced,
                            "ratio": traced / closed},
        "plans": {label: {s: [p["hourly_cost"], p["instances"]]
                          for s, p in ps.items()}
                  for label, ps in plans.items()}}
    print(f"planner from the dry run: {json.dumps(report['planner'])}",
          flush=True)
    return report


def check_dist(torch, wrappers: dict, calibration) -> tuple:
    """Phase 13: a world of one NCCL rank over a ``FileStore`` and a 1x1
    mesh on the card, (a) and (b) on it, the process group destroyed, then
    (c). Returns ({"dist": report}'s value, counts by path)."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_smoke_world, make_smoke_mesh
    _no_reference_loaded("distributed layer")
    init_smoke_world("cuda")
    try:
        if dist.get_backend() != "nccl":
            fail(f"phase 13: backend {dist.get_backend()}, want nccl")
        mesh = make_smoke_mesh()
        train_report, counts = check_dist_train(torch, wrappers, mesh)
        moe_report = check_dist_moe(torch, mesh)
    finally:
        dist.destroy_process_group()
    report = {"train": train_report, "moe": moe_report,
              "dryrun": check_dryrun(calibration)}
    return report, counts


def _run_module(args: list, timeout_s: int) -> str:
    """``python -m <args>`` in a subprocess with the port on its path, its
    output returned; fatal on a non-zero exit or no end in ``timeout_s``."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.Popen([sys.executable, "-m", *args], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        out, err = proc.communicate(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        fail(f"{args[0]}: no end in {timeout_s} s")
    if proc.returncode != 0:
        fail(f"{' '.join(args)} exited {proc.returncode}: {err[-2000:]}")
    return out


def _loop_plans(what: str, report: dict, dryrun_dir: str) -> dict:
    """The report's plans against ``plan_gpu_fleet`` of its own measured
    rates with the dry run's records, for each strategy (fatal if one
    differs); returns both plans' $/hour and instances, the closed form's
    beside them."""
    from repro_torch.core.gpu_catalog import (plan_gpu_fleet,
                                              streams_from_measured)
    streams = streams_from_measured(LOOP_ARCH,
                                    report["measured_stream_tokens_per_s"])
    plans = {label: {s: plan_gpu_fleet(streams, d, strategy=s)
                     for s in STRATEGIES}
             for label, d in (("dry run", dryrun_dir), ("closed form", None))}
    if json.loads(json.dumps(report["fleet_plans"])) != json.loads(
            json.dumps(plans["dry run"])):
        fail(f"{what}: fleet_plans {report['fleet_plans']} are not "
             f"plan_gpu_fleet(..., dryrun_dir) {plans['dry run']}")
    brief = {label: {s: [p["hourly_cost"], p["instances"]]
                     for s, p in ps.items()} for label, ps in plans.items()}
    print(f"{what} plans: {json.dumps(brief)}", flush=True)
    return brief


def check_loop(torch, wrappers: dict) -> tuple:
    """Phase 14, the paper's profile-then-pack loop through the launchers a
    user runs, with ``jax`` and ``repro`` absent: (a) ``python -m
    repro_torch.launch.dryrun`` for ``LOOP_ARCH`` at ``decode_32k`` on
    ``pod1`` into a directory of its own, the requirement's per-token FLOPs
    the record's; (b) ``serve(LOOP_ARCH, reduced=False, dryrun_dir=...)``
    through ``serve_path`` (counted and checked as phase 6; the model
    freed), its plans against their recomputation from the record; (c) ``python
    -m repro_torch.launch.serve --arch LOOP_ARCH --full --dryrun-dir ...``
    on the card, its JSON held the same way. Returns ({"loop": report}'s
    value, (b)'s counts)."""
    import tempfile
    from repro_torch.core.gpu_catalog import LLMStream
    from repro_torch.models.config import get_config

    _no_reference_loaded("paper's loop")
    t_phase = time.perf_counter()
    report = {}
    cfg = get_config(LOOP_ARCH)
    with tempfile.TemporaryDirectory() as d:
        # (a) the dry run's record
        t0 = time.perf_counter()
        _run_module(["repro_torch.launch.dryrun", "--arch", LOOP_ARCH,
                     "--shape", "decode_32k", "--mesh", "pod1", "--out", d],
                    DIST_DRYRUN_TIMEOUT_S)
        with open(os.path.join(d, f"{LOOP_ARCH}_decode_32k_pod1.json")) as f:
            rec = json.load(f)
        if not rec.get("flops_per_device", 0) > 0:
            fail(f"phase 14: the dry run's record has no FLOPs: {rec}")
        traced = rec["flops_per_device"] * 256 / 128
        closed = 2.0 * cfg.active_param_count()
        got = LLMStream("s", LOOP_ARCH, 1.0).requirement(d)[0] * 1e12
        if abs(got - traced) > 1e-9 * traced or not traced > closed:
            fail(f"phase 14: requirement({d}) gives {got:.6g} FLOP a token;"
                 f" the record {traced:.6g}, the closed form {closed:.6g}")
        report["dryrun"] = {
            "flops_per_device": rec["flops_per_device"],
            "trace_s": rec["trace_s"],
            "flops_per_token": {"dry run": traced, "closed form": closed},
            "s": time.perf_counter() - t0}
        print(f"phase 14 dry run: {traced:.6g} FLOP a token from the record"
              f", {closed:.6g} closed form; {rec['trace_s']} s of tracing",
              flush=True)

        # (b) serve(..., dryrun_dir=d) in this process, counted and held
        # as phase 6 holds it
        t0 = time.perf_counter()
        counts, _, out = serve_path(torch, LOOP_ARCH, wrappers, dryrun_dir=d)
        if out["frames_served"] != 24:
            fail(f"phase 14: {out['frames_served']} frames served; want 24")
        report["serve"] = {
            "frames_served": out["frames_served"],
            "tokens_per_s": out["tokens_per_s"],
            "measured_stream_tokens_per_s":
                out["measured_stream_tokens_per_s"],
            "launches": counts, "s": time.perf_counter() - t0,
            "plans": _loop_plans("phase 14 serve(dryrun_dir=)", out, d)}

        # (c) the command line, in a process of its own on the card
        t0 = time.perf_counter()
        cli = json.loads(_run_module(
            ["repro_torch.launch.serve", "--arch", LOOP_ARCH, "--full",
             "--dryrun-dir", d], LOOP_SERVE_TIMEOUT_S))
        if cli["frames_served"] != 24:
            fail(f"phase 14: the command line served {cli['frames_served']}"
                 " frames; want 24")
        report["cli"] = {
            "frames_served": cli["frames_served"],
            "tokens_per_s": cli["tokens_per_s"],
            "measured_stream_tokens_per_s":
                cli["measured_stream_tokens_per_s"],
            "s": time.perf_counter() - t0,
            "plans": _loop_plans("phase 14 --dryrun-dir", cli, d)}
    report["s"] = time.perf_counter() - t_phase
    print(f"phase 14: {report['s']:.1f} s", flush=True)
    return report, counts


def moe_experts_bound_ms(x, rows, ends, w1) -> tuple[float, str]:
    """Least time for one grouped expert call on these inputs: the weights
    of every held expert that gets a row (w1, w3, w2: 3·D·F each), the
    tokens and the rows' outputs, each read or written once at the HBM
    rate, against the three products of each held row (6·D·F) at the fp32
    rate."""
    T, D = x.shape
    F = w1.shape[2]
    counts = np.diff(np.concatenate([[0], ends.cpu().numpy()]))
    held_rows, touched = int(counts.sum()), int((counts > 0).sum())
    nbytes = 4 * (3 * touched * D * F + T * D + held_rows * D)
    return _bound(nbytes, 6.0 * D * F * held_rows, "float32")


def check_granite(torch, wrappers: dict) -> tuple[dict, dict]:
    """Phase 15: granite-4.0-h-small at full width in fp32, weights from a
    seeded generator on the card, through ``ContinuousBatchingEngine`` with
    the kernels on: ``GRANITE_FRAMES`` frames of ``GRANITE_PROMPT`` tokens,
    ``GRANITE_NEW`` answered each, ``GRANITE_SLOTS`` slots of
    ``GRANITE_CACHE``. The drain runs under ``torch.profiler``, with every
    launch count, ``moe_experts.launches`` among them, set to 0 just before
    it; every decode step must replay the engine's CUDA graph, and the
    kernels' calls that ran on the card, by the trace (``_device_calls``:
    a replay calls no wrapper), must be the grouped expert kernels once a
    layer in every prefill and decode step (40 layers), the SSD kernel in
    the 36 Mamba-2 layers and flash in the 4 attention layers of every
    prefill, nothing else. The first call of the
    grouped expert product at each shape (the drain's prefill of 576
    tokens; the decode step's 16, from one eager step on the drain's last
    state, since the drain's decode steps replay the engine's CUDA graph and
    call no wrapper) is kept, inputs and all, and the kernels are held
    against ``ref.moe_experts_ref`` on those inputs within
    ``MOE_TOL`` of the largest |output|, over the held rows and the zero
    row; then timed there (back to back, device alone, host enqueue, the
    plain version, the bound). Returns the grouped kernel's record and the
    other kernels' calls on the card; the model freed."""
    from repro_torch.kernels import dense_gemm as dg
    from repro_torch.kernels import moe_experts as me
    from repro_torch.kernels import ops, ref
    from repro_torch.models import steps
    from repro_torch.models.config import get_config
    from repro_torch.serving import ContinuousBatchingEngine, Request

    cfg = get_config(GRANITE_ARCH)
    params = _params(torch, cfg)
    torch.cuda.reset_peak_memory_stats()
    eng = ContinuousBatchingEngine(cfg, params, max_slots=GRANITE_SLOTS,
                                   cache_len=GRANITE_CACHE)
    rng = np.random.default_rng(15)
    for i in range(GRANITE_FRAMES):
        eng.submit(Request(f"g{i}", rng.integers(
            0, cfg.vocab_size, GRANITE_PROMPT).astype(np.int32),
            max_new_tokens=GRANITE_NEW))
    kept = {}
    plain_op = ops.moe_experts

    def keep_first(x, rows, ends, w1, w3, w2, small=False):
        if x.shape[0] not in kept:
            kept[x.shape[0]] = (x.clone(), rows.clone(), ends.clone(), w1,
                                w3, w2, small)
        return plain_op(x, rows, ends, w1, w3, w2, small)

    kernels = {**wrappers, "moe_experts": me.moe_experts,
               "dense_gemm": dg.dense_gemm}
    for fn in kernels.values():
        fn.launches = 0
    ops.moe_experts = keep_first
    try:
        prof, wall, done = _traced_drain(torch, eng)
        calls = {name: fn.launches for name, fn in kernels.items()}
        counts = _device_calls(torch, prof, kernels)
        del prof
        # the drain's decode steps replay the engine's CUDA graph, which
        # calls no wrapper: one eager step from the drain's last state
        # gives the grouped product its decode inputs
        steps.decode_step(params, eng.cache, {
            "token": torch.as_tensor(eng._pending, dtype=torch.long,
                                     device="cuda"),
            "pos": torch.as_tensor(eng._slot_pos, dtype=torch.long,
                                   device="cuda")}, cfg, eng.opts)
        torch.cuda.synchronize()
    finally:
        ops.moe_experts = plain_op
    ran = eng.stats
    share = eng.report()["decode_graph_share"]
    print(f"{GRANITE_ARCH}: {len(done)} frames of {GRANITE_PROMPT} tokens in "
          f"{wall:.2f} s traced; {ran['prefills']} prefills, "
          f"{ran['decode_steps']} decode steps, {share} of them replayed; "
          f"launches {counts} by the trace, wrapper calls {calls}; peak "
          f"memory {torch.cuda.max_memory_allocated() / 1e9:.1f} GB")
    if share != 1.0:
        fail(f"{GRANITE_ARCH}: {share} of the decode steps replayed the "
             "engine's CUDA graph; expected all")
    if len(done) != GRANITE_FRAMES or any(
            len(r.output) != GRANITE_NEW for r in done):
        fail(f"{GRANITE_ARCH}: {len(done)} frames answered of "
             f"{GRANITE_FRAMES}, or an answer of another length")
    moe_layers = sum(1 for _, f in cfg.layer_kinds if f == "moe")
    want = {name: expected_launches(cfg, name, ran["prefills"],
                                    ran["decode_steps"]) for name in wrappers}
    want["moe_experts"] = moe_layers * (ran["prefills"] + ran["decode_steps"])
    dense = counts.pop("dense_gemm")
    want_dense = DENSE_PER_PREFILL[GRANITE_ARCH] * ran["prefills"]
    if counts != want or not _dense_count_ok(calls["dense_gemm"], dense,
                                             want_dense):
        fail(f"{GRANITE_ARCH}: launches {counts}, dense_gemm {dense} by the "
             f"trace and {calls['dense_gemm']} wrapper calls; expected "
             f"{want}, dense_gemm {want_dense}")
    counts["dense_gemm"] = calls["dense_gemm"]
    if sorted(kept) != [GRANITE_SLOTS, GRANITE_PROMPT]:
        fail(f"{GRANITE_ARCH}: the grouped product saw token counts "
             f"{sorted(kept)}; expected {GRANITE_SLOTS} and {GRANITE_PROMPT}")

    shapes = {}
    for T, label in ((GRANITE_PROMPT, "prefill"), (GRANITE_SLOTS, "decode")):
        x, rows, ends, w1, w3, w2, small = kept[T]
        if small != (label == "decode"):
            fail(f"moe_experts {label}: small tiles {small}")
        run = lambda: me.moe_experts(x, rows, ends, w1, w3, w2, small)
        got = run()
        want_y = ref.moe_experts_ref(x, rows, ends, w1, w3, w2)
        torch.cuda.synchronize()
        R, held = rows.shape[0], int(ends[-1])
        keep = torch.cat([torch.arange(held, device=x.device),
                          torch.tensor([R], device=x.device)])
        err = (got[keep] - want_y[keep]).abs().max().item()
        scale = want_y[keep].abs().max().item()
        if not bool(got[keep].isfinite().all()) or err > MOE_TOL * scale:
            fail(f"moe_experts {label} T {T}: max |err| {err:.3e} over "
                 f"{MOE_TOL} x {scale:.3e}")
        dev_ms, per_kernel = device_ms(torch, run, "moe_grouped_kernel")
        t = {"ms": cuda_ms(torch, run), "device_ms_alone": dev_ms,
             "device_ms_by_kernel": per_kernel,
             "host_enqueue_ms": host_enqueue_ms(torch, run)}
        t["plain_ms"] = cuda_ms(torch, lambda: ref.moe_experts_ref(
            x, rows, ends, w1, w3, w2), iters=20, warmup=3)
        t["bound_ms"], t["bound_by"] = moe_experts_bound_ms(x, rows, ends, w1)
        shapes[label] = {"tokens": T, "held_rows": held, "entries": R,
                         "small_tiles": small, "max_abs_err": err,
                         "max_abs_out": scale, **t}
        print(f"moe_experts {label} (T {T}, D {x.shape[1]}, F "
              f"{w1.shape[2]}, {w1.shape[0]} held, {held} held rows of {R}):"
              f" max |err| {err:.3e} of {scale:.3e}; {json.dumps(t)}")
    del eng, params, kept, done
    gc.collect()
    torch.cuda.empty_cache()
    pre = shapes["prefill"]
    return {"name": "moe_experts", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/moe_experts.cu",
            "replaces": None, "shape": [GRANITE_PROMPT, cfg.d_model,
                                        cfg.moe_d_ff, cfg.held_experts],
            "dtype": "float32", "max_abs_err": pre["max_abs_err"],
            "ms": pre["ms"], "device_ms": pre["device_ms_alone"],
            "device_ms_alone": pre["device_ms_alone"],
            "device_ms_by_path": {GRANITE_PATH: pre["device_ms_alone"]},
            "host_enqueue_ms": pre["host_enqueue_ms"],
            "plain_ms": pre["plain_ms"], "bound_ms": pre["bound_ms"],
            "bound_by": pre["bound_by"], "library_ms": None,
            "launches": counts["moe_experts"],
            "launches_by_path": {GRANITE_PATH: counts["moe_experts"]},
            "shapes": shapes}, {n: c for n, c in counts.items()
                                if n != "moe_experts"}


def dense_bound_ms(M: int, K: int, N: int) -> tuple[float, str]:
    """The least time of an fp32 (M, K) @ (K, N) done as three TF32 passes:
    the passes at the dense TF32 peak, or x, w and the output at the HBM
    rate, whichever is longer."""
    ops_s = 3 * 2 * M * K * N / 495e12
    bytes_s = 4 * (M * K + K * N + M * N) / pb_peaks.HBM_BYTES_PER_S
    return max(ops_s, bytes_s) * 1e3, \
        "operations" if ops_s >= bytes_s else "bytes"


def _dense_count_ok(calls: int, on_card: int, want: int) -> bool:
    """The dense product's calls on a served path: the wrapper's calls
    exactly (a prefill runs eagerly, each call one launch), and the trace's
    kernels no more, and fewer by at most ``DENSE_TRACE_MISS`` (a long
    process's trace can drop a record: 893 of 896 once)."""
    return calls == want and want * (1 - DENSE_TRACE_MISS) <= on_card <= want


def _dense_device_ms(torch, run, n: int = 20) -> float:
    """Device time of one call from ``torch.profiler``: the mean over the
    ``dense_gemm_kernel`` records of ``n`` calls (over those recorded, so a
    dropped record does not lower it)."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            run()
        torch.cuda.synchronize()
    times = [e.time_range.elapsed_us() / 1e3 for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and "dense_gemm_kernel" in e.name]
    if not times:
        fail("the profiler saw no dense_gemm_kernel")
    return sum(times) / len(times)


def check_dense(torch) -> dict:
    """Phase 16: the split-TF32 dense product at every (K, N) of
    ``DENSE_SHAPES`` and ``DENSE_ROWS`` rows against fp64 and its plain
    version, timed beside its bound; then one traced drain of olmo-1b and
    of mamba2-2.7b at full width, 576-token frames, in which the kernel's
    calls on the card (by the trace) and its wrapper's calls must both be
    ``DENSE_PER_PREFILL`` x the prefills. Returns its record, whose
    launches are the drains' (phase 15 adds granite-4.0-h-small's)."""
    from repro_torch.kernels import dense_gemm as dg
    from repro_torch.kernels import ref
    from repro_torch.models.config import get_config
    from repro_torch.serving import ContinuousBatchingEngine, Request

    shapes = {}
    for K, N in DENSE_SHAPES:
        g = torch.Generator(device="cuda").manual_seed(K * 7 + N)
        x = torch.randn(DENSE_ROWS, K, device="cuda", generator=g,
                        dtype=torch.float64)
        w = torch.randn(K, N, device="cuda", generator=g,
                        dtype=torch.float64) * 0.02
        x, w = x.float(), w.float()
        truth = x.double() @ w.double()
        plain = lambda: ref.dense_gemm_ref(x, w)
        t = {"plain_ms": cuda_ms(torch, plain, iters=50, warmup=5)}
        t["bound_ms"], t["bound_by"] = dense_bound_ms(DENSE_ROWS, K, N)
        plain_err = (plain().double() - truth).abs().max().item()
        if dg.takes(x, w):
            run = lambda: dg.dense_gemm(x, w)
            err = (run().double() - truth).abs().max().item()
            if not err <= 2 * plain_err:
                fail(f"dense_gemm K {K} N {N}: max |err| {err:.3e} against "
                     f"fp64, over twice the plain version's {plain_err:.3e}")
            t["ms"] = cuda_ms(torch, run, iters=50, warmup=5)
            t["device_ms_alone"] = _dense_device_ms(torch, run)
            t["host_enqueue_ms"] = host_enqueue_ms(torch, run, 50, 5)
            t["max_abs_err"] = err
            t["blocks"], t["whole_tiles"], t["unsplit"] = dg.plan(
                DENSE_ROWS, N, K, dg._sms(0))
        t["plain_max_abs_err"] = plain_err
        shapes[f"{K}x{N}"] = t
        print(f"dense_gemm ({DENSE_ROWS}, {K}) @ ({K}, {N}): {json.dumps(t)}",
              flush=True)
        del x, w, truth

    counts = {}
    for arch in ("olmo-1b", "mamba2-2.7b"):
        cfg = get_config(arch)
        params = _params(torch, cfg)
        eng = ContinuousBatchingEngine(cfg, params, max_slots=GRANITE_SLOTS,
                                       cache_len=GRANITE_CACHE)
        rng = np.random.default_rng(16)
        for i in range(DENSE_FRAMES):
            eng.submit(Request(f"d{i}", rng.integers(
                0, cfg.vocab_size, GRANITE_PROMPT).astype(np.int32),
                max_new_tokens=2))
        dg.dense_gemm.launches = 0
        prof, wall, done = _traced_drain(torch, eng)
        calls = dg.dense_gemm.launches
        on_card = _device_calls(torch, prof, ["dense_gemm"])["dense_gemm"]
        del prof
        want = DENSE_PER_PREFILL[arch] * eng.stats["prefills"]
        share = eng.report()["dense_kernel_share"]
        print(f"{arch}: {len(done)} frames of {GRANITE_PROMPT} tokens in "
              f"{wall:.2f} s traced; dense_gemm {on_card} calls on the card "
              f"by the trace, {calls} wrapper calls, {want} expected; "
              f"dense_kernel_share {share}", flush=True)
        if not _dense_count_ok(calls, on_card, want) or share != 1.0:
            fail(f"{arch}: dense_gemm ran {on_card} times by the trace and "
                 f"{calls} by its wrapper; expected {want} "
                 f"({DENSE_PER_PREFILL[arch]} a prefill), share {share}")
        counts[DENSE_PATH.format(arch=arch)] = calls
        del eng, params, done
        gc.collect()
        torch.cuda.empty_cache()
    main = shapes["4096x16768"]
    return {"name": "dense_gemm", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/dense_gemm.cu",
            "replaces": None, "shape": [DENSE_ROWS, 4096, 16768],
            "dtype": "float32", "max_abs_err": main["max_abs_err"],
            "ms": main["ms"], "device_ms": main["device_ms_alone"],
            "device_ms_alone": main["device_ms_alone"],
            "host_enqueue_ms": main["host_enqueue_ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": main["plain_ms"],
            "launches": sum(counts.values()), "launches_by_path": counts,
            "shapes": shapes}


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

    from repro_torch.kernels import dense_gemm as dg
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_experts as me
    from repro_torch.kernels import ref
    from repro_torch.kernels import rglru_scan as rg
    from repro_torch.kernels import ssd_scan as ssd

    # 2) build
    build_kernels({"flash_attention": fa, "flash_attention_bwd": fa,
                   "ssd_scan": ssd, "rglru_scan": rg, "moe_experts": me,
                   "dense_gemm": dg})
    wrappers = {"flash_attention": fa.flash_attention,
                "ssd_scan": ssd.ssd_scan, "rglru_scan": rg.rglru_scan,
                "rglru_gated_scan": rg.rglru_gated_scan,
                "flash_attention_bwd": fa.flash_attention_bwd}

    # 3-4) each kernel against its plain version, and its times; 9a) the
    # flash backward's
    records = {"flash_attention": check_flash(torch, fa, ref),
               "ssd_scan": check_ssd(torch, ssd, ref),
               "rglru_scan": check_rglru(torch, rg, ref),
               "rglru_gated_scan": check_rglru_gated(torch, rg, ref),
               "flash_attention_bwd": check_flash_bwd(torch, fa, ref)}

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
    calibration = None
    for arch in SERVED:
        counts, calib, _ = serve_path(torch, arch, wrappers)
        if calib is not None:
            calibration = calib
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

    # 16) the split-TF32 dense product: its shapes, and its launches in
    # served drains of olmo-1b and mamba2-2.7b (granite's join in 15)
    records["dense_gemm"] = check_dense(torch)

    # 15) granite-4.0-h-small, the grouped expert kernels' main path: its
    # record, and the other kernels' launches joining their sums
    moe_record, counts = check_granite(torch, wrappers)
    for name, n in counts.items():
        records[name]["launches"] += n
        if n:
            records[name]["launches_by_path"][GRANITE_PATH] = n
    records["moe_experts"] = moe_record

    # 9b-c) training, the served models freed: the main path's launches
    # join each kernel's sum and its paths
    counts = check_training(torch, fa, wrappers)
    for name, n in counts.items():
        records[name]["launches"] += n
        records[name]["launches_by_path"][f"{TRAIN_ARCH} train"] = n
    check_refusals(torch, wrappers)

    # 11) a simulated day capped by the rates phase 6 measured on the card
    sim_report = check_calibrated_day(calibration)

    # 12) the observability loop: drift detected live across two olmo-1b
    # engines, a main path whose launches join the sum
    obs_report, counts = check_obs_engines(torch, wrappers)
    for name, n in counts.items():
        records[name]["launches"] += n
        if n:
            records[name]["launches_by_path"][OBS_PATH] = n
    # 13) the distributed layer: training on a 1x1 NCCL mesh (a main path
    # whose launches join the sum), the sharded MoE forms, the dry run
    dist_report, by_path = check_dist(torch, wrappers, calibration)
    for path, counts in by_path.items():
        for name, n in counts.items():
            records[name]["launches"] += n
            if n:
                records[name]["launches_by_path"][path] = n
    # 14) the paper's loop through both launchers: the dry run, then serve
    # with its record (a main path whose launches join the sum) and plan
    loop_report, counts = check_loop(torch, wrappers)
    for name, n in counts.items():
        records[name]["launches"] += n
        if n:
            records[name]["launches_by_path"][LOOP_PATH] = n
    print(json.dumps({"vgg": vgg_report}))
    print(card, flush=True)
    print(json.dumps({"sim": sim_report}))
    print(card, flush=True)
    print(json.dumps({"obs": obs_report}))
    print(card, flush=True)
    print(json.dumps({"dist": dist_report}))
    print(card, flush=True)
    print(json.dumps({"loop": loop_report}))
    print(card, flush=True)
    print(json.dumps({"kernels": list(records.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

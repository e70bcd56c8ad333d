"""Serving launcher: the profile-then-pack loop on one GPU.

Serves simulated camera streams on a serving engine (the measurement phase,
the paper's empirical profiling step), then plans an H100 fleet from the
*measured* per-stream tokens/sec three ways — per-stream, uniform-big and
packed — and reports cost, throughput and SLO attainment. The port of
``repro.launch.serve``; it runs on the GPU unless told ``device="cpu"``.
``serve`` draws fp32 weights, as the reference does; ``measure_and_plan``
is its second half, for an engine built by the caller (bf16 weights, say).

    python -m repro_torch.launch.serve --device cuda [--full]
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from repro_torch.checkpoint import init_params
from repro_torch.core.gpu_catalog import plan_gpu_fleet, streams_from_measured
from repro_torch.models.config import get_config, list_archs
from repro_torch.serving import (ContinuousBatchingEngine, Request,
                                 ServingEngine, StreamSimulator)

PROMPT_LEN = 32
NEW_TOKENS = 8


def _warmup(eng, prompt_len: int, new_tokens: int) -> None:
    """Run the prefill/decode paths once outside the measurement window
    (the first call builds the CUDA kernel and warms the allocator) and
    reset the stats, so one-time cost does not deflate the measured rates
    the fleet planner consumes. The static engine is warmed at its full
    max_batch; the continuous engine always prefills B=1 and decodes
    B=max_slots, so one request covers both."""
    n = getattr(eng, "max_batch", 1)
    toks = np.zeros(prompt_len, np.int32)
    for i in range(n):
        eng.submit(Request(f"warmup-{i}", toks.copy(),
                           max_new_tokens=new_tokens))
    eng.drain()
    eng.reset_stats()


def _device_bytes(device) -> int:
    """Memory of ``device``: the card's, or the host's for the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_properties(device).total_memory
    return os.sysconf("SC_PHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")


def serve(arch: str = "olmo-1b", *, n_streams: int = 4, fps: float = 2.0,
          seconds: int = 3, reduced: bool = True, engine: str = "continuous",
          device="cuda") -> dict:
    cfg = get_config(arch, reduced=reduced)
    if cfg.frontend != "none" or cfg.is_encoder:
        # a request carries tokens only: no patch embeddings or audio
        # frames, and an encoder has no decode
        raise ValueError(f"serve: {arch} (frontend {cfg.frontend!r}, "
                         f"{'encoder' if cfg.is_encoder else 'decoder'}) "
                         "does not serve token requests")
    need, have = 4 * cfg.param_count(), _device_bytes(device)
    if need > have:
        raise ValueError(
            f"serve: {arch}'s fp32 weights take {need / 1e9:.1f} GB and "
            f"{device} has {have / 1e9:.1f} GB; build an engine on bf16 "
            "weights and serve it with measure_and_plan")
    # fp32 weights drawn from a seeded generator on the device
    gen = torch.Generator(device=device).manual_seed(0)
    params = init_params(cfg, gen, torch.float32, device=device)
    if engine == "continuous":
        eng = ContinuousBatchingEngine(cfg, params, max_slots=8,
                                       cache_len=128)
    elif engine == "static":
        eng = ServingEngine(cfg, params, max_batch=8, cache_len=128)
    else:
        raise ValueError(engine)
    return measure_and_plan(eng, n_streams=n_streams, fps=fps,
                            seconds=seconds)


def measure_and_plan(eng, *, n_streams: int = 4, fps: float = 2.0,
                     seconds: int = 3) -> dict:
    """Warm ``eng`` (either engine), serve ``n_streams`` simulated streams
    at ``fps`` for ``seconds`` ticks, and plan the H100 fleet three ways
    from the measured per-stream rates of its architecture
    (``eng.cfg.name``). Returns ``serve``'s report."""
    arch = eng.cfg.name
    # 1) serve the streams and measure throughput
    _warmup(eng, prompt_len=PROMPT_LEN, new_tokens=NEW_TOKENS)
    sim = StreamSimulator(eng, prompt_len=PROMPT_LEN, new_tokens=NEW_TOKENS)
    done = []
    for _ in range(seconds):
        sim.tick({f"cam-{i}": fps for i in range(n_streams)}, dt_s=1.0)
        done.extend(eng.drain())

    # 2) per-stream measured rates feed the packing machinery; streams that
    # served no frames fall back to their nominal fps x tokens-per-frame
    measured = eng.measured_rates()
    for i in range(n_streams):
        measured.setdefault(f"cam-{i}", fps * NEW_TOKENS)

    streams = streams_from_measured(arch, measured)
    plans = {s: plan_gpu_fleet(streams, strategy=s)
             for s in ("per-stream", "uniform-big", "packed")}
    packed, per_stream = plans["packed"], plans["per-stream"]
    savings = 1.0 - packed["hourly_cost"] / per_stream["hourly_cost"]
    out = {
        "arch": arch,
        "engine": ("continuous" if isinstance(eng, ContinuousBatchingEngine)
                   else "static"),
        "frames_served": len(done),
        "tokens_per_s": round(eng.throughput_tokens_per_s(), 1),
        "measured_stream_tokens_per_s": {k: round(v, 1)
                                         for k, v in sorted(measured.items())},
        "fleet_plans": plans,
        "packed_vs_per_stream_savings": round(savings, 3),
    }
    if isinstance(eng, ContinuousBatchingEngine):
        rep = eng.report()
        out["serving_report"] = {k: round(v, 4) if isinstance(v, float) else v
                                 for k, v in rep.items()}
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list_archs(), default="olmo-1b")
    ap.add_argument("--streams", type=int, default=4)
    ap.add_argument("--fps", type=float, default=2.0)
    ap.add_argument("--seconds", type=int, default=3)
    ap.add_argument("--engine", choices=("continuous", "static"),
                    default="continuous")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--full", action="store_true",
                    help="the architecture's full widths and depth (default: "
                         "its reduced test size)")
    args = ap.parse_args()
    out = serve(args.arch, n_streams=args.streams, fps=args.fps,
                seconds=args.seconds, reduced=not args.full,
                engine=args.engine, device=args.device)
    print(json.dumps(out, indent=2))


if __name__ == "__main__":
    main()

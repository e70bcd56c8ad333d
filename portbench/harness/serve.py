"""Serving cells: camera frames through the program's continuous-batching
engine (``ContinuousBatchingEngine.submit`` and ``.step``), fed by the
camera generator.

Set-up: the weights from the seed, the engine, one prefill of each frame
length the cameras use and one decode step of every slot. Then the loop
runs: cameras hand over frames, the engine steps, answers go back to their
cameras. The window opens at the first answer and closes at the first
answer at least ``seconds`` later; it counts every frame answered inside
it (after its open, up to and including its close), each timed by the
harness's clock from its handover to the step that returned its last
token.

Correctness: the logits of every served token are taken where the steps
return them (the engine keeps only the greedy tokens). After the window, a
sample of the frames answered in it, drawn from the seed, goes to the
plain reference: each prompt with its served tokens, the reference's
logits at the served positions.
"""
from __future__ import annotations

import contextlib
import gc
import time

import numpy as np
import torch

from harness import cameras, check, weights

STUCK_S = 120.0     # no answer for this long after the window should close


class Capture:
    """The logit of each token the engine serves (the maximum of the row
    its greedy token came from), kept on the device by request."""

    def __init__(self, engine, steps):
        self.engine, self.steps = engine, steps
        self.pending, self.by_request = {}, {}
        self.orig = (steps.prefill_into_slot_step, steps.decode_step)

    def install(self) -> None:
        prefill, decode = self.orig

        def captured_prefill(params, cache, batch, slot, *a, **k):
            logits, cache = prefill(params, cache, batch, slot, *a, **k)
            self.pending[slot] = logits.amax(-1)
            return logits, cache

        def captured_decode(params, cache, batch, *a, **k):
            logits, cache = decode(params, cache, batch, *a, **k)
            top = logits.amax(-1)
            for slot, req in enumerate(self.engine._slot_req):
                if req is None:
                    continue
                if slot in self.pending:
                    self.by_request[req.request_id] = [self.pending.pop(slot)]
                self.by_request[req.request_id].append(top[slot])
            return logits, cache
        self.steps.prefill_into_slot_step = captured_prefill
        self.steps.decode_step = captured_decode

    def restore(self) -> None:
        self.steps.prefill_into_slot_step, self.steps.decode_step = self.orig

    def values(self, request_id: str):
        """The served tokens' logits of a request, or None if the steps
        never returned them."""
        got = self.by_request.get(request_id)
        return None if got is None else torch.stack(got).cpu()


def measure(ctx) -> None:
    from repro_torch.models import model as M
    from repro_torch.models import steps
    from repro_torch.serving.engine import ContinuousBatchingEngine, Request

    run, tr, dev = ctx.run, ctx.traffic, ctx.device
    params = weights.make(ctx.ref.tree(ctx.config), ctx.seed, dev, ctx.dtype)
    opts = M.ModelOptions(use_kernels=ctx.config["use_kernels"], remat=False)
    slots, cache_len, new = tr["max_slots"], tr["cache_len"], tr["new_tokens"]
    engine = ContinuousBatchingEngine(ctx.arch, params, max_slots=slots,
                                      cache_len=cache_len, opts=opts)
    cams = cameras.Cameras(tr, ctx.seed, ctx.arch.vocab_size)
    capture = Capture(engine, steps)
    capture.install()
    try:
        # the cell's shapes: a prefill of each frame length, a full decode
        for n in sorted(set(cams.lengths)):
            steps.prefill_into_slot_step(
                params, engine.cache,
                {"tokens": torch.zeros((1, n), dtype=torch.long, device=dev)},
                0, ctx.arch, opts, cache_len)
        steps.decode_step(
            params, engine.cache,
            {"token": torch.zeros(slots, dtype=torch.long, device=dev),
             "pos": torch.full((slots,), n, dtype=torch.long, device=dev)},
            ctx.arch, opts)
        ctx.sync()
        capture.pending.clear()
        capture.by_request.clear()
        gc.collect()
        gc.freeze()
        _loop(ctx, engine, cams, Request, new)
    finally:
        capture.restore()
        gc.unfreeze()
    run.memory_peak = ctx.memory_peak()

    # the sample the reference reads, drawn from the seed
    frames = run.frames
    rng = np.random.default_rng([ctx.seed % (1 << 63), 3])
    pick = sorted(rng.choice(len(frames), min(len(frames),
                                              tr["sample_requests"]),
                             replace=False)) if frames else []
    sample = [(frames[i][4], frames[i][5], capture.values(frames[i][6]))
              for i in pick]
    del engine, capture
    ctx.free()
    run.checks = check.serving(ctx, params, sample)


def _loop(ctx, engine, cams, Request, new: int) -> None:
    run, spans, clock = ctx.run, ctx.spans, time.perf_counter
    handed = {}                              # request id -> (camera, t0)
    frames = []
    window = contextlib.ExitStack()
    t_open = None
    run.setup_s = ctx.since_start()
    if ctx.profiler is not None:
        ctx.profiler.start()
    t = clock()
    cams.start(t)
    while True:
        for cam, k, t0 in cams.due(clock()):
            req = Request(request_id=f"c{cam}f{k}", tokens=cams.tokens(cam, k),
                          max_new_tokens=new, stream_id=f"c{cam}",
                          deadline_s=cams.period)
            engine.submit(req)
            handed[req.request_id] = (cam, t0)
        if not engine.queue and not engine.active_slots():
            time.sleep(max(0.0, cams.next_capture() - clock()))
            continue
        with spans.span("step"):
            done = engine.step()
        t = clock()
        for req in done:
            cam, t0 = handed.pop(req.request_id)
            cams.answered(cam)
            if t_open is not None:
                frames.append((t0, t, len(req.tokens), len(req.output),
                               req.tokens, req.output, req.request_id))
        if t_open is None:
            if done:
                t_open = t
                engine.reset_stats()
                window.enter_context(spans.span("window"))
        elif (done and t - t_open >= ctx.seconds) or \
                t - t_open >= ctx.seconds + STUCK_S:
            break
    window.close()
    if ctx.profiler is not None:
        ctx.profiler.stop()
    run.window = (t_open, t)
    run.frames = frames
    run.attempted = len(frames)
    run.engine_report = engine.report()

"""Training cells: the program's ``models/steps.py::train_step`` on batches
of token rows drawn from the seed (every row its own draw), with AdamW as
the traffic file states it.

Set-up builds the one train state (the weights from the seed, the
optimizer's moments) and drives it through the traffic's
``checked_steps`` first steps with the window's own call and feed; what
the comparison needs is read from that state as it goes: each step's loss,
the first gradient as the optimizer took it (from its first moment after
one step) and each leaf's change over the steps. The same state then runs
the window: steps until ``seconds`` have passed, each step's loss and
gradient norm read as a training loop reads them, so that the window ends
on a synchronise. The reference takes the first steps after the window.
"""
from __future__ import annotations

import gc
import math
import time

import torch

from harness import check, weights
from reference.train import leaves


def batch(ctx, i: int) -> dict:
    """Batch ``i``: (B, S + 1) token ids from the seed, as inputs and
    next-token labels."""
    tr = ctx.traffic
    g = weights.generator(ctx.seed, ctx.device, 100 + i)
    rows = torch.randint(0, ctx.arch.vocab_size,
                         (tr["batch"], tr["seq_len"] + 1), generator=g,
                         device=ctx.device)
    return {"tokens": rows[:, :-1].contiguous(),
            "labels": rows[:, 1:].contiguous()}


def measure(ctx) -> None:
    from repro_torch.models import model as M
    from repro_torch.models import steps as ST
    from repro_torch.optim import AdamWConfig, adamw_init

    run, tr = ctx.run, ctx.traffic
    o = tr["optimizer"]
    topts = ST.TrainOptions(
        opt=AdamWConfig(lr=o["lr"], b1=o["b1"], b2=o["b2"], eps=o["eps"],
                        weight_decay=o["weight_decay"],
                        clip_norm=o["clip_norm"]),
        schedule_total=o["total"], schedule_warmup=o["warmup"])
    opts = M.ModelOptions(use_kernels=ctx.config["use_kernels"],
                          remat=tr["remat"])
    params = weights.make(ctx.ref.tree(ctx.config), ctx.seed, ctx.device,
                          ctx.dtype)
    start = [p.clone() for p in leaves(params)]
    state = {"params": params, "opt": adamw_init(params, topts.opt)}
    del params
    prog = {"loss": []}
    for i in range(tr["checked_steps"]):
        state, m = ST.train_step(state, batch(ctx, i), ctx.arch, opts, topts)
        prog["loss"].append(float(m["loss"]))
        if i == 0:
            prog["grad1"] = [float(torch.linalg.vector_norm(x.double()))
                             / (1 - o["b1"]) for x in leaves(state["opt"]["m"])]
    prog["delta"] = [float(torch.linalg.vector_norm((p - q).double()))
                     for p, q in zip(leaves(state["params"]), start)]
    del start, m
    ctx.sync()
    gc.collect()
    gc.freeze()
    try:
        _window(ctx, ST, state, opts, topts)
    finally:
        gc.unfreeze()
    run.memory_peak = ctx.memory_peak()
    del state
    ctx.free()
    run.checks = check.training(
        ctx, prog, [batch(ctx, i) for i in range(tr["checked_steps"])])


def _window(ctx, ST, state, opts, topts) -> None:
    run, clock = ctx.run, time.perf_counter
    tokens = ctx.traffic["batch"] * ctx.traffic["seq_len"]
    i = ctx.traffic["checked_steps"]
    run.setup_s = ctx.since_start()
    if ctx.profiler is not None:
        ctx.profiler.start()
    with ctx.spans.span("window"):
        t_open = t = clock()
        while t - t_open < ctx.seconds:
            with ctx.spans.span("step"):
                state, m = ST.train_step(state, batch(ctx, i), ctx.arch,
                                         opts, topts)
                loss, norm = float(m["loss"]), float(m["grad_norm"])
            t = clock()
            run.steps.append(tokens)
            run.failed += not (math.isfinite(loss) and math.isfinite(norm))
            i += 1
    if ctx.profiler is not None:
        ctx.profiler.stop()
    run.window = (t_open, t)
    run.attempted = len(run.steps)

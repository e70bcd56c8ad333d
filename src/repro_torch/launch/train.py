"""Training launcher: trains a (reduced or full) configuration on the
synthetic pipeline, the port of ``repro.launch.train``. It runs on the GPU
unless told ``device="cpu"``. Weights come from a ``torch.Generator``
seeded by ``seed``, the step's batch from ``make_batch(seed + step)``; the
state is fp32 by default, as the reference's, and AdamW updates it in
place.

With a ``mesh`` (``launch.mesh``) the state is placed by the production
sharding rules (``sharding.state_specs``) and each batch by
``sharding.batch_specs``, and the step runs on DTensors; with more than one
microbatch the split keeps each microbatch on the data axes
(``TrainOptions.batch_axes``). Without one, it trains on one device.

    python -m repro_torch.launch.train [--full] [--arch olmo-1b] [--steps 20]
        [--mesh smoke|pod1|pod2]

``--mesh smoke`` starts a world of one rank (NCCL on the card, gloo on the
CPU); ``pod1`` and ``pod2`` join the world a launcher such as ``torchrun``
describes in the environment, one rank a GPU.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time

import torch
import torch.distributed as dist
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.checkpoint import save_checkpoint
from repro_torch.data.pipeline import InputShape, make_batch
from repro_torch.launch import sharding as SH
from repro_torch.launch.mesh import (data_axes, init_smoke_world,
                                     make_production_mesh, make_smoke_mesh)
from repro_torch.models import model as M
from repro_torch.models import steps as ST
from repro_torch.models.config import get_config, list_archs
from repro_torch.optim import AdamWConfig


def _value(t: torch.Tensor) -> float:
    return float(t.full_tensor() if hasattr(t, "full_tensor") else t)


def train(arch: str, *, reduced: bool = True, steps: int = 20,
          batch: int = 8, seq: int = 256, microbatches: int = 1,
          mesh=None, log_every: int = 5, checkpoint_path: str | None = None,
          dtype: torch.dtype = torch.float32, seed: int = 0, device="cuda",
          opts: M.ModelOptions | None = None) -> dict:
    """``steps`` AdamW steps of ``arch`` on ``batch`` × ``seq`` synthetic
    tokens, with remat and the kernels on unless ``opts`` says otherwise,
    on ``mesh`` if one is given (its device type must be ``device``'s).
    Returns the reference's record (arch, steps, first_loss, final_loss,
    wall_s, loss_history), the gradient norm of every step
    (grad_norm_history) and the host seconds of every step, from placing
    its batch to reading its loss (step_s_history)."""
    cfg = get_config(arch, reduced=reduced)
    shape = InputShape("custom_train", seq, batch, "train")
    opts = opts or M.ModelOptions(remat=True)
    topts = ST.TrainOptions(
        microbatches=microbatches, opt=AdamWConfig(),
        schedule_total=max(steps, 2), schedule_warmup=max(steps // 10, 1),
        batch_axes=data_axes(mesh) if mesh is not None and microbatches > 1
        else ())
    gen = torch.Generator(device=device).manual_seed(seed)
    state = ST.init_train_state(cfg, gen, dtype, topts, device=device)
    placed = contextlib.nullcontext
    if mesh is not None:
        if mesh.device_type != torch.device(device).type:
            raise ValueError(f"mesh on {mesh.device_type}, device {device}")
        policy = SH.ShardingPolicy.for_arch(cfg)
        state = SH.distribute(state, SH.state_specs(state, mesh, policy),
                              mesh)
        batch_spec = SH.batch_specs(cfg, shape, mesh)
        placed = implicit_replication

    history, norms, step_s = [], [], []
    t0 = time.monotonic()
    for i in range(steps):
        b = make_batch(cfg, shape, seed=seed + i, dtype=dtype, device=device)
        t1 = time.perf_counter()
        if mesh is not None:
            b = SH.distribute(b, batch_spec, mesh)
        with placed():
            state, metrics = ST.train_step(state, b, cfg, opts, topts)
        # reading the values waits for the step to finish
        loss, norm = _value(metrics["loss"]), _value(metrics["grad_norm"])
        step_s.append(time.perf_counter() - t1)
        history.append(loss)
        norms.append(norm)
        if i % log_every == 0 or i == steps - 1:
            print(f"step {i:5d}  loss {loss:.4f}  grad_norm {norm:.3f}")
    wall = time.monotonic() - t0

    if checkpoint_path:
        # a sharded state is gathered first, as the reference's store does
        save_checkpoint(checkpoint_path, SH.gather(state), cfg,
                        meta={"arch": arch, "steps": steps,
                              "final_loss": history[-1]})
    return {"arch": arch, "steps": steps, "first_loss": history[0],
            "final_loss": history[-1], "wall_s": round(wall, 1),
            "loss_history": history, "grad_norm_history": norms,
            "step_s_history": step_s}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list_archs(), default="olmo-1b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--mesh", choices=["smoke", "pod1", "pod2"], default=None)
    args = ap.parse_args()
    mesh = None
    if args.mesh == "smoke":
        init_smoke_world(args.device)
        mesh = make_smoke_mesh()
    elif args.mesh:
        dist.init_process_group("nccl" if args.device == "cuda" else "gloo")
        if args.device == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        mesh = make_production_mesh(multi_pod=args.mesh == "pod2")
    try:
        rec = train(args.arch, reduced=args.reduced, steps=args.steps,
                    batch=args.batch, seq=args.seq,
                    microbatches=args.microbatches, mesh=mesh,
                    checkpoint_path=args.checkpoint, device=args.device)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    print(json.dumps({k: v for k, v in rec.items()
                      if not k.endswith("_history")}, indent=2))


if __name__ == "__main__":
    main()

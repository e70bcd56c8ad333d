"""Training launcher: trains a (reduced or full) configuration on the
synthetic pipeline on one device, the port of ``repro.launch.train``
without its mesh (the port's distributed layer is still to come). It runs
on the GPU unless told ``device="cpu"``. Weights come from a
``torch.Generator`` seeded by ``seed``, the step's batch from
``make_batch(seed + step)``; the state is fp32 by default, as the
reference's, and AdamW updates it in place.

    python -m repro_torch.launch.train [--full] [--arch olmo-1b] [--steps 20]
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch.checkpoint import save_checkpoint
from repro_torch.data.pipeline import InputShape, make_batch
from repro_torch.models import model as M
from repro_torch.models import steps as ST
from repro_torch.models.config import get_config, list_archs
from repro_torch.optim import AdamWConfig


def train(arch: str, *, reduced: bool = True, steps: int = 20,
          batch: int = 8, seq: int = 256, microbatches: int = 1,
          log_every: int = 5, checkpoint_path: str | None = None,
          dtype: torch.dtype = torch.float32, seed: int = 0, device="cuda",
          opts: M.ModelOptions | None = None) -> dict:
    """``steps`` AdamW steps of ``arch`` on ``batch`` × ``seq`` synthetic
    tokens, with remat and the kernels on unless ``opts`` says otherwise.
    Returns the reference's record (arch, steps, first_loss, final_loss,
    wall_s, loss_history) and the gradient norm of every step
    (grad_norm_history)."""
    cfg = get_config(arch, reduced=reduced)
    shape = InputShape("custom_train", seq, batch, "train")
    opts = opts or M.ModelOptions(remat=True)
    topts = ST.TrainOptions(microbatches=microbatches, opt=AdamWConfig(),
                            schedule_total=max(steps, 2),
                            schedule_warmup=max(steps // 10, 1))
    gen = torch.Generator(device=device).manual_seed(seed)
    state = ST.init_train_state(cfg, gen, dtype, topts, device=device)

    history, norms = [], []
    t0 = time.monotonic()
    for i in range(steps):
        b = make_batch(cfg, shape, seed=seed + i, dtype=dtype, device=device)
        state, metrics = ST.train_step(state, b, cfg, opts, topts)
        loss, norm = float(metrics["loss"]), float(metrics["grad_norm"])
        history.append(loss)
        norms.append(norm)
        if i % log_every == 0 or i == steps - 1:
            print(f"step {i:5d}  loss {loss:.4f}  grad_norm {norm:.3f}")
    wall = time.monotonic() - t0

    if checkpoint_path:
        save_checkpoint(checkpoint_path, state, cfg,
                        meta={"arch": arch, "steps": steps,
                              "final_loss": history[-1]})
    return {"arch": arch, "steps": steps, "first_loss": history[0],
            "final_loss": history[-1], "wall_s": round(wall, 1),
            "loss_history": history, "grad_norm_history": norms}


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
    args = ap.parse_args()
    rec = train(args.arch, reduced=args.reduced, steps=args.steps,
                batch=args.batch, seq=args.seq,
                microbatches=args.microbatches,
                checkpoint_path=args.checkpoint, device=args.device)
    print(json.dumps({k: v for k, v in rec.items()
                      if not k.endswith("_history")}, indent=2))


if __name__ == "__main__":
    main()

"""Dry run across a production mesh: trace every (arch x input-shape)
combination's step on the port's H100 meshes and record its per-device
roofline inputs, the port of ``repro.launch.dryrun``. No real tensor is
allocated: parameters, optimizer state, caches and inputs are meta
tensors, placed as DTensors by the sharding rules over a fake process
group of 256 (``pod1``) or 512 (``pod2``) ranks, whose collectives do
nothing. ``launch.step_analysis`` counts what each rank would run.

    python -m repro_torch.launch.dryrun --arch olmo-1b --shape decode_32k --mesh pod1
    python -m repro_torch.launch.dryrun --all --mesh pod1

The reference compiles (``lower_s``, ``compile_s``); the port traces
eagerly, so a record has one ``trace_s``. The reference's per-arch
``MICROBATCHES`` were sized to a TPU's memory and are not carried over:
training defaults to 1 microbatch (``--microbatches`` sets it), and each
record gives its per-device argument bytes against the H100's 80 GB.
A process holds one default process group, so one process traces one mesh.
Records go to ``experiments/dryrun_torch/`` by default.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import torch
import torch.distributed as dist
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch import checkpoint
from repro_torch.data.pipeline import SHAPES, InputShape, input_specs
from repro_torch.launch import sharding as SH
from repro_torch.launch.mesh import POD1, POD2, make_production_mesh
from repro_torch.launch.step_analysis import analyze_step
from repro_torch.models import model as M
from repro_torch.models import steps as ST
from repro_torch.models.config import ArchConfig, get_config, list_archs
from repro_torch.optim import AdamWConfig, adamw_init

LONG_WINDOW = 4096  # sliding-window size for long_500k on quadratic archs
DEVICE_BYTES = 80e9  # one H100's HBM (NVIDIA's data sheet)
OUT_DIR = "experiments/dryrun_torch"


def init_fake_world(world_size: int) -> None:
    """The default process group: a fake one of ``world_size`` ranks (this
    process is rank 0), whose collectives return at once. It is part of
    the installed torch (``torch.testing._internal``), imported here alone
    so that a rename shows in one place."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() != world_size:
            raise RuntimeError(f"a process group of {dist.get_world_size()}"
                               f" ranks exists; {world_size} are needed")
        return
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def applicability(cfg: ArchConfig, shape: InputShape) -> str | None:
    """A skip reason, or None if the combination runs."""
    if shape.kind == "decode" and cfg.is_encoder:
        return "encoder-only architecture: no decode step"
    return None


def model_options(cfg: ArchConfig, shape: InputShape,
                  ring_cache: bool = False, remat: bool = True,
                  moe_local: bool = False,
                  blockwise_attention: int = 0,
                  gqa_expand_kv: bool = False,
                  moe_expert_constraint: bool = False) -> M.ModelOptions:
    """The reference's options: the plain path (the kernels do not run on
    meta tensors), long_500k on a quadratic arch as a sliding window."""
    window = 0
    if shape.name == "long_500k" and cfg.attention_is_quadratic:
        window = LONG_WINDOW
    return M.ModelOptions(use_kernels=False, window_override=window,
                          ring_cache=ring_cache,
                          remat=remat and shape.kind == "train",
                          moe_local_dispatch=moe_local,
                          blockwise_attention=blockwise_attention,
                          gqa_expand_kv=gqa_expand_kv and shape.kind == "train",
                          moe_expert_shard_constraint=moe_expert_constraint)


def build(cfg: ArchConfig, shape: InputShape, mesh, *,
          moe_shard_map: bool = False,
          policy: SH.ShardingPolicy | None = None,
          ring_cache: bool = False,
          microbatches: int | None = None,
          moe_local: bool = False,
          blockwise_attention: int = 0,
          gqa_expand_kv: bool = False,
          moe_expert_constraint: bool = False,
          dtype: torch.dtype = torch.bfloat16):
    """The step of this combination and its placed meta inputs: (step
    function, its arguments, extra record fields). Raises where a sharded
    dim does not divide the mesh (the reference's in_shardings would)."""
    policy = policy or SH.ShardingPolicy.for_arch(cfg)
    opts = model_options(cfg, shape, ring_cache=ring_cache,
                         moe_local=moe_local,
                         blockwise_attention=blockwise_attention,
                         gqa_expand_kv=gqa_expand_kv,
                         moe_expert_constraint=moe_expert_constraint)
    dp = tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))
    if moe_shard_map:
        opts = dataclasses.replace(opts, moe_shard_map_mesh=mesh,
                                   moe_shard_map_dp=dp)
    batch = SH.distribute(input_specs(cfg, shape, dtype=dtype),
                          SH.batch_specs(cfg, shape, mesh), mesh)
    params = checkpoint.meta_params(cfg, dtype)

    if shape.kind == "train":
        mb = microbatches or 1
        opt_dtype = torch.bfloat16 if cfg.param_count() > 1e11 \
            else torch.float32
        topts = ST.TrainOptions(microbatches=mb,
                                opt=AdamWConfig(state_dtype=opt_dtype),
                                batch_axes=dp if mb > 1 else ())
        state = {"params": params, "opt": adamw_init(params, topts.opt)}
        state = SH.distribute(state, SH.state_specs(state, mesh, policy),
                              mesh)
        fn = lambda s, b: ST.train_step(s, b, cfg, opts, topts)
        return fn, (state, batch), {"microbatches": mb}

    params = SH.distribute(params, SH.params_specs(params, mesh, policy),
                           mesh)
    cache = M.init_cache(cfg, shape.global_batch, shape.seq_len, dtype, opts,
                         device="meta")
    cache = SH.distribute(cache, SH.cache_specs(cache, cfg, shape, mesh,
                                                policy), mesh)
    if shape.kind == "prefill":
        fn = lambda p, b: ST.prefill_step(p, b, cfg, opts, shape.seq_len)
        return fn, (params, batch), {}
    fn = lambda p, c, b: ST.decode_step(p, c, b, cfg, opts)
    return fn, (params, cache, batch), {}


def run_one(arch: str, shape_name: str, mesh_name: str,
            ring_cache: bool = False, microbatches: int | None = None,
            policy: SH.ShardingPolicy | None = None,
            legacy_expert_sharding: bool = False,
            decode_seq_over_model: bool = False,
            moe_local: bool = False,
            blockwise_attention: int = 0,
            gqa_expand_kv: bool = False,
            moe_expert_constraint: bool = False,
            moe_shard_map: bool = False,
            fsdp_off: bool = False) -> dict:
    """Trace one combination on ``mesh_name`` ("pod1" or "pod2") and return
    its record. Starts the fake process group of that mesh's size if this
    process has none."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    multi_pod = mesh_name == "pod2"
    if policy is None:
        base = SH.ShardingPolicy.for_arch(cfg)
        policy = dataclasses.replace(
            base, fsdp=base.fsdp and not fsdp_off,
            expert_fallback_shard=not legacy_expert_sharding,
            decode_seq_over_model=decode_seq_over_model)
    rec: dict = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "mesh_shape": list((POD2 if multi_pod else POD1)[0]),
        "params": cfg.param_count(), "active_params": cfg.active_param_count(),
        "ring_cache": ring_cache,
        "moe_local": moe_local,
        "blockwise_attention": blockwise_attention,
        "policy": {"fsdp": policy.fsdp,
                   "expert_fallback_shard": policy.expert_fallback_shard,
                   "decode_seq_over_model": policy.decode_seq_over_model},
    }
    reason = applicability(cfg, shape)
    if reason:
        rec["skipped"] = reason
        return rec
    if shape.name == "long_500k" and cfg.attention_is_quadratic:
        rec["attn"] = "sliding"
    t0 = time.monotonic()
    init_fake_world(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod)
    fn, args, extra = build(cfg, shape, mesh, policy=policy,
                            moe_shard_map=moe_shard_map,
                            ring_cache=ring_cache,
                            microbatches=microbatches,
                            moe_local=moe_local,
                            blockwise_attention=blockwise_attention,
                            gqa_expand_kv=gqa_expand_kv,
                            moe_expert_constraint=moe_expert_constraint)
    rec.update(extra)
    with implicit_replication():
        _, analysis = analyze_step(fn, *args)
    rec["trace_s"] = round(time.monotonic() - t0, 3)
    rec.update(analysis)
    rec["memory"]["device_bytes"] = DEVICE_BYTES
    rec["memory"]["argument_share_of_device"] = \
        analysis["memory"]["argument_size_in_bytes"] / DEVICE_BYTES
    return rec


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list_archs())
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", choices=["pod1", "pod2"], default="pod1")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--ring-cache", action="store_true")
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--legacy-expert-sharding", action="store_true",
                    help="replicate experts that do not divide the model "
                         "axis, instead of sharding their matmul dims")
    ap.add_argument("--decode-seq-over-model", action="store_true",
                    help="shard the KV cache's sequence axis over model")
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args()
    if not args.all and not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --all")

    combos = ([(a, s) for a in list_archs() for s in SHAPES]
              if args.all else [(args.arch, args.shape)])
    os.makedirs(args.out, exist_ok=True)
    n_ok = n_skip = n_fail = 0
    for arch, shape in combos:
        tag = "ring_" if args.ring_cache else ""
        path = os.path.join(args.out, f"{tag}{arch}_{shape}_{args.mesh}.json")
        if args.skip_existing and os.path.exists(path):
            continue
        try:
            rec = run_one(arch, shape, args.mesh, ring_cache=args.ring_cache,
                          microbatches=args.microbatches,
                          legacy_expert_sharding=args.legacy_expert_sharding,
                          decode_seq_over_model=args.decode_seq_over_model)
            if "skipped" in rec:
                n_skip += 1
            else:
                n_ok += 1
                print(f"--- {arch} x {shape} x {args.mesh}: "
                      f"{rec['flops_per_device']:.4g} FLOP, "
                      f"{rec['bytes_per_device']:.4g} B, collectives "
                      f"{rec['collectives']['counts']}, "
                      f"{rec['trace_s']} s", flush=True)
        except Exception as e:
            rec = {"arch": arch, "shape": shape, "mesh": args.mesh,
                   "error": f"{type(e).__name__}: {e}",
                   "traceback": traceback.format_exc()}
            n_fail += 1
            print(f"FAIL {arch} x {shape} x {args.mesh}: {e}", flush=True)
        with open(path, "w") as f:
            json.dump(rec, f, indent=2)
    print(f"dry-run done: {n_ok} ok, {n_skip} skipped, {n_fail} failed")
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()

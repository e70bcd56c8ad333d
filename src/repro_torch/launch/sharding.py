"""Sharding rules: parameter, optimizer, batch and cache specs, the port of
``repro.launch.sharding``, and their DTensor placements.

Baseline policy, the reference's:
  * tensor-parallel over "model": attention heads, FFN hidden, experts,
    SSD inner dim, RG-LRU width, vocab (embedding rows / lm_head cols)
  * batch-parallel over ("pod", "data")
  * ``fsdp=True`` also shards the non-model major dim of large 2-D+
    weights over "data" (at >= 8e9 parameters)
  * long-context decode (batch 1): the KV cache's sequence axis is sharded
    over the data axes instead of the batch

A spec is a tuple with one entry per tensor dim: a mesh-axis name, a tuple
of names, or None, the entries of the reference's ``PartitionSpec``. The
port's parameters and caches are per-layer lists with no leading repeat
dim, so a leaf's spec is the reference's rule with the repeat dim
stripped (the reference prepends None under ``/scan/``).

``to_placements`` turns a spec into DTensor placements: ``Shard(d)`` on
each mesh dim that tensor dim d names, ``Replicate()`` elsewhere. DTensor
would shard an uneven dim without complaint; the reference's explicit
in_shardings reject it, so ``to_placements`` checks divisibility and
raises. ``distribute`` places a train state, parameter tree, cache or
batch by a spec tree of the same structure.

A mesh here is anything with ``mesh_dim_names`` and ``shape`` (a
``DeviceMesh``), so the specs of a 256-GPU mesh can be computed without
one.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
from torch.distributed.tensor import Replicate, Shard, distribute_tensor

from repro_torch.data.pipeline import InputShape
from repro_torch.models.config import ArchConfig


@dataclasses.dataclass(frozen=True)
class ShardingPolicy:
    fsdp: bool = False                 # shard major dims over "data" as well
    shard_seq_in_long_decode: bool = True
    # when experts do not divide the model axis, shard the expert matmul
    # dims instead of replicating them
    expert_fallback_shard: bool = True
    # shard the KV cache's sequence axis over "model" when the KV heads do
    # not divide it (False: shard head_dim)
    decode_seq_over_model: bool = False

    @staticmethod
    def for_arch(cfg: ArchConfig) -> "ShardingPolicy":
        return ShardingPolicy(fsdp=cfg.param_count() >= 8e9)


def axis_sizes(mesh) -> dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _dp(mesh):
    """The batch axes as a spec entry: a name, or a tuple of several (as a
    ``PartitionSpec`` normalises them)."""
    dp = tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))
    return dp[0] if len(dp) == 1 else dp


def _fsdp_axis(mesh, policy: ShardingPolicy) -> Optional[str]:
    return "data" if (policy.fsdp and "data" in mesh.mesh_dim_names) else None


def _names(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def param_spec(path: str, leaf, mesh, policy: ShardingPolicy) -> tuple:
    """The spec of one parameter leaf, identified by its path.

    Every axis assignment is divisibility-checked against the mesh; on
    failure the rule falls through a chain of alternative dims and in the
    end replicates. That is what lets odd vocabularies (50280, 151655, 504)
    and grok's 8 experts on a larger model axis place cleanly."""
    sizes = axis_sizes(mesh)
    fa = _fsdp_axis(mesh, policy)
    name = path.split("/")[-1]
    shape = tuple(leaf.shape)
    ndim = len(shape)

    def _ok(dim: int, axis) -> bool:
        return shape[dim] % math.prod(sizes[a] for a in _names(axis)) == 0

    def out(*axes):
        axes = list(axes) + [None] * (ndim - len(axes))
        used: set = set()
        clean = []
        for d, a in enumerate(axes):
            if a is not None and _ok(d, a) and a not in used:
                clean.append(a)
                used.add(a)
            else:
                clean.append(None)
        return tuple(clean)

    def chain(*candidates):
        """The first candidate whose every axis divides evenly wins."""
        for cand in candidates:
            full = list(cand) + [None] * (ndim - len(cand))
            if all(a is None or _ok(d, a) for d, a in enumerate(full)):
                return out(*cand)
        return out()

    if name == "embedding":                        # (V, D)
        return chain(("model", fa), (None, "model"))
    if name == "lm_head":                          # (D, V)
        return chain((fa, "model"), ("model", fa))
    if name in ("wq", "wk", "wv", "w1", "w3", "wx", "wgate", "in_proj"):
        if ndim == 3:                              # moe (E, D, F)
            if policy.expert_fallback_shard:
                return chain(("model", fa, None), (None, fa, "model"),
                             (None, None, "model"), (None, fa, None))
            return chain(("model", fa, None), (fa, None, "model"))
        return chain((fa, "model"), ("model", fa))
    if name in ("wo", "w2", "out_proj"):
        if ndim == 3:                              # moe (E, F, D)
            if policy.expert_fallback_shard:
                return chain(("model", None, fa), (None, "model", fa),
                             (None, "model", None), (None, None, fa))
            return chain(("model", None, fa), (fa, "model", None))
        return chain(("model", fa), (fa, "model"))
    if name in ("wr", "wi"):                       # rg-lru gates (W, W)
        return chain((fa, "model"))
    if name == "router":
        return out()
    if name == "conv_w":
        return chain((None, "model"))
    if name in ("conv_b", "norm_scale", "lam"):
        return chain(("model",))
    if name in ("A_log", "D", "dt_bias", "scale", "bias"):
        return out()
    if name == "step":
        return ()
    return (None,) * ndim


def _map_with_path(fn, tree, path: str = ""):
    """``tree`` (dicts and lists) with each leaf x replaced by fn(path, x);
    a path joins keys and list indices with "/"."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, f"{path}/{k}" if path else str(k))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_with_path(fn, v, f"{path}/{i}" if path else str(i))
                for i, v in enumerate(tree)]
    return fn(path, tree)


def params_specs(params, mesh, policy: ShardingPolicy):
    return _map_with_path(lambda p, x: param_spec(p, x, mesh, policy),
                          params)


def state_specs(state, mesh, policy: ShardingPolicy) -> dict:
    """Train state {params, opt{m, v, step}}: the moments mirror the
    parameters."""
    p_spec = params_specs(state["params"], mesh, policy)
    return {"params": p_spec,
            "opt": {"m": p_spec, "v": p_spec, "step": ()}}


def batch_specs(cfg: ArchConfig, shape: InputShape, mesh) -> dict:
    dp = _dp(mesh)
    b = dp if shape.global_batch > 1 else None
    if shape.kind in ("train", "prefill"):
        specs: dict = {}
        if cfg.frontend == "audio":
            specs["frames"] = (b, None, None)
        elif cfg.frontend == "vision":
            specs["tokens"] = (b, None)
            specs["patch_embeds"] = (b, None, None)
        else:
            specs["tokens"] = (b, None)
        if shape.kind == "train":
            specs["labels"] = (b, None)
        return specs
    return {"token": (b,), "pos": ()}


def _cache_leaf_spec(name: str, leaf, cfg: ArchConfig, shape: InputShape,
                     mesh, policy: ShardingPolicy) -> tuple:
    dp = _dp(mesh)
    batched = shape.global_batch > 1
    shard_seq = (not batched) and policy.shard_seq_in_long_decode
    # kv heads shard over "model" only when they divide it evenly; otherwise
    # shard head_dim (no padding; the contraction becomes a sum)
    msize = axis_sizes(mesh)["model"]
    kv_axis_on_heads = cfg.num_kv_heads % msize == 0
    b = dp if batched else None
    if name in ("k", "v"):       # (B, L, K, hd)
        if kv_axis_on_heads:
            mid = (None, "model", None)
        elif policy.decode_seq_over_model and leaf.shape[-3] % msize == 0:
            mid = ("model", None, None)
        else:
            mid = (None, None, "model")
        if batched:
            return (dp, *mid)
        if shard_seq and mid[0] is None:
            return (None, dp, *mid[1:])
        return (None, *mid)
    if name == "state":          # ssd (B, H, P, N)
        return (b, "model", None, None)
    if name == "conv":           # (B, W-1, C)
        return (b, None, "model")
    if name == "h":              # rglru (B, W)
        return (b, "model")
    return (None,) * leaf.dim()


def cache_specs(cache: list, cfg: ArchConfig, shape: InputShape, mesh,
                policy: ShardingPolicy) -> list:
    """One dict of specs per layer, as ``model.init_cache``'s list."""
    return [{name: _cache_leaf_spec(name, leaf, cfg, shape, mesh, policy)
             for name, leaf in layer.items()} for layer in cache]


def to_placements(spec: tuple, mesh, shape=None) -> list:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on each mesh
    dim that tensor dim d names, ``Replicate()`` on the others. A tensor dim
    named by several mesh axes must name them in mesh order (DTensor shards
    a dim over mesh dims left to right, as a ``PartitionSpec`` tuple does).
    With ``shape``, raise where a sharded dim does not divide evenly."""
    names = list(mesh.mesh_dim_names)
    sizes = axis_sizes(mesh)
    placements: list = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        axes = _names(entry)
        order = [names.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(f"spec {spec}: dim {d} names {axes} out of "
                             f"mesh order {tuple(names)}")
        n = math.prod(sizes[a] for a in axes)
        if shape is not None and axes and shape[d] % n:
            raise ValueError(f"spec {spec}: dim {d} of shape {tuple(shape)} "
                             f"does not divide into {n} shards over {axes}")
        for i in order:
            placements[i] = Shard(d)
    return placements


def distribute(tree, specs, mesh):
    """``tree`` (dicts and lists of tensors) as DTensors placed by ``specs``
    (a tree of the same structure). Every rank holds the same full tensor
    (the same seed, or meta tensors in the dry run), so each keeps its own
    shard and nothing is communicated."""
    if isinstance(tree, dict):
        return {k: distribute(v, specs[k], mesh) for k, v in tree.items()}
    if isinstance(tree, list):
        return [distribute(v, s, mesh) for v, s in zip(tree, specs)]
    return distribute_tensor(tree, mesh, to_placements(specs, mesh,
                                                       tree.shape),
                             src_data_rank=None)


def gather(tree):
    """``tree`` with every DTensor replaced by its full tensor (a
    collective on a sharded mesh); plain tensors as they are."""
    if isinstance(tree, dict):
        return {k: gather(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [gather(v) for v in tree]
    return tree.full_tensor() if hasattr(tree, "full_tensor") else tree


def constrain(x: torch.Tensor, spec: tuple) -> torch.Tensor:
    """The port of ``jax.lax.with_sharding_constraint``: a DTensor is
    redistributed to ``spec`` on its own mesh; a plain tensor is returned
    as it is."""
    mesh = getattr(x, "device_mesh", None)
    if mesh is None:
        return x
    return x.redistribute(mesh, to_placements(spec, mesh, x.shape))

"""The weight bridge: the reference's flat-npz checkpoints as the port's
parameters, and a seeded initialiser with the reference's distributions.

``repro.checkpoint.store.save_checkpoint`` writes one npz array per pytree
leaf, keyed by its path: ``embed/embedding``, ``final_norm/scale``,
``scan/[j]/mixer/wq``, ``rem/[i]/ffn/w1`` ... Leaves under ``scan/[j]`` are
stacked over the ``n_full`` repeats of the block pattern (leading repeat
dimension), so layer ``r * p + j`` is ``scan/[j]/...[r]``; leaves under
``rem/[i]`` are layer ``n_full * p + i``. ``nonparam_ln`` norms have no
leaves. The port's layout is described in ``repro_torch.models.model``.

``save_checkpoint`` and ``restore_checkpoint`` write and read that format
for any tree holding parameter trees, such as a train state
``{"params": ..., "opt": {"m": ..., "v": ..., "step": ...}}``: a path
``.../layers/<l>/...`` maps to ``.../scan/[j]/...`` (stacked over the
repeats) or ``.../rem/[i]/...`` as above, every other path is its own key
(``opt/step``), so the reference's ``restore_checkpoint`` reads the port's
train state into ``init_train_state``'s structure and the port reads the
reference's.

The SSD mixer's ``A_log``, ``D`` and ``dt_bias`` and the RG-LRU mixer's
``lam`` are fp32 in the reference whatever the parameters' dtype
(``repro.models.ssm.init_ssd``, ``repro.models.rglru.init_rglru``); both
``load_flat`` and ``init_params`` keep them fp32 (``FP32_LEAVES``).
"""
from __future__ import annotations

import json
import math
import os
from typing import Mapping, Optional, Union

import numpy as np
import torch

from repro_torch.models.config import ArchConfig
from repro_torch.models.model import check_kind
from repro_torch.models.rglru import RG_C
from repro_torch.models.ssm import N_GROUPS
from repro_torch.tree import items, map_tree

FP32_LEAVES = ("A_log", "D", "dt_bias", "lam")


def _norm_shapes(cfg: ArchConfig) -> dict:
    D = cfg.d_model
    if cfg.norm == "rmsnorm":
        return {"scale": (D,)}
    if cfg.norm == "layernorm":
        return {"scale": (D,), "bias": (D,)}
    if cfg.norm == "nonparam_ln":
        return {}
    raise ValueError(cfg.norm)


def _block_shapes(cfg: ArchConfig, kind) -> dict:
    check_kind(kind)
    D = cfg.d_model
    if kind[0] == "ssd":
        di, H, N = cfg.d_inner, cfg.ssm_heads, cfg.ssm_state
        conv_ch = di + 2 * N_GROUPS * N
        mixer = {"in_proj": (D, 2 * di + 2 * N_GROUPS * N + H),
                 "conv_w": (cfg.ssm_conv, conv_ch), "conv_b": (conv_ch,),
                 "A_log": (H,), "D": (H,), "dt_bias": (H,),
                 "norm_scale": (di,), "out_proj": (di, D)}
        if kind[1] is None:
            return {"norm1": _norm_shapes(cfg), "mixer": mixer}
    elif kind[0] == "rglru":
        W = cfg.rnn_width
        mixer = {"wx": (D, W), "wgate": (D, W), "conv_w": (cfg.rnn_conv, W),
                 "conv_b": (W,), "wr": (W, W), "wi": (W, W), "lam": (W,),
                 "wo": (W, D)}
    else:                                       # attn, attn_window
        H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        mixer = {"wq": (D, H * hd), "wk": (D, K * hd), "wv": (D, K * hd),
                 "wo": (H * hd, D)}
    if kind[1] == "moe":
        E, Fe = cfg.held_experts, cfg.moe_d_ff
        ffn = {"router": (D, cfg.num_experts), "w1": (E, D, Fe),
               "w2": (E, Fe, D)}
        if cfg.gated:
            ffn["w3"] = (E, D, Fe)
        if cfg.moe_shared_d_ff:
            Fs = cfg.moe_shared_d_ff
            ffn["shared"] = {"w1": (D, Fs), "w2": (Fs, D), "w3": (D, Fs)}
    else:
        ffn = {"w1": (D, cfg.d_ff), "w2": (cfg.d_ff, D)}
        if cfg.gated:
            ffn["w3"] = (D, cfg.d_ff)
    return {"norm1": _norm_shapes(cfg), "mixer": mixer,
            "norm2": _norm_shapes(cfg), "ffn": ffn}


def param_shapes(cfg: ArchConfig) -> dict:
    """The port's parameter tree with a shape tuple at every leaf."""
    embed = {"embedding": (cfg.vocab_size, cfg.d_model)}
    if not cfg.tie_embeddings:
        embed["lm_head"] = (cfg.d_model, cfg.vocab_size)
    return {"embed": embed, "final_norm": _norm_shapes(cfg),
            "layers": [_block_shapes(cfg, kind) for kind in cfg.layer_kinds]}


def _map_tree(fn, shapes, path=""):
    if isinstance(shapes, dict):
        return {k: _map_tree(fn, v, f"{path}/{k}" if path else k)
                for k, v in shapes.items()}
    if isinstance(shapes, list):
        return [_map_tree(fn, v, f"{path}/{i}") for i, v in enumerate(shapes)]
    return fn(path, shapes)


def _flat_key(cfg: ArchConfig, path: str) -> tuple[str, int | None]:
    """Port path ``layers/<l>/mixer/wq`` -> (npz key, repeat index)."""
    parts = path.split("/")
    if parts[0] != "layers":
        return path, None
    layer, rest = int(parts[1]), "/".join(parts[2:])
    p = len(cfg.block_pattern)
    n_full = cfg.num_layers // p
    if layer < n_full * p:
        return f"scan/[{layer % p}]/{rest}", layer // p
    return f"rem/[{layer - n_full * p}]/{rest}", None


def load_flat(path_or_dict: Union[str, os.PathLike, Mapping[str, np.ndarray]],
              cfg: ArchConfig, device="cuda",
              dtype: torch.dtype = torch.float32) -> dict:
    """Load a checkpoint written by the reference's ``save_checkpoint`` (a
    path, with or without ``.npz``, or the mapping ``np.load`` returns)
    into the port's parameter dict on ``device`` as ``dtype``."""
    if isinstance(path_or_dict, Mapping):
        data = path_or_dict
    else:
        path = os.fspath(path_or_dict)
        data = np.load(path if path.endswith(".npz") else path + ".npz")

    def leaf(path: str, shape: tuple) -> torch.Tensor:
        key, repeat = _flat_key(cfg, path)
        if key not in data:
            raise KeyError(f"checkpoint has no leaf {key!r} (for {path})")
        arr = np.asarray(data[key])
        if repeat is not None:
            arr = arr[repeat]
        if tuple(arr.shape) != tuple(shape):
            raise ValueError(f"{key}: shape {arr.shape} != {shape}")
        return torch.from_numpy(np.ascontiguousarray(arr)).to(
            device=device, dtype=_leaf_dtype(path, dtype))

    return _map_tree(leaf, param_shapes(cfg))


def _init_std(cfg: ArchConfig, path: str) -> float:
    """The reference's standard deviation of the normal-drawn leaf at port
    path ``path``. A mixer's ``wo`` and ``conv_w`` take their own mixer's
    std (an RG-LRU ``wo`` is 1/√W/√(2L), an attention ``wo`` 1/√(H·hd)/√(2L);
    an RG-LRU ``conv_w`` 1/√rnn_conv, an SSD one 1/√ssm_conv), and an FFN's
    ``w2`` its own FFN's (an MLP's 1/√d_ff/√(2L), an MoE's
    1/√moe_d_ff/√(2L), its shared expert's 1/√moe_shared_d_ff/√(2L)), so the
    layer's block kind is read from the path."""
    parts = path.split("/")
    name = parts[-1]
    kind = (cfg.layer_kinds[int(parts[1])] if parts[0] == "layers"
            else (None, None))
    mixer = kind[0] if parts[2:3] == ["mixer"] else None
    out = 1.0 / math.sqrt(2 * cfg.num_layers)        # output projections
    if name in ("wq", "wk", "wv", "w1", "w3", "in_proj", "lm_head", "wx",
                "wgate", "router"):
        return 1.0 / math.sqrt(cfg.d_model)
    if name in ("wr", "wi"):
        return 1.0 / math.sqrt(cfg.rnn_width)
    if name == "wo" and mixer == "rglru":
        return out / math.sqrt(cfg.rnn_width)
    if name == "wo":
        return out / math.sqrt(cfg.num_heads * cfg.head_dim)
    if name == "w2" and "shared" in parts:
        return out / math.sqrt(cfg.moe_shared_d_ff)
    if name == "w2" and kind[1] == "moe":
        return out / math.sqrt(cfg.moe_d_ff)
    if name == "w2":
        return out / math.sqrt(cfg.d_ff)
    if name == "out_proj":
        return out / math.sqrt(cfg.d_inner)
    if name == "conv_w" and mixer == "rglru":
        return 1.0 / math.sqrt(cfg.rnn_conv)
    if name == "conv_w":
        return 1.0 / math.sqrt(cfg.ssm_conv)
    if name == "embedding":
        return 0.02
    raise KeyError(path)


def _leaf_dtype(path: str, dtype: torch.dtype) -> torch.dtype:
    return torch.float32 if path.rsplit("/", 1)[-1] in FP32_LEAVES else dtype


def init_params(cfg: ArchConfig, generator: torch.Generator,
                dtype: torch.dtype = torch.float32, device="cuda") -> dict:
    """Random parameters with the reference's distributions
    (``repro.models.layers.init_attention/init_mlp/init_embed``,
    ``repro.models.moe.init_moe``, ``repro.models.ssm.init_ssd`` and
    ``repro.models.rglru.init_rglru``):
    N(0, 1) scaled by 1/sqrt(fan_in) (the convs by 1/sqrt(kernel width)),
    the output projections further by 1/sqrt(2 * num_layers), embeddings by
    0.02; norm scales 1, biases 0; SSD ``A_log = log(linspace(1, 16, H))``,
    ``D = 1`` and ``dt_bias ~ U(log 1e-3, log 1e-1)`` (the raw value, as the
    reference draws it); RG-LRU ``lam = log(expm1(-log(u) / (2 c)))`` with
    u ~ U(0.9², 0.999²), so that a = e^{-c softplus(lam)} lies in
    [0.9, 0.999] at r = 1. The SSD scalars and ``lam`` are fp32. Draws on
    ``generator``'s device, so the bits differ from JAX's."""
    fills = {"scale": 1.0, "bias": 0.0, "norm_scale": 1.0, "conv_b": 0.0,
             "D": 1.0}

    def leaf(path: str, shape: tuple) -> torch.Tensor:
        name = path.rsplit("/", 1)[-1]
        ldtype = _leaf_dtype(path, dtype)
        if name in fills:
            return torch.full(shape, fills[name], dtype=ldtype, device=device)
        if name == "A_log":
            return torch.log(torch.linspace(1.0, 16.0, shape[0],
                                            device=device))
        if name == "dt_bias":
            lo, hi = math.log(1e-3), math.log(1e-1)
            u = torch.rand(shape, generator=generator,
                           device=generator.device)
            return (u * (hi - lo) + lo).to(device=device)
        if name == "lam":
            lo, hi = 0.9 ** 2, 0.999 ** 2
            u = torch.rand(shape, generator=generator,
                           device=generator.device) * (hi - lo) + lo
            return torch.log(torch.expm1(-torch.log(u) / (2 * RG_C))).to(
                device=device)
        w = torch.randn(shape, generator=generator, device=generator.device)
        return (w * _init_std(cfg, path)).to(device=device, dtype=ldtype)

    return _map_tree(leaf, param_shapes(cfg))


def meta_params(cfg: ArchConfig, dtype: torch.dtype = torch.float32) -> dict:
    """``init_params``' tree as meta tensors of the same shapes and dtypes:
    the dry run's parameters, which allocate nothing."""
    return _map_tree(lambda path, shape: torch.empty(
        shape, dtype=_leaf_dtype(path, dtype), device="meta"),
        param_shapes(cfg))


def _tree_key(cfg: ArchConfig, path: str) -> tuple[str, int | None]:
    """Port path ``<prefix>/layers/<l>/...`` -> (npz key ``<prefix>/scan/[j]
    /...`` or ``<prefix>/rem/[i]/...``, repeat index); any other path is
    its own key."""
    parts = path.split("/")
    if "layers" not in parts:
        return path, None
    at = parts.index("layers")
    key, repeat = _flat_key(cfg, "/".join(parts[at:]))
    return "/".join(parts[:at] + [key]), repeat


def save_checkpoint(path: str, tree, cfg: ArchConfig,
                    meta: Optional[dict] = None) -> None:
    """Write ``tree`` (dicts and lists of tensors, e.g. a train state) as
    the reference's flat npz: layer leaves stacked over the block pattern's
    repeats under ``scan/[j]``, or under ``rem/[i]``, the rest by path.
    ``cfg`` gives the pattern, which the port's per-layer list does not
    carry. bf16 leaves are written as fp32 (numpy has no bf16; exact, and
    both restores cast to the target's dtype). ``meta`` goes to
    ``<path>.meta.json``."""
    flat: dict[str, np.ndarray] = {}
    stacked: dict[str, dict[int, np.ndarray]] = {}
    for p, leaf in items(tree):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        arr = t.cpu().numpy()
        key, repeat = _tree_key(cfg, p)
        if repeat is None:
            flat[key] = arr
        else:
            stacked.setdefault(key, {})[repeat] = arr
    for key in list(stacked):
        reps = stacked.pop(key)
        flat[key] = np.stack([reps[r] for r in range(len(reps))])
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **flat)
    if meta is not None:
        with open(path + ".meta.json", "w") as f:
            json.dump(meta, f, indent=2, default=str)


def restore_checkpoint(path: str, like, cfg: ArchConfig):
    """Read a flat npz (the port's or the reference's ``save_checkpoint``)
    into the structure of ``like``: each leaf's shape must match, and it
    takes ``like``'s dtype and device."""
    data = np.load(path if path.endswith(".npz") else path + ".npz")
    walked = iter(items(like))
    read: dict[str, np.ndarray] = {}   # each stacked key read once

    def leaf(_):
        p, t = next(walked)
        key, repeat = _tree_key(cfg, p)
        if key not in data:
            raise KeyError(f"checkpoint has no leaf {key!r} (for {p})")
        if key not in read:
            read[key] = np.asarray(data[key])
        arr = read[key]
        if repeat is not None:
            arr = arr[repeat]
        if tuple(arr.shape) != tuple(t.shape):
            raise ValueError(f"{key}: shape {arr.shape} != {tuple(t.shape)}")
        # np.array, not ascontiguousarray, which makes a 0-d leaf 1-d
        return torch.from_numpy(np.array(arr)).to(device=t.device,
                                                  dtype=t.dtype)

    return map_tree(leaf, like)

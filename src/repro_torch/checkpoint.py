"""The weight bridge: the reference's flat-npz checkpoints as the port's
parameters, and a seeded initialiser with the reference's distributions.

``repro.checkpoint.store.save_checkpoint`` writes one npz array per pytree
leaf, keyed by its path: ``embed/embedding``, ``final_norm/scale``,
``scan/[j]/mixer/wq``, ``rem/[i]/ffn/w1`` ... Leaves under ``scan/[j]`` are
stacked over the ``n_full`` repeats of the block pattern (leading repeat
dimension), so layer ``r * p + j`` is ``scan/[j]/...[r]``; leaves under
``rem/[i]`` are layer ``n_full * p + i``. ``nonparam_ln`` norms have no
leaves. The port's layout is described in ``repro_torch.models.model``.
"""
from __future__ import annotations

import math
import os
from typing import Mapping, Union

import numpy as np
import torch

from repro_torch.models.config import ArchConfig
from repro_torch.models.model import check_kind


def _norm_shapes(cfg: ArchConfig) -> dict:
    D = cfg.d_model
    if cfg.norm == "rmsnorm":
        return {"scale": (D,)}
    if cfg.norm == "layernorm":
        return {"scale": (D,), "bias": (D,)}
    if cfg.norm == "nonparam_ln":
        return {}
    raise ValueError(cfg.norm)


def param_shapes(cfg: ArchConfig) -> dict:
    """The port's parameter tree with a shape tuple at every leaf."""
    D, H, K, hd, Fd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                       cfg.head_dim, cfg.d_ff)
    embed = {"embedding": (cfg.vocab_size, D)}
    if not cfg.tie_embeddings:
        embed["lm_head"] = (D, cfg.vocab_size)
    ffn = {"w1": (D, Fd), "w2": (Fd, D)}
    if cfg.gated:
        ffn["w3"] = (D, Fd)
    block = {"norm1": _norm_shapes(cfg),
             "mixer": {"wq": (D, H * hd), "wk": (D, K * hd),
                       "wv": (D, K * hd), "wo": (H * hd, D)},
             "norm2": _norm_shapes(cfg), "ffn": ffn}
    for kind in cfg.layer_kinds:
        check_kind(kind)
    return {"embed": embed, "final_norm": _norm_shapes(cfg),
            "layers": [block] * cfg.num_layers}


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
            device=device, dtype=dtype)

    return _map_tree(leaf, param_shapes(cfg))


def init_params(cfg: ArchConfig, generator: torch.Generator,
                dtype: torch.dtype = torch.float32, device="cuda") -> dict:
    """Random parameters with the reference's distributions
    (``repro.models.layers.init_attention/init_mlp/init_embed``): N(0, 1)
    scaled by 1/sqrt(fan_in), the output projections further by
    1/sqrt(2 * num_layers), embeddings by 0.02; norm scales 1, biases 0.
    Draws on ``generator``'s device, so the bits differ from JAX's."""
    D, H, hd, L = cfg.d_model, cfg.num_heads, cfg.head_dim, cfg.num_layers
    s_in = 1.0 / math.sqrt(D)
    scale = {"wq": s_in, "wk": s_in, "wv": s_in, "w1": s_in, "w3": s_in,
             "wo": 1.0 / math.sqrt(H * hd) / math.sqrt(2 * L),
             "w2": 1.0 / math.sqrt(cfg.d_ff) / math.sqrt(2 * L),
             "embedding": 0.02, "lm_head": 1.0 / math.sqrt(D)}

    def leaf(path: str, shape: tuple) -> torch.Tensor:
        name = path.rsplit("/", 1)[-1]
        if name in ("scale", "bias"):
            fill = 1.0 if name == "scale" else 0.0
            return torch.full(shape, fill, dtype=dtype, device=device)
        w = torch.randn(shape, generator=generator, device=generator.device)
        return (w * scale[name]).to(device=device, dtype=dtype)

    return _map_tree(leaf, param_shapes(cfg))

"""Deterministic synthetic inputs for the four input shapes, ported from
``repro.data.pipeline`` (which imports jax).

``input_specs`` gives meta-device tensors of each input's shape and dtype:
the no-allocation stand-ins the dry run traces with. ``make_batch`` draws from ``np.random.default_rng(seed)`` in the same order
as the reference, so its arrays equal the reference's value for value; they
are returned as torch tensors on ``device``. For the audio and vision
architectures the modality encoder is stubbed: the batch carries frame or
projected patch *embeddings* of width d_model directly.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.models.config import ArchConfig


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # train | prefill | decode


SHAPES: dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


def input_specs(cfg: ArchConfig, shape: InputShape, *,
                dtype: torch.dtype = torch.bfloat16) -> dict:
    """Meta tensors standing in for every model input of this step kind:
    ``make_batch``'s keys, shapes and dtypes, with the reference's
    defaults (bf16 embeddings, int32 tokens, labels and positions)."""
    B, S = shape.global_batch, shape.seq_len
    meta = lambda shp, dt=torch.int32: torch.empty(shp, dtype=dt,
                                                   device="meta")
    if shape.kind in ("train", "prefill"):
        if cfg.frontend == "audio":
            specs = {"frames": meta((B, S, cfg.d_model), dtype)}
        elif cfg.frontend == "vision":
            P = cfg.num_patches
            specs = {"tokens": meta((B, S - P)),
                     "patch_embeds": meta((B, P, cfg.d_model), dtype)}
        else:
            specs = {"tokens": meta((B, S))}
        if shape.kind == "train":
            specs["labels"] = meta((B, S))
        return specs
    # decode: one token and a position (the cache comes separately)
    return {"token": meta((B,)), "pos": meta(())}


def make_batch(cfg: ArchConfig, shape: InputShape, seed: int = 0, *,
               dtype: torch.dtype = torch.float32, device="cuda") -> dict:
    """Real deterministic inputs of one step of ``shape.kind``.

    train / prefill: ``tokens`` (B, S) int32, or for ``frontend="vision"``
    ``tokens`` (B, S - num_patches) and ``patch_embeds`` (B, num_patches,
    D), or for ``frontend="audio"`` ``frames`` (B, S, D); train adds
    ``labels`` (B, S) int32, -100 where no loss is taken (the vision prefix;
    all but ~8% of audio frames). decode: ``token`` (B,) int32 and ``pos``,
    a 0-d int32 tensor."""
    rng = np.random.default_rng(seed)
    B, S = shape.global_batch, shape.seq_len
    ints = lambda a: torch.as_tensor(np.asarray(a, np.int32), device=device)
    floats = lambda a: torch.as_tensor(a, device=device).to(dtype)
    out: dict = {}
    if shape.kind in ("train", "prefill"):
        if cfg.frontend == "audio":
            out["frames"] = floats(
                rng.standard_normal((B, S, cfg.d_model), dtype=np.float32))
        elif cfg.frontend == "vision":
            P = cfg.num_patches
            out["tokens"] = ints(rng.integers(0, cfg.vocab_size, (B, S - P)))
            out["patch_embeds"] = floats(
                rng.standard_normal((B, P, cfg.d_model), dtype=np.float32))
        else:
            out["tokens"] = ints(rng.integers(0, cfg.vocab_size, (B, S)))
        if shape.kind == "train":
            labels = rng.integers(0, cfg.vocab_size, (B, S))
            if cfg.frontend == "vision":
                labels[:, : cfg.num_patches] = -100      # no loss on patches
            if cfg.frontend == "audio":
                # masked prediction: loss on a random 8% of frames
                mask = rng.random((B, S)) < 0.08
                labels = np.where(mask, labels % cfg.vocab_size, -100)
            out["labels"] = ints(labels)
    else:
        out["token"] = ints(rng.integers(0, cfg.vocab_size, (B,)))
        out["pos"] = ints(min(128, shape.seq_len - 1))
    return out


def synthetic_batch_iterator(cfg: ArchConfig, shape: InputShape, *,
                             dtype: torch.dtype = torch.float32,
                             start_seed: int = 0, device="cuda"):
    """Endless deterministic stream of training batches: ``make_batch`` at
    seeds start_seed, start_seed + 1, ..."""
    seed = start_seed
    while True:
        yield make_batch(cfg, shape, seed=seed, dtype=dtype, device=device)
        seed += 1

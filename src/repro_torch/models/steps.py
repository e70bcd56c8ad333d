"""Step functions for serving: prefill, decode and prefill-into-slot,
ported from ``repro.models.steps``. PyTorch runs eagerly, so there is no
jit wrapper; there is no train step in this slice."""
from __future__ import annotations

import torch

from repro_torch.models import model as M
from repro_torch.models.config import ArchConfig


@torch.no_grad()
def prefill_step(params, batch: dict, cfg: ArchConfig, opts: M.ModelOptions,
                 cache_len: int):
    return M.prefill(params, batch, cfg, opts, cache_len)


@torch.no_grad()
def decode_step(params, cache: list, batch: dict, cfg: ArchConfig,
                opts: M.ModelOptions):
    """``batch["pos"]`` may be an int (lock-step batch) or a (B,) tensor of
    per-slot positions (continuous batching). The cache is updated in
    place."""
    return M.decode_step(params, batch["token"], batch["pos"], cache, cfg,
                         opts)


@torch.no_grad()
def prefill_into_slot_step(params, cache: list, batch: dict, slot: int,
                           cfg: ArchConfig, opts: M.ModelOptions,
                           cache_len: int):
    """Prefill ONE request (leading batch dim of 1) and write its KV into
    row ``slot`` of an existing batched cache — the admission primitive of
    continuous batching: a new request joins a running pool without
    re-prefilling the other slots. Returns (last-position logits (V,),
    the batched cache, updated in place)."""
    logits, one = M.prefill(params, batch, cfg, opts, cache_len)
    return logits[0], M.insert_cache_slot(cache, one, slot)

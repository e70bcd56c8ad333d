"""Model assembly: blocks -> stack -> LM, ported from ``repro.models.model``.

Parameters are a plain dict::

    {"embed": {"embedding": (V, D)[, "lm_head": (D, V)]}, "final_norm": {...},
     "layers": [{"norm1": {...}, "mixer": {wq, wk, wv, wo},
                 "norm2": {...}, "ffn": {w1, w2[, w3]}}, ...]}

with one entry of ``layers`` per layer: the reference's ``lax.scan`` over
stacked repeats becomes a Python loop, and its (repeat, ...) leaves become
per-layer tensors (``repro_torch.checkpoint.load_flat`` splits them). An
``("ssd", None)`` layer has ``norm1`` and an SSD ``mixer`` (see
``models.ssm``) and no ``norm2``/``ffn``; an ``("rglru", "mlp")`` layer
has an RG-LRU ``mixer`` (see ``models.rglru``). The cache is a list with one
dict per layer and no leading repeat axis: ``{"k", "v"}`` of (B, L, K, hd)
for attention (for ``attn_window`` a ring of L = min(cache_len, window)
slots, position p in slot p % L), ``{"state", "conv"}`` for SSD and
``{"h", "conv"}`` for RG-LRU.

This port covers the block kinds in ``KINDS``. Modes:
  prefill      — full sequence, returns last-position logits + cache
  decode_step  — one token per row against the cache (updated in place)
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.models import layers, rglru, ssm
from repro_torch.models.config import ArchConfig


@dataclasses.dataclass(frozen=True)
class ModelOptions:
    """Execution options orthogonal to the architecture.

    ``use_kernels`` routes prefill attention, the prefill SSD scan and the
    RG-LRU of prefill and decode through the hand-written kernels
    (``kernels.ops``); unlike the reference it defaults to True, because
    the kernels are what the port serves with. ``remat`` is kept for parity
    with the reference's options; the port has no training step, so it
    changes nothing here."""

    use_kernels: bool = True
    remat: bool = True


KINDS = (("attn", "mlp"), ("attn_window", "mlp"), ("rglru", "mlp"),
         ("ssd", None))


def check_kind(kind) -> None:
    """Raise unless ``kind`` is a block this port runs."""
    if tuple(kind) not in KINDS:
        raise NotImplementedError(
            f"block kind {kind}: this port covers {KINDS} blocks")


def effective_window(cfg: ArchConfig, kind_mixer: str) -> int:
    """The sliding window a mixer attends over (0: none)."""
    return cfg.window if kind_mixer == "attn_window" else 0


def _kv_rows(cfg: ArchConfig, kind_mixer: str, cache_len: int) -> int:
    """Rows of an attention cache: a windowed mixer keeps a ring of
    min(cache_len, window) slots, any other mixer all cache_len positions."""
    w = effective_window(cfg, kind_mixer)
    return min(cache_len, w) if w > 0 else cache_len


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def init_block_cache(cfg: ArchConfig, kind, batch: int, cache_len: int,
                     dtype, device) -> dict:
    check_kind(kind)
    if kind[0] == "ssd":
        return ssm.ssd_init_cache(cfg, batch, dtype, device)
    if kind[0] == "rglru":
        return rglru.rglru_init_cache(cfg, batch, dtype, device)
    K, hd = cfg.num_kv_heads, cfg.head_dim
    shape = (batch, _kv_rows(cfg, kind[0], cache_len), K, hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def apply_block_full(params, x: torch.Tensor, cfg: ArchConfig, kind,
                     opts: ModelOptions, want_cache: bool,
                     cache_len: int = 0):
    """Full-sequence block. Returns (x, cache_or_None)."""
    check_kind(kind)
    mixer, ffn = kind
    h = layers.apply_norm(params["norm1"], x, cfg)
    cache = None
    if mixer == "ssd":
        out = ssm.ssd_forward(params["mixer"], h, cfg,
                              use_kernel=opts.use_kernels)
        if want_cache:
            cache = ssm.ssd_cache_from_prefill(params["mixer"], h, cfg)
    elif mixer == "rglru":
        out = rglru.rglru_forward(params["mixer"], h, cfg,
                                  use_kernel=opts.use_kernels,
                                  want_cache=want_cache)
        if want_cache:
            out, cache = out
    else:
        out, (k, v) = layers.attention_full(
            params["mixer"], h, cfg, window=effective_window(cfg, mixer),
            use_flash=opts.use_kernels)
        if want_cache:
            # a full-length cache (S <= cache_len) is the ring's padded case
            S, L = x.shape[1], _kv_rows(cfg, mixer, cache_len)
            cache = {"k": _ring_from_prefill(k, L, S),
                     "v": _ring_from_prefill(v, L, S)}
    x = x + out
    if ffn is None:
        return x, cache
    h2 = layers.apply_norm(params["norm2"], x, cfg)
    x = x + layers.apply_mlp(params["ffn"], h2, cfg)
    return x, cache


def _ring_from_prefill(k: torch.Tensor, L: int, S: int) -> torch.Tensor:
    """The last L of S prefill keys (or values) in ring order: position p in
    slot p % L; zero-padded to L when S <= L."""
    if S <= L:
        return F.pad(k, (0, 0, 0, 0, 0, L - S))
    return torch.roll(k[:, S - L:], (S - L) % L, dims=1)


def apply_block_decode(params, x: torch.Tensor, cache: dict, pos,
                       cfg: ArchConfig, kind, opts: ModelOptions):
    """One-token block. Returns (x, cache), the cache updated in place."""
    check_kind(kind)
    mixer, ffn = kind
    h = layers.apply_norm(params["norm1"], x, cfg)
    if mixer == "ssd":
        out, cache = ssm.ssd_step(params["mixer"], h, cache, cfg)
    elif mixer == "rglru":
        out, cache = rglru.rglru_step(params["mixer"], h, cache, cfg,
                                      use_kernel=opts.use_kernels)
    else:
        # a windowed mixer's cache is a ring of L <= window slots, which
        # holds exactly the last L positions
        decode = (layers.attention_decode_ring
                  if effective_window(cfg, mixer) > 0
                  else layers.attention_decode)
        out, ck, cv = decode(params["mixer"], h, cache["k"], cache["v"], pos,
                             cfg)
        cache = {"k": ck, "v": cv}
    x = x + out
    if ffn is None:
        return x, cache
    h2 = layers.apply_norm(params["norm2"], x, cfg)
    x = x + layers.apply_mlp(params["ffn"], h2, cfg)
    return x, cache


# ---------------------------------------------------------------------------
# Full model
# ---------------------------------------------------------------------------

def init_cache(cfg: ArchConfig, batch: int, cache_len: int, dtype,
               opts: ModelOptions, device="cuda") -> list:
    return [init_block_cache(cfg, kind, batch, cache_len, dtype, device)
            for kind in cfg.layer_kinds]


def insert_cache_slot(cache: list, one: list, slot: int) -> list:
    """Write a single-request cache (batch dim of size 1) into row ``slot``
    of a batched cache of the same cache_len, **in place**, and return it.
    The batch axis is axis 0 of every per-layer tensor (the reference's
    scan caches carry a leading repeat axis; these do not). Each row keeps
    the batched cache's dtype: the SSD and RG-LRU states stay fp32. A row
    of another shape raises rather than broadcast: a prompt shorter than
    ``ssm_conv - 1`` (``rnn_conv - 1``) tokens leaves a short SSD (RG-LRU)
    conv history (as in the reference, whose slot update then keeps stale
    rows)."""
    for big, small in zip(cache, one):
        for name in big:
            if tuple(small[name].shape) != (1, *big[name].shape[1:]):
                raise ValueError(
                    f"cache {name!r}: row of shape {tuple(small[name].shape)}"
                    f" does not fit a slot of {tuple(big[name].shape[1:])}")
            big[name][slot:slot + 1] = small[name].to(big[name].dtype)
    return cache


def apply_stack_full(params, x: torch.Tensor, cfg: ArchConfig,
                     opts: ModelOptions, want_cache: bool,
                     cache_len: int = 0):
    """All blocks over the full sequence. Returns (x, caches_or_None)."""
    caches = []
    for p, kind in zip(params["layers"], cfg.layer_kinds):
        x, c = apply_block_full(p, x, cfg, kind, opts, want_cache, cache_len)
        caches.append(c)
    return x, (caches if want_cache else None)


def prefill(params, batch: dict, cfg: ArchConfig, opts: ModelOptions,
            cache_len: int):
    """Full-sequence prefill of ``batch["tokens"]`` (B, S).
    Returns (last-position logits (B, V) in fp32, cache)."""
    x = layers.embed_tokens(params["embed"], batch["tokens"], cfg)
    x, cache = apply_stack_full(params, x, cfg, opts, want_cache=True,
                                cache_len=cache_len)
    x = layers.apply_norm(params["final_norm"], x, cfg)
    last = x[:, -1]
    logits = layers.unembed(params["embed"], last[:, None], cfg)[:, 0]
    return logits.float(), cache


def decode_step(params, token: torch.Tensor, pos, cache: list,
                cfg: ArchConfig, opts: ModelOptions):
    """One decode step. token: (B,) integer tensor; pos: an int or a (B,)
    tensor of per-row positions. Returns (logits (B, V) in fp32, cache),
    the cache updated in place."""
    x = layers.embed_tokens(params["embed"], token[:, None], cfg)
    new_cache = []
    for p, c, kind in zip(params["layers"], cache, cfg.layer_kinds):
        x, c = apply_block_decode(p, x, c, pos, cfg, kind, opts)
        new_cache.append(c)
    x = layers.apply_norm(params["final_norm"], x, cfg)
    logits = layers.unembed(params["embed"], x, cfg)[:, 0]
    return logits.float(), new_cache

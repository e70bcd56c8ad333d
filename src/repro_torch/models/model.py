"""Model assembly: blocks -> stack -> LM, ported from ``repro.models.model``.

Parameters are a plain dict::

    {"embed": {"embedding": (V, D)[, "lm_head": (D, V)]}, "final_norm": {...},
     "layers": [{"norm1": {...}, "mixer": {wq, wk, wv, wo},
                 "norm2": {...}, "ffn": {w1, w2[, w3]}}, ...]}

with one entry of ``layers`` per layer: the reference's ``lax.scan`` over
stacked repeats becomes a Python loop, and its (repeat, ...) leaves become
per-layer tensors (``repro_torch.checkpoint.load_flat`` splits them). An
``("ssd", None)`` layer has ``norm1`` and an SSD ``mixer`` (see
``models.ssm``) and no ``norm2``/``ffn``; an ``("attn", "moe")`` or
``("ssd", "moe")`` layer's ``ffn`` is ``{router, w1, w2[, w3][, shared]}``
(see ``models.moe``); an ``("rglru", "mlp")`` layer has an RG-LRU ``mixer``
(see ``models.rglru``). The cache is a list with one
dict per layer and no leading repeat axis: ``{"k", "v"}`` of (B, L, K, hd)
for attention (a ring of L = min(cache_len, window) slots, position p in
slot p % L, for ``attn_window`` or for ``ModelOptions.window_override`` with
``ring_cache``; else all cache_len positions), ``{"state", "conv"}`` for SSD
and ``{"h", "conv"}`` for RG-LRU.

``embed_inputs`` is the frontend: token embeddings, a vision prefix of
patch embeddings before them (``frontend="vision"``), or audio frame
embeddings plus sinusoidal positions (``frontend="audio"``). A config's
``embedding_multiplier`` scales the token embeddings, its
``residual_multiplier`` each block's mixer and FFN outputs before they join
the residual, and its ``logits_scaling`` divides the logits.

This port covers the block kinds in ``KINDS``. Modes:
  forward_hidden — full sequence, final-norm hidden states (an encoder)
                   and the MoE auxiliary loss
  loss_fn        — cross-entropy over ``forward_hidden``'s logits plus the
                   weighted MoE aux: the training objective
  prefill        — full sequence, returns last-position logits + cache
  decode_step    — one token per row against the cache (updated in place)
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers, moe, rglru, ssm
from repro_torch.models.config import ArchConfig


@dataclasses.dataclass(frozen=True)
class ModelOptions:
    """Execution options orthogonal to the architecture.

    ``use_kernels`` routes prefill attention, the prefill SSD scan and the
    RG-LRU of prefill and decode through the hand-written kernels
    (``kernels.ops``); unlike the reference it defaults to True, because
    the kernels are what the port serves with. In training, flash
    attention's gradient is a backward kernel too; the SSD and RG-LRU
    kernels have no backward yet and refuse grad on the card, so train
    those models with ``use_kernels=False``. ``window_override > 0``
    gives every full-attention (``attn``) mixer that sliding window (the
    reference's long-context option on dense models); with ``ring_cache``
    its cache is a ring of min(cache_len, window) slots, else the full
    length masked to the window. ``blockwise_attention > 0`` runs
    full-sequence attention as online softmax over KV blocks of that many
    keys; the flash kernel takes its place when the kernels are on, so the
    two are refused together. ``gqa_expand_kv`` repeats KV heads onto the
    query heads before full-sequence attention; it is for ``forward_hidden``
    only, since a prefill would hand back H-head K/V for a K-head decode
    cache (``prefill`` refuses it for GQA models). ``remat``, under grad mode,
    recomputes each block's activations in the backward instead of keeping
    them (``torch.utils.checkpoint``; the reference's ``jax.checkpoint`` of
    the scanned block body): training's memory for one more forward; it
    changes nothing without grad. The MoE options are the reference's:
    ``moe_local_dispatch`` routes per sequence (``moe.apply_moe_local``),
    ``moe_expert_shard_constraint`` pins the expert-sharded dispatch (see
    ``moe.apply_moe``), and a ``moe_shard_map_mesh`` (a ``DeviceMesh``)
    runs ``moe.apply_moe_shard_map`` over it with tokens sharded over
    ``moe_shard_map_dp``."""

    use_kernels: bool = True
    window_override: int = 0
    ring_cache: bool = False
    remat: bool = True
    moe_local_dispatch: bool = False
    blockwise_attention: int = 0
    gqa_expand_kv: bool = False
    moe_expert_shard_constraint: bool = False
    moe_shard_map_mesh: Any = None
    moe_shard_map_dp: tuple = ("data",)

    def __post_init__(self):
        if self.use_kernels and self.blockwise_attention > 0:
            raise ValueError("blockwise_attention needs use_kernels=False: "
                             "with the kernels on, the flash kernel runs "
                             "full-sequence attention")


KINDS = (("attn", "mlp"), ("attn", "moe"), ("attn_window", "mlp"),
         ("rglru", "mlp"), ("ssd", None), ("ssd", "moe"))


def check_kind(kind) -> None:
    """Raise unless ``kind`` is a block this port runs."""
    if tuple(kind) not in KINDS:
        raise NotImplementedError(
            f"block kind {kind}: this port covers {KINDS} blocks")


def effective_window(cfg: ArchConfig, kind_mixer: str,
                     opts: ModelOptions) -> int:
    """The sliding window a mixer attends over (0: none)."""
    if kind_mixer == "attn_window":
        return cfg.window
    if kind_mixer == "attn" and opts.window_override > 0:
        return opts.window_override
    return 0


def _is_ring(cfg: ArchConfig, kind_mixer: str, opts: ModelOptions) -> bool:
    """Whether a mixer's cache is a ring of min(cache_len, window) slots:
    an ``attn_window`` mixer's always, an overridden window's with
    ``ring_cache``."""
    return effective_window(cfg, kind_mixer, opts) > 0 and (
        opts.ring_cache or kind_mixer == "attn_window")


def _kv_rows(cfg: ArchConfig, kind_mixer: str, cache_len: int,
             opts: ModelOptions) -> int:
    """Rows of an attention cache: a ring keeps min(cache_len, window)
    slots, any other cache all cache_len positions."""
    if _is_ring(cfg, kind_mixer, opts):
        return min(cache_len, effective_window(cfg, kind_mixer, opts))
    return cache_len


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def init_block_cache(cfg: ArchConfig, kind, batch: int, cache_len: int,
                     dtype, opts: ModelOptions, device) -> dict:
    check_kind(kind)
    if kind[0] == "ssd":
        return ssm.ssd_init_cache(cfg, batch, dtype, device)
    if kind[0] == "rglru":
        return rglru.rglru_init_cache(cfg, batch, dtype, device)
    K, hd = cfg.num_kv_heads, cfg.head_dim
    shape = (batch, _kv_rows(cfg, kind[0], cache_len, opts), K, hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _residual(out: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """A block's mixer or FFN output as it joins the residual: times the
    config's ``residual_multiplier`` (no op at 1)."""
    r = cfg.residual_multiplier
    return out if r == 1.0 else out * r


def _apply_moe(params, h: torch.Tensor, cfg: ArchConfig, opts: ModelOptions,
               want_aux: bool):
    """An MoE FFN call, (out, aux): dropless (``capacity_factor`` 0, aux
    None unless ``want_aux``), or the reference's capacity forms by
    ``opts``."""
    if cfg.capacity_factor == 0:
        return moe.apply_moe_dropless(params, h, cfg, want_aux=want_aux,
                                      use_kernel=opts.use_kernels)
    if opts.moe_shard_map_mesh is not None:
        return moe.apply_moe_shard_map(params, h, cfg,
                                       opts.moe_shard_map_mesh,
                                       dp_axes=opts.moe_shard_map_dp)
    return moe.apply_moe(
        params, h, cfg, local_dispatch=opts.moe_local_dispatch,
        expert_shard_constraint=opts.moe_expert_shard_constraint)


def _apply_ffn(params, x: torch.Tensor, cfg: ArchConfig, ffn: str,
               opts: ModelOptions, want_aux: bool = True):
    """The block's FFN after its mixer: (x + FFN(norm2(x)), MoE aux or
    None)."""
    h = layers.apply_norm(params["norm2"], x, cfg)
    if ffn == "moe":
        out, aux = _apply_moe(params["ffn"], h, cfg, opts, want_aux)
        return x + _residual(out, cfg), aux
    return x + _residual(layers.apply_mlp(params["ffn"], h, cfg), cfg), None


def apply_block_full(params, x: torch.Tensor, cfg: ArchConfig, kind,
                     opts: ModelOptions, want_cache: bool,
                     cache_len: int = 0, want_aux: bool = True):
    """Full-sequence block. Returns (x, aux, cache_or_None): aux is the MoE
    auxiliary loss (fp32 scalar) of an ``moe`` FFN, else None; without
    ``want_aux`` the dropless form does not compute it (None)."""
    check_kind(kind)
    mixer, ffn = kind
    h = layers.apply_norm(params["norm1"], x, cfg)
    cache = None
    if mixer == "ssd":
        out = ssm.ssd_forward(params["mixer"], h, cfg,
                              use_kernel=opts.use_kernels,
                              want_cache=want_cache)
        if want_cache:
            out, cache = out
    elif mixer == "rglru":
        out = rglru.rglru_forward(params["mixer"], h, cfg,
                                  use_kernel=opts.use_kernels,
                                  want_cache=want_cache)
        if want_cache:
            out, cache = out
    else:
        out, (k, v) = layers.attention_full(
            params["mixer"], h, cfg,
            window=effective_window(cfg, mixer, opts),
            use_flash=opts.use_kernels, blockwise=opts.blockwise_attention,
            expand_kv=opts.gqa_expand_kv)
        if want_cache:
            # a full-length cache (S <= cache_len) is the ring's padded case
            S, L = x.shape[1], _kv_rows(cfg, mixer, cache_len, opts)
            if S > L and not _is_ring(cfg, mixer, opts):
                raise ValueError(f"prefill of {S} positions into a cache of "
                                 f"{L}")
            cache = {"k": _ring_from_prefill(k, L, S),
                     "v": _ring_from_prefill(v, L, S)}
    x = x + _residual(out, cfg)
    if ffn is None:
        return x, None, cache
    x, aux = _apply_ffn(params, x, cfg, ffn, opts, want_aux)
    return x, aux, cache


def _ring_from_prefill(k: torch.Tensor, L: int, S: int) -> torch.Tensor:
    """The last L of S prefill keys (or values) in ring order: position p in
    slot p % L; zero-padded to L when S <= L."""
    if S <= L:
        return F.pad(k, (0, 0, 0, 0, 0, L - S))
    return torch.roll(k[:, S - L:], (S - L) % L, dims=1)


def apply_block_decode(params, x: torch.Tensor, cache: dict, pos,
                       cfg: ArchConfig, kind, opts: ModelOptions):
    """One-token block. Returns (x, cache), the cache updated in place; an
    MoE FFN's aux is dropped, as in the reference (the dropless form does
    not compute it)."""
    check_kind(kind)
    mixer, ffn = kind
    h = layers.apply_norm(params["norm1"], x, cfg)
    if mixer == "ssd":
        out, cache = ssm.ssd_step(params["mixer"], h, cache, cfg)
    elif mixer == "rglru":
        out, cache = rglru.rglru_step(params["mixer"], h, cache, cfg,
                                      use_kernel=opts.use_kernels)
    else:
        w = effective_window(cfg, mixer, opts)
        if w > 0 and cache["k"].shape[1] <= w:
            # a ring of L <= window slots holds exactly the last L positions
            out, ck, cv = layers.attention_decode_ring(
                params["mixer"], h, cache["k"], cache["v"], pos, cfg)
        else:
            # a full-length cache, masked to the window if there is one
            out, ck, cv = layers.attention_decode(
                params["mixer"], h, cache["k"], cache["v"], pos, cfg,
                window=w)
        cache = {"k": ck, "v": cv}
    x = x + _residual(out, cfg)
    if ffn is None:
        return x, cache
    x, _ = _apply_ffn(params, x, cfg, ffn, opts, want_aux=False)
    return x, cache


# ---------------------------------------------------------------------------
# Full model
# ---------------------------------------------------------------------------

def init_cache(cfg: ArchConfig, batch: int, cache_len: int, dtype,
               opts: ModelOptions, device="cuda") -> list:
    return [init_block_cache(cfg, kind, batch, cache_len, dtype, opts,
                             device) for kind in cfg.layer_kinds]


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


def _sin_positions(S: int, D: int, dtype, device) -> torch.Tensor:
    """Sinusoidal absolute positions (S, D): sin in the even columns, cos in
    the odd ones, as the reference computes them."""
    pos = torch.arange(S, device=device, dtype=torch.float32)[:, None]
    div = torch.exp(-math.log(10_000.0) * torch.arange(
        0, D, 2, device=device, dtype=torch.float32) / D)
    pe = torch.zeros((S, D), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div[: (D + 1) // 2])
    return pe.to(dtype)


def embed_inputs(params, batch: dict, cfg: ArchConfig) -> torch.Tensor:
    """The frontend: ``batch["tokens"]`` embedded; for ``frontend="vision"``
    the projected ``batch["patch_embeds"]`` (B, P, D) before them; for
    ``frontend="audio"`` the frame embeddings ``batch["frames"]`` (B, S, D)
    plus sinusoidal positions (standing in for the stubbed frontend's conv
    positional embedding). Returns (B, S, D)."""
    if cfg.frontend == "audio":
        x = batch["frames"]
        return x + _sin_positions(x.shape[1], x.shape[2], x.dtype,
                                  x.device)[None]
    tok = _embed(params, batch["tokens"], cfg)
    if cfg.frontend == "vision":
        return torch.cat([batch["patch_embeds"].to(tok.dtype), tok], dim=1)
    return tok


def _embed(params, tokens: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Token embeddings times the config's ``embedding_multiplier`` (no op
    at 1)."""
    x = layers.embed_tokens(params["embed"], tokens, cfg)
    m = cfg.embedding_multiplier
    return x if m == 1.0 else x * m


def logits_of(params, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """The output head over final-norm hidden states x (..., D): the
    logits, divided by the config's ``logits_scaling`` (no op at 1)."""
    logits = layers.unembed(params["embed"], x, cfg)
    s = cfg.logits_scaling
    return logits if s == 1.0 else logits / s


def apply_stack_full(params, x: torch.Tensor, cfg: ArchConfig,
                     opts: ModelOptions, want_cache: bool,
                     cache_len: int = 0, want_aux: bool = True):
    """All blocks over the full sequence. Returns (x, aux, caches_or_None):
    aux is the MoE auxiliary loss summed over the layers, an fp32 scalar
    (0 without MoE blocks, and from dropless layers without
    ``want_aux``)."""
    caches = []
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = opts.remat and torch.is_grad_enabled()
    for p, kind in zip(params["layers"], cfg.layer_kinds):
        if remat:
            x, aux_l, c = checkpoint(apply_block_full, p, x, cfg, kind, opts,
                                     want_cache, cache_len, want_aux,
                                     use_reentrant=False)
        else:
            x, aux_l, c = apply_block_full(p, x, cfg, kind, opts, want_cache,
                                           cache_len, want_aux)
        if aux_l is not None:
            aux = aux + aux_l
        caches.append(c)
    return x, aux, (caches if want_cache else None)


def forward_hidden(params, batch: dict, cfg: ArchConfig, opts: ModelOptions):
    """Embed (``embed_inputs``), every block over the full sequence, final
    norm. Returns (hidden states (B, S, D), aux): aux is the MoE auxiliary
    loss summed over the layers, an fp32 scalar, 0 for a model without
    MoE blocks."""
    x = embed_inputs(params, batch, cfg)
    x, aux, _ = apply_stack_full(params, x, cfg, opts, want_cache=False)
    return layers.apply_norm(params["final_norm"], x, cfg), aux


MOE_AUX_WEIGHT = 0.01


def _logz_gold_sharded(logits: DTensor, labels: DTensor):
    """logsumexp over the vocab and the label's logit, for logits (B, S, V)
    on a mesh, without gathering the vocab: each rank takes its rows and
    vocab shard (``layers.row_placements``), the shard's max, Σ exp and the
    label's logit where it holds the label, and the shards are combined by
    a max and two sums over the mesh dims that split the vocab. Returns
    (logz, gold), (B, S) DTensors."""
    mesh = logits.device_mesh
    pl = layers.row_placements(logits, 2)
    local = logits.redistribute(mesh, pl).to_local()
    rows = [p if p == Shard(0) else Replicate() for p in pl]
    part = [Partial() if p == Shard(2) else r for p, r in zip(pl, rows)]
    V = local.shape[-1]
    first = layers.shard_index(mesh, pl, 2)
    with torch.no_grad():     # the shift changes no value or gradient
        m = DTensor.from_local(local.amax(dim=-1), mesh, [
            Partial("max") if p == Shard(2) else r
            for p, r in zip(pl, rows)], run_check=False)
        m = m.redistribute(mesh, rows).to_local()
    sumexp = DTensor.from_local(torch.exp(local - m[..., None]).sum(dim=-1),
                                mesh, part, run_check=False)
    idx = labels.redistribute(mesh, rows).to_local() - first * V
    mine = (idx >= 0) & (idx < V)
    gold = torch.gather(local, -1, idx.clamp(0, V - 1)[..., None])[..., 0]
    gold = DTensor.from_local(torch.where(mine, gold, 0.0), mesh, part,
                              run_check=False)
    m = DTensor.from_local(m, mesh, rows, run_check=False)
    return m + torch.log(sumexp.redistribute(mesh, rows)), \
        gold.redistribute(mesh, rows)


def loss_fn(params, batch: dict, cfg: ArchConfig, opts: ModelOptions):
    """Cross-entropy LM (or masked-prediction) loss over
    ``forward_hidden``'s logits in fp32, labels < 0 ignored, averaged over
    the n = max(#valid, 1) labelled positions, plus ``MOE_AUX_WEIGHT`` times
    the MoE aux. Returns (total, {"ce_loss", "aux_loss", "tokens"}), fp32
    0-d tensors, as ``repro.models.model.loss_fn``."""
    hidden, aux = forward_hidden(params, batch, cfg, opts)
    logits = logits_of(params, hidden, cfg).float()
    labels = batch["labels"].long()
    valid = labels >= 0
    safe = torch.where(valid, labels, 0)
    if isinstance(logits, DTensor):
        logz, gold = _logz_gold_sharded(logits, safe)
    else:
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, safe[..., None])[..., 0]
    nll = (logz - gold) * valid
    n = torch.clamp(valid.sum(), min=1)
    loss = nll.sum() / n
    total = loss + MOE_AUX_WEIGHT * aux
    return total, {"ce_loss": loss, "aux_loss": aux,
                   "tokens": n.float()}


def check_cache_options(cfg: ArchConfig, opts: ModelOptions) -> None:
    """Raise if ``opts`` cannot fill a decode cache: ``gqa_expand_kv`` on a
    GQA model would cache H K/V heads where ``init_cache`` holds K."""
    if opts.gqa_expand_kv and cfg.num_kv_heads < cfg.num_heads:
        raise ValueError(
            f"gqa_expand_kv: prefill would cache {cfg.num_heads} K/V heads "
            f"where the decode cache holds {cfg.num_kv_heads}; use it with "
            f"forward_hidden only")


def prefill(params, batch: dict, cfg: ArchConfig, opts: ModelOptions,
            cache_len: int):
    """Full-sequence prefill of ``embed_inputs(batch)``: ``batch["tokens"]``
    (B, S), after ``batch["patch_embeds"]`` for a vision model.
    Returns (last-position logits (B, V) in fp32, cache)."""
    check_cache_options(cfg, opts)
    x = embed_inputs(params, batch, cfg)
    x, _, cache = apply_stack_full(params, x, cfg, opts, want_cache=True,
                                   cache_len=cache_len, want_aux=False)
    x = layers.apply_norm(params["final_norm"], x, cfg)
    last = x[:, -1]
    logits = logits_of(params, last[:, None], cfg)[:, 0]
    return logits.float(), cache


def decode_step(params, token: torch.Tensor, pos, cache: list,
                cfg: ArchConfig, opts: ModelOptions):
    """One decode step. token: (B,) integer tensor; pos: an int or a (B,)
    tensor of per-row positions. Returns (logits (B, V) in fp32, cache),
    the cache updated in place."""
    x = _embed(params, token[:, None], cfg)
    new_cache = []
    for p, c, kind in zip(params["layers"], cache, cfg.layer_kinds):
        x, c = apply_block_decode(p, x, c, pos, cfg, kind, opts)
        new_cache.append(c)
    x = layers.apply_norm(params["final_norm"], x, cfg)
    logits = logits_of(params, x, cfg)[:, 0]
    return logits.float(), new_cache

"""Shared layers: norms, RoPE, GQA attention (full prefill and cached
decode), MLPs, embeddings. Plain functions over parameter dicts of tensors,
ported from ``repro.models.layers`` with the same layouts: activations are
(B, S, D), heads are split as (B, S, H, hd), caches are (B, S_max, K, hd).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.config import ArchConfig

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def apply_norm(params, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    xf = x.float()
    if cfg.norm == "rmsnorm":
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
        out = xf * torch.rsqrt(var + 1e-6)
        return (out * params["scale"].float()).to(x.dtype)
    if cfg.norm not in ("layernorm", "nonparam_ln"):
        raise ValueError(cfg.norm)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    # jnp.var is the population variance
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    out = (xf - mu) * torch.rsqrt(var + 1e-5)
    if cfg.norm == "layernorm":
        out = out * params["scale"].float() + params["bias"].float()
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: (..., S). Rotates the two halves of
    the head dimension (x[:hd/2], x[hd/2:]) as the reference does."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = torch.exp(-math.log(theta) * torch.arange(
        half, dtype=torch.float32, device=x.device) / half)
    angles = positions[..., :, None].float() * freqs        # (..., S, half)
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    xr1 = x1 * cos - x2 * sin
    xr2 = x2 * cos + x1 * sin
    return torch.cat([xr1, xr2], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def _split_heads(x: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    return x.reshape(*x.shape[:-1], n, hd)


def attention_full(params, x: torch.Tensor, cfg: ArchConfig, *,
                   window: int = 0, use_flash: bool = False):
    """Full-sequence attention (prefill). Returns (out, (k, v)).

    ``use_flash`` sends q, k, v through ``kernels.ops.flash_attention``:
    the hand-written CUDA kernel for CUDA tensors, its plain PyTorch
    version for CPU tensors. Otherwise the scores are formed by einsum as
    in the reference's jnp path. Queries sit at positions 0..S-1;
    ``window > 0`` keeps, for query s, the keys t > s - window."""
    B, S, D = x.shape
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    positions = torch.arange(S, device=x.device)[None, :]
    q = _split_heads(x @ params["wq"], H, hd)
    k = _split_heads(x @ params["wk"], K, hd)
    v = _split_heads(x @ params["wv"], K, hd)
    if cfg.causal:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)

    if use_flash:
        from repro_torch.kernels import ops as kops
        out = kops.flash_attention(q, k, v, causal=cfg.causal, window=window)
    else:
        G = H // K
        qg = q.reshape(B, S, K, G, hd)
        scores = torch.einsum("bskgh,btkh->bkgst", qg, k) / math.sqrt(hd)
        srange = torch.arange(S, device=x.device)
        mask = torch.ones((S, S), dtype=torch.bool, device=x.device)
        if cfg.causal:
            mask &= srange[None, :] <= srange[:, None]
        if window > 0:
            mask &= srange[None, :] > srange[:, None] - window
        scores = torch.where(mask, scores, NEG_INF)
        w = torch.softmax(scores.float(), dim=-1).to(x.dtype)
        out = torch.einsum("bkgst,btkh->bskgh", w, v)
    return out.reshape(B, S, H * hd) @ params["wo"], (k, v)


def _decode_qkv(params, x: torch.Tensor, pos, cfg: ArchConfig):
    """q, k, v of one new token per row, RoPE'd at ``pos`` (an int, or a
    (B,) tensor of per-row positions), and the positions as (B, 1)."""
    B = x.shape[0]
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = _split_heads(x @ params["wq"], H, hd)
    k = _split_heads(x @ params["wk"], K, hd)
    v = _split_heads(x @ params["wv"], K, hd)
    if isinstance(pos, torch.Tensor) and pos.dim() == 1:
        posb = pos.to(device=x.device, dtype=torch.long)[:, None]
    else:
        posb = torch.full((B, 1), int(pos), dtype=torch.long, device=x.device)
    return (rope(q, posb, cfg.rope_theta), rope(k, posb, cfg.rope_theta), v,
            posb)


def _decode_attend(params, q: torch.Tensor, cache_k: torch.Tensor,
                   cache_v: torch.Tensor, mask: torch.Tensor,
                   cfg: ArchConfig, dtype) -> torch.Tensor:
    """One query row per batch row against the cache under ``mask``
    (B, cache length); returns the output projection (B, 1, D)."""
    B = q.shape[0]
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    qg = q.reshape(B, 1, K, H // K, hd)
    scores = torch.einsum("bskgh,btkh->bkgst", qg, cache_k) / math.sqrt(hd)
    scores = torch.where(mask[:, None, None, None, :], scores, NEG_INF)
    w = torch.softmax(scores.float(), dim=-1).to(dtype)
    out = torch.einsum("bkgst,btkh->bskgh", w, cache_v).reshape(B, 1, H * hd)
    return out @ params["wo"]


def attention_decode(params, x: torch.Tensor, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, pos, cfg: ArchConfig):
    """One-token decode. x: (B, 1, D); cache_[kv]: (B, S_max, K, hd);
    pos: an int (one write position for every row) or a (B,) integer tensor
    of per-row positions (continuous batching: each slot decodes at its own
    depth). Writes the new key and value into the caches **in place** and
    returns (out, cache_k, cache_v)."""
    q, k, v, posb = _decode_qkv(params, x, pos, cfg)
    rows = torch.arange(x.shape[0], device=x.device)
    cache_k[rows, posb[:, 0]] = k[:, 0].to(cache_k.dtype)
    cache_v[rows, posb[:, 0]] = v[:, 0].to(cache_v.dtype)
    trange = torch.arange(cache_k.shape[1], device=x.device)
    mask = trange[None, :] <= posb                          # (B, S_max)
    out = _decode_attend(params, q, cache_k, cache_v, mask, cfg, x.dtype)
    return out, cache_k, cache_v


def attention_decode_ring(params, x: torch.Tensor, cache_k: torch.Tensor,
                          cache_v: torch.Tensor, pos, cfg: ArchConfig):
    """One-token decode against a ring (window-sized) cache of length L:
    position p lives in slot p % L. The ring holds exactly the last L
    positions, so the only mask is "slot already written" (arange(L) <= pos,
    all true once pos >= L). Keys are RoPE'd at their absolute position when
    written, so relative phases hold. ``pos`` is an int or (B,) per-row
    positions; the caches are written **in place**. Returns (out, cache_k,
    cache_v)."""
    q, k, v, posb = _decode_qkv(params, x, pos, cfg)
    L = cache_k.shape[1]
    rows = torch.arange(x.shape[0], device=x.device)
    slot = posb[:, 0] % L
    cache_k[rows, slot] = k[:, 0].to(cache_k.dtype)
    cache_v[rows, slot] = v[:, 0].to(cache_v.dtype)
    mask = torch.arange(L, device=x.device)[None, :] <= posb    # (B, L)
    out = _decode_attend(params, q, cache_k, cache_v, mask, cfg, x.dtype)
    return out, cache_k, cache_v


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def _act(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "silu":
        return F.silu(x)
    if kind == "gelu":
        return F.gelu(x, approximate="tanh")   # jax.nn.gelu's default
    if kind == "relu2":
        r = F.relu(x)
        return r * r
    raise ValueError(kind)


def apply_mlp(params, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    h = _act(x @ params["w1"], cfg.activation)
    if cfg.gated:
        h = h * (x @ params["w3"])
    return h @ params["w2"]


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------

def embed_tokens(params, tokens: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    return params["embedding"][tokens]


def unembed(params, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        return x @ params["embedding"].T
    return x @ params["lm_head"]

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
                   use_flash: bool = False):
    """Full-sequence attention (prefill). Returns (out, (k, v)).

    ``use_flash`` sends q, k, v through ``kernels.ops.flash_attention``:
    the hand-written CUDA kernel for CUDA tensors, its plain PyTorch
    version for CPU tensors. Otherwise the scores are formed by einsum as
    in the reference's jnp path. Queries sit at positions 0..S-1; this
    slice's blocks have no sliding window."""
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
        out = kops.flash_attention(q, k, v, causal=cfg.causal)
    else:
        G = H // K
        qg = q.reshape(B, S, K, G, hd)
        scores = torch.einsum("bskgh,btkh->bkgst", qg, k) / math.sqrt(hd)
        srange = torch.arange(S, device=x.device)
        mask = torch.ones((S, S), dtype=torch.bool, device=x.device)
        if cfg.causal:
            mask &= srange[None, :] <= srange[:, None]
        scores = torch.where(mask, scores, NEG_INF)
        w = torch.softmax(scores.float(), dim=-1).to(x.dtype)
        out = torch.einsum("bkgst,btkh->bskgh", w, v)
    return out.reshape(B, S, H * hd) @ params["wo"], (k, v)


def attention_decode(params, x: torch.Tensor, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, pos, cfg: ArchConfig):
    """One-token decode. x: (B, 1, D); cache_[kv]: (B, S_max, K, hd);
    pos: an int (one write position for every row) or a (B,) integer tensor
    of per-row positions (continuous batching: each slot decodes at its own
    depth). Writes the new key and value into the caches **in place** and
    returns (out, cache_k, cache_v)."""
    B = x.shape[0]
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    S_max = cache_k.shape[1]
    q = _split_heads(x @ params["wq"], H, hd)
    k = _split_heads(x @ params["wk"], K, hd)
    v = _split_heads(x @ params["wv"], K, hd)
    if isinstance(pos, torch.Tensor) and pos.dim() == 1:
        posb = pos.to(device=x.device, dtype=torch.long)[:, None]
    else:
        posb = torch.full((B, 1), int(pos), dtype=torch.long, device=x.device)
    q = rope(q, posb, cfg.rope_theta)
    k = rope(k, posb, cfg.rope_theta)
    rows = torch.arange(B, device=x.device)
    cache_k[rows, posb[:, 0]] = k[:, 0].to(cache_k.dtype)
    cache_v[rows, posb[:, 0]] = v[:, 0].to(cache_v.dtype)
    G = H // K
    qg = q.reshape(B, 1, K, G, hd)
    scores = torch.einsum("bskgh,btkh->bkgst", qg, cache_k) / math.sqrt(hd)
    trange = torch.arange(S_max, device=x.device)
    mask = trange[None, :] <= posb                          # (B, S_max)
    scores = torch.where(mask[:, None, None, None, :], scores, NEG_INF)
    w = torch.softmax(scores.float(), dim=-1).to(x.dtype)
    out = torch.einsum("bkgst,btkh->bskgh", w, cache_v).reshape(B, 1, H * hd)
    return out @ params["wo"], cache_k, cache_v


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

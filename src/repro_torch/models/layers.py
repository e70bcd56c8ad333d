"""Shared layers: norms, RoPE, GQA attention (full, blockwise or flash
prefill, causal or bidirectional, with an optional sliding window; cached
decode over a full-length or ring cache), MLPs, embeddings. Plain functions
over parameter dicts of tensors, ported from ``repro.models.layers`` with
the same layouts: activations are (B, S, D), heads are split as
(B, S, H, hd), caches are (B, S_max, K, hd).
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


def attention_blockwise(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        cfg: ArchConfig, *, window: int = 0,
                        block: int = 512) -> torch.Tensor:
    """Online-softmax attention over KV blocks of ``block`` keys, in plain
    torch ops (the reference writes it in jnp, not Pallas): one (S, block)
    score tile at a time, with the running max m, sum l and accumulator in
    fp32. q: (B,S,H,hd); k, v: (B,T,K,hd) with T a multiple of the block
    (after ``block = min(block, T)``). Queries and keys share positions
    0..; ``cfg.causal`` and ``window`` mask as in ``attention_full``.
    Returns (B,S,H,hd) in q's dtype."""
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    block = min(block, T)
    if T % block:
        raise ValueError(f"attention_blockwise: {T} keys are not a multiple "
                         f"of the block {block}")
    qg = q.reshape(B, S, K, G, hd)
    scale = 1.0 / math.sqrt(hd)
    q_idx = torch.arange(S, device=q.device)
    m = torch.full((B, K, G, S, 1), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, K, G, S, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, K, G, S, hd), dtype=torch.float32, device=q.device)
    for j in range(T // block):
        kj = k[:, j * block:(j + 1) * block]
        vj = v[:, j * block:(j + 1) * block]
        s = torch.einsum("bskgh,btkh->bkgst", qg, kj).float() * scale
        k_idx = j * block + torch.arange(block, device=q.device)
        mask = torch.ones((S, block), dtype=torch.bool, device=q.device)
        if cfg.causal:
            mask &= k_idx[None, :] <= q_idx[:, None]
        if window > 0:
            mask &= k_idx[None, :] > q_idx[:, None] - window
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bkgst,btkh->bkgsh", p.to(vj.dtype),
                                         vj).float()
        m = m_new
    l = torch.where(l == 0.0, 1.0, l)
    out = (acc / l).to(q.dtype)                           # (B,K,G,S,hd)
    return out.reshape(B, H, S, hd).transpose(1, 2).reshape(B, S, H, hd)


def attention_full(params, x: torch.Tensor, cfg: ArchConfig, *,
                   window: int = 0, use_flash: bool = False,
                   blockwise: int = 0, expand_kv: bool = False):
    """Full-sequence attention (prefill, or an encoder's forward). Returns
    (out, (k, v)).

    ``use_flash`` sends q, k, v through ``kernels.ops.flash_attention``:
    the hand-written CUDA kernel for CUDA tensors, its plain PyTorch
    version for CPU tensors. Otherwise ``blockwise > 0`` runs
    ``attention_blockwise`` over KV blocks of that size, and else the
    scores are formed by einsum as in the reference's jnp path. Queries sit
    at positions 0..S-1; ``window > 0`` keeps, for query s, the keys
    t > s - window; ``cfg.causal`` False (an encoder) masks nothing and
    applies no RoPE. ``expand_kv`` repeats each KV head onto its
    H / K query heads first (``repeat_interleave``, as the reference's
    ``jnp.repeat``): the same function, and the (k, v) returned are the
    expanded ones, as in the reference."""
    B, S, D = x.shape
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    positions = torch.arange(S, device=x.device)[None, :]
    q = _split_heads(x @ params["wq"], H, hd)
    k = _split_heads(x @ params["wk"], K, hd)
    v = _split_heads(x @ params["wv"], K, hd)
    if cfg.causal:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    if expand_kv and K < H:
        k = k.repeat_interleave(H // K, dim=2)
        v = v.repeat_interleave(H // K, dim=2)
        K = H

    if use_flash:
        from repro_torch.kernels import ops as kops
        out = kops.flash_attention(q, k, v, causal=cfg.causal, window=window)
    elif blockwise > 0:
        out = attention_blockwise(q, k, v, cfg, window=window,
                                  block=blockwise)
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
                     cache_v: torch.Tensor, pos, cfg: ArchConfig, *,
                     window: int = 0):
    """One-token decode. x: (B, 1, D); cache_[kv]: (B, S_max, K, hd);
    pos: an int (one write position for every row) or a (B,) integer tensor
    of per-row positions (continuous batching: each slot decodes at its own
    depth). ``window > 0`` masks the full-length cache to the keys
    t > pos - window. Writes the new key and value into the caches **in
    place** and returns (out, cache_k, cache_v)."""
    q, k, v, posb = _decode_qkv(params, x, pos, cfg)
    rows = torch.arange(x.shape[0], device=x.device)
    cache_k[rows, posb[:, 0]] = k[:, 0].to(cache_k.dtype)
    cache_v[rows, posb[:, 0]] = v[:, 0].to(cache_v.dtype)
    trange = torch.arange(cache_k.shape[1], device=x.device)
    mask = trange[None, :] <= posb                          # (B, S_max)
    if window > 0:
        mask &= trange[None, :] > posb - window
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

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
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.kernels import ops as kops
from repro_torch.models.config import ArchConfig

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def apply_norm(params, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    xf = x.float()
    if cfg.norm == "rmsnorm":
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
        out = xf * torch.rsqrt(var + cfg.rms_norm_eps)
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

def linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w for x (..., D_in) and w (D_in, D_out). On plain tensors
    ``kernels.ops.matmul``: a fp32 CUDA product of many rows with no
    gradient wanted (a prefill's) runs on the split-TF32 kernel, any other
    on ``x @ w``. On DTensors, tensor
    parallelism written out, so that no torch release's choice gathers a
    weight that the rules split: on the "model" mesh dim a weight sharded
    on its output dim is column-parallel (x gathered there, the output
    split, x's gradient a partial sum) and one sharded on its input dim is
    row-parallel (x split on its last dim, the output a partial sum); on
    the data axes the weight is gathered (an FSDP shard) and x keeps its
    batch sharding (the weight's gradient a partial sum over them)."""
    if not isinstance(w, DTensor):
        return kops.matmul(x, w)
    mesh = w.device_mesh
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    last = x.dim() - 1
    xp, xg, wp, wg, op = [], [], [], [], []
    for d, (a, p) in enumerate(zip(mesh.mesh_dim_names, w.placements)):
        if a == "model" and p == Shard(1):                  # column-parallel
            xp.append(Replicate()), xg.append(Partial())
            wp.append(p), wg.append(p), op.append(Shard(last))
        elif a == "model" and p == Shard(0):                # row-parallel
            xp.append(Shard(last)), xg.append(Shard(last))
            wp.append(p), wg.append(p), op.append(Partial())
        else:
            b = x.placements[d] if x.placements[d] == Shard(0) \
                else Replicate()
            xp.append(b), xg.append(b), op.append(b)
            wp.append(Replicate())
            wg.append(Partial() if b == Shard(0) else Replicate())
    out = x.redistribute(mesh, xp).to_local(grad_placements=xg) @ \
        w.redistribute(mesh, wp).to_local(grad_placements=wg)
    return DTensor.from_local(out, mesh, op, run_check=False)


def scale_queries(q: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """q pre-scaled so that the kernels' and the einsums' 1/√hd softmax
    scale becomes ``cfg.attention_multiplier``; unchanged where it is 0."""
    if not cfg.attention_multiplier:
        return q
    return q * (cfg.attention_multiplier * math.sqrt(cfg.head_dim))


def _split_heads(x: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    """(..., n·hd) -> (..., n, hd). A DTensor whose last dim is sharded into
    a count of shards that does not divide the n heads is gathered on it
    first (DTensor cannot split a sharded dim unevenly)."""
    if isinstance(x, DTensor):
        last = Shard(x.dim() - 1)
        if n % math.prod(x.device_mesh.size(d) for d, p in
                         enumerate(x.placements) if p == last):
            x = x.redistribute(x.device_mesh, [
                Replicate() if p == last else p for p in x.placements])
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


def shard_index(mesh, placements, dim: int) -> int:
    """This rank's place among the shards of tensor dim ``dim`` under
    ``placements`` (mesh dims that split one tensor dim do so left to
    right); 0 where the dim is whole."""
    first = 0
    for d, p in enumerate(placements):
        if p == Shard(dim):
            first = first * mesh.size(d) + mesh.get_local_rank(d)
    return first


def row_placements(t: DTensor, keep: int) -> list:
    """Placements for running a computation that is independent per batch
    row and per index of dim ``keep`` (a head, a vocab entry) on ``t``'s
    shards: a sharding of the batch (dim 0) or of ``keep`` stays; on every
    other mesh dim, in mesh order, ``keep`` is sharded if its shards divide
    it, else the batch if they divide it, else nothing. So no rank repeats
    another's work, whatever ``t`` held there (a pending sum is
    reduce-scattered)."""
    mesh = t.device_mesh
    kept = (Shard(0), Shard(keep))
    n = {0: 1, keep: 1}
    for d, p in enumerate(t.placements):
        if p in kept:
            n[p.dim] *= mesh.size(d)
    out = []
    for d, p in enumerate(t.placements):
        if p in kept:
            out.append(p)
            continue
        for dim in (keep, 0):
            if t.shape[dim] % (n[dim] * mesh.size(d)) == 0:
                n[dim] *= mesh.size(d)
                out.append(Shard(dim))
                break
        else:
            out.append(Replicate())
    return out


def _heads_local(fn, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 *rows: torch.Tensor) -> torch.Tensor:
    """fn(q, k, v, *rows) -> (B, S, H, hd), attention that is independent
    per batch row and per head, on plain tensors. On DTensors (a mesh) fn
    gets each rank's own rows and heads, and its output is wrapped back as
    a DTensor. q's rows and heads are split over the mesh as far as they
    divide (``row_placements``); k, v and each of ``rows`` (per-row
    tensors such as a decode mask) take the same batch sharding. Where the
    KV heads divide as the query heads do, k and v are split the same way
    (rank i's KV heads are then the ones its query heads read); else they
    are whole there and each rank slices the KV heads its query heads
    read, their gradient then partial over the mesh dims that split the
    query heads. A sharding of k and v on the keys or head_dim is
    gathered. This is exact; the kernels and the plain
    attention never see a DTensor (a DTensor einsum would merge a sharded
    batch dim with a sharded head dim, which some torch releases
    refuse)."""
    if not isinstance(q, DTensor):
        return fn(q, k, v, *rows)
    mesh = q.device_mesh
    qp = row_placements(q, 2)
    split = [d for d, p in enumerate(qp) if p == Shard(2)]
    aligned = k.shape[2] % math.prod(mesh.size(d) for d in split) == 0
    kvp = [p if p == Shard(0) or (aligned and p == Shard(2)) else Replicate()
           for p in qp]
    grad = [Partial() if p == Shard(2) and not aligned else kp
            for p, kp in zip(qp, kvp)]
    q_loc = q.redistribute(mesh, qp).to_local()
    k_loc, v_loc = (t.redistribute(mesh, kvp).to_local(grad_placements=grad)
                    for t in (k, v))
    rp = [p if p == Shard(0) else Replicate() for p in qp]
    rows = [(r if isinstance(r, DTensor) else DTensor.from_local(
        r, mesh, [Replicate()] * mesh.ndim, run_check=False)).redistribute(
        mesh, rp).to_local() for r in rows]
    if split and not aligned:
        G = q.shape[2] // k.shape[2]
        heads = q_loc.shape[2]
        h0 = shard_index(mesh, qp, 2) * heads
        k_loc = k_loc[:, :, h0 // G:(h0 + heads - 1) // G + 1]
        v_loc = v_loc[:, :, h0 // G:(h0 + heads - 1) // G + 1]
    return DTensor.from_local(fn(q_loc, k_loc, v_loc, *rows), mesh, qp,
                              run_check=False)


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            mask: torch.Tensor) -> torch.Tensor:
    """softmax(q kᵀ / √hd) v under ``mask`` (broadcast to (B, K, G, S,
    T)), the scores formed by einsum over GQA groups as in the reference's
    jnp path: q (B, S, H, hd), k and v (B, T, K, hd) -> (B, S, H, hd)."""
    B, S, H, hd = q.shape
    K = k.shape[2]
    qg = q.reshape(B, S, K, H // K, hd)
    scores = torch.einsum("bskgh,btkh->bkgst", qg, k) / math.sqrt(hd)
    scores = torch.where(mask, scores, NEG_INF)
    w = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    return torch.einsum("bkgst,btkh->bskgh", w, v).reshape(B, S, H, hd)


def attention_full(params, x: torch.Tensor, cfg: ArchConfig, *,
                   window: int = 0, positions: torch.Tensor | None = None,
                   use_flash: bool = False, blockwise: int = 0,
                   expand_kv: bool = False):
    """Full-sequence attention (prefill, or an encoder's forward). Returns
    (out, (k, v)).

    ``use_flash`` sends q, k, v through ``kernels.ops.flash_attention``:
    the hand-written CUDA kernel for CUDA tensors, its plain PyTorch
    version for CPU tensors. Otherwise ``blockwise > 0`` runs
    ``attention_blockwise`` over KV blocks of that size, and else the
    scores are formed by einsum as in the reference's jnp path.
    ``positions``, (1, S) or (B, S), are the RoPE positions of q and k
    (default 0..S-1); as in the reference they feed RoPE only, and the
    masks stay in index space: ``window > 0`` keeps, for query s, the keys
    t > s - window; ``cfg.causal`` False (an encoder) masks nothing and
    applies no RoPE. ``expand_kv`` repeats each KV head onto its
    H / K query heads first (``repeat_interleave``, as the reference's
    ``jnp.repeat``): the same function, and the (k, v) returned are the
    expanded ones, as in the reference."""
    B, S, D = x.shape
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    q = _split_heads(linear(x, params["wq"]), H, hd)
    k = _split_heads(linear(x, params["wk"]), K, hd)
    v = _split_heads(linear(x, params["wv"]), K, hd)
    if cfg.causal and cfg.rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    q = scale_queries(q, cfg)
    if expand_kv and K < H:
        k = k.repeat_interleave(H // K, dim=2)
        v = v.repeat_interleave(H // K, dim=2)
        K = H

    if use_flash:
        fn = lambda q, k, v: kops.flash_attention(q, k, v, causal=cfg.causal,
                                                  window=window)
    elif blockwise > 0:
        fn = lambda q, k, v: attention_blockwise(q, k, v, cfg, window=window,
                                                 block=blockwise)
    else:
        def fn(q, k, v):
            srange = torch.arange(S, device=q.device)
            mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
            if cfg.causal:
                mask &= srange[None, :] <= srange[:, None]
            if window > 0:
                mask &= srange[None, :] > srange[:, None] - window
            return _attend(q, k, v, mask)
    out = _heads_local(fn, q, k, v)
    return linear(out.reshape(B, S, H * hd), params["wo"]), (k, v)


def _decode_qkv(params, x: torch.Tensor, pos, cfg: ArchConfig):
    """q, k, v of one new token per row, RoPE'd at ``pos`` (an int, or a
    (B,) tensor of per-row positions) unless the config has no RoPE, q
    scaled by ``scale_queries``, and the positions as (B, 1)."""
    B = x.shape[0]
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = _split_heads(linear(x, params["wq"]), H, hd)
    k = _split_heads(linear(x, params["wk"]), K, hd)
    v = _split_heads(linear(x, params["wv"]), K, hd)
    if isinstance(pos, torch.Tensor):
        # a 0-d position is broadcast without reading it on the host
        posb = pos.to(device=x.device, dtype=torch.long).reshape(-1) \
            .expand(B)[:, None]
    else:
        posb = torch.full((B, 1), int(pos), dtype=torch.long, device=x.device)
    if cfg.rope:
        q, k = rope(q, posb, cfg.rope_theta), rope(k, posb, cfg.rope_theta)
    return scale_queries(q, cfg), k, v, posb


def _write_rows(cache: torch.Tensor, slot: torch.Tensor,
                new: torch.Tensor) -> None:
    """cache[b, slot[b, 0]] = new[b, 0] for every row b, **in place**;
    cache (B, L, K, hd), slot (B, 1), new (B, 1, K, hd). On DTensors the
    write is made on each rank's shard: ``new`` and ``slot`` are brought to
    the cache's batch and head sharding, and where the cache's slots are
    sharded (long-context decode) a rank writes only the rows whose slot it
    holds (the others write back what they read)."""
    if not isinstance(cache, DTensor):
        rows = torch.arange(cache.shape[0], device=cache.device)
        cache[rows, slot[:, 0]] = new[:, 0].to(cache.dtype)
        return
    mesh = cache.device_mesh
    pl = [Replicate() if p == Shard(1) else p for p in cache.placements]
    new = new.redistribute(mesh, pl).to_local()
    slot = slot.redistribute(mesh, [p if p == Shard(0) else Replicate()
                                    for p in pl]).to_local()[:, 0]
    local = cache.to_local()
    L = local.shape[1]
    slot = slot - shard_index(mesh, cache.placements, 1) * L
    rows = torch.arange(local.shape[0], device=local.device)
    mine = (slot >= 0) & (slot < L)
    slot = slot.clamp(0, L - 1)
    val = new[:, 0].to(local.dtype)
    if L < cache.shape[1]:
        val = torch.where(mine[:, None, None], val, local[rows, slot])
    local[rows, slot] = val


def _decode_attend(params, q: torch.Tensor, cache_k: torch.Tensor,
                   cache_v: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """One query row per batch row against the cache under ``mask``
    (B, cache length); returns the output projection (B, 1, D)."""
    B = q.shape[0]
    attend = lambda q, k, v, m: _attend(q, k, v, m[:, None, None, None, :])
    if isinstance(cache_k, DTensor) and Shard(3) in cache_k.placements:
        out = _attend_split_head_dim(q, cache_k, cache_v, mask)
    else:
        out = _heads_local(attend, q, cache_k, cache_v, mask)
    return linear(out.reshape(B, 1, -1), params["wo"])


def _attend_split_head_dim(q: DTensor, k: DTensor, v: DTensor,
                           mask) -> DTensor:
    """``_attend`` against a cache whose head_dim is sharded (the rules'
    layout when the KV heads do not divide the model axis): on the mesh
    dims that split head_dim, each rank forms its part of every score from
    its slice of q and k, one all-reduce sums the parts, and each rank
    weights its slice of v, so its output is its head_dim slice. The rows
    take the cache's batch sharding; a sharding of the cache's keys is
    gathered. Returns (B, S, H, hd) with the heads split where they
    divide."""
    mesh = k.device_mesh
    hd = [p == Shard(3) for p in k.placements]
    kvp = [Shard(3) if h else p if p == Shard(0) else Replicate()
           for h, p in zip(hd, k.placements)]
    rows = [Shard(0) if p == Shard(0) else Replicate() for p in kvp]
    q_loc = q.redistribute(mesh, kvp).to_local()
    k_loc, v_loc = (t.redistribute(mesh, kvp).to_local() for t in (k, v))
    if not isinstance(mask, DTensor):
        mask = DTensor.from_local(mask, mesh, [Replicate()] * mesh.ndim,
                                  run_check=False)
    mask = mask.redistribute(mesh, rows).to_local()
    B, S, H, hd_loc = q_loc.shape
    K = k_loc.shape[2]
    qg = q_loc.reshape(B, S, K, H // K, hd_loc)
    part = torch.einsum("bskgh,btkh->bkgst", qg, k_loc) / math.sqrt(q.shape[3])
    scores = DTensor.from_local(part, mesh, [
        Partial() if h else r for h, r in zip(hd, rows)], run_check=False)
    scores = scores.redistribute(mesh, rows).to_local()
    scores = torch.where(mask[:, None, None, None, :], scores, NEG_INF)
    w = torch.softmax(scores.float(), dim=-1).to(q_loc.dtype)
    out = torch.einsum("bkgst,btkh->bskgh", w, v_loc).reshape(B, S, H, hd_loc)
    out = DTensor.from_local(out, mesh, kvp, run_check=False)
    return out.redistribute(mesh, row_placements(out, 2))


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
    _write_rows(cache_k, posb, k)
    _write_rows(cache_v, posb, v)
    trange = torch.arange(cache_k.shape[1], device=x.device)
    mask = trange[None, :] <= posb                          # (B, S_max)
    if window > 0:
        mask &= trange[None, :] > posb - window
    out = _decode_attend(params, q, cache_k, cache_v, mask)
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
    _write_rows(cache_k, posb % L, k)
    _write_rows(cache_v, posb % L, v)
    mask = torch.arange(L, device=x.device)[None, :] <= posb    # (B, L)
    out = _decode_attend(params, q, cache_k, cache_v, mask)
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
    h = _act(linear(x, params["w1"]), cfg.activation)
    if cfg.gated:
        h = h * linear(x, params["w3"])
    return linear(h, params["w2"])


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------

def embed_tokens(params, tokens: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    if isinstance(tokens, DTensor):
        return _embed_sharded(params["embedding"], tokens)
    return params["embedding"][tokens]


def _embed_sharded(table: DTensor, tokens: DTensor) -> DTensor:
    """The rows of ``table`` (V, D) that ``tokens`` (B, S) name, on a mesh,
    by each rank's own shards: the tokens keep their batch sharding; the
    table keeps a vocab or width sharding on the mesh dims that do not
    split the batch (an FSDP shard on those is gathered). A rank looks up
    the tokens of its vocab shard (the others give zero rows, summed over
    the vocab-splitting dims) or its columns. Written by hand because the
    gradient of an indexed lookup has no sharding rule in every torch
    release."""
    mesh = table.device_mesh
    tok = [p if p == Shard(0) else Replicate() for p in tokens.placements]
    tab = [Replicate() if t == Shard(0) or not isinstance(p, Shard) else p
           for p, t in zip(table.placements, tok)]
    local = table.redistribute(mesh, tab).to_local(grad_placements=[
        Partial() if t == Shard(0) else p for p, t in zip(tab, tok)])
    ids = tokens.redistribute(mesh, tok).to_local().long()
    V = local.shape[0]
    ids = ids - shard_index(mesh, tab, 0) * V
    mine = (ids >= 0) & (ids < V)
    out = F.embedding(ids.clamp(0, V - 1), local) * mine[..., None].to(
        local.dtype)
    out_pl = [Partial() if p == Shard(0) else Shard(2) if p == Shard(1)
              else t for p, t in zip(tab, tok)]
    out = DTensor.from_local(out, mesh, out_pl, run_check=False)
    return out.redistribute(mesh, [Replicate() if isinstance(p, Partial)
                                   else p for p in out_pl])


def unembed(params, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        return linear(x, params["embedding"].T)
    return linear(x, params["lm_head"])

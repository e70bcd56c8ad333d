"""Plain PyTorch versions of the kernels: the CPU path of ``kernels.ops``
and the oracle each CUDA kernel is held against on the card. Ported from
``repro.kernels.ref``."""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0) -> torch.Tensor:
    """softmax(q·kᵀ/√hd + mask)·v. q: (B,S,H,hd); k, v: (B,T,K,hd) with
    H % K == 0; queries are the last S of T positions. Computed in fp32,
    returned in q's dtype. Masked scores are the finite -1e30, so a row
    with no visible key (causal, T < S) is the mean of v."""
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    qg = q.reshape(B, S, K, G, hd)
    scores = torch.einsum("bskgh,btkh->bkgst", qg.float(),
                          k.float()) / math.sqrt(hd)
    srange = torch.arange(S, device=q.device)
    trange = torch.arange(T, device=q.device)
    mask = torch.ones((S, T), dtype=torch.bool, device=q.device)
    off = T - S
    if causal:
        mask &= trange[None, :] <= srange[:, None] + off
    if window > 0:
        mask &= trange[None, :] > srange[:, None] + off - window
    scores = torch.where(mask, scores, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkh->bskgh", w, v.float())
    return out.reshape(B, S, H, hd).to(q.dtype)

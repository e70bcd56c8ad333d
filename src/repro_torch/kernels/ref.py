"""Plain PyTorch versions of the kernels: the CPU path of ``kernels.ops``
and the oracle each CUDA kernel is held against on the card. Ported from
``repro.kernels.ref``."""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

NEG_INF = -1e30
RG_C = 8.0                      # the RG-LRU's gate constant c


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


def ssd_scan_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 Bm: torch.Tensor, Cm: torch.Tensor, chunk: int) -> torch.Tensor:
    """Chunked SSD from a zero state (``repro.models.ssm.ssd_scan_ref``).
    x: (b,s,h,p); dt: (b,s,h); A: (h,); Bm, Cm: (b,s,g,n) with h % g == 0
    and s % chunk == 0. Computed in fp32, returned in x's dtype.

    Within a chunk, position i sees j <= i through (C_i·B_j) e^{cs_i-cs_j}
    dt_j, cs the inclusive cumsum of dt·A; across chunks the state is carried
    by a Python loop. The decay is formed only for j <= i: the other
    triangle's e^{cs_i-cs_j} overflows fp32 once dt·|A| summed over a chunk
    passes ~88, so ``diff`` is masked to -inf before the exp (e^-inf = 0)."""
    b, s, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    if s % chunk:
        raise ValueError(f"ssd_scan_ref: s={s} is not a multiple of chunk "
                         f"{chunk}")
    nc, L, rep = s // chunk, chunk, h // g
    xc = x.float().reshape(b, nc, L, h, p)
    dtc = dt.float().reshape(b, nc, L, h)
    Bc = Bm.float().reshape(b, nc, L, g, n)
    Cc = Cm.float().reshape(b, nc, L, g, n)

    cs = torch.cumsum(dtc * A.float(), dim=2)                  # (b,nc,L,h)
    csh = cs.transpose(2, 3)                                   # (b,nc,h,L)
    diff = csh[..., :, None] - csh[..., None, :]               # (b,nc,h,i,j)
    tri = torch.ones((L, L), dtype=torch.bool, device=x.device).tril()
    decay = torch.exp(torch.where(tri, diff, -torch.inf))
    cb = torch.einsum("bclgn,bcsgn->bcgls", Cc, Bc)             # (b,nc,g,i,j)
    cb = cb.repeat_interleave(rep, dim=2)                       # (b,nc,h,i,j)
    scores = cb * decay * dtc.transpose(2, 3)[..., None, :]
    y = torch.einsum("bchls,bcshp->bclhp", scores, xc)

    # chunk-final states, then the recurrence over chunks
    w = dtc * torch.exp(cs[:, :, -1:, :] - cs)                  # (b,nc,L,h)
    xw = (xc * w[..., None]).reshape(b, nc, L, g, rep, p)
    states = torch.einsum("bcsgn,bcsgrp->bcgrpn", Bc, xw).reshape(
        b, nc, h, p, n)
    chunk_decay = torch.exp(cs[:, :, -1, :])                   # (b,nc,h)
    state = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    prev = []
    for c in range(nc):
        prev.append(state)
        state = state * chunk_decay[:, c, :, None, None] + states[:, c]
    prev = torch.stack(prev, dim=1).reshape(b, nc, g, rep, p, n)

    y_off = torch.einsum("bclgn,bcgrpn->bclgrp", Cc, prev).reshape(
        b, nc, L, h, p)
    y = y + y_off * torch.exp(cs)[..., None]
    return y.reshape(b, s, h, p).to(x.dtype)


def ssd_scan_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                     Bm: torch.Tensor, Cm: torch.Tensor,
                     chunk: int) -> torch.Tensor:
    """The chunk-parallel form the CUDA kernels compute, step by step, so
    that the CPU tests can hold the decomposition itself against the
    reference: (1) C·Bᵀ once per (batch, chunk, group), lower triangle only;
    (2) every chunk's local state Σ_j (B_j dt_j e^{cs_end - cs_j}) ⊗ x_j;
    (3) the pass over chunks, state_c = state_{c-1}·e^{cs_end} + local_c,
    giving the state entering each chunk; (4) the outputs
    (C·Bᵀ ⊙ e^{cs_i - cs_j} ⊙ dt_j)·x + e^{cs_i} C·state_in. Same inputs as
    ``ssd_scan_ref``, but s need not be a multiple of chunk: the last chunk
    is zero-padded (dt = 0 there, so the rows before it are unchanged) and
    the padding's rows are dropped. fp32, returned in x's dtype."""
    b, s, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    L, rep = chunk, h // g
    nc = -(-s // L)
    pad = lambda a: torch.nn.functional.pad(
        a.float(), (0, 0) * (a.dim() - 2) + (0, nc * L - s))
    xc = pad(x).reshape(b, nc, L, h, p)
    dtc = pad(dt).reshape(b, nc, L, h)
    Bc = pad(Bm).reshape(b, nc, L, g, n)
    Cc = pad(Cm).reshape(b, nc, L, g, n)
    cs = torch.cumsum(dtc * A.float(), dim=2)                  # (b,nc,L,h)
    tri = torch.ones((L, L), dtype=torch.bool, device=x.device).tril()

    # (1) C·Bᵀ per group, shared by its h/g heads
    cb = torch.einsum("bcign,bcjgn->bcgij", Cc, Bc) * tri      # (b,nc,g,i,j)
    # (2) local states, (n, p) per head as the kernel keeps them
    w = dtc * torch.exp(cs[:, :, -1:, :] - cs)                 # (b,nc,L,h)
    Bh = Bc.repeat_interleave(rep, dim=3)                      # (b,nc,L,h,n)
    local = torch.einsum("bcjhn,bcjhp->bchnp", Bh, xc * w[..., None])
    # (3) the state entering each chunk
    decay = torch.exp(cs[:, :, -1, :])                         # (b,nc,h)
    state = torch.zeros((b, h, n, p), dtype=torch.float32, device=x.device)
    entering = []
    for c in range(nc):
        entering.append(state)
        state = state * decay[:, c, :, None, None] + local[:, c]
    st = torch.stack(entering, dim=1)                          # (b,nc,h,n,p)
    # (4) outputs; e^{cs_i - cs_j} only for j <= i
    csh = cs.transpose(2, 3)                                   # (b,nc,h,L)
    diff = csh[..., :, None] - csh[..., None, :]               # (b,nc,h,i,j)
    seg = torch.exp(torch.where(tri, diff, -torch.inf))
    scores = (cb.repeat_interleave(rep, dim=2) * seg
              * dtc.transpose(2, 3)[..., None, :])
    y = torch.einsum("bchij,bcjhp->bcihp", scores, xc)
    Ch = Cc.repeat_interleave(rep, dim=3)                      # (b,nc,L,h,n)
    y_off = torch.einsum("bcihn,bchnp->bcihp", Ch, st)
    y = y + y_off * torch.exp(cs)[..., None]
    return y.reshape(b, nc * L, h, p)[:, :s].to(x.dtype)


def ssd_scan_naive(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   Bm: torch.Tensor, Cm: torch.Tensor) -> torch.Tensor:
    """The O(s) state recurrence, the ground-truth definition of the scan
    (``repro.kernels.ref.ssd_scan_naive``): state_t = state_{t-1}·e^{dt_t A}
    + dt_t B_t ⊗ x_t and y_t = C_t·state_t. fp32, returned in x's dtype."""
    b, s, h, p = x.shape
    rep = h // Bm.shape[2]
    Bh = Bm.float().repeat_interleave(rep, dim=2)              # (b,s,h,n)
    Ch = Cm.float().repeat_interleave(rep, dim=2)
    dtf = dt.float()
    dA = torch.exp(dtf * A.float())                            # (b,s,h)
    state = torch.zeros((b, h, p, Bm.shape[3]), dtype=torch.float32,
                        device=x.device)
    ys = []
    for t in range(s):
        state = state * dA[:, t, :, None, None] + torch.einsum(
            "bh,bhn,bhp->bhpn", dtf[:, t], Bh[:, t], x[:, t].float())
        ys.append(torch.einsum("bhn,bhpn->bhp", Ch[:, t], state))
    return torch.stack(ys, dim=1).to(x.dtype)


def rglru_scan_ref(a: torch.Tensor, b: torch.Tensor,
                   h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The RG-LRU linear recurrence h_t = a_t ⊙ h_{t-1} + b_t along axis 1
    from ``h0`` (B, W), or from a zero state when None
    (``repro.kernels.ref.rglru_scan_ref``, an associative scan there; a
    sequential loop here). a, b: (B, S, W), any S and W; computed and
    returned in fp32. Each step is one multiply and one add, each rounded."""
    a, b = a.float(), b.float()
    h = torch.zeros_like(a[:, 0]) if h0 is None else h0.float()
    out = torch.empty_like(a)
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        out[:, t] = h
    return out


def rglru_gates(r_pre: torch.Tensor, i_pre: torch.Tensor, xc: torch.Tensor,
                lam: torch.Tensor):
    """The RG-LRU's (a, gated input), both fp32, from the projections
    r_pre = xc·Wr and i_pre = xc·Wi, the conv output xc and lam
    (``repro.models.rglru._gates``): a = exp(-8·softplus(lam)·sigmoid(r_pre))
    and sqrt(clamp(1 - a·a, 1e-12))·(sigmoid(i_pre)·xc)."""
    r = torch.sigmoid(r_pre.float())
    i = torch.sigmoid(i_pre.float())
    a = torch.exp(-RG_C * F.softplus(lam) * r)
    gated_in = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (
        i * xc.float())
    return a, gated_in


def rglru_gated_scan_ref(r_pre: torch.Tensor, i_pre: torch.Tensor,
                         xc: torch.Tensor, gate_pre: torch.Tensor,
                         lam: torch.Tensor, h0: Optional[torch.Tensor] = None,
                         state_out: Optional[torch.Tensor] = None):
    """The RG-LRU of one recurrent layer, the function the gated CUDA kernel
    computes: ``rglru_gates``, the scan from ``h0`` (zero when None) and
    y = h.to(dtype)·gelu_tanh(gate_pre), the tail of
    ``repro.models.rglru.rglru_forward``. r_pre, i_pre, xc, gate_pre:
    (B, S, W) of one dtype; lam fp32 (W,); h0 fp32 (B, W) or None. Returns
    (y in the inputs' dtype, the final state h[:, -1] as a contiguous fp32
    (B, W) tensor); the state is copied into ``state_out`` when given (which
    may be ``h0``)."""
    a, gated_in = rglru_gates(r_pre, i_pre, xc, lam)
    h = rglru_scan_ref(a, gated_in, h0)
    y = h.to(xc.dtype) * F.gelu(gate_pre, approximate="tanh")
    if state_out is None:
        return y, h[:, -1].contiguous()
    return y, state_out.copy_(h[:, -1])

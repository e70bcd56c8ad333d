"""Mamba-2 SSD block (state-space duality, arXiv:2405.21060), ported from
``repro.models.ssm``.

The full-sequence form runs the chunked SSD scan (``kernels.ops.ssd_scan``:
the hand-written CUDA kernel on the GPU, its plain PyTorch version on the
CPU) or, with ``use_kernel=False``, the plain version everywhere. A prefill
that wants a decode cache takes it from the same call
(``ssd_forward(..., want_cache=True)``): ``h @ in_proj``, the conv and the
discretisation are formed once, where the reference forms them twice.
Decode is the classic SSM state update in torch ops, as the reference's is
jnp: an fp32 (B, H, P, N) state and the last ``ssm_conv - 1`` pre-conv
inputs, both updated in place.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref
from repro_torch.models.config import ArchConfig

N_GROUPS = 1  # B/C projection groups (Mamba-2 default for these sizes)


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv via shifted adds. x: (B,S,C); w: (W,C)."""
    W = w.shape[0]
    out = torch.zeros_like(x)
    for i in range(W):
        shift = W - 1 - i
        if shift == 0:
            out = out + x * w[i]
        else:
            out = out + F.pad(x, (0, 0, shift, 0))[:, :-shift] * w[i]
    return out + b


def _split_proj(cfg: ArchConfig, zxbcdt: torch.Tensor):
    di, N = cfg.d_inner, cfg.ssm_state
    g = N_GROUPS
    z = zxbcdt[..., :di]
    xBC = zxbcdt[..., di: di + di + 2 * g * N]
    dt = zxbcdt[..., di + di + 2 * g * N:]
    return z, xBC, dt


def _gated_rmsnorm(y: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype,
                   eps: float) -> torch.Tensor:
    yf = y.float()
    return (yf * torch.rsqrt(torch.mean(yf * yf, dim=-1, keepdim=True)
                             + eps)).to(dtype) * scale


def ssd_forward(params, x: torch.Tensor, cfg: ArchConfig,
                use_kernel: bool = False, want_cache: bool = False):
    """Full-sequence Mamba-2 block. x: (B,S,D) -> (B,S,D), or with
    ``want_cache`` (y, the decode cache after this prefill from a zero
    state; see ``ssd_cache_from_prefill``)."""
    B, S, D = x.shape
    di, H, P, N = cfg.d_inner, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    zxbcdt = kops.matmul(x, params["in_proj"])
    z, xBC_raw, dt = _split_proj(cfg, zxbcdt)
    xBC = F.silu(_causal_conv(xBC_raw, params["conv_w"], params["conv_b"]))
    xin = xBC[..., :di].reshape(B, S, H, P)
    Bm = xBC[..., di: di + N_GROUPS * N].reshape(B, S, N_GROUPS, N)
    Cm = xBC[..., di + N_GROUPS * N:].reshape(B, S, N_GROUPS, N)
    dt = F.softplus(dt.float() + params["dt_bias"])
    A = -torch.exp(params["A_log"])
    # causal right-padding to a chunk multiple (padding never affects the
    # past); the kernel would take a ragged tail, but the reference pads
    pad = (-S) % cfg.ssm_chunk
    if pad:
        padf = lambda a: F.pad(a, (0, 0) * (a.dim() - 2) + (0, pad))
        xin_p, dt_p, Bm_p, Cm_p = map(padf, (xin, dt, Bm, Cm))
    else:
        xin_p, dt_p, Bm_p, Cm_p = xin, dt, Bm, Cm
    if use_kernel:
        y = kops.ssd_scan(xin_p.contiguous(), dt_p.contiguous(), A,
                          Bm_p.contiguous(), Cm_p.contiguous(),
                          cfg.ssm_chunk)
    else:
        y = ref.ssd_scan_ref(xin_p.float(), dt_p, A, Bm_p.float(),
                             Cm_p.float(), cfg.ssm_chunk).to(x.dtype)
    if pad:
        y = y[:, :S]
    y = y + params["D"].to(x.dtype)[None, None, :, None] * xin
    y = y.reshape(B, S, di) * F.silu(z)
    y = _gated_rmsnorm(y, params["norm_scale"], x.dtype,
                       cfg.ssm_norm_eps)
    y = kops.matmul(y, params["out_proj"])
    if not want_cache:
        return y
    # the final state by one sum over the unpadded S positions (the scan
    # kernel returns no state)
    cs = torch.cumsum(dt * A, dim=1)                            # (B,S,H)
    w = dt * torch.exp(cs[:, -1:, :] - cs)                      # dt·decay
    xw = (xin.float() * w[..., None]).reshape(B, S, N_GROUPS,
                                              H // N_GROUPS, P)
    state = torch.einsum("bsgn,bsgrp->bgrpn", Bm.float(),
                         xw).reshape(B, H, P, N)
    conv = xBC_raw[:, S - (cfg.ssm_conv - 1):, :]
    return y, {"state": state, "conv": conv}


def ssd_init_cache(cfg: ArchConfig, batch: int, dtype, device) -> dict:
    """Zero decode cache: the fp32 SSM state, whatever the parameters'
    dtype, and the conv history in the parameters' dtype."""
    di, H, P, N = cfg.d_inner, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    conv_ch = di + 2 * N_GROUPS * N
    return {
        "state": torch.zeros((batch, H, P, N), dtype=torch.float32,
                             device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, conv_ch), dtype=dtype,
                            device=device),
    }


def ssd_cache_from_prefill(params, h: torch.Tensor, cfg: ArchConfig) -> dict:
    """The decode cache after a prefill of ``h`` (B,S,D) from a zero state
    (``repro.models.model._ssd_cache_from_prefill``): the final SSM state
    (fp32) by one sum over the unpadded S positions, and the conv history as
    the last ``ssm_conv - 1`` pre-conv ``xBC`` rows. It is the cache of
    ``ssd_forward(..., want_cache=True)``, which a prefill calls to form
    ``h @ in_proj`` once; this entry runs the whole block for it."""
    return ssd_forward(params, h, cfg, want_cache=True)[1]


def ssd_step(params, x: torch.Tensor, cache: dict, cfg: ArchConfig):
    """One-token decode. x: (B,1,D) -> (out (B,1,D), cache). The state and
    the conv history are updated **in place**, so a serving pool's cache
    is allocated once."""
    B = x.shape[0]
    di, H, P, N = cfg.d_inner, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    zxbcdt = x[:, 0] @ params["in_proj"]
    z, xBC, dt = _split_proj(cfg, zxbcdt)
    # conv over (cached last W-1 inputs, current)
    hist = torch.cat([cache["conv"], xBC[:, None, :]], dim=1)   # (B,W,C)
    conv_out = torch.einsum("bwc,wc->bc", hist, params["conv_w"]) \
        + params["conv_b"]
    xBC_c = F.silu(conv_out)
    cache["conv"].copy_(hist[:, 1:])

    xin = xBC_c[..., :di].reshape(B, H, P)
    Bm = xBC_c[..., di: di + N_GROUPS * N].reshape(B, N_GROUPS, N)
    Cm = xBC_c[..., di + N_GROUPS * N:].reshape(B, N_GROUPS, N)
    rep = H // N_GROUPS
    Bh = Bm.repeat_interleave(rep, dim=1).float()               # (B,H,N)
    Ch = Cm.repeat_interleave(rep, dim=1).float()

    dt = F.softplus(dt.float() + params["dt_bias"])              # (B,H)
    A = -torch.exp(params["A_log"])
    dA = torch.exp(dt * A)                                       # (B,H)
    st = cache["state"].mul_(dA[:, :, None, None]).add_(torch.einsum(
        "bh,bhn,bhp->bhpn", dt, Bh, xin.float()))
    y = torch.einsum("bhn,bhpn->bhp", Ch, st).to(x.dtype)
    y = y + params["D"].to(x.dtype)[None, :, None] * xin
    y = y.reshape(B, di) * F.silu(z)
    y = _gated_rmsnorm(y, params["norm_scale"], x.dtype,
                       cfg.ssm_norm_eps)
    out = (y @ params["out_proj"])[:, None, :]
    return out, cache

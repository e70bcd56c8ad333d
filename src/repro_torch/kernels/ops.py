"""Kernel dispatch by device, the port of ``repro.kernels.ops``.

CUDA tensors go to the hand-written kernels, CPU tensors to their plain
PyTorch versions (``kernels.ref``); any other device raises. There is no
fallback: a CUDA tensor a kernel refuses raises.

Training: flash attention has a gradient. Under grad mode, when an input
requires grad, ``flash_attention`` runs through ``FlashAttention``, a
``torch.autograd.Function`` whose forward also writes each row's
log-sum-exp and whose backward is the CUDA backward kernel
(``flash_attention_bwd``) on the card, its plain version on the CPU.
Otherwise it calls the forward alone, as the serving paths always do. The
SSD, RG-LRU and MoE expert kernels have no backward kernel yet: on CUDA
tensors under grad, ``ssd_scan``, ``rglru_scan``, ``rglru_gated_scan`` and
``moe_experts`` raise
``ValueError`` rather than hand back an output with no gradient (train such
a model with ``ModelOptions(use_kernels=False)``). On the CPU their plain
versions are differentiable torch ops.

Dense products: ``matmul(x, w)`` is ``x @ w`` (on the CPU, the plain
version ``ref.dense_gemm_ref`` computes), except that a product the
split-TF32 kernel takes by its rule (``dense_gemm.takes``: plain fp32 CUDA
tensors, no gradient wanted, at least ``dense_gemm.MIN_ROWS`` rows) runs on
it. That rule, not the device alone, decides: a declined CUDA product is
cuBLAS's, as before.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.autograd.function import once_differentiable

from repro_torch.kernels import dense_gemm as _dg
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import moe_experts as _moe
from repro_torch.kernels import ref
from repro_torch.kernels import rglru_scan as _rg
from repro_torch.kernels import ssd_scan as _ssd


def _wants_grad(*ts: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def _refuse_grad(name: str, ts) -> None:
    if _wants_grad(*ts):
        raise ValueError(
            f"{name}: the CUDA kernel has no backward kernel yet, so its "
            "output would carry no gradient; train with "
            "ModelOptions(use_kernels=False) or run under torch.no_grad()")


class FlashAttention(torch.autograd.Function):
    """Flash attention with its gradient: the forward kernel (or its plain
    version on the CPU) writes the output and each row's log-sum-exp; the
    backward recomputes P from them (``flash_attention_bwd``, or
    ``ref.flash_attention_bwd_ref`` on the CPU)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int):
        if q.is_cuda:
            B, S, H, _ = q.shape
            lse = torch.empty((B, H, S), dtype=torch.float32,
                              device=q.device)
            out = _fa.flash_attention(q, k, v, causal=causal, window=window,
                                      lse=lse)
        else:
            out, lse = ref.flash_attention_fwd_ref(q, k, v, causal=causal,
                                                   window=window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        bwd = _fa.flash_attention_bwd if q.is_cuda else \
            ref.flash_attention_bwd_ref
        dq, dk, dv = bwd(q, k, v, o, lse, do.contiguous(), causal=ctx.causal,
                         window=ctx.window)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    devices = {q.device.type, k.device.type, v.device.type}
    if devices not in ({"cuda"}, {"cpu"}):
        raise ValueError(f"flash_attention: no kernel for devices "
                         f"{sorted(devices)}; need all cuda or all cpu")
    if _wants_grad(q, k, v):
        return FlashAttention.apply(q, k, v, causal, window)
    if devices == {"cuda"}:
        return _fa.flash_attention(q, k, v, causal=causal, window=window)
    return ref.flash_attention_ref(q, k, v, causal=causal, window=window)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, chunk: int) -> torch.Tensor:
    devices = {t.device.type for t in (x, dt, A, B, C)}
    if devices == {"cuda"}:
        _refuse_grad("ssd_scan", (x, dt, A, B, C))
        return _ssd.ssd_scan(x, dt, A, B, C, chunk)
    if devices == {"cpu"}:
        return ref.ssd_scan_ref(x, dt, A, B, C, chunk)
    raise ValueError(f"ssd_scan: no kernel for devices {sorted(devices)}; "
                     "need all cuda or all cpu")


def rglru_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    devices = {a.device.type, b.device.type}
    if devices == {"cuda"}:
        _refuse_grad("rglru_scan", (a, b))
        return _rg.rglru_scan(a, b)
    if devices == {"cpu"}:
        return ref.rglru_scan_ref(a, b)
    raise ValueError(f"rglru_scan: no kernel for devices {sorted(devices)}; "
                     "need all cuda or all cpu")


def rglru_gated_scan(r_pre: torch.Tensor, i_pre: torch.Tensor,
                     xc: torch.Tensor, gate_pre: torch.Tensor,
                     lam: torch.Tensor, h0: Optional[torch.Tensor] = None,
                     state_out: Optional[torch.Tensor] = None):
    ts = [r_pre, i_pre, xc, gate_pre, lam] + [
        t for t in (h0, state_out) if t is not None]
    devices = {t.device.type for t in ts}
    if devices == {"cuda"}:
        _refuse_grad("rglru_gated_scan", ts)
        return _rg.rglru_gated_scan(r_pre, i_pre, xc, gate_pre, lam, h0,
                                    state_out)
    if devices == {"cpu"}:
        return ref.rglru_gated_scan_ref(r_pre, i_pre, xc, gate_pre, lam, h0,
                                        state_out)
    raise ValueError(f"rglru_gated_scan: no kernel for devices "
                     f"{sorted(devices)}; need all cuda or all cpu")


def moe_experts(x: torch.Tensor, rows: torch.Tensor, ends: torch.Tensor,
                w1: torch.Tensor, w3: torch.Tensor, w2: torch.Tensor,
                small: bool = False) -> torch.Tensor:
    ts = (x, rows, ends, w1, w3, w2)
    devices = {t.device.type for t in ts}
    if devices == {"cuda"}:
        _refuse_grad("moe_experts", ts)
        return _moe.moe_experts(x, rows, ends, w1, w3, w2, small)
    if devices == {"cpu"}:
        return ref.moe_experts_ref(x, rows, ends, w1, w3, w2)
    raise ValueError(f"moe_experts: no kernel for devices {sorted(devices)}; "
                     "need all cuda or all cpu")


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w, on the split-TF32 kernel where ``dense_gemm.takes`` it."""
    if _dg.takes(x, w):
        return _dg.dense_gemm(x, w)
    return x @ w

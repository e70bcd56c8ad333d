"""Kernel dispatch by device, the port of ``repro.kernels.ops``.

CUDA tensors go to the hand-written kernel, CPU tensors to its plain
PyTorch version (``kernels.ref``); any other device raises. There is no
fallback: a CUDA tensor the kernel refuses raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ref
from repro_torch.kernels import rglru_scan as _rg
from repro_torch.kernels import ssd_scan as _ssd


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    devices = {q.device.type, k.device.type, v.device.type}
    if devices == {"cuda"}:
        return _fa.flash_attention(q, k, v, causal=causal, window=window)
    if devices == {"cpu"}:
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    raise ValueError(f"flash_attention: no kernel for devices "
                     f"{sorted(devices)}; need all cuda or all cpu")


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, chunk: int) -> torch.Tensor:
    devices = {t.device.type for t in (x, dt, A, B, C)}
    if devices == {"cuda"}:
        return _ssd.ssd_scan(x, dt, A, B, C, chunk)
    if devices == {"cpu"}:
        return ref.ssd_scan_ref(x, dt, A, B, C, chunk)
    raise ValueError(f"ssd_scan: no kernel for devices {sorted(devices)}; "
                     "need all cuda or all cpu")


def rglru_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    devices = {a.device.type, b.device.type}
    if devices == {"cuda"}:
        return _rg.rglru_scan(a, b)
    if devices == {"cpu"}:
        return ref.rglru_scan_ref(a, b)
    raise ValueError(f"rglru_scan: no kernel for devices {sorted(devices)}; "
                     "need all cuda or all cpu")

"""Wrapper of the hand-written CUDA RG-LRU scan kernel
(``csrc/rglru_scan.cu``), the port of the Pallas TPU kernel
``repro.kernels.rglru_scan.rglru_scan``.

The wrapper takes CUDA tensors only: it checks them, allocates the output,
launches the kernel on the current stream and raises if the launch is
refused. ``rglru_scan.launches`` counts its launches, so a run can show that
its path went through the kernel. The plain PyTorch version of the same
function is ``kernels.ref.rglru_scan_ref``; ``kernels.ops`` chooses between
the two by the tensors' device.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load("rglru_scan")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.rglru_scan_fwd.argtypes = [ptr, ptr, ptr, i32, i32, i32, ptr]
    lib.rglru_scan_fwd.restype = i32
    return lib


def build() -> None:
    """Compile (if needed) and load the kernel now rather than at first
    launch."""
    _library()


def _check(a: torch.Tensor, b: torch.Tensor) -> None:
    for name, t in (("a", a), ("b", b)):
        if not t.is_cuda:
            raise ValueError(f"rglru_scan: {name} is on {t.device}; the CUDA "
                             "kernel takes CUDA tensors only")
        if t.dtype != torch.float32:
            raise ValueError(f"rglru_scan: {name} is {t.dtype}; the kernel "
                             "takes float32 only")
        if not t.is_contiguous():
            raise ValueError(f"rglru_scan: {name} must be contiguous")
    if a.device != b.device:
        raise ValueError("rglru_scan: a and b on different devices")
    if a.dim() != 3 or a.shape != b.shape:
        raise ValueError(f"rglru_scan: need a, b of one (B, S, W) shape, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if a.numel() == 0:
        raise ValueError("rglru_scan: empty input")
    if a.shape[0] > 65535:
        raise ValueError(f"rglru_scan: batch {a.shape[0]} > 65535")


def rglru_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t ⊙ h_{t-1} + b_t along axis 1 from a zero state, on the GPU.
    a, b: contiguous CUDA fp32 tensors of one (B, S, W) shape, any S and W.
    Returns h (B, S, W) fp32."""
    _check(a, b)
    lib = _library()
    B, S, W = a.shape
    h = torch.empty_like(a)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = lib.rglru_scan_fwd(a.data_ptr(), b.data_ptr(), h.data_ptr(),
                                B, S, W, stream)
    if rc != 0:
        raise RuntimeError(f"rglru_scan: kernel launch failed with CUDA error "
                           f"{rc}")
    rglru_scan.launches += 1
    return h


rglru_scan.launches = 0

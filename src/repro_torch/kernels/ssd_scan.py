"""Wrapper of the hand-written CUDA SSD chunked-scan kernel
(``csrc/ssd_scan.cu``), the port of the Pallas TPU kernel
``repro.kernels.ssd_scan.ssd_scan``.

The wrapper takes CUDA tensors only: it checks them, allocates the output,
launches the kernel on the current stream and raises if the launch is
refused. ``ssd_scan.launches`` counts its launches, so a run can show that
its path went through the kernel. The plain PyTorch version of the same
function is ``kernels.ref.ssd_scan_ref``; ``kernels.ops`` chooses between
the two by the tensors' device.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

HEAD_DIMS = (16, 32, 64, 128)
DTYPES = (torch.float32, torch.bfloat16)
MAX_SMEM_BYTES = 232_448            # 227 KB: the most one Hopper block may use


def smem_bytes(p: int, n: int, chunk: int) -> int:
    """Dynamic shared memory of one block, as the kernel lays it out: the
    (n, p) state, the chunk's x (L, p) and B (L, n + 4), one C row and one
    score row per warp (8 warps), and dt, cs and the decay weights."""
    return 4 * (n * p + chunk * p + chunk * (n + 4) + 8 * n + 8 * chunk
                + 3 * chunk)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load("ssd_scan")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.ssd_scan_fwd.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr,
                                 i32, i32, i32, i32, i32, i32, i32, i32, ptr]
    lib.ssd_scan_fwd.restype = i32
    return lib


def build() -> None:
    """Compile (if needed) and load the kernel now rather than at first
    launch."""
    _library()


def _check(x, dt, A, B, C, chunk: int) -> None:
    named = (("x", x), ("dt", dt), ("A", A), ("B", B), ("C", C))
    for name, t in named:
        if not t.is_cuda:
            raise ValueError(f"ssd_scan: {name} is on {t.device}; the CUDA "
                             "kernel takes CUDA tensors only")
        if not t.is_contiguous():
            raise ValueError(f"ssd_scan: {name} must be contiguous")
    if len({t.device for _, t in named}) != 1:
        raise ValueError("ssd_scan: inputs on different devices")
    if x.dim() != 4 or dt.dim() != 3 or A.dim() != 1 or B.dim() != 4 \
            or C.dim() != 4:
        raise ValueError(f"ssd_scan: need x (b,s,h,p), dt (b,s,h), A (h,), "
                         f"B, C (b,s,g,n); got {tuple(x.shape)}, "
                         f"{tuple(dt.shape)}, {tuple(A.shape)}, "
                         f"{tuple(B.shape)}, {tuple(C.shape)}")
    if x.dtype not in DTYPES or not (x.dtype == B.dtype == C.dtype):
        raise ValueError(f"ssd_scan: x, B, C dtypes {x.dtype}, {B.dtype}, "
                         f"{C.dtype}; need all float32 or all bfloat16")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise ValueError(f"ssd_scan: dt and A must be float32, got "
                         f"{dt.dtype}, {A.dtype}")
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if tuple(dt.shape) != (b, s, h) or tuple(A.shape) != (h,) \
            or tuple(B.shape) != (b, s, g, n) or C.shape != B.shape:
        raise ValueError(f"ssd_scan: shapes disagree: x {tuple(x.shape)}, "
                         f"dt {tuple(dt.shape)}, A {tuple(A.shape)}, "
                         f"B {tuple(B.shape)}, C {tuple(C.shape)}")
    if min(b, s, h) == 0:
        raise ValueError("ssd_scan: empty input")
    if p not in HEAD_DIMS:
        raise ValueError(f"ssd_scan: head dim {p} not in {HEAD_DIMS}")
    if g == 0 or h % g != 0:
        raise ValueError(f"ssd_scan: {h} heads, {g} groups; need h % g == 0")
    if n == 0 or n % 4 or chunk <= 0 or chunk % 4:
        raise ValueError(f"ssd_scan: state {n} and chunk {chunk} must be "
                         "positive multiples of 4")
    if smem_bytes(p, n, chunk) > MAX_SMEM_BYTES:
        raise ValueError(f"ssd_scan: p={p}, n={n}, chunk={chunk} needs "
                         f"{smem_bytes(p, n, chunk)} bytes of shared memory; "
                         f"a block has {MAX_SMEM_BYTES}")


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, chunk: int) -> torch.Tensor:
    """Mamba-2 SSD chunked scan on the GPU from a zero state. x: (b,s,h,p);
    dt: (b,s,h) fp32; A: (h,) fp32; B, C: (b,s,g,n) with h % g == 0;
    contiguous CUDA tensors, x/B/C all fp32 or all bf16. p in {16, 32, 64,
    128}; n and chunk multiples of 4. s need not be a multiple of chunk:
    the last chunk runs at its own length (the same rows as zero-padding).
    Returns y (b,s,h,p) in x's dtype."""
    _check(x, dt, A, B, C, chunk)
    lib = _library()
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.ssd_scan_fwd(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), y.data_ptr(), b, s, h, p, g, n, int(chunk),
            int(x.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"ssd_scan: kernel launch failed with CUDA error "
                           f"{rc}")
    ssd_scan.launches += 1
    return y


ssd_scan.launches = 0

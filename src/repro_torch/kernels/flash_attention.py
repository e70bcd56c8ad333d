"""Wrapper of the hand-written CUDA flash-attention kernel
(``csrc/flash_attention.cu``), the port of the Pallas TPU kernel
``repro.kernels.flash_attention.flash_attention``.

The wrapper takes CUDA tensors only: it checks them, allocates the output,
launches the kernel on the current stream and raises if the launch is
refused. ``flash_attention.launches`` counts its launches, so a run can
show that its path went through the kernel. The plain PyTorch version of the
same function is ``kernels.ref.flash_attention_ref``; ``kernels.ops``
chooses between the two by the tensors' device.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

HEAD_DIMS = (32, 64, 128, 256)
DTYPES = (torch.float32, torch.bfloat16)
MAX_SMEM_BYTES = 232_448            # 227 KB: the most one Hopper block may use


def smem_bytes(hd: int) -> int:
    """Dynamic shared memory of one block, as the kernel lays it out: the
    8 query rows, a 32-key tile of k (rows padded by one word) and of v, all
    fp32."""
    return 4 * (8 * hd + 32 * (hd + 1) + 32 * hd)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_fwd.argtypes = [ptr, ptr, ptr, ptr,
                                        i32, i32, i32, i32, i32, i32,
                                        i32, i32, i32, ptr]
    lib.flash_attention_fwd.restype = i32
    return lib


def build() -> None:
    """Compile (if needed) and load the kernel now rather than at first
    launch."""
    _library()


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"flash_attention: {name} is on {t.device}; the "
                             "CUDA kernel takes CUDA tensors only")
        if t.dim() != 4:
            raise ValueError(f"flash_attention: {name} must be 4-d, "
                             f"got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be contiguous")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k, v on different devices")
    if q.dtype not in DTYPES or not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"flash_attention: dtypes {q.dtype}, {k.dtype}, "
                         f"{v.dtype}; need all float32 or all bfloat16")
    B, S, H, hd = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} disagree")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {hd} not in {HEAD_DIMS}")
    if smem_bytes(hd) > MAX_SMEM_BYTES:
        raise ValueError(f"flash_attention: head_dim {hd} needs "
                         f"{smem_bytes(hd)} bytes of shared memory; a block "
                         f"has {MAX_SMEM_BYTES}")
    K = k.shape[2]
    if K == 0 or H % K != 0:
        raise ValueError(f"flash_attention: {H} query heads, {K} kv heads; "
                         "need H % K == 0")
    if min(B, S, k.shape[1]) == 0:
        raise ValueError("flash_attention: empty input")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """softmax(q·kᵀ/√hd + mask)·v on the GPU. q: (B,S,H,hd); k, v:
    (B,T,K,hd), contiguous CUDA tensors of one dtype (fp32 or bf16),
    hd in {32, 64, 128, 256}, H % K == 0. Queries are the last S of the T
    positions. Returns (B,S,H,hd) in q's dtype."""
    _check(q, k, v)
    lib = _library()
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, S, T, H, K, hd, int(causal), int(window),
            int(q.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention: kernel launch failed with CUDA "
                           f"error {rc}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0

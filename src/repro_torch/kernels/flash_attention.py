"""Wrapper of the hand-written CUDA flash-attention kernel
(``csrc/flash_attention.cu``), the port of the Pallas TPU kernel
``repro.kernels.flash_attention.flash_attention``.

The wrapper takes CUDA tensors only: it checks them, allocates the output,
launches the kernel on the current stream of the tensors' device (which
must be the current device) and raises if the launch is refused.
``flash_attention.launches`` counts its launches, so a run can show that its
path went through the kernel. The plain PyTorch version of the same function
is ``kernels.ref.flash_attention_ref``; ``kernels.ops`` chooses between the
two by the tensors' device.
"""
from __future__ import annotations

import ctypes
import functools
import struct

import torch

from repro_torch.kernels import _build

HEAD_DIMS = (32, 64, 80, 128, 256)   # each a native instantiation
DTYPES = (torch.float32, torch.bfloat16)
MAX_SMEM_BYTES = 232_448            # 227 KB: the most one Hopper block may use
KEYS_PER_TILE = 32
_ARGS = struct.Struct("14q")         # flash_attention_fwd's packed arguments


def smem_bytes(hd: int, dtype: torch.dtype = torch.float32) -> int:
    """Dynamic shared memory of one block, as the kernel lays it out. fp32:
    8 query rows and k padded by 4 floats a row, a ring of two 32-key tiles
    of k and v. bf16: 64 query rows and the two-tile ring, every row padded
    by 8 values."""
    if dtype == torch.bfloat16:
        return 2 * (hd + 8) * (64 + 4 * KEYS_PER_TILE)
    return 4 * (8 * (hd + 4) + 2 * KEYS_PER_TILE * (hd + 4)
                + 2 * KEYS_PER_TILE * hd)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    lib.flash_attention_fwd.argtypes = [ctypes.c_char_p]
    lib.flash_attention_fwd.restype = ctypes.c_int
    return lib


def build() -> None:
    """Compile (if needed) and load the kernel now rather than at first
    launch."""
    _library()


@functools.lru_cache(maxsize=256)
def _check_static(q_shape, k_shape, v_shape, dtypes) -> None:
    """The checks that depend only on shapes and dtypes; cached, so that a
    serving path's few shapes are each checked once (a failing check
    raises and is not cached)."""
    qd, kd, vd = dtypes
    if qd not in DTYPES or not (qd == kd == vd):
        raise ValueError(f"flash_attention: dtypes {qd}, {kd}, {vd}; need "
                         "all float32 or all bfloat16")
    if len(q_shape) != 4 or len(k_shape) != 4 or k_shape != v_shape:
        raise ValueError(f"flash_attention: need 4-d q, k, v with k and v "
                         f"alike; got {tuple(q_shape)}, {tuple(k_shape)}, "
                         f"{tuple(v_shape)}")
    B, S, H, hd = q_shape
    _, T, K, khd = k_shape
    if k_shape[0] != B or khd != hd:
        raise ValueError(f"flash_attention: q {tuple(q_shape)}, "
                         f"k {tuple(k_shape)}, v {tuple(v_shape)} disagree")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {hd} not in {HEAD_DIMS}")
    if K == 0 or H % K:
        raise ValueError(f"flash_attention: {H} query heads, {K} kv heads; "
                         "need H % K == 0")
    if B == 0 or S == 0 or T == 0:
        raise ValueError("flash_attention: empty input")
    if smem_bytes(hd, qd) > MAX_SMEM_BYTES:
        raise ValueError(f"flash_attention: head_dim {hd} needs "
                         f"{smem_bytes(hd, qd)} bytes of shared memory; "
                         f"a block has {MAX_SMEM_BYTES}")


def _check_layout(q: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor) -> tuple[int, int, int]:
    """Contiguity and 16-byte alignment; returns the three data pointers."""
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: q, k, v must be contiguous")
    ptrs = q.data_ptr(), k.data_ptr(), v.data_ptr()
    if (ptrs[0] | ptrs[1] | ptrs[2]) & 15:
        raise ValueError("flash_attention: q, k, v must start on 16 bytes")
    return ptrs


def check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Everything the kernel needs of the inputs but their device: dtypes,
    ranks, shapes, head dim, heads, contiguity and 16-byte alignment."""
    _check_static(q.shape, k.shape, v.shape, (q.dtype, k.dtype, v.dtype))
    _check_layout(q, k, v)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """Checks that guard the launch; returns the device's index and the
    three data pointers."""
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError(f"flash_attention: q, k, v on {q.device}, "
                         f"{k.device}, {v.device}; the CUDA kernel takes "
                         "CUDA tensors only")
    _check_static(q.shape, k.shape, v.shape, (q.dtype, k.dtype, v.dtype))
    ptrs = _check_layout(q, k, v)
    dev = q.device
    if k.device != dev or v.device != dev:
        raise ValueError(f"flash_attention: q, k, v on {dev}, {k.device}, "
                         f"{v.device}; need one CUDA device")
    if dev.index != torch.cuda.current_device():
        raise ValueError(f"flash_attention: tensors on {dev}, but the "
                         f"current device is cuda:"
                         f"{torch.cuda.current_device()}")
    return dev.index, ptrs


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """softmax(q·kᵀ/√hd + mask)·v on the GPU. q: (B,S,H,hd); k, v:
    (B,T,K,hd), contiguous CUDA tensors of one dtype (fp32 or bf16) on the
    current device, hd in ``HEAD_DIMS`` (launched as it is, never padded),
    H % K == 0. Queries are the last S of the T positions. Returns
    (B,S,H,hd) in q's dtype."""
    index, (qp, kp, vp) = _check(q, k, v)
    (B, S, H, hd), (_, T, K, _) = q.shape, k.shape
    out = torch.empty_like(q)
    # the 14 arguments packed as int64s: ctypes passes one buffer much
    # faster than 14 converted arguments
    args = _ARGS.pack(
        qp, kp, vp, out.data_ptr(), B, S, T, H, K, hd, causal, window,
        q.dtype is torch.bfloat16,
        torch._C._cuda_getCurrentRawStream(index))   # the current stream
    rc = _library().flash_attention_fwd(args)
    if rc != 0:
        raise RuntimeError(f"flash_attention: kernel launch failed with CUDA "
                           f"error {rc}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0

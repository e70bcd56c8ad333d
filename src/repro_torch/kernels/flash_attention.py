"""Wrappers of the hand-written CUDA flash-attention kernels: the forward
(``csrc/flash_attention.cu``), the port of the Pallas TPU kernel
``repro.kernels.flash_attention.flash_attention``, and its backward
(``csrc/flash_attention_bwd.cu``), which the reference does not have (it
differentiates its jnp path).

The wrappers take CUDA tensors only: they check them, allocate the outputs,
launch on the current stream of the tensors' device (which must be the
current device) and raise if a launch is refused. ``flash_attention.launches``
and ``flash_attention_bwd.launches`` count their calls, so a run can show
that its path went through the kernels. The plain PyTorch versions are
``kernels.ref.flash_attention_ref`` (``flash_attention_fwd_ref`` with the
log-sum-exp) and ``kernels.ref.flash_attention_bwd_ref``; ``kernels.ops``
chooses by the tensors' device.
"""
from __future__ import annotations

import ctypes
import functools
import struct
from typing import Optional

import torch

from repro_torch.kernels import _build

HEAD_DIMS = (32, 64, 80, 128, 256)   # each a native instantiation
DTYPES = (torch.float32, torch.bfloat16)
MAX_SMEM_BYTES = 232_448            # 227 KB: the most one Hopper block may use
KEYS_PER_TILE = 32
_ARGS = struct.Struct("15q")         # flash_attention_fwd's packed arguments
_BWD_ARGS = struct.Struct("19q")     # flash_attention_bwd's


def smem_bytes(hd: int, dtype: torch.dtype = torch.float32) -> int:
    """Dynamic shared memory of one block, as the kernel lays it out. fp32:
    8 query rows and k padded by 4 floats a row, a ring of two 32-key tiles
    of k and v. bf16: 64 query rows and the two-tile ring, every row padded
    by 8 values."""
    if dtype == torch.bfloat16:
        return 2 * (hd + 8) * (64 + 4 * KEYS_PER_TILE)
    return 4 * (8 * (hd + 4) + 2 * KEYS_PER_TILE * (hd + 4)
                + 2 * KEYS_PER_TILE * hd)


def smem_bytes_bwd(hd: int, dtype: torch.dtype = torch.float32) -> int:
    """Dynamic shared memory of the larger of the two backward blocks (dkdv
    and dq), as the kernel lays them out with the tiles its ``Tiles`` sets:
    a dkdv block's keys and the query rows of its step, a dq block's query
    rows and the keys of its step. dkdv: its k and v tile, a ring of two
    q/dO tiles, P and dS, and two buffers of lse and Δ; dq: its q and dO
    tile, a ring of two k/v tiles, dS (fp32: dSᵀ, which first holds Pᵀ),
    its lse and Δ. Rows are padded by 4 floats (fp32) or 8 values (bf16);
    P and dS rows by 8 (fp32 dSᵀ rows by 4)."""
    if dtype == torch.bfloat16:
        kv_keys, kv_rows, q_rows, q_keys = (32 if hd == 256 else 64), 32, 64, 32
        rs, es = hd + 8, 2
        ds = q_rows * (q_keys + 8)
    else:
        kv_keys, kv_rows, q_rows, q_keys = ((32, 32, 32, 32) if hd == 256
                                            else (64, 32, 64, 64))
        rs, es = hd + 4, 4
        ds = q_keys * (q_rows + 4)
    dkdv = es * (2 * kv_keys * rs + 4 * kv_rows * rs
                 + 2 * kv_rows * (kv_keys + 8)) + 16 * kv_rows
    dq = es * (2 * q_rows * rs + 4 * q_keys * rs + ds) + 8 * q_rows
    return max(dkdv, dq)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    lib.flash_attention_fwd.argtypes = [ctypes.c_char_p]
    lib.flash_attention_fwd.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _bwd_library() -> ctypes.CDLL:
    lib = _build.load("flash_attention_bwd")
    lib.flash_attention_bwd.argtypes = [ctypes.c_char_p]
    lib.flash_attention_bwd.restype = ctypes.c_int
    lib.flash_attention_bwd_smem.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.flash_attention_bwd_smem.restype = ctypes.c_longlong
    return lib


def built_smem_bytes_bwd(hd: int, dtype: torch.dtype) -> int:
    """The built backward kernel's own count of what ``smem_bytes_bwd``
    mirrors (builds the kernel if needed; -1 for a head dim it lacks)."""
    return _bwd_library().flash_attention_bwd_smem(
        hd, dtype is torch.bfloat16)


def build() -> None:
    """Compile (if needed) and load both kernels now rather than at first
    launch."""
    _library()
    _bwd_library()


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


def _check_lse(lse: torch.Tensor, q: torch.Tensor) -> None:
    B, S, H, _ = q.shape
    if (lse.dtype != torch.float32 or tuple(lse.shape) != (B, H, S)
            or not lse.is_contiguous() or lse.device != q.device):
        raise ValueError(f"flash_attention: lse must be a contiguous fp32 "
                         f"({B}, {H}, {S}) tensor on {q.device}; got "
                         f"{lse.dtype} {tuple(lse.shape)} on {lse.device}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    lse: Optional[torch.Tensor] = None) -> torch.Tensor:
    """softmax(q·kᵀ/√hd + mask)·v on the GPU. q: (B,S,H,hd); k, v:
    (B,T,K,hd), contiguous CUDA tensors of one dtype (fp32 or bf16) on the
    current device, hd in ``HEAD_DIMS`` (launched as it is, never padded),
    H % K == 0. Queries are the last S of the T positions. Returns
    (B,S,H,hd) in q's dtype. ``lse``, a contiguous fp32 (B,H,S) tensor on
    the same device, receives each row's log-sum-exp of its scaled, masked
    scores (what ``flash_attention_bwd`` needs); None writes nothing
    more."""
    index, (qp, kp, vp) = _check(q, k, v)
    (B, S, H, hd), (_, T, K, _) = q.shape, k.shape
    if lse is not None:
        _check_lse(lse, q)
    out = torch.empty_like(q)
    # the 15 arguments packed as int64s: ctypes passes one buffer much
    # faster than 15 converted arguments
    args = _ARGS.pack(
        qp, kp, vp, out.data_ptr(), B, S, T, H, K, hd, causal, window,
        q.dtype is torch.bfloat16,
        torch._C._cuda_getCurrentRawStream(index),   # the current stream
        0 if lse is None else lse.data_ptr())
    rc = _library().flash_attention_fwd(args)
    if rc != 0:
        raise RuntimeError(f"flash_attention: kernel launch failed with CUDA "
                           f"error {rc}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def check_bwd_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     o: torch.Tensor, do: torch.Tensor) -> None:
    """Everything the backward kernel needs of its inputs but their device:
    the forward's checks on q, k, v, T == S (queries and keys at the same
    positions, as in training), and o and dO shaped, typed and laid out as
    q."""
    check_shapes(q, k, v)
    if k.shape[1] != q.shape[1]:
        raise ValueError(f"flash_attention_bwd: T = {k.shape[1]} keys for "
                         f"S = {q.shape[1]} queries; the backward kernel "
                         "takes T == S only")
    for name, t in (("o", o), ("do", do)):
        if t.shape != q.shape or t.dtype != q.dtype:
            raise ValueError(f"flash_attention_bwd: {name} is {t.dtype} "
                             f"{tuple(t.shape)}; need q's {q.dtype} "
                             f"{tuple(q.shape)}")
        if not t.is_contiguous() or t.data_ptr() & 15:
            raise ValueError(f"flash_attention_bwd: {name} must be "
                             "contiguous and start on 16 bytes")
    hd = q.shape[3]
    if smem_bytes_bwd(hd, q.dtype) > MAX_SMEM_BYTES:
        raise ValueError(f"flash_attention_bwd: head_dim {hd} needs "
                         f"{smem_bytes_bwd(hd, q.dtype)} bytes of shared "
                         f"memory; a block has {MAX_SMEM_BYTES}")


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        *, causal: bool = True, window: int = 0):
    """The gradient of ``flash_attention`` on the GPU: (dq, dk, dv) in the
    inputs' dtype from q (B,S,H,hd), k, v (B,S,K,hd), the forward's output
    o and its ``lse`` (B,H,S) fp32, and the output's gradient ``do``
    (B,S,H,hd). The same checks as the forward, and T == S. Three launches
    (Δ = rowsum(dO ∘ O), then dk and dv, then dq) on the current stream.
    fp32 runs on the CUDA cores; bf16 on the tensor cores, with P and dS
    rounded to bf16 before the products that take them (every sum fp32)."""
    index, (qp, kp, vp) = _check(q, k, v)
    check_bwd_shapes(q, k, v, o, do)
    _check_lse(lse, q)
    if o.device != q.device or do.device != q.device:
        raise ValueError(f"flash_attention_bwd: o on {o.device}, do on "
                         f"{do.device}; need q's {q.device}")
    B, S, H, hd = q.shape
    K = k.shape[2]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    args = _BWD_ARGS.pack(
        qp, kp, vp, o.data_ptr(), lse.data_ptr(), do.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), delta.data_ptr(),
        B, S, H, K, hd, causal, window, q.dtype is torch.bfloat16,
        torch._C._cuda_getCurrentRawStream(index))
    rc = _bwd_library().flash_attention_bwd(args)
    if rc != 0:
        raise RuntimeError(f"flash_attention_bwd: kernel launch failed with "
                           f"CUDA error {rc}")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0

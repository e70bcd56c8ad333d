"""Wrappers of the hand-written CUDA RG-LRU kernel (``csrc/rglru_scan.cu``):
``rglru_scan``, the port of the Pallas TPU kernel
``repro.kernels.rglru_scan.rglru_scan``, and ``rglru_gated_scan``, the whole
RG-LRU of a recurrent layer (gates, scan from an optional state, GeLU gating)
in one launch, which the model's prefill and decode run.

The wrappers take CUDA tensors only: they check them, allocate the outputs,
launch on the current stream of the tensors' device (which must be the
current device) and raise if the launch is refused. Shape and dtype checks
and the launch layout are computed once per (shapes, dtypes); contiguity,
device and alignment are checked on every call. ``rglru_scan.launches`` and
``rglru_gated_scan.launches`` count the launches, so a run can show that its
path went through the kernel. The plain PyTorch versions are
``kernels.ref.rglru_scan_ref`` and ``kernels.ref.rglru_gated_scan_ref``;
``kernels.ops`` chooses by the tensors' device.
"""
from __future__ import annotations

import ctypes
import functools
import struct
from typing import Optional

import torch

from repro_torch.kernels import _build

DTYPES = (torch.float32, torch.bfloat16)
MAX_WARPS = 8                       # warps of a block (kernel: kMaxWarps)
_SCAN_ARGS = struct.Struct("11q")   # rglru_scan_fwd's packed arguments
_GATED_ARGS = struct.Struct("17q")  # rglru_gated_scan_fwd's


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load("rglru_scan")
    for fn in (lib.rglru_scan_fwd, lib.rglru_gated_scan_fwd):
        fn.argtypes = [ctypes.c_char_p]
        fn.restype = ctypes.c_int
    return lib


def build() -> None:
    """Compile (if needed) and load the kernel now rather than at first
    launch."""
    _library()


@functools.lru_cache(maxsize=256)
def launch_layout(B: int, S: int, W: int, vec: int) -> tuple:
    """How the kernel spreads a (B, S, W) call: (L, G, NW, blocks). A
    thread scans L steps (1 for S <= 64, else 8) of ``vec`` channels; a
    warp holds G channel groups by 32/G chunks, 32/G = the chunks S needs up
    to 8 (so G >= 4); a block has NW warps (at most 8) and covers G·vec
    channels; the grid is ceil(W / (G·vec)) x B blocks. (1, 32, 4096) with
    vec 4 gives 256 blocks of 128 threads; (8, 1, 4096) 256 of 32."""
    L = 1 if S <= 64 else 8
    chunks = -(-S // L)
    per_warp = min(8, 1 << (chunks - 1).bit_length())
    G = 32 // per_warp
    nw = min(MAX_WARPS, -(-chunks // per_warp))
    return L, G, nw, -(-W // (G * vec)) * B


def vector_width(W: int, ptrs, esize: int) -> int:
    """Elements a thread moves per access: 4 (16 bytes of fp32, 8 of bf16)
    when W and every pointer allow, else 2, else 1."""
    either = 0
    for p in ptrs:
        either |= p
    for vec in (4, 2):
        if W % vec == 0 and not either & (vec * esize - 1):
            return vec
    return 1


def _check_devices(name: str, tensors) -> int:
    """Every tensor on the current CUDA device and contiguous; returns the
    device's index."""
    for t in tensors:
        if not t.is_cuda:
            raise ValueError(f"{name}: a tensor is on {t.device}; the CUDA "
                             "kernel takes CUDA tensors only")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    index = torch.cuda.current_device()
    for t in tensors:
        if t.get_device() != index:
            raise ValueError(f"{name}: tensor on {t.device}, but the current "
                             f"device is cuda:{index}")
    return index


@functools.lru_cache(maxsize=256)
def _check_scan_static(a_shape, b_shape, dtypes) -> None:
    """The scan's checks that depend only on shapes and dtypes; cached (a
    failing check raises and is not cached)."""
    if dtypes != (torch.float32, torch.float32):
        raise ValueError(f"rglru_scan: a, b are {dtypes[0]}, {dtypes[1]}; the "
                         "kernel takes float32 only")
    if len(a_shape) != 3 or a_shape != b_shape:
        raise ValueError(f"rglru_scan: need a, b of one (B, S, W) shape, got "
                         f"{tuple(a_shape)} and {tuple(b_shape)}")
    if 0 in a_shape:
        raise ValueError("rglru_scan: empty input")
    if a_shape[0] > 65535:
        raise ValueError(f"rglru_scan: batch {a_shape[0]} > 65535")


@functools.lru_cache(maxsize=256)
def _check_gated_static(r_shape, i_shape, xc_shape, g_shape, r_dtype,
                        i_dtype, xc_dtype, g_dtype, lam_shape, lam_dtype,
                        h0_shape, h0_dtype, out_shape, out_dtype) -> None:
    name = "rglru_gated_scan"
    dtypes = (r_dtype, i_dtype, xc_dtype, g_dtype)
    if r_dtype not in DTYPES or len(set(dtypes)) != 1:
        raise ValueError(f"{name}: r_pre, i_pre, xc, gate_pre are {dtypes}; "
                         "need all float32 or all bfloat16")
    shapes = (r_shape, i_shape, xc_shape, g_shape)
    if len(xc_shape) != 3 or len(set(shapes)) != 1:
        raise ValueError(f"{name}: need r_pre, i_pre, xc, gate_pre of one "
                         f"(B, S, W) shape, got {[tuple(s) for s in shapes]}")
    B, S, W = xc_shape
    if B == 0 or S == 0 or W == 0:
        raise ValueError(f"{name}: empty input")
    if B > 65535:
        raise ValueError(f"{name}: batch {B} > 65535")
    if lam_dtype != torch.float32 or lam_shape != (W,):
        raise ValueError(f"{name}: lam is {lam_dtype} {tuple(lam_shape)}; "
                         f"need float32 ({W},)")
    for what, shape, dtype in (("h0", h0_shape, h0_dtype),
                               ("the state buffer", out_shape, out_dtype)):
        if shape is not None and (dtype != torch.float32
                                  or shape != (B, W)):
            raise ValueError(f"{name}: {what} is {dtype} {tuple(shape)}; "
                             f"need float32 ({B}, {W})")


def check_gated_shapes(r_pre: torch.Tensor, i_pre: torch.Tensor,
                       xc: torch.Tensor, gate_pre: torch.Tensor,
                       lam: torch.Tensor, h0: Optional[torch.Tensor] = None,
                       state_out: Optional[torch.Tensor] = None) -> None:
    """Everything the gated kernel needs of its inputs but their device and
    layout: r_pre, i_pre, xc and gate_pre of one (B, S, W) shape and one
    dtype (float32 or bfloat16), lam float32 (W,), h0 and the state buffer
    (when given) float32 (B, W). Cached per (shapes, dtypes)."""
    _check_gated_static(
        r_pre.shape, i_pre.shape, xc.shape, gate_pre.shape, r_pre.dtype,
        i_pre.dtype, xc.dtype, gate_pre.dtype, lam.shape, lam.dtype,
        None if h0 is None else h0.shape, None if h0 is None else h0.dtype,
        None if state_out is None else state_out.shape,
        None if state_out is None else state_out.dtype)


def rglru_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t ⊙ h_{t-1} + b_t along axis 1 from a zero state, on the GPU.
    a, b: contiguous CUDA fp32 tensors of one (B, S, W) shape on the current
    device, any S and W. Returns h (B, S, W) fp32."""
    index = _check_devices("rglru_scan", (a, b))
    _check_scan_static(a.shape, b.shape, (a.dtype, b.dtype))
    B, S, W = a.shape
    h = torch.empty_like(a)
    ptrs = a.data_ptr(), b.data_ptr(), h.data_ptr()
    vec = vector_width(W, ptrs, 4)
    L, G, nw, _ = launch_layout(B, S, W, vec)
    args = _SCAN_ARGS.pack(*ptrs, B, S, W, vec, L, G.bit_length() - 1, nw,
                           torch._C._cuda_getCurrentRawStream(index))
    rc = _library().rglru_scan_fwd(args)
    if rc != 0:
        raise RuntimeError(f"rglru_scan: kernel launch failed with CUDA error "
                           f"{rc}")
    rglru_scan.launches += 1
    return h


rglru_scan.launches = 0


def rglru_gated_scan(r_pre: torch.Tensor, i_pre: torch.Tensor,
                     xc: torch.Tensor, gate_pre: torch.Tensor,
                     lam: torch.Tensor, h0: Optional[torch.Tensor] = None,
                     state_out: Optional[torch.Tensor] = None):
    """The RG-LRU of one recurrent layer in one launch, on the GPU:
    a = exp(-8·softplus(lam)·sigmoid(r_pre)), b = sqrt(clamp(1 - a·a,
    1e-12))·sigmoid(i_pre)·xc, h the scan of (a, b) from ``h0`` (zero when
    None) and y = h.to(dtype)·gelu_tanh(gate_pre). r_pre, i_pre, xc and
    gate_pre: contiguous (B, S, W) CUDA tensors of one dtype (fp32 or bf16);
    lam: fp32 (W,); h0: fp32 (B, W) or None. Returns (y (B, S, W) in the
    inputs' dtype, the final state h[:, -1] fp32 (B, W)); the state goes to
    ``state_out`` when given (it may be ``h0`` itself, updated in place),
    else to a new tensor. The full h is never stored."""
    ins = (r_pre, i_pre, xc, gate_pre, lam)
    if h0 is not None:
        ins += (h0,)
    if state_out is not None and state_out is not h0:
        ins += (state_out,)
    index = _check_devices("rglru_gated_scan", ins)
    check_gated_shapes(r_pre, i_pre, xc, gate_pre, lam, h0, state_out)
    B, S, W = xc.shape
    y = torch.empty_like(xc)
    if state_out is None:
        state_out = torch.empty(B, W, dtype=torch.float32, device=xc.device)
    ptrs = (r_pre.data_ptr(), i_pre.data_ptr(), xc.data_ptr(),
            gate_pre.data_ptr(), y.data_ptr())
    vec = vector_width(W, ptrs, xc.element_size())
    L, G, nw, _ = launch_layout(B, S, W, vec)
    args = _GATED_ARGS.pack(
        *ptrs[:4], lam.data_ptr(), 0 if h0 is None else h0.data_ptr(),
        ptrs[4], state_out.data_ptr(), B, S, W, xc.dtype is torch.bfloat16,
        vec, L, G.bit_length() - 1, nw,
        torch._C._cuda_getCurrentRawStream(index))
    rc = _library().rglru_gated_scan_fwd(args)
    if rc != 0:
        raise RuntimeError(f"rglru_gated_scan: kernel launch failed with CUDA "
                           f"error {rc}")
    rglru_gated_scan.launches += 1
    return y, state_out


rglru_gated_scan.launches = 0

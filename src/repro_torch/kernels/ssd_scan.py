"""Wrapper of the hand-written CUDA SSD chunked-scan kernels
(``csrc/ssd_scan.cu``), the port of the Pallas TPU kernel
``repro.kernels.ssd_scan.ssd_scan``.

One call launches the chunk-parallel form: a first kernel forms C·Bᵀ once
per (batch, chunk, group) and the cumsum of dt·A per (batch, chunk, head);
when s spans more than one chunk, every chunk's local state and a short pass
over chunks for the state entering each follow; a last kernel writes the
outputs per (batch·head, chunk, 32-row tile). The wrapper takes CUDA tensors
only: it checks them, allocates the output and the kernels' fp32 scratch
(one ``torch.empty``), launches on the current stream of the tensors'
device (which must be the current device) and raises if a launch is
refused. ``ssd_scan.launches`` counts its calls, so a run can show that its
path went through the kernels. The plain PyTorch version of the same
function is ``kernels.ref.ssd_scan_ref`` (``kernels.ref.ssd_scan_chunked``
is the plain form of this decomposition); ``kernels.ops`` chooses by the
tensors' device.
"""
from __future__ import annotations

import ctypes
import functools
import struct

import torch

from repro_torch.kernels import _build

HEAD_DIMS = (16, 32, 64, 128)
DTYPES = (torch.float32, torch.bfloat16)
MAX_SMEM_BYTES = 232_448            # 227 KB: the most one Hopper block may use
TILE = 16                           # rows of an output tile
CB_TILE = 16                        # rows and columns of a C·Bᵀ tile
STATE_ROWS = 32                     # state rows (of n) per block
PREP_WARPS = 8                      # cs rows per block of the first kernel
_ARGS = struct.Struct("20q")        # ssd_scan_fwd's packed arguments


def smem_bytes(p: int, n: int, chunk: int, esize: int = 4,
               chunks: int = 2) -> int:
    """Dynamic shared memory of the largest of one call's kernels, as
    ``csrc/ssd_scan.cu`` lays them out (``esize`` bytes per x/B/C value;
    ``chunks`` > 1 adds the carried state's kernels and buffers):

    - C·Bᵀ and cs: a 16-row tile of C and of B, rows padded by 16 bytes,
      or one fp32 row of dt·A per warp (8 warps);
    - local states: cs and the decay weights (2 floats a row), the
      chunk's x and 32 columns of its B;
    - outputs: the (L, 16 + 4) fp32 transposed score tile, cs and dt, the
      chunk's x and, after the first chunk, the (n, p) fp32 state and 16
      rows of C padded by 16 bytes."""
    prep = max(2 * CB_TILE * (n * esize + 16), 4 * PREP_WARPS * chunk)
    out = 4 * chunk * (TILE + 4) + 4 * 2 * chunk + chunk * p * esize
    if chunks <= 1:
        return max(prep, out)
    states = 4 * 2 * chunk + chunk * p * esize + chunk * STATE_ROWS * esize
    out += 4 * n * p + TILE * (n * esize + 16)
    return max(prep, states, out)


def scratch_shapes(b: int, s: int, h: int, g: int, n: int, p: int,
                   chunk: int) -> dict[str, tuple[int, ...]]:
    """The fp32 scratch one call needs: C·Bᵀ (b, nc, g, L, L), stored
    transposed; cs and dt as rows per (batch, chunk, head), (b, nc, h, L);
    each chunk's local state, then the state entering the next chunk,
    (b, nc-1, h, n, p); and e^{cs_end} per chunk (b, nc-1, h). The last two
    are empty when the sequence is one chunk."""
    nc = -(-s // chunk)
    return {"cb": (b, nc, g, chunk, chunk), "cs": (b, nc, h, chunk),
            "dt": (b, nc, h, chunk), "states": (b, nc - 1, h, n, p),
            "decay": (b, nc - 1, h)}


@functools.lru_cache(maxsize=256)
def scratch_layout(b: int, s: int, h: int, g: int, n: int, p: int,
                   chunk: int) -> tuple[int, ...]:
    """Offsets (in floats) of each of ``scratch_shapes``' buffers in one
    flat fp32 allocation, each rounded up to 16 bytes, and the total last."""
    offsets, total = [], 0
    for shape in scratch_shapes(b, s, h, g, n, p, chunk).values():
        offsets.append(total)
        size = 1
        for d in shape:
            size *= d
        total += -(-size // 4) * 4
    return (*offsets, total)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load("ssd_scan")
    lib.ssd_scan_fwd.argtypes = [ctypes.c_char_p]
    lib.ssd_scan_fwd.restype = ctypes.c_int
    lib.ssd_scan_smem_bytes.argtypes = [ctypes.c_int] * 5
    lib.ssd_scan_smem_bytes.restype = ctypes.c_longlong
    return lib


def build() -> None:
    """Compile (if needed) and load the kernels now rather than at first
    launch."""
    _library()


@functools.lru_cache(maxsize=256)
def _check_static(shapes, dtypes, chunk: int) -> None:
    """The checks that depend only on shapes, dtypes and chunk; cached, so
    that a serving path's few shapes are each checked once (a failing check
    raises and is not cached)."""
    xs, dts, As, Bs, Cs = shapes
    xd, dtd, Ad, Bd, Cd = dtypes
    if len(xs) != 4 or len(dts) != 3 or len(As) != 1 or len(Bs) != 4 \
            or len(Cs) != 4:
        raise ValueError(f"ssd_scan: need x (b,s,h,p), dt (b,s,h), A (h,), "
                         f"B, C (b,s,g,n); got {tuple(xs)}, {tuple(dts)}, "
                         f"{tuple(As)}, {tuple(Bs)}, {tuple(Cs)}")
    if xd not in DTYPES or not (xd == Bd == Cd):
        raise ValueError(f"ssd_scan: x, B, C dtypes {xd}, {Bd}, {Cd}; need "
                         "all float32 or all bfloat16")
    if dtd != torch.float32 or Ad != torch.float32:
        raise ValueError(f"ssd_scan: dt and A must be float32, got {dtd}, "
                         f"{Ad}")
    b, s, h, p = xs
    g, n = Bs[2], Bs[3]
    if tuple(dts) != (b, s, h) or tuple(As) != (h,) \
            or tuple(Bs) != (b, s, g, n) or Cs != Bs:
        raise ValueError(f"ssd_scan: shapes disagree: x {tuple(xs)}, "
                         f"dt {tuple(dts)}, A {tuple(As)}, B {tuple(Bs)}, "
                         f"C {tuple(Cs)}")
    if min(b, s, h) == 0:
        raise ValueError("ssd_scan: empty input")
    if p not in HEAD_DIMS:
        raise ValueError(f"ssd_scan: head dim {p} not in {HEAD_DIMS}")
    if g == 0 or h % g != 0:
        raise ValueError(f"ssd_scan: {h} heads, {g} groups; need h % g == 0")
    if n == 0 or n % 4 or chunk <= 0 or chunk % 4:
        raise ValueError(f"ssd_scan: state {n} and chunk {chunk} must be "
                         "positive multiples of 4")
    need = smem_bytes(p, n, chunk, 2 if xd == torch.bfloat16 else 4,
                      -(-s // chunk))
    if need > MAX_SMEM_BYTES:
        raise ValueError(f"ssd_scan: p={p}, n={n}, chunk={chunk} needs "
                         f"{need} bytes of shared memory; a block has "
                         f"{MAX_SMEM_BYTES}")


def _check_layout(x, dt, A, B, C) -> None:
    if not (x.is_contiguous() and dt.is_contiguous() and A.is_contiguous()
            and B.is_contiguous() and C.is_contiguous()):
        raise ValueError("ssd_scan: inputs must be contiguous")
    if (x.data_ptr() | B.data_ptr() | C.data_ptr()) & 15:
        raise ValueError("ssd_scan: x, B and C must start on 16 bytes")


def check_shapes(x, dt, A, B, C, chunk: int) -> None:
    """Everything the kernels need of the inputs but their device: ranks,
    dtypes, shapes, head dim, groups, state size and chunk, shared memory,
    contiguity and alignment."""
    ts = (x, dt, A, B, C)
    _check_static(tuple(t.shape for t in ts), tuple(t.dtype for t in ts),
                  chunk)
    _check_layout(*ts)


def _check(x, dt, A, B, C, chunk: int) -> int:
    """Checks that guard the launch; returns the device's index."""
    ts = (x, dt, A, B, C)
    for name, t in zip("x dt A B C".split(), ts):
        if not t.is_cuda:
            raise ValueError(f"ssd_scan: {name} is on {t.device}; the CUDA "
                             "kernel takes CUDA tensors only")
    _check_static((x.shape, dt.shape, A.shape, B.shape, C.shape),
                  (x.dtype, dt.dtype, A.dtype, B.dtype, C.dtype), chunk)
    _check_layout(*ts)
    dev = x.device
    if dt.device != dev or A.device != dev or B.device != dev \
            or C.device != dev:
        raise ValueError("ssd_scan: inputs on different devices")
    if dev.index != torch.cuda.current_device():
        raise ValueError(f"ssd_scan: tensors on {dev}, but the current "
                         f"device is cuda:{torch.cuda.current_device()}")
    return dev.index


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, chunk: int) -> torch.Tensor:
    """Mamba-2 SSD chunked scan on the GPU from a zero state. x: (b,s,h,p);
    dt: (b,s,h) fp32; A: (h,) fp32; B, C: (b,s,g,n) with h % g == 0;
    contiguous CUDA tensors on the current device, x/B/C all fp32 or all
    bf16. p in {16, 32, 64, 128}; n and chunk multiples of 4. s need not be
    a multiple of chunk: the last chunk runs at its own length (the same rows
    as zero-padding). Returns y (b,s,h,p) in x's dtype."""
    index = _check(x, dt, A, B, C, chunk)
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    y = torch.empty_like(x)
    *offsets, total = scratch_layout(b, s, h, g, n, p, chunk)
    scratch = torch.empty(total, dtype=torch.float32, device=x.device)
    base = scratch.data_ptr()
    # the 20 arguments packed as int64s: ctypes passes one buffer much
    # faster than 20 converted arguments
    args = _ARGS.pack(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
        C.data_ptr(), y.data_ptr(), *(base + 4 * off for off in offsets),
        b, s, h, p, g, n, chunk, x.dtype is torch.bfloat16,
        torch._C._cuda_getCurrentRawStream(index))   # the current stream
    rc = _library().ssd_scan_fwd(args)
    if rc != 0:
        raise RuntimeError(f"ssd_scan: kernel launch failed with CUDA error "
                           f"{rc}")
    ssd_scan.launches += 1
    return y


ssd_scan.launches = 0

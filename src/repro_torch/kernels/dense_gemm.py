"""Wrapper of the hand-written split-TF32 dense fp32 product
(``csrc/dense_gemm.cu``): C = X·W on the tensor cores at fp32 accuracy.
No TPU kernel stands behind it: the JAX package leaves ``x @ w`` to XLA,
and on the H100 an fp32 ``x @ w`` runs on cuBLAS's SIMT sgemm, below the
CUDA cores' 67 TFLOP/s. The source's note gives the arithmetic and design.

``takes`` is the route (``kernels.ops.matmul``, and through it
``models.layers.linear``): a product goes to the kernel when x and w are
plain (not DTensor) fp32 CUDA tensors, w is contiguous, no gradient is
wanted, x has at least ``MIN_ROWS`` rows, K and N are multiples of 4 and N
is at least one tile (``TILE_N``); any other product stays ``x @ w``. So a
prefill's products (576 rows) take the kernel, and a decode step's (16
rows), training's (grad), bf16 models' and a router's (N 72) keep cuBLAS.

The kernel gives the blocks whole tiles where those fill the SMs' waves,
and shares the rest out stream-K: their stages of K in one run, an equal
share of it a block (``plan``, ``segments``). The wrapper takes
CUDA tensors only: it checks them, allocates the output and, where a tile's
stages fall to more than one block, the partials' workspace
(``torch.empty``), launches
on the current stream of the tensors' device and raises if a launch is
refused. It reads nothing back from the device. Counters, plain integers
on ``dense_gemm``: ``launches`` (its calls), ``flops_taken`` (the FLOPs of
those calls) and ``flops_declined`` (the FLOPs of fp32 CUDA products of at
least ``MIN_ROWS`` rows that ``takes`` sent to ``x @ w``). The plain
PyTorch version is ``kernels.ref.dense_gemm_ref``; ``kernels.ops.dense_gemm``
chooses by the tensors' device.
"""
from __future__ import annotations

import ctypes
import functools
import struct

import torch
from torch.distributed.tensor import DTensor

from repro_torch.kernels import _build

# R: the fewest rows at which the kernel beat cuBLAS's sgemm at every
# product a served prefill runs (H100 SXM, 700 W: at 96 and 128 rows it
# lost where N is 1,024, and at 64 rows everywhere)
MIN_ROWS = 192
ALIGN = 4               # K, N and x's row stride: whole 16-byte chunks
TILE_M, TILE_N, TILE_K = 192, 128, 32  # a block's tile and stage depth
PARTIAL = 96 * 256      # floats of one segment's partial tile
MIN_SHARE = 4           # the fewest stages of K a block is given
WHOLE_FILL = 0.9        # the share of the waves' SMs that whole tiles
                        # must keep busy to be given out whole
_ARGS = struct.Struct("12q")   # dense_gemm_fwd's packed arguments


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load("dense_gemm")
    lib.dense_gemm_fwd.argtypes = [ctypes.c_char_p]
    lib.dense_gemm_fwd.restype = ctypes.c_int
    return lib


def build() -> None:
    """Compile (if needed) and load the kernel now rather than at first
    launch."""
    _library()


def tiles(M: int, N: int) -> int:
    return -(-M // TILE_M) * -(-N // TILE_N)


@functools.lru_cache(maxsize=1024)
def plan(M: int, N: int, K: int, sms: int) -> tuple[int, int, bool]:
    """(blocks, whole tiles, no split tile) for a product on ``sms`` SMs,
    one block an SM. Where whole tiles keep ``WHOLE_FILL`` of the waves'
    SMs busy they are all given out whole; else all but the last one or two
    waves' worth are, and the rest are shared out stream-K (their stages of
    K, ``TILE_K`` deep, in one run, an equal share a block). No block is
    given fewer than ``MIN_SHARE`` stages unless there are fewer. The last
    is whether every block's stream-K share begins on a tile's edge, so
    that no tile is split and no workspace is needed."""
    stages, n = -(-K // TILE_K), tiles(M, N)
    blocks = max(1, min(sms, n * stages // MIN_SHARE))
    if n >= blocks and n / (-(-n // blocks) * blocks) >= WHOLE_FILL:
        whole = n
    else:
        whole = max(0, (n // blocks - 1) * blocks)
    rest = (n - whole) * stages
    return blocks, whole, rest % blocks == 0 and rest // blocks % stages == 0


def segments(M: int, N: int, K: int, blocks: int,
             whole: int) -> list[list[tuple]]:
    """Each block's segments as the kernel walks them: (tile, first stage,
    stages, part, parts, slot). Block b first takes the whole tiles b, b +
    G, ... below ``whole`` (G blocks), then iterations [b·I/G, (b+1)·I/G)
    of the run of the other tiles' stages (I of them); a segment is its run
    within one tile; ``part`` is its place among the tile's segments, in
    block order, ``parts`` their number; ``slot`` 0 for a block's first
    stream-K segment, 1 for any later one (only a first or a last segment
    can be a part)."""
    stages = -(-K // TILE_K)
    total = (tiles(M, N) - whole) * stages
    start = lambda b: b * total // blocks
    block_of = lambda i: ((i + 1) * blocks - 1) // total
    out = []
    for b in range(blocks):
        segs = [(t, 0, stages, 0, 1, 0) for t in range(b, whole, blocks)]
        i, end = start(b), start(b + 1)
        while i < end:
            k, kb0 = divmod(i, stages)
            nk = min(stages - kb0, end - i)
            b0 = block_of(k * stages)
            parts = block_of(k * stages + stages - 1) - b0 + 1
            segs.append((whole + k, kb0, nk, b - b0, parts,
                         0 if i == start(b) else 1))
            i += nk
        out.append(segs)
    return out


def takes(x: torch.Tensor, w: torch.Tensor) -> bool:
    """Whether ``x @ w`` goes to the kernel (the rule in the module's
    docstring); counts the FLOPs of a declined fp32 CUDA product of at
    least ``MIN_ROWS`` rows in ``dense_gemm.flops_declined``."""
    if x.device.type != "cuda" or x.dtype != torch.float32 \
            or w.dtype != torch.float32 or w.dim() != 2:
        return False
    K, N = w.shape
    if x.dim() == 0 or x.shape[-1] != K:
        return False
    rows = x.numel() // K if K else 0
    if rows < MIN_ROWS:
        return False
    if not (isinstance(x, DTensor) or isinstance(w, DTensor)
            or (torch.is_grad_enabled()
                and (x.requires_grad or w.requires_grad))) \
            and w.is_contiguous() and w.device == x.device \
            and K % ALIGN == 0 and N % ALIGN == 0 and N >= TILE_N \
            and w.data_ptr() % 16 == 0:
        return True
    dense_gemm.flops_declined += 2 * rows * K * N
    return False


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


_counters: dict[tuple[int, int], torch.Tensor] = {}


def _tile_counters(index: int, stream: int, n: int) -> torch.Tensor:
    """The per-tile arrival counters of one device and stream, zero
    between calls (the last block to finish a split tile resets its
    counter)."""
    c = _counters.get((index, stream))
    if c is None or c.numel() < n:
        c = torch.zeros(max(n, 1024), dtype=torch.int32,
                        device=torch.device("cuda", index))
        _counters[(index, stream)] = c
    return c


@functools.lru_cache(maxsize=256)
def _check_static(xs, ws, dtypes) -> None:
    """The checks that depend only on shapes and dtypes; cached, so that a
    serving path's few shapes are each checked once."""
    if len(ws) != 2 or not xs or xs[-1] != ws[0]:
        raise ValueError(f"dense_gemm: need x (..., K) and w (K, N); got "
                         f"{xs} and {ws}")
    if dtypes != (torch.float32, torch.float32):
        raise ValueError(f"dense_gemm: x and w must be float32, got {dtypes}")
    K, N = ws
    if min(K, N) <= 0 or K % ALIGN or N % ALIGN:
        raise ValueError(f"dense_gemm: K {K} and N {N} must be positive "
                         f"multiples of {ALIGN}")


def dense_gemm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w on the GPU at fp32 accuracy. x (..., K) and w (K, N) fp32 CUDA
    tensors on the current device, w contiguous, K and N multiples of 4.
    Returns (..., N) fp32."""
    if not (x.is_cuda and w.is_cuda):
        raise ValueError(f"dense_gemm: x on {x.device}, w on {w.device}; "
                         "the CUDA kernel takes CUDA tensors only")
    _check_static(tuple(x.shape), tuple(w.shape), (x.dtype, w.dtype))
    if not w.is_contiguous():
        raise ValueError("dense_gemm: w must be contiguous")
    index = x.device.index
    if w.device != x.device or index != torch.cuda.current_device():
        raise ValueError(f"dense_gemm: x on {x.device}, w on {w.device}, "
                         f"current device cuda:{torch.cuda.current_device()}")
    if w.data_ptr() % 16:
        raise ValueError("dense_gemm: w must start on 16 bytes")
    K, N = w.shape
    x2 = x.reshape(-1, K)
    M = x2.shape[0]
    if M == 0:
        return x.new_empty((*x.shape[:-1], N))
    if x2.stride(1) != 1 or x2.stride(0) < K or x2.stride(0) % ALIGN \
            or x2.data_ptr() % 16:
        x2 = x2.contiguous()
    c = torch.empty((M, N), dtype=torch.float32, device=x.device)
    stream = torch._C._cuda_getCurrentRawStream(index)
    grid, whole, unsplit = plan(M, N, K, _sms(index))
    ws = cnt = None
    if not unsplit:
        ws = torch.empty(grid * 2 * PARTIAL, dtype=torch.float32,
                         device=x.device)
        cnt = _tile_counters(index, stream, tiles(M, N))
    args = _ARGS.pack(x2.data_ptr(), w.data_ptr(), c.data_ptr(),
                      ws.data_ptr() if ws is not None else 0,
                      cnt.data_ptr() if cnt is not None else 0,
                      M, N, K, x2.stride(0), whole, grid, stream)
    rc = _library().dense_gemm_fwd(args)
    if rc != 0:
        raise RuntimeError(f"dense_gemm: kernel launch failed with CUDA "
                           f"error {rc}")
    dense_gemm.launches += 1
    dense_gemm.flops_taken += 2 * M * K * N
    return c.reshape(*x.shape[:-1], N)


dense_gemm.launches = 0
dense_gemm.flops_taken = 0
dense_gemm.flops_declined = 0

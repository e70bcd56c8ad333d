"""Wrapper of the hand-written grouped fp32 expert products of a dropless
MoE layer (``csrc/moe_experts.cu``). No TPU kernel stands behind it: the
JAX package's MoE gives each expert a fixed capacity and leaves the padded
products to XLA.

The layer (``models.moe.apply_moe_dropless``) sorts the (token, k) entries
that fall on the experts this device holds by expert, on the device, and
hands over each sorted row's token (``rows``) and each held expert's end
row (``ends``). One call launches two kernels: each held expert's SwiGLU
gate and up products over exactly its rows, then its down product. No
count is read back on the host. The wrapper takes CUDA tensors only: it
checks them, allocates the output and the fp32 scratch between the two
kernels (``torch.empty``), launches on the current stream of the tensors'
device and raises if a launch is refused. ``moe_experts.launches`` counts
its calls (the ``moe_expert_launches`` of a run), so a run can show that
its path went through the kernels. The plain PyTorch version of the same
function is ``kernels.ref.moe_experts_ref``; ``kernels.ops`` chooses by the
tensors' device.
"""
from __future__ import annotations

import ctypes
import functools
import struct

import torch

from repro_torch.kernels import _build

WIDTH_MULTIPLE = 64            # D and F: whole column tiles and slices
SMALL_ROWS = 8                 # expected rows an expert at or under which
                               # the decode tiles (16 x 32) are taken
_ARGS = struct.Struct("15q")   # moe_experts_fwd's packed arguments


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load("moe_experts")
    lib.moe_experts_fwd.argtypes = [ctypes.c_char_p]
    lib.moe_experts_fwd.restype = ctypes.c_int
    return lib


def build() -> None:
    """Compile (if needed) and load the kernels now rather than at first
    launch."""
    _library()


def small_tiles(entries: int, experts: int) -> bool:
    """Whether a call takes the decode tiles: when the rows an expert gets
    under uniform routing, ``entries`` (tokens·K) over the ``experts`` (E)
    routed to, are few."""
    return entries <= SMALL_ROWS * experts


@functools.lru_cache(maxsize=256)
def _check_static(shapes, dtypes) -> None:
    """The checks that depend only on shapes and dtypes; cached, so that a
    serving path's few shapes are each checked once."""
    xs, rs, es, w1s, w3s, w2s = shapes
    if len(xs) != 2 or len(rs) != 1 or len(es) != 1 or len(w1s) != 3:
        raise ValueError(f"moe_experts: need x (T, D), rows (R,), ends (n,), "
                         f"w1, w3 (n, D, F), w2 (n, F, D); got {shapes}")
    T, D = xs
    n, _, Fw = w1s
    if tuple(w1s) != (n, D, Fw) or tuple(w3s) != (n, D, Fw) \
            or tuple(w2s) != (n, Fw, D) or tuple(es) != (n,):
        raise ValueError(f"moe_experts: shapes disagree: {shapes}")
    if dtypes[0] != torch.float32 or any(d != torch.float32
                                         for d in dtypes[3:]):
        raise ValueError(f"moe_experts: x and the weights must be float32, "
                         f"got {dtypes}")
    if dtypes[1] != torch.int64 or dtypes[2] != torch.int64:
        raise ValueError("moe_experts: rows and ends must be int64")
    if min(T, rs[0], n) == 0:
        raise ValueError("moe_experts: empty input")
    if D % WIDTH_MULTIPLE or Fw % WIDTH_MULTIPLE:
        raise ValueError(f"moe_experts: D {D} and F {Fw} must be multiples "
                         f"of {WIDTH_MULTIPLE}")


def _check(x, rows, ends, w1, w3, w2) -> int:
    """Checks that guard the launch; returns the device's index."""
    ts = (x, rows, ends, w1, w3, w2)
    for name, t in zip("x rows ends w1 w3 w2".split(), ts):
        if not t.is_cuda:
            raise ValueError(f"moe_experts: {name} is on {t.device}; the "
                             "CUDA kernel takes CUDA tensors only")
        if not t.is_contiguous():
            raise ValueError(f"moe_experts: {name} must be contiguous")
    _check_static(tuple(tuple(t.shape) for t in ts),
                  tuple(t.dtype for t in ts))
    dev = x.device
    if any(t.device != dev for t in ts):
        raise ValueError("moe_experts: inputs on different devices")
    if (x.data_ptr() | w1.data_ptr() | w3.data_ptr() | w2.data_ptr()) & 15:
        raise ValueError("moe_experts: x and the weights must start on 16 "
                         "bytes")
    if dev.index != torch.cuda.current_device():
        raise ValueError(f"moe_experts: tensors on {dev}, but the current "
                         f"device is cuda:{torch.cuda.current_device()}")
    return dev.index


def moe_experts(x: torch.Tensor, rows: torch.Tensor, ends: torch.Tensor,
                w1: torch.Tensor, w3: torch.Tensor, w2: torch.Tensor,
                small: bool) -> torch.Tensor:
    """Each held expert's SwiGLU over its sorted rows, on the GPU. x (T, D)
    fp32; rows (R,) int64, the token of each sorted row; ends (n,) int64,
    each held expert's end row, ascending; w1, w3 (n, D, F) and w2 (n, F,
    D) fp32; D and F multiples of 64; contiguous CUDA tensors on the
    current device. ``small``: the decode tiles (``small_tiles``). Returns
    y (R + 1, D): row r < ends[-1] is (silu(x[rows[r]] @ w1[e]) *
    (x[rows[r]] @ w3[e])) @ w2[e] for r's expert e; row R is zero (where
    the combine sends the entries that fall on no held expert); the rows
    between are not written."""
    index = _check(x, rows, ends, w1, w3, w2)
    R, (T, D), (n, _, Fw) = rows.shape[0], x.shape, w1.shape
    y = torch.empty((R + 1, D), dtype=torch.float32, device=x.device)
    y[R].zero_()
    h = torch.empty((R, Fw), dtype=torch.float32, device=x.device)
    args = _ARGS.pack(
        x.data_ptr(), rows.data_ptr(), ends.data_ptr(), w1.data_ptr(),
        w3.data_ptr(), w2.data_ptr(), h.data_ptr(), y.data_ptr(), T, R, n,
        D, Fw, bool(small), torch._C._cuda_getCurrentRawStream(index))
    rc = _library().moe_experts_fwd(args)
    if rc != 0:
        raise RuntimeError(f"moe_experts: kernel launch failed with CUDA "
                           f"error {rc}")
    moe_experts.launches += 1
    return y


moe_experts.launches = 0

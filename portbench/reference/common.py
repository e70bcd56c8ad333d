"""What the plain references share: the description of a parameter tree
(shape and distribution of every leaf, from which the benchmark makes the
weights), the precision every contraction runs in, and the norms.

A reference imports torch only: nothing of the program under test. Every
matrix product goes through ``ein`` so that one switch sets its precision:
"fp32" with TF32 off (what the configurations state), or "tf32", the
control one step below it. On a GPU "tf32" is the card's own TF32 path; on
the CPU, which has none, the operands are rounded to TF32's 10-bit
mantissa and the products summed in fp32, which is what the tensor cores
do.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math

import torch

PRECISIONS = ("fp32", "tf32")
FP32_LEAVES = ("A_log", "D", "dt_bias")    # fp32 whatever the weights' type


@dataclasses.dataclass(frozen=True)
class Leaf:
    """One parameter: its shape and how it is drawn. ``init`` is
    ("normal", std), ("uniform", lo, hi), ("const", value) or
    ("log_linspace", lo, hi): log of ``shape[0]`` evenly spaced values."""
    shape: tuple
    init: tuple


def normal(std: float) -> tuple:
    return ("normal", float(std))


def const(value: float) -> tuple:
    return ("const", float(value))


def norm_tree(kind: str, D: int) -> dict:
    if kind == "nonparam_ln":
        return {}
    if kind == "rmsnorm":
        return {"scale": Leaf((D,), const(1.0))}
    if kind == "layernorm":
        return {"scale": Leaf((D,), const(1.0)), "bias": Leaf((D,), const(0.0))}
    raise ValueError(f"norm {kind!r}")


def apply_norm(p: dict, x: torch.Tensor, kind: str) -> torch.Tensor:
    """rmsnorm: x·rsqrt(mean(x²) + 1e-6)·scale; layernorm and the
    non-parametric one: (x - mean)·rsqrt(var + 1e-5), population
    variance, then ·scale + bias for layernorm."""
    if kind == "rmsnorm":
        return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + 1e-6) \
            * p["scale"]
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    out = (x - mu) * torch.rsqrt(var + 1e-5)
    if kind == "layernorm":
        out = out * p["scale"] + p["bias"]
    return out


class Precision:
    """The precision of every contraction in one reference run."""

    def __init__(self, name: str = "fp32"):
        if name not in PRECISIONS:
            raise ValueError(f"precision {name!r}; one of {PRECISIONS}")
        self.name = name

    @contextlib.contextmanager
    def active(self):
        """Set the card's TF32 switches for the run and put them back."""
        old = (torch.backends.cuda.matmul.allow_tf32,
               torch.backends.cudnn.allow_tf32)
        tf32 = self.name == "tf32"
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
        try:
            yield self
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = old

    def ein(self, eq: str, *ops: torch.Tensor) -> torch.Tensor:
        if self.name == "tf32" and ops[0].device.type != "cuda":
            ops = tuple(round_tf32(t) for t in ops)
        return torch.einsum(eq, *ops)


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """``t`` (fp32) rounded to the nearest TF32 value (10 mantissa bits,
    ties to even), kept in fp32."""
    bits = t.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    rounded = (bits + 0xFFF + lsb) & ~0x1FFF
    return rounded.view(torch.float32)


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary positions 0..S-1 on x (B, S, H, hd), the two halves of the
    head dimension rotated against each other (GPT-NeoX's layout)."""
    S, hd = x.shape[1], x.shape[-1]
    half = hd // 2
    freqs = torch.exp(-math.log(theta) * torch.arange(
        half, dtype=torch.float32, device=x.device) / half)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] \
        * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)

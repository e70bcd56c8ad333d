"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427),
ported from ``repro.models.rglru``.

Real-gated linear recurrent unit:
    r_t = sigmoid(W_r x_t);  i_t = sigmoid(W_i x_t)
    a_t = exp(-c * softplus(Lambda) * r_t)          (c = 8)
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)
inside the Griffin recurrent block: linear in, causal conv, RG-LRU,
GeLU-gated output projection. With ``use_kernel=True`` the RG-LRU of a
layer (gates, scan, GeLU gating) is one call of
``kernels.ops.rglru_gated_scan`` (one launch of the hand-written CUDA kernel
on the GPU, its plain PyTorch version on the CPU), in prefill and in decode;
with ``use_kernel=False`` the plain torch ops run everywhere. Decode keeps an
fp32 (B, W) state and the last ``rnn_conv - 1`` pre-conv inputs, both
updated in place.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ref
from repro_torch.models.config import ArchConfig
from repro_torch.models.ssm import _causal_conv

RG_C = ref.RG_C


def _gates(params, xc: torch.Tensor):
    """(a, gated input), both fp32, from the conv output ``xc``."""
    return ref.rglru_gates(xc @ params["wr"], xc @ params["wi"], xc,
                           params["lam"])


def _gated_scan(params, x: torch.Tensor, xc: torch.Tensor, h0=None):
    """The fused RG-LRU of one layer through ``kernels.ops``: returns (y,
    final state); the state goes into ``h0`` when given (in place)."""
    from repro_torch.kernels import ops as kops
    return kops.rglru_gated_scan(xc @ params["wr"], xc @ params["wi"], xc,
                                 x @ params["wgate"], params["lam"], h0=h0,
                                 state_out=h0)


def rglru_forward(params, x: torch.Tensor, cfg: ArchConfig,
                  use_kernel: bool = False, want_cache: bool = False):
    """Full-sequence recurrent block. x: (B,S,D) -> (B,S,D), or with
    ``want_cache`` (out, decode cache).

    The cache is the scan's own last state ``h[:, -1]`` (the kernel's
    final-state buffer with ``use_kernel``) and the last ``rnn_conv - 1``
    pre-conv inputs. The reference's ``_rglru_cache_from_prefill`` instead
    recomputes the projection, conv and gates and reruns the plain scan; the
    values agree (fp32, 2e-5), and here each prefill launches one kernel per
    layer and never runs the plain scan on the GPU."""
    S = x.shape[1]
    xw = x @ params["wx"]
    xc = _causal_conv(xw, params["conv_w"], params["conv_b"])
    if use_kernel:
        y, h_last = _gated_scan(params, x, xc)
    else:
        gate = F.gelu(x @ params["wgate"], approximate="tanh")
        a, gated_in = _gates(params, xc)
        h = ref.rglru_scan_ref(a, gated_in)
        y = h.to(x.dtype) * gate
        h_last = h[:, -1]
    out = y @ params["wo"]
    if not want_cache:
        return out
    # S < rnn_conv - 1 leaves a short history, as in the reference
    return out, {"h": h_last, "conv": xw[:, S - (cfg.rnn_conv - 1):]}


def rglru_init_cache(cfg: ArchConfig, batch: int, dtype, device) -> dict:
    """Zero decode cache: the fp32 state, whatever the parameters' dtype,
    and the conv history in the parameters' dtype."""
    W = cfg.rnn_width
    return {"h": torch.zeros((batch, W), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, cfg.rnn_conv - 1, W), dtype=dtype,
                                device=device)}


def rglru_step(params, x: torch.Tensor, cache: dict, cfg: ArchConfig,
               use_kernel: bool = False):
    """One-token decode. x: (B,1,D) -> (out (B,1,D), cache). The state and
    the conv history are updated **in place**, so a serving pool's cache is
    allocated once; with ``use_kernel`` the state is the fused kernel's h0
    and final-state buffer at S = 1. The conv history stays in torch ops."""
    xw = x[:, 0] @ params["wx"]
    hist = torch.cat([cache["conv"], xw[:, None, :]], dim=1)   # (B,W,C)
    xc = torch.einsum("bwc,wc->bc", hist, params["conv_w"]) + params["conv_b"]
    if use_kernel:
        # the einsum leaves xc batch-minor; the kernel reads rows
        y, _ = _gated_scan(params, x, xc.contiguous()[:, None, :],
                           h0=cache["h"])
        y = y[:, 0]
    else:
        gate = F.gelu(x[:, 0] @ params["wgate"], approximate="tanh")
        a, gated_in = _gates(params, xc[:, None, :])
        h = cache["h"].mul_(a[:, 0]).add_(gated_in[:, 0])
        y = h.to(x.dtype) * gate
    cache["conv"].copy_(hist[:, 1:])
    return (y @ params["wo"])[:, None, :], cache

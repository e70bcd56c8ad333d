"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427),
ported from ``repro.models.rglru``.

Real-gated linear recurrent unit:
    r_t = sigmoid(W_r x_t);  i_t = sigmoid(W_i x_t)
    a_t = exp(-c * softplus(Lambda) * r_t)          (c = 8)
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)
inside the Griffin recurrent block: linear in, causal conv, RG-LRU,
GeLU-gated output projection. The full-sequence form runs the scan through
``kernels.ops.rglru_scan`` (the hand-written CUDA kernel on the GPU, its
plain PyTorch version on the CPU) or, with ``use_kernel=False``, the plain
version everywhere. Decode is the single-step recurrence in torch ops, as
the reference's is jnp: an fp32 (B, W) state and the last ``rnn_conv - 1``
pre-conv inputs, both updated in place.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ref
from repro_torch.models.config import ArchConfig
from repro_torch.models.ssm import _causal_conv

RG_C = 8.0


def _gates(params, xc: torch.Tensor):
    """(a, gated input), both fp32, from the conv output ``xc``."""
    r = torch.sigmoid((xc @ params["wr"]).float())
    i = torch.sigmoid((xc @ params["wi"]).float())
    a = torch.exp(-RG_C * F.softplus(params["lam"]) * r)         # (B,S,W)
    gated_in = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (
        i * xc.float())
    return a, gated_in


def rglru_forward(params, x: torch.Tensor, cfg: ArchConfig,
                  use_kernel: bool = False, want_cache: bool = False):
    """Full-sequence recurrent block. x: (B,S,D) -> (B,S,D), or with
    ``want_cache`` (out, decode cache).

    The cache is the scan's own last state ``h[:, -1]`` and the last
    ``rnn_conv - 1`` pre-conv inputs. The reference's
    ``_rglru_cache_from_prefill`` instead recomputes the projection, conv and
    gates and reruns the plain scan; the values agree (fp32, 2e-5), and here
    each prefill launches the scan once per layer and never runs the plain
    scan on the GPU."""
    S = x.shape[1]
    gate = F.gelu(x @ params["wgate"], approximate="tanh")
    xw = x @ params["wx"]
    xc = _causal_conv(xw, params["conv_w"], params["conv_b"])
    a, gated_in = _gates(params, xc)
    if use_kernel:
        from repro_torch.kernels import ops as kops
        h = kops.rglru_scan(a.contiguous(), gated_in.contiguous())
    else:
        h = ref.rglru_scan_ref(a, gated_in)
    out = (h.to(x.dtype) * gate) @ params["wo"]
    if not want_cache:
        return out
    # S < rnn_conv - 1 leaves a short history, as in the reference
    return out, {"h": h[:, -1], "conv": xw[:, S - (cfg.rnn_conv - 1):]}


def rglru_init_cache(cfg: ArchConfig, batch: int, dtype, device) -> dict:
    """Zero decode cache: the fp32 state, whatever the parameters' dtype,
    and the conv history in the parameters' dtype."""
    W = cfg.rnn_width
    return {"h": torch.zeros((batch, W), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, cfg.rnn_conv - 1, W), dtype=dtype,
                                device=device)}


def rglru_step(params, x: torch.Tensor, cache: dict, cfg: ArchConfig):
    """One-token decode. x: (B,1,D) -> (out (B,1,D), cache). The state and
    the conv history are updated **in place**, so a serving pool's cache is
    allocated once."""
    gate = F.gelu(x[:, 0] @ params["wgate"], approximate="tanh")
    xw = x[:, 0] @ params["wx"]
    hist = torch.cat([cache["conv"], xw[:, None, :]], dim=1)   # (B,W,C)
    xc = torch.einsum("bwc,wc->bc", hist, params["conv_w"]) + params["conv_b"]
    a, gated_in = _gates(params, xc[:, None, :])
    h = cache["h"].mul_(a[:, 0]).add_(gated_in[:, 0])
    cache["conv"].copy_(hist[:, 1:])
    y = h.to(x.dtype) * gate
    return (y @ params["wo"])[:, None, :], cache

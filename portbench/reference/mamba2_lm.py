"""Plain PyTorch Mamba-2 language model (arXiv:2405.21060): pre-norm SSD
blocks with no MLP, a final RMSNorm and an output head. The SSD mixer is
computed in its quadratic "dual" form over the whole sequence,

    y_i = Σ_{j<=i} (C_i·B_j) · exp(Σ_{j<t<=i} dt_t·A) · dt_j · x_j + D·x_i,

which shares nothing with a chunked scan or a recurrent step: the
cumulative sums of dt·A are taken in fp64 so that their differences stay
exact over long sequences. One group of B and C (Mamba-2's default at these
sizes). No kernels, no cache, no batching of requests.

The weights' description: in_proj N(0, 1/D); conv_w N(0, 1/width);
out_proj N(0, 1/d_inner/(2·layers)); the embedding N(0, 0.02²), the head
N(0, 1/D); A_log = log(linspace(1, 16, heads)); dt_bias ~ U(log 1e-3,
log 1e-1); D = 1; the norms' scales 1 and conv_b 0.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from reference.common import Leaf, Precision, apply_norm, const, norm_tree, \
    normal


def _sizes(c: dict):
    di = c["ssm_expand"] * c["d_model"]
    return di, di // c["ssm_head_dim"], c["ssm_head_dim"], c["ssm_state"]


def tree(c: dict) -> dict:
    D, L, V, W = c["d_model"], c["num_layers"], c["vocab_size"], c["ssm_conv"]
    di, H, _, N = _sizes(c)

    def block():
        return {"norm1": norm_tree(c["norm"], D),
                "mixer": {
                    "in_proj": Leaf((D, 2 * di + 2 * N + H),
                                    normal(1 / math.sqrt(D))),
                    "conv_w": Leaf((W, di + 2 * N), normal(1 / math.sqrt(W))),
                    "conv_b": Leaf((di + 2 * N,), const(0.0)),
                    "A_log": Leaf((H,), ("log_linspace", 1.0, 16.0)),
                    "D": Leaf((H,), const(1.0)),
                    "dt_bias": Leaf((H,), ("uniform", math.log(1e-3),
                                           math.log(1e-1))),
                    "norm_scale": Leaf((di,), const(1.0)),
                    "out_proj": Leaf((di, D), normal(
                        1 / math.sqrt(2 * L) / math.sqrt(di)))}}

    embed = {"embedding": Leaf((V, D), normal(0.02))}
    if not c.get("tie_embeddings", False):
        embed["lm_head"] = Leaf((D, V), normal(1 / math.sqrt(D)))
    return {"embed": embed, "final_norm": norm_tree(c["norm"], D),
            "layers": [block() for _ in range(L)]}


def _mixer(p: dict, h: torch.Tensor, c: dict, pr: Precision) -> torch.Tensor:
    B, S, _ = h.shape
    di, H, P, N = _sizes(c)
    W = c["ssm_conv"]
    z, xbc, dt = pr.ein("bsd,de->bse", h, p["in_proj"]).split(
        [di, di + 2 * N, H], dim=-1)
    padded = F.pad(xbc, (0, 0, W - 1, 0))
    conv = sum(padded[:, i:i + S] * p["conv_w"][i] for i in range(W))
    x, Bm, Cm = F.silu(conv + p["conv_b"]).split([di, N, N], dim=-1)
    x = x.reshape(B, S, H, P)
    dt = F.softplus(dt + p["dt_bias"])                          # (B, S, H)
    cs = torch.cumsum(dt.double() * -torch.exp(p["A_log"].double()), dim=1)
    seg = cs[:, :, None, :] - cs[:, None, :, :]                 # (B, i, j, H)
    causal = torch.ones(S, S, dtype=torch.bool, device=h.device).tril()
    decay = torch.exp(seg.masked_fill(~causal[None, :, :, None],
                                      -math.inf)).float()
    cb = pr.ein("bin,bjn->bij", Cm, Bm)
    y = pr.ein("bijh,bjhp->bihp", cb[..., None] * decay * dt[:, None],
               x)
    y = (y + p["D"][:, None] * x).reshape(B, S, di) * F.silu(z)
    y = y * torch.rsqrt((y * y).mean(-1, keepdim=True) + 1e-6) \
        * p["norm_scale"]
    return pr.ein("bse,ed->bsd", y, p["out_proj"])


def hidden(params: dict, tokens: torch.Tensor, c: dict,
           pr: Precision) -> torch.Tensor:
    x = params["embed"]["embedding"][tokens]
    for p in params["layers"]:
        x = x + _mixer(p["mixer"], apply_norm(p["norm1"], x, c["norm"]), c,
                       pr)
    return apply_norm(params["final_norm"], x, c["norm"])


def logits_last(params: dict, tokens: torch.Tensor, n: int, c: dict,
                pr: Precision) -> torch.Tensor:
    """Logits (B, n, V) at the last ``n`` positions of ``tokens``."""
    x = hidden(params, tokens, c, pr)[:, -n:]
    emb = params["embed"]
    if "lm_head" in emb:
        return pr.ein("bsd,dv->bsv", x, emb["lm_head"])
    return pr.ein("bsd,vd->bsv", x, emb["embedding"])

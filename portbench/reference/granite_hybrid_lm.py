"""Plain PyTorch granite-4.0-h-small (hf:ibm-granite/granite-4.0-h-small,
``model_type: granitemoehybrid``): every position's logits from the full
sequence, dropless, with no kernels, no cache and no batching of requests.

Each layer: x ← x + r·mixer(RMSNorm(x)), the mixer Mamba-2 or attention as
``block_pattern`` says; then x ← x + r·(MoE(RMSNorm(x)) + shared(RMSNorm(x))).
x₀ = embedding_multiplier·embed(tokens); logits = RMSNorm(x)·Eᵀ /
logits_scaling (tied). RMSNorm eps ``rms_norm_eps``.

- Mamba-2, in its quadratic "dual" form over the whole sequence (shares
  nothing with a chunked scan or a recurrent step),
  y_i = Σ_{j<=i} (C_i·B_j)·exp(Σ_{j<t<=i} dt_t·A)·dt_j·x_j + D·x_i,
  the cumulative sums of dt·A in fp64; one group of B and C, a causal
  depthwise conv with a bias, then y·silu(z) and an RMSNorm over the whole
  d_inner (eps ``ssm_norm_eps``).
- Attention: grouped-query, no positional encoding, softmax scale
  ``attention_multiplier``, causal.
- MoE: router logits h·W_r over all ``num_experts``; each token takes its
  ``experts_per_token`` largest (ties to the lower index); the gates are
  the softmax over the selected logits; every selected expert computes
  (dropless); SwiGLU experts; one shared SwiGLU expert on every token.

Departures from the published model: only the share. The parameters hold
experts 0 .. ``experts_held`` - 1 (all, without it); the routing is over
all experts, and the experts held elsewhere add nothing, as on one device
of an expert-parallel group. Each call of ``logits_last`` prints (standard
output, before the run's result line) how many routing decisions it took
and how many had a margin, the last selected logit less the first left
out, under ``NEAR_TIE``: where fp32 rounding could pick another expert.

The weights' description: in_proj, the attention projections, the router
and the experts' and shared expert's w1 and w3 N(0, 1/D); out_proj, wo and
the w2s further by 1/√(2·layers) over √fan_in; conv_w N(0, 1/width),
conv_b U(-1/2, 1/2) (PyTorch's default for a depthwise conv of width 4);
A_log = log(linspace(1, 16, heads)); dt_bias ~ U(log 1e-3, log 1e-1);
D = 1; the norms' scales 1; the embedding N(0, 0.02²).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from reference.common import Leaf, Precision, const, normal

NEAR_TIE = 1e-5
ROUTING = {"decisions": 0, "near_ties": 0}


def _sizes(c: dict):
    di = c["ssm_expand"] * c["d_model"]
    return di, di // c["ssm_head_dim"], c["ssm_head_dim"], c["ssm_state"]


def _kinds(c: dict) -> list:
    p = c["block_pattern"]
    return [tuple(p[i % len(p)]) for i in range(c["num_layers"])]


def _held(c: dict) -> int:
    return c.get("experts_held") or c["num_experts"]


def tree(c: dict) -> dict:
    D, L, V, W = c["d_model"], c["num_layers"], c["vocab_size"], c["ssm_conv"]
    di, H, _, N = _sizes(c)
    Hq, K, hd = c["num_heads"], c["num_kv_heads"], c["head_dim"]
    E, Fe, Fs = _held(c), c["moe_d_ff"], c["moe_shared_d_ff"]
    inp, out = normal(1 / math.sqrt(D)), 1 / math.sqrt(2 * L)
    scale = {"scale": Leaf((D,), const(1.0))}

    def mixer(kind):
        if kind == "ssd":
            return {"in_proj": Leaf((D, 2 * di + 2 * N + H), inp),
                    "conv_w": Leaf((W, di + 2 * N), normal(1 / math.sqrt(W))),
                    "conv_b": Leaf((di + 2 * N,), ("uniform", -0.5, 0.5)),
                    "A_log": Leaf((H,), ("log_linspace", 1.0, 16.0)),
                    "D": Leaf((H,), const(1.0)),
                    "dt_bias": Leaf((H,), ("uniform", math.log(1e-3),
                                           math.log(1e-1))),
                    "norm_scale": Leaf((di,), const(1.0)),
                    "out_proj": Leaf((di, D), normal(out / math.sqrt(di)))}
        return {"wq": Leaf((D, Hq * hd), inp), "wk": Leaf((D, K * hd), inp),
                "wv": Leaf((D, K * hd), inp),
                "wo": Leaf((Hq * hd, D), normal(out / math.sqrt(Hq * hd)))}

    def block(kind):
        return {"norm1": dict(scale), "mixer": mixer(kind),
                "norm2": dict(scale),
                "ffn": {"router": Leaf((D, c["num_experts"]), inp),
                        "w1": Leaf((E, D, Fe), inp),
                        "w2": Leaf((E, Fe, D), normal(out / math.sqrt(Fe))),
                        "w3": Leaf((E, D, Fe), inp),
                        "shared": {"w1": Leaf((D, Fs), inp),
                                   "w2": Leaf((Fs, D),
                                              normal(out / math.sqrt(Fs))),
                                   "w3": Leaf((D, Fs), inp)}}}

    return {"embed": {"embedding": Leaf((V, D), normal(0.02))},
            "final_norm": dict(scale),
            "layers": [block(m) for m, _ in _kinds(c)]}


def _norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def _swiglu(p: dict, x: torch.Tensor, pr: Precision) -> torch.Tensor:
    a = F.silu(pr.ein("td,df->tf", x, p["w1"])) * pr.ein("td,df->tf", x,
                                                          p["w3"])
    return pr.ein("tf,fd->td", a, p["w2"])


def _mamba2(p: dict, h: torch.Tensor, c: dict, pr: Precision):
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
    del seg
    cb = pr.ein("bin,bjn->bij", Cm, Bm)
    y = pr.ein("bijh,bjhp->bihp", cb[..., None] * decay * dt[:, None], x)
    y = (y + p["D"][:, None] * x).reshape(B, S, di) * F.silu(z)
    y = _norm(y, p["norm_scale"], c["ssm_norm_eps"])
    return pr.ein("bse,ed->bsd", y, p["out_proj"])


def _attention(p: dict, h: torch.Tensor, c: dict, pr: Precision):
    B, S, _ = h.shape
    H, K, hd = c["num_heads"], c["num_kv_heads"], c["head_dim"]
    q = pr.ein("bsd,de->bse", h, p["wq"]).reshape(B, S, H, hd)
    k = pr.ein("bsd,de->bse", h, p["wk"]).reshape(B, S, K, hd)
    v = pr.ein("bsd,de->bse", h, p["wv"]).reshape(B, S, K, hd)
    k = k.repeat_interleave(H // K, dim=2)
    v = v.repeat_interleave(H // K, dim=2)
    s = pr.ein("bshd,bthd->bhst", q, k) * c["attention_multiplier"]
    causal = torch.ones(S, S, dtype=torch.bool, device=h.device).tril()
    w = torch.softmax(s.masked_fill(~causal, -math.inf), dim=-1)
    o = pr.ein("bhst,bthd->bshd", w, v).reshape(B, S, H * hd)
    return pr.ein("bse,ed->bsd", o, p["wo"])


def _moe(p: dict, h: torch.Tensor, c: dict, pr: Precision) -> torch.Tensor:
    B, S, D = h.shape
    K = c["experts_per_token"]
    x = h.reshape(B * S, D)
    logits = pr.ein("td,de->te", x, p["router"])
    top, ids = torch.sort(logits, dim=-1, descending=True, stable=True)
    margin = top[:, K - 1] - top[:, K]
    ROUTING["decisions"] += margin.numel()
    ROUTING["near_ties"] += int((margin < NEAR_TIE).sum())
    gates = torch.softmax(top[:, :K], dim=-1)
    ids = ids[:, :K]
    out = torch.zeros_like(x)
    for e in range(_held(c)):
        tok, slot = torch.nonzero(ids == e, as_tuple=True)
        if tok.numel():
            w = {n: p[n][e] for n in ("w1", "w2", "w3")}
            out.index_add_(0, tok, gates[tok, slot, None] *
                           _swiglu(w, x[tok], pr))
    return (out + _swiglu(p["shared"], x, pr)).reshape(B, S, D)


def logits_last(params: dict, tokens: torch.Tensor, n: int, c: dict,
                pr: Precision) -> torch.Tensor:
    """Logits (B, n, V) at the last ``n`` positions of ``tokens``."""
    eps, r = c["rms_norm_eps"], c["residual_multiplier"]
    emb = params["embed"]["embedding"]
    x = emb[tokens] * c["embedding_multiplier"]
    for p, (mixer, _) in zip(params["layers"], _kinds(c)):
        h = _norm(x, p["norm1"]["scale"], eps)
        m = _mamba2 if mixer == "ssd" else _attention
        x = x + r * m(p["mixer"], h, c, pr)
        x = x + r * _moe(p["ffn"], _norm(x, p["norm2"]["scale"], eps), c, pr)
    x = _norm(x, params["final_norm"]["scale"], eps)[:, -n:]
    print(f"reference routing ({pr.name}): {ROUTING['near_ties']} of "
          f"{ROUTING['decisions']} decisions in this process within "
          f"{NEAR_TIE} of a tie", flush=True)
    return pr.ein("bsd,vd->bsv", x, emb) / c["logits_scaling"]

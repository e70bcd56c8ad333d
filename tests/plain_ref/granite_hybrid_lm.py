"""Plain PyTorch granite-4.0-h-small (hf:ibm-granite/granite-4.0-h-small,
``model_type: granitemoehybrid``), for the CPU tests: fp32, TF32 off, no
kernels, no cache, no batching of requests, dropless. It imports torch
only and reads the parameters in the port's layout (see ``forward``).

Each layer: x ← x + r·mixer(RMSNorm(x)), the mixer Mamba-2 or attention as
``block_pattern`` says; then x ← x + r·(MoE(RMSNorm(x)) + shared(RMSNorm(x))).
x₀ = embedding_multiplier·embed(tokens); logits = RMSNorm(x)·Eᵀ /
logits_scaling (tied). RMSNorm eps ``rms_norm_eps``.

- Mamba-2, in its quadratic "dual" form over the whole sequence,
  y_i = Σ_{j<=i} (C_i·B_j)·exp(Σ_{j<t<=i} dt_t·A)·dt_j·x_j + D·x_i
  (the cumulative sums of dt·A in fp64), one group of B and C, a causal
  depthwise conv with a bias, then y·silu(z) and an RMSNorm over the whole
  d_inner (eps ``ssm_norm_eps``).
- Attention: grouped-query, no positional encoding, softmax scale
  ``attention_multiplier``, causal.
- MoE: router logits h·W_r over all ``num_experts``; each token takes its
  ``experts_per_token`` largest (ties to the lower index); the gates are
  the softmax over the selected logits; every selected expert computes
  (dropless); SwiGLU experts; one shared SwiGLU expert on every token.

Departures from the published model: only the share. ``held`` (first,
count) names the experts whose weights the parameters hold (default 0 ..
``experts_held`` - 1, or all); the routing is over all experts, and the
experts held elsewhere add nothing, as on one device of an expert-parallel
group. ``ROUTING`` counts the routing decisions taken and those whose
margin (the last selected logit less the first one left out) is under
``NEAR_TIE``: where fp32 rounding could pick another expert.
"""
import math

import torch
import torch.nn.functional as F

NEAR_TIE = 1e-5
ROUTING = {"decisions": 0, "near_ties": 0}


def rms_norm(x, scale, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def swiglu(p, h):
    return (F.silu(h @ p["w1"]) * (h @ p["w3"])) @ p["w2"]


def mamba2(p, h, c):
    B, S, _ = h.shape
    di = c["ssm_expand"] * c["d_model"]
    P, N, W = c["ssm_head_dim"], c["ssm_state"], c["ssm_conv"]
    H = di // P
    z, xbc, dt = (h @ p["in_proj"]).split([di, di + 2 * N, H], dim=-1)
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
    cb = torch.einsum("bin,bjn->bij", Cm, Bm)
    y = torch.einsum("bijh,bjhp->bihp", cb[..., None] * decay * dt[:, None],
                     x)
    y = (y + p["D"][:, None] * x).reshape(B, S, di) * F.silu(z)
    y = rms_norm(y, p["norm_scale"], c["ssm_norm_eps"])
    return y @ p["out_proj"]


def attention(p, h, c):
    B, S, _ = h.shape
    H, K, hd = c["num_heads"], c["num_kv_heads"], c["head_dim"]
    q = (h @ p["wq"]).reshape(B, S, H, hd)
    k = (h @ p["wk"]).reshape(B, S, K, hd).repeat_interleave(H // K, dim=2)
    v = (h @ p["wv"]).reshape(B, S, K, hd).repeat_interleave(H // K, dim=2)
    s = torch.einsum("bshd,bthd->bhst", q, k) * c["attention_multiplier"]
    causal = torch.ones(S, S, dtype=torch.bool, device=h.device).tril()
    w = torch.softmax(s.masked_fill(~causal, -math.inf), dim=-1)
    return torch.einsum("bhst,bthd->bshd", w, v).reshape(B, S, H * hd) \
        @ p["wo"]


def held_range(c, held=None):
    return held if held is not None else (
        0, c.get("experts_held") or c["num_experts"])


def moe(p, h, c, held=None):
    """The held experts' part of the routed sum plus the shared expert."""
    B, S, D = h.shape
    K = c["experts_per_token"]
    x = h.reshape(B * S, D)
    logits = x @ p["router"]
    top, ids = torch.sort(logits, dim=-1, descending=True, stable=True)
    margin = top[:, K - 1] - top[:, K]
    ROUTING["decisions"] += margin.numel()
    ROUTING["near_ties"] += int((margin < NEAR_TIE).sum())
    gates = torch.softmax(top[:, :K], dim=-1)
    ids = ids[:, :K]
    first, count = held_range(c, held)
    out = torch.zeros_like(x)
    for e in range(first, first + count):
        tok, slot = torch.nonzero(ids == e, as_tuple=True)
        if tok.numel():
            w = {n: p[n][e - first] for n in ("w1", "w2", "w3")}
            out.index_add_(0, tok, gates[tok, slot, None] * swiglu(w, x[tok]))
    if "shared" in p:
        out = out + swiglu(p["shared"], x)
    return out.reshape(B, S, D)


def kinds(c):
    pattern = c["block_pattern"]
    return [tuple(pattern[i % len(pattern)]) for i in range(c["num_layers"])]


def forward(params, tokens, c, held=None):
    """Logits (B, S, V) of ``tokens`` (B, S), in fp32 with TF32 off. The
    parameters are the port's: ``embed/embedding``, ``final_norm/scale`` and
    per layer ``norm1``, ``mixer`` (``in_proj``, ``conv_w``, ``conv_b``,
    ``A_log``, ``D``, ``dt_bias``, ``norm_scale``, ``out_proj``; or ``wq``,
    ``wk``, ``wv``, ``wo``), ``norm2`` and ``ffn`` (``router``, ``w1``,
    ``w3`` (held, D, F), ``w2`` (held, F, D), ``shared``)."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        eps, r = c["rms_norm_eps"], c["residual_multiplier"]
        emb = params["embed"]["embedding"]
        x = emb[tokens] * c["embedding_multiplier"]
        for p, (mixer, _) in zip(params["layers"], kinds(c)):
            h = rms_norm(x, p["norm1"]["scale"], eps)
            m = mamba2 if mixer == "ssd" else attention
            x = x + r * m(p["mixer"], h, c)
            h = rms_norm(x, p["norm2"]["scale"], eps)
            x = x + r * moe(p["ffn"], h, c, held)
        x = rms_norm(x, params["final_norm"]["scale"], eps)
        return (x @ emb.T) / c["logits_scaling"]
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old

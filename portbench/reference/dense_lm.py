"""Plain PyTorch decoder language model, as OLMo describes it
(arXiv:2402.00838): pre-norm blocks of causal multi-head (or grouped-query)
attention with rotary positions, then a SwiGLU MLP; a final norm; tied or
separate embeddings. Every position's logits from the full sequence: no
kernels, no cache, no batching of requests.

The parameter tree is the benchmark's description of the weights: the
benchmark draws them from it (``Leaf``) and hands the same tensors to the
program and to this reference. N(0, 1) scaled by 1/√fan_in; the output
projections (``wo``, ``w2``) further by 1/√(2·layers); the embedding by
0.02.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from reference.common import Leaf, Precision, apply_norm, norm_tree, normal, \
    rope


def tree(c: dict) -> dict:
    D, L, V = c["d_model"], c["num_layers"], c["vocab_size"]
    H, K, hd, Fw = c["num_heads"], c["num_kv_heads"], c["head_dim"], c["d_ff"]
    inp, out = 1 / math.sqrt(D), 1 / math.sqrt(2 * L)
    ffn = {"w1": Leaf((D, Fw), normal(inp)),
           "w2": Leaf((Fw, D), normal(out / math.sqrt(Fw)))}
    if c.get("gated", True):
        ffn["w3"] = Leaf((D, Fw), normal(inp))

    def block():
        return {"norm1": norm_tree(c["norm"], D),
                "mixer": {"wq": Leaf((D, H * hd), normal(inp)),
                          "wk": Leaf((D, K * hd), normal(inp)),
                          "wv": Leaf((D, K * hd), normal(inp)),
                          "wo": Leaf((H * hd, D),
                                     normal(out / math.sqrt(H * hd)))},
                "norm2": norm_tree(c["norm"], D),
                "ffn": dict(ffn)}

    embed = {"embedding": Leaf((V, D), normal(0.02))}
    if not c.get("tie_embeddings", False):
        embed["lm_head"] = Leaf((D, V), normal(inp))
    return {"embed": embed, "final_norm": norm_tree(c["norm"], D),
            "layers": [block() for _ in range(L)]}


def _act(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "silu":
        return F.silu(x)
    if kind == "gelu":
        return F.gelu(x, approximate="tanh")
    if kind == "relu2":
        return F.relu(x) ** 2
    raise ValueError(kind)


def _block(p: dict, x: torch.Tensor, c: dict, pr: Precision) -> torch.Tensor:
    B, S, D = x.shape
    H, K, hd = c["num_heads"], c["num_kv_heads"], c["head_dim"]
    h = apply_norm(p["norm1"], x, c["norm"])
    m = p["mixer"]
    q = pr.ein("bsd,de->bse", h, m["wq"]).reshape(B, S, H, hd)
    k = pr.ein("bsd,de->bse", h, m["wk"]).reshape(B, S, K, hd)
    v = pr.ein("bsd,de->bse", h, m["wv"]).reshape(B, S, K, hd)
    q, k = rope(q, c["rope_theta"]), rope(k, c["rope_theta"])
    k = k.repeat_interleave(H // K, dim=2)
    v = v.repeat_interleave(H // K, dim=2)
    s = pr.ein("bshd,bthd->bhst", q, k) / math.sqrt(hd)
    causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    w = torch.softmax(s.masked_fill(~causal, -1e30), dim=-1)
    o = pr.ein("bhst,bthd->bshd", w, v).reshape(B, S, H * hd)
    x = x + pr.ein("bse,ed->bsd", o, m["wo"])
    h = apply_norm(p["norm2"], x, c["norm"])
    f = p["ffn"]
    a = _act(pr.ein("bsd,df->bsf", h, f["w1"]), c["activation"])
    if "w3" in f:
        a = a * pr.ein("bsd,df->bsf", h, f["w3"])
    return x + pr.ein("bsf,fd->bsd", a, f["w2"])


def _unembed(params: dict, x: torch.Tensor, c: dict,
             pr: Precision) -> torch.Tensor:
    emb = params["embed"]
    if "lm_head" in emb:
        return pr.ein("bsd,dv->bsv", x, emb["lm_head"])
    return pr.ein("bsd,vd->bsv", x, emb["embedding"])


def hidden(params: dict, tokens: torch.Tensor, c: dict, pr: Precision, *,
           remat: bool = False) -> torch.Tensor:
    """Final-norm hidden states (B, S, D) of ``tokens`` (B, S). ``remat``
    recomputes each block in the backward (memory only)."""
    x = params["embed"]["embedding"][tokens]
    for p in params["layers"]:
        if remat:
            x = checkpoint(_block, p, x, c, pr, use_reentrant=False)
        else:
            x = _block(p, x, c, pr)
    return apply_norm(params["final_norm"], x, c["norm"])


def logits_last(params: dict, tokens: torch.Tensor, n: int, c: dict,
                pr: Precision) -> torch.Tensor:
    """Logits (B, n, V) at the last ``n`` positions of ``tokens``."""
    return _unembed(params, hidden(params, tokens, c, pr)[:, -n:], c, pr)


def loss(params: dict, tokens: torch.Tensor, labels: torch.Tensor, c: dict,
         pr: Precision) -> torch.Tensor:
    """Mean cross-entropy of ``labels`` (B, S) over every position."""
    logits = _unembed(params, hidden(params, tokens, c, pr, remat=True), c,
                      pr)
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    return (torch.logsumexp(logits, dim=-1) - gold).mean()

"""Operations and bytes, from shapes alone: the yardstick of every roofline
and every share of a peak. Each input byte is read once and each output
byte written once, whatever a kernel reads again; masked (query, key) pairs
are not counted.

Model FLOPs count what the model needs, not what a program computes: two
per matmul parameter a token (the output head only where logits are
taken), the attention products over the visible pairs, and an SSD layer's
state work (its update and its read, 2·heads·head_dim·state multiply-adds a
token). A step that computes a product twice, as a program may, is not
counted twice.
"""
from __future__ import annotations

import numpy as np

from metrics import peaks

ESIZE = {"float32": 4, "bfloat16": 2}


def visible_pairs(S: int, T: int, causal: bool, window: int) -> int:
    """(query, key) pairs a mask keeps; the queries are the last S of T
    positions; ``window`` > 0 keeps keys t > p - window of query p."""
    p = np.arange(S, dtype=np.int64) + (T - S)
    hi = np.minimum(p, T - 1) if causal else np.full(S, T - 1)
    lo = np.maximum(p - window + 1, 0) if window > 0 else np.zeros(S, int)
    return int(np.maximum(hi - lo + 1, 0).sum())


def attention_fwd(B, S, H, hd, K, T, causal=True, window=0,
                  dtype="float32", lse=False):
    """(flops, bytes) of one attention forward: q·kᵀ and p·v over the
    visible pairs; q, k, v read and the output (and each row's fp32
    log-sum-exp, if written) written."""
    e = ESIZE[dtype]
    nbytes = e * (2 * B * S * H * hd + 2 * B * T * K * hd) \
        + (4 * B * H * S if lse else 0)
    return 4.0 * hd * B * H * visible_pairs(S, T, causal, window), nbytes


def attention_bwd(B, S, H, hd, K, causal=True, window=0, dtype="float32"):
    """(flops, bytes) of one attention backward: its five products (q·kᵀ
    again, dO·vᵀ, Pᵀ·dO, dS·k, dSᵀ·q) over the visible pairs; q, k, v, o,
    dO and the fp32 lse read, dq, dk, dv written."""
    e = ESIZE[dtype]
    nbytes = e * (4 * B * S * H * hd + 4 * B * S * K * hd) + 4 * B * H * S
    return 10.0 * hd * B * H * visible_pairs(S, S, causal, window), nbytes


def ssd_scan(b, s, h, p, g, n, chunk, dtype="float32"):
    """(flops, bytes) of one SSD scan from a zero state: per chunk of Lc
    positions C·Bᵀ over its Lc(Lc+1)/2 pairs once per (batch, group),
    scores·x over them per (batch, head), and per (batch, head) C·state
    (Lc·n·p) after the first chunk and the state's update (Lc·n·p) before
    the last; x, B, C, dt (fp32) and A read, y written."""
    e = ESIZE[dtype]
    nbytes = e * (2 * b * s * h * p + 2 * b * s * g * n) + 4 * (b * s * h + h)
    chunks = [min(chunk, s - c) for c in range(0, s, chunk)]
    macs = 0
    for i, lc in enumerate(chunks):
        pairs = lc * (lc + 1) // 2
        macs += b * g * pairs * n + b * h * pairs * p
        macs += b * h * lc * n * p * ((i > 0) + (i < len(chunks) - 1))
    return 2.0 * macs, nbytes


def bound_s(flops: float, nbytes: float, dtype: str = "float32") -> float:
    """The least time the card could take: the larger of the operations
    at the dtype's peak and the bytes at the HBM rate."""
    return max(flops / peaks.FLOPS[dtype], nbytes / peaks.HBM_BYTES_PER_S)


def roofline_pct(*groups) -> float | None:
    """Σ bound / Σ device time, in %, over groups of (calls, bound of a
    call's description): spans whose ``device_s`` the trace filled. None
    where it gave them no device time."""
    timed = [(c, b) for calls, b in groups for c in calls if c.device_s]
    if not timed:
        return None
    return 100.0 * sum(b(c.info) for c, b in timed) / \
        sum(c.device_s for c, _ in timed)


# -- the entries' calls, as the harness's spans describe them ----------------

def flash_call(info: dict) -> float:
    """Bound of a call ``flash_attention(q, k, v, *, causal=True, window=0,
    lse=None)``."""
    (B, S, H, hd), (_, T, K, _) = info["args"][0], info["args"][1]
    kw = info["kwargs"]
    return bound_s(*attention_fwd(
        B, S, H, hd, K, T, kw.get("causal", True), kw.get("window", 0),
        info["dtype"], kw.get("lse") is not None), info["dtype"])


def flash_bwd_call(info: dict) -> float:
    """Bound of a call ``flash_attention_bwd(q, k, v, o, lse, do, *,
    causal=True, window=0)``."""
    (B, S, H, hd), (_, _, K, _) = info["args"][0], info["args"][1]
    kw = info["kwargs"]
    return bound_s(*attention_bwd(B, S, H, hd, K, kw.get("causal", True),
                                  kw.get("window", 0), info["dtype"]),
                   info["dtype"])


def ssd_call(info: dict) -> float:
    """Bound of a call ``ssd_scan(x, dt, A, B, C, chunk)``; the scan's
    arithmetic is fp32 whatever x's type."""
    (b, s, h, p), (_, _, g, n) = info["args"][0], info["args"][3]
    return bound_s(*ssd_scan(b, s, h, p, g, n, info["args"][5],
                             info["dtype"]))


# -- model sizes --------------------------------------------------------------

def _ssd_sizes(c: dict):
    di = c["ssm_expand"] * c["d_model"]
    return di, di // c["ssm_head_dim"], c["ssm_head_dim"], c["ssm_state"]


def _kinds(c: dict) -> list:
    pattern = c["block_pattern"]
    return [tuple(pattern[i % len(pattern)]) for i in range(c["num_layers"])]


def param_count(c: dict) -> int:
    """Parameters of a configuration of attention + MLP and SSD blocks, as
    the port's planner counts them (2·layers + 1 norms unless they have no
    parameters; an SSD block's conv bias and gated-norm scale left out)."""
    D, V = c["d_model"], c["vocab_size"]
    n = V * D * (1 if c.get("tie_embeddings") else 2)
    for mixer, ffn in _kinds(c):
        n += _mixer_matmul(c, mixer)
        if mixer == "ssd":
            di, H, _, N = _ssd_sizes(c)
            n += c["ssm_conv"] * (di + 2 * N) + 3 * H
        n += _ffn_matmul(c, ffn)
    if c["norm"] != "nonparam_ln":
        n += (2 * c["num_layers"] + 1) * D
    return n


def flops_per_token_closed(c: dict) -> float:
    """The planner's closed form of FLOPs a token: 2·parameters."""
    return 2.0 * param_count(c)


def _mixer_matmul(c: dict, mixer: str) -> int:
    D = c["d_model"]
    if mixer in ("attn", "attn_window"):
        H, K, hd = c["num_heads"], c["num_kv_heads"], c["head_dim"]
        return 2 * D * H * hd + 2 * D * K * hd
    if mixer == "ssd":
        di, H, _, N = _ssd_sizes(c)
        return D * (2 * di + 2 * N + H) + di * D
    raise ValueError(f"mixer {mixer!r}")


def _ffn_matmul(c: dict, ffn) -> int:
    if ffn is None:
        return 0
    if ffn == "mlp":
        return (3 if c.get("gated", True) else 2) * c["d_model"] * c["d_ff"]
    raise ValueError(f"ffn {ffn!r}")


def matmul_params(c: dict) -> int:
    """Matmul parameters a token passes through, the output head apart."""
    return sum(_mixer_matmul(c, m) + _ffn_matmul(c, f) for m, f in _kinds(c))


def _mixing_flops(c: dict, queries: int, pairs: int) -> float:
    """Attention products over ``pairs`` visible (query, key) pairs, or an
    SSD's state work for ``queries`` tokens, summed over the layers."""
    total = 0.0
    for mixer, _ in _kinds(c):
        if mixer in ("attn", "attn_window"):
            total += 4.0 * c["num_heads"] * c["head_dim"] * pairs
        elif mixer == "ssd":
            di, H, P, N = _ssd_sizes(c)
            total += 4.0 * H * P * N * queries
    return total


def model_flops_frame(c: dict, prompt: int, new: int) -> float:
    """A served frame: the prefill of ``prompt`` tokens (logits at its last
    position) and ``new`` - 1 decode steps, step j attending prompt + j
    positions."""
    head = 2.0 * c["d_model"] * c["vocab_size"]
    flops = 2.0 * matmul_params(c) * prompt + head + _mixing_flops(
        c, prompt, prompt * (prompt + 1) // 2)
    for j in range(1, new):
        flops += 2.0 * matmul_params(c) + head + _mixing_flops(c, 1,
                                                               prompt + j)
    return flops


def model_flops_train_step(c: dict, batch: int, seq: int) -> float:
    """A training step on ``batch`` causal rows of ``seq`` tokens, logits
    at every position: three times the forward (forward, and the backward's
    two products per forward product)."""
    fwd = 2.0 * (matmul_params(c) + c["d_model"] * c["vocab_size"]) \
        * batch * seq + _mixing_flops(c, batch * seq,
                                      batch * seq * (seq + 1) // 2)
    return 3.0 * fwd

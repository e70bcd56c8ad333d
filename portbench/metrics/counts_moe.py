"""Operations and bytes of a dropless MoE layer that holds a share of its
experts, from its shapes alone, and model FLOPs of a served frame of a
model whose every block ends in one (``counts.py`` counts no MoE).

A call over T tokens of width D, routing over E experts (top K), holding
``held`` of them (each SwiGLU of width F), with a shared SwiGLU expert of
width Fs:

- operations: the router 2·T·D·E, the held experts' entries 6·D·F·T·K·
  held/E (the entries expected under uniform routing), the shared expert
  6·D·Fs·T;
- bytes, fp32, each read or written once: the router's and the shared
  expert's weights, the weights (3·D·F each) of the held experts that
  T tokens are expected to touch, held·(1 - (1 - K/E)^T), and the layer's
  input and output, 2·T·D.
"""
from __future__ import annotations

from metrics import counts

ESIZE = 4                                  # fp32


def _sizes(c: dict):
    return (c["d_model"], c["num_experts"], c["experts_per_token"],
            c.get("experts_held") or c["num_experts"], c["moe_d_ff"],
            c.get("moe_shared_d_ff", 0))


def moe_flops(c: dict, tokens: int) -> float:
    D, E, K, held, Fe, Fs = _sizes(c)
    return 2.0 * tokens * D * E + 6.0 * D * Fe * tokens * K * held / E \
        + 6.0 * D * Fs * tokens


def moe_bytes(c: dict, tokens: int) -> float:
    D, E, K, held, Fe, Fs = _sizes(c)
    touched = held * (1.0 - (1.0 - K / E) ** tokens)
    return ESIZE * (D * E + 3.0 * D * Fs + touched * 3.0 * D * Fe
                    + 2.0 * tokens * D)


def moe_call(info: dict, c: dict) -> float:
    """Bound of a call ``apply_moe_dropless(params, x, cfg, ...)``, x (B,
    S, D): the larger of its operations at the fp32 peak and its bytes at
    the HBM rate."""
    B, S, _ = info["args"][1]
    return counts.bound_s(moe_flops(c, B * S), moe_bytes(c, B * S))


def _layer_flops(c: dict, queries: int, pairs: int) -> float:
    """Every block over ``queries`` new tokens: the mixers' matmuls, the
    attention products over ``pairs`` visible pairs or the SSD state work,
    and the MoE FFN."""
    kinds = counts._kinds(c)
    mixers = sum(counts._mixer_matmul(c, m) for m, _ in kinds)
    moe = sum(f == "moe" for _, f in kinds)
    return 2.0 * mixers * queries + counts._mixing_flops(c, queries, pairs) \
        + moe * moe_flops(c, queries)


def model_flops_frame(c: dict, prompt: int, new: int) -> float:
    """A served frame: the prefill of ``prompt`` tokens (logits at its last
    position) and ``new`` - 1 decode steps, step j attending prompt + j
    positions; the output head at each answered position."""
    head = 2.0 * c["d_model"] * c["vocab_size"]
    flops = _layer_flops(c, prompt, prompt * (prompt + 1) // 2) + head
    for j in range(1, new):
        flops += _layer_flops(c, 1, prompt + j) + head
    return flops

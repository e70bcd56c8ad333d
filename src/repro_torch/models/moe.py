"""Token-choice top-k Mixture-of-Experts with capacity dispatch, the port of
``repro.models.moe.apply_moe``. The reference's sharding variants
(``apply_moe_local``, ``apply_moe_shard_map`` and the expert shard
constraint) wait for the port's distributed layer.

Parameters per MoE layer: ``router`` (D, E), ``w1``/``w3`` (E, D, F) and
``w2`` (E, F, D). Each token picks its K most probable experts (softmax
over the fp32 router logits; the K weights renormalised to sum to 1). Each
expert takes at most C tokens, C = ceil(T·K/E·capacity_factor) rounded up
to a multiple of 4 and at least 4, filled in row-major (token, k) order;
the entries past C are dropped. Every expert then runs over all its C
slots, filled or not, as in the reference. The auxiliary load-balance loss
is Switch/GShard's E·Σ_e f_e·P_e / K, before any drop, in fp32.

Three points keep the port equal to the reference, and deterministic on
the card:

* ties in top-k go to the lower expert index, as ``jax.lax.top_k`` breaks
  them (``torch.topk`` does not): a stable descending sort, first K;
* the dispatch writes each in-capacity slot once, so it is a plain
  indexed copy (the dropped entries all land in one extra slot that is
  thrown away);
* the combine sums each token's K entries as a (T, K, D) sum over K,
  where the reference scatter-adds them into the token: the same sum with
  no atomics, so its order does not change from run to run.

The expert products are batched matrix products (``torch.bmm``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import _act


def capacity(tokens: int, cfg: ArchConfig) -> int:
    """Slots per expert for ``tokens`` routed tokens: ceil(T·K/E·cf),
    rounded up to a multiple of 4, at least 4 (the reference's formula,
    float expression included)."""
    C = int(math.ceil(tokens * cfg.experts_per_token / cfg.num_experts
                      * cfg.capacity_factor))
    return max(4, -(-C // 4) * 4)


def _route(router: torch.Tensor, x: torch.Tensor, cfg: ArchConfig):
    """x: (T, D) -> (probs (T, E) fp32, top weights (T, K) fp32
    renormalised, top ids (T, K)), ties toward the lower expert."""
    probs = torch.softmax((x @ router).float(), dim=-1)
    top_w, top_ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    K = cfg.experts_per_token
    top_w, top_ids = top_w[:, :K], top_ids[:, :K]
    return probs, top_w / top_w.sum(dim=-1, keepdim=True), top_ids


def _aux_loss(probs: torch.Tensor, top_ids: torch.Tensor,
              cfg: ArchConfig) -> torch.Tensor:
    """E · Σ_e f_e · P_e / K over the tokens: f_e the share of routing
    entries per token that chose e, P_e the mean probability."""
    E, K = cfg.num_experts, cfg.experts_per_token
    f_e = F.one_hot(top_ids, E).float().sum(dim=1).mean(dim=0)
    p_e = probs.mean(dim=0)
    return E * torch.sum(f_e * p_e) / K


def _slots(top_ids: torch.Tensor, C: int, cfg: ArchConfig):
    """Each (token, k) entry's slot: ``dest`` (T·K,), expert · C + its
    position among the entries routed to that expert before it in
    row-major (token, k) order, or E·C (the dropped slot) past C; and
    ``within`` (T·K,), the entries kept."""
    E = cfg.num_experts
    ids = top_ids.reshape(-1)
    onehot = F.one_hot(ids, E)                            # (T·K, E)
    before = onehot.cumsum(dim=0) - onehot                # entries before me
    pos = before.gather(1, ids[:, None])[:, 0]
    within = pos < C
    return torch.where(within, ids * C + pos, E * C), within


def _experts(params, expert_in: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """expert_in: (E, C, D) -> (E, C, D): each expert's FFN over its C
    slots, by batched matrix products."""
    h = _act(torch.bmm(expert_in, params["w1"]), cfg.activation)
    if cfg.gated:
        h = h * torch.bmm(expert_in, params["w3"])
    return torch.bmm(h, params["w2"])


def _dispatch(x: torch.Tensor, dest: torch.Tensor, C: int,
              cfg: ArchConfig) -> torch.Tensor:
    """x: (T, D) -> the experts' inputs (E, C, D): row c of expert e holds
    the token routed to slot e·C + c (zero if none)."""
    D = x.shape[1]
    E, K = cfg.num_experts, cfg.experts_per_token
    buf = x.new_zeros((E * C + 1, D))
    # in-capacity slots are written once each; the dropped entries all
    # land in the last slot, which is cut away below
    buf.index_copy_(0, dest, x.repeat_interleave(K, dim=0))
    return buf[: E * C].view(E, C, D)


def _combine(out: torch.Tensor, dest: torch.Tensor, within: torch.Tensor,
             top_w: torch.Tensor) -> torch.Tensor:
    """The experts' outputs (E, C, D) back to the tokens (T, D): each
    token's K slots, weighted by its routing weights (0 where dropped),
    summed over K."""
    T, K = top_w.shape
    D = out.shape[-1]
    slots = torch.cat([out.reshape(-1, D), out.new_zeros((1, D))])
    weight = (top_w.reshape(-1) * within).to(out.dtype)
    return (slots[dest] * weight[:, None]).view(T, K, D).sum(dim=1)


def apply_moe(params, x: torch.Tensor, cfg: ArchConfig):
    """x: (B, S, D) -> (out (B, S, D), aux fp32 scalar). Capacity and slot
    positions are counted over all T = B·S tokens of the batch, so a
    token's output depends on what else is in the batch, as in the
    reference."""
    B, S, D = x.shape
    xf = x.reshape(B * S, D)
    probs, top_w, top_ids = _route(params["router"], xf, cfg)
    aux = _aux_loss(probs, top_ids, cfg)
    C = capacity(B * S, cfg)
    dest, within = _slots(top_ids, C, cfg)
    out = _experts(params, _dispatch(xf, dest, C, cfg), cfg)
    return _combine(out, dest, within, top_w).view(B, S, D), aux

"""Token-choice top-k Mixture-of-Experts, in two forms.

Parameters per MoE layer: ``router`` (D, E), ``w1``/``w3`` (E_held, D, F)
and ``w2`` (E_held, F, D), and with ``cfg.moe_shared_d_ff`` a ``shared``
SwiGLU expert {w1, w3 (D, Fs), w2 (Fs, D)}. Each token picks its K most
probable experts (softmax over the fp32 router logits; the K weights
renormalised to sum to 1, which equals a softmax over the K selected
logits). Ties in top-k go to the lower expert index, as ``jax.lax.top_k``
breaks them (``torch.topk`` does not): a stable descending sort, first K.
The auxiliary load-balance loss is Switch/GShard's E·Σ_e f_e·P_e / K over
all E experts, in fp32.

**Dropless, one device's share** (``apply_moe_dropless``; a config with
``capacity_factor`` 0): every entry routed to an expert computes. The layer
holds experts first .. first + n - 1 of the E it routes over (``experts``,
or experts 0 .. ``cfg.held_experts`` - 1), as one device of an
expert-parallel group does, and returns the part of the output its experts
give, plus the shared expert's. The entries that fall on held experts are
sorted by expert on the device (a stable sort of each entry's held index,
the others keyed past the last), each expert's end row is found by a
binary search of the sorted keys, and the expert products run over exactly
those rows (``kernels.ops.moe_experts``: the grouped CUDA kernels on the
card). Nothing is read back on the host, so a decode step is not stalled
once a layer; a token's output depends on no other token of the batch.
The combine takes each token's K rows in k order (a zero row for an entry
held elsewhere), weighted, summed over K: no atomics.

**With a capacity** (every other MoE config: the port of
``repro.models.moe``): global dispatch (``apply_moe``), per-sequence
dispatch (``apply_moe_local``) and explicit expert parallelism over a mesh
(``apply_moe_shard_map``). Each expert takes at most C tokens, C =
ceil(T·K/E·capacity_factor) rounded up to a multiple of 4 and at least 4,
filled in row-major (token, k) order; the entries past C are dropped. Every
expert then runs over all its C slots, filled or not, as in the reference.
The aux loss is taken before any drop. Two more points keep the port equal
to the reference, and deterministic on the card:

* the dispatch writes each in-capacity slot once, so it is a plain
  indexed copy (the dropped entries all land in one extra slot that is
  thrown away);
* the combine sums each token's K entries as a (T, K, D) sum over K,
  where the reference scatter-adds them into the token: the same sum with
  no atomics, so its order does not change from run to run.

The expert products are batched matrix products (``torch.bmm``).

On a mesh (DTensor inputs) every capacity form runs expert-parallel by
hand, as the reference's ``shard_map`` body does (``_moe_on_mesh``): the
expert weights are sharded over "model" on the expert dim (replicated when
the experts do not divide it), each rank routes its tokens, dispatches only
to its own experts and combines its partial output, and one all-reduce
over "model" sums the parts. What differs is which tokens a rank routes
and over which tokens capacity counts: global dispatch gathers the
tokens over the data axes (its capacity counts the whole batch, so the
routing cannot stay local) and splits each expert's slots among the data
ranks; per-sequence dispatch and ``shard_map`` keep each data shard's
tokens. The routing, dispatch and combine run on plain local tensors,
index ops for which DTensor has no sharding rule in every torch release.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref
from repro_torch.kernels.moe_experts import small_tiles
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import _act, apply_mlp, shard_index


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
    probs = torch.softmax(kops.matmul(x, router).float(), dim=-1)
    top_w, top_ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    K = cfg.experts_per_token
    top_w, top_ids = top_w[:, :K], top_ids[:, :K]
    return probs, top_w / top_w.sum(dim=-1, keepdim=True), top_ids


def _expert_stats(probs: torch.Tensor, top_ids: torch.Tensor,
                  cfg: ArchConfig):
    """(f_e, P_e), each (E,) fp32: the share of routing entries per token
    that chose e, and e's mean probability, over the tokens."""
    f_e = F.one_hot(top_ids, cfg.num_experts).float().sum(dim=1).mean(dim=0)
    return f_e, probs.mean(dim=0)


def _aux(f_e: torch.Tensor, p_e: torch.Tensor, cfg: ArchConfig):
    """The load-balance loss E · Σ_e f_e · P_e / K."""
    return cfg.num_experts * torch.sum(f_e * p_e) / cfg.experts_per_token


def _slots(top_ids: torch.Tensor, C: int, cfg: ArchConfig, experts=None,
           rows: bool = False, part=None):
    """Each (token, k) entry's slot: ``dest`` (T·K,), expert · C + its
    position among the entries routed to that expert before it in
    row-major (token, k) order, or E·C (the dropped slot) past C; and
    ``within`` (T·K,), the entries kept. ``rows``: ``top_ids`` is (B,
    S·K), positions are counted within each sequence and both results are
    (B, S·K). With ``experts`` (first, count), slots are numbered among
    those experts only, and an entry routed elsewhere goes to the dropped
    slot and is not kept. With ``part`` (r, n), each expert's C slots are
    cut into n runs of ``local_capacity(C, part)`` and only run r's are
    kept, numbered from 0 within it."""
    E = cfg.num_experts
    ids = top_ids if rows else top_ids.reshape(-1)
    onehot = F.one_hot(ids, E)                            # (..., E)
    before = onehot.cumsum(dim=-2) - onehot               # entries before me
    pos = before.gather(-1, ids[..., None])[..., 0]
    within = pos < C
    n_e = E
    if experts is not None:
        first, n_e = experts
        ids = ids - first
        within = within & (ids >= 0) & (ids < n_e)
    Cl = local_capacity(C, part)
    if part is not None:
        within = within & (pos // Cl == part[0])
        pos = pos - part[0] * Cl
    return torch.where(within, ids * Cl + pos, n_e * Cl), within


def local_capacity(C: int, part=None) -> int:
    """Slots per expert in run r of n (``part``): ceil(C / n); C without."""
    return C if part is None else -(-C // part[1])


def _experts(params, expert_in: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """expert_in: (E, C, D) -> (E, C, D): each expert's FFN over its C
    slots, by batched matrix products."""
    h = _act(torch.bmm(expert_in, params["w1"]), cfg.activation)
    if cfg.gated:
        h = h * torch.bmm(expert_in, params["w3"])
    return torch.bmm(h, params["w2"])


def _dispatch(x: torch.Tensor, dest: torch.Tensor, C: int,
              cfg: ArchConfig, experts=None) -> torch.Tensor:
    """x: (T, D) -> the experts' inputs (E, C, D): row c of expert e holds
    the token routed to slot e·C + c (zero if none). With ``experts``
    (first, count), those experts' inputs (count, C, D)."""
    D = x.shape[1]
    E, K = cfg.num_experts, cfg.experts_per_token
    if experts is not None:
        E = experts[1]
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


def _global(params, x: torch.Tensor, cfg: ArchConfig, experts=None,
            part=None):
    """Global dispatch on plain tensors over all B·S tokens. ``experts``
    (first, count) keeps only the entries routed to experts first ..
    first + count - 1, whose weights ``params`` holds, and ``part`` (r, n)
    only those in run r of n of each expert's slots (a rank's share on a
    mesh): the others are dropped, so the output is that share's part."""
    B, S, D = x.shape
    xf = x.reshape(B * S, D)
    probs, top_w, top_ids = _route(params["router"], xf, cfg)
    stats = _expert_stats(probs, top_ids, cfg)
    C = capacity(B * S, cfg)
    dest, within = _slots(top_ids, C, cfg, experts, part=part)
    out = _experts(params, _dispatch(xf, dest, local_capacity(C, part), cfg,
                                     experts), cfg)
    return _combine(out, dest, within, top_w).view(B, S, D), stats


def _local(params, x: torch.Tensor, cfg: ArchConfig, experts=None,
           part=None):
    """Per-sequence dispatch on plain tensors: capacity C = capacity(S)
    per sequence and slot positions counted within each sequence, so
    every op keeps the batch dim. ``experts`` as in ``_global``."""
    B, S, D = x.shape
    E, K = cfg.num_experts, cfg.experts_per_token
    probs, top_w, top_ids = _route(params["router"], x.reshape(B * S, D),
                                    cfg)
    stats = _expert_stats(probs, top_ids, cfg)
    C = capacity(S, cfg)
    dest, within = _slots(top_ids.reshape(B, S * K), C, cfg, experts,
                          rows=True)
    n_e = E if experts is None else experts[1]
    slots = n_e * C + 1                    # each sequence's dropped slot last
    flat = (dest + torch.arange(B, device=x.device)[:, None] * slots)
    buf = x.new_zeros((B * slots, D))
    buf.index_copy_(0, flat.reshape(-1),
                    x.reshape(B * S, D).repeat_interleave(K, dim=0))
    expert_in = buf.view(B, slots, D)[:, :-1].reshape(B, n_e, C, D)
    out = _experts(params, expert_in.transpose(0, 1).reshape(n_e, B * C, D),
                   cfg).view(n_e, B, C, D).transpose(0, 1)
    out = torch.cat([out.reshape(B, n_e * C, D), out.new_zeros((B, 1, D))],
                    dim=1).reshape(B * slots, D)
    weight = (top_w.reshape(-1) * within.reshape(-1)).to(out.dtype)
    combined = (out[flat.reshape(-1)] * weight[:, None]).view(B * S, K, D)
    return combined.sum(dim=1).view(B, S, D), stats


def apply_moe_local(params, x: torch.Tensor, cfg: ArchConfig):
    """Per-sequence dispatch: x (B, S, D) -> (out, aux). Slot positions
    are computed per sequence and capacity is per sequence, C =
    capacity(S), so on a mesh the routing stays local to each data shard
    and the only traffic is the sum over "model" of the experts' parts.
    The aux loss is the global form's (over all B·S tokens)."""
    if isinstance(x, DTensor):
        return _moe_on_mesh(_local, params, x, cfg, gather_tokens=False)
    out, stats = _local(params, x, cfg)
    return out, _aux(*stats, cfg)


def apply_moe(params, x: torch.Tensor, cfg: ArchConfig,
              local_dispatch: bool = False,
              expert_shard_constraint: bool = False):
    """x: (B, S, D) -> (out (B, S, D), aux fp32 scalar). Capacity and slot
    positions are counted over all T = B·S tokens of the batch, so a
    token's output depends on what else is in the batch, as in the
    reference. ``local_dispatch`` runs ``apply_moe_local`` instead.

    ``expert_shard_constraint`` is the reference's pin of the dispatch
    buffers to the expert-sharded layout, so that each rank builds only its
    own experts' slots and the combine is one sum of (T, D). On a mesh the
    port always dispatches that way (there is no compiler to choose
    another layout), so the option adds only the reference's requirement:
    the experts must divide the model axis. On plain tensors it changes
    nothing."""
    if local_dispatch:
        return apply_moe_local(params, x, cfg)
    if isinstance(x, DTensor):
        return _moe_on_mesh(_global, params, x, cfg, gather_tokens=True,
                            require_expert_split=expert_shard_constraint)
    out, stats = _global(params, x, cfg)
    return out, _aux(*stats, cfg)


def _sort_held(top_ids: torch.Tensor, first: int, n: int):
    """The entries (T·K of ``top_ids``, row-major (token, k)) that fall on
    experts first .. first + n - 1, sorted by expert, stably: (rows (T·K,),
    each sorted row's token; ends (n,), each held expert's end row; pos
    (T·K,), each entry's sorted row, or T·K for an entry held elsewhere).
    Rows from ends[-1] on are entries held elsewhere."""
    T, K = top_ids.shape
    ids = top_ids.reshape(-1) - first
    held = (ids >= 0) & (ids < n)
    keys, order = torch.sort(torch.where(held, ids, n), stable=True)
    ends = torch.searchsorted(keys, torch.arange(
        1, n + 1, device=keys.device, dtype=keys.dtype))
    pos = torch.empty_like(order).index_copy_(
        0, order, torch.arange(T * K, device=order.device))
    return order // K, ends, torch.where(held, pos, T * K)


def apply_moe_dropless(params, x: torch.Tensor, cfg: ArchConfig,
                       experts=None, want_aux: bool = True,
                       use_kernel: bool = True):
    """Dropless MoE over the experts this device holds: x (B, S, D) ->
    (out (B, S, D), aux fp32 scalar, or None without ``want_aux``).
    ``experts`` (first, count) are the held experts, whose weights
    ``params`` holds (default: 0 .. ``cfg.held_experts`` - 1); the routing
    is over all ``cfg.num_experts``. ``out`` is the held experts' part of
    the routed sum plus the shared expert, if any. ``use_kernel`` sends the
    expert products through ``kernels.ops`` (the CUDA kernels for CUDA
    tensors), else through their plain version. The experts are SwiGLU."""
    if isinstance(x, DTensor):
        raise NotImplementedError("apply_moe_dropless: plain tensors only")
    if not (cfg.gated and cfg.activation == "silu"):
        raise ValueError("apply_moe_dropless: SwiGLU experts only")
    B, S, D = x.shape
    T, K = B * S, cfg.experts_per_token
    xf = x.reshape(T, D)
    probs, top_w, top_ids = _route(params["router"], xf, cfg)
    first, n = experts if experts is not None else (0, cfg.held_experts)
    rows, ends, pos = _sort_held(top_ids, first, n)
    weights = (params["w1"], params["w3"], params["w2"])
    if use_kernel:
        y = kops.moe_experts(xf, rows, ends, *weights,
                             small=small_tiles(T * K, cfg.num_experts))
    else:
        y = ref.moe_experts_ref(xf, rows, ends, *weights)
    out = (y[pos] * top_w.reshape(-1, 1).to(y.dtype)).view(T, K, D).sum(1)
    if cfg.moe_shared_d_ff:
        out = out + apply_mlp(params["shared"], xf, cfg)
    aux = _aux(*_expert_stats(probs, top_ids, cfg), cfg) if want_aux \
        else None
    return out.view(B, S, D), aux


def apply_moe_shard_map(params, x: torch.Tensor, cfg: ArchConfig, mesh,
                        dp_axes: tuple = ("data",)):
    """Expert-parallel MoE over ``mesh``, the reference's ``shard_map``
    form: tokens sharded over ``dp_axes`` and replicated over "model",
    expert weights sharded over "model" on the expert dim. Each rank routes
    its local tokens (capacity over them), dispatches only to the experts
    it owns, runs them, and the weighted parts are summed with one
    all-reduce over "model"; the aux loss is averaged over ``dp_axes``.
    Requires the experts to divide the model axis. Plain tensors are taken
    as the global values, replicated on every rank, and the output is then
    a plain tensor too."""
    plain = not isinstance(x, DTensor)
    if plain:
        rep = lambda t: DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                           run_check=False)
        params = {k: rep(v) for k, v in params.items()}
        x = rep(x)
    if tuple(dp_axes) != tuple(a for a in mesh.mesh_dim_names
                               if a in ("pod", "data")):
        raise ValueError(f"dp_axes {dp_axes}: the port shards tokens over "
                         f"the mesh's data axes")
    out, aux = _moe_on_mesh(_global, params, x, cfg, gather_tokens=False,
                            require_expert_split=True, mean_of_aux=True)
    if plain:
        return out.full_tensor(), aux.full_tensor()
    return out, aux


def _moe_on_mesh(body, params, x: DTensor, cfg: ArchConfig, *,
                 gather_tokens: bool, require_expert_split: bool = False,
                 mean_of_aux: bool = False):
    """``body`` (``_global`` or ``_local``) expert-parallel on x's mesh.
    Experts: sharded over "model" on the expert dim, or replicated there
    when they do not divide it; replicated over the data axes (an FSDP
    shard is gathered). Tokens: replicated over "model"; over the data
    axes each rank keeps its shard, or with ``gather_tokens`` every rank
    routes all of them and takes run r of n of each expert's slots (r its
    place among the n data ranks), so that the experts' work is split over
    the data ranks as well. Each rank's output is its experts' (and slots')
    part, summed over "model" (and the data axes, where the tokens were
    gathered) by one reduction. The aux loss is the global form's, from
    f_e and P_e averaged over the data shards (equal shards, so their
    means are the batch's); with ``mean_of_aux`` (``shard_map``'s ``pmean``)
    it is each shard's aux, averaged. A rank contributes its share divided
    by the ranks that hold the same tokens, so the sum over the mesh is the
    mean and the gradient reaches the router once. Returns (out with x's
    placements, aux replicated)."""
    mesh = x.device_mesh
    names = mesh.mesh_dim_names
    E, B = cfg.num_experts, x.shape[0]
    m = mesh.size(names.index("model")) if "model" in names else 1
    split = E % m == 0
    if require_expert_split and not split:
        raise ValueError(f"{E} experts do not divide the model axis of {m}")
    dp = [d for d, a in enumerate(names) if a in ("pod", "data")]
    n_dp = math.prod(mesh.size(d) for d in dp)
    if not gather_tokens and B % n_dp:
        raise ValueError(f"batch {B} does not divide the data axes' {n_dp} "
                         f"shards")
    on_model = [a == "model" and split for a in names]
    tok = [Shard(0) if d in dp and not gather_tokens else Replicate()
           for d in range(mesh.ndim)]
    # each rank's result is a part wherever ranks split the work: over
    # "model" (experts), and over the data axes when the tokens are
    # gathered (slots); the gradients of what they share are parts too
    summed = [on_model[d] or (d in dp and gather_tokens)
              for d in range(mesh.ndim)]
    x_loc = x.redistribute(mesh, tok).to_local(grad_placements=[
        Partial() if summed[d] else p for d, p in enumerate(tok)])
    w_pl = [Shard(0) if on_model[d] else Replicate()
            for d in range(mesh.ndim)]
    w_grad = [Partial() if d in dp else p for d, p in enumerate(w_pl)]
    r_grad = [Partial() if on_model[d] or d in dp else Replicate()
              for d in range(mesh.ndim)]
    local = {}
    for k, w in params.items():
        pl, gp = ((w_pl, w_grad) if k != "router" else
                  ([Replicate()] * mesh.ndim, r_grad))
        local[k] = w.redistribute(mesh, pl).to_local(grad_placements=gp)
    experts = part = None
    if split and m > 1:
        r = mesh.get_local_rank(names.index("model"))
        experts = (r * (E // m), E // m)
    if gather_tokens and n_dp > 1:
        part = (shard_index(mesh, [Shard(0) if d in dp else Replicate()
                                   for d in range(mesh.ndim)], 0), n_dp)
    out, stats = body(local, x_loc, cfg, experts, part)
    out = DTensor.from_local(out, mesh, [
        Partial() if summed[d] else p for d, p in enumerate(tok)],
        run_check=False)
    share = (m if split else 1) * n_dp
    mean = lambda t: DTensor.from_local(t / share, mesh, [
        Partial() if on_model[d] or d in dp else Replicate()
        for d in range(mesh.ndim)], run_check=False).redistribute(
        mesh, [Replicate()] * mesh.ndim)
    aux = mean(_aux(*stats, cfg)) if mean_of_aux else \
        _aux(*(mean(t) for t in stats), cfg)
    return out.redistribute(mesh, x.placements), aux

"""The paper's allocation machinery over H100 instance types: the port's
counterpart of ``repro.core.tpu_catalog``.

The boxes are LLM serving streams — an architecture decoding at a measured
tokens/s — and the trucks are instances with 1, 2, 4 or 8 H100 GPUs. The
dimensions are (TFLOP/s, HBM GiB). Per GPU: 989 TFLOP/s dense bf16 and
80 GB of HBM3, from NVIDIA's H100 SXM datasheet
(https://www.nvidia.com/en-us/data-center/h100/). The capacity is the
datasheet peak with no assumed sustained fraction (the TPU catalog's
``MFU = 0.4`` is not carried over); the planner's 90% head-room cap
(``UTILIZATION_CAP``) applies on top, as for every catalog. Prices are
placeholders with a regional spread, not quotes.

The HBM requirement is bf16 weights plus a bf16 KV cache of ``kv_seq``
tokens resident per stream. The compute requirement is the decode step's
per-token FLOPs from the port's dry run (``launch/dryrun.py``: the
``decode_32k`` record on ``pod1``, per-device FLOPs × 256 devices / 128
sequences) when a ``dryrun_dir`` holds one, as the reference reads its
compiled step's; else the closed form, 2 FLOPs per active parameter. The
closed form leaves out attention over the resident cache, which at 32k
tokens is most of a dense model's decode work.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional, Sequence

import numpy as np

from repro_torch.core.catalog import UTILIZATION_CAP, Catalog, InstanceType
from repro_torch.core.packing import (Bin, Choice, Infeasible, Item, Problem,
                                      Solution, fits, validate)
from repro_torch.core.solver import solve
from repro_torch.models.config import ArchConfig, get_config

PEAK_TFLOPS_BF16 = 989.0           # per H100 SXM, dense (datasheet)
HBM_GIB = 80e9 / 2**30             # 80 GB per H100 SXM (datasheet), in GiB
GPU_COUNTS = (1, 2, 4, 8)
PLACEHOLDER_PRICE_PER_GPU = 3.00   # $/GPU-hour: a placeholder, not a quote


def h100_catalog() -> Catalog:
    """H100 instances of 1, 2, 4 and 8 GPUs in three regions at
    placeholder prices (a per-GPU base with regional multipliers)."""
    def prices(base: float) -> dict[str, float]:
        return {"us-east": round(base, 3),
                "europe-west": round(base * 1.12, 3),
                "asia-east": round(base * 1.23, 3)}

    return Catalog(types=tuple(
        InstanceType(name=f"h100-{n}",
                     capacity=(n * PEAK_TFLOPS_BF16, n * HBM_GIB),
                     prices=prices(PLACEHOLDER_PRICE_PER_GPU * n),
                     has_gpu=True,
                     dimensions=("tflops", "hbm_gib"))
        for n in GPU_COUNTS))


@dataclasses.dataclass(frozen=True)
class LLMStream:
    """One serving workload: an architecture decoding at a tokens/s target."""

    stream_id: str
    arch: str
    tokens_per_s: float
    kv_seq: int = 32_768          # resident context per stream

    def requirement(self, dryrun_dir: Optional[str] = None
                    ) -> tuple[float, float]:
        """(TFLOP/s needed, HBM GiB resident): the per-token FLOPs of the
        dry run's record in ``dryrun_dir`` if there is one, else the closed
        form."""
        cfg = get_config(self.arch)
        flops_tok = 2.0 * cfg.active_param_count()      # decode forward
        rec = _load_dryrun(dryrun_dir, self.arch, "decode_32k") \
            if dryrun_dir else None
        if rec and rec.get("flops_per_device", 0) > 0:
            # per-device FLOPs x pod1's 256 GPUs / decode_32k's 128 rows
            flops_tok = rec["flops_per_device"] * 256 / 128
        tflops = self.tokens_per_s * flops_tok / 1e12
        hbm = (_param_bytes(cfg) + _kv_bytes(cfg, self.kv_seq)) / 2**30
        return (tflops, hbm)


def _param_bytes(cfg: ArchConfig) -> float:
    return 2.0 * cfg.param_count()                      # bf16


def _kv_bytes(cfg: ArchConfig, seq: int) -> float:
    total = 0.0
    for mixer, _ in cfg.layer_kinds:
        if mixer == "attn":
            total += 2 * seq * cfg.num_kv_heads * cfg.head_dim * 2
        elif mixer == "attn_window":
            total += 2 * min(seq, cfg.window) * cfg.num_kv_heads * cfg.head_dim * 2
        elif mixer == "ssd":
            total += cfg.ssm_heads * cfg.ssm_head_dim * cfg.ssm_state * 4
        elif mixer == "rglru":
            total += cfg.rnn_width * 4
    return total


def _load_dryrun(dryrun_dir: str, arch: str, shape: str) -> Optional[dict]:
    """The dry run's ``pod1`` record of (arch, shape), or None if there is
    none or it holds an error or a skip."""
    path = os.path.join(dryrun_dir, f"{arch}_{shape}_pod1.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        rec = json.load(f)
    return rec if "error" not in rec and "skipped" not in rec else None


def streams_from_measured(arch: str,
                          per_stream_tokens_per_s: dict[str, float],
                          *, kv_seq: int = 32_768) -> list[LLMStream]:
    """Packing items from an engine's *measured* per-stream decode rates
    (the paper's profile-then-pack step)."""
    return [LLMStream(sid, arch, tokens_per_s=rate, kv_seq=kv_seq)
            for sid, rate in sorted(per_stream_tokens_per_s.items())]


def streams_from_engine(arch: str, engine, *,
                        kv_seq: int = 32_768) -> list[LLMStream]:
    """Packing items straight from a serving engine's ``measured_rates()``.
    An engine with no wall time yields no items."""
    return streams_from_measured(arch, engine.measured_rates(), kv_seq=kv_seq)


def build_gpu_problem(streams: Sequence[LLMStream], catalog: Catalog,
                      dryrun_dir: Optional[str] = None) -> Problem:
    """Packing problem over the catalog's instance types and locations.

    Columnwise like the reference's ``build_tpu_problem``: the usable
    capacity matrix is built once, each distinct requirement vector is
    compared against every choice in one numpy pass, and streams with equal
    requirements share one requirements tuple."""
    choices = []
    for t in catalog.types:
        for loc, price in sorted(t.prices.items()):
            choices.append(Choice(key=f"{t.name}@{loc}", type_name=t.name,
                                  location=loc,
                                  capacity=t.usable(UTILIZATION_CAP),
                                  price=price, has_gpu=t.has_gpu))
    usable = np.array([c.capacity for c in choices])          # (C, D)

    req_tuples: dict[tuple[float, float], tuple] = {}
    items = []
    for s in streams:
        req = s.requirement(dryrun_dir)
        shared = req_tuples.get(req)
        if shared is None:
            ok = (np.asarray(req) <= usable).all(axis=1)      # (C,)
            shared = tuple(req if fit else None for fit in ok)
            req_tuples[req] = shared
        items.append(Item(key=s.stream_id, requirements=shared))
    return Problem(choices=tuple(choices), items=tuple(items))


def plan_gpu_fleet(streams: Sequence[LLMStream],
                   dryrun_dir: Optional[str] = None,
                   strategy: str = "packed") -> dict:
    """strategy: 'packed' (exact multiple-choice packing), 'uniform-big'
    (8-GPU instances in their cheapest region, first fit), 'per-stream'
    (the cheapest compatible instance for each stream). Requirements read
    the dry run's records in ``dryrun_dir`` if given. Every plan is checked
    by ``validate`` before it is returned."""
    catalog = h100_catalog()
    problem = build_gpu_problem(streams, catalog, dryrun_dir)
    if strategy == "packed":
        sol, _ = solve(problem, time_budget_s=30.0)
    elif strategy == "per-stream":
        bins = []
        cost = 0.0
        for i, item in enumerate(problem.items):
            compat = item.compatible()
            if not compat:
                raise Infeasible(item.key)
            c = min(compat, key=lambda c: problem.choices[c].price)
            bins.append(Bin(choice=c, items=[i]))
            cost += problem.choices[c].price
        sol = Solution(bins=bins, cost=cost, note="per-stream")
    elif strategy == "uniform-big":
        loc, _ = catalog.get("h100-8").cheapest_location()
        big = next(c for c, ch in enumerate(problem.choices)
                   if ch.type_name == "h100-8" and ch.location == loc)
        cap = problem.choices[big].capacity
        bins = []
        cost = 0.0
        for i, item in enumerate(problem.items):
            req = item.requirements[big]
            if req is None:
                raise Infeasible(item.key)
            placed = False
            for b in bins:
                if fits(req, b.used(problem), cap):
                    b.items.append(i)
                    placed = True
                    break
            if not placed:
                bins.append(Bin(choice=big, items=[i]))
                cost += problem.choices[big].price
        sol = Solution(bins=bins, cost=cost, note="uniform-big")
    else:
        raise ValueError(strategy)
    validate(problem, sol)
    return {"strategy": strategy, "hourly_cost": round(sol.cost, 2),
            "instances": sol.instance_counts(problem),
            "optimal": sol.optimal}

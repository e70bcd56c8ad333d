"""The comparisons that decide ``correct``, against the plain reference.

Serving, for a sample of frames answered in the window (prompt, served
tokens, the program's logit of each served token):

- ``logit_gap``: the widest gap by which a served token's reference logit
  lies below the reference's best at that position (0 where the program
  served the reference's own greedy token);
- ``logit_err``: the widest |program's logit - reference's logit| of a
  served token.

Training, over the first steps that set-up drove through the program's own
step (the reference takes the same steps from the same weights and
batches):

- ``loss_gap``: the widest |program's loss - reference's| / reference's,
  over the steps;
- ``grad1_gap``: the worst leaf's |‖g‖ - ‖g_ref‖| of the first gradient as
  the optimizer takes it, over max(‖g_ref‖ of the leaf, the median leaf's);
- ``delta_gap``: the same for each leaf's change over the steps, leaving
  out the leaves whose reference gradient is under a thousandth of the
  median leaf's (they move by round-off alone).

A control puts a reference of lower precision in the program's place:
``serving_control`` reads, at each position of the same prompts and tokens,
the token the lower precision puts first.
"""
from __future__ import annotations

import math
import statistics

import numpy as np
import torch

from harness import weights
from reference import train as ref_train
from reference.common import Precision

REF_BATCH = 4            # sequences the reference takes at once


def reference_logits(ctx, params, seqs: list, n: int,
                     precision: str) -> torch.Tensor:
    """The reference's logits (N, n, V) at the last ``n`` positions of each
    sequence (equal lengths), ``REF_BATCH`` at a time."""
    pr = Precision(precision)
    out = []
    with torch.no_grad(), pr.active():
        for i in range(0, len(seqs), REF_BATCH):
            toks = torch.as_tensor(np.stack(seqs[i:i + REF_BATCH]),
                                   dtype=torch.long, device=ctx.device)
            out.append(ctx.ref.logits_last(params, toks, n, ctx.config,
                                           pr).float().cpu())
    return torch.cat(out)


def _sequences(sample: list) -> dict:
    """The sample grouped by (prompt length, tokens served): each frame's
    prompt with its served tokens but the last, the served tokens and the
    program's logits of them."""
    groups = {}
    for prompt, served, logits in sample:
        g = groups.setdefault((len(prompt), len(served)), ([], [], []))
        g[0].append(np.concatenate([prompt, served[:-1]]).astype(np.int64))
        g[1].append(torch.as_tensor(np.asarray(served, np.int64)))
        g[2].append(logits)
    return groups


def _readings(ref: torch.Tensor, tokens: torch.Tensor,
              logits: torch.Tensor) -> dict:
    at = torch.gather(ref, -1, tokens[..., None])[..., 0]
    return {"logit_gap": float((ref.amax(-1) - at).max()),
            "logit_err": float((logits - at).abs().max())}


def _widest(parts: list) -> dict:
    return {k: max(p[k] for p in parts) for k in parts[0]}


def serving(ctx, params, sample: list) -> dict:
    """{number: {"value", "limit"}} for the sample; a frame whose logits
    the steps never returned, or an empty sample, reads infinite."""
    if not sample or any(s[2] is None for s in sample):
        return {k: {"value": math.inf, "limit": v}
                for k, v in ctx.limits.items()}
    parts = []
    for (_, n), (seqs, toks, logits) in _sequences(sample).items():
        ref = reference_logits(ctx, params, seqs, n, "fp32")
        parts.append(_readings(ref, torch.stack(toks), torch.stack(logits)))
    return {k: {"value": v, "limit": ctx.limits[k]}
            for k, v in _widest(parts).items()}


def serving_control(ctx, params, sample: list, precision: str) -> dict:
    """The control's readings: the reference in ``precision`` in the
    program's place, teacher-forced on the sample's prompts and served
    tokens, read at each of their positions: the token the lower precision
    puts first, against the fp32 reference."""
    widest = {}
    for seqs, _, _ in _sequences(sample).values():
        for i in range(0, len(seqs), REF_BATCH):
            part = seqs[i:i + REF_BATCH]
            S = len(part[0])
            ref = reference_logits(ctx, params, part, S, "fp32")
            low = reference_logits(ctx, params, part, S, precision)
            top = low.argmax(-1)
            got = _readings(ref, top, torch.gather(low, -1, top[..., None])
                            [..., 0])
            widest = {k: max(v, widest.get(k, 0.0)) for k, v in got.items()}
    return widest


def _worst_leaf(got: list, want: list, keep: list) -> float:
    med = statistics.median(want[i] for i in keep)
    return max(abs(got[i] - want[i]) / max(want[i], med) for i in keep)


def training_readings(prog: dict, ref: dict) -> dict:
    moved = [i for i, g in enumerate(ref["grad1"])
             if g >= 1e-3 * statistics.median(ref["grad1"])]
    return {"loss_gap": max(abs(a - b) / abs(b)
                            for a, b in zip(prog["loss"], ref["loss"])),
            "grad1_gap": _worst_leaf(prog["grad1"], ref["grad1"],
                                     range(len(ref["grad1"]))),
            "delta_gap": _worst_leaf(prog["delta"], ref["delta"], moved)}


def training_reference(ctx, batches: list, precision: str = "fp32",
                       half_batch: bool = False) -> dict:
    params = weights.make(ctx.ref.tree(ctx.config), ctx.seed, ctx.device,
                          ctx.dtype)
    return ref_train.run(ctx.ref, params,
                         [(b["tokens"], b["labels"]) for b in batches],
                         ctx.config,
                         ctx.traffic["optimizer"], Precision(precision),
                         half_batch=half_batch)


def training(ctx, prog: dict, batches: list) -> dict:
    got = training_readings(prog, training_reference(ctx, batches))
    return {k: {"value": v, "limit": ctx.limits[k]} for k, v in got.items()}

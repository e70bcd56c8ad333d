"""Plain training steps: the loss of a reference model, its gradient by
torch.autograd, global-norm clipping and AdamW with a linear-warmup cosine
schedule, written out from the published formulas (Loshchilov & Hutter,
arXiv:1711.05101): m ← b1·m + (1-b1)·g, v ← b2·v + (1-b2)·g², and
p ← p - lr·(m̂/(√v̂ + eps) + wd·p) with m̂, v̂ bias-corrected by step t.

``run`` takes the first steps from the given parameters and returns what
the benchmark compares: each step's loss, the norm of every leaf of the
first step's gradient as the optimizer takes it (after clipping), and the
norm of every leaf's change over the steps.
"""
from __future__ import annotations

import math

import torch

from reference.common import Precision


def lr_scale(step: int, warmup: int, total: int, min_ratio: float) -> float:
    """Linear warmup from 0 at step 0, then cosine decay to ``min_ratio``."""
    warm = min(1.0, step / max(warmup, 1))
    frac = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
    return warm * (min_ratio + (1 - min_ratio) * 0.5 * (1 + math.cos(
        math.pi * frac)))


def leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def run(model, params: dict, batches: list, c: dict, opt: dict,
        pr: Precision, *, half_batch: bool = False) -> dict:
    """``len(batches)`` AdamW steps of ``model`` (a reference module with
    ``loss``) from ``params``, updated in place. ``half_batch`` is a
    planted fault: the loss is the mean over the first half of each
    batch's rows."""
    flat = leaves(params)
    p0 = [p.detach().clone() for p in flat]
    m = [torch.zeros_like(p) for p in flat]
    v = [torch.zeros_like(p) for p in flat]
    losses, grad1 = [], None
    for t, (tokens, labels) in enumerate(batches):
        if half_batch:
            tokens, labels = tokens[: len(tokens) // 2], \
                labels[: len(labels) // 2]
        live = [p.detach().requires_grad_() for p in flat]
        it = iter(live)
        tree = _rebuild(params, it)
        with pr.active():
            loss = model.loss(tree, tokens, labels, c, pr)
            grads = torch.autograd.grad(loss, live)
        losses.append(float(loss.detach()))
        norm = torch.sqrt(sum(torch.sum(g.double() ** 2) for g in grads))
        clip = min(1.0, opt["clip_norm"] / (float(norm) + 1e-9))
        grads = [g * clip for g in grads]
        if grad1 is None:
            grad1 = [float(torch.linalg.vector_norm(g.double()))
                     for g in grads]
        lr = opt["lr"] * lr_scale(t, opt["warmup"], opt["total"],
                                  opt["min_ratio"])
        b1c, b2c = 1 - opt["b1"] ** (t + 1), 1 - opt["b2"] ** (t + 1)
        with torch.no_grad():
            for p, g, mi, vi in zip(flat, grads, m, v):
                mi.mul_(opt["b1"]).add_((1 - opt["b1"]) * g)
                vi.mul_(opt["b2"]).add_((1 - opt["b2"]) * g * g)
                step = (mi / b1c) / (torch.sqrt(vi / b2c) + opt["eps"])
                p.sub_(lr * (step + opt["weight_decay"] * p))
        del grads
    delta = [float(torch.linalg.vector_norm((p - q).double()))
             for p, q in zip(flat, p0)]
    return {"loss": losses, "grad1": grad1, "delta": delta}


def _rebuild(tree, it):
    if isinstance(tree, dict):
        return {k: _rebuild(v, it) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_rebuild(v, it) for v in tree]
    return next(it)

"""Weights from ``--seed``, made where they are served, in a few large
calls: every normal leaf is a slice of one buffer drawn by one
``normal_`` on a generator of the device, then scaled; every uniform leaf a
slice of one ``uniform_`` buffer; constants are filled. The tree's layout
and distributions are the reference's (``reference.<family>.tree``); the
same tensors go to the program and to the reference."""
from __future__ import annotations

import math

import torch

from reference.common import FP32_LEAVES


def _walk(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, f"{path}/{k}" if path else k)
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _walk(v, f"{path}/{i}")
    else:
        yield path, tree


def _rebuild(tree, made: dict, path=""):
    if isinstance(tree, dict):
        return {k: _rebuild(v, made, f"{path}/{k}" if path else k)
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_rebuild(v, made, f"{path}/{i}") for i, v in enumerate(tree)]
    return made[path]


def generator(seed: int, device, stream: int) -> torch.Generator:
    """A generator of ``device`` for one use of the seed (``stream`` keeps
    the weights, the batches and the rest apart); any whole number is a
    seed."""
    g = torch.Generator(device=device)
    g.manual_seed((seed * 1_000_003 + stream) % (1 << 63))
    return g


def make(spec, seed: int, device, dtype=torch.float32) -> dict:
    """The tree ``spec`` (of ``Leaf``) with every leaf drawn from ``seed``
    on ``device``, in ``dtype`` but for the scan's constants
    (``FP32_LEAVES``), which stay fp32."""
    leaves = list(_walk(spec))
    normal = [(p, l) for p, l in leaves if l.init[0] == "normal"]
    uniform = [(p, l) for p, l in leaves if l.init[0] == "uniform"]
    gen = generator(seed, device, 0)
    made = {}
    size = lambda l: math.prod(l.shape)
    buf = torch.empty(sum(size(l) for _, l in normal), dtype=torch.float32,
                      device=device).normal_(generator=gen)
    off = 0
    for p, l in normal:
        made[p] = buf[off:off + size(l)].view(l.shape).mul_(l.init[1])
        off += size(l)
    ubuf = torch.empty(sum(size(l) for _, l in uniform), dtype=torch.float32,
                       device=device).uniform_(generator=gen)
    off = 0
    for p, l in uniform:
        lo, hi = l.init[1], l.init[2]
        made[p] = ubuf[off:off + size(l)].view(l.shape).mul_(hi - lo).add_(lo)
        off += size(l)
    for p, l in leaves:
        kind = l.init[0]
        if kind == "const":
            made[p] = torch.full(l.shape, l.init[1], device=device)
        elif kind == "log_linspace":
            made[p] = torch.log(torch.linspace(l.init[1], l.init[2],
                                               l.shape[0], device=device))
        elif kind not in ("normal", "uniform"):
            raise ValueError(f"{p}: unknown init {l.init}")
    if dtype != torch.float32:
        made = {p: t if p.rsplit("/", 1)[-1] in FP32_LEAVES else t.to(dtype)
                for p, t in made.items()}
    return _rebuild(spec, made)

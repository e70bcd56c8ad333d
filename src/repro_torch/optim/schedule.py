"""Learning-rate schedules, pure functions of the step counter, ported from
``repro.optim.schedule``."""
from __future__ import annotations

import math

import torch


def cosine_schedule(step, *, warmup: int = 100, total: int = 10_000,
                    min_ratio: float = 0.1):
    """Linear warmup then cosine decay to ``min_ratio``: a scale in (0, 1]
    (0 at step 0). ``step`` is an int (returns a Python float) or a tensor
    (returns an fp32 tensor on its device, computed in fp32 as the
    reference computes it)."""
    if not isinstance(step, torch.Tensor):
        step = float(step)
        warm = min(1.0, step / max(warmup, 1))
        frac = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
        cos = 0.5 * (1.0 + math.cos(math.pi * frac))
        return warm * (min_ratio + (1 - min_ratio) * cos)
    step = step.float()
    warm = torch.clamp(step / max(warmup, 1), max=1.0)
    frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * frac))
    return warm * (min_ratio + (1 - min_ratio) * cos)

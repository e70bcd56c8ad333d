"""AdamW with global-norm clipping, ported from ``repro.optim.adamw``.

The reference's update is pure; this one updates the parameters and the
moments **in place** under ``torch.no_grad()``, which saves a copy of the
whole train state a step (18.8 GB at full-width olmo-1b in fp32). The
operations and their order are the reference's: clip by
min(1, clip_norm / (‖g‖ + 1e-9)), the fp32 moments, bias correction with
step + 1, mhat / (√vhat + eps) + wd · p, then the cast back to each
tensor's dtype. The moments' dtype is ``AdamWConfig.state_dtype``.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.tree import leaves, map_tree


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    state_dtype: torch.dtype = torch.float32   # bf16 for memory-bound archs


def adamw_init(params, cfg: AdamWConfig) -> dict:
    """Zero moments shaped as ``params`` in ``cfg.state_dtype`` and a 0-d
    int32 step counter, on the parameters' device."""
    zeros = lambda p: torch.zeros(p.shape, dtype=cfg.state_dtype,
                                  device=p.device)
    device = leaves(params)[0].device
    return {"m": map_tree(zeros, params), "v": map_tree(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree) -> torch.Tensor:
    """√(Σ over the leaves of Σ g²), each leaf summed in fp32."""
    total = 0
    for g in leaves(tree):
        total = total + torch.sum(torch.square(g.float()))
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(params, grads, state: dict, cfg: AdamWConfig,
                 lr_scale=1.0):
    """One AdamW step. ``grads`` is shaped as ``params`` (a leaf may be in
    another dtype). Updates ``params``, ``state["m"]`` and ``state["v"]`` in
    place and returns (params, new state, {"grad_norm": ‖g‖}), the new
    state holding the same moment tensors and the step counter + 1."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    stepf = step.float()
    b1c = 1.0 - torch.pow(cfg.b1, stepf)
    b2c = 1.0 - torch.pow(cfg.b2, stepf)
    lr = cfg.lr * lr_scale
    for p, g, m, v in zip(leaves(params), leaves(grads),
                          leaves(state["m"]), leaves(state["v"])):
        g = g.float() * scale
        m32 = m if m.dtype == torch.float32 else m.float()
        v32 = v if v.dtype == torch.float32 else v.float()
        m_new = m32.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v_new = v32.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        p32 = p if p.dtype == torch.float32 else p.float()
        delta = (m_new / b1c) / (torch.sqrt(v_new / b2c) + cfg.eps)
        delta = delta.add_(cfg.weight_decay * p32)
        p.copy_(p32 - lr * delta)
        if m32 is not m:
            m.copy_(m_new)
            v.copy_(v_new)
    return params, {"m": state["m"], "v": state["v"], "step": step}, \
        {"grad_norm": gnorm}

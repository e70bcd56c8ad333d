"""The paper's analysis programs, VGG16 and ZF, the port of
``repro.models.vgg``: the per-frame compute of the streams the planner
bills (object-detection backbones).

The entry takes the reference's (B, H, W, C) frames and returns (B,
classes) logits; inside, activations are NCHW and conv weights OIHW, so the
convolutions are cuDNN's on the card. Each conv pads as JAX's "SAME" does:
out = ceil(in / stride), total pad max((out - 1)·stride + k - in, 0), of
which total // 2 before and the rest after (asymmetric at stride 2, which
``padding="same"`` of ``F.conv2d`` refuses). Pools are 2×2/2 "VALID"
(floor). The FC head flattens in the reference's (h, w, c) order, so the
first FC weight keeps its rows. Parameters::

    {"conv": [{"w": (out, in, k, k), "b": (out,)}, ...],
     "fc": [{"w": (in, out), "b": (out,)}, ...]}

with the strides taken from the layout. Input size is free (224 px is the
canonical architectures; the tests use 64 and 67).
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F


# layout entries: (out_channels, kernel, stride) or 'M' = 2x2 maxpool
def _c(ch, k=3, s=1):
    return (ch, k, s)


VGG16_LAYOUT: Sequence = (_c(64), _c(64), "M", _c(128), _c(128), "M",
                          _c(256), _c(256), _c(256), "M",
                          _c(512), _c(512), _c(512), "M",
                          _c(512), _c(512), _c(512), "M")
# ZFNet: 7x7/2 and 5x5/2 early convs shrink the spatial extent fast
ZF_LAYOUT: Sequence = (_c(96, 7, 2), "M", _c(256, 5, 2), "M",
                       _c(384), _c(384), _c(256), "M")


def same_pad(size: int, k: int, stride: int) -> tuple[int, int]:
    """JAX's "SAME" padding of one spatial dim: (before, after)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _convs(layout: Sequence):
    return [item for item in layout if item != "M"]


def init_convnet(layout: Sequence, generator: torch.Generator, *,
                 in_channels: int = 3, num_classes: int = 1000,
                 input_hw: int = 64, fc_width: int = 512,
                 dtype: torch.dtype = torch.float32, device="cuda") -> dict:
    """Random parameters with the reference's distributions: each conv
    N(0, 1)/sqrt(k·k·in), each FC N(0, 1)/sqrt(fan_in), biases 0. Draws on
    ``generator``'s device, so the bits differ from JAX's."""
    def normal(shape, std):
        w = torch.randn(shape, generator=generator, device=generator.device)
        return (w * std).to(device=device, dtype=dtype)

    params: dict = {"conv": [], "fc": []}
    c_in, hw = in_channels, input_hw
    for item in layout:
        if item == "M":
            hw //= 2
            continue
        ch, ksz, stride = item
        std = 1.0 / math.sqrt(ksz * ksz * c_in)
        params["conv"].append({
            "w": normal((ch, c_in, ksz, ksz), std),
            "b": torch.zeros((ch,), dtype=dtype, device=device)})
        hw = -(-hw // stride)
        c_in = ch
    flat = hw * hw * c_in
    for width in (fc_width, fc_width, num_classes):
        params["fc"].append({"w": normal((flat, width), 1.0 / math.sqrt(flat)),
                             "b": torch.zeros((width,), dtype=dtype,
                                              device=device)})
        flat = width
    return params


def params_from_reference(ref_params: dict, device="cuda",
                          dtype: torch.dtype = torch.float32) -> dict:
    """The reference's parameters (arrays that ``np.asarray`` takes) as the
    port's: conv weights HWIO -> OIHW; the ``stride`` leaves are dropped
    (the port reads strides from the layout)."""
    def t(a, perm=None):
        a = np.asarray(a, np.float32)
        if perm is not None:
            a = np.transpose(a, perm)
        return torch.tensor(a, dtype=dtype, device=device)

    return {"conv": [{"w": t(p["w"], (3, 2, 0, 1)), "b": t(p["b"])}
                     for p in ref_params["conv"]],
            "fc": [{"w": t(p["w"]), "b": t(p["b"])}
                   for p in ref_params["fc"]]}


def apply_convnet(params: dict, x: torch.Tensor,
                  layout: Sequence) -> torch.Tensor:
    """x: (B, H, W, C) -> logits (B, num_classes)."""
    x = x.permute(0, 3, 1, 2)                       # NHWC -> NCHW
    convs = iter(zip(params["conv"], _convs(layout)))
    for item in layout:
        if item == "M":
            x = F.max_pool2d(x, 2, 2)
            continue
        p, (_, ksz, stride) = next(convs)
        ph, pw = same_pad(x.shape[2], ksz, stride), same_pad(x.shape[3], ksz,
                                                             stride)
        x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
        x = F.relu(F.conv2d(x, p["w"], p["b"], stride=stride))
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)   # (h, w, c) order
    for i, p in enumerate(params["fc"]):
        x = x @ p["w"] + p["b"]
        if i < len(params["fc"]) - 1:
            x = F.relu(x)
    return x


def init_vgg16(generator: torch.Generator, **kw) -> dict:
    return init_convnet(VGG16_LAYOUT, generator, **kw)


def apply_vgg16(params: dict, x: torch.Tensor) -> torch.Tensor:
    return apply_convnet(params, x, VGG16_LAYOUT)


def init_zf(generator: torch.Generator, **kw) -> dict:
    return init_convnet(ZF_LAYOUT, generator, **kw)


def apply_zf(params: dict, x: torch.Tensor) -> torch.Tensor:
    return apply_convnet(params, x, ZF_LAYOUT)


def flops_per_frame(layout: Sequence, input_hw: int, in_channels: int = 3,
                    fc_width: int = 512, num_classes: int = 1000) -> int:
    """Analytic conv + FC FLOPs of one frame (2 per multiply-add), as the
    reference counts them: VGG16 is ~12x ZF at 224 px."""
    total = 0
    hw, c_in = input_hw, in_channels
    for item in layout:
        if item == "M":
            hw //= 2
            continue
        ch, ksz, stride = item
        hw = -(-hw // stride)
        total += 2 * ksz * ksz * c_in * ch * hw * hw
        c_in = ch
    flat = hw * hw * c_in
    for width in (fc_width, fc_width, num_classes):
        total += 2 * flat * width
        flat = width
    return total

"""The NVIDIA H100's published peaks (data sheet, SXM part, dense rates, at
its full 700 W limit): what every share of a peak or a roofline in this
benchmark divides by."""
from __future__ import annotations

FLOPS = {"float32": 67e12,        # outside the tensor cores
         "tf32": 495e12,          # float32 on the tensor cores
         "bfloat16": 989e12}
HBM_BYTES_PER_S = 3.35e12


def flops_of(config: dict) -> float:
    """The peak rate of a configuration's stated precision: float32 with
    TF32 off is 67 TFLOP/s."""
    if config["dtype"] == "float32" and config.get("tf32"):
        return FLOPS["tf32"]
    return FLOPS[config["dtype"]]

"""Share of the flash-attention roofline in training over the window: its
forward calls (remat's repeats included) and its backward calls,
``kernels/flash_attention.py::flash_attention`` and
``flash_attention_bwd``: each call's bound summed over the device time of
everything launched inside the calls, by the trace, in %."""
from metrics import counts

SPANS = {"flash": {"target":
                   "repro_torch.kernels.flash_attention:flash_attention"},
         "flash_bwd": {"target": "repro_torch.kernels.flash_attention:"
                                 "flash_attention_bwd"}}


def read(run):
    return counts.roofline_pct(
        (run.spans.between("flash", *run.window), counts.flash_call),
        (run.spans.between("flash_bwd", *run.window), counts.flash_bwd_call))

"""Share of the flash-attention forward's roofline over the window: the
sum of each call's bound (its operations at the peak or its bytes at the
HBM rate, whichever is longer) over the device time of everything launched
inside the calls to its entry, ``kernels/flash_attention.py::
flash_attention``, by the trace, in %."""
from metrics import counts

SPANS = {"flash": {"target":
                   "repro_torch.kernels.flash_attention:flash_attention"}}


def read(run):
    return counts.roofline_pct(
        (run.spans.between("flash", *run.window), counts.flash_call))

"""Share of the SSD scan's roofline over the window: each call's bound
(``counts.ssd_scan`` at the fp32 peak or the HBM rate) summed over the
device time of everything launched inside the calls to its entry,
``kernels/ssd_scan.py::ssd_scan``, by the trace, in %."""
from metrics import counts

SPANS = {"ssd": {"target": "repro_torch.kernels.ssd_scan:ssd_scan"}}


def read(run):
    return counts.roofline_pct(
        (run.spans.between("ssd", *run.window), counts.ssd_call))

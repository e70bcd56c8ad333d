"""Share of the dropless MoE layer's roofline over the window: each call's
bound (``counts_moe.moe_call``: its operations at the fp32 peak or its
bytes at the HBM rate, from its shapes and the configuration) summed over
the device time of everything launched inside the calls to its entry,
``models/moe.py::apply_moe_dropless`` (router, sort, expert products,
combine, shared expert), by the trace, in %."""
from metrics import counts, counts_moe

SPANS = {"moe": {"target": "repro_torch.models.moe:apply_moe_dropless"}}


def read(run):
    return counts.roofline_pct((run.spans.between("moe", *run.window),
                                lambda info: counts_moe.moe_call(
                                    info, run.config)))

"""The MoE layers' share of the host-paced decode step's issue, in ms: the
mean, over the program's ``steps.decode`` spans begun inside the window,
of the host time of the calls to the dropless MoE layer's entry,
``models/moe.py::apply_moe_dropless``, that began inside each (the
harness's spans, opened and closed with no synchronise, on the clock of
the program's spans). None where the decode steps hold no such call."""
from metrics import program_spans

SPANS = {"moe": {"target": "repro_torch.models.moe:apply_moe_dropless"}}


def _moe_ms(step, calls):
    """Summed host ms of the ``calls`` that began inside ``step``, or None
    if none did."""
    t0 = step.start_s
    t1 = t0 + step.wall_ms / 1e3
    inside = [c.t1 - c.t0 for c in calls if t0 <= c.t0 <= t1]
    return 1e3 * sum(inside) if inside else None


def read(run):
    steps = program_spans.began_in_window(run, "steps.decode")
    if not steps:
        return None
    calls = run.spans.between("moe", *run.window)
    per_step = [m for m in (_moe_ms(s, calls) for s in steps)
                if m is not None]
    return sum(per_step) / len(per_step) if per_step else None

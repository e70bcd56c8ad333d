"""Mean wall time of the window's admissions' prefills: a span around each
call of ``models/steps.py::prefill_into_slot_step`` (the module attribute
the engine calls), closed after a synchronise."""

SPANS = {"prefill": {"target": "repro_torch.models.steps:prefill_into_slot_step",
                     "sync": True}}


def read(run):
    calls = run.spans.between("prefill", *run.window)
    if not calls:
        return None
    return 1e3 * sum(c.t1 - c.t0 for c in calls) / len(calls)

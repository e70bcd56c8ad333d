"""Mean wall time of the window's batched decode steps: a span around each
call of ``models/steps.py::decode_step`` (the module attribute the engine
calls), closed after a synchronise."""

SPANS = {"decode": {"target": "repro_torch.models.steps:decode_step",
                    "sync": True}}


def read(run):
    calls = run.spans.between("decode", *run.window)
    if not calls:
        return None
    return 1e3 * sum(c.t1 - c.t0 for c in calls) / len(calls)

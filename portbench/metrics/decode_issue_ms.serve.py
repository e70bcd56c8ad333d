"""Mean host time of the window's batched decode steps as the host issues
them, in ms: the program's ``steps.decode`` spans, opened inside
``models/steps.py::decode_step`` and closed when it returns, with no
synchronise (``decode_step_ms.serve`` is the same call closed after one)."""
from metrics import program_spans


def read(run):
    spans = program_spans.began_in_window(run, "steps.decode")
    if not spans:
        return None
    return sum(s.wall_ms for s in spans) / len(spans)

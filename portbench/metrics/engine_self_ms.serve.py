"""Mean self time of the window's engine steps, in ms: each of the
program's ``engine.step`` spans that began inside the window, less the time
its child spans (admission, decode, readback, retirements) cover. What is
left is the engine's own bookkeeping on the host."""
from metrics import program_spans


def self_ms(span) -> float:
    """``span``'s wall time less the union of its children's intervals,
    each clipped to the span's own."""
    start = span.start_s
    end = start + span.wall_ms / 1e3
    covered, reach = 0.0, start
    for s, e in sorted((c.start_s, c.start_s + c.wall_ms / 1e3)
                       for c in span.children):
        s, e = max(s, reach), min(e, end)
        if e > s:
            covered += e - s
            reach = e
    return span.wall_ms - 1e3 * covered


def read(run):
    spans = program_spans.began_in_window(run, "engine.step")
    if not spans:
        return None
    return sum(self_ms(s) for s in spans) / len(spans)

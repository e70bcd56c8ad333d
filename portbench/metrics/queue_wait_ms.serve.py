"""The 90th percentile (nearest rank) of the window's queue waits, in ms:
the program's ``request.queue`` spans, each from
``ContinuousBatchingEngine.submit`` to the start of the request's prefill,
of the requests admitted inside the window. (A wait is recorded at its
admission, so one that began in the window may not be recorded when it
closes; every admission inside it is whole, as every frame answered inside
it is for ``frame_latency_p90_s``.)"""
import math

from metrics import program_spans


def read(run):
    spans = program_spans.named("request.queue")
    if spans is None:
        return None
    t0, t1 = run.window
    waits = sorted(s.wall_ms for s in spans
                   if t0 <= s.start_s + s.wall_ms / 1e3 <= t1)
    if not waits:
        return None
    return waits[math.ceil(0.9 * len(waits)) - 1]

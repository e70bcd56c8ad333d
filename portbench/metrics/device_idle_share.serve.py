"""The share of the traced window in which nothing ran on the device: 1 -
the union of its kernels', copies' and fills' intervals over the window,
from the profiler's trace, in %."""


def read(run):
    if run.trace is None or run.trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])

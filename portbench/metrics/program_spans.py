"""The program's own spans: those of
``repro_torch.obs.trace.program_tracer()``, which the serving path writes
while the traced run's profiler records, each with its host start on
``time.perf_counter`` (``start_s``), the clock of the window. A program
without that tracer gives None, and so do its readers."""


def named(name: str):
    """Every span named ``name``, or None if the program keeps no program
    tracer."""
    try:
        from repro_torch.obs.trace import program_tracer
    except ImportError:
        return None
    return [s for s in program_tracer().find(name) if s.start_s is not None]


def began_in_window(run, name: str):
    """The spans named ``name`` whose start lies inside the window, or
    None."""
    spans = named(name)
    if spans is None:
        return None
    t0, t1 = run.window
    return [s for s in spans if t0 <= s.start_s <= t1]

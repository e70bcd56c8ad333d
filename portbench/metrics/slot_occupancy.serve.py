"""The engine's own slot occupancy over the window's decode steps
(``ContinuousBatchingEngine.report()["slot_occupancy"]``, its counters
zeroed when the window opens), in %."""


def read(run):
    occ = run.engine_report.get("slot_occupancy")
    return None if not occ else 100.0 * occ

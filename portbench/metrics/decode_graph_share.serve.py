"""Share of the window's batched decode steps that the engine replayed from
its CUDA graph, in %: ``ContinuousBatchingEngine.report()
["decode_graph_share"]`` (its counters zeroed when the window opens), times
100. None where the engine reports no such share."""


def read(run):
    share = run.engine_report.get("decode_graph_share")
    return None if share is None else 100.0 * share

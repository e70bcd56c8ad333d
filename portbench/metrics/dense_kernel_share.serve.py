"""Share of the FLOPs of the window's fp32 dense products of many rows (a
prefill's) that ran on the split-TF32 kernel, in %:
``ContinuousBatchingEngine.report()["dense_kernel_share"]`` (its counters
zeroed when the window opens), times 100. None where the engine reports no
such share (a program without the kernel)."""


def read(run):
    share = run.engine_report.get("dense_kernel_share")
    return None if share is None else 100.0 * share

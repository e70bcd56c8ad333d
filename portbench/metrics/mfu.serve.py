"""Model FLOPs of the frames answered inside the window (each frame's
prefill and decode steps, ``counts.model_flops_frame``) over the window's
seconds, as a share of the card's peak for the configuration's precision
(67 TFLOP/s for float32 with TF32 off), in %."""
from metrics import counts, peaks


def read(run):
    if not run.frames or run.window_s <= 0:
        return None
    flops = sum(counts.model_flops_frame(run.config, n, new)
                for _, _, n, new, *_ in run.frames)
    return 100.0 * flops / run.window_s / peaks.flops_of(run.config)

"""Model FLOPs of the optimizer steps completed inside the window
(``counts.model_flops_train_step``) over the window's seconds, as a share
of the card's peak for the configuration's precision (67 TFLOP/s for
float32 with TF32 off), in %."""
from metrics import counts, peaks


def read(run):
    if not run.steps or run.window_s <= 0:
        return None
    step = counts.model_flops_train_step(
        run.config, run.traffic["batch"], run.traffic["seq_len"])
    return 100.0 * step * len(run.steps) / run.window_s / \
        peaks.flops_of(run.config)

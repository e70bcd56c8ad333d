"""Model FLOPs of the frames answered inside the window, for a model whose
blocks end in a dropless MoE of which this card holds a share
(``counts_moe.model_flops_frame``: the mixers, the held experts' expected
entries, the router, the shared expert and the output head at each
answered position), over the window's seconds, as a share of the card's
peak for the configuration's precision (67 TFLOP/s for float32 with TF32
off), in %."""
from metrics import counts_moe, peaks


def read(run):
    if not run.frames or run.window_s <= 0:
        return None
    flops = sum(counts_moe.model_flops_frame(run.config, n, new)
                for _, _, n, new, *_ in run.frames)
    return 100.0 * flops / run.window_s / peaks.flops_of(run.config)

"""step_mfu_pct: the model operations of the dispatches completed in the
traced window (SuperPoint over every image, LightGlue over every pair
problem at the keypoints each side has: ``flops.window_work``) over the
window's seconds, in % of one H100's dense bf16 peak (989 TFLOP/s). The
run prints the card's power limit beside it."""

from slambench.flops import PEAK_FLOPS


def read(run):
    if run.steps == 0:
        return None
    ops = run.work["detector_flops"] + run.work["matcher_flops"]
    return 100.0 * ops / (run.seconds * PEAK_FLOPS)

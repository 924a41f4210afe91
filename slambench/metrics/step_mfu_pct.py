"""step_mfu_pct: the model operations of the dispatches completed in the
traced window (SuperPoint over every image, the configuration's matcher
over every pair problem at the keypoints each side has, by its module's
``work`` and its ``parts``, each operation once: ``flops.window_work``)
over the window's seconds, in % of one H100's dense bf16 peak (989
TFLOP/s). The run prints the card's power limit beside it."""

from slambench.flops import PEAK_FLOPS


def read(run):
    if run.steps == 0:
        return None
    ops = (run.work["detector_flops"] + run.work["matcher_flops"]
           + sum(f for f, _b, _peak in run.work["parts"].values()))
    return 100.0 * ops / (run.seconds * PEAK_FLOPS)

"""detector_roofline_pct: the least time SuperPoint's work could take on
the card (its operations at the bf16 peak or its least bytes at HBM's
rate, whichever is longer), for the dispatches completed in the traced
window, in % of the device time of the trace's detector layer
(``layers/detector.json``). Silent when the trace shows no detector."""

from slambench.flops import least_seconds


def read(run):
    t = run.trace.layer_s.get("detector", 0.0)
    if t <= 0 or run.steps == 0:
        return None
    return 100.0 * least_seconds(run.work["detector_flops"], run.work["detector_bytes"]) / t

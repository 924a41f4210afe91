"""matcher_roofline_pct: as detector_roofline_pct, for the matcher and the
match extraction (``layers/matcher.json``), its work the configuration's
matcher module's ``work`` (``matchers/<matcher>.py``) counted at the
keypoints each side of a pair has."""

from slambench.flops import least_seconds


def read(run):
    t = run.trace.layer_s.get("matcher", 0.0)
    if t <= 0 or run.steps == 0:
        return None
    return 100.0 * least_seconds(run.work["matcher_flops"], run.work["matcher_bytes"]) / t

"""Keyframe insertion policy (pure predicate).

Behavioral spec from ``include/KeyframeGate.h:11-24``. The
decision combines three triggers — a frame-count ceiling, an absolute
tracked-match floor, and a covisibility fraction against the reference
keyframe — with a short refractory window (``min_frames``) so a one-frame
covisibility glitch cannot spawn consecutive keyframes.
"""

from __future__ import annotations

# Single source for the gate's fixed thresholds: the on-device gate mirror
# (ops.frontend_step.track_kf_scan callers) must stay in lockstep with the
# host gate, so they import these instead of re-stating the literals.
MIN_FRAMES_DEFAULT = 2
MIN_MATCHES_DEFAULT = 30


def should_insert_keyframe(
    tracked_matches: int,
    reference_features: int,
    frames_since_keyframe: int,
    covisibility_ratio: float = 0.7,
    max_frames: int = 20,
    min_frames: int = MIN_FRAMES_DEFAULT,
    min_matches: int = MIN_MATCHES_DEFAULT,
) -> bool:
    if frames_since_keyframe < min_frames:
        return False
    if frames_since_keyframe >= max_frames or tracked_matches < min_matches:
        return True
    ratio = tracked_matches / max(1, reference_features)
    return ratio < covisibility_ratio

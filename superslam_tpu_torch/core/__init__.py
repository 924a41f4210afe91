"""Device-free estimation core (the TPU never appears below this line).

Mirrors the reference's GPU-free ``superslam_core`` split
(``CMakeLists.txt:210-229``): everything here is testable
with deterministic extractor/matcher stubs and synthetic stereo geometry.
"""

from .factors import (
    HUBER_K,
    batch_stereo_factor,
    batch_stereo_project,
    huber_loss,
    huber_weights,
    stereo_diag_sigmas,
)
from .frame import StereoFrame
from .frame_tracker import FrameTracker, PointObs
from .interfaces import FeatureExtractor, FeatureMatcher, Features, MatchResult
from .keyframe_gate import should_insert_keyframe
from .keyframes import KeyframeDatabase, KeyframeRecord
from .loop_closer import LoopCloser, LoopParams, LoopResult
from .place_recognition import (
    CosineDescriptorIndex,
    LoopCandidate,
    PlaceRecognizer,
    TemporalConsistencyVoter,
)
from .pose_graph import GlobalPoseGraph
from .sparse_map import SparseMap
from .vo_estimator import KeyframeMsg, VoEstimator
from .window_smoother import StereoObs, WindowSmoother

__all__ = [
    "HUBER_K",
    "batch_stereo_factor",
    "batch_stereo_project",
    "huber_loss",
    "huber_weights",
    "stereo_diag_sigmas",
    "StereoFrame",
    "FrameTracker",
    "PointObs",
    "FeatureExtractor",
    "FeatureMatcher",
    "Features",
    "MatchResult",
    "should_insert_keyframe",
    "KeyframeDatabase",
    "KeyframeRecord",
    "LoopCloser",
    "LoopParams",
    "LoopResult",
    "CosineDescriptorIndex",
    "LoopCandidate",
    "PlaceRecognizer",
    "TemporalConsistencyVoter",
    "GlobalPoseGraph",
    "SparseMap",
    "KeyframeMsg",
    "VoEstimator",
    "StereoObs",
    "WindowSmoother",
]

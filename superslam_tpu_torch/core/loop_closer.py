"""Loop closure: retrieval -> temporal vote -> geometric verification.

Equivalent of the reference LoopCloser
(``src/LoopCloser.cc:44-125``):

- ``detect``: query the recognizer (exclude_recent, top_k), temporal-vote the
  best candidate, then geometrically verify candidates in score order until
  one passes.
- ``verify``: match candidate<->query, backproject the candidate's stereo
  points into its camera frame, recover T_candidate_query with the robust
  pose-only tracker seeded at identity, count reprojection inliers (< 3 px on
  (uL, v)), require >= min_inliers, and emit a Huber-robustified edge whose
  sigma is noise_base/sqrt(inliers) clamped (sigR >= 0.02, sigT >= 0.20).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..geometry.se3 import Pose3
from ..geometry.stereo_camera import StereoCalib
from ..utils.env import env_float
from .frame_tracker import FrameTracker
from .interfaces import FeatureMatcher
from .keyframes import KeyframeDatabase, KeyframeRecord
from .place_recognition import PlaceRecognizer, TemporalConsistencyVoter


@dataclass
class LoopParams:
    """Tunables; env-overridable per the SUPERSLAM_* convention
    (LoopCloser.h:26-35)."""

    min_score: float = 0.75
    exclude_recent: int = 30
    top_k: int = 3
    required_votes: int = 3
    id_tolerance: int = 5
    min_inliers: int = 30
    inlier_px: float = 3.0
    noise_base: float = 0.1


@dataclass
class LoopResult:
    accepted: bool = False
    matched_keyframe: int = 0
    relative_pose: Pose3 = field(default_factory=Pose3)  # T_matched_query
    noise_sigmas: np.ndarray | None = None  # (6,) diagonal, Huber-robustified
    inliers: int = 0
    best_score: float = 0.0  # top retrieval score (the viewer's loop_deep_score)


class LoopCloser:
    def __init__(
        self,
        matcher: FeatureMatcher,
        calib: StereoCalib,
        recognizer: PlaceRecognizer,
        params: LoopParams | None = None,
    ):
        self.matcher = matcher
        self.calib = calib
        self.recognizer = recognizer
        p = params or LoopParams()
        p.min_inliers = int(env_float("SUPERSLAM_LOOP_MIN_INLIERS", p.min_inliers))
        p.min_score = env_float("SUPERSLAM_LOOP_MIN_SCORE", p.min_score)
        self.params = p
        self.db = KeyframeDatabase()
        self.verifier = FrameTracker(calib)
        self.voter = TemporalConsistencyVoter(p.required_votes, p.id_tolerance)

    def compute_global_descriptor(self, image: np.ndarray) -> np.ndarray:
        return self.recognizer.compute_global_descriptor(image)

    def add_keyframe(self, rec: KeyframeRecord) -> None:
        self.db.add(rec)
        self.recognizer.add(rec.keyframe_id, rec.global_descriptor)

    def detect(self, query: KeyframeRecord) -> LoopResult:
        cands = self.recognizer.query(
            query.global_descriptor, self.params.exclude_recent, self.params.top_k
        )
        best = cands[0] if cands else None
        best_score = float(best.score) if best else 0.0
        if not self.voter.vote(best):
            return LoopResult(best_score=best_score)
        for c in cands:
            if c.score < self.params.min_score:
                break  # sorted descending; nothing better remains
            r = self.verify(query, self.db.get(c.keyframe_id))
            if r.accepted:
                r.best_score = best_score
                return r
        return LoopResult(best_score=best_score)

    def verify(self, query: KeyframeRecord, candidate: KeyframeRecord) -> LoopResult:
        out = LoopResult(matched_keyframe=candidate.keyframe_id)
        m = self.matcher.match(
            candidate.keypoints_left,
            candidate.descriptors_left,
            query.keypoints_left,
            query.descriptors_left,
        )
        if len(m) == 0:
            return out
        ci = m.matches[:, 0]
        qi = m.matches[:, 1]
        nc, nq = candidate.stereo.shape[0], query.stereo.shape[0]
        ok = (ci >= 0) & (qi >= 0) & (ci < nc) & (qi < nq)
        ci, qi = ci[ok], qi[ok]
        ok = candidate.has_depth[ci] & query.has_depth[qi]
        ci, qi = ci[ok], qi[ok]
        if ci.shape[0] < self.params.min_inliers:
            return out  # too few correspondences to trust a loop

        # Candidate-frame 3D points and their measurements in the query.
        Xc = self.calib.backproject_cam_batch(candidate.stereo[ci])
        meas = query.stereo[qi]

        # Relative pose: the query camera in the candidate frame
        # (T_candidate_query), pose-only LM from identity.
        rel = self.verifier.track_arrays(Pose3(), Xc, meas)

        # Reprojection inliers on (uL, v) under the recovered pose.
        from .factors import batch_stereo_project

        proj, valid = batch_stereo_project(rel, self.calib, Xc)
        err = np.hypot(proj[:, 0] - meas[:, 0], proj[:, 2] - meas[:, 2])
        inliers = int(np.sum(valid & (err < self.params.inlier_px)))
        out.inliers = inliers
        if inliers < self.params.min_inliers:
            return out

        # Edge noise: tighter with more inliers, clamped, robustified.
        s = self.params.noise_base / np.sqrt(inliers)
        sigR = max(s, 0.02)
        sigT = max(s, 0.20)
        out.noise_sigmas = np.array([sigR, sigR, sigR, sigT, sigT, sigT])
        out.relative_pose = rel
        out.accepted = True
        return out

"""Stereo front-end: image pair -> StereoFrame.

Port of ``superslam_tpu/frontend/stereo_frontend.py`` (a copy: numpy over
the extractor and matcher interfaces), the equivalent of
``src/StereoFrontEnd.cc:10-49``: one batched L+R extract, a LightGlue
L<->R match, then the stereo gates — disparity >= min_disparity (1 px
default) and the rectified row check |vL - vR| <= 2 px. Unmatched
keypoints are kept as monocular (uR = NaN).
"""

from __future__ import annotations

import numpy as np

from ..core.frame import StereoFrame
from ..core.interfaces import FeatureExtractor, FeatureMatcher
from ..geometry.stereo_camera import StereoCalib
from ..utils.profiler import profile_scope


class StereoFrontEnd:
    def __init__(
        self,
        extractor: FeatureExtractor,
        matcher: FeatureMatcher,
        calib: StereoCalib,
        min_disparity: float = 1.0,
    ):
        self.extractor = extractor
        self.matcher = matcher
        self.calib = calib
        self.min_disparity = float(min_disparity)

    def process(
        self, left: np.ndarray, right: np.ndarray, timestamp: float
    ) -> StereoFrame:
        with profile_scope("fe_extract_stereo"):
            L, R = self.extractor.extract_stereo(left, right)

        n = L.keypoints.shape[0]
        stereo = np.empty((n, 3))
        stereo[:, 0] = L.keypoints[:, 0]
        stereo[:, 1] = np.nan  # default: monocular-only
        stereo[:, 2] = L.keypoints[:, 1]
        has_depth = np.zeros(n, dtype=bool)

        with profile_scope("fe_lg_stereo_match"):
            m = self.matcher.match(L.keypoints, L.descriptors, R.keypoints, R.descriptors)

        if len(m) > 0:
            i = m.matches[:, 0]
            j = m.matches[:, 1]
            ok = (i >= 0) & (j >= 0) & (i < n) & (j < R.keypoints.shape[0])
            i, j = i[ok], j[ok]
            uL = L.keypoints[i, 0]
            vL = L.keypoints[i, 1]
            uR = R.keypoints[j, 0]
            vR = R.keypoints[j, 1]
            gate = (uL - uR >= self.min_disparity) & (np.abs(vL - vR) <= 2.0)
            i = i[gate]
            stereo[i, 1] = uR[gate]
            has_depth[i] = True

        return StereoFrame(
            timestamp=timestamp,
            keypoints_left=L.keypoints,
            descriptors_left=L.descriptors,
            stereo=stereo,
            has_depth=has_depth,
            scores=L.scores,
        )

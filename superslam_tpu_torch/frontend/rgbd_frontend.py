"""RGB-D front-end: gray + depth -> StereoFrame.

Port of ``superslam_tpu/frontend/rgbd_frontend.py`` (numpy around the
port's extractor), the equivalent of ``src/RgbdFrontEnd.cc:23-58``: mono extract,
undistort keypoints (radtan), sample depth at the RAW pixel (uint16 /
depth_factor or float32), synthesize uR = uL - bf/Z for 0 < Z < max_depth.
The emitted StereoFrame uses the same backend as stereo.
"""

from __future__ import annotations

import numpy as np

from ..core.frame import StereoFrame
from ..core.interfaces import FeatureExtractor
from ..geometry.stereo_camera import StereoCalib
from ..io.undistort import undistort_points


class RgbdFrontEnd:
    def __init__(
        self,
        extractor: FeatureExtractor,
        calib: StereoCalib,
        depth_factor: float,
        max_depth: float,
        dist_coeffs: np.ndarray | None = None,
    ):
        self.extractor = extractor
        self.calib = calib
        self.depth_factor = float(depth_factor)
        self.max_depth = float(max_depth)
        self.dist_coeffs = (
            None
            if dist_coeffs is None or not np.any(np.asarray(dist_coeffs))
            else np.asarray(dist_coeffs, np.float64)
        )

    def _sample_depth(self, depth: np.ndarray, uv: np.ndarray) -> np.ndarray:
        """Depth at rounded RAW pixels; 0 outside the image."""
        u = np.rint(uv[:, 0]).astype(int)
        v = np.rint(uv[:, 1]).astype(int)
        ok = (u >= 0) & (v >= 0) & (u < depth.shape[1]) & (v < depth.shape[0])
        z = np.zeros(uv.shape[0])
        if depth.dtype == np.uint16:
            z[ok] = depth[v[ok], u[ok]].astype(np.float64) / self.depth_factor
        else:
            z[ok] = depth[v[ok], u[ok]].astype(np.float64) / self.depth_factor
        return z

    def process(
        self, gray: np.ndarray, depth: np.ndarray, timestamp: float
    ) -> StereoFrame:
        L = self.extractor.extract(gray)
        raw = L.keypoints.astype(np.float64).reshape(-1, 2)
        n = raw.shape[0]

        if self.dist_coeffs is not None and n > 0:
            undist = undistort_points(raw, self.calib, self.dist_coeffs)
        else:
            undist = raw

        Z = self._sample_depth(depth, raw)  # raw pixel: depth registered to raw
        bf = self.calib.bf
        stereo = np.empty((n, 3))
        stereo[:, 0] = undist[:, 0]
        stereo[:, 2] = undist[:, 1]
        valid = (Z > 0.0) & (Z < self.max_depth)
        stereo[:, 1] = np.where(valid, undist[:, 0] - bf / np.where(valid, Z, 1.0), np.nan)

        return StereoFrame(
            timestamp=timestamp,
            keypoints_left=undist.astype(np.float32),
            descriptors_left=L.descriptors,
            stereo=stereo,
            has_depth=valid,
            scores=L.scores,
        )

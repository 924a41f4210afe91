"""Per-frame currency of the whole system.

Equivalent of the reference StereoFrame
(``include/StereoFrame.h:15-26``): left keypoints,
device-resident descriptors, per-keypoint stereo measurement (uL, uR, v)
with uR = NaN when no stereo depth, has_depth flags, and a Twc pose.

On TPU the reference's DescriptorPool slot handle
(``include/DescriptorPool.h:62-76``) is replaced by an HBM-resident
``jax.Array`` (or a host numpy array in device-free tests): descriptors are
simply the output of one jitted program passed to the next, so the pool /
free-list / D2D-copy machinery of reference components 3-4 intentionally
disappears.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import numpy as np

from ..geometry.se3 import Pose3
from ..geometry.stereo_camera import StereoCalib


@dataclass
class StereoFrame:
    timestamp: float = 0.0
    keypoints_left: np.ndarray = field(default_factory=lambda: np.zeros((0, 2)))
    # Device- or host-resident [N, D] descriptors. jax.Array on the hot path.
    descriptors_left: Any = None
    stereo: np.ndarray = field(default_factory=lambda: np.zeros((0, 3)))
    has_depth: np.ndarray = field(default_factory=lambda: np.zeros(0, dtype=bool))
    scores: np.ndarray = field(default_factory=lambda: np.zeros(0))
    pose: Pose3 = field(default_factory=Pose3)  # Twc

    def __len__(self) -> int:
        return int(self.keypoints_left.shape[0])

    def backproject(self, i: int, calib: StereoCalib) -> np.ndarray:
        """World point for stereo feature i: Twc * camera-frame backprojection
        (StereoFrame.cc:5-13)."""
        uL, uR, v = self.stereo[i]
        return self.pose.transform_from(calib.backproject_cam(uL, uR, v))

    def backproject_all(self, calib: StereoCalib, indices: np.ndarray) -> np.ndarray:
        """Batched world points for the given stereo-valid feature rows."""
        pts_cam = calib.backproject_cam_batch(self.stereo[indices])
        return self.pose.transform_from(pts_cam)

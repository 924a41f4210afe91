"""Rectified stereo camera model with analytic pose Jacobians.

Equivalent of gtsam::Cal3_S2Stereo + gtsam::StereoCamera as used by the
reference factors (``include/PoseOptimizationFactors.h``)
and by StereoFrame::backproject (``src/StereoFrame.cc:5-13``).

A stereo measurement is ``(uL, uR, v)``. Pose is ``Twc`` (camera in world).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .se3 import Pose3, skew


class CheiralityError(Exception):
    """Point at or behind the camera plane."""


@dataclass(frozen=True)
class StereoCalib:
    """fx, fy, cx, cy in pixels; baseline in meters. skew assumed 0."""

    fx: float
    fy: float
    cx: float
    cy: float
    baseline: float

    @property
    def bf(self) -> float:
        return self.fx * self.baseline

    def backproject_cam(self, uL: float, uR: float, v: float) -> np.ndarray:
        """Stereo point -> camera-frame 3D point. Z = fx*b/(uL-uR)."""
        Z = self.fx * self.baseline / (uL - uR)
        X = (uL - self.cx) * Z / self.fx
        Y = (v - self.cy) * Z / self.fy
        return np.array([X, Y, Z])

    def backproject_cam_batch(self, stereo: np.ndarray) -> np.ndarray:
        """(N,3) rows of (uL,uR,v) -> (N,3) camera-frame points."""
        uL, uR, v = stereo[:, 0], stereo[:, 1], stereo[:, 2]
        Z = self.fx * self.baseline / (uL - uR)
        X = (uL - self.cx) * Z / self.fx
        Y = (v - self.cy) * Z / self.fy
        return np.stack([X, Y, Z], axis=1)


def stereo_project(
    pose: Pose3, calib: StereoCalib, Xw: np.ndarray
) -> np.ndarray:
    """Project world point into (uL, uR, v). Raises CheiralityError if Z<=0."""
    p = pose.transform_to(Xw)
    if p[2] <= 1e-9:
        raise CheiralityError
    x, y, z = p
    uL = calib.fx * x / z + calib.cx
    uR = calib.fx * (x - calib.baseline) / z + calib.cx
    v = calib.fy * y / z + calib.cy
    return np.array([uL, uR, v])


def stereo_project_jacobian(
    pose: Pose3, calib: StereoCalib, Xw: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Projection + 3x6 Jacobian wrt the pose tangent (right retraction).

    For pose' = pose * Exp(xi) with xi = (w, v):
      p_cam' ~= p_cam - w x p_cam - v
      => d p_cam / d w = [p_cam]x,  d p_cam / d v = -I
    Chained with the stereo pinhole projection Jacobian. Convention-identical
    to gtsam::StereoCamera::project2's pose block.

    Raises CheiralityError if the point is behind the camera.
    """
    p = pose.transform_to(Xw)
    if p[2] <= 1e-9:
        raise CheiralityError
    x, y, z = p
    iz = 1.0 / z
    iz2 = iz * iz
    fx, fy, b = calib.fx, calib.fy, calib.baseline
    uL = fx * x * iz + calib.cx
    uR = fx * (x - b) * iz + calib.cx
    v = fy * y * iz + calib.cy
    # d(uL,uR,v)/d p_cam
    Jp = np.array(
        [
            [fx * iz, 0.0, -fx * x * iz2],
            [fx * iz, 0.0, -fx * (x - b) * iz2],
            [0.0, fy * iz, -fy * y * iz2],
        ]
    )
    Dcam = np.hstack([skew(p), -np.eye(3)])  # 3x6: [d/dw, d/dv]
    return np.array([uL, uR, v]), Jp @ Dcam


def stereo_project_point_jacobian(
    pose: Pose3, calib: StereoCalib, Xw: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Projection + 3x3 Jacobian wrt the world point (for triangulation/BA).

    p_cam = R^T (Xw - t)  =>  d p_cam / d Xw = R^T.
    """
    p = pose.transform_to(Xw)
    if p[2] <= 1e-9:
        raise CheiralityError
    x, y, z = p
    iz = 1.0 / z
    iz2 = iz * iz
    fx, fy, b = calib.fx, calib.fy, calib.baseline
    uL = fx * x * iz + calib.cx
    uR = fx * (x - b) * iz + calib.cx
    v = fy * y * iz + calib.cy
    Jp = np.array(
        [
            [fx * iz, 0.0, -fx * x * iz2],
            [fx * iz, 0.0, -fx * (x - b) * iz2],
            [0.0, fy * iz, -fy * y * iz2],
        ]
    )
    return np.array([uL, uR, v]), Jp @ pose.R.T


def mono_project_jacobian(
    pose: Pose3, calib: StereoCalib, Xw: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Monocular (u, v) projection + 2x6 pose Jacobian (right retraction)."""
    p = pose.transform_to(Xw)
    if p[2] <= 1e-9:
        raise CheiralityError
    x, y, z = p
    iz = 1.0 / z
    iz2 = iz * iz
    fx, fy = calib.fx, calib.fy
    u = fx * x * iz + calib.cx
    v = fy * y * iz + calib.cy
    Jp = np.array(
        [
            [fx * iz, 0.0, -fx * x * iz2],
            [0.0, fy * iz, -fy * y * iz2],
        ]
    )
    Dcam = np.hstack([skew(p), -np.eye(3)])
    return np.array([u, v]), Jp @ Dcam

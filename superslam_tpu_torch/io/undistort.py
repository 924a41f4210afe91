"""Lens undistortion + stereo rectification (numpy; radtan model).

A copy of ``superslam_tpu/io/undistort.py`` (the port imports nothing of
the JAX package).

Covers the two places the reference touches distortion:
- RgbdFrontEnd's cv::undistortPoints (``src/RgbdFrontEnd.cc:36-40``)
- the EuRoC example's initUndistortRectifyMap-based stereo rectification
  (``examples/stereo/euroc.cc:89-135``).
"""

from __future__ import annotations

import numpy as np

from ..geometry.stereo_camera import StereoCalib


def _distort_normalized(xy: np.ndarray, dist: np.ndarray) -> np.ndarray:
    """Apply radtan (k1, k2, p1, p2[, k3]) to normalized coords (N, 2)."""
    k1, k2, p1, p2 = dist[0], dist[1], dist[2], dist[3]
    k3 = dist[4] if dist.shape[0] > 4 else 0.0
    x, y = xy[:, 0], xy[:, 1]
    r2 = x * x + y * y
    radial = 1.0 + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2
    xd = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    return np.stack([xd, yd], axis=1)


def undistort_points(
    pts: np.ndarray,
    calib: StereoCalib,
    dist: np.ndarray,
    iterations: int = 8,
) -> np.ndarray:
    """Iteratively invert the radtan model (cv::undistortPoints semantics,
    re-projected with the same K). pts: (N, 2) pixels -> (N, 2) pixels."""
    fx, fy, cx, cy = calib.fx, calib.fy, calib.cx, calib.cy
    xd = (pts[:, 0] - cx) / fx
    yd = (pts[:, 1] - cy) / fy
    target = np.stack([xd, yd], axis=1)
    xy = target.copy()
    for _ in range(iterations):
        d = _distort_normalized(xy, dist)
        xy = xy + (target - d)
    return np.stack([xy[:, 0] * fx + cx, xy[:, 1] * fy + cy], axis=1)


class RectifyMap:
    """Precomputed remap grid for stereo rectification (one per camera).

    Equivalent to cv::initUndistortRectifyMap + cv::remap with bilinear
    interpolation: for each rectified pixel, find the source pixel in the
    raw image through R_rect^T and the distortion model.
    """

    def __init__(
        self,
        K_raw: np.ndarray,  # 3x3 raw intrinsics
        dist: np.ndarray,  # radtan coeffs
        R_rect: np.ndarray,  # 3x3 rectifying rotation
        P_new: np.ndarray,  # 3x4 or 3x3 new projection
        width: int,
        height: int,
    ):
        P = np.asarray(P_new, np.float64)
        fx_n, fy_n = P[0, 0], P[1, 1]
        cx_n, cy_n = P[0, 2], P[1, 2]
        u, v = np.meshgrid(np.arange(width), np.arange(height))
        x = (u - cx_n) / fx_n
        y = (v - cy_n) / fy_n
        ones = np.ones_like(x)
        rays = np.stack([x, y, ones], axis=-1) @ np.linalg.inv(np.asarray(R_rect)).T
        xn = rays[..., 0] / rays[..., 2]
        yn = rays[..., 1] / rays[..., 2]
        xy = np.stack([xn.ravel(), yn.ravel()], axis=1)
        xyd = _distort_normalized(xy, np.asarray(dist, np.float64))
        K = np.asarray(K_raw, np.float64)
        self.map_x = (xyd[:, 0] * K[0, 0] + K[0, 2]).reshape(height, width)
        self.map_y = (xyd[:, 1] * K[1, 1] + K[1, 2]).reshape(height, width)
        self.width, self.height = width, height

    def remap(self, image: np.ndarray) -> np.ndarray:
        """Bilinear remap of a grayscale image."""
        img = np.asarray(image, np.float32)
        h, w = img.shape[:2]
        x = np.clip(self.map_x, 0, w - 1.001)
        y = np.clip(self.map_y, 0, h - 1.001)
        x0 = x.astype(int)
        y0 = y.astype(int)
        fx = (x - x0).astype(np.float32)
        fy = (y - y0).astype(np.float32)
        out = (
            img[y0, x0] * (1 - fx) * (1 - fy)
            + img[y0, x0 + 1] * fx * (1 - fy)
            + img[y0 + 1, x0] * (1 - fx) * fy
            + img[y0 + 1, x0 + 1] * fx * fy
        )
        if image.dtype == np.uint8:
            return np.clip(out + 0.5, 0, 255).astype(np.uint8)
        return out

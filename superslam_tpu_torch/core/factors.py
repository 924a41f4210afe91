"""Pose-only reprojection factors and noise models (vectorized, numpy).

Reimplements the behavior of the reference's custom GTSAM factors
(``include/PoseOptimizationFactors.h:33-137``):

- ``PoseOnlyStereoFactor``: 3 residuals (uL, uR, v), landmark fixed, analytic
  pose Jacobian; cheirality -> large constant residual + zero Jacobian
  instead of throwing, so the point is culled as an outlier.
- ``stereo_diag_sigmas``: diagonal (uL, uR, v) noise where sigma_uR grows
  smoothly as disparity -> 0 (far-point deweighting, no hard depth gate):
  ``sigma_uR = sigma_d0 * sqrt(1 + (d_cond/d)^2)``, ``d_cond = mbf/Z_cond``.

Unlike the reference (one factor object per match), evaluation here is
batched over all N matches at once: one (N,3) residual block and one
(N,3,6) Jacobian block per linearization. On a single host core this is the
difference between O(N) Python loops and three numpy GEMMs.
"""

from __future__ import annotations

import numpy as np

from ..geometry.se3 import Pose3
from ..geometry.stereo_camera import StereoCalib
from ..utils.env import env_float

HUBER_K = float(np.sqrt(7.815))  # chi2(3, 0.95), as in FrameTracker.cc:23


def disp_sigma_px() -> float:
    """Base disparity sigma (px); env SUPERSLAM_DISP_SIGMA_PX overrides."""
    return env_float("SUPERSLAM_DISP_SIGMA_PX", 8.0)


def stereo_cond_depth_m() -> float:
    """Depth beyond which stereo is deweighted; env overrides."""
    return env_float("SUPERSLAM_STEREO_COND_DEPTH_M", 40.0)


def stereo_diag_sigmas(
    sigma_px: float, disparity: np.ndarray, mbf: float
) -> np.ndarray:
    """Per-match (N,3) diagonal sigmas over (uL, uR, v).

    uL and v keep the matching-floor sigma; uR carries disparity (metric
    depth/scale) with smooth far-point release. Mirrors
    PoseOptimizationFactors.h:127-137.
    """
    disparity = np.asarray(disparity, dtype=np.float64)
    sigma_d0 = disp_sigma_px()
    d_cond = mbf / stereo_cond_depth_m()
    d = np.where(disparity > 1e-3, disparity, 1e-3)
    r = d_cond / d
    sigma_uR = sigma_d0 * np.sqrt(1.0 + r * r)
    n = disparity.shape[0]
    out = np.empty((n, 3))
    out[:, 0] = sigma_px
    out[:, 1] = sigma_uR
    out[:, 2] = sigma_px
    return out


def batch_stereo_project(
    pose: Pose3, calib: StereoCalib, Xw: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Project (N,3) world points -> (N,3) (uL,uR,v) and a validity mask.

    valid[i] is False for cheirality failures (Z <= 0); those rows hold
    garbage and must be masked by the caller.
    """
    p = pose.transform_to(Xw)  # (N,3) camera-frame
    z = p[:, 2]
    valid = z > 1e-9
    zs = np.where(valid, z, 1.0)
    iz = 1.0 / zs
    uL = calib.fx * p[:, 0] * iz + calib.cx
    uR = calib.fx * (p[:, 0] - calib.baseline) * iz + calib.cx
    v = calib.fy * p[:, 1] * iz + calib.cy
    return np.stack([uL, uR, v], axis=1), valid


def batch_stereo_factor(
    pose: Pose3,
    calib: StereoCalib,
    Xw: np.ndarray,
    meas: np.ndarray,
) -> tuple[np.ndarray, np.ndarray]:
    """Residuals and pose Jacobians for N pose-only stereo factors.

    Returns (r, J): r (N,3) = projection - measurement; J (N,3,6) wrt the
    right-retraction pose tangent [w, v]. Cheirality rows get the reference's
    escape hatch: residual = 2*fx (constant) and J = 0.
    """
    Xw = np.asarray(Xw, dtype=np.float64)
    meas = np.asarray(meas, dtype=np.float64)
    n = Xw.shape[0]
    p = pose.transform_to(Xw)  # (N,3)
    z = p[:, 2]
    valid = z > 1e-9
    zs = np.where(valid, z, 1.0)
    iz = 1.0 / zs
    iz2 = iz * iz
    fx, fy, b = calib.fx, calib.fy, calib.baseline
    x, y = p[:, 0], p[:, 1]

    proj = np.empty((n, 3))
    proj[:, 0] = fx * x * iz + calib.cx
    proj[:, 1] = fx * (x - b) * iz + calib.cx
    proj[:, 2] = fy * y * iz + calib.cy

    # d(uL,uR,v)/d p_cam, batched: (N,3,3)
    Jp = np.zeros((n, 3, 3))
    Jp[:, 0, 0] = fx * iz
    Jp[:, 0, 2] = -fx * x * iz2
    Jp[:, 1, 0] = fx * iz
    Jp[:, 1, 2] = -fx * (x - b) * iz2
    Jp[:, 2, 1] = fy * iz
    Jp[:, 2, 2] = -fy * y * iz2

    # d p_cam / d xi = [skew(p_cam), -I], batched: (N,3,6)
    Dcam = np.zeros((n, 3, 6))
    Dcam[:, 0, 1] = -p[:, 2]
    Dcam[:, 0, 2] = p[:, 1]
    Dcam[:, 1, 0] = p[:, 2]
    Dcam[:, 1, 2] = -p[:, 0]
    Dcam[:, 2, 0] = -p[:, 1]
    Dcam[:, 2, 1] = p[:, 0]
    Dcam[:, :, 3:] = -np.eye(3)

    J = np.einsum("nij,njk->nik", Jp, Dcam)
    r = proj - meas

    bad = ~valid
    if bad.any():
        r[bad] = 2.0 * fx
        J[bad] = 0.0
    return r, J


def batch_mono_factor(
    pose: Pose3,
    calib: StereoCalib,
    Xw: np.ndarray,
    meas: np.ndarray,
) -> tuple[np.ndarray, np.ndarray]:
    """Residuals and pose Jacobians for N pose-only MONOCULAR factors.

    The 2-residual (u, v) counterpart of batch_stereo_factor — equivalent to
    the reference's PoseOnlyProjectionFactor
    (PoseOptimizationFactors.h:33-68): landmark fixed, cheirality rows get
    residual 2*fx and zero Jacobian.
    """
    Xw = np.asarray(Xw, dtype=np.float64)
    meas = np.asarray(meas, dtype=np.float64)
    n = Xw.shape[0]
    p = pose.transform_to(Xw)
    z = p[:, 2]
    valid = z > 1e-9
    zs = np.where(valid, z, 1.0)
    iz = 1.0 / zs
    iz2 = iz * iz
    fx, fy = calib.fx, calib.fy
    x, y = p[:, 0], p[:, 1]

    proj = np.empty((n, 2))
    proj[:, 0] = fx * x * iz + calib.cx
    proj[:, 1] = fy * y * iz + calib.cy

    Jp = np.zeros((n, 2, 3))
    Jp[:, 0, 0] = fx * iz
    Jp[:, 0, 2] = -fx * x * iz2
    Jp[:, 1, 1] = fy * iz
    Jp[:, 1, 2] = -fy * y * iz2

    Dcam = np.zeros((n, 3, 6))
    Dcam[:, 0, 1] = -p[:, 2]
    Dcam[:, 0, 2] = p[:, 1]
    Dcam[:, 1, 0] = p[:, 2]
    Dcam[:, 1, 2] = -p[:, 0]
    Dcam[:, 2, 0] = -p[:, 1]
    Dcam[:, 2, 1] = p[:, 0]
    Dcam[:, :, 3:] = -np.eye(3)

    J = np.einsum("nij,njk->nik", Jp, Dcam)
    r = proj - meas
    bad = ~valid
    if bad.any():
        r[bad] = 2.0 * fx
        J[bad] = 0.0
    return r, J


def huber_weights(whitened: np.ndarray, k: float = HUBER_K) -> np.ndarray:
    """Per-factor Huber IRLS weights from whitened (N,D) residual blocks.

    GTSAM's robust noise model applies the m-estimator on the norm of the
    whitened residual: w = 1 for |e| <= k, k/|e| otherwise.
    """
    norms = np.linalg.norm(whitened, axis=-1)
    safe = np.where(norms > 1e-12, norms, 1.0)
    return np.where(norms <= k, 1.0, k / safe)


def huber_loss(whitened: np.ndarray, k: float = HUBER_K) -> float:
    """Total robust error 0.5 * sum rho(|e_i|) over factor blocks."""
    norms = np.linalg.norm(whitened, axis=-1)
    quad = 0.5 * norms**2
    lin = k * norms - 0.5 * k * k
    return float(np.sum(np.where(norms <= k, quad, lin)))

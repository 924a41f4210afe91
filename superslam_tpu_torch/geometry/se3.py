"""SO(3)/SE(3) Lie-group operations (numpy, float64 host path).

Conventions follow GTSAM's ``Pose3`` (the optimization currency of the
reference estimator, e.g. ``include/VoEstimator.h:34``):

- A pose is ``Twc`` = (R, t): ``transform_from(p) = R @ p + t`` maps
  camera-frame points to world.
- The tangent vector is **rotation-first**: ``xi = [wx, wy, wz, vx, vy, vz]``.
  Noise sigmas ordered ``(r, r, r, t, t, t)`` throughout the estimator match
  this (see ``src/VoEstimator.cc:33-38``).
- ``retract(T, xi) = T @ Expmap(xi)`` (right / body-frame perturbation), the
  GTSAM Pose3 default retraction.

Everything here is plain numpy: these ops run on the host inside the
device-free estimation core. The JAX mirrors used by the on-device solver
live in ``superslam_tpu.ops.lie``.
"""

from __future__ import annotations

import numpy as np

_EPS = 1e-10


def skew(w: np.ndarray) -> np.ndarray:
    """3-vector -> 3x3 skew-symmetric matrix [w]x."""
    wx, wy, wz = w
    return np.array(
        [
            [0.0, -wz, wy],
            [wz, 0.0, -wx],
            [-wy, wx, 0.0],
        ]
    )


def so3_expmap(w: np.ndarray) -> np.ndarray:
    """Rodrigues: axis-angle 3-vector -> rotation matrix."""
    theta2 = float(w @ w)
    W = skew(w)
    if theta2 < _EPS:
        return np.eye(3) + W + 0.5 * (W @ W)
    theta = np.sqrt(theta2)
    return (
        np.eye(3)
        + (np.sin(theta) / theta) * W
        + ((1.0 - np.cos(theta)) / theta2) * (W @ W)
    )


def so3_logmap(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> axis-angle 3-vector."""
    tr = np.trace(R)
    cos_theta = np.clip((tr - 1.0) * 0.5, -1.0, 1.0)
    theta = np.arccos(cos_theta)
    if theta < 1e-7:
        # First-order: R ~ I + [w]x
        return 0.5 * np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    if np.pi - theta < 1e-7:
        # Near pi: extract axis from the symmetric part.
        A = (R + np.eye(3)) * 0.5
        axis = np.sqrt(np.maximum(np.diag(A), 0.0))
        # Resolve signs from off-diagonals using the largest component.
        k = int(np.argmax(axis))
        if axis[k] < _EPS:
            return np.zeros(3)
        s = np.empty(3)
        s[k] = axis[k]
        for j in range(3):
            if j != k:
                s[j] = A[k, j] / axis[k]
        return theta * s / np.linalg.norm(s)
    w = (theta / (2.0 * np.sin(theta))) * np.array(
        [R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]]
    )
    return w


def _so3_left_jacobian(w: np.ndarray) -> np.ndarray:
    """Left Jacobian of SO(3): V such that Exp(w, v) translation = V @ v."""
    theta2 = float(w @ w)
    W = skew(w)
    if theta2 < _EPS:
        return np.eye(3) + 0.5 * W + (W @ W) / 6.0
    theta = np.sqrt(theta2)
    return (
        np.eye(3)
        + ((1.0 - np.cos(theta)) / theta2) * W
        + ((theta - np.sin(theta)) / (theta2 * theta)) * (W @ W)
    )


def _so3_left_jacobian_inv(w: np.ndarray) -> np.ndarray:
    theta2 = float(w @ w)
    W = skew(w)
    if theta2 < _EPS:
        return np.eye(3) - 0.5 * W + (W @ W) / 12.0
    theta = np.sqrt(theta2)
    half = 0.5 * theta
    cot = half / np.tan(half)
    return np.eye(3) - 0.5 * W + ((1.0 - cot) / theta2) * (W @ W)


class Pose3:
    """Rigid transform; immutable. Mirrors gtsam::Pose3 semantics."""

    __slots__ = ("R", "t")

    def __init__(self, R: np.ndarray | None = None, t: np.ndarray | None = None):
        self.R = np.eye(3) if R is None else np.asarray(R, dtype=np.float64)
        self.t = np.zeros(3) if t is None else np.asarray(t, dtype=np.float64).reshape(3)

    # -- constructors ------------------------------------------------------
    @staticmethod
    def identity() -> "Pose3":
        return Pose3()

    @staticmethod
    def expmap(xi: np.ndarray) -> "Pose3":
        """SE(3) exponential. xi = [w, v] (rotation-first)."""
        xi = np.asarray(xi, dtype=np.float64).reshape(6)
        w, v = xi[:3], xi[3:]
        R = so3_expmap(w)
        t = _so3_left_jacobian(w) @ v
        return Pose3(R, t)

    @staticmethod
    def from_matrix(M: np.ndarray) -> "Pose3":
        M = np.asarray(M, dtype=np.float64)
        return Pose3(M[:3, :3], M[:3, 3])

    # -- group ops ---------------------------------------------------------
    def compose(self, other: "Pose3") -> "Pose3":
        return Pose3(self.R @ other.R, self.R @ other.t + self.t)

    def __mul__(self, other: "Pose3") -> "Pose3":
        return self.compose(other)

    def inverse(self) -> "Pose3":
        Rt = self.R.T
        return Pose3(Rt, -Rt @ self.t)

    def between(self, other: "Pose3") -> "Pose3":
        """self^-1 * other (gtsam::Pose3::between)."""
        return self.inverse().compose(other)

    def logmap(self) -> np.ndarray:
        """SE(3) log. Returns [w, v]."""
        w = so3_logmap(self.R)
        v = _so3_left_jacobian_inv(w) @ self.t
        return np.concatenate([w, v])

    def retract(self, xi: np.ndarray) -> "Pose3":
        """Right (body-frame) retraction: self * Expmap(xi)."""
        return self.compose(Pose3.expmap(xi))

    def local(self, other: "Pose3") -> np.ndarray:
        """Inverse retraction: Logmap(self^-1 * other)."""
        return self.between(other).logmap()

    # -- actions -----------------------------------------------------------
    def transform_from(self, p: np.ndarray) -> np.ndarray:
        """Camera/body frame -> world. Supports (3,) or (N, 3)."""
        p = np.asarray(p, dtype=np.float64)
        if p.ndim == 1:
            return self.R @ p + self.t
        return p @ self.R.T + self.t

    def transform_to(self, p: np.ndarray) -> np.ndarray:
        """World -> camera/body frame. Supports (3,) or (N, 3)."""
        p = np.asarray(p, dtype=np.float64)
        if p.ndim == 1:
            return self.R.T @ (p - self.t)
        return (p - self.t) @ self.R

    # -- adjoint / misc ----------------------------------------------------
    def adjoint(self) -> np.ndarray:
        """6x6 Adjoint with [w, v] ordering."""
        A = np.zeros((6, 6))
        A[:3, :3] = self.R
        A[3:, 3:] = self.R
        A[3:, :3] = skew(self.t) @ self.R
        return A

    def matrix(self) -> np.ndarray:
        M = np.eye(4)
        M[:3, :3] = self.R
        M[:3, 3] = self.t
        return M

    def is_finite(self) -> bool:
        return bool(np.isfinite(self.R).all() and np.isfinite(self.t).all())

    def translation_norm(self) -> float:
        return float(np.linalg.norm(self.t))

    def __repr__(self) -> str:  # pragma: no cover
        return f"Pose3(t={self.t}, rpy~{so3_logmap(self.R)})"

"""Trajectory export in KITTI and TUM formats.

Equivalent of ``src/SuperSLAM.cc:191-219``:
- KITTI: one 3x4 row-major Twc matrix per line.
- TUM: ``timestamp tx ty tz qx qy qz qw`` (Twc, Hamilton quaternion).
Plus a PLY point-cloud writer for save_map (SuperSLAM.cc:221-236).
"""

from __future__ import annotations

import numpy as np

from ..geometry.se3 import Pose3


def rotation_to_quaternion(R: np.ndarray) -> np.ndarray:
    """3x3 -> (qx, qy, qz, qw), Hamilton, normalized."""
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        qw = 0.25 * s
        qx = (R[2, 1] - R[1, 2]) / s
        qy = (R[0, 2] - R[2, 0]) / s
        qz = (R[1, 0] - R[0, 1]) / s
    elif R[0, 0] > R[1, 1] and R[0, 0] > R[2, 2]:
        s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
        qw = (R[2, 1] - R[1, 2]) / s
        qx = 0.25 * s
        qy = (R[0, 1] + R[1, 0]) / s
        qz = (R[0, 2] + R[2, 0]) / s
    elif R[1, 1] > R[2, 2]:
        s = np.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2
        qw = (R[0, 2] - R[2, 0]) / s
        qx = (R[0, 1] + R[1, 0]) / s
        qy = 0.25 * s
        qz = (R[1, 2] + R[2, 1]) / s
    else:
        s = np.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2
        qw = (R[1, 0] - R[0, 1]) / s
        qx = (R[0, 2] + R[2, 0]) / s
        qy = (R[1, 2] + R[2, 1]) / s
        qz = 0.25 * s
    q = np.array([qx, qy, qz, qw])
    return q / np.linalg.norm(q)


def save_trajectory_kitti(path: str, poses: list[Pose3]) -> None:
    with open(path, "w") as f:
        for p in poses:
            M = p.matrix()[:3, :]  # 3x4 Twc row-major
            f.write(" ".join(f"{v:.9e}" for v in M.ravel()) + "\n")


def save_trajectory_tum(
    path: str, poses: list[Pose3], timestamps: list[float]
) -> None:
    with open(path, "w") as f:
        for t, p in zip(timestamps, poses):
            q = rotation_to_quaternion(p.R)
            f.write(
                f"{t:.6f} {p.t[0]:.7f} {p.t[1]:.7f} {p.t[2]:.7f} "
                f"{q[0]:.7f} {q[1]:.7f} {q[2]:.7f} {q[3]:.7f}\n"
            )


def load_trajectory_kitti(path: str) -> list[Pose3]:
    poses = []
    with open(path) as f:
        for line in f:
            vals = np.fromstring(line, sep=" ")
            if vals.size != 12:
                continue
            M = vals.reshape(3, 4)
            poses.append(Pose3(M[:, :3], M[:, 3]))
    return poses


def load_trajectory_tum(path: str) -> tuple[list[float], list[Pose3]]:
    ts, poses = [], []
    with open(path) as f:
        for line in f:
            if line.startswith("#"):
                continue
            vals = np.fromstring(line, sep=" ")
            if vals.size < 8:
                continue
            t, tx, ty, tz, qx, qy, qz, qw = vals[:8]
            n = np.linalg.norm([qx, qy, qz, qw])
            qx, qy, qz, qw = qx / n, qy / n, qz / n, qw / n
            R = np.array(
                [
                    [
                        1 - 2 * (qy * qy + qz * qz),
                        2 * (qx * qy - qz * qw),
                        2 * (qx * qz + qy * qw),
                    ],
                    [
                        2 * (qx * qy + qz * qw),
                        1 - 2 * (qx * qx + qz * qz),
                        2 * (qy * qz - qx * qw),
                    ],
                    [
                        2 * (qx * qz - qy * qw),
                        2 * (qy * qz + qx * qw),
                        1 - 2 * (qx * qx + qy * qy),
                    ],
                ]
            )
            ts.append(float(t))
            poses.append(Pose3(R, np.array([tx, ty, tz])))
    return ts, poses


def save_map_ply(path: str, cloud: np.ndarray) -> None:
    """ASCII PLY point cloud (save_map equivalent)."""
    with open(path, "w") as f:
        f.write(
            "ply\nformat ascii 1.0\n"
            f"element vertex {cloud.shape[0]}\n"
            "property float x\nproperty float y\nproperty float z\n"
            "end_header\n"
        )
        for p in cloud:
            f.write(f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f}\n")

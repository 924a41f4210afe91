"""3D viewer / run recorder.

Port of ``superslam_tpu/io/viewer.py``, the equivalent of the reference
RerunViewer (``src/RerunViewer.cc``): streams the live trajectory, the
per-frame stereo cloud, text logs, and scalar series. When the rerun SDK
is importable it streams to a viewer (or records to .rrd when
SUPERSLAM_RRD is set, matching the reference's headless mode); otherwise
it falls back to a matplotlib recorder that writes a trajectory plot on
close(); where matplotlib is missing too, close() logs a warning and
returns (a display never takes down tracking).
"""

from __future__ import annotations

import os

import numpy as np

from ..geometry.se3 import Pose3
from ..geometry.stereo_camera import StereoCalib
from ..utils.logging import get_logger


class RerunViewer:
    def __init__(self, app_name: str = "superslam_tpu"):
        self._traj: list[np.ndarray] = []
        self._scalars: dict[str, list[tuple[int, float]]] = {}
        self._frame = 0
        self._rr = None
        try:
            import rerun as rr  # optional dependency

            rr.init(app_name)
            rrd = os.environ.get("SUPERSLAM_RRD")
            if rrd:
                rr.save(rrd)
            else:
                rr.spawn()
            self._rr = rr
            try:
                # Static series registration, mirroring the reference's
                # RerunViewer.cc:33-41 names/styling.
                rr.log_static(
                    "plots/loop_deep_score",
                    rr.SeriesLine(color=[255, 64, 64], name="Loop deep score"),
                )
                rr.log_static(
                    "plots/frontend_inlier_ratio",
                    rr.SeriesLine(
                        color=[64, 200, 64],
                        name="Frontend landmark inlier ratio",
                    ),
                )
            except Exception:
                pass  # older rerun SDKs; per-point logging still works
        except Exception:
            get_logger().info(
                "rerun SDK unavailable; falling back to matplotlib recorder"
            )

    def draw_frame(self, frame, pose: Pose3, calib: StereoCalib) -> None:
        self._frame += 1
        self._traj.append(pose.t.copy())
        cloud = None
        idx = np.flatnonzero(frame.has_depth)
        if idx.size:
            pts_cam = calib.backproject_cam_batch(frame.stereo[idx])
            cloud = pose.transform_from(pts_cam)
        if self._rr is not None:
            rr = self._rr
            rr.set_time_sequence("frame", self._frame)
            rr.log("world/trajectory", rr.LineStrips3D([np.stack(self._traj)]))
            if cloud is not None:
                rr.log("world/cloud", rr.Points3D(cloud))

    def log_info(self, component: str, message: str) -> None:
        if self._rr is not None:
            self._rr.log(f"logs/{component}", self._rr.TextLog(message))
        else:
            get_logger().info("[%s] %s", component, message)

    def plot(self, series: str, value: float) -> None:
        self._scalars.setdefault(series, []).append((self._frame, float(value)))
        if self._rr is not None:
            self._rr.log(f"plots/{series}", self._rr.Scalar(float(value)))

    def close(self, out_path: str | None = None) -> None:
        if self._rr is not None or not self._traj:
            return
        out = out_path or os.environ.get("SUPERSLAM_VIEWER_PLOT", "trajectory.png")
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt

            t = np.stack(self._traj)
            n_plots = 1 + len(self._scalars)
            fig, axes = plt.subplots(1, n_plots, figsize=(6 * n_plots, 5))
            axes = np.atleast_1d(axes)
            axes[0].plot(t[:, 0], t[:, 2], "b-")
            axes[0].set_title("trajectory (x-z)")
            axes[0].set_aspect("equal")
            for ax, (name, vals) in zip(axes[1:], self._scalars.items()):
                v = np.array(vals)
                ax.plot(v[:, 0], v[:, 1])
                ax.set_title(name)
            fig.savefig(out, dpi=110)
            get_logger().info("viewer plot -> %s", out)
        except Exception as e:  # viewer must never take down tracking
            get_logger().warning("viewer plot failed: %s", e)

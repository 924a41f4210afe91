"""The SuperSLAM facade of the port: stereo, synchronous, host-solved.

Port of ``superslam_tpu/slam.py`` for the first slice: YAML config ->
env bridging -> calibration -> one fused SuperPoint + LightGlue step per
frame on the device (``frontend/fused.py``), the host ``VoEstimator``
(FrameTracker, WindowSmoother, keyframe gate) and trajectory/map export.

Not ported yet, and refused with ``NotImplementedError`` rather than run
differently (ROADMAP queue 1):
- RGB-D configs (``DepthMapFactor``);
- loop closure (``SUPERSLAM_ENABLE_LOOP`` with a ``loop:`` block);
- the pipelined tracker (``SUPERSLAM_PIPELINE`` > 1); the port's default
  pipeline depth is 0, the synchronous loop;
- device tracking (``SUPERSLAM_DEVICE_TRACKER`` truthy).

The facade runs on CUDA unless ``device="cpu"`` is given; without a GPU
and without that argument it raises.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .config import Config, apply_tuning_overrides, read_calib
from .core.vo_estimator import VoEstimator
from .frontend.fused import FusedStereoPipeline
from .frontend.matcher import LightGlueMatcher
from .geometry.se3 import Pose3
from .io.trajectory import save_map_ply, save_trajectory_kitti, save_trajectory_tum
from .models.lightglue import init_lightglue_params
from .models.superpoint import init_superpoint_params
from .models.weights import load_params
from .utils.device import resolve_device
from .utils.env import device_tracker_wanted


class SuperSLAM:
    def __init__(self, config_path: str, device="cuda"):
        self.device = resolve_device(device)
        cfg = Config.load(config_path)
        self.cfg = cfg
        if cfg.has("DepthMapFactor"):
            raise NotImplementedError(
                "RGB-D (DepthMapFactor) is not ported to superslam_tpu_torch yet "
                "(ROADMAP queue 1, RGB-D)"
            )
        if os.environ.get("SUPERSLAM_ENABLE_LOOP") and cfg.get("loop") is not None:
            raise NotImplementedError(
                "loop closure is not ported to superslam_tpu_torch yet "
                "(ROADMAP queue 1, loop closure)"
            )
        depth = int(os.environ.get("SUPERSLAM_PIPELINE", "0"))
        if depth > 1:
            raise NotImplementedError(
                f"SUPERSLAM_PIPELINE={depth}: the pipelined tracker is not ported "
                "to superslam_tpu_torch yet (ROADMAP queue 1, pipelined tracker); "
                "the port runs the synchronous loop (depth 0)"
            )
        if device_tracker_wanted():
            raise NotImplementedError(
                "SUPERSLAM_DEVICE_TRACKER: device tracking is not ported to "
                "superslam_tpu_torch yet (ROADMAP queue 1, pipelined tracker)"
            )
        apply_tuning_overrides(cfg)
        self.calib = read_calib(cfg)

        model_dir = str(cfg.get("SuperPoint.model_dir", "weights/"))
        sp_max_kp = int(cfg.get("superpoint.max_keypoints", 1024))
        sp_thresh = float(cfg.get("superpoint.keypoint_threshold", 0.005))
        sp_borders = int(cfg.get("superpoint.remove_borders", 4))
        lg_w = int(cfg.get("lightglue.image_width", cfg.get("Camera.width", 640)))
        lg_h = int(cfg.get("lightglue.image_height", cfg.get("Camera.height", 480)))
        lg_thresh = float(cfg.get("lightglue.match_threshold", 0.1))

        def weights(block: str, default_name: str) -> str | None:
            name = cfg.get(f"{block}.weights_file", default_name)
            return os.path.join(model_dir, name) if name else None

        sp_params = load_params(
            weights("superpoint", "superpoint_v1.safetensors"),
            lambda: init_superpoint_params(),
            self.device,
        )
        lg_file = weights("lightglue", "lightglue_superpoint.safetensors")
        if lg_file and os.path.basename(lg_file) == "__passthrough__":
            # Sentinel: the analytically constructed mutual-nearest-neighbour
            # matcher (init_lightglue_params(passthrough=True)).
            lg_params = init_lightglue_params(passthrough=True, device=self.device)
        else:
            lg_params = load_params(lg_file, lambda: init_lightglue_params(), self.device)

        # One matcher shared by the estimator's re-match paths.
        self.matcher = LightGlueMatcher(
            lg_params,
            image_width=lg_w,
            image_height=lg_h,
            max_keypoints=sp_max_kp,
            threshold=lg_thresh,
            device=self.device,
        )
        # Hot path: the fused one-step/one-readback pipeline.
        self.pipeline = FusedStereoPipeline(
            sp_params,
            lg_params,
            self.calib,
            width=lg_w,
            height=lg_h,
            max_keypoints=sp_max_kp,
            keypoint_threshold=sp_thresh,
            remove_borders=sp_borders,
            match_threshold=lg_thresh,
            device=self.device,
        )
        window_size = int(cfg.get("Backend.window_size", 0) or 0)
        self.estimator = VoEstimator(self.matcher, self.calib, window_size)
        self.estimator.set_keyframe_params(
            float(cfg.get("KeyFrame.covis_ratio", 0.7)),
            int(cfg.get("KeyFrame.max_frames", 20)),
        )
        self._timestamps: list[float] = []
        self._live_poses: list[Pose3] = []

    # -- tracking -------------------------------------------------------------
    def track_stereo(
        self, left: np.ndarray, right: np.ndarray, timestamp: float
    ) -> np.ndarray:
        """Track one stereo pair; returns the 4x4 Tcw matrix."""
        frame, kf_matches = self.pipeline.process(left, right, timestamp)
        pose = self.estimator.track(frame, None, kf_matches=kf_matches)
        # If this frame became the keyframe, its device features become the
        # pipeline's track-match reference.
        if self.estimator._last_keyframe is frame:
            self.pipeline.set_keyframe(frame.descriptors_left)
        self._timestamps.append(timestamp)
        self._live_poses.append(pose)
        return pose.inverse().matrix()

    def track_rgbd(self, gray: np.ndarray, depth: np.ndarray, timestamp: float):
        raise NotImplementedError(
            "RGB-D is not ported to superslam_tpu_torch yet (ROADMAP queue 1, RGB-D)"
        )

    # -- outputs --------------------------------------------------------------
    def loop_closure_count(self) -> int:
        return self.estimator.loop_closure_count()

    def save_trajectory(self, path: str, fmt: str = "kitti") -> None:
        self.estimator.stop_loop_worker()
        traj = self.estimator.corrected_trajectory()
        if fmt.lower() == "kitti":
            save_trajectory_kitti(path, traj)
        elif fmt.lower() == "tum":
            save_trajectory_tum(path, traj, self._timestamps)
        else:
            raise ValueError(f"unknown trajectory format: {fmt}")

    def save_map(self, path: str) -> None:
        self.estimator.stop_loop_worker()
        save_map_ply(path, self.estimator.map.cloud(self.estimator.anchors()))

    def shutdown(self) -> None:
        self.estimator.stop_loop_worker()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

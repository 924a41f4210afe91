"""The SuperSLAM facade of the port: stereo, pipelined, device-tracked on
the card.

Port of ``superslam_tpu/slam.py``: YAML config -> env bridging ->
calibration -> the fused SuperPoint + LightGlue step on the device
(``frontend/fused.py``), the host ``VoEstimator`` (FrameTracker,
WindowSmoother, keyframe gate) and trajectory/map export. The defaults
are the JAX package's with its TPU replaced by the card:
``SUPERSLAM_PIPELINE`` depth 3 (``frontend/pipelined.py``; 0 or 1 is the
synchronous loop), ``SUPERSLAM_PIPELINE_BATCH`` 1, and device tracking with
zero-lag device keyframes on a CUDA device, host-solved on the CPU
(``utils/env.py::device_tracker_wanted``, ``SUPERSLAM_DEVICE_KF``).

Not ported yet, and refused with ``NotImplementedError`` rather than run
differently (ROADMAP queue 1):
- RGB-D configs (``DepthMapFactor``);
- loop closure (``SUPERSLAM_ENABLE_LOOP`` with a ``loop:`` block).
The viewer is absent.

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
from .frontend.pipelined import PipelinedStereoTracker
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

        # Pipelined tracking (SUPERSLAM_PIPELINE=depth, default 3): the host
        # estimator runs while later frames' steps are on the device; the
        # per-call return is the constant-velocity prediction and
        # corrected_trajectory() stays exact. SUPERSLAM_PIPELINE=0 forces the
        # synchronous loop. SUPERSLAM_PIPELINE_BATCH=S puts S frames in one
        # step and one readback.
        self._tracker = None
        depth = int(os.environ.get("SUPERSLAM_PIPELINE", "3"))
        batch = int(os.environ.get("SUPERSLAM_PIPELINE_BATCH", "1"))
        if depth > 1:
            self._tracker = PipelinedStereoTracker(
                self.pipeline,
                self.estimator,
                depth=depth,
                batch=max(1, batch),
                device_tracking=device_tracker_wanted(self.device),
            )

    # -- tracking -------------------------------------------------------------
    def track_stereo(
        self, left: np.ndarray, right: np.ndarray, timestamp: float
    ) -> np.ndarray:
        """Track one stereo pair; returns the 4x4 Tcw matrix (with the
        pipelined tracker, the constant-velocity prediction for this frame;
        the estimate lands within depth x batch frames)."""
        if self._tracker is not None:
            pose = self._tracker.track(left, right, timestamp)
            self._timestamps.append(timestamp)
            self._live_poses.append(pose)
            return pose.inverse().matrix()
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

    def flush(self) -> None:
        """Drain the pipelined tracker (nothing to do when synchronous)."""
        if self._tracker is not None:
            self._tracker.flush()

    def save_trajectory(self, path: str, fmt: str = "kitti") -> None:
        self.flush()
        self.estimator.stop_loop_worker()
        traj = self.estimator.corrected_trajectory()
        if fmt.lower() == "kitti":
            save_trajectory_kitti(path, traj)
        elif fmt.lower() == "tum":
            save_trajectory_tum(path, traj, self._timestamps)
        else:
            raise ValueError(f"unknown trajectory format: {fmt}")

    def save_map(self, path: str) -> None:
        self.flush()
        self.estimator.stop_loop_worker()
        save_map_ply(path, self.estimator.map.cloud(self.estimator.anchors()))

    def shutdown(self) -> None:
        self.flush()
        self.estimator.stop_loop_worker()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

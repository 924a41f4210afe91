"""The SuperSLAM facade of the port: stereo and RGB-D, pipelined,
device-tracked on the card, with optional loop closure.

Port of ``superslam_tpu/slam.py``: YAML config -> env bridging ->
calibration -> the fused SuperPoint + LightGlue step on the device
(``frontend/fused.py`` for stereo, ``frontend/fused_rgbd.py`` for RGB-D,
selected by the presence of ``DepthMapFactor``), the host ``VoEstimator``
(FrameTracker, WindowSmoother, keyframe gate) and trajectory/map export.
The defaults are the JAX package's with its TPU replaced by the card:
``SUPERSLAM_PIPELINE`` depth 3 (``frontend/pipelined.py``,
``frontend/pipelined_rgbd.py``; 0 or 1 is the synchronous loop),
``SUPERSLAM_PIPELINE_BATCH`` 1, and device tracking on a CUDA device,
host-solved on the CPU (``utils/env.py::device_tracker_wanted``): stereo
with zero-lag device keyframes (``SUPERSLAM_DEVICE_KF``), RGB-D with the
dispatch-frozen mono chain.

Loop closure (``SUPERSLAM_ENABLE_LOOP`` with a ``loop:`` block): EigenPlaces
(``frontend/recognizer.py``) and a dedicated LightGlue matcher for the
loop worker's geometric verification, behind the estimator's async
worker; the pipelined trackers hand the worker each keyframe's device
upload for its descriptor. Unlike the JAX facade, a failing loop init
raises instead of carrying on VO-only (a missing weights file still falls
back to a random init inside ``load_params``).

``use_viewer=True`` attaches ``io/viewer.py::RerunViewer`` and, as in the
JAX facade, forces the synchronous loop (depth 0) so every frame is drawn.
``SUPERSLAM_XLA_SMOOTHER=1`` solves each window on the facade's device
(``ops/window_solver.py``).

The facade runs on CUDA unless ``device="cpu"`` is given; without a GPU
and without that argument it raises.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .config import Config, apply_tuning_overrides, read_calib, read_dist_coeffs
from .core.loop_closer import LoopCloser, LoopParams
from .core.vo_estimator import VoEstimator
from .frontend.fused import FusedStereoPipeline
from .frontend.fused_rgbd import FusedRgbdPipeline
from .frontend.matcher import LightGlueMatcher
from .frontend.pipelined import PipelinedStereoTracker
from .frontend.pipelined_rgbd import PipelinedRgbdTracker
from .frontend.recognizer import EigenPlacesRecognizer
from .geometry.se3 import Pose3
from .io.trajectory import save_map_ply, save_trajectory_kitti, save_trajectory_tum
from .io.viewer import RerunViewer
from .models.eigenplaces import init_eigenplaces_params
from .models.lightglue import init_lightglue_params
from .models.superpoint import init_superpoint_params
from .models.weights import load_params
from .utils.device import resolve_device
from .utils.env import device_tracker_wanted


class SuperSLAM:
    def __init__(self, config_path: str, use_viewer: bool = False, device="cuda"):
        self.device = resolve_device(device)
        cfg = Config.load(config_path)
        self.cfg = cfg
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

        def matcher() -> LightGlueMatcher:
            return LightGlueMatcher(
                lg_params,
                image_width=lg_w,
                image_height=lg_h,
                max_keypoints=sp_max_kp,
                threshold=lg_thresh,
                device=self.device,
            )

        # One matcher shared by the estimator's re-match paths.
        self.matcher = matcher()
        # Stereo vs RGB-D keyed on DepthMapFactor (SuperSLAM.cc:89-108). Hot
        # path: the fused one-step/one-readback pipeline of either mode.
        self._rgbd = cfg.has("DepthMapFactor")
        self.pipeline = self.rgbd_pipeline = None
        if self._rgbd:
            self.rgbd_pipeline = FusedRgbdPipeline(
                sp_params,
                lg_params,
                self.calib,
                width=lg_w,
                height=lg_h,
                depth_factor=float(cfg.get("DepthMapFactor")),
                max_depth=float(cfg.get("ThDepth", 40.0)) * self.calib.baseline,
                dist_coeffs=read_dist_coeffs(cfg),
                max_keypoints=sp_max_kp,
                keypoint_threshold=sp_thresh,
                remove_borders=sp_borders,
                match_threshold=lg_thresh,
                device=self.device,
            )
        else:
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
        self.estimator = VoEstimator(self.matcher, self.calib, window_size, device=self.device)
        self.estimator.set_keyframe_params(
            float(cfg.get("KeyFrame.covis_ratio", 0.7)),
            int(cfg.get("KeyFrame.max_frames", 20)),
        )

        # Optional pose-graph loop closure (SuperSLAM.cc:119-143). No catch:
        # a failed init raises rather than running VO-only unnoticed.
        self.loop_enabled = False
        self._recognizer = None
        if os.environ.get("SUPERSLAM_ENABLE_LOOP") and cfg.get("loop") is not None:
            ep_params = load_params(
                weights("loop", "eigenplaces_resnet18_512.safetensors"),
                lambda: init_eigenplaces_params(),
                self.device,
            )
            self._recognizer = EigenPlacesRecognizer(
                ep_params, image_size=int(cfg.get("loop.image_width", 512)), device=self.device
            )
            params = LoopParams()
            if cfg.get("loop.min_inliers") is not None:
                params.min_inliers = int(cfg.get("loop.min_inliers"))
            if cfg.get("loop.min_score") is not None:
                params.min_score = float(cfg.get("loop.min_score"))
            # A dedicated matcher instance for the loop worker's thread.
            lc = LoopCloser(matcher(), self.calib, self._recognizer, params)
            self.estimator.enable_loop_closure(lc, async_=True)
            self.loop_enabled = True

        # The viewer (optional rerun SDK, else the matplotlib recorder). No
        # catch: RerunViewer itself degrades to the recorder.
        self.viewer = RerunViewer() if use_viewer else None

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
        if use_viewer:
            depth = 0  # the viewer draws every frame: stay synchronous
        # Loop descriptors straight from the device-resident frame: the
        # pipelined trackers hand the worker a closure over the step's own
        # uint8 upload instead of a host gray copy.
        loop_fn = None
        if self._recognizer is not None:
            rec = self._recognizer

            def loop_fn(gray_dev, _rec=rec, _h=lg_h, _w=lg_w):
                return _rec.compute_global_descriptor_from_device(gray_dev, _h, _w)

        if depth > 1:
            tracker = PipelinedRgbdTracker if self._rgbd else PipelinedStereoTracker
            self._tracker = tracker(
                self.rgbd_pipeline if self._rgbd else self.pipeline,
                self.estimator,
                depth=depth,
                batch=max(1, batch),
                device_tracking=device_tracker_wanted(self.device),
                loop_descriptor_fn=loop_fn,
            )

    # -- tracking -------------------------------------------------------------
    def track_stereo(
        self, left: np.ndarray, right: np.ndarray, timestamp: float
    ) -> np.ndarray:
        """Track one stereo pair; returns the 4x4 Tcw matrix (with the
        pipelined tracker, the constant-velocity prediction for this frame;
        the estimate lands within depth x batch frames)."""
        if self._tracker is not None:
            return self._record(self._tracker.track(left, right, timestamp), timestamp)
        frame, kf_matches = self.pipeline.process(left, right, timestamp)
        gray = left if self.loop_enabled else None
        pose = self.estimator.track(frame, gray, kf_matches=kf_matches)
        # If this frame became the keyframe, its device features become the
        # pipeline's track-match reference.
        if self.estimator._last_keyframe is frame:
            self.pipeline.set_keyframe(frame.descriptors_left)
        self._draw(frame, pose)
        return self._record(pose, timestamp)

    def track_rgbd(self, gray: np.ndarray, depth: np.ndarray, timestamp: float) -> np.ndarray:
        """Track one gray + depth frame; returns the 4x4 Tcw matrix, as
        track_stereo."""
        if self._tracker is not None:
            return self._record(self._tracker.track(gray, depth, timestamp), timestamp)
        frame, kf_matches = self.rgbd_pipeline.process(gray, depth, timestamp)
        img = gray if self.loop_enabled else None
        pose = self.estimator.track(frame, img, kf_matches=kf_matches)
        if self.estimator._last_keyframe is frame:
            self.rgbd_pipeline.set_keyframe(frame.descriptors_left)
        self._draw(frame, pose)
        return self._record(pose, timestamp)

    def _draw(self, frame, pose: Pose3) -> None:
        if self.viewer is None:
            return
        self.viewer.draw_frame(frame, pose, self.calib)
        # the reference RerunViewer's two scalar series
        self.viewer.plot("frontend_inlier_ratio", self.estimator.last_inlier_ratio)
        if self.loop_enabled:
            self.viewer.plot("loop_deep_score", self.estimator.last_loop_score)

    def _record(self, pose: Pose3, timestamp: float) -> np.ndarray:
        self._timestamps.append(timestamp)
        self._live_poses.append(pose)
        return pose.inverse().matrix()

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
        if self.viewer is not None:
            self.viewer.close()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

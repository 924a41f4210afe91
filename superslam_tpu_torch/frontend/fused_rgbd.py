"""Fused RGB-D pipeline: one device step and one readback a frame, depth
sampled on the host (the sensor depth image never goes to the device).

Port of ``superslam_tpu/frontend/fused_rgbd.py``. It produces the same
(StereoFrame, frame-to-keyframe MatchResult) pair the unfused RgbdFrontEnd
+ matcher path produces; the estimator cannot tell the difference. The
uint8 frame goes through the stereo pipeline's ring of pinned slots
(``fused.UploadRing``) for one image instead of a pair, anything else
through ``fused.to_device``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.frame import StereoFrame
from ..core.interfaces import MatchResult
from ..geometry.stereo_camera import StereoCalib
from ..io.undistort import undistort_points
from ..models.lightglue import prepare_params
from ..models.superpoint import prepare_superpoint_params
from ..ops.frontend_step import PACK_SCALE
from ..ops.rgbd_step import fused_rgbd_step
from ..utils.device import resolve_device
from ..utils.profiler import profile_scope
from .extractor import pad_to_multiple
from .features import PaddedFeatures, keyframe_world_arrays
from .fused import UploadRing, to_device


class FusedRgbdPipeline:
    def __init__(
        self,
        sp_params,
        lg_params,
        calib: StereoCalib,
        width: int,
        height: int,
        depth_factor: float,
        max_depth: float,
        dist_coeffs: np.ndarray | None = None,
        max_keypoints: int = 1000,
        keypoint_threshold: float = 0.005,
        remove_borders: int = 4,
        nms_radius: int = 4,
        match_threshold: float = 0.1,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.sp_params = prepare_superpoint_params(sp_params, self.device)
        self.lg_params = prepare_params(lg_params, self.device)
        self.calib = calib
        self.width = int(width)
        self.height = int(height)
        self.pad_w = pad_to_multiple(self.width)
        self.pad_h = pad_to_multiple(self.height)
        self.depth_factor = float(depth_factor)
        self.max_depth = float(max_depth)
        self.dist_coeffs = (
            None
            if dist_coeffs is None or not np.any(np.asarray(dist_coeffs))
            else np.asarray(dist_coeffs, np.float64)
        )
        self.K = int(max_keypoints)
        self.keypoint_threshold = float(keypoint_threshold)
        self.remove_borders = int(remove_borders)
        self.nms_radius = int(nms_radius)
        self.match_threshold = float(match_threshold)

        dev = self.device
        self._kf_kpts = torch.zeros((self.K, 2), dtype=torch.float32, device=dev)
        self._kf_desc = torch.zeros((self.K, 256), dtype=torch.float32, device=dev)
        self._kf_valid = torch.zeros((self.K,), dtype=torch.bool, device=dev)
        # Keyframe world points for device (mono) tracking, see
        # ops/rgbd_step.py::fused_rgbd_track_step_multi.
        self._kf_xw = torch.zeros((self.K, 3), dtype=torch.float32, device=dev)
        self._kf_depth_ok = torch.zeros((self.K,), dtype=torch.bool, device=dev)
        self._ring = UploadRing((1, self.pad_h, self.pad_w), dev)

    @property
    def upload_slots(self) -> int:
        return self._ring.slots

    @upload_slots.setter
    def upload_slots(self, n: int) -> None:
        self._ring.slots = n

    def _prepare_np(self, gray: np.ndarray, out: np.ndarray | None = None) -> np.ndarray:
        """Host uint8 (1, padH, padW) frame, written into ``out`` when given."""
        a = np.asarray(gray)
        if a.ndim == 3:
            a = (a @ np.array([0.114, 0.587, 0.299], np.float32)).astype(np.uint8)
        if a.dtype != np.uint8:
            # Contract: float => [0, 1]; integer => raw pixels (dtype-keyed,
            # see frontend/fused.py).
            if np.issubdtype(a.dtype, np.floating):
                a = a * 255.0
            a = np.clip(a, 0, 255).astype(np.uint8)
        batch = np.empty((1, self.pad_h, self.pad_w), np.uint8) if out is None else out
        batch.fill(0)
        h, w = a.shape
        batch[0, : min(h, self.pad_h), : min(w, self.pad_w)] = a[: self.pad_h, : self.pad_w]
        return batch

    def upload(self, gray: np.ndarray) -> torch.Tensor:
        """The padded uint8 (1, padH, padW) frame on the device, a fresh
        tensor each call (UploadRing)."""
        return self._ring.upload(lambda out=None: self._prepare_np(gray, out=out))

    def to_device(self, arr: np.ndarray) -> torch.Tensor:
        return to_device(arr, self.device)

    def _sample_depth(self, depth: np.ndarray, uv: np.ndarray) -> np.ndarray:
        u = np.rint(uv[:, 0]).astype(int)
        v = np.rint(uv[:, 1]).astype(int)
        ok = (u >= 0) & (v >= 0) & (u < depth.shape[1]) & (v < depth.shape[0])
        z = np.zeros(uv.shape[0])
        z[ok] = depth[v[ok], u[ok]].astype(np.float64) / self.depth_factor
        return z

    def step_kw(self) -> dict:
        """The static arguments of the RGB-D steps."""
        return dict(
            max_keypoints=self.K,
            keypoint_threshold=self.keypoint_threshold,
            remove_borders=self.remove_borders,
            nms_radius=self.nms_radius,
            true_width=self.width,
            true_height=self.height,
            match_threshold=self.match_threshold,
        )

    def process(
        self, gray: np.ndarray, depth: np.ndarray, timestamp: float
    ) -> tuple[StereoFrame, MatchResult]:
        with profile_scope("fe_rgbd_extract"):
            packed, desc_dev, kpts_dev, valid_dev = fused_rgbd_step(
                self.sp_params,
                self.lg_params,
                self.upload(gray),
                self._kf_kpts,
                self._kf_desc,
                self._kf_valid,
                **self.step_kw(),
            )
            p = packed.cpu().numpy()  # the ONE host readback this frame

        feats = PaddedFeatures(
            kpts=kpts_dev,
            desc=desc_dev,
            n=0,  # filled by decode_packed
            width=self.width,
            height=self.height,
            valid=valid_dev,
        )
        return self.decode_packed(p, depth, timestamp, feats)

    def decode_packed(
        self, p: np.ndarray, depth: np.ndarray, timestamp: float, feats
    ) -> tuple[StereoFrame, MatchResult]:
        """Host-side decode of one frame's (3, K) int16 block: valid-prefix
        count, undistortion, depth sampled at the raw pixel, uR synthesis.
        Coordinates arrive in 1/PACK_SCALE px fixed point."""
        n = int((p[0].astype(np.int32) >= 0).sum())  # valid prefix (x < 0 pad)
        feats.n = n
        raw = np.stack([p[0, :n], p[1, :n]], axis=1).astype(np.float64) / PACK_SCALE
        if self.dist_coeffs is not None and n > 0:
            undist = undistort_points(raw, self.calib, self.dist_coeffs)
        else:
            undist = raw

        Z = self._sample_depth(depth, raw)  # depth registered to the RAW pixel
        bf = self.calib.bf
        stereo = np.empty((n, 3))
        stereo[:, 0] = undist[:, 0]
        stereo[:, 2] = undist[:, 1]
        valid = (Z > 0.0) & (Z < self.max_depth)
        stereo[:, 1] = np.where(valid, undist[:, 0] - bf / np.where(valid, Z, 1.0), np.nan)

        frame = StereoFrame(
            timestamp=timestamp,
            keypoints_left=undist.astype(np.float32),
            descriptors_left=feats,
            stereo=stereo,
            has_depth=valid,
            scores=np.ones(n, np.float32),
        )
        ti = p[2].astype(np.int32)
        qi = np.flatnonzero(ti >= 0).astype(np.int32)
        matches = MatchResult(
            matches=np.stack([qi, ti[qi]], 1), scores=np.ones(qi.size, np.float32)
        )
        return frame, matches

    def set_keyframe(self, feats: PaddedFeatures) -> None:
        """Adopt a frame's device-resident features as the new keyframe."""
        self._kf_kpts = feats.kpts
        self._kf_desc = feats.desc
        if feats.valid is not None:
            self._kf_valid = feats.valid
        else:
            self._kf_valid = torch.arange(self.K, device=self.device) < feats.n

    def set_keyframe_world(self, frame: StereoFrame) -> None:
        """Upload the new keyframe's world points (sensor depth backprojected
        through the smoothed Twc) for device mono tracking."""
        xw, depth_ok = keyframe_world_arrays(frame, self.calib, self.K)
        self._kf_xw = self.to_device(xw)
        self._kf_depth_ok = self.to_device(depth_ok)

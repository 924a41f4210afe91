"""Fused stereo tracking pipeline: one device step + one readback per frame.

Port of ``superslam_tpu/frontend/fused.py``: wraps
``ops.frontend_step.fused_stereo_step`` with the host-side state it needs
(the last keyframe's device-resident features, the program's own outputs
from the frame that became a keyframe, and for device tracking its world
points) and the packed-block decode. It produces the (StereoFrame,
frame-to-keyframe MatchResult) pair the estimator consumes. The LightGlue
checkpoint is cast and the fused blocks' and the conv pairs' kernel
operands are prepared once at construction.

On the card every host-to-device copy goes through pinned memory without
blocking the host (a copy from pageable memory waits for every queued
kernel): frames through a ring of pinned slots (``upload``), anything else
through ``to_device``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.frame import StereoFrame
from ..core.interfaces import MatchResult
from ..geometry.stereo_camera import StereoCalib
from ..models.lightglue import prepare_params
from ..models.superpoint import prepare_superpoint_params
from ..ops.frontend_step import PACK_SCALE, fused_stereo_step
from ..utils.device import resolve_device
from ..utils.profiler import profile_scope
from .extractor import pad_to_multiple
from .features import PaddedFeatures, keyframe_world_arrays


def decode_packed(
    p: np.ndarray, timestamp: float, feats: PaddedFeatures
) -> tuple[StereoFrame, MatchResult]:
    """Decode one frame's int16 packed block (ops.frontend_step layout).

    Valid rows form a prefix (row 0 < 0 marks padding). Coordinates and
    disparity arrive in 1/PACK_SCALE px fixed point. Match confidences are
    not transferred (nothing downstream consumes them); MatchResult scores
    are 1.0.
    """
    x = p[0].astype(np.int32)
    n = int((x >= 0).sum())
    feats.n = n
    uL = x[:n].astype(np.float64) / PACK_SCALE
    v = p[1, :n].astype(np.float64) / PACK_SCALE
    disparity = p[2, :n].astype(np.float64) / PACK_SCALE
    ok = disparity >= 0
    stereo = np.stack([uL, np.where(ok, uL - disparity, np.nan), v], axis=1)
    frame = StereoFrame(
        timestamp=timestamp,
        keypoints_left=np.stack([uL, v], axis=1).astype(np.float32),
        descriptors_left=feats,
        stereo=stereo,
        has_depth=ok,
        scores=np.ones(n, np.float32),
    )
    ti = p[3].astype(np.int32)
    qi = np.flatnonzero(ti >= 0).astype(np.int32)
    matches = MatchResult(
        matches=np.stack([qi, ti[qi]], axis=1),
        scores=np.ones(qi.size, np.float32),
    )
    return frame, matches


class FusedStereoPipeline:
    def __init__(
        self,
        sp_params,
        lg_params,
        calib: StereoCalib,
        width: int,
        height: int,
        max_keypoints: int = 600,
        keypoint_threshold: float = 0.005,
        remove_borders: int = 4,
        nms_radius: int = 4,
        min_disparity: float = 1.0,
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
        self.K = int(max_keypoints)
        self.keypoint_threshold = float(keypoint_threshold)
        self.remove_borders = int(remove_borders)
        self.nms_radius = int(nms_radius)
        self.min_disparity = float(min_disparity)
        self.match_threshold = float(match_threshold)

        # Last-keyframe device state (zeros until the first keyframe lands).
        self._kf_kpts = torch.zeros((self.K, 2), dtype=torch.float32, device=self.device)
        self._kf_desc = torch.zeros((self.K, 256), dtype=torch.float32, device=self.device)
        self._kf_valid = torch.zeros((self.K,), dtype=torch.bool, device=self.device)
        # World points of the keyframe's stereo features (device tracking):
        # uploaded once per keyframe so the step can run the pose-only LM
        # against them without a host round trip.
        self._kf_xw = torch.zeros((self.K, 3), dtype=torch.float32, device=self.device)
        self._kf_depth_ok = torch.zeros((self.K,), dtype=torch.bool, device=self.device)
        # The frame upload ring: pinned host slots, each with the event of
        # its last copy (a pipelined tracker asks for depth x batch + 1).
        self.upload_slots = 2
        self._slots: list[tuple[torch.Tensor, torch.cuda.Event]] = []
        self._next_slot = 0

    def _prepare_np(
        self, left: np.ndarray, right: np.ndarray, out: np.ndarray | None = None
    ) -> np.ndarray:
        """Host uint8 (2, padH, padW) batch, written into ``out`` when given:
        the upload is uint8 and the normalization happens on the device."""
        batch = np.empty((2, self.pad_h, self.pad_w), np.uint8) if out is None else out
        batch.fill(0)
        for i, img in enumerate((left, right)):
            a = np.asarray(img)
            if a.ndim == 3:
                a = (a @ np.array([0.114, 0.587, 0.299], np.float32)).astype(np.uint8)
            if a.dtype != np.uint8:
                # Input contract: float images are normalized to [0, 1];
                # integer images are raw pixels (keyed on dtype, not range).
                if np.issubdtype(a.dtype, np.floating):
                    a = a * 255.0
                a = np.clip(a, 0, 255).astype(np.uint8)
            h, w = a.shape
            batch[i, : min(h, self.pad_h), : min(w, self.pad_w)] = a[
                : self.pad_h, : self.pad_w
            ]
        return batch

    def upload(self, left: np.ndarray, right: np.ndarray) -> torch.Tensor:
        """The padded uint8 (2, padH, padW) pair on the device. On the card it
        is prepared straight into the next pinned slot of the ring and copied
        without blocking the host; a slot is rewritten only after its last
        copy has run (at once in steady state, the ring being deeper than
        the frames in flight)."""
        if self.device.type != "cuda":
            return torch.from_numpy(self._prepare_np(left, right))
        while len(self._slots) < self.upload_slots:
            host = torch.empty((2, self.pad_h, self.pad_w), dtype=torch.uint8, pin_memory=True)
            self._slots.append((host, torch.cuda.Event()))
        host, copied = self._slots[self._next_slot]
        self._next_slot = (self._next_slot + 1) % len(self._slots)
        copied.synchronize()
        self._prepare_np(left, right, out=host.numpy())
        dev = host.to(self.device, non_blocking=True)
        copied.record()
        return dev

    def to_device(self, arr: np.ndarray) -> torch.Tensor:
        """A host array on the pipeline's device; on the card through pinned
        memory and a copy that does not block the host (PyTorch's pinned
        allocator keeps the block until the copy has run)."""
        arr = np.asarray(arr)
        t = torch.from_numpy(arr if arr.flags.c_contiguous else arr.copy())
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def process(
        self, left: np.ndarray, right: np.ndarray, timestamp: float
    ) -> tuple[StereoFrame, MatchResult]:
        with profile_scope("fe_extract_stereo"):
            images = self.upload(left, right)
            packed, desc_dev, kpts_dev, valid_dev = fused_stereo_step(
                self.sp_params,
                self.lg_params,
                images,
                self._kf_kpts,
                self._kf_desc,
                self._kf_valid,
                max_keypoints=self.K,
                keypoint_threshold=self.keypoint_threshold,
                remove_borders=self.remove_borders,
                nms_radius=self.nms_radius,
                true_width=self.width,
                true_height=self.height,
                min_disparity=self.min_disparity,
                match_threshold=self.match_threshold,
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
        return decode_packed(p, timestamp, feats)

    def set_keyframe(self, feats: PaddedFeatures) -> None:
        """Adopt a frame's device-resident features as the new keyframe."""
        self._kf_kpts = feats.kpts
        self._kf_desc = feats.desc
        if feats.valid is not None:
            self._kf_valid = feats.valid
        else:
            self._kf_valid = torch.arange(self.K, device=self.device) < feats.n

    def set_keyframe_world(self, frame: StereoFrame) -> None:
        """Upload the new keyframe's world points for device tracking (see
        features.keyframe_world_arrays for the grounding contract)."""
        xw, depth_ok = keyframe_world_arrays(frame, self.calib, self.K)
        self._kf_xw = self.to_device(xw)
        self._kf_depth_ok = self.to_device(depth_ok)

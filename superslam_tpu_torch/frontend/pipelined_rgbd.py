"""Software-pipelined RGB-D tracking with frame batching.

Port of ``superslam_tpu/frontend/pipelined_rgbd.py``, the RGB-D analogue
of ``frontend/pipelined.py`` (see its docstring for the scheduling): S
frames a step and one packed readback, uploads at submit time through the
pipeline's pinned ring, results drained before the next dispatch, the
readbacks non-blocking copies into pooled pinned blocks (``_AsyncHost``).
The depth image never goes to the device: it rides along in the in-flight
record and is sampled on the host at decode time (src/RgbdFrontEnd.cc:23-58).

Device tracking (``device_tracking=True``) is the JAX package's
dispatch-frozen mono chain: the step solves against the keyframe the host
uploaded, re-anchored on the host's poses at every dispatch. A frame whose
device row coasts (fewer than min_matches correspondences) is solved on
the host instead. There are no device keyframes on the RGB-D path, as in
the JAX package.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from ..core.vo_estimator import VoEstimator
from ..geometry.se3 import Pose3
from ..ops.rgbd_step import RGBD_PACK_ROWS, fused_rgbd_step_multi, fused_rgbd_track_step_multi
from ..utils.profiler import profile_scope
from .features import LazySlotFeatures
from .fused_rgbd import FusedRgbdPipeline
from .pipelined import _AsyncHost, _decode_device_pose, _track_statics, pose_carry


@dataclass
class _InFlight:
    timestamp: float
    packed: _AsyncHost  # host copy of the (S * RGBD_PACK_ROWS, K) block
    slot: int
    desc: Any  # batched (S, K, D) step output (lazily sliced)
    kpts: Any
    valid: Any
    kf_ref_id: int | None
    depth_img: np.ndarray
    pose: _AsyncHost | None = None  # device-tracking track rows
    gray_dev: Any = None  # the device-resident (1, H, W) uint8 upload


class PipelinedRgbdTracker:
    def __init__(
        self,
        pipeline: FusedRgbdPipeline,
        estimator: VoEstimator,
        depth: int = 3,
        batch: int = 1,
        device_tracking: bool = False,
        loop_descriptor_fn=None,
    ):
        self.pipeline = pipeline
        self.estimator = estimator
        self.depth = max(1, int(depth))
        self.batch = max(1, int(batch))
        estimator._kf_store_size = max(estimator._kf_store_size, self.depth * self.batch + 2)
        pipeline.upload_slots = max(pipeline.upload_slots, self.depth * self.batch + 1)
        # The loop worker's descriptor source: a callable over the device
        # upload (recognizer.compute_global_descriptor_from_device). When
        # set, keyframes hand the worker a lazy closure over the frame's
        # upload; each upload is a fresh tensor, held until then.
        self.loop_descriptor_fn = loop_descriptor_fn
        self._staged: list[tuple[torch.Tensor, np.ndarray, float]] = []
        self._pending: deque[_InFlight] = deque()
        self._host_blocks: dict = {}  # the readbacks' pinned blocks, by shape
        self._last_pose = Pose3()
        self._last_rel = Pose3()
        self._have_kf = False
        # The device pose solve (mono factors; SUPERSLAM_DEVICE_TRACKER).
        # Distorted calibrations are undistorted on the device before the
        # solve (ops/rgbd_step.py::undistort_points), into the host
        # estimator's coordinates.
        self.device_tracking = bool(device_tracking)
        self.device_kf = False  # no device keyframes on the RGB-D path
        if self.device_tracking:
            s = _track_statics(pipeline.calib)
            self._trk_calib = s["calib"]
            self._trk_min_matches = s["min_matches"]
            self._trk_sigma_px = s["sigma_px"]
            d = pipeline.dist_coeffs
            if d is None:
                self._trk_dist = None
            else:
                d = [float(x) for x in np.asarray(d).reshape(-1)]
                self._trk_dist = tuple((d + [0.0] * 5)[:5])

    # -- pipeline ------------------------------------------------------------
    def submit(self, gray: np.ndarray, depth_img: np.ndarray, timestamp: float) -> None:
        with profile_scope("pl_upload"):
            dev = self.pipeline.upload(gray)
        self._staged.append((dev, np.asarray(depth_img), timestamp))
        if len(self._staged) >= self.batch:
            while len(self._pending) > (self.depth - 1) * self.batch:
                self.drain_one()
            self._dispatch()

    def _dispatch(self) -> None:
        if not self._staged:
            return
        pl = self.pipeline
        staged, self._staged = self._staged, []
        n_real = len(staged)
        while len(staged) < self.batch:
            staged.append(staged[-1])
        images = staged[0][0] if self.batch == 1 else torch.cat([d for d, *_ in staged], dim=0)
        track_out = None
        if self.device_tracking:
            # Dispatch-frozen chain: re-anchor on host state at every
            # dispatch (a carry riding dispatch to dispatch dead-reckons past
            # the host's corrections; see frontend/pipelined.py), so the
            # step's own carry out is dropped. No fallback: an error here
            # propagates.
            packed, desc, kpts, valid, track_out, _ = fused_rgbd_track_step_multi(
                pl.sp_params,
                pl.lg_params,
                images,
                pl._kf_kpts,
                pl._kf_desc,
                pl._kf_valid,
                pl._kf_xw,
                pl._kf_depth_ok,
                *pose_carry(pl, self._last_pose, self._last_rel),
                **pl.step_kw(),
                calib=self._trk_calib,
                min_matches=self._trk_min_matches,
                track_sigma_px=self._trk_sigma_px,
                dist=self._trk_dist,
            )
        else:
            packed, desc, kpts, valid = fused_rgbd_step_multi(
                pl.sp_params,
                pl.lg_params,
                images,
                pl._kf_kpts,
                pl._kf_desc,
                pl._kf_valid,
                **pl.step_kw(),
            )
        fut = _AsyncHost(packed, self._host_blocks, n_real)
        pose_fut = None if track_out is None else _AsyncHost(track_out, self._host_blocks, n_real)
        kf_ref = self.estimator._last_keyframe_id if self._have_kf else None
        for s, (dev, depth_img, ts) in enumerate(staged[:n_real]):
            self._pending.append(
                _InFlight(
                    ts, fut, s, desc, kpts, valid, kf_ref, depth_img,
                    pose=pose_fut,
                    gray_dev=dev if self.loop_descriptor_fn is not None else None,
                )
            )

    def drain_one(self) -> Pose3 | None:
        if not self._pending:
            return None
        item = self._pending.popleft()
        with profile_scope("pl_fetch_wait"):
            frame, kf_matches = self._decode(item)
        device_pose = None
        if item.pose is not None:
            row = item.pose.result()[item.slot].copy()
            item.pose.release()
            # A coasting row (fewer than min_matches correspondences) is the
            # carry's prediction, not a solve: the host solves the frame on
            # the device's own matches.
            if item.kf_ref_id is not None and row[12] >= self._trk_min_matches:
                device_pose = _decode_device_pose(row)
        provider = None
        if self.loop_descriptor_fn is not None and item.gray_dev is not None:
            fn, dev = self.loop_descriptor_fn, item.gray_dev
            provider = lambda: fn(dev[0])  # noqa: E731 (evaluated on the worker)
        prev = self._last_pose
        pose = self.estimator.track(
            frame,
            None,
            kf_matches=kf_matches if item.kf_ref_id is not None else None,
            kf_ref_id=item.kf_ref_id,
            device_pose=device_pose,
            descriptor_provider=provider,
        )
        if self.estimator._last_keyframe is frame:
            self.pipeline.set_keyframe(frame.descriptors_left)
            if self.device_tracking:
                self.pipeline.set_keyframe_world(frame)
        self._last_rel = prev.between(pose)
        self._last_pose = pose
        self._have_kf = True
        return pose

    def _decode(self, item: _InFlight):
        block = item.packed.result()
        p = block.reshape(-1, RGBD_PACK_ROWS, block.shape[-1])[item.slot]
        feats = LazySlotFeatures(
            item.kpts,
            item.desc,
            item.valid,
            slot=item.slot,
            n=0,  # filled by decode_packed
            width=self.pipeline.width,
            height=self.pipeline.height,
        )
        out = self.pipeline.decode_packed(p, item.depth_img, item.timestamp, feats)
        item.packed.release()  # decode_packed copied what it keeps
        return out

    # -- public API ------------------------------------------------------------
    def track(self, gray: np.ndarray, depth_img: np.ndarray, timestamp: float) -> Pose3:
        """Submit this frame; returns the constant-velocity prediction (the
        exact pose lands within depth x batch calls; corrected_trajectory()
        is exact)."""
        self.submit(gray, depth_img, timestamp)
        return self._last_pose * self._last_rel

    def flush(self) -> Pose3:
        """Dispatch anything staged and drain everything in flight."""
        self._dispatch()
        while self._pending:
            self.drain_one()
        return self._last_pose

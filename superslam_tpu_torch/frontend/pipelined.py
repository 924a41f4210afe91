"""Software-pipelined stereo tracking with frame batching.

Port of ``superslam_tpu/frontend/pipelined.py``. A fully synchronous loop
waits, every frame, for the device step and its readback before the host
estimator can run, and the device waits for the estimator before the next
step. This wrapper overlaps the two:

- **Depth-D pipelining**: each dispatch queues its step on the device and
  a non-blocking copy of the packed readback into pinned host memory; the
  host estimator consumes results up to D - 1 dispatches behind submission,
  while later frames' device work proceeds.
- **Frame batching** (batch=S, ``SUPERSLAM_PIPELINE_BATCH``): S consecutive
  stereo frames go through one step and one packed readback. All S frames'
  track matches refer to the same keyframe state; the estimator resolves
  lagged keyframe references from its retained store.

Three modes:
- host-solved (``fused_stereo_step_multi``): the host estimator solves
  every pose;
- device keyframes (``device_tracking=True``, the default with it;
  ``fused_stereo_track_kf_step_multi``): the pose solve and the keyframe
  promotion run in the step, the keyframe rides the step's carry, and the
  host follows the readback's accept and promo bits;
- dispatch-frozen device tracking (``SUPERSLAM_DEVICE_KF=0``,
  ``fused_stereo_track_step_multi``): the step solves against the keyframe
  the host uploaded, re-anchored on host poses at every dispatch.

The estimator still sees every frame, in order, with full data; only the
pose returned at submit time is the constant-velocity prediction for the
newest frame, and corrected_trajectory() is exact throughout.

What differs from the JAX package: the readbacks are non-blocking copies
into pinned host tensors with an event (``_AsyncHost``); there is no
fetcher thread pool; and there is no fallback from device keyframes to
dispatch-frozen tracking when the step fails: the error propagates. Loop
closure (loop descriptors from the device frame, gray copies) is not
ported.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from ..core.factors import disp_sigma_px, stereo_cond_depth_m
from ..core.keyframe_gate import MIN_FRAMES_DEFAULT, MIN_MATCHES_DEFAULT
from ..core.vo_estimator import VoEstimator
from ..geometry.se3 import Pose3
from ..ops import frontend_step as step
from ..utils.env import env_flag, env_float, env_int
from ..utils.profiler import profile_scope
from .features import LazySlotFeatures, keyframe_world_arrays
from .fused import FusedStereoPipeline, decode_packed


class _AsyncHost:
    """A device tensor's host copy, queued behind the step that made it.

    On the card the copy goes into a pinned block without blocking the host
    (a copy into pageable memory would wait for every queued kernel), with
    an event after it; ``result()`` waits on that event only, by drain time
    long past. Blocks return to ``pool`` once every frame that reads them
    has drained (``release``), so steady state allocates nothing."""

    def __init__(self, t: torch.Tensor, pool: dict, readers: int):
        self._pool, self._readers = pool, readers
        self._event = None
        if t.device.type == "cpu":
            self._host = t
            return
        key = (tuple(t.shape), t.dtype)
        free = pool.setdefault(key, [])
        self._host = free.pop() if free else torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        self._host.copy_(t, non_blocking=True)
        self._event = torch.cuda.Event()
        self._event.record()

    def result(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy()

    def release(self) -> None:
        self._readers -= 1
        if self._readers == 0 and self._event is not None:
            self._pool[(tuple(self._host.shape), self._host.dtype)].append(self._host)


def _track_statics(calib) -> dict:
    """Static solver parameters of the device-tracking dispatch."""
    return {
        "calib": (
            float(calib.fx),
            float(calib.fy),
            float(calib.cx),
            float(calib.cy),
            float(calib.baseline),
        ),
        "min_matches": env_int("SUPERSLAM_TRACK_MIN_MATCHES", 10),
        "sigma_px": 10.0,  # FrameTracker.cc:24
        "disp_sigma0": float(disp_sigma_px()),
        "disp_cond": float(calib.bf) / float(stereo_cond_depth_m()),
    }


def _decode_device_pose(row: np.ndarray) -> Pose3:
    """One track row -> Twc (see ops.frontend_step.track_scan)."""
    return Pose3(
        R=row[:9].astype(np.float64).reshape(3, 3),
        t=row[9:12].astype(np.float64),
    )


@dataclass
class _InFlight:
    timestamp: float
    packed: _AsyncHost  # host copy of the (S * PACK_ROWS, K) block
    slot: int  # this frame's row in the packed block
    desc: Any  # batched (S, K, D) step output (lazily sliced)
    kpts: Any
    valid: Any
    kf_ref_id: int | None
    pose: _AsyncHost | None = None  # device-tracking track rows
    kf_epoch: int = -1  # device-kf mode: kf-state epoch at dispatch


class PipelinedStereoTracker:
    def __init__(
        self,
        pipeline: FusedStereoPipeline,
        estimator: VoEstimator,
        depth: int = 3,
        batch: int = 1,
        device_tracking: bool = False,
    ):
        self.pipeline = pipeline
        self.estimator = estimator
        self.depth = max(1, int(depth))
        self.batch = max(1, int(batch))
        pipeline.upload_slots = max(pipeline.upload_slots, self.depth * self.batch + 1)
        # On-device pose solve (SUPERSLAM_DEVICE_TRACKER): the step also runs
        # the pose-only LM per frame and the host estimator adopts the solved
        # pose instead of calling FrameTracker. The LM carry (previous pose +
        # constant-velocity model) lives on the device across dispatches.
        self.device_tracking = bool(device_tracking)
        self._carry = None  # (R, t, rel_R, rel_t) device tensors
        # Padded flush tails run the duplicate frames through the pose scan,
        # corrupting the constant-velocity carry; rebuild it from the host's
        # last pose/rel before the next dispatch instead.
        self._carry_stale = True
        # Zero-lag device keyframe mode (SUPERSLAM_DEVICE_KF, default on with
        # device tracking): the keyframe state rides the step's carry and
        # promotion happens in the step (track_kf_scan), so every frame
        # matches against the newest keyframe. The host follows the
        # readback's accept/promo bits; `_kf_epoch` counts host-initiated
        # reseeds (first keyframe, flush tails) so frames dispatched against
        # superseded device state fall back to the host re-match path
        # instead of trusting stale matches.
        self.device_kf = self.device_tracking and env_flag("SUPERSLAM_DEVICE_KF", True)
        self._kf_state = None  # (nk, desc, valid, xw, depth_ok, since)
        self._kf_epoch = 0
        self.reseeds = 0  # _seed_kf_state runs (host-to-device keyframe uploads)
        # True while the host keyframe chain has advanced past the device
        # carry (host-initiated insertion): in-flight device results then
        # refer to an older keyframe than estimator._last_keyframe_id and
        # must not be adopted under that id.
        self._kf_dirty = False
        if self.device_tracking:
            s = _track_statics(pipeline.calib)
            self._trk_calib = s["calib"]
            self._trk_min_matches = s["min_matches"]
            self._trk_sigma_px = s["sigma_px"]
            self._trk_disp_sigma0 = s["disp_sigma0"]
            self._trk_disp_cond = s["disp_cond"]
            self._kf_accept_frac = env_float("SUPERSLAM_TRACK_ACCEPT_FRAC", 0.4)
            self._kf_support_px = 2.0 * env_float("SUPERSLAM_TRACK_CHI2_PX", 2.0)
            self._kf_covis = env_float("SUPERSLAM_KF_COVIS", estimator._covisibility_ratio)
            self._kf_max_frames = int(estimator._max_keyframe_frames)
        # In-flight frames can lag up to depth*batch insertions behind the
        # newest keyframe; retain enough keyframes that their precomputed
        # matches stay resolvable (an eviction forces a host re-match).
        estimator._kf_store_size = max(estimator._kf_store_size, self.depth * self.batch + 2)
        self._staged: list[tuple[torch.Tensor, float]] = []
        self._pending: deque[_InFlight] = deque()
        self._host_blocks: dict = {}  # the readbacks' pinned blocks, by shape
        self._last_pose = Pose3()
        self._last_rel = Pose3()
        self._have_kf = False

    def _pose_carry(self):
        """Host poses -> the device tracking carry (R, t, rel_R, rel_t) f32,
        one upload."""
        p, r = self._last_pose, self._last_rel
        flat = np.concatenate([p.R.ravel(), p.t, r.R.ravel(), r.t]).astype(np.float32)
        dev = self.pipeline.to_device(flat)
        return dev[:9].view(3, 3), dev[9:12], dev[12:21].view(3, 3), dev[21:24]

    def _seed_kf_state(self) -> None:
        """(Re)build the device keyframe carry from the host's newest
        keyframe: the bootstrap after the first insertion, and the recovery
        after any host-initiated insertion or flush-tail pollution. Bumps
        the epoch so in-flight frames dispatched against the superseded
        device state fall back to the host re-match path. Uploads the world
        points through the pinned path; ``reseeds`` counts the runs."""
        pl = self.pipeline
        est = self.estimator
        frame = est._last_keyframe
        feats = frame.descriptors_left
        center, scale = step._norm_frame(pl.width, pl.height, pl.device)
        nk = (feats.kpts - center) / scale
        valid = feats.valid
        if valid is None:
            valid = pl.to_device(np.arange(pl.K) < feats.n)
        xw, dok = keyframe_world_arrays(frame, pl.calib, pl.K)
        self._kf_state = (
            nk,
            feats.desc,
            valid,
            pl.to_device(xw),
            pl.to_device(dok),
            pl.to_device(np.asarray(est._frames_since_keyframe, np.int32)),
        )
        self._kf_epoch += 1
        self.reseeds += 1
        self._kf_dirty = False
        # The device pose chain re-anchors on host state along with the
        # keyframe (they travel through the same step carry).
        self._carry_stale = True

    # -- pipeline ------------------------------------------------------------
    def submit(self, left: np.ndarray, right: np.ndarray, timestamp: float) -> None:
        # Upload each frame as it arrives, so the copy streams during the
        # frame interval instead of bursting S frames at dispatch time.
        with profile_scope("pl_upload"):
            dev = self.pipeline.upload(left, right)
        self._staged.append((dev, timestamp))
        if len(self._staged) >= self.batch:
            # Drain before dispatching, so the estimator's host work runs
            # while the in-flight steps are on the device.
            while len(self._pending) > (self.depth - 1) * self.batch:
                self.drain_one()
            self._dispatch()

    def _step_kw(self) -> dict:
        pl = self.pipeline
        return dict(
            max_keypoints=pl.K,
            keypoint_threshold=pl.keypoint_threshold,
            remove_borders=pl.remove_borders,
            nms_radius=pl.nms_radius,
            true_width=pl.width,
            true_height=pl.height,
            min_disparity=pl.min_disparity,
            match_threshold=pl.match_threshold,
        )

    def _track_kw(self) -> dict:
        return dict(
            calib=self._trk_calib,
            min_matches=self._trk_min_matches,
            track_sigma_px=self._trk_sigma_px,
            disp_sigma0=self._trk_disp_sigma0,
            disp_cond=self._trk_disp_cond,
        )

    def _dispatch(self) -> None:
        if not self._staged:
            return
        pl = self.pipeline
        staged, self._staged = self._staged, []
        n_real = len(staged)
        # Pad partial batches (the flush tail) by replicating the last frame
        # so every dispatch has the same shapes; dummy results are dropped.
        while len(staged) < self.batch:
            staged.append(staged[-1])
        images = staged[0][0] if self.batch == 1 else torch.cat([d for d, _ in staged], dim=0)
        track_out = None
        used_kf_program = False
        if self.device_kf and self._kf_state is None and self._have_kf:
            self._seed_kf_state()
        if self.device_kf and self._kf_state is not None:
            if self._carry is None or self._carry_stale:
                self._carry = self._pose_carry()
                self._carry_stale = False
            # No fallback: an error here propagates.
            (
                packed, desc, kpts, valid, track_out, self._kf_state, self._carry,
            ) = step.fused_stereo_track_kf_step_multi(
                pl.sp_params,
                pl.lg_params,
                images,
                self._kf_state,
                self._carry,
                **self._step_kw(),
                **self._track_kw(),
                accept_frac=self._kf_accept_frac,
                support_px=self._kf_support_px,
                kf_min_frames=MIN_FRAMES_DEFAULT,
                kf_max_frames=self._kf_max_frames,
                kf_min_matches=MIN_MATCHES_DEFAULT,
                covis_ratio=self._kf_covis,
            )
            used_kf_program = True
            if n_real < self.batch:
                # Duplicate flush-tail frames ran the scan: both the pose
                # carry and the device keyframe may have moved (a duplicate
                # can promote). Rebuild both from host state before the next
                # dispatch.
                self._carry_stale = True
                self._kf_state = None
        elif self.device_tracking and not self.device_kf:
            # Dispatch-frozen mode: re-anchor the device pose chain on host
            # state at every dispatch (a carry riding dispatch to dispatch
            # dead-reckons past every host-side correction; the JAX package
            # measured ATE 2.34 m riding against 0.039 m re-anchored on a
            # 60-frame bisect of the rendered circuit).
            self._carry = self._pose_carry()
            self._carry_stale = False
            packed, desc, kpts, valid, track_out, self._carry = step.fused_stereo_track_step_multi(
                pl.sp_params,
                pl.lg_params,
                images,
                pl._kf_kpts,
                pl._kf_desc,
                pl._kf_valid,
                pl._kf_xw,
                pl._kf_depth_ok,
                *self._carry,
                **self._step_kw(),
                **self._track_kw(),
            )
            if n_real < self.batch:
                self._carry_stale = True  # duplicates polluted the carry
        else:
            packed, desc, kpts, valid = step.fused_stereo_step_multi(
                pl.sp_params,
                pl.lg_params,
                images,
                pl._kf_kpts,
                pl._kf_desc,
                pl._kf_valid,
                **self._step_kw(),
            )
        fut = _AsyncHost(packed, self._host_blocks, n_real)
        pose_fut = None if track_out is None else _AsyncHost(track_out, self._host_blocks, n_real)
        kf_ref = self.estimator._last_keyframe_id if self._have_kf else None
        for s, (_dev, ts) in enumerate(staged[:n_real]):
            # The batched outputs go in whole; LazySlotFeatures slices a
            # frame's rows only if something (keyframe adoption, host
            # re-match) actually reads them.
            self._pending.append(
                _InFlight(
                    ts, fut, s, desc, kpts, valid, kf_ref, pose=pose_fut,
                    kf_epoch=self._kf_epoch if used_kf_program else -1,
                )
            )

    def drain_one(self) -> Pose3 | None:
        if not self._pending:
            return None
        item = self._pending.popleft()
        with profile_scope("pl_fetch_wait"):
            frame, kf_matches = self._decode(item)
        device_pose = None
        device_accept = device_promote = None
        kf_ref = item.kf_ref_id
        if item.pose is not None:
            row = item.pose.result()[item.slot].copy()
            item.pose.release()
            if item.kf_epoch >= 0:
                # Zero-lag device keyframe dispatch: matches/pose refer to
                # the device-carried keyframe, which equals the host's newest
                # keyframe as long as every insertion since this frame's
                # dispatch came from a promo bit (the host follows them in
                # drain order). A host-initiated insertion or a reseed breaks
                # that lockstep: fall back to the host re-match path for the
                # in-flight frames it orphaned.
                if item.kf_epoch == self._kf_epoch and not self._kf_dirty:
                    device_pose = _decode_device_pose(row)
                    device_accept = bool(row[14] > 0.5)
                    device_promote = bool(row[15] > 0.5)
                    kf_ref = self.estimator._last_keyframe_id
                else:
                    kf_ref = None
            elif item.kf_ref_id is not None:
                if row[12] >= self._trk_min_matches:
                    device_pose = _decode_device_pose(row)
                else:
                    # In-step coast (n < min_matches): the row is the device
                    # carry's dead-reckoned prediction, not a solve. Fall
                    # through to the full host solve on the device's own
                    # matches and reseed the carry from host state at the
                    # next dispatch.
                    self._carry_stale = True
        if self.device_kf and device_promote is None:
            # Stale/bootstrap frame while the zero-lag mode is active: it
            # tracks through the host re-match path, but it must not run the
            # host keyframe gate: a host-initiated insertion orphans every
            # in-flight frame (epoch bump), and at keyframe cadences shorter
            # than the pipeline depth the orphaning cascades until every
            # frame drains stale. Insertion authority stays with the in-step
            # gate on the next epoch-valid frame. (The first keyframe is
            # unaffected: _init_first_keyframe runs before any gate.)
            device_promote = False
        prev = self._last_pose
        pose = self.estimator.track(
            frame,
            None,
            kf_matches=kf_matches if kf_ref is not None else None,
            kf_ref_id=kf_ref,
            device_pose=device_pose,
            device_accept=device_accept,
            device_promote=device_promote,
        )
        if self.estimator._last_keyframe is frame:
            if self.device_kf:
                if not device_promote:
                    # Host-initiated insertion (first keyframe, or a frame
                    # that drained through the host path): the device carry
                    # no longer matches the newest keyframe. Reseed at the
                    # next dispatch.
                    self._kf_state = None
                    self._kf_dirty = True
            else:
                self.pipeline.set_keyframe(frame.descriptors_left)
                if self.device_tracking:
                    self.pipeline.set_keyframe_world(frame)
        self._last_rel = prev.between(pose)
        self._last_pose = pose
        self._have_kf = True
        return pose

    def _decode(self, item: _InFlight):
        block = item.packed.result()
        p = block.reshape(-1, step.PACK_ROWS, block.shape[-1])[item.slot]
        feats = LazySlotFeatures(
            item.kpts,
            item.desc,
            item.valid,
            slot=item.slot,
            n=0,  # filled by decode_packed
            width=self.pipeline.width,
            height=self.pipeline.height,
        )
        out = decode_packed(p, item.timestamp, feats)  # copies out of the block
        item.packed.release()
        return out

    # -- public API ------------------------------------------------------------
    def track(self, left: np.ndarray, right: np.ndarray, timestamp: float) -> Pose3:
        """Submit this frame; drain until at most (depth*batch - 1) remain in
        flight. Returns the constant-velocity prediction for this frame
        (the exact pose lands within `batch` calls; corrected_trajectory()
        is always exact)."""
        self.submit(left, right, timestamp)
        return self._last_pose * self._last_rel

    def flush(self) -> Pose3:
        """Dispatch anything staged and drain everything in flight."""
        self._dispatch()
        while self._pending:
            self.drain_one()
        return self._last_pose

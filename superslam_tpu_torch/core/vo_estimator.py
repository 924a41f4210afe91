"""Sliding-window stereo VO orchestrator, optionally upgraded to SLAM with
pose-graph loop closure.

Equivalent of the reference VoEstimator
(``src/VoEstimator.cc``, header ``include/VoEstimator.h``):

- First frame -> origin keyframe (stereo sets metric scale).
- Per frame: match to last keyframe -> build PointObs (depth on both ends)
  with landmark-id carry-over -> pose-only LM seeded with the previous pose
  -> coast on constant velocity when matches < SUPERSLAM_TRACK_MIN_MATCHES
  -> covisibility keyframe gate -> on keyframe: landmark ids reuse-or-mint,
  window add + optimize, pose corrected by the window, SparseMap add, seed
  anchor record, KeyframeMsg to the loop worker.
- Live pose = (loop-corrected anchor or last KF pose) * rel. Tracking and
  the window are NEVER rebased; corrections only move the anchors.
- The loop worker adds the tier-2 node + odometry edge, computes the global
  descriptor, detects, and on accept adds a loop edge, re-optimizes, and
  publishes anchors under a lock (only if the rollback did not fire).

The worker runs on a Python thread (the reference's std::thread +
condvar-deque, ``src/VoEstimator.cc:113-173``): the heavy work inside it is
JAX/numpy, which releases the GIL.
"""

from __future__ import annotations

import os
import sys
import threading
from collections import deque
from dataclasses import dataclass, field

import numpy as np

from ..geometry.se3 import Pose3
from ..geometry.stereo_camera import StereoCalib
from ..utils.env import env_flag, env_float, env_int
from ..utils.profiler import profile_scope
from .frame import StereoFrame
from .frame_tracker import FrameTracker
from .interfaces import FeatureMatcher, MatchResult
from .keyframe_gate import should_insert_keyframe
from .keyframes import KeyframeRecord
from .loop_closer import LoopCloser
from .pose_graph import GlobalPoseGraph
from .sparse_map import SparseMap
from .window_smoother import StereoObs, WindowSmoother

_DEFAULT_WINDOW = 8


def _resolve_window_size(cfg: int) -> int:
    v = os.environ.get("SUPERSLAM_WS_WINDOW")
    if v is not None:
        return int(v)
    return cfg if cfg > 0 else _DEFAULT_WINDOW


def _odometry_sigmas() -> np.ndarray:
    r = env_float("SUPERSLAM_ODOM_ROT_SIGMA", 0.02)
    t = env_float("SUPERSLAM_ODOM_TRANS_SIGMA", 0.05)
    return np.array([r, r, r, t, t, t])


@dataclass
class KeyframeMsg:
    keyframe_id: int = 0
    previous_keyframe_id: int = 0
    has_previous: bool = False
    pose: Pose3 = field(default_factory=Pose3)
    relative_odometry: Pose3 = field(default_factory=Pose3)
    record: KeyframeRecord = field(default_factory=KeyframeRecord)
    left_gray: np.ndarray | None = None
    # Lazy global-descriptor source evaluated ON THE WORKER THREAD (the
    # pipelined trackers hand in a closure over the device-resident frame,
    # so the loop path never re-uploads the image).
    descriptor_provider: "callable | None" = None


class VoEstimator:
    def __init__(
        self,
        matcher: FeatureMatcher,
        calib: StereoCalib,
        window_size: int = 0,
        kf_store_size: int = 2,
        device=None,
    ):
        self.matcher = matcher
        self.calib = calib
        # device: where SUPERSLAM_XLA_SMOOTHER=1 solves the window (None:
        # CUDA, raising without a card).
        self.smoother = WindowSmoother(calib, _resolve_window_size(window_size), device)
        self.tracker = FrameTracker(calib)

        self._has_keyframe = False
        self._last_keyframe_id = 0
        self._last_keyframe_pose = Pose3()
        self._previous_frame_pose = Pose3()
        self._previous_relative = Pose3()  # constant-velocity fallback
        # Device-kf mode: the RAW device-chain pose of the last keyframe.
        # The in-program keyframe chain (ops.frontend_step.track_kf_scan)
        # dead-reckons — its scan carry never sees the window smoother — so
        # adopted device poses are consumed as INCREMENTS against this
        # reference and re-anchored on the smoothed keyframe pose (see
        # _track). None = the device carry was (re)seeded from host state,
        # i.e. the device chain currently coincides with the smoothed frame.
        self._kf_device_pose: Pose3 | None = None
        self._frames_since_keyframe = 0
        self._covisibility_ratio = 0.8
        self._max_keyframe_frames = 20
        self._last_keyframe: StereoFrame | None = None
        self._last_kf_feature_to_landmark: dict[int, int] = {}
        # Retained recent keyframes for pipelined tracking: a frame whose
        # device program was dispatched just before a keyframe insertion may
        # carry matches against the PREVIOUS keyframe; the estimator resolves
        # them against the keyframe they were actually computed from. Must
        # cover the pipeline's in-flight window (depth*batch frames can lag
        # up to ~depth*batch/min_frames insertions); unresolvable refs force
        # a host re-match, which is correct but defeats the fused pipeline.
        self._kf_store: dict[int, tuple[StereoFrame, dict[int, int]]] = {}
        self._kf_store_size = max(2, int(kf_store_size))
        self._next_keyframe_id = 0
        self._global_landmark_id = 0

        # Loop closure (tier 2)
        self._loop_enabled = False
        self._loop_async = True
        self._global_graph: GlobalPoseGraph | None = None
        self._loop_closer: LoopCloser | None = None
        self._worker: threading.Thread | None = None
        self._queue: deque[KeyframeMsg] = deque()
        self._queue_lock = threading.Lock()
        self._queue_cv = threading.Condition(self._queue_lock)
        self._stop_worker = False

        self._correction_lock = threading.Lock()
        self._anchors: dict[int, Pose3] = {}  # corrected KF poses
        self._seed_anchors: dict[int, Pose3] = {}  # VO pose at KF insert
        self._frame_records: list[tuple[int, Pose3]] = []  # (ref_kf, kf->frame)
        self._loop_count = 0
        self._loop_count_lock = threading.Lock()
        self.map = SparseMap()

        # Viewer scalar series (reference RerunViewer.cc:33-41): per-frame
        # tracked-landmark inlier ratio and the latest loop retrieval score
        # (plain float writes; read lock-free by the viewer thread).
        self.last_inlier_ratio = 0.0
        self.last_loop_score = 0.0

    # -- lifecycle -----------------------------------------------------------
    def enable_loop_closure(self, loop_closer: LoopCloser, async_: bool = True) -> None:
        self._global_graph = GlobalPoseGraph()
        self._loop_closer = loop_closer
        self._loop_enabled = True
        self._loop_async = async_
        if async_:
            self._worker = threading.Thread(
                target=self._worker_loop, name="loop-worker", daemon=True
            )
            self._worker.start()

    def stop_loop_worker(self) -> None:
        """Drain and join the async worker. Idempotent."""
        if self._worker is None or not self._worker.is_alive():
            return
        with self._queue_cv:
            self._stop_worker = True
            self._queue_cv.notify_all()
        self._worker.join()

    def loop_closure_count(self) -> int:
        with self._loop_count_lock:
            return self._loop_count

    def set_keyframe_params(self, covisibility_ratio: float, max_frames: int) -> None:
        self._covisibility_ratio = covisibility_ratio
        self._max_keyframe_frames = max_frames

    # -- outputs -------------------------------------------------------------
    def anchors(self) -> dict[int, Pose3]:
        """Loop-corrected anchors, falling back to the VO seed anchors.
        Read only after stop_loop_worker()."""
        return dict(self._anchors) if self._anchors else dict(self._seed_anchors)

    def corrected_trajectory(self) -> list[Pose3]:
        """anchor[ref_kf] * rel per frame record; exact live-VO fallback when
        no loop fired (VoEstimator.cc:181-201)."""
        out = []
        for ref_kf, rel in self._frame_records:
            anchor = self._anchors.get(ref_kf)
            if anchor is None:
                anchor = self._seed_anchors.get(ref_kf, Pose3())
            out.append(anchor * rel)
        return out

    # -- tracking ------------------------------------------------------------
    def track(
        self,
        frame: StereoFrame,
        left_gray: np.ndarray | None = None,
        kf_matches: "MatchResult | None" = None,
        kf_ref_id: int | None = None,
        device_pose: Pose3 | None = None,
        descriptor_provider=None,
        device_accept: bool | None = None,
        device_promote: bool | None = None,
    ) -> Pose3:
        """Track one frame. `kf_matches` optionally carries precomputed
        frame-to-keyframe matches (the fused device pipeline computes them in
        the same XLA program as extraction); when absent the estimator calls
        the matcher itself, as the reference does (VoEstimator.cc:242-247).
        `kf_ref_id` names the keyframe the precomputed matches refer to — in
        pipelined mode it may lag the newest keyframe by one insertion.
        `device_pose` optionally carries the pose solved ON DEVICE in the
        same program (fused_stereo_track_step_multi); it replaces the host
        FrameTracker solve but every gate (coast, keyframe, smoothing) still
        runs here — UNLESS `device_accept`/`device_promote` are given
        (zero-lag device keyframe mode, ops.frontend_step.track_kf_scan):
        then the device already judged the solve by the same support rule
        and ran the keyframe gate in-program, and the estimator ADOPTS both
        decisions verbatim so host map bookkeeping stays in lockstep with
        the device-carried keyframe (re-deciding here in f64 could disagree
        at the gate boundary and desync the keyframe chain).
        `descriptor_provider` lazily supplies the loop worker's global
        descriptor (evaluated on the worker thread) in place of
        `left_gray`."""
        with profile_scope("vo_track_total"):
            return self._track(
                frame, left_gray, kf_matches, kf_ref_id, device_pose,
                descriptor_provider, device_accept, device_promote,
            )

    def _track(
        self,
        frame: StereoFrame,
        left_gray: np.ndarray | None,
        kf_matches: "MatchResult | None",
        kf_ref_id: int | None = None,
        device_pose: Pose3 | None = None,
        descriptor_provider=None,
        device_accept: bool | None = None,
        device_promote: bool | None = None,
    ) -> Pose3:
        n = len(frame)

        if not self._has_keyframe:
            return self._init_first_keyframe(frame, left_gray, descriptor_provider)

        # Match current frame to the reference keyframe (query=KF, train=frame).
        kf = self._last_keyframe
        kf_f2l = self._last_kf_feature_to_landmark
        match_src = "host"
        if kf_matches is not None and kf_ref_id is not None:
            if kf_ref_id == self._last_keyframe_id:
                match_src = "dev-cur"  # matches refer to the current keyframe
            elif kf_ref_id in self._kf_store:
                kf, kf_f2l = self._kf_store[kf_ref_id]
                match_src = "dev-store"
            else:
                # The keyframe these matches were computed against has been
                # evicted (deep pipelines can lag several insertions) —
                # interpreting them against the current keyframe would feed
                # wrong 3D-2D correspondences to the solve. Re-match on host
                # (and drop the device pose AND the device accept/promote
                # bits, all judged against the same evicted keyframe state:
                # a surviving accept bit would exempt the host re-solve from
                # the coast guard).
                kf_matches = None
                device_pose = None
                device_accept = None
                device_promote = None
                match_src = "rematch"
        if kf_matches is not None:
            m = kf_matches
            if os.environ.get("SUPERSLAM_MATCH_XCHECK"):
                mh = self.matcher.match(
                    kf.keypoints_left,
                    kf.descriptors_left,
                    frame.keypoints_left,
                    frame.descriptors_left,
                )
                dev_pairs = {tuple(r) for r in np.asarray(m.matches)}
                host_pairs = {tuple(r) for r in np.asarray(mh.matches)}
                inter = len(dev_pairs & host_pairs)
                print(
                    f"[xchk] dev={len(dev_pairs)} host={len(host_pairs)} "
                    f"agree={inter}",
                    file=sys.stderr,
                )
        else:
            with profile_scope("vo_lg_track_match"):
                m = self.matcher.match(
                    kf.keypoints_left,
                    kf.descriptors_left,
                    frame.keypoints_left,
                    frame.descriptors_left,
                )

        min_matches = env_int("SUPERSLAM_TRACK_MIN_MATCHES", 10)
        accept_frac = env_float("SUPERSLAM_TRACK_ACCEPT_FRAC", 0.4)
        support_px = 2.0 * env_float("SUPERSLAM_TRACK_CHI2_PX", 2.0)

        def _attempt(kf_a, f2l_a, m_a, device_pose_a):
            """Build depth-valid correspondences from one match source,
            solve, and judge the result by SUPPORT — how many of ALL the
            matches the pose explains by reprojection. The acceptance
            criterion is support, not distance to the constant-velocity
            prediction: both pure distance rules fail, measured on the
            rendered circuit:
              * reject-far-solves latches: coasting never updates
                _previous_relative, so one poisoned velocity makes every
                later (correct) solve look like a jump and the coast runs
                away forever (ATE 1.8 -> 11.9 m from one 1.1 m step);
              * accept-near-solves poisons: a gate-starved full-set solve
                that explained 15 of 98 matches still landed within 2 m of
                the prediction and its bad step entered the velocity carry.
            A garbage step explains ~0 matches (the measured 23 m step from
            a bad basin supports none); a genuine recovery after coasting
            explains most. Healthy frames run 75-85% support;
            SUPERSLAM_TRACK_ACCEPT_FRAC (default 0.4, <=0 disables) is the
            floor. A legitimately hard frame (occlusion, low texture)
            coasting one frame is standard VO behavior; what must never
            happen is a low-support pose entering the velocity carry or the
            keyframe map."""
            fml: dict[int, int] = {}
            ki_l: list[int] = []
            fi_l: list[int] = []
            if len(m_a) > 0:
                ki = m_a.matches[:, 0]
                fi = m_a.matches[:, 1]
                ok = (ki >= 0) & (fi >= 0) & (ki < len(kf_a)) & (fi < n)
                ki, fi = ki[ok], fi[ok]
                ok = kf_a.has_depth[ki] & frame.has_depth[fi]
                ki, fi = ki[ok], fi[ok]
                ki_l = ki.tolist()
                fi_l = fi.tolist()
                for kidx, fidx in zip(ki_l, fi_l):
                    lm = f2l_a.get(kidx)
                    if lm is not None:
                        fml[fidx] = lm
            n_m = len(ki_l)
            Xw = meas = None
            n_kept = -1
            if device_accept and device_pose_a is not None:
                # Zero-lag device keyframe mode, ACCEPTED solve: the device
                # judged it by the identical support rule in-program
                # (track_kf_scan); adopt it. The pose is a RAW device-chain
                # pose — _track re-anchors it on the smoothed keyframe (see
                # the `adopted` handling below).
                return {
                    "pose": device_pose_a,
                    "coast": False,
                    "support": -1,
                    "n": n_m,
                    "fml": fml,
                    "ki": ki_l,
                    "fi": fi_l,
                    "Xw": None,
                    "meas": None,
                    "n_kept": -1,
                    "adopted": True,
                }
            if device_accept is False:
                # Device-REJECTED solve: do NOT adopt the device coast. The
                # in-program chain has no rescue machinery by design
                # (track_scan docstring: degenerate-frame recovery lives
                # with the estimator), and its coast compounds: one marginal
                # rejection freezes its velocity carry, every later
                # prediction falls further behind, and the chain rejects
                # until covisibility happens to return (measured on a
                # 0.71 m/frame render: 33 consecutive frozen frames, ATE
                # 4.45 m vs 0.09 host). Fall through to the full host solve
                # on the device's own matches; a host-gate insertion below
                # then reseeds the device carry at the recovered pose.
                device_pose_a = None
            if n_m > 0:
                Xw = kf_a.backproject_all(self.calib, np.asarray(ki_l))
                meas = frame.stereo[np.asarray(fi_l)]
                if device_pose_a is not None:
                    # Solved on device in the fused program against the same
                    # keyframe world points (see frontend.pipelined); the
                    # host LM would converge to the same optimum from its
                    # prior. The device program applies the same min_matches
                    # coast gate to ITS OWN usable-match count (stereo/depth
                    # gates evaluated on device), which can differ by a few
                    # from n_m here right at the gate boundary; on such
                    # frames the adopted pose is the device's solve/coast
                    # decision — an intentional divergence (both paths coast
                    # below their gate either way).
                    pose_a = device_pose_a
                else:
                    # Init at the constant-velocity prediction and gate
                    # matches against it before the LM (track_gated
                    # docstring): Huber alone diverges under the structured
                    # outlier fraction LightGlue produces at keyframe gaps.
                    # The device program (ops.frontend_step.track_scan)
                    # applies the identical recipe. SUPERSLAM_TRACK_GATE=0
                    # restores the plain solve.
                    pred = self._previous_frame_pose * self._previous_relative
                    if env_flag("SUPERSLAM_TRACK_GATE", True):
                        pose_a, _keep = self.tracker.track_gated(
                            pred,
                            Xw,
                            meas,
                            gate_px=env_float("SUPERSLAM_TRACK_GATE_PX", 10.0),
                            chi2_px=env_float("SUPERSLAM_TRACK_CHI2_PX", 2.0),
                            chi2_rounds=env_int(
                                "SUPERSLAM_TRACK_CHI2_ROUNDS", 2
                            ),
                            min_keep=min_matches,
                            init=self._previous_frame_pose,
                        )
                        n_kept = int(_keep.sum())
                    else:
                        pose_a = self.tracker.track_arrays(
                            self._previous_frame_pose, Xw, meas
                        )
            else:
                pose_a = self._previous_frame_pose
            coast_a = n_m < min_matches
            support_a = -1
            if not coast_a:
                if not pose_a.is_finite():
                    coast_a = True
                elif accept_frac > 0:
                    support_a = self.tracker.reproj_support(
                        pose_a, Xw, meas, support_px
                    )
                    coast_a = support_a < max(min_matches, accept_frac * n_m)
            return {
                "pose": pose_a,
                "coast": coast_a,
                "support": support_a,
                "n": n_m,
                "fml": fml,
                "ki": ki_l,
                "fi": fi_l,
                "Xw": Xw,
                "meas": meas,
                "n_kept": n_kept,
            }

        # Lagged matches cost real accuracy even when they nominally succeed:
        # the A/B on the rendered circuit measured pipelined ATE 0.296 m with
        # lagged matches vs 0.103 m re-matching every lagged frame against
        # the newest keyframe — byte-identical to the synchronous path, i.e.
        # the keyframe lag explained the WHOLE pipelined accuracy gap. So
        # host-solved tracking re-matches lagged frames by default, FIRST
        # (the lagged attempt's LM would be discarded whenever the re-match
        # succeeds, which is the measured common case), falling back to the
        # lagged matches only when the re-match solve coasts.
        # SUPERSLAM_FORCE_REMATCH=0 restores rescue-only (one matcher call
        # saved per lagged frame, 3x the ATE). Device-solved tracking keeps
        # rescue-only: its pose was solved in-program against the lagged
        # keyframe, and the zero-lag fix there is in-program keyframe
        # promotion, not a host re-match that would discard the device
        # solve. Rescue rationale either way: repetitive texture aliases
        # the matcher harder the wider the baseline (measured: the same
        # frame that gets 45% geometrically-consistent matches against a
        # 4-frame-old keyframe gets healthy matches against the newest one).
        force_rematch = env_flag("SUPERSLAM_FORCE_REMATCH", device_pose is None)
        lagged = kf is not self._last_keyframe and n > 0
        res = None
        if not (force_rematch and lagged):
            res = _attempt(kf, kf_f2l, m, device_pose)
        if lagged and (res is None or res["coast"]):
            with profile_scope("vo_lg_track_match"):
                m2 = self.matcher.match(
                    self._last_keyframe.keypoints_left,
                    self._last_keyframe.descriptors_left,
                    frame.keypoints_left,
                    frame.descriptors_left,
                )
            res2 = _attempt(
                self._last_keyframe, self._last_kf_feature_to_landmark, m2, None
            )
            if not res2["coast"]:
                res, m = res2, m2
                kf = self._last_keyframe
                kf_f2l = self._last_kf_feature_to_landmark
                match_src = "rematch-cur"
        if res is None:
            # Force mode and the re-match coasted: fall back to the lagged
            # attempt (it may still explain the frame; both coasting is the
            # genuine coast case either way).
            res = _attempt(kf, kf_f2l, m, device_pose)

        n_matches = res["n"]
        frame_matched_landmark = res["fml"]
        kf_idx_list, fr_idx_list = res["ki"], res["fi"]
        Xw, meas = res["Xw"], res["meas"]
        n_kept = res["n_kept"]
        frame_pose = res["pose"]
        coast = res["coast"]
        dev_pose = None
        if res.get("adopted"):
            # The device-kf chain dead-reckons: its scan carry (pose AND the
            # promoted keyframes' world-point grounding) never sees the
            # window smoother, so its absolute poses drift like raw VO while
            # the host keyframe chain is window-smoothed at every insertion.
            # Consuming the device pose verbatim therefore throws the
            # smoother's work away (the anchor*rel identity cancels it
            # exactly: anchor==smoothed KF, rel==smoothed_KF^-1 * dev_pose).
            # Instead, treat the device chain as a RELATIVE odometry source:
            # take its increment since the keyframe's own device-chain pose
            # and re-anchor on the smoothed keyframe pose. Measured on the
            # rendered 150-frame circuit (trained stack, CPU): devkf ATE
            # 0.2112 m raw-chain vs 0.0675 host; this re-anchoring is the
            # designed fix.
            dev_pose = frame_pose
            ref_dev = self._kf_device_pose
            if ref_dev is None:
                # Carry was (re)seeded from host state: the device chain
                # restarted in the smoothed frame at the keyframe itself.
                ref_dev = self._last_keyframe_pose
            frame_pose = self._last_keyframe_pose * (
                ref_dev.inverse() * frame_pose
            )
        self.last_inlier_ratio = n_matches / max(1, len(kf))
        if coast:
            # Adopted frames never coast (device_accept=False frames run the
            # host solve instead — see _attempt), so every coast here is a
            # host-side decision: hold the host velocity.
            frame_pose = self._previous_frame_pose * self._previous_relative
        else:
            self._previous_relative = self._previous_frame_pose.between(frame_pose)

        if os.environ.get("SUPERSLAM_VO_DEBUG"):
            rel_kf = self._last_keyframe_pose.between(frame_pose)
            kept = n_kept
            sup = -1
            if Xw is not None and n_matches > 0:
                sup = self.tracker.reproj_support(frame_pose, Xw, meas, 4.0)
            dump = os.environ.get("SUPERSLAM_DUMP_WEAK")
            if dump and 0 <= sup < 0.3 * n_matches:
                np.savez(
                    f"{dump}_t{frame.timestamp:.3f}.npz",
                    frame_kpts=frame.keypoints_left,
                    frame_stereo=frame.stereo,
                    frame_desc=self.matcher.descriptors_to_host(
                        frame.descriptors_left
                    ),
                    kf_kpts=kf.keypoints_left,
                    kf_stereo=kf.stereo,
                    kf_desc=self.matcher.descriptors_to_host(
                        kf.descriptors_left
                    ),
                    kf_pose=np.concatenate([kf.pose.R.ravel(), kf.pose.t]),
                    matches=np.asarray(m.matches),
                    kf_idx=np.asarray(kf_idx_list),
                    fr_idx=np.asarray(fr_idx_list),
                    solved=np.concatenate(
                        [frame_pose.R.ravel(), frame_pose.t]
                    ),
                )
            print(
                f"[trk] nmatch={n_matches} kept={kept} sup={sup} coast={int(coast)} "
                f"src={match_src} ref={kf_ref_id} cur={self._last_keyframe_id} "
                f"lastKf|t|={self._last_keyframe_pose.translation_norm():.2f} "
                f"res|t|={frame_pose.translation_norm():.2f} "
                f"relKf|t|={rel_kf.translation_norm():.2f}",
                file=sys.stderr,
            )

        # Keyframe gate + insertion. NEVER insert from a coasted frame: the
        # coast pose is a constant-velocity guess, and a keyframe built
        # there backprojects its landmarks at a hallucinated pose —
        # permanently poisoning the map (measured on the rendered circuit:
        # keyframes inserted during a coast spiral left a map NO later pose
        # could explain — support hit 0 on every frame — making recovery
        # impossible even once the solver found the true pose again).
        self._frames_since_keyframe += 1
        covis = env_float("SUPERSLAM_KF_COVIS", self._covisibility_ratio)
        reference_features = len(kf_f2l)
        if device_promote is not None and device_accept is not False:
            # Zero-lag device keyframe mode: the gate already ran in-program
            # with these exact semantics; follow its bit so the host keyframe
            # chain mirrors the device-carried keyframe one-for-one. (Stale
            # frames arrive here with device_accept=None and a forced
            # device_promote=False — insertion authority stays in-program,
            # see frontend.pipelined.drain_one.) Device-REJECTED frames
            # (device_accept=False) take the host branch below: they were
            # host-solved, and a host-gate insertion is the designed
            # recovery — it reseeds the stuck device carry at the rescued
            # pose (drain_one keys the reseed on device_promote=False).
            insert = device_promote and not coast
        else:
            insert = not coast and should_insert_keyframe(
                n_matches,
                reference_features,
                self._frames_since_keyframe,
                covis,
                self._max_keyframe_frames,
            )
        if insert:
            frame_pose = self._insert_keyframe(
                frame, frame_pose, frame_matched_landmark, left_gray,
                descriptor_provider,
            )
            # Device-promoted insertion: remember the new keyframe's RAW
            # device-chain pose so later adopted poses re-anchor against it.
            # Host-initiated insertion: the pipelined tracker reseeds the
            # device carry from host state, after which the device chain
            # coincides with the smoothed frame again (None sentinel).
            self._kf_device_pose = dev_pose if res.get("adopted") else None

        self._previous_frame_pose = frame_pose
        rel_pose = self._last_keyframe_pose.inverse() * frame_pose
        self._frame_records.append((self._last_keyframe_id, rel_pose))
        anchor = self._last_keyframe_pose
        with self._correction_lock:
            corrected = self._anchors.get(self._last_keyframe_id)
        if corrected is not None:
            anchor = corrected
        live = anchor * rel_pose
        frame.pose = live
        return live

    # -- internals -------------------------------------------------------------
    def _retain_keyframe(
        self, kf_id: int, frame: StereoFrame, f2l: dict[int, int]
    ) -> None:
        self._kf_store[kf_id] = (frame, f2l)
        while len(self._kf_store) > self._kf_store_size:
            self._kf_store.pop(next(iter(self._kf_store)))

    def _feature_to_landmark_obs(
        self, frame: StereoFrame, feature_to_landmark: dict[int, int]
    ) -> list[StereoObs]:
        return [
            StereoObs(feature_to_landmark[i], frame.stereo[i])
            for i in range(len(frame))
            if frame.has_depth[i]
        ]

    def _backproject_stereo(self, frame: StereoFrame) -> np.ndarray:
        idx = np.flatnonzero(frame.has_depth)
        if idx.size == 0:
            return np.zeros((0, 3))
        return self.calib.backproject_cam_batch(frame.stereo[idx])

    def _init_first_keyframe(
        self,
        frame: StereoFrame,
        left_gray: np.ndarray | None,
        descriptor_provider=None,
    ) -> Pose3:
        origin = Pose3()
        frame.pose = origin
        feature_to_landmark = {}
        for i in range(len(frame)):
            if frame.has_depth[i]:
                feature_to_landmark[i] = self._global_landmark_id
                self._global_landmark_id += 1
        self.smoother.add_keyframe(
            self._next_keyframe_id,
            origin,
            self._feature_to_landmark_obs(frame, feature_to_landmark),
        )
        self._last_keyframe_id = self._next_keyframe_id
        self._next_keyframe_id += 1
        self._last_keyframe_pose = origin
        self._previous_frame_pose = origin
        self._last_keyframe = frame
        self._last_kf_feature_to_landmark = feature_to_landmark
        self._has_keyframe = True
        self._retain_keyframe(self._last_keyframe_id, frame, feature_to_landmark)

        self.map.add_keyframe(self._last_keyframe_id, self._backproject_stereo(frame))
        self._seed_anchors[self._last_keyframe_id] = origin

        if self._loop_enabled:
            msg = self._make_keyframe_msg(
                self._last_keyframe_id, frame, left_gray, descriptor_provider
            )
            msg.has_previous = False
            self._submit_keyframe(msg)
        self._frame_records.append((self._last_keyframe_id, Pose3()))
        return origin

    def _insert_keyframe(
        self,
        frame: StereoFrame,
        frame_pose: Pose3,
        frame_matched_landmark: dict[int, int],
        left_gray: np.ndarray | None,
        descriptor_provider=None,
    ) -> Pose3:
        self._frames_since_keyframe = 0
        previous_keyframe_id = self._last_keyframe_id
        keyframe_id = self._next_keyframe_id
        self._next_keyframe_id += 1

        # Landmark ids: matched features reuse the KF's id; unmatched stereo
        # mint new ids.
        feature_to_landmark: dict[int, int] = {}
        for i in range(len(frame)):
            if not frame.has_depth[i]:
                continue
            lm = frame_matched_landmark.get(i)
            if lm is None:
                lm = self._global_landmark_id
                self._global_landmark_id += 1
            feature_to_landmark[i] = lm

        self.smoother.add_keyframe(
            keyframe_id, frame_pose, self._feature_to_landmark_obs(frame, feature_to_landmark)
        )
        if not os.environ.get("SUPERSLAM_VO_NO_SMOOTHER"):
            with profile_scope("vo_gtsam_optimize"):
                self.smoother.optimize()
            frame_pose = self.smoother.pose_of(keyframe_id)

        self._last_keyframe_id = keyframe_id
        self._last_keyframe_pose = frame_pose
        self._last_kf_feature_to_landmark = feature_to_landmark
        self._last_keyframe = frame
        self._last_keyframe.pose = frame_pose  # Twc for next-frame backprojection
        self._retain_keyframe(keyframe_id, frame, feature_to_landmark)

        self.map.add_keyframe(keyframe_id, self._backproject_stereo(frame))
        self._seed_anchors[keyframe_id] = frame_pose

        if self._loop_enabled:
            msg = self._make_keyframe_msg(
                keyframe_id, self._last_keyframe, left_gray, descriptor_provider
            )
            msg.has_previous = True
            msg.previous_keyframe_id = previous_keyframe_id
            if self.smoother.in_window(previous_keyframe_id) and self.smoother.in_window(
                keyframe_id
            ):
                msg.relative_odometry = self.smoother.pose_of(
                    previous_keyframe_id
                ).between(self.smoother.pose_of(keyframe_id))
            self._submit_keyframe(msg)
        return frame_pose

    def _make_keyframe_msg(
        self,
        keyframe_id: int,
        frame: StereoFrame,
        left_gray: np.ndarray | None,
        descriptor_provider=None,
    ) -> KeyframeMsg:
        rec = KeyframeRecord(
            keyframe_id=keyframe_id,
            timestamp=frame.timestamp,
            pose_at_insert=frame.pose,
            keypoints_left=frame.keypoints_left,
            # Device-capable matchers keep the record's descriptors in HBM
            # (loop verification consumes them without any host round trip);
            # others materialize float32 rows.
            descriptors_left=getattr(
                self.matcher, "retain_for_matching", self.matcher.descriptors_to_host
            )(frame.descriptors_left),
            stereo=frame.stereo,
            has_depth=frame.has_depth,
        )
        return KeyframeMsg(
            keyframe_id=keyframe_id,
            pose=frame.pose,
            record=rec,
            left_gray=None if left_gray is None else np.array(left_gray, copy=True),
            descriptor_provider=descriptor_provider,
        )

    def _submit_keyframe(self, msg: KeyframeMsg) -> None:
        if self._loop_async:
            with self._queue_cv:
                self._queue.append(msg)
                self._queue_cv.notify()
        else:
            self._process_keyframe(msg)

    def _worker_loop(self) -> None:
        while True:
            with self._queue_cv:
                self._queue_cv.wait_for(lambda: self._stop_worker or self._queue)
                if self._stop_worker and not self._queue:
                    return
                msg = self._queue.popleft()
            try:
                self._process_keyframe(msg)
            except Exception:  # noqa: BLE001 — worker must survive one bad KF
                # A failed keyframe (descriptor provider device error, solver
                # blowup) must not kill loop closure for the rest of the run
                # — degrade to "this keyframe never entered the loop DB"
                # (SURVEY §5.3 failure-handling posture).
                import logging
                import traceback

                logging.getLogger("superslam").error(
                    "loop worker: keyframe %d failed:\n%s",
                    msg.keyframe_id,
                    traceback.format_exc(),
                )

    def _process_keyframe(self, msg: KeyframeMsg) -> None:
        self._global_graph.add_keyframe(
            msg.keyframe_id, msg.pose, is_first=not msg.has_previous
        )
        if msg.has_previous:
            self._global_graph.add_odometry(
                msg.previous_keyframe_id,
                msg.keyframe_id,
                msg.relative_odometry,
                _odometry_sigmas(),
            )

        loop_result = None
        if msg.descriptor_provider is not None:
            msg.record.global_descriptor = msg.descriptor_provider()
        elif msg.left_gray is not None:
            msg.record.global_descriptor = self._loop_closer.compute_global_descriptor(
                msg.left_gray
            )
        if msg.record.global_descriptor is not None:
            self._loop_closer.add_keyframe(msg.record)
            loop_result = self._loop_closer.detect(msg.record)
            self.last_loop_score = loop_result.best_score

        if loop_result is None or not loop_result.accepted:
            return  # no loop; the odometry edge is recorded

        self._global_graph.add_loop(
            loop_result.matched_keyframe,
            msg.keyframe_id,
            loop_result.relative_pose,
            loop_result.noise_sigmas,
        )
        corrected = self._global_graph.optimize_and_get_all()
        if not self._global_graph.last_loop_rejected():
            with self._loop_count_lock:
                self._loop_count += 1
            with self._correction_lock:
                self._anchors = corrected

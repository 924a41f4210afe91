"""Fixed-lag sliding-window smoother with smart stereo factors.

Equivalent of the reference WindowSmoother
(``src/WindowSmoother.cc:38-118``): a deque of the last K
keyframe poses, one smart stereo projection factor per landmark seen in >= 2
window keyframes (landmarks marginalized, poses only), isotropic sigma_px
measurement noise, ZERO_ON_DEGENERACY semantics, dynamic outlier rejection at
3.0 px, a strong gauge prior on the oldest keyframe (sigma 1e-4), and a batch
LM capped at 4 iterations / tol 1e-3. Diverged or throwing solves keep the
previous poses.

One deliberate deviation: the 3 px outlier gate is evaluated once at the
seed poses and frozen for the solve (``_prefilter_groups``), where GTSAM
re-evaluates it at every linearization. The re-evaluated gate makes the LM
cost discontinuous in the keep-set, and on outlier-heavy tracks the
optimizer exploits it — "improving" error by moving poses until landmarks
eject (measured 5-7 m per-solve pose yanks). A window-scale trust region
(SUPERSLAM_WS_MAX_MOVE_M, default 5 m) additionally rejects any solve that
moves a keyframe by metres.

GTSAM's SmartStereoProjectionPoseFactor is implemented here in its
variable-projection form: at every linearization each landmark is
re-triangulated from the current poses (Gauss-Newton on the point, poses
fixed), then eliminated by a per-landmark 3x3 Schur complement, leaving a
dense 6K x 6K reduced camera system. Landmarks are batched by track length so
the whole linearization is a few einsums per group instead of a Python loop
per landmark.
"""

from __future__ import annotations

import os
from collections import OrderedDict, deque
from dataclasses import dataclass

import numpy as np

from ..geometry.se3 import Pose3
from ..geometry.stereo_camera import StereoCalib
from ..utils.env import env_float, env_int
from ..utils.profiler import profile_scope


@dataclass
class StereoObs:
    """A landmark's stereo measurement in one keyframe (WindowSmoother.h:13)."""

    landmark_id: int
    meas: np.ndarray  # (uL, uR, v)


class WindowSmoother:
    DEGENERACY_EPS = 1e-9

    def __init__(self, calib: StereoCalib, window_size: int, device=None):
        self.calib = calib
        self.window_size = int(window_size)
        # Where SUPERSLAM_XLA_SMOOTHER=1 solves (_lm_xla): None is CUDA,
        # which raises without a card; the host LM paths ignore it.
        self.device = device
        # Solve-cadence state (SUPERSLAM_WS_SOLVE_EVERY): number of
        # optimize() calls since the last FULL solve. Seeded high so the
        # first call is always full.
        self._since_full_solve = 1 << 30
        self._window: deque[int] = deque()
        self._poses: "OrderedDict[int, Pose3]" = OrderedDict()
        self._obs: dict[int, list[StereoObs]] = {}
        # Per-keyframe columnar obs (ids (N,) int64, meas (N, 3) float64),
        # mirrors _obs; see add_keyframe.
        self._obs_arr: dict[int, tuple[np.ndarray, np.ndarray]] = {}

    # -- bookkeeping --------------------------------------------------------
    def add_keyframe(
        self, keyframe_id: int, initial_pose: Pose3, obs: list[StereoObs]
    ) -> None:
        self._poses[keyframe_id] = initial_pose
        self._obs[keyframe_id] = obs
        # Columnar copy, built ONCE per insertion: optimize() rebuilds the
        # track groups at every solve (~window_size times per keyframe
        # lifetime), and iterating StereoObs objects there put ~45 ms of
        # pure-Python attribute walks on the tracking drain path.
        if obs:
            self._obs_arr[keyframe_id] = (
                np.array([o.landmark_id for o in obs], dtype=np.int64),
                np.array([o.meas for o in obs], dtype=np.float64),
            )
        else:
            self._obs_arr[keyframe_id] = (
                np.empty((0,), np.int64),
                np.empty((0, 3), np.float64),
            )
        self._window.append(keyframe_id)
        while len(self._window) > self.window_size:  # fixed-lag: drop oldest
            old = self._window.popleft()
            self._poses.pop(old, None)
            self._obs.pop(old, None)
            self._obs_arr.pop(old, None)

    def pose_of(self, keyframe_id: int) -> Pose3:
        return self._poses[keyframe_id]

    def window_count(self) -> int:
        return len(self._window)

    def in_window(self, keyframe_id: int) -> bool:
        return keyframe_id in self._poses

    # -- optimization -------------------------------------------------------
    def optimize(self) -> None:
        if len(self._window) < 2:
            return  # need parallax

        kf_ids = list(self._window)
        K = len(kf_ids)
        idx_of = {k: i for i, k in enumerate(kf_ids)}
        poses = [self._poses[k] for k in kf_ids]

        sigma_px = env_float("SUPERSLAM_SMART_SIGMA_PX", 1.0)
        max_iters = env_int("SUPERSLAM_WS_MAX_ITERS", 4)
        # Solve-cadence amortization for dense keyframe insertion: at the
        # covis-0.75 gate the trained matcher inserts a keyframe every ~2
        # frames and the full window LM (~93 ms at bench shapes) lands on
        # the tracking drain path at every insertion — 46.7 ms/frame of the
        # flagship bench leg (scripts/profile_bench_ab.py; the LM, not the
        # rebuild, dominates after the columnar-rebuild rewrite). With
        # SUPERSLAM_WS_SOLVE_EVERY=k > 1, only every k-th optimize() runs
        # the full max_iters LM; the calls between run a warm-started
        # 1-iteration polish (SUPERSLAM_WS_LIGHT_ITERS) on the same frozen
        # seed-gated landmark set — every keyframe is still smoothed, the
        # deep re-convergence is amortized. Default 1 = historical behavior.
        solve_every = env_int("SUPERSLAM_WS_SOLVE_EVERY", 1)
        if solve_every > 1:
            self._since_full_solve += 1
            if self._since_full_solve >= solve_every:
                self._since_full_solve = 0
            else:
                max_iters = env_int("SUPERSLAM_WS_LIGHT_ITERS", 1)
        dyn_outlier_px = env_float("SUPERSLAM_WS_OUTLIER_PX", 3.0)
        prior_sigma = 1e-4
        prior_pose = poses[0]

        # Group landmark tracks (>=2 views) by track length for batching
        # (profiled as ws_rebuild, matching the reference's scope names).
        with profile_scope("ws_rebuild"):
            # Vectorized rebuild over the per-keyframe columnar copies,
            # ordering-identical to the per-obs Python loop it replaces (~12 ms
            # of attribute walks + per-track np.stack on the drain path):
            # tracks appear in first-observation order, each track's views stay
            # in window order (stable argsort), and the groups dict is keyed in
            # first-seen track-length order.
            ids = np.concatenate([self._obs_arr[kf][0] for kf in kf_ids])
            meas_all = np.concatenate([self._obs_arr[kf][1] for kf in kf_ids])
            view_all = np.concatenate(
                [
                    np.full(self._obs_arr[kf][0].shape[0], idx_of[kf], np.int64)
                    for kf in kf_ids
                ]
            )
            groups: dict[int, tuple[np.ndarray, np.ndarray]] = {}
            if ids.size:
                _u, first, inv, counts = np.unique(
                    ids, return_index=True, return_inverse=True, return_counts=True
                )
                perm = np.argsort(inv, kind="stable")
                starts = np.concatenate(([0], np.cumsum(counts[:-1])))
                views_s = view_all[perm]
                meas_s = meas_all[perm]
                fs_order = np.argsort(first, kind="stable")
                for m in dict.fromkeys(counts[fs_order].tolist()):
                    if m < 2:
                        continue
                    sel = counts == m
                    row_start = starts[sel][np.argsort(first[sel], kind="stable")]
                    gi = row_start[:, None] + np.arange(m)[None, :]
                    groups[int(m)] = (views_s[gi], meas_s[gi])
        if not groups:
            return

        # Robust gating, deviating deliberately from GTSAM's
        # setDynamicOutlierRejectionThreshold (WindowSmoother.cc:77) which
        # re-evaluates the 3 px gate at every linearization. That makes the
        # LM cost discontinuous in the keep-set, and on outlier-heavy tracks
        # the optimizer exploits it — "improving" error by yanking poses
        # until landmarks eject (measured 5-7 m per-solve moves, ATE
        # 1.5 -> 1794 m on the rendered-world sequence). Here instead:
        #   * the gate is evaluated ONCE at the seed poses and FROZEN for the
        #     solve (dyn passed down as 0) — the LM cost stays continuous;
        #   * with the Huber loss on (SUPERSLAM_WS_HUBER_K > 0) the seed gate
        #     is widened 2x, since seed-pose error inflates honest residuals
        #     and the robust loss bounds whatever junk the wider gate admits;
        #   * SUPERSLAM_WS_ROUNDS > 1 re-evaluates the gate at the refined
        #     poses and re-solves (classic optimize/re-gate/re-optimize) —
        #     useful when seeds are systematically off but measurements are
        #     clean; NOT the default, because on outlier-heavy data the
        #     re-gate admits junk consistent with the moved poses (measured
        #     km-scale blowups via tracker feedback).
        max_move = env_float("SUPERSLAM_WS_MAX_MOVE_M", 0.5)
        n_rounds = env_int("SUPERSLAM_WS_ROUNDS", 1)
        huber_k = env_float("SUPERSLAM_WS_HUBER_K", 1.345)
        seed_gate = dyn_outlier_px * (2.0 if huber_k > 0 else 1.0)
        seeds = poses
        accepted = None
        if os.environ.get("SUPERSLAM_XLA_SMOOTHER") == "1":
            # Outside the catch below: without a card the knob raises, it
            # does not keep the seed poses unnoticed.
            self._solver_device()
        try:
            with profile_scope("ws_solve"):
                for _round in range(n_rounds):
                    with profile_scope("ws_gate"):
                        fgroups = self._prefilter_groups(
                            poses, groups, seed_gate
                        )
                    if not fgroups:
                        break
                    if os.environ.get("SUPERSLAM_WS_DEBUG") == "1":
                        _L = sum(v.shape[0] for v, _ in fgroups.values())
                        print(
                            f"[ws] K={K} L={_L} m_max={max(fgroups)} "
                            f"iters={max_iters}",
                            flush=True,
                        )
                    with profile_scope("ws_lm"):
                        result = self._solve_backend(
                            poses, fgroups, sigma_px, prior_pose, prior_sigma,
                            max_iters, huber_k,
                        )
                    if result is None:
                        break
                    # Divergence guards: non-finite / exploded
                    # (WindowSmoother.cc:106-109) plus a window-scale trust
                    # region — a batch refinement of VO-seeded keyframes has
                    # no business moving any pose by metres; a solve that
                    # does is chasing outlier tracks and keeping the seeds is
                    # strictly safer. SUPERSLAM_WS_MAX_MOVE_M tunes
                    # (<=0 disables).
                    bad = False
                    for p, seed in zip(result, seeds):
                        if not p.is_finite() or p.translation_norm() > 1e6:
                            bad = True
                            break
                        if max_move > 0 and (
                            np.linalg.norm(p.t - seed.t) > max_move
                        ):
                            bad = True
                            break
                    if bad:
                        break
                    accepted = result
                    poses = result
        except Exception:
            pass  # keep best-so-far poses (WindowSmoother.cc:112-116)

        if accepted is None:
            return
        for kf, p in zip(kf_ids, accepted):
            self._poses[kf] = p

    def _solve_backend(
        self,
        poses: list[Pose3],
        groups: dict,
        sigma_px: float,
        prior_pose: Pose3,
        prior_sigma: float,
        max_iters: int,
        huber_k: float = 0.0,
    ) -> list[Pose3] | None:
        """One LM pass on a frozen landmark set via the selected backend."""
        if os.environ.get("SUPERSLAM_XLA_SMOOTHER") == "1":
            return self._lm_xla(
                poses, groups, sigma_px, 0.0, max_iters, huber_k
            )
        if os.environ.get("SUPERSLAM_NATIVE", "1") != "0":
            from .. import native

            if native.available():
                return self._lm_native(
                    poses, groups, sigma_px, 0.0, prior_sigma, max_iters,
                    huber_k,
                )
        return self._lm(
            poses, groups, sigma_px, 0.0, prior_pose, prior_sigma, max_iters,
            huber_k,
        )

    # -- internals ----------------------------------------------------------
    def _prefilter_groups(
        self, poses: list[Pose3], groups: dict, dyn_outlier_px: float
    ) -> dict:
        """Apply the dynamic-outlier gate once, at the seed poses.

        Triangulates every track from the seeds and drops landmarks whose max
        per-view reprojection error exceeds ``dyn_outlier_px`` (or that fail
        cheirality). The surviving set is then held fixed for the LM.

        All track-length groups are merged into ONE zero-padded (L, m_max)
        batch so the gate is a handful of large einsums instead of
        5-GN-iterations-per-group of small ones (~22 ms of the tracking
        drain path at window 10 x 350 obs). Padding with zeroed residual/
        Jacobian terms is float-exact: appending +0.0 to a sum never changes
        it, so the keep-set is bitwise the per-group reference's
        (tests/test_window_smoother.py pins this on random windows)."""
        if dyn_outlier_px <= 0:
            return groups
        try:
            m_max = max(groups)
            L = sum(v.shape[0] for v, _ in groups.values())
            views = np.zeros((L, m_max), np.int64)
            meas = np.zeros((L, m_max, 3), np.float64)
            valid = np.zeros((L, m_max), bool)
            mlen = np.zeros((L,), np.int32)
            offs: dict[int, tuple[int, int]] = {}
            r0 = 0
            for m, (v, x) in groups.items():
                n = v.shape[0]
                views[r0 : r0 + n, :m] = v
                meas[r0 : r0 + n, :m] = x
                valid[r0 : r0 + n, :m] = True
                mlen[r0 : r0 + n] = m
                offs[m] = (r0, n)
                r0 += n
            if os.environ.get("SUPERSLAM_NATIVE", "1") != "0":
                # Hot path: the gate sits on the tracking drain at every
                # keyframe insertion and the numpy batch below is 80-90% of
                # ws_solve (15-40 ms vs ~3 ms for the native LM). Same
                # frozen-at-seeds semantics, C++ (keep-set parity pinned by
                # tests/test_native_core.py on random windows).
                from .. import native

                if native.available():
                    keep_all = native.window_seed_gate(
                        poses, views, meas, mlen, self.calib, dyn_outlier_px
                    )
                    out_nat: dict[int, tuple[np.ndarray, np.ndarray]] = {}
                    for m, (v, x) in groups.items():
                        r0, n = offs[m]
                        keep = keep_all[r0 : r0 + n]
                        if keep.any():
                            out_nat[m] = (v[keep], x[keep])
                    return out_nat
            R, t = self._pose_arrays(poses)
            X, ok = self._triangulate_padded(R, t, views, meas, valid)
            Rv, tv = R[views], t[views]
            p = np.einsum("lmji,lmj->lmi", Rv, X[:, None, :] - tv)
            z = p[..., 2]
            zs = np.where(z > self.DEGENERACY_EPS, z, 1.0)
            r = self._residuals_from_cam(p, 1.0 / zs, meas)
            r = np.where(valid[..., None], r, 0.0)
            maxerr = np.max(np.linalg.norm(r, axis=-1), axis=-1)
            keep_all = ok & (maxerr < dyn_outlier_px)
        except np.linalg.LinAlgError:
            # The reference path isolates a singular batch to its group;
            # the merged solve cannot, so fall back wholesale.
            return self._prefilter_groups_ref(poses, groups, dyn_outlier_px)
        out: dict[int, tuple[np.ndarray, np.ndarray]] = {}
        for m, (v, x) in groups.items():
            r0, n = offs[m]
            keep = keep_all[r0 : r0 + n]
            if keep.any():
                out[m] = (v[keep], x[keep])
        return out

    def _prefilter_groups_ref(
        self, poses: list[Pose3], groups: dict, dyn_outlier_px: float
    ) -> dict:
        """Per-group reference implementation of the seed gate (the merged
        fast path above is pinned to it bitwise)."""
        if dyn_outlier_px <= 0:
            return groups
        R, t = self._pose_arrays(poses)
        out: dict[int, tuple[np.ndarray, np.ndarray]] = {}
        for m, (views, meas) in groups.items():
            X, ok = self._triangulate_group(R, t, views, meas)
            Rv, tv = R[views], t[views]
            p = np.einsum("lmji,lmj->lmi", Rv, X[:, None, :] - tv)
            z = p[..., 2]
            zs = np.where(z > self.DEGENERACY_EPS, z, 1.0)
            r = self._residuals_from_cam(p, 1.0 / zs, meas)
            maxerr = np.max(np.linalg.norm(r, axis=-1), axis=-1)
            keep = ok & (maxerr < dyn_outlier_px)
            if keep.any():
                out[m] = (views[keep], meas[keep])
        return out

    def _pose_arrays(self, poses: list[Pose3]) -> tuple[np.ndarray, np.ndarray]:
        R = np.stack([p.R for p in poses])  # (K,3,3)
        t = np.stack([p.t for p in poses])  # (K,3)
        return R, t

    def _triangulate_group(
        self,
        R: np.ndarray,
        t: np.ndarray,
        views: np.ndarray,
        meas: np.ndarray,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Batched GN point triangulation for one track-length group.

        Returns (X (L,3) world points, ok (L,) validity). Poses fixed.
        """
        c = self.calib
        Rv = R[views]  # (L,m,3,3)
        tv = t[views]  # (L,m,3)
        L, m = views.shape

        # Init from the first view's stereo backprojection, lifted to world.
        uL0, uR0, v0 = meas[:, 0, 0], meas[:, 0, 1], meas[:, 0, 2]
        disp0 = uL0 - uR0
        ok = disp0 > 1e-6
        z0 = c.bf / np.where(ok, disp0, 1.0)
        cam0 = np.stack(
            [(uL0 - c.cx) * z0 / c.fx, (v0 - c.cy) * z0 / c.fy, z0], axis=1
        )
        X = np.einsum("lij,lj->li", Rv[:, 0], cam0) + tv[:, 0]

        for _ in range(5):
            p = np.einsum("lmji,lmj->lmi", Rv, X[:, None, :] - tv)  # (L,m,3) cam
            z = p[..., 2]
            ok = ok & np.all(z > self.DEGENERACY_EPS, axis=1)
            zs = np.where(z > self.DEGENERACY_EPS, z, 1.0)
            iz = 1.0 / zs
            r = self._residuals_from_cam(p, iz, meas)  # (L,m,3)
            Jp = self._proj_jacobian(p, iz)  # (L,m,3,3)
            Jx = np.einsum("lmij,lmkj->lmik", Jp, Rv)  # dproj/dX = Jp @ R^T
            A = np.einsum("lmij,lmik->ljk", Jx, Jx)  # (L,3,3)
            g = np.einsum("lmij,lmi->lj", Jx, r)
            A = A + 1e-9 * np.eye(3)
            try:
                delta = -np.linalg.solve(A, g[..., None])[..., 0]
            except np.linalg.LinAlgError:
                return X, np.zeros(L, dtype=bool)
            X = X + np.where(ok[:, None], delta, 0.0)

        # Final validity: all views in front and well-conditioned.
        p = np.einsum("lmji,lmj->lmi", Rv, X[:, None, :] - tv)
        ok = ok & np.all(p[..., 2] > self.DEGENERACY_EPS, axis=1)
        ok = ok & np.isfinite(X).all(axis=1)
        return X, ok

    def _triangulate_padded(
        self,
        R: np.ndarray,
        t: np.ndarray,
        views: np.ndarray,
        meas: np.ndarray,
        valid: np.ndarray,
    ) -> tuple[np.ndarray, np.ndarray]:
        """_triangulate_group over a zero-padded (L, m_max) batch: padded
        view slots contribute exactly-zero residual/Jacobian terms and are
        excluded from the cheirality test, so every track's result is
        bitwise what the unpadded per-group call computes (view 0 is always
        real: tracks have >= 2 views)."""
        c = self.calib
        Rv = R[views]  # (L,m,3,3)
        tv = t[views]  # (L,m,3)
        L, m = views.shape

        uL0, uR0, v0 = meas[:, 0, 0], meas[:, 0, 1], meas[:, 0, 2]
        disp0 = uL0 - uR0
        ok = disp0 > 1e-6
        z0 = c.bf / np.where(ok, disp0, 1.0)
        cam0 = np.stack(
            [(uL0 - c.cx) * z0 / c.fx, (v0 - c.cy) * z0 / c.fy, z0], axis=1
        )
        X = np.einsum("lij,lj->li", Rv[:, 0], cam0) + tv[:, 0]

        for _ in range(5):
            p = np.einsum("lmji,lmj->lmi", Rv, X[:, None, :] - tv)
            z = p[..., 2]
            ok = ok & np.all((z > self.DEGENERACY_EPS) | ~valid, axis=1)
            zs = np.where(z > self.DEGENERACY_EPS, z, 1.0)
            iz = 1.0 / zs
            r = self._residuals_from_cam(p, iz, meas)
            Jp = self._proj_jacobian(p, iz)
            Jx = np.einsum("lmij,lmkj->lmik", Jp, Rv)
            Jx = np.where(valid[..., None, None], Jx, 0.0)
            r = np.where(valid[..., None], r, 0.0)
            A = np.einsum("lmij,lmik->ljk", Jx, Jx)
            g = np.einsum("lmij,lmi->lj", Jx, r)
            A = A + 1e-9 * np.eye(3)
            delta = -np.linalg.solve(A, g[..., None])[..., 0]
            X = X + np.where(ok[:, None], delta, 0.0)

        p = np.einsum("lmji,lmj->lmi", Rv, X[:, None, :] - tv)
        ok = ok & np.all((p[..., 2] > self.DEGENERACY_EPS) | ~valid, axis=1)
        ok = ok & np.isfinite(X).all(axis=1)
        return X, ok

    def _residuals_from_cam(
        self, p: np.ndarray, iz: np.ndarray, meas: np.ndarray
    ) -> np.ndarray:
        c = self.calib
        proj = np.empty_like(p)
        proj[..., 0] = c.fx * p[..., 0] * iz + c.cx
        proj[..., 1] = c.fx * (p[..., 0] - c.baseline) * iz + c.cx
        proj[..., 2] = c.fy * p[..., 1] * iz + c.cy
        return proj - meas

    def _proj_jacobian(self, p: np.ndarray, iz: np.ndarray) -> np.ndarray:
        """(...,3) cam points -> (...,3,3) d(uL,uR,v)/dp_cam."""
        c = self.calib
        iz2 = iz * iz
        J = np.zeros(p.shape[:-1] + (3, 3))
        J[..., 0, 0] = c.fx * iz
        J[..., 0, 2] = -c.fx * p[..., 0] * iz2
        J[..., 1, 0] = c.fx * iz
        J[..., 1, 2] = -c.fx * (p[..., 0] - c.baseline) * iz2
        J[..., 2, 1] = c.fy * iz
        J[..., 2, 2] = -c.fy * p[..., 1] * iz2
        return J

    def _error_and_points(
        self,
        poses: list[Pose3],
        groups: dict,
        inv_sigma: float,
        dyn_outlier_px: float,
        prior_pose: Pose3,
        prior_info: float,
        huber_k: float = 0.0,
    ) -> float:
        """Total robust chi2 with fresh triangulation (smart-factor error).

        huber_k > 0 applies a Huber loss on the whitened per-view residual
        norm (rho = 0.5 e^2 for e <= k, k*e - 0.5 k^2 beyond); 0 is the plain
        quadratic (GTSAM-parity) cost."""
        R, t = self._pose_arrays(poses)
        err = 0.0
        for m, (views, meas) in groups.items():
            X, ok = self._triangulate_group(R, t, views, meas)
            if not ok.any():
                continue
            Rv, tv = R[views], t[views]
            p = np.einsum("lmji,lmj->lmi", Rv, X[:, None, :] - tv)
            z = p[..., 2]
            zs = np.where(z > self.DEGENERACY_EPS, z, 1.0)
            r = self._residuals_from_cam(p, 1.0 / zs, meas)
            # Dynamic outlier rejection: max per-view reprojection error (px).
            maxerr = np.max(np.linalg.norm(r, axis=-1), axis=-1)
            keep = ok & (maxerr < dyn_outlier_px) if dyn_outlier_px > 0 else ok
            if not keep.any():
                continue
            rw = r[keep] * inv_sigma
            e = np.linalg.norm(rw, axis=-1)
            if huber_k > 0:
                rho = np.where(
                    e <= huber_k,
                    0.5 * e * e,
                    huber_k * e - 0.5 * huber_k * huber_k,
                )
                err += float(np.sum(rho))
            else:
                err += 0.5 * float(np.sum(e * e))
        dxi = prior_pose.local(poses[0])
        err += 0.5 * float(dxi @ dxi) * prior_info
        return err

    def _lm_native(
        self,
        poses: list[Pose3],
        groups: dict,
        sigma_px: float,
        dyn_outlier_px: float,
        prior_sigma: float,
        max_iters: int,
        huber_k: float = 0.0,
    ) -> list[Pose3] | None:
        """Native C++ window LM (csrc ssl_window_lm) — the same VarPro
        smart-factor semantics as _lm (the numpy oracle, pinned by
        tests/test_native_core.py), 5-10x faster on this single-core host
        where the solve sits on the tracking drain path at every keyframe."""
        from .. import native

        m_max = max(groups)
        L = sum(v.shape[0] for v, _ in groups.values())
        views = np.zeros((L, m_max), np.int32)
        meas = np.zeros((L, m_max, 3), np.float64)
        mlen = np.zeros((L,), np.int32)
        r = 0
        for m in sorted(groups):
            v, x = groups[m]
            n = v.shape[0]
            views[r : r + n, :m] = v
            meas[r : r + n, :m] = x
            mlen[r : r + n] = m
            r += n
        return native.window_lm(
            poses, views, meas, mlen, self.calib,
            inv_sigma=1.0 / sigma_px,
            dyn_outlier_px=dyn_outlier_px,
            prior_info=1.0 / (prior_sigma * prior_sigma),
            max_iters=max_iters,
            huber_k=huber_k,
        )

    def _lm_xla(
        self,
        poses: list[Pose3],
        groups: dict,
        sigma_px: float,
        dyn_outlier_px: float,
        max_iters: int,
        huber_k: float = 0.0,
    ) -> list[Pose3] | None:
        """SUPERSLAM_XLA_SMOOTHER=1: the whole window LM on the smoother's
        device (ops/window_solver.py::solve_window, oracle-pinned to the
        numpy path). Groups are merged into ONE padded (L, m_max) problem
        with L bucketed to multiples of 64, the JAX package's shapes (the
        padded rows are masked out). The one host read is the result's
        copy."""
        import torch

        from ..ops.window_solver import solve_window

        dev = self._solver_device()
        K = len(poses)
        m_max = max(groups)
        L = sum(v.shape[0] for v, _ in groups.values())
        Lp = max(64, -(-L // 64) * 64)
        views = np.zeros((Lp, m_max), np.int64)
        meas = np.zeros((Lp, m_max, 3), np.float32)
        obs_valid = np.zeros((Lp, m_max), bool)
        lm_valid = np.zeros((Lp,), bool)
        r = 0
        for m in sorted(groups):
            v, x = groups[m]
            n = v.shape[0]
            views[r : r + n, :m] = v
            meas[r : r + n, :m] = x
            obs_valid[r : r + n, :m] = True
            lm_valid[r : r + n] = True
            r += n
        c = self.calib

        def up(a):
            # pinned, so the copy does not wait for the queued frame steps
            t = torch.from_numpy(a)
            return t.pin_memory().to(dev, non_blocking=True) if dev.type == "cuda" else t

        R, t = solve_window(
            up(np.stack([p.R for p in poses]).astype(np.float32)),
            up(np.stack([p.t for p in poses]).astype(np.float32)),
            up(views),
            up(meas),
            up(lm_valid),
            up(obs_valid),
            (c.fx, c.fy, c.cx, c.cy, c.baseline),
            inv_sigma=1.0 / sigma_px,
            dyn_outlier_px=dyn_outlier_px,
            prior_info=1e8,  # gauge prior sigma 1e-4, as the numpy path
            num_poses=K,
            max_iters=max_iters,
            huber_k=huber_k,
        )
        R = R.cpu().numpy().astype(np.float64)
        t = t.cpu().numpy().astype(np.float64)
        out = []
        for k in range(K):
            # re-orthonormalize the f32 rotation before it re-enters the
            # f64 geometry stack
            u, _, vt = np.linalg.svd(R[k])
            out.append(Pose3(R=u @ vt, t=t[k]))
        return out

    def _solver_device(self):
        from ..utils.device import resolve_device

        return resolve_device(self.device if self.device is not None else "cuda")

    def _lm(
        self,
        poses: list[Pose3],
        groups: dict,
        sigma_px: float,
        dyn_outlier_px: float,
        prior_pose: Pose3,
        prior_sigma: float,
        max_iters: int,
        huber_k: float = 0.0,
    ) -> list[Pose3] | None:
        K = len(poses)
        inv_sigma = 1.0 / sigma_px
        prior_info = 1.0 / (prior_sigma * prior_sigma)

        err = self._error_and_points(
            poses, groups, inv_sigma, dyn_outlier_px, prior_pose, prior_info,
            huber_k,
        )
        lam, lam_factor = 1e-5, 10.0
        rel_tol = abs_tol = 1e-3

        for _ in range(max_iters):
            Hb = self._build_reduced_system(
                poses, groups, inv_sigma, dyn_outlier_px, prior_pose,
                prior_info, huber_k,
            )
            if Hb is None:
                return poses
            H, b = Hb

            stepped = False
            for _try in range(8):
                try:
                    delta = np.linalg.solve(H + lam * np.eye(6 * K), -b)
                except np.linalg.LinAlgError:
                    lam *= lam_factor
                    continue
                cand = [
                    p.retract(delta[6 * i : 6 * i + 6]) for i, p in enumerate(poses)
                ]
                cand_err = self._error_and_points(
                    cand, groups, inv_sigma, dyn_outlier_px, prior_pose,
                    prior_info, huber_k,
                )
                if cand_err < err:
                    improvement = err - cand_err
                    poses, err = cand, cand_err
                    lam = max(lam / lam_factor, 1e-10)
                    stepped = True
                    if improvement < rel_tol * max(err, 1.0) or improvement < abs_tol:
                        return poses
                    break
                lam *= lam_factor
                if lam > 1e8:
                    return poses
            if not stepped:
                return poses
        return poses

    def _build_reduced_system(
        self,
        poses: list[Pose3],
        groups: dict,
        inv_sigma: float,
        dyn_outlier_px: float,
        prior_pose: Pose3,
        prior_info: float,
        huber_k: float = 0.0,
    ) -> tuple[np.ndarray, np.ndarray] | None:
        """Schur-reduced camera system: H (6K,6K), b (6K).

        Per landmark: whitened residual r (m,3), pose Jacobians U_j (3,6),
        point Jacobian Jx (m,3,3). Eliminate the point:
          H_jk += U_j^T U_j [j==k]  -  W_j A^-1 W_k^T,  W_j = U_j^T Jx_j
          b_j  += U_j^T r_j        -  W_j A^-1 (sum_k Jx_k^T r_k)
        Batched over all landmarks with the same track length.
        """
        K = len(poses)
        R, t = self._pose_arrays(poses)
        Hblk = np.zeros((K, K, 6, 6))
        bblk = np.zeros((K, 6))
        any_factor = False

        for m, (views, meas) in groups.items():
            X, ok = self._triangulate_group(R, t, views, meas)
            Rv, tv = R[views], t[views]
            p = np.einsum("lmji,lmj->lmi", Rv, X[:, None, :] - tv)  # (L,m,3) cam
            z = p[..., 2]
            zs = np.where(z > self.DEGENERACY_EPS, z, 1.0)
            iz = 1.0 / zs
            r = self._residuals_from_cam(p, iz, meas)
            maxerr = np.max(np.linalg.norm(r, axis=-1), axis=-1)
            keep = ok & (maxerr < dyn_outlier_px) if dyn_outlier_px > 0 else ok
            if not keep.any():
                continue
            any_factor = True
            views_k = views[keep]
            p, iz, r = p[keep], iz[keep], r[keep]
            Rv = Rv[keep]

            Jp = self._proj_jacobian(p, iz)  # (L,m,3,3)
            # Pose Jacobian: d p_cam/d xi = [skew(p_cam), -I] (right retract).
            L = p.shape[0]
            Dcam = np.zeros((L, m, 3, 6))
            Dcam[..., 0, 1] = -p[..., 2]
            Dcam[..., 0, 2] = p[..., 1]
            Dcam[..., 1, 0] = p[..., 2]
            Dcam[..., 1, 2] = -p[..., 0]
            Dcam[..., 2, 0] = -p[..., 1]
            Dcam[..., 2, 1] = p[..., 0]
            Dcam[..., 0, 3] = -1.0
            Dcam[..., 1, 4] = -1.0
            Dcam[..., 2, 5] = -1.0
            U = np.einsum("lmij,lmjk->lmik", Jp, Dcam) * inv_sigma  # (L,m,3,6)
            Jx = np.einsum("lmij,lmkj->lmik", Jp, Rv) * inv_sigma  # (L,m,3,3)
            rw = r * inv_sigma
            if huber_k > 0:
                # IRLS Huber: scale each view's whitened residual/Jacobian by
                # sqrt(min(1, k/e)) so outlier views have bounded influence.
                e = np.linalg.norm(rw, axis=-1)  # (L,m)
                sw = np.sqrt(np.minimum(1.0, huber_k / np.maximum(e, 1e-12)))
                U = U * sw[..., None, None]
                Jx = Jx * sw[..., None, None]
                rw = rw * sw[..., None]

            A = np.einsum("lmij,lmik->ljk", Jx, Jx) + 1e-12 * np.eye(3)
            try:
                Ainv = np.linalg.inv(A)  # (L,3,3)
            except np.linalg.LinAlgError:
                continue
            W = np.einsum("lmij,lmik->lmjk", U, Jx)  # (L,m,6,3) = U^T Jx
            gx = np.einsum("lmij,lmi->lj", Jx, rw)  # (L,3)
            Ainv_gx = np.einsum("lij,lj->li", Ainv, gx)  # (L,3)

            # Diagonal contributions + gradient.
            Hdiag = np.einsum("lmij,lmik->lmjk", U, U)  # (L,m,6,6)
            gdiag = np.einsum("lmij,lmi->lmj", U, rw)  # (L,m,6)
            gcorr = np.einsum("lmjk,lk->lmj", W, Ainv_gx)  # (L,m,6)
            WAinv = np.einsum("lmjk,lki->lmji", W, Ainv)  # (L,m,6,3)

            for j in range(m):
                vj = views_k[:, j]
                np.add.at(bblk, vj, gdiag[:, j] - gcorr[:, j])
                np.add.at(Hblk, (vj, vj), Hdiag[:, j])
                for k in range(m):
                    vk = views_k[:, k]
                    corr = np.einsum(
                        "lji,lki->ljk", WAinv[:, j], W[:, k]
                    )  # (L,6,6)
                    np.add.at(Hblk, (vj, vk), -corr)

        if not any_factor:
            return None

        H = Hblk.transpose(0, 2, 1, 3).reshape(6 * K, 6 * K)
        b = bblk.reshape(6 * K)
        # Gauge prior on the oldest keyframe.
        dxi = prior_pose.local(poses[0])
        H[:6, :6] += prior_info * np.eye(6)
        b[:6] += prior_info * dxi
        return H, b

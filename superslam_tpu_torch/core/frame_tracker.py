"""Motion-only pose solve (Levenberg-Marquardt over SE(3)).

Equivalent of the reference FrameTracker
(``src/FrameTracker.cc:16-31``): one pose-only stereo factor
per match, Huber(sqrt(7.815)) over the disparity-aware diagonal noise, a
single 6-DOF variable, batch LM. Also reused as the loop-closure geometric
verifier seeded at identity (``src/LoopCloser.cc:72``).

All factor evaluation is batched (see core.factors); each LM iteration is a
handful of numpy GEMMs plus one 6x6 solve.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..geometry.se3 import Pose3
from ..geometry.stereo_camera import StereoCalib
from .factors import (
    HUBER_K,
    batch_stereo_factor,
    huber_loss,
    huber_weights,
    stereo_diag_sigmas,
)


@dataclass
class PointObs:
    """A triangulated 3D world point and its stereo measurement (uL,uR,v)
    in the current frame. Mirrors FrameTracker.h:10-14."""

    Xw: np.ndarray
    meas: np.ndarray


class FrameTracker:
    """Pose-only LM tracker. Tracking sigma_px = 10.0 (FrameTracker.cc:24)."""

    def __init__(self, calib: StereoCalib, sigma_px: float = 10.0):
        self.calib = calib
        self.sigma_px = sigma_px

    def track(self, initial_guess: Pose3, matches: list[PointObs]) -> Pose3:
        if not matches:
            return initial_guess
        Xw = np.stack([m.Xw for m in matches])
        meas = np.stack([m.meas for m in matches])
        return self.track_arrays(initial_guess, Xw, meas)

    def _reproj_residuals(
        self, pose: Pose3, Xw: np.ndarray, meas: np.ndarray
    ) -> tuple[np.ndarray, np.ndarray]:
        """(uL, v) reprojection distance at `pose` plus a Z>0.1 cheirality
        mask — the gating/support metric shared by track_gated and
        reproj_support."""
        p = pose.transform_to(Xw)
        z = p[:, 2]
        zok = z > 0.1
        zs = np.where(zok, z, 1.0)
        uL = self.calib.fx * p[:, 0] / zs + self.calib.cx
        v = self.calib.fy * p[:, 1] / zs + self.calib.cy
        return np.hypot(uL - meas[:, 0], v - meas[:, 2]), zok

    def reproj_support(
        self, pose: Pose3, Xw: np.ndarray, meas: np.ndarray, px: float
    ) -> int:
        """How many of ALL matches `pose` explains: count with positive
        depth and (uL, v) reprojection error under `px`. The acceptance
        signal the estimator uses to distinguish a genuinely-recovered
        solve from a garbage step (a wrong pose explains only its own
        outlier subset; see VoEstimator coast guard)."""
        r, zok = self._reproj_residuals(pose, Xw, meas)
        return int((zok & (r < px)).sum())

    def track_gated(
        self,
        predicted: Pose3,
        Xw: np.ndarray,
        meas: np.ndarray,
        *,
        gate_px: float = 10.0,
        chi2_px: float = 2.0,
        chi2_rounds: int = 2,
        min_keep: int = 10,
        init: Pose3 | None = None,
        rescue_frac: float = 0.5,
    ) -> tuple[Pose3, np.ndarray]:
        """Prior-gated robust solve: reject matches against the PREDICTED
        pose before the LM ever sees them, then re-solve on shrinking chi2
        inlier sets.

        The plain Huber LM diverges under structured outliers: at keyframe
        gaps ~35% of LightGlue matches can be coherent mismatches whose
        bounded-but-nonzero Huber gradients pull the optimum a meter away,
        and post-hoc rejection at that wrong pose then keeps the wrong set
        (measured on a rendered stereo circuit: gap-5 solves diverged to
        meter scale; with this recipe 2.3 cm mean / 3.6 cm max). The same
        idea as ORB-SLAM's projection-window search before pose
        optimization; the reference relies on GTSAM Huber alone
        (``src/FrameTracker.cc:16-31``).

        Recipe (steps 1-4 mirrored by the on-device ``track_scan`` gate;
        steps 2b and 5 are host-side recovery — the device chain cannot
        latch the way the host estimator's coast guard can, see below):
          1. project all world points at `predicted`; keep matches whose
             (uL, v) reprojection distance is under `gate_px` and Z > 0.1;
          2. if fewer than `min_keep` survive, retry at 2x then 4x the
             gate before falling back to the full set — a mildly-wrong
             prediction (sharp turn, post-coast) starves the tight gate
             while a widened one still excludes the gross structured
             outliers (measured: the full-set fallback is what poisoned
             the velocity carry into a permanent coast spiral on the
             rendered circuit, frame 94: one 1.1 m step at 0.2 m/frame
             true motion);
          3. LM from `init` (default `predicted`) on the kept set;
          4. `chi2_rounds` times: re-project at the current estimate, keep
             residuals under `chi2_px` (stop if fewer than `min_keep`),
             re-solve from the current estimate;
          5. rescue: if the result explains under `rescue_frac` of ALL
             matches (support at 2*chi2_px), re-solve from `init` on the
             full set AND on the complement of the kept set (same chi2
             rounds each) and keep whichever pose has the most full-set
             support — when the prediction itself is bad, the gate keeps
             a subset consistent with the bad prediction and the solve
             self-confirms; the rejected rows then hold the true
             consensus, and the full-set Huber can stall in the kept
             minority's zero-residual minimum, so both are tried.

        `init` exists because gating at the prediction and INITIALIZING at
        the prediction are different decisions: the estimator gates at the
        constant-velocity prediction but inits at the previous pose —
        init-at-prediction extrapolates the solver's own residual error
        through the velocity carry and diverges on weakly-observable
        geometry (measured: a 120-frame far-wall corridor run walks off to
        inf), while gate-at-prediction is what rejects the structured
        outliers.

        Returns (pose, kept mask over the input rows).
        """
        if init is None:
            init = predicted
        n_in = Xw.shape[0]
        if n_in == 0:
            return predicted, np.zeros(0, bool)

        def resid(pose: Pose3) -> tuple[np.ndarray, np.ndarray]:
            return self._reproj_residuals(pose, Xw, meas)

        def chi2_refine(pose: Pose3, keep: np.ndarray) -> tuple[Pose3, np.ndarray]:
            for _ in range(chi2_rounds):
                r, zok = resid(pose)
                k2 = zok & (r < chi2_px)
                if k2.sum() < min_keep:
                    break
                keep = k2
                pose = self.track_arrays(pose, Xw[keep], meas[keep])
            return pose, keep

        keep = np.ones(n_in, bool)
        starved_seed = None
        if gate_px > 0:
            r0, zok = resid(predicted)
            for g in (gate_px, 2.0 * gate_px, 4.0 * gate_px):
                k0 = zok & (r0 < g)
                if k0.sum() >= min_keep:
                    keep = k0
                    break
            else:
                # Full-set fallback. Remember the widest-gate rows anyway:
                # a handful of prediction-consistent matches can seed a
                # rescue solve that the chi2 rounds then re-expand against
                # the full set (k2 is evaluated over ALL rows).
                wide = zok & (r0 < 4.0 * gate_px)
                if wide.sum() >= 4:
                    starved_seed = wide
        pose = self.track_arrays(init, Xw[keep], meas[keep])
        pose, keep = chi2_refine(pose, keep)

        if gate_px > 0 and rescue_frac > 0:
            support_px = 2.0 * chi2_px
            support = self.reproj_support(pose, Xw, meas, support_px)
            if support < max(min_keep, rescue_frac * n_in):
                # Candidate 1: ungated Huber on the full set. Candidate 2:
                # the COMPLEMENT of the gated set — when the gate kept a
                # minority coherent with a bad prediction, the rejected
                # rows hold the true consensus, and solving on the full
                # set can stall in the minority's zero-residual minimum.
                # Candidate 3: the below-min_keep widest-gate seed from a
                # starved gate (see above).
                candidates = [np.ones(n_in, bool)]
                comp = ~keep
                if comp.sum() >= min_keep:
                    candidates.append(comp)
                if starved_seed is not None:
                    candidates.append(starved_seed)
                for seed in candidates:
                    alt = self.track_arrays(init, Xw[seed], meas[seed])
                    alt, alt_keep = chi2_refine(alt, seed)
                    alt_support = self.reproj_support(alt, Xw, meas, support_px)
                    if alt_support > support:
                        pose, keep, support = alt, alt_keep, alt_support
        return pose, keep

    def track_arrays(
        self, initial_guess: Pose3, Xw: np.ndarray, meas: np.ndarray
    ) -> Pose3:
        """Solve for the pose from (N,3) world points and (N,3) stereo meas."""
        if Xw.shape[0] == 0:
            return initial_guess
        disparity = meas[:, 0] - meas[:, 1]
        sigmas = stereo_diag_sigmas(self.sigma_px, disparity, self.calib.bf)

        # Native C++ LM (csrc/): identical factors/damping, ~10x less host
        # overhead per iteration on this single-core host. SUPERSLAM_NATIVE=0
        # forces the numpy path (the oracle).
        import os

        if os.environ.get("SUPERSLAM_NATIVE", "1") != "0":
            from .. import native

            if native.available():
                return native.pose_only_lm(
                    Xw, meas, sigmas, self.calib, HUBER_K, initial_guess
                )
        inv_sig = 1.0 / sigmas

        def robust_error(pose: Pose3) -> float:
            r, _ = batch_stereo_factor(pose, self.calib, Xw, meas)
            return huber_loss(r * inv_sig, HUBER_K)

        pose = initial_guess
        lam = 1e-5
        err = robust_error(pose)
        max_iters, lam_factor = 100, 10.0
        for _ in range(max_iters):
            r, J = batch_stereo_factor(pose, self.calib, Xw, meas)
            rw = r * inv_sig  # whitened (N,3)
            Jw = J * inv_sig[:, :, None]  # whitened (N,3,6)
            w = huber_weights(rw, HUBER_K)  # (N,)
            Jf = (Jw * w[:, None, None]).reshape(-1, 6)
            Ju = Jw.reshape(-1, 6)
            H = Ju.T @ Jf  # sum w * J^T J
            g = Jf.T @ rw.reshape(-1)

            stepped = False
            for _try in range(10):
                try:
                    delta = np.linalg.solve(H + lam * np.eye(6), -g)
                except np.linalg.LinAlgError:
                    lam *= lam_factor
                    continue
                cand = pose.retract(delta)
                cand_err = robust_error(cand)
                if cand_err < err:
                    improvement = err - cand_err
                    pose, err = cand, cand_err
                    lam = max(lam / lam_factor, 1e-10)
                    stepped = True
                    if improvement < 1e-5 * max(err, 1.0) or improvement < 1e-5:
                        return pose
                    break
                lam *= lam_factor
                if lam > 1e10:
                    return pose
            if not stepped:
                return pose
        return pose

#!/usr/bin/env python3
"""Standalone cost model of the PyTorch/CUDA port's WindowSmoother at the
bench's keyframe cadence.

The port's counterpart of ``scripts/profile_smoother.py``, on the host: it
builds a window shape like the bench's (a keyframe every ~2 frames, long
tracks) incrementally (add_keyframe + optimize per step, as the estimator
does) and scans the knobs that cut the per-insertion cost (max_iters,
window size, solve cadence), reporting steady-state ms an optimize and the
pose error each variant leaves against the ground truth.

Usage: python scripts/profile_smoother_torch.py [--steps 40] [--obs-per-kf 500]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from superslam_tpu_torch.core.window_smoother import StereoObs, WindowSmoother  # noqa: E402
from superslam_tpu_torch.geometry import Pose3, StereoCalib, stereo_project  # noqa: E402
from superslam_tpu_torch.geometry.stereo_camera import CheiralityError  # noqa: E402


def make_calib() -> StereoCalib:
    return StereoCalib(fx=500.0, fy=500.0, cx=320.0, cy=240.0, baseline=0.5)


def build_sequence(rng, steps, obs_per_kf, survival=0.9):
    """Per-KF observation lists over a moving landmark pool whose tracks
    die with prob (1-survival) per step -> mean track length ~1/(1-s)."""
    calib = make_calib()
    gt = [Pose3(t=np.array([0.25 * k, 0.02 * np.sin(0.3 * k), 0.9 * k])) for k in range(steps)]
    alive: dict[int, np.ndarray] = {}
    next_id = 0
    per_kf = []
    for k in range(steps):
        for lm in list(alive):
            if rng.random() > survival:
                del alive[lm]
        base = gt[k].t
        while len(alive) < obs_per_kf:
            alive[next_id] = base + rng.uniform([-8, -4, 6], [8, 4, 30])
            next_id += 1
        obs = []
        for lm, X in alive.items():
            try:
                m = stereo_project(gt[k], calib, X)
            except CheiralityError:
                continue
            obs.append(StereoObs(lm, m + rng.normal(0, 0.4, 3)))
        per_kf.append(obs)
    return calib, gt, per_kf


def run(calib, gt, per_kf, window, max_iters, solve_every=1, seed_noise=0.03):
    rng = np.random.default_rng(7)
    os.environ["SUPERSLAM_WS_MAX_ITERS"] = str(max_iters)
    sm = WindowSmoother(calib, window_size=window, device="cpu")
    times = []
    for k, (tp, obs) in enumerate(zip(gt, per_kf)):
        seed = tp * Pose3.expmap(rng.normal(0, seed_noise, 6) * np.array([0.1, 0.1, 0.1, 1, 1, 1]))
        sm.add_keyframe(k, seed if k else tp, obs)
        if k % solve_every == 0 or k == len(gt) - 1:
            t0 = time.perf_counter()
            sm.optimize()
            dt = (time.perf_counter() - t0) * 1e3
            if k >= window:  # steady state only
                times.append(dt)
    errs = [np.linalg.norm(sm.pose_of(k).t - gt[k].t) for k in list(sm._window)]
    return {
        "window": window, "max_iters": max_iters, "solve_every": solve_every,
        "ms_mean": float(np.mean(times)) if times else float("nan"),
        "ms_p90": float(np.percentile(times, 90)) if times else float("nan"),
        "n_timed": len(times),
        "final_err_mean_m": float(np.mean(errs)),
        "final_err_max_m": float(np.max(errs)),
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--obs-per-kf", type=int, default=500)
    args = ap.parse_args()

    rng = np.random.default_rng(0)
    calib, gt, per_kf = build_sequence(rng, args.steps, args.obs_per_kf)
    n_obs = sum(len(o) for o in per_kf) / len(per_kf)
    print(f"[smoother-bench] {args.steps} KFs, {n_obs:.0f} obs/KF, mean track ~10")

    for window, iters, every in [
        (20, 4, 1),   # bench default shape
        (20, 8, 1),   # does the solver early-exit?
        (20, 2, 1),
        (20, 1, 1),
        (10, 4, 1),
        (8, 4, 1),
        (20, 4, 2),   # solve every 2nd insertion
        (20, 4, 4),
    ]:
        r = run(calib, gt, per_kf, window, iters, every)
        print(f"  window={window:2d} iters={iters} every={every}: "
              f"{r['ms_mean']:.1f} ms mean / {r['ms_p90']:.1f} p90 "
              f"(n={r['n_timed']}), err mean {r['final_err_mean_m']*100:.2f} cm "
              f"max {r['final_err_max_m']*100:.2f} cm")


if __name__ == "__main__":
    main()

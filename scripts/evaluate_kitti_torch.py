#!/usr/bin/env python3
"""Evaluate a KITTI-format estimated trajectory against ground truth, with
the PyTorch/CUDA port's metrics.

The port's counterpart of ``scripts/evaluate_kitti.py`` (same JSON):
SE(3)-Umeyama-aligned ATE RMSE, RPE at 1 m, and the KITTI segment metric
(t_rel %, r_rel deg/m over 100-800 m), from ``superslam_tpu_torch/eval/metrics.py``.
Host only.

Usage: python scripts/evaluate_kitti_torch.py <est.txt> <gt.txt> [--plot out.png]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from superslam_tpu_torch.eval.metrics import ate, kitti_segment_errors, rpe  # noqa: E402
from superslam_tpu_torch.io.trajectory import load_trajectory_kitti  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("est")
    ap.add_argument("gt")
    ap.add_argument("--plot", default=None)
    args = ap.parse_args()

    est = load_trajectory_kitti(args.est)
    gt = load_trajectory_kitti(args.gt)
    a = ate(est, gt)
    r = rpe(est, gt, delta_m=1.0)
    t_rel, r_rel = kitti_segment_errors(est, gt)
    out = {
        "ate_rmse_m": round(a.rmse, 4),
        "ate_mean_m": round(a.mean, 4),
        "ate_max_m": round(a.max, 4),
        "rpe_rmse_m": round(r.rmse, 4),
        "t_rel_percent": round(t_rel, 3),
        "r_rel_deg_per_m": round(r_rel, 5),
        "frames": min(len(est), len(gt)),
    }
    print(json.dumps(out))

    if args.plot:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        import numpy as np

        pe = np.stack([p.t for p in est])
        pg = np.stack([p.t for p in gt])
        fig, ax = plt.subplots(figsize=(6, 6))
        ax.plot(pg[:, 0], pg[:, 2], "k-", label="ground truth")
        ax.plot(pe[:, 0], pe[:, 2], "b-", label="estimate")
        ax.set_aspect("equal")
        ax.legend()
        fig.savefig(args.plot, dpi=120)
        print(f"plot -> {args.plot}")


if __name__ == "__main__":
    main()

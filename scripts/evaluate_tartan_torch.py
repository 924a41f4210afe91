#!/usr/bin/env python3
"""Evaluate a TartanAir/TartanGround run with the PyTorch/CUDA port's
metrics: the estimate is TUM-format at synthesized 10 Hz; ground truth is
pose_left.txt (x y z qx qy qz qw per frame, NED), matched frame by frame.
The port's counterpart of ``scripts/evaluate_tartan.py`` (same JSON). Host
only.

Usage: python scripts/evaluate_tartan_torch.py <est_tum.txt> <pose_left.txt>
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from scripts.evaluate_euroc_torch import quat_to_rotation  # noqa: E402
from superslam_tpu_torch.eval.metrics import ate, kitti_segment_errors, rpe  # noqa: E402
from superslam_tpu_torch.geometry import Pose3  # noqa: E402
from superslam_tpu_torch.io.trajectory import load_trajectory_tum  # noqa: E402


def load_tartan_gt(path):
    poses = []
    with open(path) as f:
        for line in f:
            try:
                v = np.array(line.split(), dtype=np.float64)
            except ValueError:
                continue  # a header or comment line
            if v.size < 7:
                continue
            tx, ty, tz, qx, qy, qz, qw = v[:7]
            poses.append(Pose3(quat_to_rotation(qx, qy, qz, qw), np.array([tx, ty, tz])))
    return poses


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("est")
    ap.add_argument("gt")
    args = ap.parse_args()
    _, est = load_trajectory_tum(args.est)
    gt = load_tartan_gt(args.gt)
    a = ate(est, gt)
    r = rpe(est, gt, delta_m=1.0)
    t_rel, r_rel = kitti_segment_errors(est, gt)
    print(json.dumps({
        "ate_rmse_m": round(a.rmse, 4), "ate_mean_m": round(a.mean, 4),
        "rpe_rmse_m": round(r.rmse, 4), "t_rel_percent": round(t_rel, 3),
        "frames": min(len(est), len(gt)),
    }))


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Evaluate a TUM-format estimated trajectory against TUM ground truth, with
the PyTorch/CUDA port's metrics.

The port's counterpart of ``scripts/evaluate_tum.py`` (same JSON):
timestamp association (nearest, <= 20 ms), then SE(3)-aligned ATE and RPE
from ``superslam_tpu_torch/eval/metrics.py``. Host only.

Usage: python scripts/evaluate_tum_torch.py <est_tum.txt> <groundtruth.txt>
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from superslam_tpu_torch.eval.metrics import ate, rpe  # noqa: E402
from superslam_tpu_torch.io.trajectory import load_trajectory_tum  # noqa: E402


def associate(ts_a, ts_b, max_dt=0.02):
    """(i, j) pairs: each stamp of ``ts_a`` with the nearest of ``ts_b``,
    kept when they lie within ``max_dt`` seconds."""
    tb = np.asarray(ts_b)
    pairs = []
    for i, t in enumerate(ts_a):
        j = int(np.argmin(np.abs(tb - t)))
        if abs(tb[j] - t) <= max_dt:
            pairs.append((i, j))
    return pairs


def associated_metrics(ts_e, est, ts_g, gt) -> dict:
    """ATE and RPE over the associated pairs: the JSON of the TUM and EuRoC
    evaluators."""
    pairs = associate(ts_e, ts_g)
    est_m = [est[i] for i, _ in pairs]
    gt_m = [gt[j] for _, j in pairs]
    a = ate(est_m, gt_m)
    r = rpe(est_m, gt_m, delta_m=1.0)
    return {
        "ate_rmse_m": round(a.rmse, 4),
        "ate_mean_m": round(a.mean, 4),
        "ate_max_m": round(a.max, 4),
        "rpe_rmse_m": round(r.rmse, 4),
        "matched_frames": len(pairs),
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("est")
    ap.add_argument("gt")
    args = ap.parse_args()

    ts_e, est = load_trajectory_tum(args.est)
    ts_g, gt = load_trajectory_tum(args.gt)
    print(json.dumps(associated_metrics(ts_e, est, ts_g, gt)))


if __name__ == "__main__":
    main()

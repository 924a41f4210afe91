#!/usr/bin/env python3
"""Evaluate a EuRoC run with the PyTorch/CUDA port's metrics: the estimate
is TUM-format; ground truth is the sequence's
state_groundtruth_estimate0/data.csv. The port's counterpart of
``scripts/evaluate_euroc.py`` (same JSON: timestamp association +
SE(3)-aligned ATE/RPE). Host only.

Usage: python scripts/evaluate_euroc_torch.py <est_tum.txt> <sequence_dir_or_gt_csv>
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from scripts.evaluate_tum_torch import associated_metrics  # noqa: E402
from superslam_tpu_torch.geometry import Pose3  # noqa: E402
from superslam_tpu_torch.io.trajectory import load_trajectory_tum  # noqa: E402


def quat_to_rotation(qx, qy, qz, qw) -> np.ndarray:
    """The rotation of a quaternion, normalized first."""
    n = np.linalg.norm([qx, qy, qz, qw])
    qx, qy, qz, qw = qx / n, qy / n, qz / n, qw / n
    return np.array(
        [
            [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qz * qw), 2 * (qx * qz + qy * qw)],
            [2 * (qx * qy + qz * qw), 1 - 2 * (qx * qx + qz * qz), 2 * (qy * qz - qx * qw)],
            [2 * (qx * qz - qy * qw), 2 * (qy * qz + qx * qw), 1 - 2 * (qx * qx + qy * qy)],
        ]
    )


def load_euroc_gt(path):
    if os.path.isdir(path):
        path = os.path.join(path, "mav0", "state_groundtruth_estimate0", "data.csv")
    ts, poses = [], []
    with open(path) as f:
        for row in csv.reader(f):
            if not row or row[0].startswith("#"):
                continue
            tx, ty, tz = map(float, row[1:4])
            qw, qx, qy, qz = map(float, row[4:8])
            ts.append(float(row[0]) * 1e-9)
            poses.append(Pose3(quat_to_rotation(qx, qy, qz, qw), np.array([tx, ty, tz])))
    return ts, poses


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("est")
    ap.add_argument("gt")
    args = ap.parse_args()
    ts_e, est = load_trajectory_tum(args.est)
    ts_g, gt = load_euroc_gt(args.gt)
    print(json.dumps(associated_metrics(ts_e, est, ts_g, gt)))


if __name__ == "__main__":
    main()

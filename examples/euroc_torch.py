#!/usr/bin/env python3
"""EuRoC MAV stereo runner with on-the-fly rectification, on the
PyTorch/CUDA port.

The port's counterpart of ``examples/euroc.py``: build left/right
rectification maps from the LEFT.*/RIGHT.* matrices in the settings yaml
(cv::initUndistortRectifyMap semantics) with the port's ``config.Config``
and ``io/undistort.py::RectifyMap``, remap each raw cam0/cam1 image, track
through the port's ``SuperSLAM``, and save the TUM-format trajectory (EuRoC
ground truth is TUM-style). Runs on CUDA unless ``--device cpu`` is given.
"""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from examples.euroc import load_euroc_sequence  # noqa: E402
from examples.example_common import (  # noqa: E402
    load_gray,
    parse_example_args,
    report_timing,
)
from examples.kitti_torch import DEVICE_ARG  # noqa: E402


def build_rectify_maps(settings_path: str):
    from superslam_tpu_torch.config import Config
    from superslam_tpu_torch.io.undistort import RectifyMap

    cfg = Config.load(settings_path)
    maps = []
    for side in ("LEFT", "RIGHT"):
        K = cfg.matrix(f"{side}.K")
        D = cfg.matrix(f"{side}.D")
        R = cfg.matrix(f"{side}.R")
        P = cfg.matrix(f"{side}.P")
        if K is None or D is None or R is None or P is None:
            raise ValueError("Rectification matrices (LEFT.*/RIGHT.*) missing")
        w = int(cfg.get(f"{side}.width"))
        h = int(cfg.get(f"{side}.height"))
        maps.append(RectifyMap(K, D.ravel(), R, P, w, h))
    return maps


def main() -> None:
    args = parse_example_args("euroc", extra=DEVICE_ARG)
    from superslam_tpu_torch.slam import SuperSLAM

    rect_l, rect_r = build_rectify_maps(args.settings)
    slam = SuperSLAM(args.settings, use_viewer=args.viewer, device=args.device)
    frames = load_euroc_sequence(args.sequence)
    if args.max_frames:
        frames = frames[: args.max_frames]

    times_ms = []
    for t, lp, rp in frames:
        left = rect_l.remap(load_gray(lp))
        right = rect_r.remap(load_gray(rp))
        t0 = time.perf_counter()
        slam.track_stereo(left, right, t)
        times_ms.append((time.perf_counter() - t0) * 1e3)

    report_timing(times_ms)
    print(f"loop closures: {slam.loop_closure_count()}")
    seq = os.path.basename(os.path.normpath(args.sequence))
    out = args.out or os.path.join("results", "euroc", f"{seq}.txt")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    slam.save_trajectory(out, "tum")
    print(f"trajectory -> {out}")
    slam.shutdown()


if __name__ == "__main__":
    main()

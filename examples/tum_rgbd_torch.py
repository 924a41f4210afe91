#!/usr/bin/env python3
"""TUM RGB-D runner on the PyTorch/CUDA port.

The port's counterpart of ``examples/tum_rgbd.py``: associate rgb.txt and
depth.txt by nearest timestamp (<= 20 ms), track RGB-D frames through the
port's ``SuperSLAM``, save the TUM-format trajectory. Runs on CUDA unless
``--device cpu`` is given.
"""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from examples.example_common import parse_example_args, report_timing  # noqa: E402
from examples.kitti_torch import DEVICE_ARG  # noqa: E402
from examples.tum_rgbd import associate  # noqa: E402


def main() -> None:
    args = parse_example_args("tum_rgbd", extra=DEVICE_ARG)
    import cv2

    from superslam_tpu_torch.slam import SuperSLAM

    slam = SuperSLAM(args.settings, use_viewer=args.viewer, device=args.device)
    pairs = associate(args.sequence)
    if args.max_frames:
        pairs = pairs[: args.max_frames]

    times_ms = []
    for t, rgb_name, depth_name in pairs:
        rgb = cv2.imread(os.path.join(args.sequence, rgb_name), cv2.IMREAD_GRAYSCALE)
        depth = cv2.imread(os.path.join(args.sequence, depth_name), cv2.IMREAD_UNCHANGED)
        if rgb is None or depth is None:
            continue
        t0 = time.perf_counter()
        slam.track_rgbd(rgb, depth, t)
        times_ms.append((time.perf_counter() - t0) * 1e3)

    report_timing(times_ms)
    print(f"loop closures: {slam.loop_closure_count()}")
    seq = os.path.basename(os.path.normpath(args.sequence))
    out = args.out or os.path.join("results", "tum", f"{seq}.txt")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    slam.save_trajectory(out, "tum")
    print(f"trajectory -> {out}")
    slam.shutdown()


if __name__ == "__main__":
    main()

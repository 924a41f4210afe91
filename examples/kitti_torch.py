#!/usr/bin/env python3
"""KITTI odometry stereo runner on the PyTorch/CUDA port.

The port's counterpart of ``examples/kitti.py``: load times.txt +
image_0/image_1, track every stereo pair through the port's ``SuperSLAM``,
report timing, save the KITTI-format trajectory to results/kitti/<seq>.txt.
Enable loop closure with SUPERSLAM_ENABLE_LOOP=1. Runs on CUDA unless
``--device cpu`` is given; without a card and without that flag it exits
non-zero.
"""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from examples.example_common import (  # noqa: E402
    load_gray,
    pace_to_timestamp,
    parse_example_args,
    report_timing,
)
from examples.kitti import load_kitti_sequence  # noqa: E402

DEVICE_ARG = {"--device": {"default": "cuda", "help": "cuda (default) or cpu"}}


def main() -> None:
    args = parse_example_args("kitti", extra=DEVICE_ARG)
    from superslam_tpu_torch.slam import SuperSLAM

    slam = SuperSLAM(args.settings, use_viewer=args.viewer, device=args.device)
    frames = load_kitti_sequence(args.sequence)
    if args.max_frames:
        frames = frames[: args.max_frames]

    times_ms = []
    prev_t = None
    for t, lp, rp in frames:
        left, right = load_gray(lp), load_gray(rp)
        t0 = time.perf_counter()
        slam.track_stereo(left, right, t)
        ms = (time.perf_counter() - t0) * 1e3
        times_ms.append(ms)
        if args.pace and prev_t is not None:
            pace_to_timestamp(ms, t - prev_t)
        prev_t = t

    report_timing(times_ms)
    print(f"loop closures: {slam.loop_closure_count()}")

    seq = os.path.basename(os.path.normpath(args.sequence))
    out = args.out or os.path.join("results", "kitti", f"{seq}.txt")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    slam.save_trajectory(out, "kitti")
    print(f"trajectory -> {out}")
    slam.shutdown()


if __name__ == "__main__":
    main()

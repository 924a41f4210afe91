#!/usr/bin/env python3
"""TartanAir / TartanGround stereo runner on the PyTorch/CUDA port.

The port's counterpart of ``examples/tartan.py``: image_left / image_right
directories, timestamps synthesized at 10 Hz, trajectory saved in TUM
format (TartanAir ground truth is pose-list style). Runs on CUDA unless
``--device cpu`` is given.
"""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from examples.example_common import (  # noqa: E402
    load_gray,
    parse_example_args,
    report_timing,
)
from examples.kitti_torch import DEVICE_ARG  # noqa: E402
from examples.tartan import load_tartan_sequence  # noqa: E402


def main() -> None:
    args = parse_example_args("tartan", extra=DEVICE_ARG)
    from superslam_tpu_torch.slam import SuperSLAM

    slam = SuperSLAM(args.settings, use_viewer=args.viewer, device=args.device)
    frames = load_tartan_sequence(args.sequence)
    if args.max_frames:
        frames = frames[: args.max_frames]

    times_ms = []
    for t, lp, rp in frames:
        left, right = load_gray(lp), load_gray(rp)
        t0 = time.perf_counter()
        slam.track_stereo(left, right, t)
        times_ms.append((time.perf_counter() - t0) * 1e3)

    report_timing(times_ms)
    print(f"loop closures: {slam.loop_closure_count()}")
    seq = os.path.basename(os.path.normpath(args.sequence))
    out = args.out or os.path.join("results", "tartan", f"{seq}.txt")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    slam.save_trajectory(out, "tum")
    print(f"trajectory -> {out}")
    slam.shutdown()


if __name__ == "__main__":
    main()

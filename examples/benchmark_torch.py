#!/usr/bin/env python3
"""Latency/throughput benchmark over a dataset sequence, on the
PyTorch/CUDA port.

The port's counterpart of ``examples/benchmark.py`` (the upstream
``examples/stereo/benchmark.cc:96-107``): per-frame mean/p50/p95/max
latency over track_stereo, sustained fps over wall clock, and the
loop-closure count. ``bench_torch.py`` at the repo root is the dataset-free
variant. Runs on CUDA unless ``--device cpu`` is given.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from examples.example_common import load_gray, parse_example_args  # noqa: E402
from examples.kitti import load_kitti_sequence  # noqa: E402
from examples.kitti_torch import DEVICE_ARG  # noqa: E402


def main() -> None:
    args = parse_example_args(
        "benchmark", extra={"--warmup": {"type": int, "default": 10}, **DEVICE_ARG}
    )
    from superslam_tpu_torch.slam import SuperSLAM

    slam = SuperSLAM(args.settings, use_viewer=False, device=args.device)
    frames = load_kitti_sequence(args.sequence)
    if args.max_frames:
        frames = frames[: args.max_frames + args.warmup]

    lat = []
    t_start = None
    n_timed = 0
    for i, (t, lp, rp) in enumerate(frames):
        left, right = load_gray(lp), load_gray(rp)
        t0 = time.perf_counter()
        slam.track_stereo(left, right, t)
        dt = time.perf_counter() - t0
        if i >= args.warmup:
            if t_start is None:
                t_start = t0
            lat.append(dt)
            n_timed += 1
    total = time.perf_counter() - t_start if t_start else 1.0

    lat_ms = np.array(lat) * 1e3
    print(
        f"frames={n_timed} mean={lat_ms.mean():.2f}ms "
        f"p50={np.percentile(lat_ms, 50):.2f}ms "
        f"p95={np.percentile(lat_ms, 95):.2f}ms max={lat_ms.max():.2f}ms "
        f"sustained={n_timed / total:.1f}fps loops={slam.loop_closure_count()}"
    )
    slam.shutdown()


if __name__ == "__main__":
    main()

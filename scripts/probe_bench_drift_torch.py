#!/usr/bin/env python3
"""How the trajectory error of ``bench_torch.py``'s run grows with the
number of frames, in four tracker modes on the same frames.

The bench laps its 144-frame closed circuit with no loop closure, so its
error grows with the frames it tracks. This probe tells plain visual-odometry
drift from a fault of one path: each leg tracks the same ``--frames`` frames
of the lap (after bench_torch's warm-up and flush) by frame count, not by
time, and prints the Umeyama-aligned ATE against the circuit's poses over
windows of several lengths and starts:

- batch 4, device keyframes (the bench's mode: frames 1-3 of a dispatch
  re-match against the keyframe carried in the scan);
- batch 1, device keyframes (the facade's default);
- batch 4, dispatch-frozen device tracking (``SUPERSLAM_DEVICE_KF=0``);
- batch 1, host-solved (``SUPERSLAM_DEVICE_TRACKER=0``).

Each leg's last line is one JSON object. Runs on CUDA unless ``--device
cpu`` is given.

Usage:  python scripts/probe_bench_drift_torch.py [--frames 2000] [--legs 0,1,2,3]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench_torch  # noqa: E402
from scripts.accuracy_suite_torch import leg_environment  # noqa: E402

LEGS = [
    ("batch 4, device keyframes", {}),
    ("batch 1, device keyframes", {"BENCH_BATCH": "1"}),
    ("batch 4, dispatch-frozen device tracking", {"SUPERSLAM_DEVICE_KF": "0"}),
    ("batch 1, host-solved", {"BENCH_BATCH": "1", "SUPERSLAM_DEVICE_TRACKER": "0"}),
]


def track_leg(frames, n: int, device) -> tuple:
    """bench_torch's tracker over its warm-up, a flush, then n frames of the
    lap and a flush. Returns (tracker, trajectory, first tracked frame after
    the warm-up, seconds for the n frames)."""
    pipeline, estimator = bench_torch.make_slam(device)
    tracker = bench_torch.make_tracker(pipeline, estimator, device)
    for i in range(bench_torch.N_WARMUP):
        tracker.track(*frames[i], 0.1 * i)
    tracker.flush()
    first = bench_torch.N_WARMUP
    t0 = time.perf_counter()
    for i in range(first, first + n):
        tracker.track(*frames[i % len(frames)], 0.1 * i)
    tracker.flush()
    return tracker, estimator.corrected_trajectory(), first, time.perf_counter() - t0


def drift_table(traj, first: int, n: int, gt) -> dict:
    """ATE (rmse, m) over [first, first + m) for growing m, and over windows
    of a fixed length at later starts."""
    from superslam_tpu_torch.eval.metrics import ate

    def over(lo, hi):
        return round(ate(traj[lo:hi], [gt[i % len(gt)] for i in range(lo, hi)]).rmse, 4)

    lengths = [m for m in (144, 500, 1000, 1500, 2000, 2500, 3000) if m <= n]
    fixed = min(1000, n)
    starts = range(first, first + n - fixed + 1, 500)
    return {
        "from_first": {m: over(first, first + m) for m in lengths},
        f"windows_of_{fixed}": {lo - first: over(lo, lo + fixed) for lo in starts},
        "laps": [over(lo, lo + len(gt)) for lo in range(first, first + n - len(gt) + 1,
                                                         len(gt))],
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=2000, help="frames a leg after the warm-up")
    ap.add_argument("--legs", default="0,1,2,3", help="indices into the legs")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()

    from superslam_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    frames = bench_torch.synth_sequence(bench_torch.N_FRAMES)
    gt = bench_torch.circuit_poses(bench_torch.N_FRAMES)
    for leg in (int(i) for i in args.legs.split(",")):
        name, env = LEGS[leg]
        with leg_environment(env):
            tracker, traj, first, secs = track_leg(frames, args.frames, device)
        if len(traj) != first + args.frames:
            raise SystemExit(f"{name}: {len(traj)} poses for {first + args.frames} frames")
        table = drift_table(traj, first, args.frames, gt)
        print(f"[{name}] depth {tracker.depth}, batch {tracker.batch}, device_kf "
              f"{tracker.device_kf}, device_tracking {tracker.device_tracking}: "
              f"{args.frames} frames in {secs:.1f} s, keyframes "
              f"{len(tracker.estimator.anchors())}, reseeds {tracker.reseeds}", flush=True)
        print(json.dumps({"leg": name, "frames": args.frames, **table}), flush=True)


if __name__ == "__main__":
    main()

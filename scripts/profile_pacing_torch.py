#!/usr/bin/env python3
"""Does pacing the submit rate change the PyTorch/CUDA port's sustained
rate? The port's counterpart of ``scripts/profile_pacing.py``.

For each minimum interval between ``track`` calls (ms; 0 = unpaced) it
builds bench_torch.py's tracker (depth 3, batch 4, device tracking on the
card), tracks the bench circuit's frames and prints the sustained fps and
the rate in windows of 25 frames: a throttle that holds the early windows'
rate would show a self-induced slowdown; one that only caps the rate shows
none.

Usage: python scripts/profile_pacing_torch.py [min_interval_ms ...] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def run(min_interval_s: float, frames, tracker, n=100) -> tuple[float, list]:
    t_next = time.perf_counter()
    t0 = time.perf_counter()
    win, wins = 25, []
    t_win = t0
    for i in range(n):
        now = time.perf_counter()
        if min_interval_s > 0 and now < t_next:
            time.sleep(t_next - now)
        t_next = time.perf_counter() + min_interval_s
        left, right = frames[i % len(frames)]
        tracker.track(left, right, 0.1 * i)
        if (i + 1) % win == 0:
            now = time.perf_counter()
            wins.append(win / (now - t_win))
            t_win = now
    tracker.flush()
    return n / (time.perf_counter() - t0), wins


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("intervals_ms", nargs="*", type=float, default=[0.0, 14.0, 18.0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()

    import bench_torch as b
    from superslam_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    frames = b.synth_sequence(40)
    for iv in (ms / 1e3 for ms in args.intervals_ms):
        tracker = b.make_tracker(*b.make_slam(device), device)
        for i in range(5):
            left, right = frames[i]
            tracker.track(left, right, 0.1 * i)
        tracker.flush()
        fps, wins = run(iv, frames, tracker)
        print(
            f"interval {iv * 1e3:5.1f} ms: sustained {fps:5.1f} fps, "
            f"windows {[round(w, 1) for w in wins]}",
            flush=True,
        )


if __name__ == "__main__":
    main()

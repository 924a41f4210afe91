#!/usr/bin/env python3
"""Same-process decomposition of the PyTorch/CUDA port's bench: its legs
round-robin in short windows in ONE process, so every cross-leg difference
is measured under the same conditions.

The port's counterpart of ``scripts/profile_bench_ab.py``, over
``bench_torch.py``'s rig, frames and tracker (depth 3, batch 4, device
tracking). The legs separate the trained stack from the passthrough
matcher, the natural keyframe cadence (covisibility 0.75) from the sparser
0.3, the device-keyframe step from the dispatch-frozen one, and bound what
the window smoother costs (``SUPERSLAM_VO_NO_SMOOTHER``) and what a sparser
solve cadence buys (``SUPERSLAM_WS_SOLVE_EVERY``). Reports each leg's
sustained fps over all rounds and the host profiler's per-leg breakdown
(``utils/profiler.py``: vo_gtsam_optimize, ws_rebuild, ws_solve,
pl_fetch_wait, pl_upload, vo_lg_track_match), and writes them as JSON.

Usage:
  python scripts/profile_bench_ab_torch.py [--rounds 3] [--settle 6] [--measure 20]
      [--legs NAME ...] [--out results/bench_ab_torch.json] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ.setdefault("SUPERSLAM_PROFILE", "1")

LEGS = [
    # (name, passthrough_lg, covis, device_kf, leg_env)
    ("passthrough_covis03_nokf", True, 0.3, False, {}),
    ("trained_covis03_nokf", False, 0.3, False, {}),
    ("trained_covis075_nokf", False, 0.75, False, {}),
    ("trained_covis075_kf", False, 0.75, True, {}),
    ("trained_covis075_kf_nosmoother", False, 0.75, True,
     {"SUPERSLAM_VO_NO_SMOOTHER": "1"}),
    # Window-solve cadence: full LM every k-th insertion, one warm
    # iteration between.
    ("trained_covis075_kf_ws2", False, 0.75, True, {"SUPERSLAM_WS_SOLVE_EVERY": "2"}),
    ("trained_covis075_kf_ws4", False, 0.75, True, {"SUPERSLAM_WS_SOLVE_EVERY": "4"}),
]

# Every env key any leg may set: cleared before each leg so settings never
# leak across the round-robin.
LEG_ENV_KEYS = ("SUPERSLAM_VO_NO_SMOOTHER", "SUPERSLAM_WS_SOLVE_EVERY")
PROFILE_LABELS = ("vo_gtsam_optimize", "ws_rebuild", "ws_solve", "pl_fetch_wait",
                  "pl_prepare", "pl_upload", "vo_lg_track_match")


def _apply_leg_env(leg_env: dict) -> None:
    for k in LEG_ENV_KEYS:
        os.environ.pop(k, None)
    os.environ.update(leg_env)


def build_tracker(passthrough: bool, covis: float, device_kf: bool, device):
    import bench_torch as b
    from superslam_tpu_torch.frontend.pipelined import PipelinedStereoTracker
    from superslam_tpu_torch.models.lightglue import init_lightglue_params

    lg = init_lightglue_params(0, passthrough=True, device=device) if passthrough else None
    pipeline, estimator = b.make_slam(device, lg_params=lg)
    estimator.set_keyframe_params(covisibility_ratio=covis, max_frames=20)
    os.environ["SUPERSLAM_DEVICE_KF"] = "1" if device_kf else "0"
    # SUPERSLAM_KF_COVIS would override the estimator's value at tracker
    # init; clear it so each leg's covis comes from set_keyframe_params.
    os.environ.pop("SUPERSLAM_KF_COVIS", None)
    return PipelinedStereoTracker(pipeline, estimator, depth=3, batch=4, device_tracking=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--settle", type=float, default=6.0)
    ap.add_argument("--measure", type=float, default=20.0)
    ap.add_argument("--legs", nargs="*", default=None)
    ap.add_argument("--out", default=os.path.join("results", "bench_ab_torch.json"))
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()

    import bench_torch as b
    from superslam_tpu_torch.utils.device import resolve_device
    from superslam_tpu_torch.utils.profiler import Profiler

    device = resolve_device(args.device)
    legs = [leg for leg in LEGS if args.legs is None or leg[0] in args.legs]
    frames = b.synth_sequence(b.N_FRAMES)

    print("[ab] building trackers...", flush=True)
    trackers, idx = {}, {}
    for name, pt, covis, dkf, leg_env in legs:
        _apply_leg_env(leg_env)
        t0 = time.time()
        tr = build_tracker(pt, covis, dkf, device)
        # Warm: the first calls and the first keyframes.
        for i in range(8):
            left, right = frames[i % len(frames)]
            tr.track(left, right, 0.1 * i)
        tr.flush()
        trackers[name], idx[name] = tr, 8
        print(f"[ab]   {name}: ready in {time.time() - t0:.0f}s", flush=True)
    _apply_leg_env({})

    fps_acc = {name: [] for name, *_ in legs}
    prof_acc = {name: {} for name, *_ in legs}
    frames_acc = {name: 0 for name, *_ in legs}
    for rnd in range(args.rounds):
        for name, _pt, _covis, _dkf, leg_env in legs:
            _apply_leg_env(leg_env)
            tr, i = trackers[name], idx[name]
            t_end = time.perf_counter() + args.settle
            while time.perf_counter() < t_end:
                left, right = frames[i % len(frames)]
                tr.track(left, right, 0.1 * i)
                i += 1
            p0 = Profiler.instance().stats()
            n0 = i
            t0 = time.perf_counter()
            t_end = t0 + args.measure
            while time.perf_counter() < t_end:
                left, right = frames[i % len(frames)]
                tr.track(left, right, 0.1 * i)
                i += 1
            dt = time.perf_counter() - t0
            p1 = Profiler.instance().stats()
            idx[name] = i
            fps = (i - n0) / dt
            fps_acc[name].append(round(fps, 2))
            frames_acc[name] += i - n0
            for label in PROFILE_LABELS:
                acc = prof_acc[name].setdefault(label, [0.0, 0])
                acc[0] += p1.get(label, (0, 0))[0] - p0.get(label, (0, 0))[0]
                acc[1] += p1.get(label, (0, 0))[1] - p0.get(label, (0, 0))[1]
            print(f"[ab] round {rnd} {name}: {fps:.1f} fps", flush=True)
    _apply_leg_env({})

    out = {"config": vars(args), "legs": []}
    for name, *_ in legs:
        prof = {
            k: {"ms_per_frame": round(v[0] / max(1, frames_acc[name]), 3),
                "total_ms": round(v[0], 1), "n": v[1]}
            for k, v in prof_acc[name].items()
        }
        out["legs"].append({
            "leg": name,
            "fps_rounds": fps_acc[name],
            "fps_mean": round(float(np.mean(fps_acc[name])), 2),
            "profile": prof,
        })
        print(f"[ab] {name}: rounds {fps_acc[name]} mean {np.mean(fps_acc[name]):.1f} fps",
              flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(f"[ab] wrote {args.out}")


if __name__ == "__main__":
    main()

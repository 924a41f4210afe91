#!/usr/bin/env python3
"""Whether the bench's lap drift is the port's or the reference's too.

Tracks ``bench_torch.py``'s 144-frame KITTI-00 circuit (the same uint8
renders, ``bench_torch.synth_sequence``, byte-equal to bench.py's) through
``superslam_tpu`` (bench.py's ``make_slam``) and ``superslam_tpu_torch``
(bench_torch.py's) on the CPU, host-solved: each package's
``PipelinedStereoTracker`` at depth 3, batch 1, no device tracking, after
the bench's warm-up frames and flush, then ``--laps`` laps and one frame
more. The circuit is closed, so frame ``i`` and frame ``i + 144`` share
one ground-truth pose: a lap's end displacement is the estimated position
at the lap's end (frame ``i + 144``) less the one at its start (frame
``i``), zero for a tracker without drift.

Prints, per lap and package, the end displacement (vector and norm) and
the lap's Umeyama-aligned ATE, then the two packages' displacements'
difference and the largest per-frame position gap between them; the last
line is one JSON object with all of it.

Both packages run LightGlue's unfused route (``SUPERSLAM_PALLAS_LG=0``:
the JAX package's fused route on the CPU is Pallas in interpret mode) and
the JAX package its XLA convs (its CPU default). With ``--f32`` both run
SuperPoint and LightGlue in f32 (each package's step and matcher modules'
``superpoint_dense`` and ``lightglue_forward`` bound to f32, as
``tests/test_torch_facade.py`` binds the steps): what is left between the
packages then is not bf16 rounding.

Usage (CPU, ~9 min a package for two laps):
  JAX_PLATFORMS=cpu python3 scripts/compare_bench_laps.py [--laps 2] [--f32]
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import bench  # noqa: E402
import bench_torch  # noqa: E402

LAP = bench_torch.N_FRAMES


def track(tracker, frames, n: int):
    """The bench's warm-up and flush, then n frames of the lap and a flush;
    returns (the first frame after the warm-up, its seconds for the n)."""
    for i in range(bench_torch.N_WARMUP):
        tracker.track(*frames[i], 0.1 * i)
    tracker.flush()
    first = bench_torch.N_WARMUP
    t0 = time.perf_counter()
    for i in range(first, first + n):
        tracker.track(*frames[i % len(frames)], 0.1 * i)
    tracker.flush()
    return first, time.perf_counter() - t0


def run_jax(frames, n: int):
    from superslam_tpu.frontend.pipelined import PipelinedStereoTracker

    pipeline, estimator = bench.make_slam()
    tracker = PipelinedStereoTracker(pipeline, estimator, depth=3, batch=1,
                                     device_tracking=False)
    first, secs = track(tracker, frames, n)
    return first, secs, estimator


def run_port(frames, n: int):
    from superslam_tpu_torch.frontend.pipelined import PipelinedStereoTracker

    pipeline, estimator = bench_torch.make_slam("cpu")
    tracker = PipelinedStereoTracker(pipeline, estimator, depth=3, batch=1,
                                     device_tracking=False)
    first, secs = track(tracker, frames, n)
    return first, secs, estimator


def bind_f32() -> None:
    """SuperPoint and LightGlue in f32 in both packages' steps and matchers."""
    import jax.numpy as jnp
    import torch

    import superslam_tpu.models.lightglue as jlg
    import superslam_tpu.ops.frontend_step as jstep
    import superslam_tpu_torch.models.lightglue as tlg
    import superslam_tpu_torch.ops.frontend_step as tstep

    for step, models, dtype in ((jstep, jlg, jnp.float32), (tstep, tlg, torch.float32)):
        step.superpoint_dense = functools.partial(step.superpoint_dense, compute_dtype=dtype)
        forward = functools.partial(models.lightglue_forward, compute_dtype=dtype, fused=False)
        step.lightglue_forward = models.lightglue_forward = forward


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--laps", type=int, default=2)
    ap.add_argument("--f32", action="store_true", help="both packages' networks in f32")
    args = ap.parse_args()
    os.environ.update({"SUPERSLAM_PALLAS_LG": "0", "SUPERSLAM_DEVICE_TRACKER": "0"})
    os.environ.pop("SUPERSLAM_ENABLE_LOOP", None)
    if args.f32:
        bind_f32()

    from superslam_tpu_torch.eval.metrics import ate

    frames = bench_torch.synth_sequence(LAP)
    gt = bench_torch.circuit_poses(LAP)
    n = args.laps * LAP + 1
    out = {"laps": args.laps, "frames": n, "f32": args.f32}
    pos = {}
    for name, fn in (("jax", run_jax), ("port", run_port)):
        first, secs, estimator = fn(frames, n)
        traj = estimator.corrected_trajectory()
        if len(traj) != first + n:
            raise SystemExit(f"{name}: {len(traj)} poses for {first + n} frames")
        p = np.array([q.t for q in traj], np.float64)
        pos[name] = p
        laps = []
        for lap in range(args.laps):
            lo = first + lap * LAP
            disp = p[lo + LAP] - p[lo]
            lap_ate = ate(traj[lo:lo + LAP], [gt[i % LAP] for i in range(lo, lo + LAP)]).rmse
            laps.append({"end_displacement_m": disp.round(6).tolist(),
                         "end_displacement_norm_m": round(float(np.linalg.norm(disp)), 6),
                         "ate_m": round(float(lap_ate), 6)})
            print(f"{name}: lap {lap}: end displacement {np.round(disp, 4).tolist()} m, norm "
                  f"{np.linalg.norm(disp):.4f} m, lap ATE {lap_ate:.4f} m", flush=True)
        n_kf = len(estimator.anchors())
        print(f"{name}: {n} frames in {secs:.1f} s, keyframes {n_kf}", flush=True)
        out[name] = {"first": first, "seconds": round(secs, 1), "keyframes": n_kf, "laps": laps}
    gaps = []
    for lap in range(args.laps):
        dj = np.array(out["jax"]["laps"][lap]["end_displacement_m"])
        dp = np.array(out["port"]["laps"][lap]["end_displacement_m"])
        gaps.append(round(float(np.linalg.norm(dj - dp)), 6))
        print(f"lap {lap}: end displacement norms jax {np.linalg.norm(dj):.4f} m, port "
              f"{np.linalg.norm(dp):.4f} m; |jax - port| {gaps[-1]:.4f} m", flush=True)
    frame_gap = np.linalg.norm(pos["jax"] - pos["port"], axis=1)
    out["displacement_difference_m"] = gaps
    out["largest_frame_gap_m"] = round(float(frame_gap.max()), 6)
    out["largest_frame_gap_at"] = int(frame_gap.argmax())
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())

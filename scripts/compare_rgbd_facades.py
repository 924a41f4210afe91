#!/usr/bin/env python3
"""Where the port's RGB-D facade parts from the JAX package's over the lap.

Runs the accuracy suite's 150-frame RGB-D circuit (rendered in memory,
``scripts/accuracy_suite_torch.py::render_rgbd_circuit``, config as its
``rgbd`` leg) through ``superslam_tpu.slam.SuperSLAM`` and
``superslam_tpu_torch.slam.SuperSLAM`` on the CPU, host-solved
(``SUPERSLAM_DEVICE_TRACKER=0``), synchronous or at ``--depth`` (the
``SUPERSLAM_PIPELINE`` depth; the leg's default is 3), and records every
frame's stages in each package as the host decodes it: the keypoints, the depth
sampled at them, the frame-to-keyframe matches, the tracked pose and the
keyframe decision. Prints both ATEs, the first frame whose live position
parts by more than GAP_M, and the first frame where each stage differs,
then writes the per-frame table to ``--out`` (JSON).

Both packages run the unfused LightGlue route, the JAX package's default
on the CPU (its fused route there is Pallas in interpret mode, far too
slow at K 512).

Usage (CPU, ~15 min for the whole lap):
  JAX_PLATFORMS=cpu python3 scripts/compare_rgbd_facades.py --out cmp.json
  JAX_PLATFORMS=cpu python3 scripts/compare_rgbd_facades.py --frames 40
  JAX_PLATFORMS=cpu python3 scripts/compare_rgbd_facades.py --depth 3
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "scripts"))

import accuracy_suite_torch as suite  # noqa: E402

GAP_M = 0.03  # tests/test_torch_rgbd.py's facade parity tolerance


def run(slam, frames, times):
    """Drive one facade, recording each frame's stages."""
    rec = []
    decode, track = slam.rgbd_pipeline.decode_packed, slam.estimator.track

    def decode_packed(*a, **k):
        frame, m = decode(*a, **k)
        rec.append({
            "kpts": np.asarray(frame.keypoints_left, np.float64),
            "depth_ok": np.asarray(frame.has_depth, bool),
            "uR": np.asarray(frame.stereo[:, 1], np.float64),
            "matches": np.asarray(m.matches, np.int64).reshape(-1, 2),
        })
        return frame, m

    def est_track(frame, *a, **k):
        pose = track(frame, *a, **k)
        rec[-1]["twc_t"] = np.asarray(pose.t, np.float64)
        rec[-1]["keyframe"] = slam.estimator._last_keyframe is frame
        return pose

    slam.rgbd_pipeline.decode_packed = decode_packed
    slam.estimator.track = est_track
    for (gray, depth), ts in zip(frames, times):
        slam.track_rgbd(gray, depth, ts)
    if slam._tracker is not None:
        slam._tracker.flush()
    slam.estimator.stop_loop_worker()
    traj = slam.estimator.corrected_trajectory()
    return rec, traj


def key(p):
    """A keypoint to 1/100 px (both packages decode PACK_SCALE fixed point)."""
    return (round(float(p[0]) * 100), round(float(p[1]) * 100))


def key_set(kpts):
    return {key(p) for p in kpts}


def match_set(rec, i):
    """Frame i's matches as (keyframe point, frame point) coordinate pairs,
    the keyframe being the newest one before it (a match row is (keyframe
    index, frame index))."""
    r = rec[i]
    kf = next((q for q in reversed(rec[:i]) if q["keyframe"]), None)
    if kf is None:
        return set()
    return {(key(kf["kpts"][a]), key(r["kpts"][b])) for a, b in r["matches"]}


def first(cond):
    idx = [i for i, c in enumerate(cond) if c]
    return idx[0] if idx else None


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=suite.FRAMES)
    ap.add_argument("--depth", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import torch

    torch.set_num_threads(4)
    os.environ.update({
        "SUPERSLAM_PIPELINE": str(args.depth),
        "SUPERSLAM_DEVICE_TRACKER": "0",
        "SUPERSLAM_PALLAS_LG": "0",
    })
    os.environ.pop("SUPERSLAM_ENABLE_LOOP", None)
    from superslam_tpu.slam import SuperSLAM as JaxSuperSLAM
    from superslam_tpu_torch.eval.metrics import ate
    from superslam_tpu_torch.slam import SuperSLAM

    pairs, times, gt = suite.render_rgbd_circuit(args.frames)
    with tempfile.TemporaryDirectory() as tmp:
        cfg = suite.write_config(os.path.join(tmp, "config.yaml"),
                                 "lightglue_synth.safetensors", suite.CONFIG_EXTRA["rgbd"])
        jrec, jtraj = run(JaxSuperSLAM(cfg), pairs, times)
        trec, ttraj = run(SuperSLAM(cfg, device="cpu"), pairs, times)

    n = len(pairs)
    rows = []
    for i in range(n):
        j, t = jrec[i], trec[i]
        # The packages may order equal-score keypoints differently: compare
        # keypoints as sets and matches as pairs of coordinates.
        jk, tk = key_set(j["kpts"]), key_set(t["kpts"])
        jd = {key(p) for p, ok in zip(j["kpts"], j["depth_ok"]) if ok}
        td = {key(p) for p, ok in zip(t["kpts"], t["depth_ok"]) if ok}
        jm, tm = match_set(jrec, i), match_set(trec, i)
        rows.append({
            "frame": i,
            "n_kpts": [len(j["kpts"]), len(t["kpts"])],
            "kpts_differ": len(jk ^ tk),
            "depth_ok_differ": len(jd ^ td),
            "matches": [len(jm), len(tm)],
            "matches_differ": len(jm ^ tm),
            "keyframe": [bool(j["keyframe"]), bool(t["keyframe"])],
            "live_gap_m": float(np.linalg.norm(j["twc_t"] - t["twc_t"])),
            "corrected_gap_m": float(np.linalg.norm(jtraj[i].t - ttraj[i].t)),
        })
    summary = {
        "frames": n,
        "depth": args.depth,
        "ate_jax_m": float(ate(jtraj, gt).rmse),
        "ate_port_m": float(ate(ttraj, gt).rmse),
        "keyframes": [sum(r["keyframe"][0] for r in rows), sum(r["keyframe"][1] for r in rows)],
        "first_live_gap_over": first(r["live_gap_m"] > GAP_M for r in rows),
        "first_corrected_gap_over": first(r["corrected_gap_m"] > GAP_M for r in rows),
        "first_kpts_differ": first(r["kpts_differ"] > 0 for r in rows),
        "first_depth_ok_differs": first(r["depth_ok_differ"] > 0 for r in rows),
        "first_matches_differ": first(r["matches_differ"] > 0 for r in rows),
        "first_keyframe_differs": first(r["keyframe"][0] != r["keyframe"][1] for r in rows),
    }
    print(json.dumps(summary))
    for r in rows:
        print(json.dumps(r))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"summary": summary, "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

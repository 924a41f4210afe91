#!/usr/bin/env python
"""Rendered-circuit accuracy legs through the PyTorch/CUDA port's facade.

The port's counterpart of ``scripts/accuracy_suite.py`` for its stereo
legs. It renders the 150-frame sprite-room circuit in memory through the
port's ``eval/synthetic_sequence.py`` with ``scripts/make_synthetic_sequence.py``'s
defaults (640x352, fx 320, baseline 0.3, 300 sprites, seed 0; frames
quantized to uint8 exactly as ``write_kitti_sequence`` writes its PNGs, so
every leg sees the reference legs' pixels) and that script's config
template (512 keypoints, threshold 0.010, ``superpoint_render`` +
``lightglue_synth``). Each leg drives ``SuperSLAM(config, device=...)``
in-process with its environment, and is scored with the port's
``eval/metrics.py`` (Umeyama-aligned ATE, RPE at 1 m, the KITTI segment
metric) against the rendered ground truth.

Legs (env; reference ATE from ACCURACY.json's CPU legs):
  stereo              SUPERSLAM_DEVICE_TRACKER=0: depth 3, host-solved
                      (the reference's CPU default)           0.0675  gated
  stereo_sync         SUPERSLAM_PIPELINE=0                    0.0667  gated
  stereo_devkf        SUPERSLAM_DEVICE_TRACKER=1: depth 3, device keyframes
                      (the port's default on the card)        0.0662  gated
  stereo_nogate       SUPERSLAM_TRACK_GATE=0                  0.0656  printed
  stereo_passthrough  lightglue.weights_file: __passthrough__ 0.1034  printed
  stereo_devtrack     SUPERSLAM_DEVICE_TRACKER=1 SUPERSLAM_DEVICE_KF=0
                      (dispatch-frozen; R2 in the reference)  1.4381  printed
The printed-only legs the reference ran host-solved on its CPU
(nogate, passthrough) also pin SUPERSLAM_DEVICE_TRACKER=0. A gated leg
passes at ATE <= 1.5 x its reference leg.

Usage (on the card; ``--device cpu`` for a CPU run, where 150 frames take
many minutes):
  python3 scripts/accuracy_suite_torch.py                       # the six legs
  python3 scripts/accuracy_suite_torch.py --legs stereo_devkf --frames 40  # 40 of the lap
  python3 scripts/accuracy_suite_torch.py --lg-checkpoints lightglue_synth.safetensors

Writes ACCURACY_TORCH.json (``--out``) with the card's name and power limit;
each leg's ``wall_s`` runs from its first frame to its flush, its ``fps``
over frames 1.. (frame 0 carries the first calls' set-up). Exits 1 when a
gated leg misses its limit.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

# scripts/make_synthetic_sequence.py's defaults and config template (:39-60).
FRAMES, WIDTH, HEIGHT, FX, BASELINE, SPRITES, SEED = 150, 640, 352, 320.0, 0.3, 300, 0
MAX_KEYPOINTS, FPS = 512, 10.0
CONFIG_TMPL = """# Auto-generated synthetic-sequence config.
Camera.fx: {fx}
Camera.fy: {fy}
Camera.cx: {cx}
Camera.cy: {cy}
Camera.bf: {bf}
Camera.width: {w}
Camera.height: {h}
ThDepth: 40
SuperPoint.model_dir: "{model_dir}"
superpoint:
  weights_file: {sp_weights}
  max_keypoints: {max_kp}
  keypoint_threshold: 0.010
  remove_borders: 4
lightglue:
  weights_file: {lg_weights}
  image_width: {w}
  image_height: {h}
Backend.window_size: 8
KeyFrame.covis_ratio: 0.75
loop:
  min_inliers: 25
  min_score: 0.60
"""

HOST_SOLVED = {"SUPERSLAM_DEVICE_TRACKER": "0"}
# leg -> (env, lightglue checkpoint, reference ATE in m, gated)
LEGS = {
    "stereo": (HOST_SOLVED, "lightglue_synth.safetensors", 0.0675, True),
    "stereo_sync": ({"SUPERSLAM_PIPELINE": "0"}, "lightglue_synth.safetensors", 0.0667, True),
    "stereo_devkf": (
        {"SUPERSLAM_DEVICE_TRACKER": "1"}, "lightglue_synth.safetensors", 0.0662, True,
    ),
    "stereo_nogate": (
        {**HOST_SOLVED, "SUPERSLAM_TRACK_GATE": "0"}, "lightglue_synth.safetensors", 0.0656,
        False,
    ),
    "stereo_passthrough": (HOST_SOLVED, "__passthrough__", 0.1034, False),
    "stereo_devtrack": (
        {"SUPERSLAM_DEVICE_TRACKER": "1", "SUPERSLAM_DEVICE_KF": "0"},
        "lightglue_synth.safetensors", 1.4381, False,
    ),
}
GATE_FACTOR = 1.5


def render_circuit(frames: int = FRAMES):
    """The first ``frames`` frames of the 150-frame lap: the stereo pairs as
    uint8 (round(x * 255), as the PNGs are written), their timestamps
    (times.txt's %.6e of i / 10) and the ground-truth poses."""
    from superslam_tpu_torch.eval.synthetic_sequence import (
        circuit_trajectory,
        make_room_world,
        render_stereo,
    )
    from superslam_tpu_torch.geometry.stereo_camera import StereoCalib

    world = make_room_world(np.random.default_rng(SEED), n_sprites=SPRITES)
    calib = StereoCalib(fx=FX, fy=FX, cx=WIDTH / 2.0, cy=HEIGHT / 2.0, baseline=BASELINE)
    poses = circuit_trajectory(FRAMES)[:frames]
    rng = np.random.default_rng(SEED + 1)
    pairs = []
    for p in poses:
        left, right = render_stereo(world, p, calib, HEIGHT, WIDTH, rng)
        pairs.append(
            (np.round(left * 255).astype(np.uint8), np.round(right * 255).astype(np.uint8))
        )
    times = [float(f"{i / FPS:.6e}") for i in range(frames)]
    return pairs, times, poses


def write_config(path: str, lg_weights: str) -> str:
    with open(path, "w") as f:
        f.write(
            CONFIG_TMPL.format(
                fx=FX, fy=FX, cx=WIDTH / 2.0, cy=HEIGHT / 2.0, bf=FX * BASELINE, w=WIDTH,
                h=HEIGHT, model_dir=os.path.join(REPO, "weights") + os.sep,
                sp_weights="superpoint_render.safetensors", lg_weights=lg_weights,
                max_kp=MAX_KEYPOINTS,
            )
        )
    return path


@contextlib.contextmanager
def leg_environment(env: dict):
    """The leg's env on top of the caller's, restored whole afterwards (the
    facade bridges YAML knobs into os.environ)."""
    saved = dict(os.environ)
    os.environ.update(env)
    try:
        yield
    finally:
        os.environ.clear()
        os.environ.update(saved)


def run_leg(name: str, circuit, device: str = "cuda", lg_weights: str | None = None) -> dict:
    """One leg over the rendered circuit; returns its metrics row."""
    from superslam_tpu_torch.eval.metrics import ate, kitti_segment_errors, rpe
    from superslam_tpu_torch.slam import SuperSLAM

    env, default_lg, ref, gated = LEGS[name]
    gated = gated and lg_weights is None  # a checkpoint face-off is printed only
    pairs, times, gt = circuit
    with tempfile.TemporaryDirectory() as tmp, leg_environment(env):
        cfg = write_config(os.path.join(tmp, "config.yaml"), lg_weights or default_lg)
        slam = SuperSLAM(cfg, device=device)
        tracker = slam._tracker
        mode = {
            "depth": tracker.depth if tracker else 0,
            "batch": tracker.batch if tracker else 1,
            "device_tracking": bool(tracker and tracker.device_tracking),
            "device_kf": bool(tracker and tracker.device_kf),
        }
        t0 = time.perf_counter()
        for i, ((left, right), ts) in enumerate(zip(pairs, times)):
            slam.track_stereo(left, right, ts)
            if i == 0:
                t1 = time.perf_counter()  # frame 0 carries the first calls' set-up
        slam.flush()
        if slam.device.type == "cuda":
            import torch

            torch.cuda.synchronize(slam.device)
        end = time.perf_counter()
        wall = end - t0
        est = slam.estimator.corrected_trajectory()
        n_kf = len(slam.estimator.anchors())
        slam.shutdown()
    a = ate(est, gt)
    r = rpe(est, gt, delta_m=1.0)
    t_rel, r_rel = kitti_segment_errors(est, gt)
    row = {
        "leg": name,
        "env": env,
        "mode": mode,
        "ate_rmse_m": float(a.rmse),
        "ate_mean_m": float(a.mean),
        "ate_max_m": float(a.max),
        "rpe_rmse_m": float(r.rmse),
        "t_rel_percent": float(t_rel),
        "r_rel_deg_per_m": float(r_rel),
        "frames": min(len(est), len(gt)),
        "keyframes": n_kf,
        "wall_s": wall,
        "fps": (len(pairs) - 1) / (end - t1) if len(pairs) > 1 else None,
        "reference_ate_m": ref,
        "limit_m": GATE_FACTOR * ref if gated else None,
    }
    if lg_weights:
        row["checkpoint"] = lg_weights
    row["passed"] = bool(np.isfinite(a.rmse)) and (not gated or a.rmse <= GATE_FACTOR * ref)
    return row


def card_info(device: str) -> dict:
    """The card's name and power limit (nvidia-smi), or what ran instead."""
    if not device.startswith("cuda"):
        return {"platform": "cpu", "card": "none (CPU run)"}
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "not readable"
    return {"platform": "gpu", "card": card, "kind": torch.cuda.get_device_name(0)}


def run_suite(legs, frames: int = FRAMES, device: str = "cuda", checkpoints=(),
              log=print) -> dict:
    """Render the circuit once and run each leg (and each checkpoint's
    stereo leg); returns the artifact."""
    circuit = render_circuit(frames)
    rows = []
    for leg in legs:
        rows.append(run_leg(leg, circuit, device))
        log(f"[suite] {json.dumps(rows[-1])}")
    faceoff = []
    for ckpt in checkpoints:
        row = run_leg("stereo", circuit, device, lg_weights=ckpt)
        row["leg"] = f"stereo_lg_{os.path.splitext(ckpt)[0]}"
        side = os.path.join(REPO, "weights", ckpt + ".json")
        if os.path.exists(side):  # the checkpoint's training record
            with open(side) as f:
                meta = json.load(f)
            row.update({f"train_{k}": meta[k] for k in ("steps", "platform", "precision",
                                                        "recall") if k in meta})
        faceoff.append(row)
        log(f"[suite] {json.dumps(row)}")
    out = {
        "suite": "rendered-world accuracy, superslam_tpu_torch",
        "frames": frames,
        "device": card_info(device),
        "weights": "superpoint_render + lightglue_synth (weights/; stereo_passthrough = "
        "analytic-matcher ablation)",
        "legs": rows,
    }
    if faceoff:
        out["lightglue_checkpoints"] = faceoff
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(REPO, "ACCURACY_TORCH.json"))
    ap.add_argument("--frames", type=int, default=FRAMES)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--legs", nargs="*", default=list(LEGS), choices=list(LEGS))
    ap.add_argument(
        "--lg-checkpoints", nargs="*", default=[],
        help="LightGlue checkpoint face-off: the stereo leg once per weights/<name>",
    )
    args = ap.parse_args()
    suite = run_suite(args.legs, args.frames, args.device, args.lg_checkpoints)
    with open(args.out, "w") as f:
        json.dump(suite, f, indent=2)
        f.write("\n")
    print(f"[suite] wrote {args.out}")
    missed = [r["leg"] for r in suite["legs"] + suite.get("lightglue_checkpoints", [])
              if not r["passed"]]
    if missed:
        print(f"[suite] legs over their limit: {missed}")
    return 1 if missed else 0


if __name__ == "__main__":
    sys.exit(main())

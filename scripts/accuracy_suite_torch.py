#!/usr/bin/env python
"""Rendered-circuit accuracy legs through the PyTorch/CUDA port's facade.

The port's counterpart of ``scripts/accuracy_suite.py``. It renders the
150-frame sprite-room circuit in memory through the port's
``eval/synthetic_sequence.py`` with ``scripts/make_synthetic_sequence.py``'s
defaults (640x352, fx 320, baseline 0.3, 300 sprites, seed 0; frames
quantized to uint8 exactly as ``write_kitti_sequence`` writes its PNGs, so
every leg sees the reference legs' pixels) and that script's config
template (512 keypoints, threshold 0.010, ``superpoint_render`` +
``lightglue_synth``, a ``loop:`` block). The RGB-D legs render the same lap
with depth as ``write_tum_sequence`` writes it (gray round(x * 255), depth
uint16 clip(Z * 5000), times i / 30) and add ``DepthMapFactor: 5000.0``.
Each leg drives ``SuperSLAM(config, device=...)`` in-process with its
environment, and is scored with the port's ``eval/metrics.py``
(Umeyama-aligned ATE, RPE at 1 m, the KITTI segment metric) against the
rendered ground truth.

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
  stereo_devkf_nohybrid  SUPERSLAM_DEVICE_TRACKER=1
                      SUPERSLAM_DEVICE_KF_HYBRID=0 (every frame
                      re-matches inside the scan)             0.0662  printed
  stereo_devkf_passthrough  SUPERSLAM_DEVICE_TRACKER=1 with the
                      passthrough matcher                     0.1059  printed
  stereo_covis03      SUPERSLAM_KF_COVIS=0.3 (sparser keyframes) 2.3216  printed
  stereo_loop         SUPERSLAM_ENABLE_LOOP=1, SUPERSLAM_DEVICE_TRACKER=0
                      (laps=1.06 revisits the start)           0.0348  gated,
                      and at least one loop closure
  stereo_loop_randomplace  as stereo_loop with loop.weights_file a missing
                      file (a random-init recognizer)          0.0348  printed
  stereo_loop_devkf   SUPERSLAM_ENABLE_LOOP=1 on the card's default   printed
  rgbd                SUPERSLAM_DEVICE_TRACKER=0 (the reference ran host-solved
                      on its CPU)                              0.0969  gated
  rgbd_devtrack       the card's default (device-tracked mono chain) printed,
                      with its gap to rgbd
  stereo_xla_smoother the stereo leg with SUPERSLAM_XLA_SMOOTHER=1 (each
                      window solved on the device, ops/window_solver.py)
                      printed
  stereo_devkf_f32off stereo_devkf with SUPERSLAM_F32_PRECISION=0 (the
                      solver-precision fix off: ops/precision.py leaves the
                      TF32 flags as they are)              printed
The printed-only legs the reference ran host-solved on its CPU
(nogate, passthrough, covis03) also pin SUPERSLAM_DEVICE_TRACKER=0. A
gated leg passes at ATE <= 1.5 x its reference leg. A leg whose env holds
SUPERSLAM_F32_PRECISION, which ops/precision.py reads once at import, runs
in a child process: this script with ``--legs <leg>``, its row read back
from the child's artifact. Every row counts the host estimator's pose
solves (``host_solves``) and the loop closures. The artifact records
which build of the host estimator's C++ core the run loaded (its path,
size, SHA-1, the flags the Makefile builds it with and this host's CPU):
the dispatch-frozen leg reads another ATE with each build.

Usage (on the card; ``--device cpu`` for a CPU run, where 150 frames take
many minutes):
  python3 scripts/accuracy_suite_torch.py                       # every leg
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
    "stereo_devkf_nohybrid": (
        {"SUPERSLAM_DEVICE_TRACKER": "1", "SUPERSLAM_DEVICE_KF_HYBRID": "0"},
        "lightglue_synth.safetensors", 0.0662, False,
    ),
    "stereo_devkf_passthrough": (
        {"SUPERSLAM_DEVICE_TRACKER": "1"}, "__passthrough__", 0.1059, False,
    ),
    "stereo_covis03": (
        {**HOST_SOLVED, "SUPERSLAM_KF_COVIS": "0.3"}, "lightglue_synth.safetensors", 2.3216,
        False,
    ),
    "stereo_loop": (
        {**HOST_SOLVED, "SUPERSLAM_ENABLE_LOOP": "1"}, "lightglue_synth.safetensors", 0.0348, True,
    ),
    "stereo_loop_randomplace": (
        {**HOST_SOLVED, "SUPERSLAM_ENABLE_LOOP": "1"}, "lightglue_synth.safetensors", 0.0348,
        False,
    ),
    "stereo_loop_devkf": (
        {"SUPERSLAM_ENABLE_LOOP": "1"}, "lightglue_synth.safetensors", None, False,
    ),
    "rgbd": (HOST_SOLVED, "lightglue_synth.safetensors", 0.0969, True),
    "rgbd_devtrack": ({}, "lightglue_synth.safetensors", None, False),
    "stereo_xla_smoother": (
        {**HOST_SOLVED, "SUPERSLAM_XLA_SMOOTHER": "1"}, "lightglue_synth.safetensors", None, False,
    ),
    # The JAX suite's kill-switch leg (scripts/accuracy_suite.py:228-231):
    # on the TPU it read 0.0693 m against stereo_devkf's 0.0738 (ACCURACY.json
    # tpu_legs), where the fix is XLA's multi-pass f32 matmul. That is no
    # yardstick for the card, where the switch leaves TF32 as it is.
    "stereo_devkf_f32off": (
        {"SUPERSLAM_DEVICE_TRACKER": "1", "SUPERSLAM_F32_PRECISION": "0"},
        "lightglue_synth.safetensors", None, False,
    ),
}
GATE_FACTOR = 1.5
RGBD_LEGS = ("rgbd", "rgbd_devtrack")
DEPTH_FACTOR, RGBD_FPS = 5000.0, 30.0  # write_tum_sequence's
# Config lines a leg adds to the template (which ends in its loop: block).
CONFIG_EXTRA = {
    # JAX accuracy_suite.py:256-265: the recognizer's checkpoint a missing
    # file, so load_params falls back to a random init.
    "stereo_loop_randomplace": "  weights_file: __random_init_ablation__\n",
    "rgbd": f"DepthMapFactor: {DEPTH_FACTOR}\n",
    "rgbd_devtrack": f"DepthMapFactor: {DEPTH_FACTOR}\n",
}


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


def render_rgbd_circuit(frames: int = FRAMES):
    """The same lap seen by the RGB-D camera, as write_tum_sequence writes it
    (make_synthetic_sequence.py --format tum): (gray uint8, depth uint16)
    pairs, their timestamps (rgb.txt's %.6f of i / 30) and the poses."""
    from superslam_tpu_torch.eval.synthetic_sequence import (
        circuit_trajectory,
        make_room_world,
        render_view,
    )
    from superslam_tpu_torch.geometry.stereo_camera import StereoCalib

    world = make_room_world(np.random.default_rng(SEED), n_sprites=SPRITES)
    calib = StereoCalib(fx=FX, fy=FX, cx=WIDTH / 2.0, cy=HEIGHT / 2.0, baseline=BASELINE)
    poses = circuit_trajectory(FRAMES)[:frames]
    rng = np.random.default_rng(SEED + 1)
    pairs = []
    for p in poses:
        img, depth = render_view(world, p, calib, HEIGHT, WIDTH, rng, return_depth=True)
        pairs.append((np.round(img * 255).astype(np.uint8),
                      np.clip(depth * DEPTH_FACTOR, 0, 65535).astype(np.uint16)))
    times = [float(f"{i / RGBD_FPS:.6f}") for i in range(frames)]
    return pairs, times, poses


def write_config(path: str, lg_weights: str, extra: str = "") -> str:
    with open(path, "w") as f:
        f.write(
            CONFIG_TMPL.format(
                fx=FX, fy=FX, cx=WIDTH / 2.0, cy=HEIGHT / 2.0, bf=FX * BASELINE, w=WIDTH,
                h=HEIGHT, model_dir=os.path.join(REPO, "weights") + os.sep,
                sp_weights="superpoint_render.safetensors", lg_weights=lg_weights,
                max_kp=MAX_KEYPOINTS,
            )
            + extra
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
        cfg = write_config(os.path.join(tmp, "config.yaml"), lg_weights or default_lg,
                           CONFIG_EXTRA.get(name, ""))
        slam = SuperSLAM(cfg, device=device)
        tracker = slam._tracker
        mode = {
            "depth": tracker.depth if tracker else 0,
            "batch": tracker.batch if tracker else 1,
            "device_tracking": bool(tracker and tracker.device_tracking),
            "device_kf": bool(tracker and tracker.device_kf),
        }
        loop = slam.loop_enabled
        solves = []
        solve = slam.estimator.tracker.track_arrays
        slam.estimator.tracker.track_arrays = lambda *a, **k: solves.append(1) or solve(*a, **k)
        track = slam.track_rgbd if name in RGBD_LEGS else slam.track_stereo
        t0 = time.perf_counter()
        for i, (frame, ts) in enumerate(zip(pairs, times)):
            track(*frame, ts)
            if i == 0:
                t1 = time.perf_counter()  # frame 0 carries the first calls' set-up
        # Drain the tracker and the loop worker before reading the trajectory.
        slam.flush()
        slam.estimator.stop_loop_worker()
        if slam.device.type == "cuda":
            import torch

            torch.cuda.synchronize(slam.device)
        end = time.perf_counter()
        wall = end - t0
        est = slam.estimator.corrected_trajectory()
        n_kf = len(slam.estimator.anchors())
        n_loops = slam.loop_closure_count()
        slam.estimator.tracker.track_arrays = solve
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
        "host_solves": len(solves),
        "loop_enabled": loop,
        "loop_closures": n_loops,
        "wall_s": wall,
        "fps": (len(pairs) - 1) / (end - t1) if len(pairs) > 1 else None,
        "reference_ate_m": ref,
        "limit_m": GATE_FACTOR * ref if gated else None,
    }
    if lg_weights:
        row["checkpoint"] = lg_weights
    row["passed"] = bool(np.isfinite(a.rmse)) and (not gated or a.rmse <= GATE_FACTOR * ref)
    if gated and name == "stereo_loop":
        row["passed"] = row["passed"] and n_loops >= 1
    return row


def run_leg_in_child(name: str, frames: int, device: str) -> dict:
    """One leg in a child process of this script (``--legs name``) with
    the leg's env set before anything is imported; returns its row."""
    env, *_ = LEGS[name]
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "leg.json")
        cmd = [sys.executable, os.path.abspath(__file__), "--legs", name, "--frames",
               str(frames), "--device", device, "--out", out]
        child = subprocess.run(cmd, env={**os.environ, **env}, capture_output=True, text=True,
                               cwd=REPO)
        if child.returncode != 0:
            raise RuntimeError(f"leg {name}: the child process exited {child.returncode}:\n"
                               f"{child.stdout[-2000:]}{child.stderr[-4000:]}")
        with open(out) as f:
            (row,) = json.load(f)["legs"]
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


def host_core_build() -> dict:
    """Which build of the host estimator's C++ core (csrc/) this process
    loads: its path (SUPERSLAM_NATIVE_SO or csrc/libsuperslam_core.so),
    size and SHA-1, the compile command the Makefile gives for it, and
    this host's CPU (the default flags carry -march=native)."""
    import hashlib
    import platform

    from superslam_tpu_torch import native

    info = {"path": os.path.relpath(native._SO, REPO), "loaded": native.available()}
    if os.path.exists(native._SO):
        with open(native._SO, "rb") as f:
            blob = f.read()
        info.update(bytes=len(blob), sha1=hashlib.sha1(blob).hexdigest())
    make = subprocess.run(["make", "-n", "-B", "-C", native._CSRC], capture_output=True,
                          text=True, timeout=60)
    info["make_command"] = next((ln.strip() for ln in make.stdout.splitlines()
                                 if "-shared" in ln), None)
    cpu = platform.processor() or platform.machine()
    if os.path.exists("/proc/cpuinfo"):
        with open("/proc/cpuinfo") as f:
            cpu = next((ln.split(":", 1)[1].strip() for ln in f
                        if ln.split(":")[0].strip() in ("model name", "Model", "CPU part")), cpu)
    info["host_cpu"] = cpu
    info["machine"] = platform.machine()
    return info


def needs_child(leg: str) -> bool:
    """Whether the leg sets SUPERSLAM_F32_PRECISION, read once at import, to
    another value than this process read."""
    from superslam_tpu_torch.ops import precision

    env = LEGS[leg][0]
    return env.get("SUPERSLAM_F32_PRECISION", precision.F32_PRECISION_MODE) != (
        precision.F32_PRECISION_MODE)


def run_suite(legs, frames: int = FRAMES, device: str = "cuda", checkpoints=(),
              log=print) -> dict:
    """Render the circuit once (and once with depth, for the RGB-D legs) and
    run each leg (and each checkpoint's stereo leg); returns the artifact.
    rgbd_devtrack's row carries its gap to rgbd's ATE when both ran."""
    children = {leg for leg in legs if needs_child(leg)}
    in_process = set(legs) - children
    stereo = render_circuit(frames) if checkpoints or in_process - set(RGBD_LEGS) else None
    rgbd = render_rgbd_circuit(frames) if in_process & set(RGBD_LEGS) else None
    rows = []
    for leg in legs:
        if leg in children:
            rows.append(run_leg_in_child(leg, frames, device))
        else:
            rows.append(run_leg(leg, rgbd if leg in RGBD_LEGS else stereo, device))
        log(f"[suite] {json.dumps(rows[-1])}")
    by_leg = {r["leg"]: r for r in rows}
    if "rgbd" in by_leg and "rgbd_devtrack" in by_leg:
        by_leg["rgbd_devtrack"]["gap_to_rgbd_m"] = (
            by_leg["rgbd_devtrack"]["ate_rmse_m"] - by_leg["rgbd"]["ate_rmse_m"])
    faceoff = []
    for ckpt in checkpoints:
        row = run_leg("stereo", stereo, device, lg_weights=ckpt)
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
        "host_core": host_core_build(),
        "weights": "superpoint_render + lightglue_synth (weights/; stereo_passthrough = "
        "analytic-matcher ablation); eigenplaces_resnet18_512 for the loop legs "
        "(stereo_loop_randomplace = random-init recognizer)",
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

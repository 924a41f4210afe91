#!/usr/bin/env python3
"""Multi-sequence batched stereo tracking (BASELINE config 5) on the
PyTorch/CUDA port.

The port's counterpart of ``examples/multi_sequence.py``: S independent
KITTI-style sequences tracked through ONE fused device step a frame
(SuperPoint over all 2S images, 2S LightGlue pair problems, one packed
readback) by ``superslam_tpu_torch/parallel/multi_tracker.py``. With more
than one CUDA device the sequence axis is split over a
``parallel/mesh.py::make_mesh`` data axis: each card owns S/n sequences
with no cross-sequence communication.

Usage:
    python examples/multi_sequence_torch.py <settings.yaml> <seq_dir> [seq_dir ...]
        [--replicate N] [--max-frames M] [--out-dir results/multi] [--device cpu]

A single sequence dir with ``--replicate N`` tracks N copies (throughput
measurement); distinct dirs track independent streams. Trajectories are
written per sequence in KITTI format. The checkpoints are the config's
``superpoint.weights_file`` and ``lightglue.weights_file`` in
``SuperPoint.model_dir``, as the facade reads them, so one config tracks
with the same networks here and in ``examples/kitti_torch.py``. The JAX
runner always takes the upstream names there (``superpoint_v1``,
``lightglue_superpoint``) and so, on a config that names other
checkpoints, tracks with other weights than its own facade: this runner
does not copy that. Runs on CUDA unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from examples.example_common import load_gray, report_timing  # noqa: E402
from examples.kitti import load_kitti_sequence  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser(prog="multi_sequence")
    ap.add_argument("settings")
    ap.add_argument("sequences", nargs="+", help="one or more sequence dirs")
    ap.add_argument("--replicate", type=int, default=1)
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--out-dir", default=os.path.join("results", "multi"))
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()

    import torch

    from superslam_tpu_torch.config import Config, apply_tuning_overrides, read_calib
    from superslam_tpu_torch.frontend.matcher import LightGlueMatcher
    from superslam_tpu_torch.io.trajectory import save_trajectory_kitti
    from superslam_tpu_torch.models.lightglue import init_lightglue_params
    from superslam_tpu_torch.models.superpoint import init_superpoint_params
    from superslam_tpu_torch.models.weights import load_params
    from superslam_tpu_torch.parallel.multi_tracker import MultiSequenceTracker
    from superslam_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    cfg = Config.load(args.settings)
    apply_tuning_overrides(cfg)
    calib = read_calib(cfg)

    seq_dirs = [d for d in args.sequences for _ in range(args.replicate)]
    S = len(seq_dirs)
    seqs = [load_kitti_sequence(d) for d in seq_dirs]
    n_frames = min(len(s) for s in seqs)
    if args.max_frames:
        n_frames = min(n_frames, args.max_frames)

    # The checkpoints the facade loads: the config's weights_file keys in
    # model_dir, the upstream names by default, __passthrough__ for the
    # analytic matcher, a random init where the file is missing.
    model_dir = str(cfg.get("SuperPoint.model_dir", "weights/"))
    sp_name = cfg.get("superpoint.weights_file", "superpoint_v1.safetensors")
    lg_name = cfg.get("lightglue.weights_file", "lightglue_superpoint.safetensors")
    sp_params = load_params(
        os.path.join(model_dir, sp_name), lambda: init_superpoint_params(), device
    )
    if lg_name == "__passthrough__":
        lg_params = init_lightglue_params(passthrough=True, device=device)
    else:
        lg_params = load_params(
            os.path.join(model_dir, lg_name), lambda: init_lightglue_params(), device
        )
    w = int(cfg.get("lightglue.image_width", cfg.get("Camera.width", 640)))
    h = int(cfg.get("lightglue.image_height", cfg.get("Camera.height", 480)))
    max_kp = int(cfg.get("superpoint.max_keypoints", 512))

    mesh = None
    n_cards = torch.cuda.device_count() if device.type == "cuda" else 1
    if n_cards > 1:
        from superslam_tpu_torch.parallel.mesh import make_mesh

        # Largest device count whose data axis divides S (each card owns
        # whole sequences); 1 device -> no mesh.
        n = max((d for d in range(1, n_cards + 1) if S % d == 0), default=1)
        if n > 1:
            mesh = make_mesh(n, model_axis=1)
            print(f"data-parallel mesh: {mesh.devices.shape} over {S} sequences")

    tracker = MultiSequenceTracker(
        sp_params,
        lg_params,
        calib,
        num_sequences=S,
        width=w,
        height=h,
        max_keypoints=max_kp,
        keypoint_threshold=float(cfg.get("superpoint.keypoint_threshold", 0.005)),
        remove_borders=int(cfg.get("superpoint.remove_borders", 4)),
        window_size=int(cfg.get("Backend.window_size", 8)),
        matcher=LightGlueMatcher(
            lg_params, image_width=w, image_height=h, max_keypoints=max_kp, device=device
        ),
        mesh=mesh,
        device=device,
    )

    times_ms = []
    t_start = time.perf_counter()
    for i in range(n_frames):
        lefts, rights, stamps = [], [], []
        for s in range(S):
            t, lp, rp = seqs[s][i]
            lefts.append(load_gray(lp))
            rights.append(load_gray(rp))
            stamps.append(t)
        t0 = time.perf_counter()
        tracker.step(lefts, rights, stamps)
        times_ms.append((time.perf_counter() - t0) * 1e3)
    wall = time.perf_counter() - t_start

    report_timing(times_ms)
    print(
        f"aggregate throughput: {S * n_frames / wall:.1f} frames/s "
        f"({S} sequences x {n_frames} frames in {wall:.1f}s)"
    )
    os.makedirs(args.out_dir, exist_ok=True)
    for s, traj in enumerate(tracker.trajectories()):
        out = os.path.join(args.out_dir, f"seq{s:02d}.txt")
        save_trajectory_kitti(out, traj)
        print(f"trajectory -> {out}")


if __name__ == "__main__":
    main()

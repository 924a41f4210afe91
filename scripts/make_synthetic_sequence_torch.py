#!/usr/bin/env python3
"""Render a synthetic stereo sequence with ground truth to disk, through the
PyTorch/CUDA port's renderer (``superslam_tpu_torch/eval/synthetic_sequence.py``).

The port's counterpart of ``scripts/make_synthetic_sequence.py``: the same
flags, config template and files, byte for byte. It writes a
KITTI-odometry-layout directory (image_0/, image_1/, times.txt,
poses_gt.txt) from the textured-sprite world renderer, plus a ready-to-run
facade config; with the committed render-trained weights this closes the
accuracy loop offline: generate -> examples/kitti_torch.py ->
scripts/evaluate_kitti_torch.py.

With ``--format tum`` it instead writes a TUM RGB-D layout (rgb/, depth/
16-bit PNGs, rgb.txt, depth.txt, groundtruth.txt) with exact rendered
depth, for examples/tum_rgbd_torch.py and scripts/evaluate_tum_torch.py.

Rendering runs on the host; nothing here needs a card.

Usage:
  python scripts/make_synthetic_sequence_torch.py /tmp/synth_seq --frames 150
  python examples/kitti_torch.py /tmp/synth_seq/config.yaml /tmp/synth_seq \\
      --no-viewer --out /tmp/synth_est.txt
  python scripts/evaluate_kitti_torch.py /tmp/synth_est.txt /tmp/synth_seq/poses_gt.txt

  python scripts/make_synthetic_sequence_torch.py /tmp/synth_rgbd --format tum
  python examples/tum_rgbd_torch.py /tmp/synth_rgbd/config.yaml /tmp/synth_rgbd \\
      --no-viewer --out /tmp/synth_rgbd_est.txt
  python scripts/evaluate_tum_torch.py /tmp/synth_rgbd_est.txt \\
      /tmp/synth_rgbd/groundtruth.txt
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# The JAX script's config template (scripts/make_synthetic_sequence.py:39-60),
# which the port's accuracy runner already keeps.
from scripts.accuracy_suite_torch import CONFIG_TMPL  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("out_dir")
    ap.add_argument("--frames", type=int, default=150)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=352)
    ap.add_argument("--trajectory", choices=("circuit", "straight"), default="circuit")
    ap.add_argument(
        "--format",
        choices=("kitti", "tum"),
        default="kitti",
        help="kitti = stereo odometry layout; tum = RGB-D layout with "
        "exact rendered depth maps",
    )
    ap.add_argument("--sprites", type=int, default=300)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--fx", type=float, default=320.0)
    ap.add_argument("--baseline", type=float, default=0.3)
    ap.add_argument("--max-keypoints", type=int, default=512)
    ap.add_argument("--model-dir", default="weights/")
    # The render-domain-trained SuperPoint: the synthetic-shapes pretrain
    # alone loses tracking on these rendered worlds.
    ap.add_argument("--sp-weights", default="superpoint_render.safetensors")
    ap.add_argument(
        "--lg-weights",
        default="lightglue_synth.safetensors",
        help="lightglue checkpoint name in model_dir, or __passthrough__ "
        "for the analytic mutual-NN matcher (no checkpoint needed)",
    )
    args = ap.parse_args()

    from superslam_tpu_torch.eval.synthetic_sequence import (
        circuit_trajectory,
        make_room_world,
        straight_trajectory,
        write_kitti_sequence,
        write_tum_sequence,
    )
    from superslam_tpu_torch.geometry import StereoCalib

    rng = np.random.default_rng(args.seed)
    world = make_room_world(rng, n_sprites=args.sprites)
    calib = StereoCalib(
        fx=args.fx,
        fy=args.fx,
        cx=args.width / 2.0,
        cy=args.height / 2.0,
        baseline=args.baseline,
    )
    if args.trajectory == "circuit":
        poses = circuit_trajectory(args.frames)
    else:
        poses = straight_trajectory(args.frames)

    if args.format == "tum":
        print(f"rendering {args.frames} rgb+depth frames at {args.width}x{args.height} ...")
        write = write_tum_sequence
    else:
        print(f"rendering {args.frames} stereo pairs at {args.width}x{args.height} ...")
        write = write_kitti_sequence
    write(
        args.out_dir,
        world,
        poses,
        calib,
        args.height,
        args.width,
        seed=args.seed + 1,
        progress=True,
    )
    cfg = CONFIG_TMPL.format(
        fx=args.fx,
        fy=args.fx,
        cx=args.width / 2.0,
        cy=args.height / 2.0,
        bf=args.fx * args.baseline,
        w=args.width,
        h=args.height,
        model_dir=args.model_dir,
        sp_weights=args.sp_weights,
        lg_weights=args.lg_weights,
        max_kp=args.max_keypoints,
    )
    if args.format == "tum":
        # DepthMapFactor switches the facade into RGB-D mode; depth PNGs are
        # written as uint16 Z * 5000 (write_tum_sequence).
        cfg += "DepthMapFactor: 5000.0\n"
    with open(os.path.join(args.out_dir, "config.yaml"), "w") as f:
        f.write(cfg)
    if args.format == "tum":
        print(
            f"wrote {args.out_dir} (rgb/, depth/, rgb.txt, depth.txt, "
            "groundtruth.txt, config.yaml)"
        )
    else:
        print(f"wrote {args.out_dir} (images, times.txt, poses_gt.txt, config.yaml)")


if __name__ == "__main__":
    main()

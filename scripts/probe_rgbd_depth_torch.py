#!/usr/bin/env python3
"""Quantify RGB-D depth-sampling quality at the PyTorch/CUDA port's
extractor keypoints.

The port's counterpart of ``scripts/probe_rgbd_depth.py``: renders every
10th frame of the TUM-leg circuit (unscaled world, 640x352, fx=320), runs the port's
``SuperPointExtractor`` with the committed render-trained checkpoint,
samples depth as RgbdFrontEnd does (the rounded pixel, as the reference's
raw-pixel lookup), and reports:
  - the share of keypoints with Z == 0 (background / no data -> dropped);
  - among the valid ones, the error of the synthesized uR against the
    ground-truth uR (the disparity of the exact depth at the subpixel
    keypoint, bilinear over valid pixels), for rounded-pixel and 3x3
    valid-median sampling.

Runs on CUDA unless ``--device cpu`` is given.

Usage: python scripts/probe_rgbd_depth_torch.py [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

W, H, FX = 640, 352, 320.0


def bilinear_valid(depth, u, v):
    u0, v0 = int(np.floor(u)), int(np.floor(v))
    zs, ws = [], []
    for du, dv in [(0, 0), (1, 0), (0, 1), (1, 1)]:
        x, y = u0 + du, v0 + dv
        if 0 <= x < depth.shape[1] and 0 <= y < depth.shape[0]:
            z = depth[y, x]
            if z > 0:
                zs.append(z)
                ws.append((1 - abs(u - x)) * (1 - abs(v - y)))
    if not zs or sum(ws) < 1e-6:
        return 0.0
    return float(np.dot(zs, ws) / sum(ws))


def median3(depth, u, v):
    ui, vi = int(round(u)), int(round(v))
    vals = []
    for dv in (-1, 0, 1):
        for du in (-1, 0, 1):
            x, y = ui + du, vi + dv
            if 0 <= x < depth.shape[1] and 0 <= y < depth.shape[0]:
                z = depth[y, x]
                if z > 0:
                    vals.append(z)
    return float(np.median(vals)) if vals else 0.0


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()

    from superslam_tpu_torch.eval.synthetic_sequence import (
        circuit_trajectory,
        make_room_world,
        render_view,
    )
    from superslam_tpu_torch.frontend.extractor import SuperPointExtractor
    from superslam_tpu_torch.geometry import StereoCalib
    from superslam_tpu_torch.models.superpoint import init_superpoint_params
    from superslam_tpu_torch.models.weights import load_params

    world = make_room_world(np.random.default_rng(0), n_sprites=300)
    calib = StereoCalib(fx=FX, fy=FX, cx=W / 2, cy=H / 2, baseline=0.3)
    poses = circuit_trajectory(150)
    sp = load_params(
        os.path.join(REPO, "weights", "superpoint_render.safetensors"),
        lambda: init_superpoint_params(),
        args.device,
    )
    ext = SuperPointExtractor(
        sp, W, H, max_keypoints=512, keypoint_threshold=0.010, device=args.device
    )

    rrng = np.random.default_rng(1)
    n_kp = n_zero = 0
    ur_err_round, ur_err_med = [], []
    bf = calib.fx * calib.baseline
    for i in range(0, 150, 10):
        img, depth = render_view(world, poses[i], calib, H, W, rrng, return_depth=True)
        # Quantize like the PNG round trip.
        depth = np.round(depth * 5000).astype(np.uint16).astype(np.float64) / 5000
        kps = ext.extract(np.round(img * 255).astype(np.uint8)).keypoints
        n_kp += len(kps)
        for u, v in kps:
            ui, vi = int(round(u)), int(round(v))
            if not (0 <= ui < W and 0 <= vi < H):
                continue
            z_round = depth[vi, ui]
            z_gt = bilinear_valid(depth, u, v)
            if z_round <= 0:
                n_zero += 1
                continue
            if z_gt <= 0:
                continue
            ur_gt = u - bf / z_gt
            ur_err_round.append(abs((u - bf / z_round) - ur_gt))
            z_m = median3(depth, u, v)
            if z_m > 0:
                ur_err_med.append(abs((u - bf / z_m) - ur_gt))

    e = np.array(ur_err_round)
    m = np.array(ur_err_med)
    print(f"keypoints: {n_kp}, Z==0 at rounded pixel: {n_zero} "
          f"({100.0 * n_zero / max(n_kp, 1):.1f}%)")
    print(f"uR err (rounded-pixel): mean {e.mean():.3f}px p95 "
          f"{np.percentile(e, 95):.3f}px max {e.max():.3f}px")
    print(f"uR err (3x3 valid-median): mean {m.mean():.3f}px p95 "
          f"{np.percentile(m, 95):.3f}px max {m.max():.3f}px")


if __name__ == "__main__":
    main()

#!/usr/bin/env python
"""Fine-tune LightGlue on correspondences harvested from the synthetic
world, with the PyTorch/CUDA port (``superslam_tpu_torch``).

Counterpart of ``scripts/train_lightglue_synth.py``, same arguments and
defaults plus ``--device``: render sprite-world view pairs WITH exact
sprite-id maps, extract keypoints and descriptors through the trained
SuperPoint, derive ground-truth assignments by ray-plane intersection +
reprojection + id agreement, and fine-tune LightGlue (initialized from the
analytic mutual-NN passthrough construction) with the port's matcher train
step (``superslam_tpu_torch.parallel.training``). Every attention call of
a step, forward and backward, is a hand-written kernel on the card.

The checkpoint is written in the committed format (torch-layout fp16
safetensors), so it drops into either package's facade via
``lightglue.weights_file``.

Usage:
  python scripts/train_lightglue_synth_torch.py --steps 300 \\
      --sp-weights weights/superpoint_render.safetensors \\
      --out weights/lightglue_synth.safetensors
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv: list[str] | None = None) -> dict:
    """Harvest, train, evaluate and save; returns the run's metadata (also
    written beside the checkpoint), with the per-step losses under
    ``losses``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--cap", type=int, default=256, help="keypoint capacity")
    ap.add_argument("--pairs", type=int, default=160, help="harvest pool size")
    ap.add_argument("--height", type=int, default=240)
    ap.add_argument("--width", type=int, default=320)
    ap.add_argument(
        "--fx", type=float, default=320.0,
        help="harvest focal length: match the evaluation sequence's fx "
        "(apparent feature scale is fx/z, independent of image size)",
    )
    ap.add_argument("--lr", type=float, default=5e-5)
    ap.add_argument(
        "--stereo-frac", type=float, default=0.0,
        help="fraction of harvested pairs whose motion is the pure stereo "
        "baseline shift: the SAME LightGlue weights do L-R stereo matching "
        "in the fused pipeline, and VO-motion-only fine-tuning degrades it",
    )
    ap.add_argument(
        "--cosine", action="store_true",
        help="cosine-decay the lr to lr/20 over the run (with a 100-step "
        "warmup) instead of a flat schedule",
    )
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sp-weights", default="weights/superpoint_render.safetensors")
    ap.add_argument("--out", default="weights/lightglue_synth.safetensors")
    ap.add_argument("--from-random", action="store_true",
                    help="init from random instead of passthrough")
    ap.add_argument("--init-weights", default=None,
                    help="resume/fine-tune from an existing checkpoint "
                    "instead of the passthrough construction")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    import torch

    from superslam_tpu_torch.eval.synthetic_sequence import (
        make_room_world,
        random_interior_pose,
    )
    from superslam_tpu_torch.geometry import Pose3, StereoCalib
    from superslam_tpu_torch.models.lightglue import init_lightglue_params, lightglue_match
    from superslam_tpu_torch.models.superpoint import init_superpoint_params
    from superslam_tpu_torch.models.weights import load_params, save_params
    from superslam_tpu_torch.parallel.training import (
        make_optimizer,
        train_step,
        warmup_cosine_schedule,
    )
    from superslam_tpu_torch.train.render_domain import harvest_matching_pair, match_prf
    from superslam_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    rng = np.random.default_rng(args.seed)
    h, w = args.height, args.width
    calib = StereoCalib(fx=args.fx, fy=args.fx, cx=w / 2.0, cy=h / 2.0, baseline=0.3)
    sp_params = load_params(args.sp_weights, lambda: init_superpoint_params(), device)
    world = make_room_world(rng, n_sprites=240)

    print(f"harvesting {args.pairs} view pairs at {w}x{h} ...", flush=True)
    t0 = time.time()
    pool = []
    while len(pool) < args.pairs:
        # VO-like motion: a base pose on the circuit + a small random step.
        pose0 = random_interior_pose(rng, yaw_jitter=0.2)
        if rng.uniform() < args.stereo_frac:
            # Stereo geometry: the right camera is a pure baseline shift.
            xi = np.array([0.0, 0.0, 0.0, calib.baseline, 0.0, 0.0])
        else:
            xi = np.concatenate(
                [rng.normal(0, 0.02, 3), rng.normal(0, 0.08, 3)]  # [w, v]
            )
        pose1 = pose0 * Pose3.expmap(xi)
        s = harvest_matching_pair(
            sp_params, world, pose0, pose1, calib, h, w, args.cap, rng, device=device
        )
        if s is not None:
            pool.append(s)
    print(f"harvested in {time.time() - t0:.1f}s", flush=True)

    held = pool[: max(4, args.pairs // 10)]
    train = pool[len(held):]

    if args.init_weights:
        params = load_params(
            args.init_weights, lambda: init_lightglue_params(args.seed), device
        )
    else:
        params = init_lightglue_params(
            args.seed, passthrough=not args.from_random, device=device
        )
    if args.cosine:
        schedule = warmup_cosine_schedule(
            init_value=args.lr / 10.0, peak_value=args.lr,
            warmup_steps=min(100, max(1, args.steps // 10)),
            decay_steps=args.steps,
            end_value=args.lr / 20.0,
        )
    else:
        schedule = None
    optimizer = make_optimizer(params, args.lr)

    def eval_prf():
        ps, rs = [], []
        for s in held:
            one = {k: torch.from_numpy(v)[None].to(device) for k, v in s.items()}
            m0, _ = lightglue_match(
                params, one["kpts0"], one["desc0"], one["kpts1"], one["desc1"],
                one["mask0"], one["mask1"],
            )
            m = m0[0].cpu().numpy()
            qi = np.flatnonzero(m >= 0)
            p, r = match_prf(np.stack([qi, m[qi]], 1), s["gt_indices"])
            ps.append(p)
            rs.append(r)
        return float(np.mean(ps)), float(np.mean(rs))

    p0, r0 = eval_prf()
    print(f"init (passthrough={not args.from_random}): P {p0:.3f} R {r0:.3f}",
          flush=True)

    losses = []
    for step in range(1, args.steps + 1):
        idx = rng.integers(len(train), size=args.batch)
        batch = {
            k: torch.from_numpy(np.stack([train[i][k] for i in idx])).to(device)
            for k in train[0]
        }
        lr = schedule(step - 1) if schedule else None
        losses.append(float(train_step(params, optimizer, batch, lr)))
        if step % 50 == 0:
            print(f"step {step}: loss {np.mean(losses[-50:]):.4f}", flush=True)

    p1, r1 = eval_prf()
    print(f"trained: P {p1:.3f} R {r1:.3f}", flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    save_params(params, args.out)
    meta = {
        "steps": args.steps,
        "init": args.init_weights or ("random" if args.from_random else "passthrough"),
        "batch": args.batch,
        "pairs": args.pairs,
        "lr": args.lr,
        "cosine": args.cosine,
        "stereo_frac": args.stereo_frac,
        "platform": (
            torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
        ),
        "precision_init": p0,
        "recall_init": r0,
        "precision": p1,
        "recall": r1,
        "final_loss": float(np.mean(losses[-50:])) if losses else None,
    }
    with open(args.out + ".json", "w") as f:
        json.dump(meta, f, indent=1)
    print(f"wrote {args.out}")
    print(json.dumps(meta))
    return {**meta, "losses": losses}


if __name__ == "__main__":
    main()

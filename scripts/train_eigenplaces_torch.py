#!/usr/bin/env python
"""Train EigenPlaces (ResNet18+GeM) for loop-closure retrieval on the
rendered sprite world, with the PyTorch/CUDA port (``superslam_tpu_torch``).

Counterpart of ``scripts/train_eigenplaces.py``, same arguments and
defaults plus ``--device``. Objective: symmetric InfoNCE over (place, view)
renders. A "place" is an anchor pose on the circuit annulus; its views are
small pose perturbations. In-batch negatives are masked to places whose
circuit angle differs by more than --theta-margin: nearby angles see the
same wall and ARE the same place for loop closure.

Batch norm: training uses batch statistics
(``models/eigenplaces.py::eigenplaces_descriptor_train``) and EMAs them into
the running statistics the inference forward reads, so the saved checkpoint
drops into either package's loader unchanged. The forward is bf16, as in the
JAX package. The optimizer is optax's ``clip_by_global_norm(1.0)`` then
Adam under a warm-up cosine schedule (``clip_by_global_norm`` and
``train_step`` here, ``train/superpoint_train.py::make_sp_optimizer``'s
Adam, ``parallel/training.py::warmup_cosine_schedule``).

The data set lives on the device as one (N, size, size) uint8 tensor; each
step gathers its batch there by index and ImageNet-normalizes it.

Usage:
  python scripts/train_eigenplaces_torch.py --steps 1500 \\
      --out weights/eigenplaces_resnet18_512.safetensors
  python scripts/train_eigenplaces_torch.py --device cpu --steps 2 --places 4 \\
      --views 2 --eval-places 2 --batch-places 2 --size 64 --height 48 --width 64 \\
      --out /tmp/ep.safetensors   # a tiny rehearsal on the CPU
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def render_place_views(world, anchors, n_views, calib, h, w, size, rng, jitter):
    """(P, V, size, size) uint8: aspect-squashed resizes of (h, w) renders,
    the geometry the recognizer feeds the network at inference
    (preprocess_image squashes the camera frame). View 0 is the anchor."""
    import cv2

    from superslam_tpu_torch.eval.synthetic_sequence import render_view
    from superslam_tpu_torch.geometry import Pose3

    out = np.empty((len(anchors), n_views, size, size), np.uint8)
    for i, anchor in enumerate(anchors):
        for v in range(n_views):
            if v == 0:
                pose = anchor  # the gallery view
            else:
                xi = np.concatenate([rng.normal(0, jitter[0], 3), rng.normal(0, jitter[1], 3)])
                pose = anchor * Pose3.expmap(xi)
            img = render_view(world, pose, calib, h, w, rng)
            img8 = np.clip(img * 255.0, 0, 255).astype(np.uint8)
            out[i, v] = cv2.resize(img8, (size, size), cv2.INTER_LINEAR)
    return out


def batch_images(data, idx):
    """data (N, s, s) uint8 on the device, idx (B,) -> (B, 3, s, s)
    ImageNet-normalized gray-as-RGB, gathered and converted on the device."""
    from superslam_tpu_torch.models.eigenplaces import _imagenet_normalize

    x = data[idx].float() / 255.0
    return _imagenet_normalize(x[:, None].expand(-1, 3, -1, -1))


def loss_fn(params, images, theta_b, pair_to, temperature, theta_margin, dtype=None):
    """Symmetric InfoNCE with the angular negative mask. images (B, 3, s, s),
    theta_b (B,) circuit angles, pair_to (B,) index of each row's positive;
    ``dtype`` the forward's (default bf16, as the JAX script's). Returns
    (loss, batch BN statistics)."""
    import torch

    from superslam_tpu_torch.models.eigenplaces import eigenplaces_descriptor_train

    desc, stats = eigenplaces_descriptor_train(params, images, dtype or torch.bfloat16)
    logits = (desc @ desc.t()) / temperature  # (B, B)
    b = logits.shape[0]
    dth = torch.abs(theta_b[:, None] - theta_b[None, :])
    dth = torch.minimum(dth, 2 * np.pi - dth)
    eye = torch.eye(b, dtype=torch.bool, device=logits.device)
    is_pos = torch.zeros((b, b), dtype=torch.bool, device=logits.device)
    is_pos[torch.arange(b, device=logits.device), pair_to] = True
    # Valid contrast set: the paired view, plus places far enough along the
    # circuit to be genuinely different scenes.
    valid = is_pos | ((dth > theta_margin) & ~eye)
    masked = torch.where(valid, logits, torch.full_like(logits, -torch.inf))
    picked = torch.gather(masked, 1, pair_to[:, None].long())[:, 0]
    return -torch.mean(picked - torch.logsumexp(masked, dim=1)), stats


def clip_by_global_norm(grads, max_norm: float = 1.0) -> None:
    """optax.clip_by_global_norm in place: every gradient times
    max_norm / norm when the global norm is at least max_norm (optax's rule;
    ``torch.nn.utils.clip_grad_norm_`` divides by norm + 1e-6 instead). No
    host read."""
    import torch

    norm = torch.sqrt(sum(torch.sum(torch.square(g)) for g in grads))
    for g in grads:
        g.copy_(torch.where(norm < max_norm, g, g / norm * max_norm))


def train_step(params, optimizer, run_stats, images, theta_b, pair_to, lr,
               temperature, theta_margin, bn_momentum, dtype=None):
    """One step: InfoNCE, clip_by_global_norm(1.0), Adam at ``lr`` (the
    schedule's value for this update), then the BN running statistics
    EMA'd towards the batch's. Updates params and run_stats in place and
    returns the loss (a 0-d tensor; no host read)."""
    import torch

    optimizer.zero_grad(set_to_none=True)
    loss, stats = loss_fn(params, images, theta_b, pair_to, temperature, theta_margin, dtype)
    loss.backward()
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params.values()]
    for p, g in zip(params.values(), grads):
        p.grad = g
    clip_by_global_norm(grads, 1.0)
    for group in optimizer.param_groups:
        group["lr"] = lr
    optimizer.step()
    with torch.no_grad():
        for k, v in run_stats.items():
            v.mul_(1.0 - bn_momentum).add_(bn_momentum * stats[k])
    return loss.detach()


def main(argv: list[str] | None = None) -> dict:
    """Render, train, evaluate and save; returns the run's metadata (also
    written beside the checkpoint), with the per-step losses and step
    times under ``losses`` and ``step_ms``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--places", type=int, default=96)
    ap.add_argument("--views", type=int, default=4)
    ap.add_argument("--eval-places", type=int, default=32)
    ap.add_argument("--steps", type=int, default=1500)
    ap.add_argument("--batch-places", type=int, default=16)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--height", type=int, default=352)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--fx", type=float, default=320.0)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--temperature", type=float, default=0.07)
    ap.add_argument(
        "--theta-margin", type=float, default=0.30,
        help="circuit-angle separation (rad) below which two places are NOT "
        "used as negatives of each other (they see the same scene)",
    )
    ap.add_argument("--rot-jitter", type=float, default=0.08)
    ap.add_argument("--trans-jitter", type=float, default=0.30)
    ap.add_argument("--bn-momentum", type=float, default=0.1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="weights/eigenplaces_resnet18_512.safetensors")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    import torch

    from superslam_tpu_torch.eval.synthetic_sequence import make_room_world, random_interior_pose
    from superslam_tpu_torch.geometry import StereoCalib
    from superslam_tpu_torch.models.eigenplaces import (
        eigenplaces_descriptor,
        init_eigenplaces_params,
    )
    from superslam_tpu_torch.models.weights import save_params
    from superslam_tpu_torch.parallel.training import warmup_cosine_schedule
    from superslam_tpu_torch.train.superpoint_train import make_sp_optimizer
    from superslam_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    rng = np.random.default_rng(args.seed)
    h, w, size = args.height, args.width, args.size
    calib = StereoCalib(fx=args.fx, fy=args.fx, cx=w / 2.0, cy=h / 2.0, baseline=0.3)

    # Train places on the suite's world, eval places on a FRESH world
    # (different sprites, same statistics): retrieval must generalize to
    # scene content, not memorize sprites.
    print(f"rendering {args.places}x{args.views} train views ...", flush=True)
    t0 = time.time()
    world = make_room_world(rng, n_sprites=300)
    anchors = [random_interior_pose(rng) for _ in range(args.places)]
    # A place's identity for negative-masking is its circuit angle,
    # recovered from the camera centre (c = [r sin t, y, -r cos t]).
    thetas = np.array([np.arctan2(p.t[0], -p.t[2]) for p in anchors])
    train_views = render_place_views(
        world, anchors, args.views, calib, h, w, size, rng, (args.rot_jitter, args.trans_jitter)
    )
    print(f"  train renders in {time.time() - t0:.1f}s", flush=True)
    t0 = time.time()
    eval_world = make_room_world(np.random.default_rng(args.seed + 999), n_sprites=300)
    eval_anchors = [random_interior_pose(rng) for _ in range(args.eval_places)]
    eval_thetas = np.array([np.arctan2(p.t[0], -p.t[2]) for p in eval_anchors])
    eval_views = render_place_views(
        eval_world, eval_anchors, 2, calib, h, w, size, rng, (args.rot_jitter, args.trans_jitter)
    )
    print(f"  eval renders in {time.time() - t0:.1f}s", flush=True)

    # The device-resident data set: one upload.
    data = torch.from_numpy(train_views.reshape(-1, size, size)).to(device)
    eval_data = torch.from_numpy(eval_views.reshape(-1, size, size)).to(device)

    init = init_eigenplaces_params(args.seed, device=device)
    run_stats = {k: v.clone() for k, v in init.items() if "running_" in k}
    trainable = {k: v for k, v in init.items() if "running_" not in k}
    schedule = warmup_cosine_schedule(
        init_value=args.lr / 10.0, peak_value=args.lr,
        warmup_steps=max(1, args.steps // 15),
        decay_steps=args.steps, end_value=args.lr / 20.0,
    )
    optimizer = make_sp_optimizer(trainable, args.lr)  # optax.adam; lr set per step

    def eval_recall():
        """recall@1 on the held-out world: each query view must retrieve its
        own place's gallery view (within theta-margin counts: that IS the
        same place for the loop closer)."""
        p = {k: v.detach() for k, v in trainable.items()}
        p.update(run_stats)
        n = len(eval_anchors)
        gallery = torch.arange(n, device=device) * 2
        g = torch.cat([eigenplaces_descriptor(p, batch_images(eval_data, i))
                       for i in gallery.split(16)])
        q = torch.cat([eigenplaces_descriptor(p, batch_images(eval_data, i + 1))
                       for i in gallery.split(16)])
        sim = (q @ g.t()).cpu().numpy()
        top = np.argmax(sim, 1)
        dth = np.abs(eval_thetas[top] - eval_thetas)
        dth = np.minimum(dth, 2 * np.pi - dth)
        r1 = float(np.mean((top == np.arange(len(top))) | (dth < args.theta_margin)))
        same = float(np.mean(np.diag(sim)))
        far = np.abs(eval_thetas[:, None] - eval_thetas[None, :])
        far = np.minimum(far, 2 * np.pi - far) > args.theta_margin
        diff = float(np.mean(sim[far])) if far.any() else float("nan")
        return r1, same, diff

    r1_0, same0, diff0 = eval_recall()
    print(f"init: recall@1 {r1_0:.3f} same {same0:.3f} vs diff {diff0:.3f}", flush=True)

    P, V, B = args.places, args.views, args.batch_places
    losses, step_ms = [], []
    t0 = time.time()
    for step in range(args.steps):
        pl = rng.choice(P, size=B, replace=False)
        v2 = np.array([rng.choice(V, size=2, replace=False) for _ in pl])
        idx = np.concatenate([pl * V + v2[:, 0], pl * V + v2[:, 1]])
        theta_b = np.concatenate([thetas[pl], thetas[pl]]).astype(np.float32)
        pair_to = np.concatenate([np.arange(B) + B, np.arange(B)])
        ts = time.perf_counter()
        loss = train_step(
            trainable, optimizer, run_stats,
            batch_images(data, torch.from_numpy(idx).to(device)),
            torch.from_numpy(theta_b).to(device), torch.from_numpy(pair_to).to(device),
            schedule(step), args.temperature, args.theta_margin, args.bn_momentum,
        )
        losses.append(float(loss))
        step_ms.append((time.perf_counter() - ts) * 1e3)
        if (step + 1) % 50 == 0:
            print(f"step {step + 1}: loss {np.mean(losses[-50:]):.4f} "
                  f"({(time.time() - t0) / (step + 1):.2f}s/step)", flush=True)

    r1_1, same1, diff1 = eval_recall()
    print(f"trained: recall@1 {r1_1:.3f} same {same1:.3f} vs diff {diff1:.3f}", flush=True)

    final = {k: v.detach() for k, v in trainable.items()}
    final.update(run_stats)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    save_params(final, args.out)
    meta = {
        "steps": args.steps,
        "places": P,
        "views": V,
        "batch_places": B,
        "lr": args.lr,
        "temperature": args.temperature,
        "theta_margin": args.theta_margin,
        "platform": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "recall_at_1_init": r1_0,
        "recall_at_1": r1_1,
        "same_place_score": same1,
        "diff_place_score": diff1,
        "final_loss": float(np.mean(losses[-50:])) if losses else None,
    }
    with open(args.out + ".json", "w") as f:
        json.dump(meta, f, indent=1)
    print(f"wrote {args.out}")
    print(json.dumps(meta))
    return {**meta, "losses": losses, "step_ms": step_ms}


if __name__ == "__main__":
    main()

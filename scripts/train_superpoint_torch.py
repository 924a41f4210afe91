#!/usr/bin/env python
"""Pretrain SuperPoint on procedural synthetic shapes (MagicPoint recipe)
and sprite-world renders, with the PyTorch/CUDA port (``superslam_tpu_torch``).

Counterpart of ``scripts/train_superpoint.py``, same arguments and defaults
plus ``--device``: trains the detector + descriptor from scratch (or from
``--resume``) on procedurally generated corner data
(``superslam_tpu_torch.train``) and writes a torch-layout fp16 safetensors
checkpoint (``models/weights.py::save_params``) that either package's loader
reads, with its metadata in a ``.json`` beside it.

The train step (``train/superpoint_train.py::sp_train_step``) runs on the
device in f32; a producer thread renders fresh shape pairs (and, with
``--render-frac``, two-view sprite-world renders) into reusable pools
meanwhile. The wire format ships uint8 images + the 3x3 homography (or the
per-cell reprojection targets of a render pair); the descriptor targets are
derived on the device. Evaluation extracts through the production path
(``superpoint_extract``: the hand-written conv and NMS kernels on the card).

Usage:
  python scripts/train_superpoint_torch.py --steps 4000 --batch 32 \\
      --out weights/superpoint_synth.safetensors
  python scripts/train_superpoint_torch.py --device cpu --steps 2 --batch 2 \\
      --pool 4 --eval-every 0 --out /tmp/sp.safetensors   # a tiny rehearsal
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv: list[str] | None = None) -> dict:
    """Fill the pools, train, evaluate and save; returns the run's metadata
    (also written beside the checkpoint), with the per-step losses under
    ``losses``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=4000)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--height", type=int, default=120)
    ap.add_argument("--width", type=int, default=160)
    ap.add_argument("--pool", type=int, default=1200)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--eval-every", type=int, default=500)
    ap.add_argument("--out", default="weights/superpoint_synth.safetensors")
    ap.add_argument("--resume", default=None, help="checkpoint to continue from")
    ap.add_argument(
        "--render-frac", type=float, default=0.0,
        help="fraction of steps trained on sprite-world renders (domain "
        "adaptation for the synthetic accuracy sequences)",
    )
    ap.add_argument("--render-height", type=int, default=240)
    ap.add_argument("--render-width", type=int, default=320)
    ap.add_argument(
        "--render-fx", type=float, default=320.0,
        help="render focal length: match the evaluation sequence's fx so "
        "apparent feature scale (fx/z) matches at test time",
    )
    ap.add_argument("--render-batch", type=int, default=8)
    ap.add_argument("--render-pool", type=int, default=300)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    import torch

    from superslam_tpu_torch.models.superpoint import init_superpoint_params
    from superslam_tpu_torch.models.weights import load_params, save_params
    from superslam_tpu_torch.train.superpoint_train import (
        evaluate_detector,
        make_sp_optimizer,
        sp_train_step,
    )
    from superslam_tpu_torch.train.synthetic_shapes import compact_pair
    from superslam_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    rng = np.random.default_rng(args.seed)
    h, w = args.height, args.width

    print(f"filling pool with {args.pool} pairs at {w}x{h} ...", flush=True)
    t0 = time.time()
    pool = [compact_pair(rng, h, w) for _ in range(args.pool)]
    print(f"pool ready in {time.time() - t0:.1f}s", flush=True)

    rsource = rpool = None
    if args.render_frac > 0:
        from superslam_tpu_torch.train.render_domain import RenderDomainSource

        rsource = RenderDomainSource(rng, args.render_height, args.render_width, fx=args.render_fx)
        print(f"filling render pool with {args.render_pool} pairs ...", flush=True)
        t0 = time.time()
        rpool = [rsource.two_view_compact(rng) for _ in range(args.render_pool)]
        print(f"render pool ready in {time.time() - t0:.1f}s", flush=True)

    stop = threading.Event()
    gen_count = [0]

    def producer() -> None:
        prng = np.random.default_rng(args.seed + 1)
        while not stop.is_set():
            if rpool is not None and prng.uniform() < args.render_frac:
                rpool[int(prng.integers(len(rpool)))] = rsource.two_view_compact(prng)
            else:
                pool[int(prng.integers(len(pool)))] = compact_pair(prng, h, w)
            gen_count[0] += 1

    th = threading.Thread(target=producer, daemon=True)
    th.start()

    params = load_params(args.resume, lambda: init_superpoint_params(args.seed), device)
    optimizer = make_sp_optimizer(params, args.lr)

    def batch_of(src, indices):
        sel = [src[i] for i in indices]
        return {k: torch.from_numpy(np.stack([s[k] for s in sel])).to(device) for k in sel[0]}

    def save():
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        save_params(params, args.out)

    eval_rng = np.random.default_rng(args.seed + 2)
    evals, losses = [], []
    t0 = time.time()
    try:
        for step in range(1, args.steps + 1):
            if rpool is not None and rng.uniform() < args.render_frac:
                b = batch_of(rpool, rng.integers(len(rpool), size=args.render_batch))
            else:
                b = batch_of(pool, rng.integers(len(pool), size=args.batch))
            loss, aux = sp_train_step(params, optimizer, b)
            losses.append(float(loss))
            if step % 100 == 0:
                rate = step / (time.time() - t0)
                print(
                    f"step {step}: loss {np.mean(losses[-100:]):.4f} "
                    f"(ce {float(aux['ce0']):.3f}/{float(aux['ce1']):.3f} "
                    f"desc {float(aux['desc']):.3f} "
                    f"hard {float(aux['hard']):.3f}) {rate:.1f} steps/s "
                    f"fresh={gen_count[0]}",
                    flush=True,
                )
            if args.eval_every and step % args.eval_every == 0:
                m = evaluate_detector(params, eval_rng, h=h, w=w)
                print(f"  eval @{step}: {json.dumps(m)}", flush=True)
                entry = {"step": step, "eval": m}
                if rsource is not None:
                    mr = evaluate_detector(params, eval_rng, image_fn=rsource.labeled_image)
                    mm = rsource.matching_eval(params, eval_rng)
                    print(f"  render eval @{step}: {json.dumps(mr)} match: {json.dumps(mm)}",
                          flush=True)
                    entry.update(render_eval=mr, match=mm)
                evals.append(entry)
                save()
    finally:
        stop.set()
        th.join()

    metrics = evaluate_detector(params, eval_rng, n_images=16, h=h, w=w)
    render_metrics = None
    if rsource is not None:
        render_metrics = evaluate_detector(
            params, eval_rng, n_images=16, image_fn=rsource.labeled_image
        )
        render_metrics.update(rsource.matching_eval(params, eval_rng, n_pairs=8))
    save()
    meta = {
        "steps": args.steps,
        "batch": args.batch,
        "image": [h, w],
        "final_loss": float(np.mean(losses[-100:])) if losses else None,
        "eval": metrics,
        "render_frac": args.render_frac,
        "render_eval": render_metrics,
    }
    with open(args.out + ".json", "w") as f:
        json.dump(meta, f, indent=1)
    print(f"wrote {args.out}")
    print(json.dumps(meta))
    return {**meta, "losses": losses, "evals": evals, "fresh": gen_count[0]}


if __name__ == "__main__":
    main()

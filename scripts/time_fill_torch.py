#!/usr/bin/env python
"""Time the multi-sequence tracker's fill of its upload slot
(``frontend/fused.py::fill_padded``, what ``MultiSequenceTracker._prepare``
calls) at each pool size: each share copied by the native fill (shipped)
or by numpy's copies (its fallback without the library), with only the
pads zeroed (shipped) or with each image's whole slot zeroed first (the
fill before it); torch's ``copy_`` and ``zero_`` on the calling thread,
split by ATen over its own intra-op threads (an alternative without a
pool); then, at the shipped pool size, small batches through the pool
against inline.

The images are the benchmark's: the KITTI cell's rendered arc
(``slambench/render.py::frame_set``, rendered into ``slambench/.cache``
when no run has yet), S streams at seeded offsets walked forward and back
as ``slambench/entries/multi_stereo.py`` walks them, written in turns into
two slots of pinned memory (on a host with a card; pageable without).
``--random H W`` takes random frames of that size instead.

Every setting fills once a step, in an order rotated step by step, so
that all see the same drift of the host. Each line is one setting's host
ms over ``--reps`` steps after 5 discarded ones (median, 10th and 90th
percentile); the last line is one JSON object.
Prints the cores the process may run on and, with a card, its name and
power limit. Host times only: nothing here runs on the card.

Usage: python scripts/time_fill_torch.py [--streams 16] [--reps 200]
           [--workers 1 2 3 4 6 8] [--random H W]
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

WARMUP = 5  # steps discarded first: the pools' threads, page faults


def _frames(args) -> np.ndarray:
    """(frames, 2, H, W) uint8."""
    if args.random:
        h, w = args.random
        return np.random.default_rng(0).integers(0, 256, (8, 2, h, w), dtype=np.uint8)
    from slambench.render import frame_set

    with open(os.path.join(ROOT, "slambench", "configs", "kitti00-stereo.json")) as f:
        cfg = json.load(f)
    return frame_set(cfg, 2)[0]


def _slot(shape, pinned: bool) -> np.ndarray:
    import torch

    return torch.empty(shape, dtype=torch.uint8, pin_memory=pinned).numpy()


def _full_zero(filler):
    """The fill before the pads-only one: each image's whole slot zeroed,
    then the image written."""

    def make(out, images):
        fill = filler(out, images)

        def zero_then_fill(lo, hi):
            out[lo:hi] = 0
            fill(lo, hi)

        return zero_then_fill

    return make


def _numpy_filler(out, images):
    """The fallback's fill without the native library: numpy's copies."""
    from superslam_tpu_torch.frontend import fused

    return functools.partial(fused._fill_numpy, out, images)


def _split(pool, fill, n: int, workers: int) -> None:
    """``fill_padded``'s split: contiguous shares of whole images, one a
    worker, each under its ``upload.fill`` span; inline for one worker."""
    from superslam_tpu_torch.frontend import fused

    if workers < 2:
        fill(0, n)
        return
    bounds = [n * i // workers for i in range(workers + 1)]
    for f in [pool.submit(fused._fill_share, fill, lo, hi) for lo, hi in zip(bounds, bounds[1:])]:
        f.result()


def _torch_fill(out, images) -> None:
    """Each image by torch's ``copy_`` and its pads by ``zero_`` on the
    calling thread; ATen splits each over its intra-op threads."""
    import torch

    t = torch.from_numpy(out)
    pad_h, pad_w = out.shape[1:]
    for k, a in enumerate(images):
        h, w = min(a.shape[0], pad_h), min(a.shape[1], pad_w)
        t[k, :h, :w].copy_(torch.from_numpy(a[:h, :w]))
        t[k, h:].zero_()
        t[k, :h, w:].zero_()


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--streams", type=int, default=16)
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--workers", type=int, nargs="+", default=[1, 2, 3, 4, 6, 8])
    ap.add_argument("--random", type=int, nargs=2, metavar=("H", "W"))
    args = ap.parse_args(argv)

    import torch

    from superslam_tpu_torch.frontend import fused
    from superslam_tpu_torch.frontend.extractor import pad_to_multiple
    from slambench.render import pingpong

    on_card = torch.cuda.is_available()
    if on_card:
        q = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True)
        print(f"card: {q.stdout.strip()}")
    cores = len(os.sched_getaffinity(0))
    print(f"cores: {cores} (os.cpu_count {os.cpu_count()}); shipped FILL_WORKERS "
          f"{fused.FILL_WORKERS}, FILL_MIN_IMAGES {fused.FILL_MIN_IMAGES}")

    frames = _frames(args)
    n, _, h, w = frames.shape
    pad = (pad_to_multiple(h), pad_to_multiple(w))
    rng = np.random.default_rng(0x0FF5)
    offsets = rng.integers(0, 2 * (n - 1), args.streams)
    slots = [_slot((2 * args.streams, *pad), on_card) for _ in range(2)]
    count = 2 * args.streams

    pools = {k: ThreadPoolExecutor(k) for k in sorted(set(args.workers) | {fused.FILL_WORKERS})}
    fillers = {"native": fused._filler, "numpy": _numpy_filler}

    def pooled(filler, k, n_img):
        workers = min(k, cores, n_img)
        return lambda out, images: _split(pools.get(k), filler(out, images), n_img, workers)

    # (label, images, fill(out, images))
    settings = [
        (dict(images=count, copy=copy, zero=zero, cap=k, workers=min(k, cores, count)), count,
         pooled(fillers[copy] if zero == "pads" else _full_zero(fillers[copy]), k, count))
        for copy in ("native", "numpy") for zero in ("pads", "full") for k in args.workers
    ] + [
        (dict(images=count, copy="torch", zero="pads", aten_threads=torch.get_num_threads()),
         count, _torch_fill)
    ] + [
        (dict(images=small, copy="native", zero="pads", route=route), small,
         pooled(fused._filler, fused.FILL_WORKERS if route == "pool" else 1, small))
        for small in (2, 3, 4, 6, 8, 12, 16) if small <= count for route in ("inline", "pool")
    ]
    ms = [[] for _ in settings]
    try:
        # Every setting once a step, in an order rotated step by step, so
        # that all of them see the same drift of the host.
        for t in range(WARMUP + args.reps):
            idx = [pingpong(int(o) + t, n) for o in offsets]
            imgs = [frames[idx[j // 2], j % 2] for j in range(count)]
            r = t % len(settings)
            for i in list(range(r, len(settings))) + list(range(r)):
                _, k_img, fill = settings[i]
                out = slots[(t + i) % 2][:k_img]
                t0 = time.perf_counter()
                fill(out, imgs[:k_img])
                if t >= WARMUP:
                    ms[i].append((time.perf_counter() - t0) * 1e3)
    finally:
        for p in pools.values():
            p.shutdown()

    results = []
    for (row, *_), m in zip(settings, ms):
        row.update(median_ms=float(np.median(m)), p10_ms=float(np.percentile(m, 10)),
                   p90_ms=float(np.percentile(m, 90)))
        results.append(row)
        print("  ".join(f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
                        for k, v in row.items()), flush=True)

    out = {"cores": cores, "card": on_card, "frames": [n, h, w], "pad": list(pad),
           "results": results}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()

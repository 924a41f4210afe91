#!/usr/bin/env python
"""Time the matcher's train step: ``train_step`` and ``sharded_train_step``
over a (1, 1) mesh of the same device, on one synthetic batch (chip_smoke's
training shape by default: 8 pairs, 256 keypoints, f32, lr 3e-4), each
the median of ``--steps`` steps after 3 discarded ones, the two interleaved
step by step so that both see the same clocks.

On the card the times are CUDA events around each step, and one more
step of each runs under torch.profiler for the device events it issues and
their busy time (a count that does not move with the host's noise); on the
CPU the times are the host's clock and say nothing about the card. Prints
the card's name and power limit (on the card) and, last, one JSON line.

The script reads the package beside it, so a copy of it in another
checkout times that checkout's step: run it in two trees, in the order
A B B A, to compare them on one card.

Usage: python scripts/time_train_step_torch.py [--steps 20] [--batch 8] [--cap 256]
           [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

WARMUP = 3  # steps discarded first: cuBLAS handles, optimizer state, the kernels' build


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--cap", type=int, default=256, help="keypoint capacity")
    ap.add_argument("--device", default="cuda", help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    import torch

    from superslam_tpu_torch.models.lightglue import init_lightglue_params
    from superslam_tpu_torch.parallel.mesh import make_mesh
    from superslam_tpu_torch.parallel.training import (
        make_optimizer,
        sharded_train_step,
        synthetic_matching_batch,
        train_step,
    )
    from superslam_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    batch = {k: torch.from_numpy(v).to(device) for k, v in
             synthetic_matching_batch(np.random.default_rng(19), args.batch, args.cap).items()}
    mesh = make_mesh(1, devices=[device])
    runs = {
        "train_step": lambda p, o: train_step(p, o, batch),
        "sharded_train_step_1x1": lambda p, o: sharded_train_step(p, o, batch, mesh),
    }
    state = {}
    for name in runs:
        params = init_lightglue_params(1, device=device)
        state[name] = (params, make_optimizer(params, 3e-4))

    def step_ms(name) -> float:
        run, (params, optimizer) = runs[name], state[name]
        if device.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            run(params, optimizer)
            b.record()
            b.synchronize()
            return a.elapsed_time(b)
        t0 = time.perf_counter()
        run(params, optimizer)
        return (time.perf_counter() - t0) * 1e3

    times = {name: [] for name in runs}
    for i in range(WARMUP + args.steps):
        for name in runs:
            ms = step_ms(name)
            if i >= WARMUP:
                times[name].append(ms)
    device_events = {}
    if device.type == "cuda":
        from torch.profiler import ProfilerActivity, profile

        for name in runs:  # one more step of each: what it issues to the card
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                step_ms(name)
            on_card = [e for e in prof.key_averages()
                       if "CUDA" in str(e.device_type) and e.self_device_time_total > 0]
            device_events[f"{name}_device_events"] = sum(e.count for e in on_card)
            device_events[f"{name}_device_busy_ms"] = sum(
                e.self_device_time_total for e in on_card) / 1e3
    out = {
        "device": str(device),
        "clock": "CUDA events" if device.type == "cuda" else "host (not a device time)",
        "batch": args.batch, "cap": args.cap, "steps": args.steps,
        **{f"{name}_median_ms": statistics.median(t) for name, t in times.items()},
        **device_events,
        **{f"{name}_ms": t for name, t in times.items()},
    }
    if device.type == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
        print(f"card: {smi.stdout.strip() or 'not readable'}")
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()

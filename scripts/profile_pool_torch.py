#!/usr/bin/env python
"""Time 2x2 max-pool formulations on the card, and what folding the pool
into the conv pairs saves.

The port's counterpart of ``scripts/profile_pool.py``: its nine
formulations of a 2x2 max pool, under its labels, at its canvas shape
(2, 64, 400, 1280) bf16, in PyTorch:

  reduce_window 2x2 bf16     F.max_pool2d in NCHW bf16
  reduce_window 2x2 f32      the same in f32
  rw f32-compute bf16 io     f32 compute, bf16 in and out
  reduce_window nhwc bf16    F.max_pool2d on a channels_last (NHWC) tensor
  reduce_window vert only    F.max_pool2d (2, 1)
  reduce_window horiz only   F.max_pool2d (1, 2)
  strided slices             max of the even and odd rows, then columns
  reshape minor max          amax over a reshaped 2 of rows, then columns
  vert rw + strided horiz    F.max_pool2d (2, 1), then strided columns

Each result is checked equal to ``F.max_pool2d`` with the same window (a
max is exact) on random bf16 values. Beside them, rows 1-2 of PERF.md's
kernel table at the main path's shapes (CIN 1 at (2, 1, 384, 1248), CIN 64
at (2, 64, 192, 624)): the pooled conv pair (``conv_pair_pool``, the main
path) against the same kernel unpooled (``conv_pair``) plus the fastest
full 2x2 formulation on its output; the pooled output is checked against
that pool of the unpooled one.

Timing: CUDA events around LO and HI back-to-back calls, (t_HI - t_LO) /
(HI - LO), the smallest of REPS, as ``profile_stages.py::timed_scan``
differences two scan lengths: one call between two events times the
host's issue as much as the card (PERF.md section 6). On the CPU
(``--device cpu``, for a rehearsal at a small ``--shape``) the same loops
run on the host clock and say nothing about the card.

Usage: python3 scripts/profile_pool_torch.py [--device cuda|cpu]
           [--shape B C H W] [--frame H W]
Exits 1 when a formulation or the folded pool disagrees.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

SHAPE = (2, 64, 400, 1280)  # scripts/profile_pool.py's canvas
FRAME = (384, 1248)  # the KITTI frame padded to the frontends' 32-pixel quantum
LO, HI, REPS = 4, 16, 3
FULL, VERT, HORIZ = (2, 2), (2, 1), (1, 2)


def _strided(t):
    v = torch.maximum(t[:, :, 0::2], t[:, :, 1::2])
    return torch.maximum(v[:, :, :, 0::2], v[:, :, :, 1::2])


def _reshape_minor(t):
    b, c, h, w = t.shape
    v = t.reshape(b, c, h // 2, 2, w).amax(dim=3)
    return v.reshape(b, c, h // 2, w // 2, 2).amax(dim=4)


def _vert_then_strided(t):
    v = F.max_pool2d(t, VERT)
    return torch.maximum(v[:, :, :, 0::2], v[:, :, :, 1::2])


# label -> (the pool, its input's form, its window)
FORMULATIONS = {
    "reduce_window 2x2 bf16": (lambda t: F.max_pool2d(t, FULL), "bf16", FULL),
    "reduce_window 2x2 f32": (lambda t: F.max_pool2d(t, FULL), "f32", FULL),
    "rw f32-compute bf16 io": (
        lambda t: F.max_pool2d(t.float(), FULL).to(torch.bfloat16), "bf16", FULL),
    "reduce_window nhwc bf16": (lambda t: F.max_pool2d(t, FULL), "nhwc", FULL),
    "reduce_window vert only": (lambda t: F.max_pool2d(t, VERT), "bf16", VERT),
    "reduce_window horiz only": (lambda t: F.max_pool2d(t, HORIZ), "bf16", HORIZ),
    "strided slices": (_strided, "bf16", FULL),
    "reshape minor max": (_reshape_minor, "bf16", FULL),
    "vert rw + strided horiz": (_vert_then_strided, "bf16", FULL),
}


def timed_loop(fn, device: torch.device) -> float:
    """ms a call: LO and HI back-to-back calls, differenced, the smallest
    of REPS (CUDA events on the card, the host clock on the CPU)."""
    cuda = device.type == "cuda"

    def run(n: int) -> float:
        if cuda:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(n):
                fn()
            b.record()
            b.synchronize()
            return a.elapsed_time(b)
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        return (time.perf_counter() - t0) * 1e3

    run(2)  # warm-up
    return min((run(HI) - run(LO)) / (HI - LO) for _ in range(REPS))


def pool_table(shape, device: torch.device) -> tuple[dict, list[str]]:
    """label -> ms of each formulation at ``shape``; and the labels whose
    result differs from F.max_pool2d."""
    gen = torch.Generator(device=device).manual_seed(0)
    x = torch.randn(shape, generator=gen, device=device).to(torch.bfloat16)
    inputs = {"bf16": x, "f32": x.float(), "nhwc": x.contiguous(memory_format=torch.channels_last)}
    times, wrong = {}, []
    for label, (fn, form, window) in FORMULATIONS.items():
        t = inputs[form]
        if not torch.equal(fn(t), F.max_pool2d(t, window)):
            wrong.append(label)
        times[label] = timed_loop(lambda fn=fn, t=t: fn(t), device)
    return times, wrong


def fold_table(frame, fastest: str, device: torch.device) -> tuple[list[dict], list[str]]:
    """Rows 1-2 at the main path's shapes: the pooled pair against the
    unpooled pair plus ``fastest`` on its output."""
    from superslam_tpu_torch.ops.cuda.conv import conv_pair, conv_pair_pool, pair_operands

    fn = FORMULATIONS[fastest][0]
    rng = np.random.default_rng(1)
    h, w = frame
    rows, wrong = [], []
    for cin, shape in ((1, (2, 1, h, w)), (64, (2, 64, h // 2, w // 2))):
        x = rng.uniform(0, 1, shape) if cin == 1 else np.maximum(rng.normal(size=shape), 0)
        x = torch.from_numpy(x.astype(np.float32)).to(device)
        if cin == 64:
            x = x.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
        wa, wb = (torch.from_numpy((rng.normal(size=s) * k).astype(np.float32)).to(device)
                  for s, k in (((64, cin, 3, 3), 0.3 if cin == 1 else 0.05),
                               ((64, 64, 3, 3), 0.05)))
        ba, bb = (torch.from_numpy((rng.normal(size=(64,)) * 0.1).astype(np.float32)).to(device)
                  for _ in range(2))
        ops = pair_operands(wa, ba, wb, bb) if device.type == "cuda" else None
        args = (x, wa, ba, wb, bb)
        pooled = conv_pair_pool(*args, operands=ops)
        full = conv_pair(*args, operands=ops)
        if not torch.equal(pooled, fn(full)):
            wrong.append(f"CIN {cin}")
        row = {
            "cin": cin, "shape": shape,
            "pooled_ms": timed_loop(lambda: conv_pair_pool(*args, operands=ops), device),
            "unpooled_ms": timed_loop(lambda: conv_pair(*args, operands=ops), device),
            "pool_ms": timed_loop(lambda: fn(full), device),
        }
        row["saved_ms"] = row["unpooled_ms"] + row["pool_ms"] - row["pooled_ms"]
        rows.append(row)
    return rows, wrong


def card_line() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "not readable"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--shape", type=int, nargs=4, default=list(SHAPE))
    ap.add_argument("--frame", type=int, nargs=2, default=list(FRAME))
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("profile_pool_torch: no CUDA device (pass --device cpu to rehearse)")
        clock = "device ms (CUDA events)"
        print(f"card: {card_line()}; {torch.cuda.get_device_name(device)}")
    else:
        clock = "host ms (CPU run: says nothing about the card)"
    times, wrong = pool_table(tuple(args.shape), device)
    print(f"2x2 max pool at {tuple(args.shape)} bf16, {clock}, ({HI} - {LO} calls) / "
          f"{HI - LO}, smallest of {REPS}:")
    for label, ms in times.items():
        flag = "" if label not in wrong else "  DIFFERS from F.max_pool2d"
        print(f"  {label:28s} {ms:9.4f} ms{flag}")
    fastest = min((k for k, v in FORMULATIONS.items() if v[2] == FULL), key=times.get)
    rows, fold_wrong = fold_table(tuple(args.frame), fastest, device)
    print(f"the pool folded into the conv pairs (rows 1-2), {clock}; the unfolded pool is "
          f"'{fastest}':")
    for r in rows:
        print(f"  CIN {r['cin']:2d} at {r['shape']}: pooled {r['pooled_ms']:.4f} ms; unpooled "
              f"{r['unpooled_ms']:.4f} + pool {r['pool_ms']:.4f} = "
              f"{r['unpooled_ms'] + r['pool_ms']:.4f} ms; folding saves {r['saved_ms']:.4f} ms"
              + ("  POOLED OUTPUT DIFFERS" if f"CIN {r['cin']}" in fold_wrong else ""))
    if wrong or fold_wrong:
        print(f"profile_pool_torch: results differ: {wrong + fold_wrong}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

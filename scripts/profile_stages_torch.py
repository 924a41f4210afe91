#!/usr/bin/env python
"""Stage-level device-time decomposition of the SuperPoint/LightGlue frame
program of the PyTorch/CUDA port (``superslam_tpu_torch``) on the card.

Counterpart of ``scripts/profile_stages.py``, with the same stage names on
the port's functions at the KITTI shape (2 x 384 x 1248, 600 keypoints).
Every stage is timed with CUDA events around one call, median of 20 after
3 warm-ups, under ``torch.no_grad()``. (The JAX script differences two scan
lengths to cancel its host relay; events on the card's own stream need no
such trick.)

Stages:
  dense_pallas    superpoint_dense on the kernel route (conv pairs, the
                  score half in the NMS kernel's logits mode), on
                  prepare_superpoint_params' operands as the pipeline
  dense_xla       the same function with cuDNN convs everywhere and
                  PyTorch's softmax, depth-to-space and the plain NMS,
                  composed here from the kernels' plain versions
                  and the port's tail: a yardstick, not a path of the port
  conv1a1b        conv1a+conv1b, no pool      (kernel conv_pair, CIN 1)
  conv2           conv2a alone                (kernel conv3x3, operands prepared once)
  conv_pair       conv2a+conv2b, no pool      (kernel conv_pair, CIN 64)
  conv_pair_pool  conv2a+conv2b+pool          (kernel conv_pair_pool)
  conv1a1b_pool   conv1a+conv1b+pool          (kernel conv_pair_pool, CIN 1)
  xla_tail        conv3a..heads from the quarter-resolution map (cuDNN)
  conv3           conv3a+conv3b (cuDNN)
  score_post      softmax + depth-to-space + NMS in one launch (the NMS
                  kernel's logits mode) + descriptor norm, from
                  channels_last logits as the frame's head gives them
  select          select_keypoints (top-K, gather, borders)
  lightglue       lightglue_forward, 2 pair problems, the default route
  lg_self         one unfused self block       lg_cross  one unfused cross block
  lg_attn         one masked_attention call    lg_ffn    one FFN
  lg_assign       the log-assignment head

Usage: python scripts/profile_stages_torch.py [--device cuda|cpu] [stage ...]
  (default: all stages, on the card; on the CPU the times are host times
  of the plain versions and say nothing about the card)
"""

from __future__ import annotations

import argparse
import os
import statistics
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

WIDTH, HEIGHT = 1241, 376
PW, PH = 1248, 384  # padded to the frontends' quantum (H % 32, W % 8)
MAX_KP = 600

STAGES = (
    "dense_pallas", "dense_xla", "conv1a1b", "conv2", "conv_pair", "conv_pair_pool",
    "conv1a1b_pool", "xla_tail", "conv3", "score_post", "select", "lightglue",
    "lg_self", "lg_cross", "lg_attn", "lg_ffn", "lg_assign",
)


def time_ms(fn, device, warmup: int = 3, iters: int = 20) -> float:
    """Median time of one call: CUDA events on the card, the host clock on
    the CPU."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        if device.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def run_stages(
    names=None,
    device="cuda",
    height: int = PH,
    width: int = PW,
    max_kp: int = MAX_KP,
    warmup: int = 3,
    iters: int = 20,
) -> dict[str, float]:
    """Time the named stages (all when ``names`` is empty) at a padded
    (2, height, width) stereo pair and ``max_kp`` keypoints; returns
    {stage: ms}. height and width are multiples of 32 and 8."""
    import torch
    import torch.nn.functional as F

    from superslam_tpu_torch.models import lightglue as lgm
    from superslam_tpu_torch.models import superpoint as spm
    from superslam_tpu_torch.ops.cuda.attention import masked_attention
    from superslam_tpu_torch.ops.cuda.conv import (
        conv3x3,
        conv3x3_operands,
        conv_pair,
        conv_pair_pool,
        conv_pair_pool_plain,
    )
    from superslam_tpu_torch.ops.cuda.nms import nms_plain
    from superslam_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    want = list(names) if names else list(STAGES)
    unknown = sorted(set(want) - set(STAGES))
    if unknown:
        raise ValueError(f"unknown stages {unknown}; known: {', '.join(STAGES)}")
    if height % 32 or width % 8:
        raise ValueError(f"shape {height}x{width}: height % 32 and width % 8 must be 0")

    bf16 = torch.bfloat16
    rng = np.random.default_rng(0)

    def dev(a, dtype=None):
        return torch.from_numpy(a).to(device=device, dtype=dtype)

    def normal(*shape, dtype=None):
        return dev(rng.standard_normal(shape).astype(np.float32), dtype)

    img = dev(rng.uniform(0, 1, (2, height, width)).astype(np.float32))
    sp = spm.init_superpoint_params(0, device=device)
    sp_ready = spm.prepare_superpoint_params(sp, device)  # + the conv pairs' operands
    lg = lgm.init_lightglue_params(0, device=device)
    lg_cast = lgm.cast_compute_params(lg)  # the unfused route's weights
    lg_ready = lgm.prepare_params(lg, device)  # + the fused blocks' operands

    # conv2a's kernel operands, laid out once as a caller of conv3x3 would.
    conv2a_ops = conv3x3_operands(sp["conv2a.weight"], sp["conv2a.bias"])

    def pair(name):
        return [sp[f"{name}{ab}.{kind}"] for ab in "ab" for kind in ("weight", "bias")]

    half = torch.zeros((2, 64, height // 2, width // 2), dtype=bf16, device=device)
    half = half.contiguous(memory_format=torch.channels_last)
    quarter = torch.zeros((2, 64, height // 4, width // 4), dtype=bf16, device=device)
    quarter = quarter.contiguous(memory_format=torch.channels_last)
    logits = normal(2, 65, height // 8, width // 8).contiguous(memory_format=torch.channels_last)
    desc_raw = normal(2, 256, height // 8, width // 8, dtype=bf16)
    scores = normal(2, height, width).abs()
    grid = normal(2, height // 8, width // 8, 256, dtype=bf16)
    kpts = dev(rng.uniform(0, 300, (4, max_kp, 2)).astype(np.float32))
    desc = normal(4, max_kp, 256)
    valid = torch.ones((4, max_kp), dtype=torch.bool, device=device)
    xtok = normal(4, max_kp, 256, dtype=bf16)
    enc = lgm._rotary_encoding(
        dev(rng.uniform(-1, 1, (4, max_kp, 2)).astype(np.float32)), lg_cast, bf16
    )
    qkv4 = normal(4, 4, max_kp, 64, dtype=bf16)

    def dense_xla():
        x = conv_pair_pool_plain(img[:, None], *pair("conv1"))
        x = conv_pair_pool_plain(x, *pair("conv2"))
        head_logits, head_desc = spm._tail(sp, x, bf16)
        return spm._scores_and_descriptors(head_logits, head_desc, 4, bf16, False, nms=nms_plain)

    def conv3_only():
        x = F.relu(spm._conv(quarter, sp, "conv3a", bf16))
        return F.relu(spm._conv(x, sp, "conv3b", bf16))

    self_prefix, cross_prefix = "transformers.0.self_attn", "transformers.0.cross_attn"
    stages = {
        "dense_pallas": lambda: spm.superpoint_dense(sp_ready, img),
        "dense_xla": dense_xla,
        "conv1a1b": lambda: conv_pair(img[:, None], *pair("conv1")),
        "conv2": lambda: conv3x3(
            half, sp["conv2a.weight"], sp["conv2a.bias"], operands=conv2a_ops
        ),
        "conv_pair": lambda: conv_pair(half, *pair("conv2")),
        "conv_pair_pool": lambda: conv_pair_pool(half, *pair("conv2")),
        "conv1a1b_pool": lambda: conv_pair_pool(img[:, None], *pair("conv1")),
        "xla_tail": lambda: spm._tail(sp, quarter, bf16),
        "conv3": conv3_only,
        "score_post": lambda: spm._scores_and_descriptors(logits, desc_raw, 4, bf16, False),
        "select": lambda: spm.select_keypoints(
            scores, grid, max_kp, true_width=width - 7, true_height=height - 8
        ),
        "lightglue": lambda: lgm.lightglue_forward(
            lg_ready, kpts[0::2], desc[0::2], kpts[1::2], desc[1::2], valid[0::2], valid[1::2]
        ),
        "lg_self": lambda: lgm._self_block(xtok, enc, valid, lg_cast, self_prefix, bf16),
        "lg_cross": lambda: lgm._cross_block_paired(xtok, valid, lg_cast, cross_prefix, bf16),
        "lg_attn": lambda: masked_attention(qkv4, qkv4, qkv4, valid),
        "lg_ffn": lambda: lgm._ffn(xtok, xtok, lg_cast, f"{self_prefix}.ffn", bf16),
        "lg_assign": lambda: lgm._log_assignment(
            xtok[0::2], xtok[1::2], valid[0::2], valid[1::2], lg_cast, "log_assignment.8"
        ),
    }
    results = {}
    with torch.no_grad():
        for name in STAGES:
            if name in want:
                results[name] = time_ms(stages[name], device, warmup, iters)
    return results


def card_line() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "not readable"


def main(argv: list[str] | None = None) -> dict[str, float]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("stages", nargs="*", help=f"any of: {', '.join(STAGES)} (default: all)")
    ap.add_argument("--device", default="cuda", help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    results = run_stages(args.stages, args.device)
    if args.device.startswith("cuda"):
        print(f"card: {card_line()}")
        unit = "ms (CUDA events, median of 20)"
    else:
        unit = "ms on the host's clock (CPU run: not a device time)"
    print(f"{'stage':16s} {unit}")
    for k, v in results.items():
        print(f"{k:16s} {v:9.4f}")
    return results


if __name__ == "__main__":
    main()

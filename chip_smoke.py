#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``superslam_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

In order, any failure exiting non-zero:

1. prints the card (``nvidia-smi`` name and power limit, and
   ``torch.cuda.get_device_name``);
2. builds the hand-written kernels from the sources in the checkout
   (``superslam_tpu_torch/ops/cuda/_build.py``) and the host estimator's
   C++ core (``csrc/``), prints the build times and the registers, shared
   memory and spills from nvcc's report of the mma.sync conv pair kernel's
   eight instantiations (CIN 1 and 64, pooled or not, bf16 or f32 out),
   conv3x3's four (CIN 1 and 64, bf16 or f32 out), the attention
   backward's four (dq and dk/dv kernels, f32 and bf16), the attention
   forward's four (bf16 and f32, in masked_attention.cu and
   lightglue_layer.cu), the fused blocks' two bf16 linears (projection
   and tail) and the NMS kernel's two modes (map and logits); any spill
   fails;
3. launches each kernel at the shapes of the main path and holds it against
   its plain PyTorch version on the card (bf16 conv pairs: max error over
   max |plain| <= 2e-2 after the pool; NMS: exact; NMS from SuperPoint's
   logits (random logits with peaks and the checkpoint's on a rendered
   frame): the pre-NMS map within 1e-6 abs of the plain softmax's, the
   NMS'd map exactly ``nms_plain`` of the kernel's own pre-NMS map, the
   same without the pre-NMS map, and the peaks that differ from the plain
   composition printed; bf16 attention: atol
   2e-2, plus the fully-masked row against the mean of v; the fused
   LightGlue self and cross blocks: max error over max |plain| <= 2e-2 in
   bf16 and atol 1e-3 in f32; the descriptor gather: atol 1e-5; the
   unpooled conv pairs and the single conv: 2e-2 of max |plain|; the conv
   pairs and the single conv on operands prepared once give the same bits
   as on OIHW weights; the forward's row statistics against the plain
   softmax's; at the training shape (16, 4, 256, 64) f32 with ragged masks
   and one fully-masked batch row, the forward within 1e-4 of max |plain|
   (the same bits with and without its row statistics; recorded as
   ``masked_attention_f32``) and the attention backward on the forward's
   residuals: dq, dk, dv within 1e-4 of max |plain|, dq = dk = 0
   in that row, autograd's gradients bit-equal), timing kernel (the convs
   on prepared operands, the backward on the forward's residuals), plain
   version and, where one exists, a library call as a yardstick (CUDA
   events, median of 20 after 3 warm-ups; for row 4 also the library's
   forward at the training shape);
4. runs the port's ``SuperSLAM`` facade on 30 rendered frames at the KITTI
   00 geometry (1241x376, padded to 1248x384; 600 keypoints; the committed
   render-trained SuperPoint and synthetic LightGlue weights) on the
   default, fused LightGlue route, checks the poses are finite, the ATE
   against ground truth is <= 0.5 m and the kernels ran exactly
   1/1/1/9/9 times per frame (conv1a1b, conv_pair, scores_nms,
   fused_self_block, fused_cross_block; nms and masked_attention 0), and
   prints the fused step's median ms and the fps; then tracks 5 more
   frames under torch.profiler, prints the device busy time per frame and
   the kernels by device time, and fails if a softmax kernel ran (the
   score half is the NMS kernel's logits mode);
5. runs the first 10 frames again on the unfused route
   (``SUPERSLAM_PALLAS_LG=0``): exactly 1/1/1/18 launches per frame
   (masked_attention 18, the fused blocks 0), ATE <= 0.5 m, and prints the
   largest per-frame position gap between the two routes;
6. extracts one rendered stereo pair with
   ``SuperPointExtractor(use_kernel=True)``: descriptors within 1e-5 of
   the default route's, and the gather_normalize kernel launched; then
   runs the map-mode entry point ``nms_suppress`` on that pair's pre-NMS
   map from ``superpoint_dense``: the logits mode's NMS'd map bit for bit;
7. trains the matcher at full width (9 layers, 256 wide, 4 heads, f32,
   batch 8 pairs, cap 256): the gradient of ``matching_loss`` through the
   kernels against the plain versions (every parameter within 1e-3 of that
   tensor's largest plain gradient); ``train_step`` on one fixed synthetic
   batch at lr 3e-4 for FIXED_BATCH_STEPS steps, the last loss below 0.7 x
   the first, with exactly 18 masked_attention and 18
   masked_attention_bwd launches per step and no fused block; then
   ``scripts/train_lightglue_synth_torch.py`` in-process on 24 harvested
   pairs for 20 steps (finite losses, precision and recall printed, the
   checkpoint written and loaded back); and one step under torch.profiler
   for the forward / backward / optimizer split;
8. runs every stage of ``scripts/profile_stages_torch.py`` and checks that
   conv1a1b_full, conv_pair_full and conv3x3 were launched there;
9. profiles, after every timed phase (a profiler session slows the
   launches that follow it on the host), the score half on one frame's
   logits, the logits mode beside the composition it replaces (PyTorch's
   softmax and depth-to-space, then the map mode), and 10 extractions with
   ``use_kernel=True`` for the gather kernel's device time;
10. prints one ``{"kernels": [...]}`` line (each kernel's launches are
    those of the phase that drives it: 4, 5, 6, 7 or 8; row 4 twice, bf16
    from phase 5 and f32 from phase 7's fixed-batch steps; ``nms``, the
    map mode, from phase 6: the main path runs the logits mode), then, as
    the last line, ``{"ok": true, "device": {...}}``.

Without a CUDA device, or without the package beside it, it exits non-zero
and prints no result.
"""

from __future__ import annotations

import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
WIDTH, HEIGHT = 1241, 376
PAD_W, PAD_H = 1248, 384  # the frontends' 32-pixel quantum
WIDTH_CELLS, HEIGHT_CELLS = PAD_W // 8, PAD_H // 8
FX, CX, CY, BF = 718.856, 607.1928, 185.2157, 386.1448  # KITTI 00
TRAIN_FX = 320.0  # focal length of the committed checkpoints' render domain
CIRCUIT_FRAMES = 144  # frames per lap of the bench circuit (bench.py)
N_FRAMES = 30
N_FRAMES_UNFUSED = 10
MAX_KP = 600
KP_THRESHOLD = 0.010
ATE_LIMIT_M = 0.5
# Training phase: the script's defaults (batch 8 pairs, cap 256), the
# reference's functional test (lr 3e-4, last loss < 0.7 x first).
TRAIN_BATCH, TRAIN_CAP, TRAIN_LR = 8, 256, 3e-4
# The first run on the card (30 steps, H100) fell below 0.7 x the start
# after 2 steps and went 6.3808 -> 0.0019; 6 is the reference test's count.
FIXED_BATCH_STEPS = 6
SCRIPT_PAIRS, SCRIPT_STEPS = 24, 20
ATTENTION_PER_STEP = 18  # 9 layers x (self + cross), forward and backward each
# Launches per frame on the default (fused) LightGlue route and on the
# unfused one (SUPERSLAM_PALLAS_LG=0).
PER_FRAME_FUSED = {
    "conv1a1b": 1, "conv_pair": 1, "scores_nms": 1, "nms": 0, "fused_self_block": 9,
    "fused_cross_block": 9, "masked_attention": 0, "gather_normalize": 0,
}
PER_FRAME_UNFUSED = {
    "conv1a1b": 1, "conv_pair": 1, "scores_nms": 1, "nms": 0, "fused_self_block": 0,
    "fused_cross_block": 0, "masked_attention": 18, "gather_normalize": 0,
}

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
TF32_FLOP_PER_S = 495e12
F32_FLOP_PER_S = 67e12

KERNEL_INFO = {
    "conv1a1b": (
        "superslam_tpu_torch/ops/cuda/conv_pair_mma.cu",
        "superslam_tpu/ops/pallas/conv.py:558",
    ),
    "conv_pair": (
        "superslam_tpu_torch/ops/cuda/conv_pair_mma.cu",
        "superslam_tpu/ops/pallas/conv.py:439",
    ),
    "nms": (
        "superslam_tpu_torch/ops/cuda/nms.cu",
        "superslam_tpu/ops/pallas/nms.py:68",
    ),
    "scores_nms": (
        "superslam_tpu_torch/ops/cuda/nms.cu",
        "superslam_tpu/ops/pallas/nms.py:68 + superslam_tpu/models/superpoint.py:236-240",
    ),
    "masked_attention": (
        "superslam_tpu_torch/ops/cuda/masked_attention.cu",
        "superslam_tpu/ops/pallas/attention.py:145",
    ),
    "masked_attention_f32": (
        "superslam_tpu_torch/ops/cuda/masked_attention.cu",
        "superslam_tpu/ops/pallas/attention.py:145",
    ),
    "fused_self_block": (
        "superslam_tpu_torch/ops/cuda/lightglue_layer.cu",
        "superslam_tpu/ops/pallas/lightglue_layer.py:344",
    ),
    "fused_cross_block": (
        "superslam_tpu_torch/ops/cuda/lightglue_layer.cu",
        "superslam_tpu/ops/pallas/lightglue_layer.py:369",
    ),
    "gather_normalize": (
        "superslam_tpu_torch/ops/cuda/gather.cu",
        "superslam_tpu/ops/pallas/gather.py:69",
    ),
    "masked_attention_bwd": (
        "superslam_tpu_torch/ops/cuda/attention_bwd.cu",
        "superslam_tpu/ops/pallas/attention.py:103",
    ),
    "conv_pair_full": (
        "superslam_tpu_torch/ops/cuda/conv_pair_mma.cu",
        "superslam_tpu/ops/pallas/conv.py:461",
    ),
    "conv1a1b_full": (
        "superslam_tpu_torch/ops/cuda/conv_pair_mma.cu",
        "superslam_tpu/ops/pallas/conv.py:580",
    ),
    "conv3x3": (
        "superslam_tpu_torch/ops/cuda/conv3x3_mma.cu",
        "superslam_tpu/ops/pallas/conv.py:640",
    ),
}


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


# nvcc's entry names (mangled) of the kernels whose registers chip_smoke
# reports: substring -> instantiations expected.
# The attention forward's two kernels are instantiated in both
# masked_attention.cu and lightglue_layer.cu.
REPORTED_KERNELS = {
    "conv_pair_mma_kernel": 8,
    "conv3x3_mma_kernel": 2,
    "conv3x3_gray_kernel": 2,
    "attn_bwd_dq_kernel": 2,
    "attn_bwd_dkv_kernel": 2,
    "attn_fwd_bf16_kernel": 2,
    "attn_fwd_f32_kernel": 2,
    "proj_mma_kernel": 1,
    "tail_mma_kernel": 1,
    "nms_tile_kernel": 2,
}


def _smem_bytes(entry: str) -> int:
    """Dynamic shared memory of a reported kernel, from the address models."""
    from superslam_tpu_torch.ops.cuda.attention import bwd_layout, fwd_layout
    from superslam_tpu_torch.ops.cuda.conv import CONV3X3_GRAY_SMEM_BYTES, mma_layout
    from superslam_tpu_torch.ops.cuda.lightglue_layer import gemm_layout
    from superslam_tpu_torch.ops.cuda.nms import tile_layout

    if "nms_tile_kernel" in entry:
        return tile_layout()["SMEM_BYTES"]
    if "attn_fwd_bf16" in entry:
        return fwd_layout("bf16")["smem_bytes"]
    if "attn_fwd_f32" in entry:
        return fwd_layout("f32")["smem_bytes"]
    if "proj_mma_kernel" in entry or "tail_mma_kernel" in entry:
        return gemm_layout("proj" if "proj_mma" in entry else "tail")["smem_bytes"]
    if "conv_pair_mma_kernel" in entry:
        return mma_layout("x", 1 if "conv_pair_mma_kernelILi1E" in entry else 64)["smem_bytes"]
    if "conv3x3_mma_kernel" in entry:
        return mma_layout("x3")["smem_bytes"]
    if "attn_bwd" in entry:
        return bwd_layout()["smem_bytes"]
    return CONV3X3_GRAY_SMEM_BYTES


def report_build(build_dir: str) -> None:
    """Print registers, shared memory and spills of every instantiation of
    the mma.sync kernels (the convs, the attention forward and backward, the
    fused blocks' linears) and of the NMS kernel from nvcc's -Xptxas -v
    report; fail on any spill (they keep their accumulators or their
    cell's channels in registers) or a missing instantiation."""
    with open(os.path.join(build_dir, "nvcc.log")) as f:
        lines = f.read().splitlines()
    found = dict.fromkeys(REPORTED_KERNELS, 0)
    for i, line in enumerate(lines):
        if "Compiling entry function" not in line:
            continue
        entry = line.split("'")[1]
        kind = next((k for k in REPORTED_KERNELS if k in entry), None)
        if kind is None:
            continue
        block = []
        for nxt in lines[i + 1 : i + 8]:
            if "Compiling entry function" in nxt:
                break
            block.append(nxt)
        text = " ".join(block)
        regs = re.search(r"Used (\d+) registers", text)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", text)
        static = re.search(r"(\d+) bytes smem", text)
        if not regs or not spill:
            fail(f"nvcc.log: no resource report after {line.strip()}")
        found[kind] += 1
        print(
            f"build {kind}: {entry}: {regs.group(1)} registers, spill stores "
            f"{spill.group(1)} B, spill loads {spill.group(2)} B, shared memory "
            f"{_smem_bytes(entry)} B dynamic + {static.group(1) if static else 0} B static"
        )
        if int(spill.group(1)) or int(spill.group(2)):
            fail(f"{entry}: spills registers")
    if found != REPORTED_KERNELS:
        fail(f"nvcc.log: instantiations reported {found}, want {REPORTED_KERNELS}")


def time_ms(torch, fn, warmup: int = 3, iters: int = 20) -> float:
    """Median device time of one call (CUDA events around each call)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound(nbytes: float, f32_ops: float = 0.0, bf16_ops: float = 0.0, tf32_ops: float = 0.0):
    """Least time in ms: bytes over HBM rate vs operations over peak rates
    (f32 on the CUDA cores, bf16 and TF32 on the tensor cores)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (
        f32_ops / F32_FLOP_PER_S + bf16_ops / BF16_FLOP_PER_S + tf32_ops / TF32_FLOP_PER_S
    ) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def attention_ops(kv_mask, heads: int = 4, dim: int = 64) -> tuple[float, float]:
    """(product, f32) operations of key-masked attention over (B, K) key
    masks: QK^T and PV over the real keys of each row's key set (a masked
    key's probability is exactly 0; a row with no real key averages all K
    values), priced by the caller at the bf16 rate or, f32-accurate, as
    three TF32 products each (3xTF32); and ~5 f32 operations per logit for
    the softmax."""
    k = kv_mask.shape[1]
    real = kv_mask.sum(dim=1)
    keys = float(real.masked_fill(real == 0, k).sum().item())
    return 4.0 * heads * k * keys * dim, 5.0 * heads * k * keys


def attention_bwd_ops(kv_mask, heads: int = 4, dim: int = 64) -> tuple[float, float]:
    """(TF32, f32) operations of the attention backward over (B, K) key
    masks: five products (s, dp, dv, dq, dk) of 2 K x keys x dim each over
    the real keys of a row's key set, each f32-accurate product three TF32
    ones (3xTF32, the card's fastest f32-accurate product), and ~8 f32
    operations per logit for p and ds. A row with no real key has p uniform
    over all K keys and only the dv product."""
    k = kv_mask.shape[1]
    real = kv_mask.sum(dim=1).double()
    no_keys = (real == 0).double()
    products = 5.0 * 2 * k * real * dim + no_keys * 2.0 * k * k * dim
    logits = 8.0 * k * real + no_keys * 3.0 * k * k
    return 3.0 * heads * float(products.sum().item()), heads * float(logits.sum().item())


def check_row_stats(label: str, got, ref) -> None:
    """The forward kernel's row statistics against the plain softmax's: the
    maximum within 1e-5 of max(|m|, 1), 1 / sum within 1e-5 relative (f32
    sums in another order)."""
    err_m = ((got[0] - ref[0]).abs() / ref[0].abs().clamp_min(1.0)).max().item()
    err_l = ((got[1] - ref[1]).abs() / ref[1].abs()).max().item()
    print(f"kernel masked_attention: {label} row statistics vs plain: maximum {err_m:.3g}, "
          f"1 / sum {err_l:.3g} (limit 1e-5)")
    if not (err_m <= 1e-5 and err_l <= 1e-5):
        fail(f"masked_attention: {label} row statistics error {err_m}, {err_l} > 1e-5")


def padded_pair(torch, left, right):
    """A rendered uint8 stereo pair as the frontends feed SuperPoint: f32 in
    [0, 1], zero-padded to the 32-pixel quantum, (2, 384, 1248) on the card."""
    img = np.zeros((2, PAD_H, PAD_W), np.float32)
    img[:, :HEIGHT, :WIDTH] = np.stack([left, right]).astype(np.float32) / 255.0
    return torch.from_numpy(img).to("cuda")


def frame_logits(torch, sp_params, left, right):
    """SuperPoint's detector logits (2, 65, 48, 156) of one rendered stereo
    pair, through the main path's encoder and heads."""
    from superslam_tpu_torch.models.superpoint import _encoder_and_heads, prepare_superpoint_params

    with torch.no_grad():
        logits, _ = _encoder_and_heads(prepare_superpoint_params(sp_params, "cuda"),
                                       padded_pair(torch, left, right), torch.bfloat16)
    return logits


def check_kernels(torch, sp_params, lg_params, frame) -> dict[str, dict]:
    """Each kernel against its plain version at the main path's shapes;
    ``frame`` is a rendered stereo pair for the NMS kernel's logits mode."""
    import torch.nn.functional as F

    from superslam_tpu_torch.models import lightglue as lg
    from superslam_tpu_torch.ops.cuda import lightglue_layer as lgl
    from superslam_tpu_torch.ops.cuda.attention import (
        attention_row_stats_plain,
        masked_attention,
        masked_attention_backward,
        masked_attention_backward_plain,
        masked_attention_plain,
        masked_attention_with_stats,
    )
    from superslam_tpu_torch.ops.cuda.conv import (
        conv3x3,
        conv3x3_operands,
        conv3x3_plain,
        conv_pair,
        conv_pair_plain,
        conv_pair_pool,
        conv_pair_pool_plain,
        pair_operands,
    )
    from superslam_tpu_torch.ops.cuda.gather import gather_normalize, gather_normalize_plain
    from superslam_tpu_torch.ops.cuda.nms import (
        nms_plain,
        nms_suppress,
        scores_nms,
        scores_nms_plain,
    )

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    bf16 = torch.bfloat16
    out: dict[str, dict] = {}

    def record(name, err, ms, plain_ms, lib_ms, bnd):
        out[name] = {
            "name": name,
            "route": "cuda",
            "source": KERNEL_INFO[name][0],
            "replaces": KERNEL_INFO[name][1],
            "max_abs_err": float(err),
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bnd[0],
            "bound_by": bnd[1],
            "library_ms": lib_ms,
        }
        lib = "none" if lib_ms is None else f"{lib_ms:.4f} ms"
        print(
            f"kernel {name}: max_abs_err {err:.3g}  kernel {ms:.4f} ms  "
            f"plain {plain_ms:.4f} ms  library {lib}  "
            f"bound {bnd[0]:.4f} ms ({bnd[1]})",
            flush=True,
        )

    def conv_case(name, kernel, plain, library, out_shape, bnd_of, prepared=None):
        """One conv kernel against its plain version (2e-2 of max |plain|,
        the kernel rounds its conv_a tile to bf16), timed beside the plain
        version and the cuDNN call; returns the kernel's output. With
        ``prepared`` (the same call on operands prepared once, as the main
        path makes it) that call must give the same bits, and its time is
        the one recorded."""
        got, ref = kernel(), plain()
        torch.cuda.synchronize()
        if got.shape != out_shape or got.dtype != bf16:
            fail(f"{name}: output {tuple(got.shape)} {got.dtype}")
        err = (got.float() - ref.float()).abs().max().item()
        rel = err / max(ref.float().abs().max().item(), 1e-12)
        print(f"kernel {name}: max error / max |plain| = {rel:.3g} (limit 2e-2)")
        if not rel <= 2e-2:
            fail(f"{name}: relative error {rel} > 2e-2")
        timed = kernel
        if prepared is not None:
            if not torch.equal(prepared(), got):
                fail(f"{name}: prepared operands give another result than OIHW weights")
            print(f"kernel {name}: with OIHW weights laid out in the call "
                  f"{time_ms(torch, kernel):.4f} ms")
            timed = prepared
        record(name, err, time_ms(torch, timed), time_ms(torch, plain),
               time_ms(torch, library), bnd_of(got))
        return got

    x = None
    for name, cin, h, w in (("conv1a1b", 1, 384, 1248), ("conv_pair", 64, 192, 624)):
        pre = ("conv1a", "conv1b") if cin == 1 else ("conv2a", "conv2b")
        wa, ba = sp_params[f"{pre[0]}.weight"], sp_params[f"{pre[0]}.bias"]
        wb, bb = sp_params[f"{pre[1]}.weight"], sp_params[f"{pre[1]}.bias"]
        ops = pair_operands(wa, ba, wb, bb)
        if cin == 1:
            x = torch.from_numpy(rng.uniform(0, 1, (2, 1, h, w)).astype(np.float32)).to(dev)
        xl = x.to(bf16).contiguous(memory_format=torch.channels_last)
        wal, bal, wbl, bbl = (t.to(bf16) for t in (wa, ba, wb, bb))
        px = 2 * h * w

        def pair_bound(out):
            return bound(
                nbytes(x, wa, ba, wb, bb, out),
                f32_ops=2 * px * 64 * 9 if cin == 1 else 0,
                bf16_ops=2 * px * 64 * 64 * 9 * (1 if cin == 1 else 2),
            )

        def library_pair():
            y = F.relu(F.conv2d(xl, wal, bal, padding=1))
            return F.relu(F.conv2d(y, wbl, bbl, padding=1))

        pooled = conv_case(
            name, lambda: conv_pair_pool(x, wa, ba, wb, bb),
            lambda: conv_pair_pool_plain(x, wa, ba, wb, bb),
            lambda: F.max_pool2d(library_pair(), 2), (2, 64, h // 2, w // 2), pair_bound,
            prepared=lambda: conv_pair_pool(x, wa, ba, wb, bb, operands=ops),
        )
        # The same pair without the pool, and (at conv2a) one conv alone, on
        # the same input: what the stage profiler times.
        conv_case(
            name + "_full", lambda: conv_pair(x, wa, ba, wb, bb),
            lambda: conv_pair_plain(x, wa, ba, wb, bb), library_pair, (2, 64, h, w), pair_bound,
            prepared=lambda: conv_pair(x, wa, ba, wb, bb, operands=ops),
        )
        if cin == 64:
            c3ops = conv3x3_operands(wa, ba)
            conv_case(
                "conv3x3", lambda: conv3x3(x, wa, ba), lambda: conv3x3_plain(x, wa, ba),
                lambda: F.relu(F.conv2d(xl, wal, bal, padding=1)), (2, 64, h, w),
                lambda out: bound(nbytes(x, wa, ba, out), bf16_ops=2 * px * 64 * 64 * 9),
                prepared=lambda: conv3x3(x, wa, ba, operands=c3ops),
            )
        x = pooled  # the next pair's input, as on the main path

    # NMS on a (2, 384, 1248) score map with ties and exact zeros.
    s = rng.uniform(0, 1, (2, 384, 1248)) ** 6
    s = torch.from_numpy((np.round(s * 4096) / 4096).astype(np.float32)).to(dev)
    got, ref = nms_suppress(s, 4), nms_plain(s, 4)
    torch.cuda.synchronize()
    if not torch.equal(got, ref):
        fail(f"nms: {(got != ref).sum().item()} elements differ from the plain version")
    ms = time_ms(torch, lambda: nms_suppress(s, 4))
    plain_ms = time_ms(torch, lambda: nms_plain(s, 4))

    def library_nms():
        p = F.max_pool2d(s[:, None], 9, 1, 4)[:, 0]
        return torch.where(s == p, s, 0.0)

    lib_ms = time_ms(torch, library_nms)
    record("nms", 0.0, ms, plain_ms, lib_ms, bound(2 * nbytes(s), f32_ops=s.numel() * 17))

    # NMS from SuperPoint's logits at the serving shape (2, 65, 48, 156),
    # channels_last as the head's convs give them: random logits with peaks,
    # and the checkpoint's own on a rendered frame (the timed input).
    x = rng.standard_normal((2, 65, HEIGHT_CELLS, WIDTH_CELLS)) * 4
    random_logits = torch.from_numpy(x.astype(np.float32)).to(dev)
    random_logits = random_logits.contiguous(memory_format=torch.channels_last)
    logits = frame_logits(torch, sp_params, *frame)
    print(f"kernel scores_nms: the main path's logits {tuple(logits.shape)} {logits.dtype} "
          f"arrive channels_last: {logits.is_contiguous(memory_format=torch.channels_last)}")
    worst = 0.0
    for label, lg_in in (("random logits with peaks", random_logits),
                         ("the checkpoint's logits on a rendered frame", logits)):
        out_k, pre_k = scores_nms(lg_in, 4, return_pre=True)
        out_only, none = scores_nms(lg_in, 4)
        ref_out, ref_pre = scores_nms_plain(lg_in, 4, return_pre=True)
        torch.cuda.synchronize()
        if out_k.shape != ref_out.shape or not torch.isfinite(pre_k).all().item():
            fail(f"scores_nms: {label}: output {tuple(out_k.shape)} not finite")
        err = (pre_k - ref_pre).abs().max().item()
        if not err <= 1e-6:
            fail(f"scores_nms: {label}: pre-NMS map max abs error {err} > 1e-6")
        n_bad = (out_k != nms_plain(pre_k, 4)).sum().item()
        if n_bad:
            fail(f"scores_nms: {label}: {n_bad} pixels differ from nms_plain of its pre-NMS map")
        if none is not None or not torch.equal(out_only, out_k):
            fail(f"scores_nms: {label}: return_pre=False gives another NMS'd map")
        peaks = (out_k > 0).sum().item()
        differ = ((out_k > 0) != (ref_out > 0)).sum().item()
        print(f"kernel scores_nms ({label}): pre-NMS map max abs error {err:.3g} (limit 1e-6), "
              f"NMS'd map == nms_plain(pre-NMS map) bit for bit, {peaks} peaks, {differ} "
              "differ from the plain composition's (not gated)")
        worst = max(worst, err)
    ms = time_ms(torch, lambda: scores_nms(logits, 4, return_pre=True))
    print(f"kernel scores_nms: without the pre-NMS map "
          f"{time_ms(torch, lambda: scores_nms(logits, 4)):.4f} ms")
    plain_ms = time_ms(torch, lambda: scores_nms_plain(logits, 4, return_pre=True))

    def library_scores():
        # A composition, not one call: softmax, pixel_shuffle (the same
        # depth-to-space) and a max_pool2d compare.
        p = F.pixel_shuffle(torch.softmax(logits, dim=1)[:, :-1], 8)
        return torch.where(p == F.max_pool2d(p, 9, 1, 4), p, 0.0)

    lib_ms = time_ms(torch, library_scores)
    record(
        "scores_nms", worst, ms, plain_ms, lib_ms,
        bound(nbytes(logits, out_k, pre_k),
              f32_ops=4.0 * logits.numel() + 19.0 * out_k.numel()),
    )

    # Attention at LightGlue's (2 pair problems x 2 sides, 4 heads, K=600).
    shape = (4, 4, 600, 64)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev, bf16)
               for _ in range(3))
    mask = torch.from_numpy(rng.uniform(size=(4, 600)) < 0.7).to(dev)
    mask[1] = False  # the keyframe side before the first keyframe
    got, ref = masked_attention(q, k, v, mask), masked_attention_plain(q, k, v, mask)
    torch.cuda.synchronize()
    err = (got.float() - ref.float()).abs().max().item()
    if not err <= 2e-2:
        fail(f"masked_attention: max abs error {err} > 2e-2")
    mean_v = v[1].float().mean(dim=1, keepdim=True).expand(-1, 600, -1)
    err_masked = (got[1].float() - mean_v).abs().max().item()
    print(f"kernel masked_attention: fully-masked row vs mean of v: {err_masked:.3g}")
    if not err_masked <= 2e-2:
        fail(f"masked_attention: fully-masked row error {err_masked} > 2e-2")
    # The row statistics (the backward's residuals) change no bit of the output.
    got_s, stats_s = masked_attention_with_stats(q, k, v, mask)
    if not torch.equal(got_s, got):
        fail("masked_attention: the output differs when the row statistics are written")
    check_row_stats("bf16", stats_s, attention_row_stats_plain(q, k, mask))
    ms = time_ms(torch, lambda: masked_attention(q, k, v, mask))
    plain_ms = time_ms(torch, lambda: masked_attention_plain(q, k, v, mask))
    sdpa_mask = mask[:, None, None, :]
    lib_ms = time_ms(
        torch, lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=sdpa_mask)
    )
    a_bf16, a_f32 = attention_ops(mask)
    record(
        "masked_attention", err, ms, plain_ms, lib_ms,
        bound(nbytes(q, k, v, mask, got), bf16_ops=a_bf16, f32_ops=a_f32),
    )

    # Attention forward (f32) and backward at the training shape: 8 pairs x
    # 2 sides, 4 heads, cap 256, ragged masks as harvested pairs have them,
    # one fully-masked batch row.
    tshape = (2 * TRAIN_BATCH, 4, TRAIN_CAP, 64)
    tq, tk, tv, tg = (
        torch.from_numpy(rng.standard_normal(tshape).astype(np.float32)).to(dev)
        for _ in range(4)
    )
    n_real = rng.integers(TRAIN_CAP // 2, TRAIN_CAP + 1, size=2 * TRAIN_BATCH)
    tmask = torch.from_numpy(np.arange(TRAIN_CAP)[None] < n_real[:, None]).to(dev)
    tmask[3] = False
    # The residuals from the forward (f32, as training runs it), and the
    # forward itself against its plain version: within 1e-4 of max |plain|
    # (3xTF32; one TF32 product would miss it), the same bits without the
    # row statistics, the fully-masked row the mean of v.
    tout, tstats = masked_attention_with_stats(tq, tk, tv, tmask)
    check_row_stats("f32", tstats, attention_row_stats_plain(tq, tk, tmask))
    tref = masked_attention_plain(tq, tk, tv, tmask)
    torch.cuda.synchronize()
    if tout.shape != tshape or not torch.isfinite(tout).all().item():
        fail(f"masked_attention (f32): output {tuple(tout.shape)} not finite")
    f32_err = (tout - tref).abs().max().item()
    f32_rel = f32_err / max(tref.abs().max().item(), 1e-12)
    print(f"kernel masked_attention (f32, {tshape}): max error / max |plain| = {f32_rel:.3g} "
          "(limit 1e-4)")
    if not f32_rel <= 1e-4:
        fail(f"masked_attention (f32): relative error {f32_rel} > 1e-4")
    with torch.no_grad():
        if not torch.equal(masked_attention(tq, tk, tv, tmask), tout):
            fail("masked_attention (f32): the output differs when the row statistics are written")
    got3 = masked_attention_backward(tq, tk, tv, tmask, tg, tout, tstats)
    ref3 = masked_attention_backward_plain(tq, tk, tv, tmask, tg)
    torch.cuda.synchronize()
    worst = 0.0
    for label, a, b in zip(("dq", "dk", "dv"), got3, ref3):
        if a.shape != tshape or a.dtype != torch.float32 or not torch.isfinite(a).all().item():
            fail(f"masked_attention_bwd: {label} {tuple(a.shape)} {a.dtype}")
        e = (a - b).abs().max().item()
        rel = e / max(b.abs().max().item(), 1e-12)
        print(f"kernel masked_attention_bwd: {label} max error / max |plain| = {rel:.3g} (limit 1e-4)")
        if not rel <= 1e-4:
            fail(f"masked_attention_bwd: {label} relative error {rel} > 1e-4")
        worst = max(worst, e)
    if got3[0][3].abs().max().item() != 0 or got3[1][3].abs().max().item() != 0:
        fail("masked_attention_bwd: dq, dk of the fully-masked batch row are not zero")
    # The Function: a result on the card carries a grad_fn and its gradient
    # is the backward kernel's.
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    out_t = masked_attention(*leaves, tmask)
    if out_t.grad_fn is None:
        fail("masked_attention: no grad_fn on a CUDA tensor that requires grad")
    out_t.backward(tg)
    if not all(torch.equal(leaf.grad, g3) for leaf, g3 in zip(leaves, got3)):
        fail("masked_attention: autograd's gradients differ from masked_attention_backward's")
    ms = time_ms(torch, lambda: masked_attention_backward(tq, tk, tv, tmask, tg, tout, tstats))
    plain_ms = time_ms(torch, lambda: masked_attention_backward_plain(tq, tk, tv, tmask, tg))
    sdpa_tmask = tmask[:, None, None, :].clone()
    sdpa_tmask[3] = True  # the library has no replaced-logit row; any mask times the same

    def library_bwd():
        for t in leaves:
            t.grad = None
        F.scaled_dot_product_attention(*leaves, attn_mask=sdpa_tmask).backward(tg)

    # Autograd through the library's attention: forward + backward, less the
    # forward alone.
    lib_ms = time_ms(torch, library_bwd)
    with torch.no_grad():
        lib_ms -= time_ms(
            torch, lambda: F.scaled_dot_product_attention(tq, tk, tv, attn_mask=sdpa_tmask)
        )
    tf32_ops, f32_ops = attention_bwd_ops(tmask)
    record(
        "masked_attention_bwd", worst, ms, plain_ms, lib_ms,
        bound(nbytes(tq, tk, tv, tg, tmask, tout, tstats, *got3),
              f32_ops=f32_ops, tf32_ops=tf32_ops),
    )
    with torch.no_grad():
        f32_fwd_ms = time_ms(torch, lambda: masked_attention(tq, tk, tv, tmask))
        f32_stats_ms = time_ms(torch, lambda: masked_attention_with_stats(tq, tk, tv, tmask))
        f32_plain_ms = time_ms(torch, lambda: masked_attention_plain(tq, tk, tv, tmask))
        f32_lib_ms = time_ms(
            torch, lambda: F.scaled_dot_product_attention(tq, tk, tv, attn_mask=sdpa_tmask)
        )
    print(f"kernel masked_attention_f32: with the row statistics {f32_stats_ms:.4f} ms")
    # Row 4 in f32: both products f32-accurate as 3xTF32 on the tensor cores,
    # over each row's real keys, and the softmax's per-logit f32 work.
    a_ops, a_f32 = attention_ops(tmask)
    record(
        "masked_attention_f32", f32_err, f32_fwd_ms, f32_plain_ms, f32_lib_ms,
        bound(nbytes(tq, tk, tv, tmask, tout, tstats), f32_ops=a_f32, tf32_ops=3.0 * a_ops),
    )
    del got3, ref3, leaves, out_t

    # The forward's library time is taken twice, before and after the
    # backward check, and the smaller kept: a first reading at a new shape
    # can include the library's own choice of kernel.
    lib_again = time_ms(
        torch, lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=sdpa_mask)
    )
    print(
        f"kernel masked_attention: library time re-taken {lib_again:.4f} ms "
        f"(first reading {out['masked_attention']['library_ms']:.4f} ms; the smaller is kept)"
    )
    out["masked_attention"]["library_ms"] = min(out["masked_attention"]["library_ms"], lib_again)

    # The fused LightGlue blocks at (2 pair problems x 2 sides, K=600, 256)
    # with the committed checkpoint's layer 0, ragged masks and the
    # keyframe side before the first keyframe fully masked.
    x32 = torch.from_numpy(rng.standard_normal((4, 600, 256)).astype(np.float32)).to(dev)
    xb = x32.to(bf16)
    kpts = torch.from_numpy(rng.uniform(-1, 1, (4, 600, 2)).astype(np.float32)).to(dev)
    proj = kpts @ lg_params["posenc.Wr.weight"].float().t()
    cos, sin = torch.cos(proj), torch.sin(proj)
    cast = lg.cast_compute_params(lg_params)  # the unfused route's weights
    m_rows = 4 * 600
    tail_ops = 2.0 * m_rows * (256 * 256 + 512 * 512 + 512 * 256)  # 2 per multiply-add
    swapped = mask.reshape(2, 2, 600).flip(1).reshape(4, 600)  # the cross block's key sets
    for name in ("fused_self_block", "fused_cross_block"):
        is_self = name == "fused_self_block"
        prefix = "transformers.0." + ("self_attn" if is_self else "cross_attn")
        prep = lgl.prep_self_weights if is_self else lgl.prep_cross_weights
        rotary = (cos, sin) if is_self else ()

        def call(fn, dtype):
            xd, w = x32.to(dtype), prep(lg_params, prefix, dtype)
            return lambda: fn(xd, *rotary, mask, w)

        got32 = call(getattr(lgl, name), torch.float32)()
        ref32 = call(getattr(lgl, name + "_plain"), torch.float32)()
        torch.cuda.synchronize()
        err32 = (got32 - ref32).abs().max().item()
        print(f"kernel {name}: f32 max abs error {err32:.3g} (limit 1e-3)")
        if not (torch.isfinite(got32).all().item() and err32 <= 1e-3):
            fail(f"{name}: f32 max abs error {err32} > 1e-3")
        kernel_fn, plain_fn = call(getattr(lgl, name), bf16), call(getattr(lgl, name + "_plain"), bf16)
        got, ref = kernel_fn(), plain_fn()
        torch.cuda.synchronize()
        if got.shape != (4, 600, 256) or got.dtype != bf16:
            fail(f"{name}: output {tuple(got.shape)} {got.dtype}")
        err = (got.float() - ref.float()).abs().max().item()
        rel = err / max(ref.float().abs().max().item(), 1e-12)
        print(f"kernel {name}: max error / max |plain| = {rel:.3g} (limit 2e-2)")
        if not (torch.isfinite(got.float()).all().item() and rel <= 2e-2):
            fail(f"{name}: relative error {rel} > 2e-2")
        ms = time_ms(torch, kernel_fn)
        plain_ms = time_ms(torch, plain_fn)
        # No single PyTorch call computes a block. For scale: the unfused
        # route's block at the same shapes (PyTorch linears, LayerNorm and
        # GELU around the masked_attention kernel).
        if is_self:
            enc = lg._rotary_encoding(kpts, cast, bf16)
            unfused_ms = time_ms(torch, lambda: lg._self_block(xb, enc, mask, cast, prefix, bf16))
        else:
            unfused_ms = time_ms(torch, lambda: lg._cross_block_paired(xb, mask, cast, prefix, bf16))
        print(f"kernel {name}: the unfused route's block at the same shapes {unfused_ms:.4f} ms")
        proj_ops = 2.0 * m_rows * 256 * (768 if is_self else 512)
        a_bf16, a_f32 = attention_ops(mask if is_self else swapped)
        io = nbytes(xb, *rotary, mask, got, *prep(lg_params, prefix, bf16))
        record(
            name, err, ms, plain_ms, None,
            bound(io, bf16_ops=proj_ops + tail_ops + a_bf16, f32_ops=a_f32 + 30.0 * m_rows * 512),
        )

    # The descriptor gather at the main path's grid (48 x 156 cells of a
    # 1248 x 384 frame, 256 channels, bf16) and keypoint count.
    grid = torch.from_numpy(rng.standard_normal((2, 48 * 156, 256)).astype(np.float32))
    grid = F.normalize(grid.to(dev), dim=-1).to(bf16)
    cells = torch.from_numpy(rng.integers(0, 48 * 156, size=(2, 600))).to(dev)
    got, ref = gather_normalize(grid, cells), gather_normalize_plain(grid, cells)
    torch.cuda.synchronize()
    if got.shape != (2, 600, 256) or got.dtype != torch.float32:
        fail(f"gather_normalize: output {tuple(got.shape)} {got.dtype}")
    err = (got - ref).abs().max().item()
    if not err <= 1e-5:
        fail(f"gather_normalize: max abs error {err} > 1e-5")
    ms = time_ms(torch, lambda: gather_normalize(grid, cells))
    plain_ms = time_ms(torch, lambda: gather_normalize_plain(grid, cells))
    flat_cells = (cells + torch.arange(2, device=dev)[:, None] * (48 * 156)).reshape(-1)
    flat_grid = grid.reshape(-1, 256)
    lib_ms = time_ms(
        torch, lambda: F.normalize(flat_grid.index_select(0, flat_cells).float(), dim=-1)
    )
    rows = cells.numel() * 256
    record(
        "gather_normalize", err, ms, plain_ms, lib_ms,
        bound(rows * grid.element_size() + nbytes(cells, got), f32_ops=3.0 * rows),
    )
    return out


def render_sequence(n: int, width: int, height: int, start: int = 0, seed: int = 0):
    """The bench circuit (bench.py): the sprite room scaled by FX/TRAIN_FX so
    the apparent feature size matches the checkpoints' render domain, seen
    through the KITTI 00 rig; frames start..start+n of a 144-frame lap."""
    from superslam_tpu_torch.eval.synthetic_sequence import (
        circuit_trajectory,
        make_room_world,
        render_stereo,
    )
    from superslam_tpu_torch.geometry.stereo_camera import StereoCalib

    s = FX / TRAIN_FX
    world = make_room_world(
        np.random.default_rng(seed),
        half_x=8.0 * s,
        half_z=8.0 * s,
        height=2.4 * s,
        n_sprites=420,
        sprite_half=(0.28 * s, 0.55 * s),
    )
    calib = StereoCalib(fx=FX, fy=FX, cx=CX, cy=CY, baseline=BF / FX)
    poses = circuit_trajectory(CIRCUIT_FRAMES, radius_x=4.5 * s, radius_z=4.5 * s, laps=1.0)
    rrng = np.random.default_rng(seed + 1)
    frames = []
    for p in poses[start : start + n]:
        left, right = render_stereo(world, p, calib, height, width, rrng)
        frames.append(
            (np.round(left * 255).astype(np.uint8), np.round(right * 255).astype(np.uint8))
        )
    return frames, poses[start : start + n]


CONFIG = """\
Camera.fx: {fx}
Camera.fy: {fx}
Camera.cx: {cx}
Camera.cy: {cy}
Camera.bf: {bf}
Camera.width: {width}
Camera.height: {height}
ThDepth: 35
SuperPoint.model_dir: "{weights}"
superpoint:
  max_keypoints: {max_kp}
  keypoint_threshold: {threshold}
  remove_borders: 4
  weights_file: superpoint_render.safetensors
lightglue:
  image_width: {width}
  image_height: {height}
  weights_file: lightglue_synth.safetensors
Backend.window_size: 10
KeyFrame.covis_ratio: 0.75
KeyFrame.max_frames: 20
"""


def run_facade(torch, frames, width: int, height: int, max_kp: int):
    """Drive the port's facade over rendered frames, with the launch counts
    set to 0 just before the first frame and read just after the last.
    Returns (the facade, poses, per-frame fused-step ms, loop seconds after
    frame 0, launch counts, keyframe count)."""
    from superslam_tpu_torch.ops.cuda import _build
    from superslam_tpu_torch.slam import SuperSLAM

    with tempfile.TemporaryDirectory() as tmp:
        cfg = os.path.join(tmp, "kitti_render.yaml")
        with open(cfg, "w") as f:
            f.write(
                CONFIG.format(
                    fx=FX, cx=CX, cy=CY, bf=BF, width=width, height=height,
                    weights=os.path.join(REPO, "weights") + os.sep,
                    max_kp=max_kp, threshold=KP_THRESHOLD,
                )
            )
        slam = SuperSLAM(cfg)

    step_ms: list[float] = []
    process = slam.pipeline.process

    def timed_process(left, right, timestamp):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        result = process(left, right, timestamp)  # ends in the packed readback
        b.record()
        b.synchronize()
        step_ms.append(a.elapsed_time(b))
        return result

    slam.pipeline.process = timed_process
    _build.reset_launch_counts()
    t1 = None
    for i, (left, right) in enumerate(frames):
        Tcw = slam.track_stereo(left, right, 0.1 * i)
        if Tcw.shape != (4, 4) or not np.isfinite(Tcw).all():
            fail(f"frame {i}: pose {Tcw}")
        if i == 0:
            t1 = time.perf_counter()
    loop_s = time.perf_counter() - t1
    counts = _build.launch_counts()
    slam.pipeline.process = process
    slam.estimator.stop_loop_worker()
    poses = slam.estimator.corrected_trajectory()
    n_kf = len(slam.estimator.anchors())
    return slam, poses, step_ms, loop_s, counts, n_kf


def check_facade_run(label, poses, gt, step_ms, loop_s, counts, n_kf, per_frame):
    """Print one facade run's line and hold it to its launch counts and the
    ATE limit. Returns the ATE result."""
    from superslam_tpu_torch.eval.metrics import ate

    n = len(gt)
    res = ate(poses, gt)
    print(
        f"facade ({label}): {n} frames {WIDTH}x{HEIGHT}, fused step median "
        f"{statistics.median(step_ms):.3f} ms (first {step_ms[0]:.1f} ms), "
        f"{(n - 1) / loop_s:.2f} fps over frames 1..{n - 1}, ATE {res.rmse:.4f} m, "
        f"keyframes {n_kf}, launches {counts}"
    )
    for k, per in per_frame.items():
        if counts[k] != per * n:
            fail(f"{label}: {k}: {counts[k]} launches in {n} frames, want {per} per frame")
    if not np.isfinite(res.rmse) or res.rmse > ATE_LIMIT_M:
        fail(f"{label}: ATE {res.rmse} m > {ATE_LIMIT_M} m")
    return res


def check_extractor_kernel_route(torch, sp_params, left, right) -> int:
    """One stereo extraction through SuperPointExtractor(use_kernel=True):
    its descriptors against the default route's (atol 1e-5), and the
    gather_normalize launches it made."""
    from superslam_tpu_torch.frontend.extractor import SuperPointExtractor
    from superslam_tpu_torch.ops.cuda import _build

    kw = dict(width=WIDTH, height=HEIGHT, max_keypoints=MAX_KP, keypoint_threshold=KP_THRESHOLD)
    default = SuperPointExtractor(sp_params, **kw).extract_stereo(left, right)
    _build.reset_launch_counts()
    kernel = SuperPointExtractor(sp_params, use_kernel=True, **kw).extract_stereo(left, right)
    torch.cuda.synchronize()
    launches = _build.launch_counts()["gather_normalize"]
    worst = 0.0
    for a, b in zip(default, kernel):
        if a.descriptors.n != b.descriptors.n or a.descriptors.n < 100:
            fail(f"extractor: {a.descriptors.n} vs {b.descriptors.n} keypoints")
        worst = max(worst, (a.descriptors.desc - b.descriptors.desc).abs().max().item())
    print(
        f"extractor (use_kernel=True): {default[0].descriptors.n} + {default[1].descriptors.n} "
        f"keypoints, descriptors vs the default route max abs diff {worst:.3g} "
        f"(limit 1e-5), gather_normalize launches {launches}"
    )
    if not worst <= 1e-5:
        fail(f"extractor: use_kernel descriptors differ by {worst} > 1e-5")
    if launches != 1:
        fail(f"extractor: gather_normalize launched {launches} times, want 1")
    return launches


def check_map_mode(torch, sp_params, left, right) -> int:
    """The map-mode entry point ``nms_suppress`` (the port of the TPU
    kernel's function) on the pre-NMS map that ``superpoint_dense`` gives
    for one rendered stereo pair: the same bits as the NMS'd map of the
    logits mode on the main path. Returns its launches."""
    from superslam_tpu_torch.models.superpoint import prepare_superpoint_params, superpoint_dense
    from superslam_tpu_torch.ops.cuda import _build
    from superslam_tpu_torch.ops.cuda.nms import nms_suppress

    params = prepare_superpoint_params(sp_params, "cuda")
    with torch.no_grad():
        scores, _, pre = superpoint_dense(params, padded_pair(torch, left, right),
                                          return_pre_nms=True)
        _build.reset_launch_counts()
        got = nms_suppress(pre, 4)
        torch.cuda.synchronize()
    launches = _build.launch_counts()["nms"]
    n_bad = (got != scores).sum().item()
    print(f"nms (map mode) on a frame's pre-NMS map: {n_bad} pixels differ from the logits "
          f"mode's NMS'd map ({(scores > 0).sum().item()} peaks), nms launches {launches}")
    if n_bad or launches != 1:
        fail(f"nms: map mode differs from the logits mode in {n_bad} pixels "
             f"or launched {launches} times")
    return launches


def profile_score_half(torch, sp_params, left, right, n: int = 20) -> None:
    """Device time and events of the score half on one frame's logits, as
    the frame ran it before (PyTorch's softmax and depth-to-space, then the
    map-mode kernel) and as it runs it now (the logits mode)."""
    from superslam_tpu_torch.ops.cuda.nms import nms_suppress, scores_nms, scores_nms_plain

    logits = frame_logits(torch, sp_params, left, right)

    def composed():
        for _ in range(n):
            nms_suppress(scores_nms_plain(logits, 0)[0], 4)

    def fused():
        for _ in range(n):
            scores_nms(logits, 4, return_pre=True)

    profile_device(torch, composed, n, "call",
                   "calls of the composition the logits mode replaces", top=8)
    profile_device(torch, fused, n, "call", "calls of the logits mode", top=8)


def profile_gather(torch, sp_params, left, right, n: int = 10) -> None:
    """The gather kernel's device time (row 7) inside n stereo extractions
    through SuperPointExtractor(use_kernel=True)."""
    from superslam_tpu_torch.frontend.extractor import SuperPointExtractor

    extractor = SuperPointExtractor(sp_params, use_kernel=True, width=WIDTH, height=HEIGHT,
                                    max_keypoints=MAX_KP, keypoint_threshold=KP_THRESHOLD)
    rows = profile_device(torch, lambda: [extractor.extract_stereo(left, right) for _ in range(n)],
                          n, "extraction", "extractions with use_kernel=True", top=0)
    gather = [e for e in rows if "gather_kernel" in e.key]
    if not gather:
        fail("extractor: no gather_normalize kernel in the profile")
    for e in gather:
        print(f"extractor (use_kernel=True): {e.key[:60]}: device "
              f"{device_us(e) / 1e3 / n:.4f} ms a call, {e.count / n:.1f} calls an extraction")


def profile_facade(torch, slam, n: int) -> None:
    """Track the next n frames of the lap under torch.profiler, print where
    the device time goes, and fail if a softmax kernel ran: the score half
    is the NMS kernel's logits mode (LightGlue's log_softmax stays)."""
    frames, _ = render_sequence(n, WIDTH, HEIGHT, start=N_FRAMES)

    def track():
        for i, (left, right) in enumerate(frames):
            slam.track_stereo(left, right, 0.1 * (N_FRAMES + i))

    for e in profile_device(torch, track, n, "frame", "frames"):
        if "softmax" in e.key.lower():
            kind = "log_softmax" if is_log_softmax(e.key) else "softmax"
            print(f"profile: {kind} kernel on the frame, {device_us(e) / 1e3 / n:.4f} ms/frame: "
                  f"{e.key}")
            if kind == "softmax":
                fail(f"the frame ran a softmax kernel: {e.key}")


def is_log_softmax(key: str) -> bool:
    """Whether a PyTorch softmax kernel's name is log_softmax's: its
    epilogue (cunn_SoftMaxForward, cunn_SpatialSoftMaxForward) or the
    is_log_softmax template flag of softmax_warp_forward."""
    flag = re.search(r"softmax_warp_forward<(?:[^,<>]+,){4}\s*(true|false)", key)
    return "logsoftmax" in key.lower() or bool(flag and flag.group(1) == "true")


def device_us(e) -> float:
    """A profiler row's own device time in microseconds."""
    return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)


def profile_device(torch, fn, n: int, unit: str, label: str, top: int = 25) -> list:
    """Run fn (n units of work) under torch.profiler, print the busy share
    of the window and the kernels by device time per unit, and return the
    device-side events by device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    # Device-side events only (kernels, memcpys): the CPU-side aten ops
    # also carry the device time of what they launched.
    rows = sorted(
        (
            e for e in prof.key_averages()
            if device_us(e) > 0 and "CPU" not in str(getattr(e, "device_type", "CPU"))
        ),
        key=device_us,
        reverse=True,
    )
    busy_ms = sum(device_us(e) for e in rows) / 1e3
    print(
        f"profile: {n} {label}, wall under the profiler {wall_ms / n:.3f} ms/{unit}, "
        f"device busy {busy_ms / n:.3f} ms/{unit} ({100 * busy_ms / wall_ms:.1f}% of "
        f"that wall), {sum(e.count for e in rows) / n:.0f} device events/{unit}"
    )
    for e in rows[:top]:
        print(
            f"profile:   {device_us(e) / 1e3 / n:8.4f} ms/{unit}  "
            f"{e.count / n:6.1f} calls/{unit}  {e.key[:90]}"
        )
    return rows


_BATCH_KEYS = ("kpts0", "desc0", "kpts1", "desc1", "mask0", "mask1", "gt_indices")


def check_training(torch) -> tuple[int, int]:
    """The matcher's training at full width on the card (phase 7 of the
    module docstring). Returns the masked_attention (the f32 forward) and
    masked_attention_bwd launches of the fixed-batch steps."""
    from scripts import train_lightglue_synth_torch as train_script
    from superslam_tpu_torch.models import lightglue as lgm
    from superslam_tpu_torch.models.weights import load_safetensors
    from superslam_tpu_torch.ops.cuda import _build
    from superslam_tpu_torch.ops.cuda.attention import masked_attention_plain
    from superslam_tpu_torch.parallel.training import (
        make_optimizer,
        matching_loss,
        synthetic_matching_batch,
        train_step,
    )

    dev = torch.device("cuda")
    batch_np = synthetic_matching_batch(np.random.default_rng(5), TRAIN_BATCH, TRAIN_CAP)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in batch_np.items()}

    # 1. The whole step's gradient through the kernels against the same
    # graph with attention's plain version (autograd through its einsums).
    def gradients(plain: bool):
        params = lgm.init_lightglue_params(1, device=dev)
        for p in params.values():
            p.requires_grad_(True)
        kernel_route = lgm.masked_attention
        if plain:
            lgm.masked_attention = masked_attention_plain
        try:
            loss = matching_loss(params, *(batch[k] for k in _BATCH_KEYS))
            loss.backward()
        finally:
            lgm.masked_attention = kernel_route
        return loss.item(), {k: p.grad for k, p in params.items()}

    _build.reset_launch_counts()
    loss_k, grads_k = gradients(plain=False)
    counts = _build.launch_counts()
    loss_p, grads_p = gradients(plain=True)
    torch.cuda.synchronize()
    worst, worst_name, n_checked = 0.0, "", 0
    for name, ref in grads_p.items():
        got = grads_k[name]
        if (ref is None) != (got is None):
            fail(f"train: gradient of {name} exists on one route only")
        if ref is None:
            continue
        if not torch.isfinite(got).all().item():
            fail(f"train: gradient of {name} is not finite")
        rel = (got - ref).abs().max().item() / max(ref.abs().max().item(), 1e-30)
        n_checked += 1
        if rel > worst:
            worst, worst_name = rel, name
    print(
        f"train: gradient of matching_loss (batch {TRAIN_BATCH}, cap {TRAIN_CAP}, f32) through "
        f"the kernels vs the plain versions: loss {loss_k:.6f} vs {loss_p:.6f}, {n_checked} "
        f"tensors, worst max error / max |plain| {worst:.3g} at {worst_name} (limit 1e-3)"
    )
    if not worst <= 1e-3 or not abs(loss_k - loss_p) <= 1e-4 * abs(loss_p):
        fail(f"train: gradient check: {worst} at {worst_name}, loss {loss_k} vs {loss_p}")
    for k in ("masked_attention", "masked_attention_bwd"):
        if counts[k] != ATTENTION_PER_STEP:
            fail(f"train: {k}: {counts[k]} launches in one gradient, want {ATTENTION_PER_STEP}")

    # 2. train_step on that fixed batch: the reference's functional test.
    params = lgm.init_lightglue_params(1, device=dev)
    optimizer = make_optimizer(params, TRAIN_LR)
    train_step(params, optimizer, batch)  # warm-up: cuBLAS handles, optimizer state
    params = lgm.init_lightglue_params(1, device=dev)
    optimizer = make_optimizer(params, TRAIN_LR)
    losses, step_ms = [], []
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    for _ in range(FIXED_BATCH_STEPS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        loss = train_step(params, optimizer, batch)
        b.record()
        b.synchronize()
        step_ms.append(a.elapsed_time(b))
        losses.append(float(loss))
    wall_s = time.perf_counter() - t0
    counts = _build.launch_counts()
    first_below = next((i + 1 for i, v in enumerate(losses) if v < 0.7 * losses[0]), None)
    print(
        f"train: {FIXED_BATCH_STEPS} steps on the fixed batch at lr {TRAIN_LR}: loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f} (first below 0.7 x start after {first_below} "
        f"steps), step median {statistics.median(step_ms):.3f} ms, "
        f"{FIXED_BATCH_STEPS / wall_s:.2f} steps/s, launches {counts}"
    )
    if not all(np.isfinite(losses)) or not losses[-1] < 0.7 * losses[0]:
        fail(f"train: the loss did not fall below 0.7 x its start: {losses}")
    for k, per in (("masked_attention", ATTENTION_PER_STEP),
                   ("masked_attention_bwd", ATTENTION_PER_STEP),
                   ("fused_self_block", 0), ("fused_cross_block", 0)):
        if counts[k] != per * FIXED_BATCH_STEPS:
            fail(f"train: {k}: {counts[k]} launches in {FIXED_BATCH_STEPS} steps, want {per} per step")
    fwd_launches, bwd_launches = counts["masked_attention"], counts["masked_attention_bwd"]

    # One more step in its three parts (CUDA events), then under the profiler.
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    optimizer.zero_grad(set_to_none=True)
    ev[0].record()
    loss = matching_loss(params, *(batch[k] for k in _BATCH_KEYS))
    ev[1].record()
    loss.backward()
    ev[2].record()
    for p in params.values():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    optimizer.step()
    ev[3].record()
    ev[3].synchronize()
    print(
        f"train: one step in parts (CUDA events): forward {ev[0].elapsed_time(ev[1]):.3f} ms, "
        f"backward {ev[1].elapsed_time(ev[2]):.3f} ms, optimizer {ev[2].elapsed_time(ev[3]):.3f} ms"
    )
    profile_device(torch, lambda: train_step(params, optimizer, batch), 1, "step", "train step", top=30)

    # 3. The training script, in-process, on harvested data.
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "lightglue_smoke.safetensors")
        t0 = time.perf_counter()
        meta = train_script.main([
            "--pairs", str(SCRIPT_PAIRS), "--steps", str(SCRIPT_STEPS),
            "--batch", str(TRAIN_BATCH), "--cap", str(TRAIN_CAP), "--out", out,
            "--sp-weights", os.path.join(REPO, "weights", "superpoint_render.safetensors"),
        ])
        script_s = time.perf_counter() - t0
        loaded = load_safetensors(out, "cuda")
    if len(meta["losses"]) != SCRIPT_STEPS or not all(np.isfinite(meta["losses"])):
        fail(f"train script: losses {meta['losses']}")
    reference = lgm.init_lightglue_params(0)
    if loaded.keys() != reference.keys():
        fail("train script: the checkpoint's names differ from the model's")
    for name, t in loaded.items():
        if t.shape != reference[name].shape or not torch.isfinite(t).all().item():
            fail(f"train script: checkpoint tensor {name} {tuple(t.shape)}")
    print(
        f"train script: {SCRIPT_PAIRS} pairs, {SCRIPT_STEPS} steps in {script_s:.1f} s, loss "
        f"{meta['losses'][0]:.4f} -> {meta['losses'][-1]:.4f}, P/R init "
        f"{meta['precision_init']:.3f}/{meta['recall_init']:.3f} trained "
        f"{meta['precision']:.3f}/{meta['recall']:.3f}, checkpoint of {len(loaded)} tensors loaded back"
    )
    return fwd_launches, bwd_launches


def check_profiler(torch) -> dict[str, int]:
    """Every stage of scripts/profile_stages_torch.py at the KITTI shape;
    returns the launches of the three conv kernels only it drives."""
    from scripts import profile_stages_torch as prof
    from superslam_tpu_torch.ops.cuda import _build

    _build.reset_launch_counts()
    results = prof.run_stages(None, "cuda")
    counts = _build.launch_counts()
    if list(results) != list(prof.STAGES):
        fail(f"profiler: stages {list(results)}")
    print("profiler: stage times at 2 x 384 x 1248, 600 keypoints (CUDA events, median of 20):")
    for name, ms in results.items():
        print(f"profiler:   {name:16s} {ms:9.4f} ms")
        if not np.isfinite(ms) or ms <= 0:
            fail(f"profiler: stage {name}: {ms}")
    only_here = {k: counts[k] for k in ("conv1a1b_full", "conv_pair_full", "conv3x3")}
    for k, n in only_here.items():
        if n < 1:
            fail(f"profiler: {k} was not launched")
    return only_here


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        import superslam_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the superslam_tpu_torch package is missing ({e})", file=sys.stderr)
        return 2

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "not readable"
    name = torch.cuda.get_device_name(0)
    print(f"card: {card}")
    print(f"torch.cuda.get_device_name: {name}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    from superslam_tpu_torch.models.weights import load_safetensors
    from superslam_tpu_torch.ops.cuda import _build

    t0 = time.perf_counter()
    _build.library()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s (nvcc {_build.build_seconds} s)")
    report_build(_build.BUILD_DIR)
    # The host estimator's C++ core (csrc/, built with make at first use):
    # build it here so the build is set-up, not part of the timed loop.
    from superslam_tpu_torch import native

    t0 = time.perf_counter()
    print(f"native host core: available={native.available()} ({time.perf_counter() - t0:.1f} s)")

    sp = load_safetensors(os.path.join(REPO, "weights", "superpoint_render.safetensors"), "cuda")
    lg = load_safetensors(os.path.join(REPO, "weights", "lightglue_synth.safetensors"), "cuda")
    frames, gt = render_sequence(N_FRAMES, WIDTH, HEIGHT)
    kernels = check_kernels(torch, sp, lg, frames[0])

    for knob in ("SUPERSLAM_PALLAS_LG", "SUPERSLAM_PALLAS_ATTN"):
        os.environ.pop(knob, None)  # the default route: fused
    slam, poses, step_ms, loop_s, counts, n_kf = run_facade(torch, frames, WIDTH, HEIGHT, MAX_KP)
    check_facade_run("fused route", poses, gt, step_ms, loop_s, counts, n_kf, PER_FRAME_FUSED)
    profile_facade(torch, slam, 5)
    slam.shutdown()

    n_u = N_FRAMES_UNFUSED
    os.environ["SUPERSLAM_PALLAS_LG"] = "0"
    slam_u, poses_u, step_ms_u, loop_s_u, counts_u, n_kf_u = run_facade(
        torch, frames[:n_u], WIDTH, HEIGHT, MAX_KP
    )
    del os.environ["SUPERSLAM_PALLAS_LG"]
    slam_u.shutdown()
    check_facade_run(
        "unfused route", poses_u, gt[:n_u], step_ms_u, loop_s_u, counts_u, n_kf_u,
        PER_FRAME_UNFUSED,
    )
    gap = max(float(np.linalg.norm(a.t - b.t)) for a, b in zip(poses[:n_u], poses_u))
    print(f"routes: largest per-frame position gap fused vs unfused over {n_u} frames {gap:.4f} m")

    gather_launches = check_extractor_kernel_route(torch, sp, *frames[0])
    map_nms_launches = check_map_mode(torch, sp, *frames[0])

    f32_fwd_launches, bwd_launches = check_training(torch)
    profiler_launches = check_profiler(torch)
    # Profiles after every timed phase: a profiler session slows the
    # launches that follow it on the host.
    profile_score_half(torch, sp, *frames[0])
    profile_gather(torch, sp, *frames[0])

    # Each kernel's launches are those of the phase that drives it.
    launches = {k: counts[k] for k, per in PER_FRAME_FUSED.items() if per}
    launches["masked_attention"] = counts_u["masked_attention"]
    launches["gather_normalize"] = gather_launches
    launches["nms"] = map_nms_launches
    launches["masked_attention_f32"] = f32_fwd_launches
    launches["masked_attention_bwd"] = bwd_launches
    launches.update(profiler_launches)
    rows = []
    for k in KERNEL_INFO:
        if launches[k] < 1:
            fail(f"{k}: no launch on the path that should drive it")
        rows.append({**kernels[k], "launches": launches[k]})
    print(f"card: {card}")
    print(json.dumps({"kernels": rows}))
    print(
        json.dumps(
            {"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``superslam_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

In order, any failure exiting non-zero:

1. prints the card (``nvidia-smi`` name and power limit, and
   ``torch.cuda.get_device_name``);
2. builds the hand-written kernels from the sources in the checkout
   (``superslam_tpu_torch/ops/cuda/_build.py``) and the host estimator's
   C++ core (``csrc/``), and prints the build times;
3. launches each kernel at the shapes of the main path and holds it against
   its plain PyTorch version on the card (bf16 conv pairs: max error over
   max |plain| <= 2e-2 after the pool; NMS: exact; bf16 attention: atol
   2e-2, plus the fully-masked row against the mean of v; the fused
   LightGlue self and cross blocks: max error over max |plain| <= 2e-2 in
   bf16 and atol 1e-3 in f32; the descriptor gather: atol 1e-5), timing
   kernel, plain version and, where one exists, a library call as a
   yardstick (CUDA events, median of 20 after 3 warm-ups);
4. runs the port's ``SuperSLAM`` facade on 30 rendered frames at the KITTI
   00 geometry (1241x376, padded to 1248x384; 600 keypoints; the committed
   render-trained SuperPoint and synthetic LightGlue weights) on the
   default, fused LightGlue route, checks the poses are finite, the ATE
   against ground truth is <= 0.5 m and the kernels ran exactly
   1/1/1/9/9 times per frame (conv1a1b, conv_pair, nms, fused_self_block,
   fused_cross_block; masked_attention 0), and prints the fused step's
   median ms and the fps; then tracks 5 more frames under torch.profiler
   and prints the device busy time per frame and the kernels by device
   time;
5. runs the first 10 frames again on the unfused route
   (``SUPERSLAM_PALLAS_LG=0``): exactly 1/1/1/18 launches per frame
   (masked_attention 18, the fused blocks 0), ATE <= 0.5 m, and prints the
   largest per-frame position gap between the two routes;
6. extracts one rendered stereo pair with
   ``SuperPointExtractor(use_kernel=True)``: descriptors within 1e-5 of
   the default route's, and the gather_normalize kernel launched;
7. prints one ``{"kernels": [...]}`` line (each kernel's launches are
   those of the phase that drives it: 4, 5 or 6), then, as the last line,
   ``{"ok": true, "device": {...}}``.

Without a CUDA device, or without the package beside it, it exits non-zero
and prints no result.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
WIDTH, HEIGHT = 1241, 376
FX, CX, CY, BF = 718.856, 607.1928, 185.2157, 386.1448  # KITTI 00
TRAIN_FX = 320.0  # focal length of the committed checkpoints' render domain
CIRCUIT_FRAMES = 144  # frames per lap of the bench circuit (bench.py)
N_FRAMES = 30
N_FRAMES_UNFUSED = 10
MAX_KP = 600
KP_THRESHOLD = 0.010
ATE_LIMIT_M = 0.5
# Launches per frame on the default (fused) LightGlue route and on the
# unfused one (SUPERSLAM_PALLAS_LG=0).
PER_FRAME_FUSED = {
    "conv1a1b": 1, "conv_pair": 1, "nms": 1, "fused_self_block": 9, "fused_cross_block": 9,
    "masked_attention": 0, "gather_normalize": 0,
}
PER_FRAME_UNFUSED = {
    "conv1a1b": 1, "conv_pair": 1, "nms": 1, "fused_self_block": 0, "fused_cross_block": 0,
    "masked_attention": 18, "gather_normalize": 0,
}

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
F32_FLOP_PER_S = 67e12

KERNEL_INFO = {
    "conv1a1b": (
        "superslam_tpu_torch/ops/cuda/conv_pair_pool.cu",
        "superslam_tpu/ops/pallas/conv.py:558",
    ),
    "conv_pair": (
        "superslam_tpu_torch/ops/cuda/conv_pair_pool.cu",
        "superslam_tpu/ops/pallas/conv.py:439",
    ),
    "nms": (
        "superslam_tpu_torch/ops/cuda/nms.cu",
        "superslam_tpu/ops/pallas/nms.py:68",
    ),
    "masked_attention": (
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
}


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


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


def bound(nbytes: float, f32_ops: float = 0.0, bf16_ops: float = 0.0):
    """Least time in ms: bytes over HBM rate vs operations over peak rates."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (f32_ops / F32_FLOP_PER_S + bf16_ops / BF16_FLOP_PER_S) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def attention_ops(kv_mask, heads: int = 4, dim: int = 64) -> tuple[float, float]:
    """(bf16, f32) operations of key-masked attention over (B, K) key masks:
    QK^T and PV over the real keys of each row's key set (a masked key's
    probability is exactly 0; a row with no real key averages all K values),
    and ~5 f32 operations per logit for the softmax."""
    k = kv_mask.shape[1]
    real = kv_mask.sum(dim=1)
    keys = float(real.masked_fill(real == 0, k).sum().item())
    return 4.0 * heads * k * keys * dim, 5.0 * heads * k * keys


def check_kernels(torch, sp_params, lg_params) -> dict[str, dict]:
    """Each kernel against its plain version at the main path's shapes."""
    import torch.nn.functional as F

    from superslam_tpu_torch.models import lightglue as lg
    from superslam_tpu_torch.ops.cuda import lightglue_layer as lgl
    from superslam_tpu_torch.ops.cuda.attention import (
        masked_attention,
        masked_attention_plain,
    )
    from superslam_tpu_torch.ops.cuda.conv import conv_pair_pool, conv_pair_pool_plain
    from superslam_tpu_torch.ops.cuda.gather import gather_normalize, gather_normalize_plain
    from superslam_tpu_torch.ops.cuda.nms import nms_plain, nms_suppress

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

    def library_conv_pool(x, wa, ba, wb, bb):
        y = F.relu(F.conv2d(x, wa, ba, padding=1))
        return F.max_pool2d(F.relu(F.conv2d(y, wb, bb, padding=1)), 2)

    x = None
    for name, cin, h, w in (("conv1a1b", 1, 384, 1248), ("conv_pair", 64, 192, 624)):
        pre = ("conv1a", "conv1b") if cin == 1 else ("conv2a", "conv2b")
        wa, ba = sp_params[f"{pre[0]}.weight"], sp_params[f"{pre[0]}.bias"]
        wb, bb = sp_params[f"{pre[1]}.weight"], sp_params[f"{pre[1]}.bias"]
        if cin == 1:
            x = torch.from_numpy(rng.uniform(0, 1, (2, 1, h, w)).astype(np.float32)).to(dev)
        got = conv_pair_pool(x, wa, ba, wb, bb)
        ref = conv_pair_pool_plain(x, wa, ba, wb, bb)
        torch.cuda.synchronize()
        if got.shape != (2, 64, h // 2, w // 2) or got.dtype != bf16:
            fail(f"{name}: output {tuple(got.shape)} {got.dtype}")
        err = (got.float() - ref.float()).abs().max().item()
        rel = err / max(ref.float().abs().max().item(), 1e-12)
        print(f"kernel {name}: max error / max |plain| = {rel:.3g} (limit 2e-2)")
        if not rel <= 2e-2:
            fail(f"{name}: relative error {rel} > 2e-2")
        ms = time_ms(torch, lambda: conv_pair_pool(x, wa, ba, wb, bb))
        plain_ms = time_ms(torch, lambda: conv_pair_pool_plain(x, wa, ba, wb, bb))
        xl = x.to(bf16).contiguous(memory_format=torch.channels_last)
        wl = [t.to(bf16) for t in (wa, ba, wb, bb)]
        lib_ms = time_ms(torch, lambda: library_conv_pool(xl, *wl))
        px = 2 * h * w
        bnd = bound(
            nbytes(x, wa, ba, wb, bb, got),
            f32_ops=2 * px * 64 * 9 if cin == 1 else 0,
            bf16_ops=2 * px * 64 * 64 * 9 * (1 if cin == 1 else 2),
        )
        record(name, err, ms, plain_ms, lib_ms, bnd)
        x = got  # the next pair's input, as on the main path

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


def profile_facade(torch, slam, n: int) -> None:
    """Track the next n frames of the lap under torch.profiler and print
    where the device time goes: busy share of the window, and the kernels
    by device time per frame."""
    from torch.profiler import ProfilerActivity, profile

    frames, _ = render_sequence(n, WIDTH, HEIGHT, start=N_FRAMES)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i, (left, right) in enumerate(frames):
            slam.track_stereo(left, right, 0.1 * (N_FRAMES + i))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    def device_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

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
        f"profile: {n} frames, wall under the profiler {wall_ms / n:.3f} ms/frame, "
        f"device busy {busy_ms / n:.3f} ms/frame ({100 * busy_ms / wall_ms:.1f}% of "
        f"that wall), {sum(e.count for e in rows) / n:.0f} device events/frame"
    )
    for e in rows[:25]:
        print(
            f"profile:   {device_us(e) / 1e3 / n:8.4f} ms/frame  "
            f"{e.count / n:6.1f} calls/frame  {e.key[:90]}"
        )


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
    # The host estimator's C++ core (csrc/, built with make at first use):
    # build it here so the build is set-up, not part of the timed loop.
    from superslam_tpu_torch import native

    t0 = time.perf_counter()
    print(f"native host core: available={native.available()} ({time.perf_counter() - t0:.1f} s)")

    sp = load_safetensors(os.path.join(REPO, "weights", "superpoint_render.safetensors"), "cuda")
    lg = load_safetensors(os.path.join(REPO, "weights", "lightglue_synth.safetensors"), "cuda")
    kernels = check_kernels(torch, sp, lg)

    frames, gt = render_sequence(N_FRAMES, WIDTH, HEIGHT)
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

    # Each kernel's launches are those of the phase that drives it.
    launches = {k: counts[k] for k, per in PER_FRAME_FUSED.items() if per}
    launches["masked_attention"] = counts_u["masked_attention"]
    launches["gather_normalize"] = gather_launches
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

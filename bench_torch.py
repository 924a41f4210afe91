#!/usr/bin/env python3
"""Benchmark of the PyTorch/CUDA port: per-frame stereo tracking rate on
KITTI-shaped frames. The port's counterpart of ``bench.py``.

Per-frame latency percentiles over ``PipelinedStereoTracker.track`` plus
sustained fps over wall clock, on the KITTI 00 camera geometry (1241x376,
fx=718.856, bf=386.1448) with the KITTI00 config's max_keypoints=600
front-end, as the reference benchmark binary
(``examples/stereo/benchmark.cc:96-107`` of the upstream C++ system)
measures it. ``vs_baseline`` is against 79 fps: the upstream C++ system's
KITTI 00 figure on an NVIDIA RTX PRO 1000 with TensorRT FP16 (BASELINE.md).

Measurement: 15 s of unmeasured sustained tracking settles the run, then the
value is the whole-run sustained rate over a further 135 s, tail drain
included. Per-10-s-window rates and the latency percentiles go to stderr.
Device time is reported separately: the step of the run's final mode looped
on the device, each iteration's images derived on the device from the last
one's output, timed as the difference of two iteration counts.

Frames are rendered: the textured-sprite room world
(``superslam_tpu_torch/eval/synthetic_sequence.py``) scaled by
fx_kitti/fx_train so the apparent feature scale matches the committed
render-trained checkpoints' domain, rendered as a closed 144-frame circuit
at the KITTI 00 camera geometry (bench.py's frames, byte for byte). The
bench runs the committed model stack (weights/superpoint_render.safetensors
+ weights/lightglue_synth.safetensors) at the natural keyframe cadence,
through ``PipelinedStereoTracker`` at depth ``BENCH_DEPTH`` (3) and batch
``BENCH_BATCH`` (4) with device tracking on the card
(``device_tracker_wanted``), device keyframes unless
``SUPERSLAM_DEVICE_KF=0``.

Runs on CUDA and exits non-zero without a card. Prints ONE JSON line last:
{"metric", "value", "unit", "vs_baseline"}.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

BASELINE_FPS = 79.0  # upstream KITTI 00, RTX PRO 1000 + TensorRT FP16 (BASELINE.md)
WIDTH, HEIGHT = 1241, 376
FX, CX, CY, BF = 718.856, 607.1928, 185.2157, 386.1448  # KITTI 00
TRAIN_FX = 320.0  # the committed checkpoints' render-domain focal length
MAX_KP = 600  # KITTI00-02.yaml superpoint.max_keypoints
N_WARMUP = 5
N_FRAMES = 144  # one full closed circuit lap; the run cycles seamlessly
WIN_S = 10.0
REPO = os.path.dirname(os.path.abspath(__file__))


def make_slam(device="cuda", lg_params=None):
    """bench.py's pipeline and estimator, the port's, on ``device``; the
    matcher is the committed lightglue_synth checkpoint unless
    ``lg_params`` is given."""
    from superslam_tpu_torch.core.vo_estimator import VoEstimator
    from superslam_tpu_torch.frontend.fused import FusedStereoPipeline
    from superslam_tpu_torch.frontend.matcher import LightGlueMatcher
    from superslam_tpu_torch.geometry.stereo_camera import StereoCalib
    from superslam_tpu_torch.models.lightglue import init_lightglue_params
    from superslam_tpu_torch.models.superpoint import init_superpoint_params
    from superslam_tpu_torch.models.weights import load_params

    calib = StereoCalib(fx=FX, fy=FX, cx=CX, cy=CY, baseline=BF / FX)
    sp_params = load_params(
        os.path.join(REPO, "weights", "superpoint_render.safetensors"),
        lambda: init_superpoint_params(0),
        device,
    )
    if lg_params is None:
        lg_params = load_params(
            os.path.join(REPO, "weights", "lightglue_synth.safetensors"),
            lambda: init_lightglue_params(0, passthrough=True),
            device,
        )
    pipeline = FusedStereoPipeline(
        sp_params,
        lg_params,
        calib,
        width=WIDTH,
        height=HEIGHT,
        max_keypoints=MAX_KP,
        keypoint_threshold=0.010,  # trained-checkpoint operating point
        device=device,
    )
    matcher = LightGlueMatcher(
        lg_params, image_width=WIDTH, image_height=HEIGHT, max_keypoints=MAX_KP, device=device
    )
    estimator = VoEstimator(matcher, calib, window_size=10, device=device)
    # Natural keyframe cadence at the accuracy stack's covisibility gate
    # (KeyFrame.covis_ratio 0.75, make_synthetic_sequence.py config).
    estimator.set_keyframe_params(covisibility_ratio=0.75, max_frames=20)
    return pipeline, estimator


def make_tracker(pipeline, estimator, device="cuda"):
    """bench.py's tracker: depth BENCH_DEPTH (3), batch BENCH_BATCH (4),
    device tracking where ``device_tracker_wanted(device)`` says."""
    from superslam_tpu_torch.frontend.pipelined import PipelinedStereoTracker
    from superslam_tpu_torch.utils.env import device_tracker_wanted

    return PipelinedStereoTracker(
        pipeline,
        estimator,
        depth=int(os.environ.get("BENCH_DEPTH", "3")),
        batch=int(os.environ.get("BENCH_BATCH", "4")),
        device_tracking=device_tracker_wanted(device),
    )


def circuit_poses(n: int):
    """The ground-truth poses of the rendered circuit (n frames a lap)."""
    from superslam_tpu_torch.eval.synthetic_sequence import circuit_trajectory

    s = FX / TRAIN_FX
    return circuit_trajectory(n, radius_x=4.5 * s, radius_z=4.5 * s, laps=1.0)


def synth_sequence(n: int, seed: int = 0):
    """Closed-loop rendered circuit at the KITTI 00 camera geometry.

    The sprite-room world scaled by FX/TRAIN_FX: apparent feature size is
    fx*size/z, so scaling the room, sprites and circuit radius by the
    focal-length ratio keeps the rendered statistics inside the committed
    checkpoints' training domain while the camera intrinsics are KITTI's.
    laps=1.0 with n frames closes the loop exactly: cycling through the
    buffer is seamless camera motion.

    Rendering is paid once per geometry and cached in the temporary
    directory, keyed by shape, count and seed and by a hash of the
    renderer's source and every render parameter, so a renderer edit never
    serves stale frames."""
    import hashlib
    import tempfile
    import zipfile

    import superslam_tpu_torch.eval.synthetic_sequence as renderer

    with open(renderer.__file__, "rb") as f:
        renderer_src_hash = hashlib.sha1(f.read()).hexdigest()
    render_key = hashlib.sha1(
        "|".join(
            str(v)
            for v in (
                renderer_src_hash,
                FX,
                TRAIN_FX,
                CX,
                CY,
                BF,
                8.0,  # half_x/half_z
                2.4,  # height
                420,  # n_sprites
                0.28,
                0.55,  # sprite_half
                4.5,  # radius_x/z
                1.0,  # laps
            )
        ).encode()
    ).hexdigest()[:10]
    cache = os.path.join(
        tempfile.gettempdir(),
        f"superslam_bench_torch_frames_{WIDTH}x{HEIGHT}_{n}_{seed}_{render_key}.npz",
    )
    if os.path.exists(cache):
        try:
            z = np.load(cache)
            # Decompress each array once: indexing the NpzFile per frame
            # decompresses the whole (n, H, W) array every time.
            left, right = z["left"], z["right"]
            return [(left[i], right[i]) for i in range(n)]
        except (OSError, EOFError, KeyError, ValueError, zipfile.BadZipFile):
            pass  # a torn or foreign file: render again
    from superslam_tpu_torch.eval.synthetic_sequence import make_room_world, render_stereo
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
    rrng = np.random.default_rng(seed + 1)
    frames = []
    for p in circuit_poses(n):
        left, right = render_stereo(world, p, calib, HEIGHT, WIDTH, rrng)
        frames.append(
            (np.round(left * 255).astype(np.uint8), np.round(right * 255).astype(np.uint8))
        )
    try:
        np.savez_compressed(
            cache,
            left=np.stack([f[0] for f in frames]),
            right=np.stack([f[1] for f in frames]),
        )
    except OSError:
        pass  # no cache: the next run renders again
    return frames


def difference_ms(run, device, lo: int = 3, hi: int = 12, samples: int = 3) -> float:
    """Per-iteration ms of ``run(iters)`` (which loops ``iters`` iterations
    on the device and returns a tensor of its last output) as the difference
    of ``hi`` and ``lo`` iterations, the smallest of ``samples`` samples;
    this cancels the fixed cost of a loop. The device is synchronized only
    around each timed loop. Both lengths run once untimed first."""
    import torch

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    run(lo)
    run(hi)
    sync()
    best = float("inf")
    for _ in range(samples):
        t0 = time.perf_counter()
        run(lo)
        sync()
        t_lo = time.perf_counter() - t0
        t0 = time.perf_counter()
        run(hi)
        sync()
        t_hi = time.perf_counter() - t0
        best = min(best, (t_hi - t_lo) / (hi - lo) * 1e3)
    return best


def next_images(images, packed):
    """The next iteration's input, on the device: the images rolled by one
    row plus the first packed element, in uint8, so no iteration repeats or
    overlaps another and nothing is read on the host."""
    import torch

    return torch.roll(images, 1, dims=2) + packed[0, 0].to(torch.uint8)


def zero_kf_state(K: int, device):
    """The device keyframe state of no keyframe yet, on ``device``: (kpts,
    desc, valid, xw, depth_ok, since) all zero."""
    import torch

    return (
        torch.zeros((K, 2), dtype=torch.float32, device=device),
        torch.zeros((K, 256), dtype=torch.float32, device=device),
        torch.zeros((K,), dtype=torch.bool, device=device),
        torch.zeros((K, 3), dtype=torch.float32, device=device),
        torch.zeros((K,), dtype=torch.bool, device=device),
        torch.zeros((), dtype=torch.int32, device=device),
    )


def identity_carry(device):
    """The device tracking carry (R, t, rel_R, rel_t) of the identity pose
    and motion, as ``pose_carry`` lays it out, on ``device``."""
    import torch

    flat = torch.zeros(24, dtype=torch.float32, device=device)
    flat[0:9:4] = 1.0  # R = I
    flat[12:21:4] = 1.0  # rel_R = I; t = rel_t = 0
    return flat[:9].view(3, 3), flat[9:12], flat[12:21].view(3, 3), flat[21:24]


def device_loop(tracker, images0):
    """``run(iters)`` for ``difference_ms``: the step family of the
    tracker's mode looped on the device: the keyframe-promoting step
    (``fused_stereo_track_kf_step_multi``, zero keyframe state and an
    identity pose carry threaded through), the dispatch-frozen tracking
    step (``fused_stereo_track_step_multi``) or the plain fused step
    (``fused_stereo_step_multi``)."""
    from superslam_tpu_torch.core.keyframe_gate import MIN_FRAMES_DEFAULT, MIN_MATCHES_DEFAULT
    from superslam_tpu_torch.ops import frontend_step as step

    pl = tracker.pipeline
    common = tracker._step_kw()
    K, dev = pl.K, pl.device

    if tracker.device_kf:
        def run(iters):
            kf, carry = zero_kf_state(K, dev), identity_carry(dev)
            images = images0
            for _ in range(iters):
                packed, _d, _k, _v, track, kf, carry = step.fused_stereo_track_kf_step_multi(
                    pl.sp_params, pl.lg_params, images, kf, carry, **common,
                    **tracker._track_kw(), accept_frac=tracker._kf_accept_frac,
                    support_px=tracker._kf_support_px, kf_min_frames=MIN_FRAMES_DEFAULT,
                    kf_max_frames=tracker._kf_max_frames, kf_min_matches=MIN_MATCHES_DEFAULT,
                    covis_ratio=tracker._kf_covis,
                )
                images = next_images(images, packed)
            return track
    elif tracker.device_tracking:
        def run(iters):
            carry = identity_carry(dev)
            images = images0
            for _ in range(iters):
                packed, _d, _k, _v, track, _carry = step.fused_stereo_track_step_multi(
                    pl.sp_params, pl.lg_params, images, pl._kf_kpts, pl._kf_desc,
                    pl._kf_valid, pl._kf_xw, pl._kf_depth_ok, *carry, **common,
                    **tracker._track_kw(),
                )
                images = next_images(images, packed)
            return track
    else:
        def run(iters):
            images = images0
            for _ in range(iters):
                packed, _d, _k, _v = step.fused_stereo_step_multi(
                    pl.sp_params, pl.lg_params, images, pl._kf_kpts, pl._kf_desc,
                    pl._kf_valid, **common,
                )
                images = next_images(images, packed)
            return packed
    return run


def run(
    device="cuda",
    settle_s: float = 15.0,
    measure_s: float = 135.0,
    device_lo: int = 3,
    device_hi: int = 12,
    device_samples: int = 3,
    observe=None,
) -> dict:
    """The benchmark: warm-up, settle, measure, then the device-only line.
    ``observe(stage, tracker)``, when given, is called with "measure" just
    before the first measured frame and "measured" just after the flush
    that ends the measured run (before the device-only loop). Prints the
    stderr lines and returns {"fps", "lat_ms", "window_fps", "device_ms",
    "measured": (first, end) frame indices, "tracker"}."""
    from superslam_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    pipeline, estimator = make_slam(device)
    tracker = make_tracker(pipeline, estimator, device)
    frames = synth_sequence(N_FRAMES)

    # Warm-up: first calls and the first keyframes; the flush drains the
    # window so the host re-match of the frames dispatched before the first
    # keyframe lands here too. The lap is closed, so indexing mod N_FRAMES
    # is seamless camera motion.
    for i in range(N_WARMUP):
        left, right = frames[i]
        tracker.track(left, right, 0.1 * i)
    tracker.flush()

    idx = N_WARMUP
    t_end = time.perf_counter() + settle_s
    while time.perf_counter() < t_end:
        left, right = frames[idx % len(frames)]
        tracker.track(left, right, 0.1 * idx)
        idx += 1

    if observe is not None:
        observe("measure", tracker)
    first = idx
    lat = []
    window_fps = []
    bench_start = time.perf_counter()
    t_win = bench_start
    win_n = 0
    while True:
        left, right = frames[idx % len(frames)]
        t0 = time.perf_counter()
        tracker.track(left, right, 0.1 * idx)
        now = time.perf_counter()
        lat.append(now - t0)
        idx += 1
        win_n += 1
        if now - t_win >= WIN_S:
            window_fps.append(win_n / (now - t_win))
            t_win, win_n = now, 0
        if now - bench_start >= measure_s:
            break
    if win_n:
        # Close the partial window before the flush, so the tail drain is
        # not charged to it (it is part of the sustained value).
        window_fps.append(win_n / (time.perf_counter() - t_win))
    tracker.flush()  # the tail drain belongs to the measured run
    fps = len(lat) / (time.perf_counter() - bench_start)
    if observe is not None:
        observe("measured", tracker)

    lat_ms = np.array(lat) * 1e3
    print(
        f"[bench] windows ({WIN_S:.0f}s each): {[round(f, 1) for f in window_fps]} fps "
        f"(spread {min(window_fps):.1f}-{max(window_fps):.1f})",
        file=sys.stderr,
    )
    print(
        f"[bench] frames={len(lat_ms)} mean={lat_ms.mean():.2f}ms "
        f"p50={np.percentile(lat_ms, 50):.2f}ms p95={np.percentile(lat_ms, 95):.2f}ms "
        f"max={lat_ms.max():.2f}ms sustained={fps:.1f}fps",
        file=sys.stderr,
    )

    # Device-only per-frame time: the step of the run's final mode looped on
    # the device at one frame a step, each iteration's input derived from
    # the last one's output (so iterations neither repeat nor overlap), timed
    # as the difference of two iteration counts: the achievable frame time
    # with the host out of the way.
    images0 = pipeline.to_device(pipeline._prepare_np(*frames[0]))
    dev_ms = difference_ms(
        device_loop(tracker, images0), device, device_lo, device_hi, device_samples
    )
    print(
        f"[bench] device-only per-frame program: {dev_ms:.1f} ms "
        f"({1000 / dev_ms:.0f} fps equivalent)",
        file=sys.stderr,
    )
    return {
        "fps": fps,
        "lat_ms": lat_ms,
        "window_fps": window_fps,
        "device_ms": dev_ms,
        "measured": (first, idx),
        "tracker": tracker,
    }


def result_line(fps: float) -> str:
    return json.dumps(
        {
            "metric": "kitti00_stereo_tracking_fps",
            "value": round(fps, 2),
            "unit": "fps",
            "vs_baseline": round(fps / BASELINE_FPS, 3),
        }
    )


def main() -> None:
    print(result_line(run()["fps"]))


if __name__ == "__main__":
    main()

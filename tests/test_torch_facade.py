"""The port's SuperSLAM facade against the JAX package's, end to end on the
CPU, plus the facade's device and scope contracts.

Parity run: 10 rendered frames of the accuracy suite's sprite-room circuit
at its own geometry (640x352, fx 320, 512 keypoints, the committed
superpoint_render + lightglue_synth weights), JAX with SUPERSLAM_PIPELINE=0
and SUPERSLAM_DEVICE_TRACKER=0, the port with device="cpu", both in their
default bf16 and both on the unfused LightGlue route (SUPERSLAM_PALLAS_LG=0:
the JAX package's fused route on the CPU is Pallas in interpret mode, far
too slow for 10 frames at K = 512). Per-frame camera positions agree
within 0.03 m and the two make the same number of keyframes; both ATEs are
printed.

The target was 0.02 m at 160x120 (ROADMAP queue 3, facade parity): there
the VO sees too few sprites, both trajectories drift ~0.1 m in 10 frames
and near-tied matches flipped by bf16 rounding move them apart by up to
0.4 m (0.06 m with both packages in f32). At 640x352 the gap is 0.018 m
with 6-8 CPU threads and 0.022 m with 1-3: oneDNN's bf16 convolutions
round by thread partition. Hence 0.03 m, not 0.02.

The f32 case shows that the gap is rounding and nothing else: neither
facade offers a compute dtype, so the port's facade (its host estimator is
a copy of the JAX package's) is driven twice, once by the port's per-frame
step and once by the JAX package's, both with their models bound to f32.
The port's own fused and unfused routes are held together the same way."""

import functools

import os

import numpy as np
import pytest
import torch

from superslam_tpu.slam import SuperSLAM as JaxSuperSLAM
from superslam_tpu_torch.eval.metrics import ate
from superslam_tpu_torch.slam import SuperSLAM

from test_torch_frontend_step import rendered_frames

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H, FX, N_FRAMES = 640, 352, 320.0, 10
F32_GAP_M = 0.000266  # measured at 640x352 with 1, 3 and all CPU threads

CONFIG = """\
Camera.fx: {fx}
Camera.fy: {fx}
Camera.cx: {cx}
Camera.cy: {cy}
Camera.bf: {bf}
Camera.width: {w}
Camera.height: {h}
ThDepth: 35
SuperPoint.model_dir: "{weights}"
superpoint:
  max_keypoints: 512
  keypoint_threshold: 0.010
  remove_borders: 4
  weights_file: superpoint_render.safetensors
lightglue:
  image_width: {w}
  image_height: {h}
  weights_file: lightglue_synth.safetensors
Backend.window_size: 8
KeyFrame.covis_ratio: 0.75
KeyFrame.max_frames: 20
"""


@pytest.fixture(scope="module")
def config_path(tmp_path_factory):
    p = tmp_path_factory.mktemp("cfg") / "render.yaml"
    p.write_text(
        CONFIG.format(
            fx=FX, cx=W / 2, cy=H / 2, bf=FX * 0.3, w=W, h=H,
            weights=os.path.join(REPO, "weights") + os.sep,
        )
    )
    return str(p)


def _run(slam, frames):
    for i, (left, right) in enumerate(frames):
        Tcw = slam.track_stereo(left, right, 0.1 * i)
        assert Tcw.shape == (4, 4) and np.isfinite(Tcw).all()
    if slam._tracker is not None:
        slam._tracker.flush()
    slam.estimator.stop_loop_worker()
    return slam.estimator.corrected_trajectory(), len(slam.estimator.anchors())


def test_facade_matches_jax_facade(config_path, monkeypatch):
    monkeypatch.setenv("SUPERSLAM_PALLAS_LG", "0")
    monkeypatch.setenv("SUPERSLAM_PIPELINE", "0")
    monkeypatch.setenv("SUPERSLAM_DEVICE_TRACKER", "0")
    monkeypatch.delenv("SUPERSLAM_ENABLE_LOOP", raising=False)
    frames, gt, _ = rendered_frames(N_FRAMES, W, H, FX)
    jtraj, jkf = _run(JaxSuperSLAM(config_path), frames)
    ttraj, tkf = _run(SuperSLAM(config_path, device="cpu"), frames)
    gap = [float(np.linalg.norm(a.t - b.t)) for a, b in zip(jtraj, ttraj)]
    print(
        f"ATE jax {ate(jtraj, gt).rmse:.4f} m, port {ate(ttraj, gt).rmse:.4f} m; "
        f"per-frame position gap max {max(gap):.4f} m; keyframes {jkf} / {tkf}"
    )
    assert len(ttraj) == len(jtraj) == N_FRAMES
    assert tkf == jkf
    assert max(gap) <= 0.03, gap


def _f32_steps(monkeypatch):
    """The two packages' per-frame steps with SuperPoint and LightGlue bound
    to f32 (module attributes rebound for this test; the JAX step is traced
    afresh), each behind the port step's torch signature and fed the f32
    checkpoint values."""
    import jax
    import jax.numpy as jnp

    import superslam_tpu.ops.frontend_step as jstep
    import superslam_tpu_torch.ops.frontend_step as tstep
    from superslam_tpu.models.weights import load_safetensors as jax_load
    from superslam_tpu_torch.models.weights import load_safetensors

    sp = os.path.join(REPO, "weights", "superpoint_render.safetensors")
    lg = os.path.join(REPO, "weights", "lightglue_synth.safetensors")
    jsp, jlg, tsp, tlg = jax_load(sp), jax_load(lg), load_safetensors(sp), load_safetensors(lg)
    for mod, dtype in ((jstep, jnp.float32), (tstep, torch.float32)):
        monkeypatch.setattr(
            mod, "superpoint_dense", functools.partial(mod.superpoint_dense, compute_dtype=dtype))
        monkeypatch.setattr(
            mod, "lightglue_forward",
            functools.partial(mod.lightglue_forward, compute_dtype=dtype, fused=False))
    jax.clear_caches()

    def port_step(_sp, _lg, images, kf_kpts, kf_desc, kf_valid, **kw):
        return tstep.fused_stereo_step(tsp, tlg, images, kf_kpts, kf_desc, kf_valid, **kw)

    def jax_step(_sp, _lg, images, kf_kpts, kf_desc, kf_valid, **kw):
        out = jstep.fused_stereo_step(
            jsp, jlg, *(jnp.asarray(t.numpy()) for t in (images, kf_kpts, kf_desc, kf_valid)), **kw)
        return tuple(torch.from_numpy(np.array(a)) for a in out)

    return port_step, jax_step


def test_facade_f32_steps_match_jax(config_path, monkeypatch):
    """Both packages' per-frame steps in f32 under the same host estimator:
    same keyframes, per-frame position gap <= 2 x the gap measured when the
    test was written (F32_GAP_M), far below the 0.02 m target: the bf16
    gap of test_facade_matches_jax_facade is rounding, not algorithm."""
    import jax

    import superslam_tpu_torch.frontend.fused as fused_mod

    monkeypatch.setenv("SUPERSLAM_PIPELINE", "0")  # the synchronous loop calls fused_stereo_step
    port_step, jax_step = _f32_steps(monkeypatch)
    frames, gt, _ = rendered_frames(N_FRAMES, W, H, FX)
    runs = []
    for step in (port_step, jax_step):
        monkeypatch.setattr(fused_mod, "fused_stereo_step", step)
        runs.append(_run(SuperSLAM(config_path, device="cpu"), frames))
    jax.clear_caches()  # drop the f32-bound traces
    (ptraj, pkf), (jtraj, jkf) = runs
    gap = [float(np.linalg.norm(a.t - b.t)) for a, b in zip(jtraj, ptraj)]
    print(
        f"f32 steps: ATE jax-step {ate(jtraj, gt).rmse:.4f} m, port-step "
        f"{ate(ptraj, gt).rmse:.4f} m; per-frame position gap max {max(gap):.6f} m; "
        f"keyframes {jkf} / {pkf}"
    )
    assert pkf == jkf
    assert max(gap) <= 2 * F32_GAP_M, gap


def test_facade_fused_route_matches_unfused(config_path, monkeypatch):
    """The port alone, device="cpu", default bf16, synchronous loop: the
    fused layer route (the default) against the unfused one over the 10
    frames. Same keyframe count, per-frame position gap <= 0.03 m (the two
    routes round at different places, like the two packages)."""
    frames, gt, _ = rendered_frames(N_FRAMES, W, H, FX)
    monkeypatch.setenv("SUPERSLAM_PIPELINE", "0")
    monkeypatch.delenv("SUPERSLAM_PALLAS_ATTN", raising=False)
    runs = {}
    for route in ("1", "0"):
        monkeypatch.setenv("SUPERSLAM_PALLAS_LG", route)
        runs[route] = _run(SuperSLAM(config_path, device="cpu"), frames)
    (ftraj, fkf), (utraj, ukf) = runs["1"], runs["0"]
    gap = [float(np.linalg.norm(a.t - b.t)) for a, b in zip(ftraj, utraj)]
    print(
        f"ATE fused {ate(ftraj, gt).rmse:.4f} m, unfused {ate(utraj, gt).rmse:.4f} m; "
        f"per-frame position gap max {max(gap):.4f} m; keyframes {fkf} / {ukf}"
    )
    assert fkf == ukf
    assert max(gap) <= 0.03, gap


def test_facade_defaults_to_cuda(config_path, monkeypatch):
    """No device argument means CUDA; without a card that raises instead of
    silently running the plain CPU versions."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        SuperSLAM(config_path)


def test_facade_pipelined_default_equals_synchronous(config_path, monkeypatch):
    """SuperSLAM(cfg, device="cpu") with SUPERSLAM_PIPELINE=3 runs the
    pipelined tracker, host-solved (the CPU default), and gives the
    synchronous loop's trajectory within 0.03 m a frame, with the same
    keyframes. Not bit for bit, as in the JAX package
    (tests/test_fused_pipeline.py holds its pair to 0.2 m): a frame in
    flight was matched against the keyframe of its dispatch, which the
    estimator resolves from its store, and the frames dispatched before the
    first keyframe drained re-match on the host (measured: 0.0061 m)."""
    monkeypatch.delenv("SUPERSLAM_DEVICE_TRACKER", raising=False)
    frames, gt, _ = rendered_frames(N_FRAMES, W, H, FX)
    runs = {}
    # Two intra-op threads for both runs (port against port): the suite runs
    # several workers on one host, and more threads than cores slow all.
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    try:
        for depth in ("3", "0"):
            monkeypatch.setenv("SUPERSLAM_PIPELINE", depth)
            slam = SuperSLAM(config_path, device="cpu")
            if depth == "3":
                tracker = slam._tracker
                assert tracker is not None and tracker.depth == 3 and tracker.batch == 1
                assert not tracker.device_tracking
            else:
                assert slam._tracker is None
            runs[depth] = _run(slam, frames)
    finally:
        torch.set_num_threads(threads)
    (ptraj, pkf), (straj, skf) = runs["3"], runs["0"]
    gap = [float(np.linalg.norm(a.t - b.t)) for a, b in zip(ptraj, straj)]
    print(f"ATE depth 3 {ate(ptraj, gt).rmse:.4f} m, depth 0 {ate(straj, gt).rmse:.4f} m; "
          f"per-frame position gap max {max(gap):.3g} m; keyframes {pkf} / {skf}")
    assert len(ptraj) == len(straj) == N_FRAMES
    assert pkf == skf
    assert max(gap) <= 0.03, gap


@pytest.mark.parametrize(
    "device,env,want",
    [
        ("cuda", None, True),
        ("cuda:0", None, True),
        ("cpu", None, False),
        ("cuda", "0", False),
        ("cpu", "1", True),
    ],
)
def test_device_tracker_wanted(monkeypatch, device, env, want):
    """The JAX package's rule with its TPU replaced by the card: on for a
    CUDA device, off on the CPU, SUPERSLAM_DEVICE_TRACKER overriding. The
    card's presence does not enter the rule, only the facade's device."""
    from superslam_tpu_torch.utils.env import device_tracker_wanted

    for available in (True, False):
        monkeypatch.setattr(torch.cuda, "is_available", lambda a=available: a)
        if env is None:
            monkeypatch.delenv("SUPERSLAM_DEVICE_TRACKER", raising=False)
        else:
            monkeypatch.setenv("SUPERSLAM_DEVICE_TRACKER", env)
        assert device_tracker_wanted(torch.device(device)) is want
        assert device_tracker_wanted(device) is want


@pytest.mark.parametrize(
    "env,extra",
    [
        ({}, "DepthMapFactor: 5000.0\n"),
        ({"SUPERSLAM_ENABLE_LOOP": "1"}, "loop:\n  image_width: 128\n"),
    ],
    ids=["rgbd", "loop"],
)
def test_facade_refuses_unported_paths(config_path, tmp_path, monkeypatch, env, extra):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    p = tmp_path / "cfg.yaml"
    p.write_text(open(config_path).read() + extra)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        SuperSLAM(str(p), device="cpu")

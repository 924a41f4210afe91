"""scripts/accuracy_suite_torch.py on the CPU.

- Its render of the circuit is bit for bit the JAX package's: the first 3
  frames of scripts/make_synthetic_sequence.py's 150-frame lap through
  superslam_tpu/eval/synthetic_sequence.py (world seed 0, 300 sprites,
  render seed 1, 640x352, fx 320, baseline 0.3), quantized as
  write_kitti_sequence writes its PNGs, and the same ground truth.
- A 4-frame stereo_sync leg runs through the runner's command line and
  writes the artifact's keys, the loaded host-core build among them.
- Every leg's reference ATE is ACCURACY.json's leg of the same name; the
  three legs that ride the device-keyframe and keyframe-gate code
  (stereo_devkf_nohybrid, stereo_devkf_passthrough, stereo_covis03) are
  printed, not gated, with the reference's envs; a 3-frame
  stereo_devkf_nohybrid leg runs the device-keyframe scan on the CPU.
- The RGB-D legs' render is the JAX package's write_tum_sequence's
  (render_view with depth on the same poses and render seed, gray
  round(x * 255), depth uint16 clip(Z * 5000), times i / 30); 3-frame
  rgbd and stereo_loop legs run on the CPU.
- The 150-frame gated legs on the CPU are marked slow (they take many
  minutes here; on the card chip_smoke.py runs them every time).
"""

import json

import numpy as np
import pytest
import torch

from scripts import accuracy_suite_torch as acc


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads: the suite runs several workers on one host, and
    more threads than cores slow every worker down."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def test_render_matches_the_jax_package():
    from superslam_tpu.eval.synthetic_sequence import (
        circuit_trajectory,
        make_room_world,
        render_stereo,
    )
    from superslam_tpu.geometry import StereoCalib

    pairs, times, gt = acc.render_circuit(3)
    world = make_room_world(np.random.default_rng(0), n_sprites=300)
    calib = StereoCalib(fx=320.0, fy=320.0, cx=320.0, cy=176.0, baseline=0.3)
    poses = circuit_trajectory(150)
    rng = np.random.default_rng(1)
    for i, (left, right) in enumerate(pairs):
        jl, jr = render_stereo(world, poses[i], calib, 352, 640, rng)
        np.testing.assert_array_equal(left, np.round(jl * 255).astype(np.uint8))
        np.testing.assert_array_equal(right, np.round(jr * 255).astype(np.uint8))
        np.testing.assert_array_equal(gt[i].R, poses[i].R)
        np.testing.assert_array_equal(gt[i].t, poses[i].t)
    assert left.shape == (352, 640) and left.dtype == np.uint8
    assert times == [0.0, 0.1, 0.2]


def test_short_leg_writes_the_artifact(tmp_path, monkeypatch):
    out = tmp_path / "ACCURACY_TORCH.json"
    monkeypatch.setattr(
        "sys.argv",
        ["accuracy_suite_torch.py", "--legs", "stereo_sync", "--frames", "4", "--device", "cpu",
         "--out", str(out)],
    )
    assert acc.main() == 0
    suite = json.loads(out.read_text())
    assert {"suite", "frames", "device", "weights", "legs"} <= set(suite)
    assert suite["frames"] == 4 and suite["device"]["platform"] == "cpu"
    (row,) = suite["legs"]
    assert row["leg"] == "stereo_sync" and row["frames"] == 4 and row["passed"]
    assert row["mode"] == {"depth": 0, "batch": 1, "device_tracking": False, "device_kf": False}
    assert row["limit_m"] == pytest.approx(1.5 * 0.0667)
    for key in ("ate_rmse_m", "ate_mean_m", "ate_max_m", "rpe_rmse_m", "wall_s", "fps",
                "keyframes", "reference_ate_m", "env"):
        assert key in row, key
    assert np.isfinite(row["ate_rmse_m"])
    core = suite["host_core"]
    assert core["path"] == "csrc/libsuperslam_core.so" and core["loaded"]
    assert len(core["sha1"]) == 40 and core["bytes"] > 0 and core["host_cpu"]
    assert "-shared" in core["make_command"]


def test_legs_carry_the_reference_legs():
    """Every leg that has a reference carries ACCURACY.json's ATE of the
    leg of the same name; the four the reference has no CPU leg for
    (stereo_loop_devkf, rgbd_devtrack: the card's defaults;
    stereo_xla_smoother: the device window solver; stereo_devkf_f32off:
    the precision kill-switch, whose one reading is the TPU's) carry none
    and are printed."""
    import os

    with open(os.path.join(acc.REPO, "ACCURACY.json")) as f:
        ref = {row["leg"]: row["ate_rmse_m"] for row in json.load(f)["legs"]}
    for leg, (_env, _lg, ate, _gated) in acc.LEGS.items():
        assert ate == ref.get(leg), leg
    assert {leg for leg, spec in acc.LEGS.items() if spec[2] is None} == {
        "stereo_loop_devkf", "rgbd_devtrack", "stereo_xla_smoother", "stereo_devkf_f32off"}
    gated = {leg for leg, spec in acc.LEGS.items() if spec[3]}
    assert gated == {"stereo", "stereo_sync", "stereo_devkf", "stereo_loop", "rgbd"}
    assert acc.LEGS["stereo_loop"][0] == {
        "SUPERSLAM_DEVICE_TRACKER": "0", "SUPERSLAM_ENABLE_LOOP": "1"}
    assert acc.LEGS["rgbd"][0] == {"SUPERSLAM_DEVICE_TRACKER": "0"}
    assert acc.LEGS["rgbd_devtrack"][0] == {}
    assert acc.LEGS["stereo_loop_devkf"][0] == {"SUPERSLAM_ENABLE_LOOP": "1"}
    assert acc.LEGS["stereo_devkf_nohybrid"][0] == {
        "SUPERSLAM_DEVICE_TRACKER": "1", "SUPERSLAM_DEVICE_KF_HYBRID": "0"}
    assert acc.LEGS["stereo_devkf_passthrough"][:2] == (
        {"SUPERSLAM_DEVICE_TRACKER": "1"}, "__passthrough__")
    assert acc.LEGS["stereo_covis03"][0] == {
        "SUPERSLAM_DEVICE_TRACKER": "0", "SUPERSLAM_KF_COVIS": "0.3"}
    assert acc.LEGS["stereo_xla_smoother"][0] == {
        "SUPERSLAM_DEVICE_TRACKER": "0", "SUPERSLAM_XLA_SMOOTHER": "1"}
    assert acc.LEGS["stereo_devkf_f32off"][0] == {
        "SUPERSLAM_DEVICE_TRACKER": "1", "SUPERSLAM_F32_PRECISION": "0"}


def test_f32off_leg_runs_in_a_child_process(monkeypatch):
    """stereo_devkf_f32off sets SUPERSLAM_F32_PRECISION, which
    ops/precision.py reads once at import: run_suite hands it to a child
    process of the suite (``--legs stereo_devkf_f32off``) with the variable
    set, renders nothing for it in the parent, and takes the child's row;
    the other legs stay in the parent."""
    import subprocess

    calls, in_parent = [], []

    def child(cmd, env, **kwargs):
        calls.append((cmd, env))
        out = cmd[cmd.index("--out") + 1]
        with open(out, "w") as f:
            json.dump({"legs": [{"leg": "stereo_devkf_f32off", "ate_rmse_m": 0.07,
                                 "passed": True}]}, f)
        return subprocess.CompletedProcess(cmd, 0, "", "")

    monkeypatch.setattr(acc.subprocess, "run", child)
    monkeypatch.setattr(acc, "run_leg", lambda leg, *a, **k: in_parent.append(leg) or {
        "leg": leg, "passed": True})
    monkeypatch.setattr(acc, "render_circuit", lambda frames: in_parent.append("render"))
    monkeypatch.setattr(acc, "host_core_build", dict)
    suite = acc.run_suite(["stereo_devkf_f32off"], 5, "cpu", log=lambda _m: None)
    assert suite["legs"] == [{"leg": "stereo_devkf_f32off", "ate_rmse_m": 0.07, "passed": True}]
    assert in_parent == []
    (cmd, env), = calls
    assert cmd[1].endswith("accuracy_suite_torch.py")
    assert cmd[cmd.index("--legs") + 1:cmd.index("--legs") + 2] == ["stereo_devkf_f32off"]
    assert cmd[cmd.index("--frames") + 1] == "5" and cmd[cmd.index("--device") + 1] == "cpu"
    assert env["SUPERSLAM_F32_PRECISION"] == "0" and env["SUPERSLAM_DEVICE_TRACKER"] == "1"
    assert not acc.LEGS["stereo_devkf_f32off"][3]  # printed only

    calls.clear()
    acc.run_suite(["stereo_devkf", "stereo_devkf_f32off"], 5, "cpu", log=lambda _m: None)
    assert in_parent == ["render", "stereo_devkf"] and len(calls) == 1


def test_short_xla_smoother_leg_on_the_cpu(monkeypatch):
    """stereo_xla_smoother over 6 frames on the CPU: the stereo leg with
    every window solved by ops/window_solver.py (the solver counted),
    printed only."""
    from superslam_tpu_torch.core import window_smoother

    solves = []
    real = window_smoother.WindowSmoother._lm_xla
    monkeypatch.setattr(window_smoother.WindowSmoother, "_lm_xla",
                        lambda self, *a, **k: solves.append(1) or real(self, *a, **k))
    row = acc.run_leg("stereo_xla_smoother", acc.render_circuit(6), "cpu")
    assert row["mode"]["depth"] == 3 and not row["mode"]["device_tracking"]
    assert row["limit_m"] is None and row["passed"] and np.isfinite(row["ate_rmse_m"])
    assert solves


def test_short_device_keyframe_leg_on_the_cpu():
    """stereo_devkf_nohybrid over 3 frames on the CPU: the pipelined tracker
    with device keyframes (the scan's plain twin here), printed only."""
    row = acc.run_leg("stereo_devkf_nohybrid", acc.render_circuit(3), "cpu")
    assert row["mode"] == {"depth": 3, "batch": 1, "device_tracking": True, "device_kf": True}
    assert row["limit_m"] is None and row["passed"] and np.isfinite(row["ate_rmse_m"])


def test_rgbd_render_matches_the_jax_package():
    from superslam_tpu.eval.synthetic_sequence import (
        circuit_trajectory,
        make_room_world,
        render_view,
    )
    from superslam_tpu.geometry import StereoCalib

    pairs, times, gt = acc.render_rgbd_circuit(3)
    world = make_room_world(np.random.default_rng(0), n_sprites=300)
    calib = StereoCalib(fx=320.0, fy=320.0, cx=320.0, cy=176.0, baseline=0.3)
    poses = circuit_trajectory(150)
    rng = np.random.default_rng(1)
    for i, (gray, depth) in enumerate(pairs):
        img, z = render_view(world, poses[i], calib, 352, 640, rng, return_depth=True)
        np.testing.assert_array_equal(gray, np.round(img * 255).astype(np.uint8))
        np.testing.assert_array_equal(depth, np.clip(z * 5000.0, 0, 65535).astype(np.uint16))
        np.testing.assert_array_equal(gt[i].t, poses[i].t)
    assert depth.dtype == np.uint16 and (depth > 0).mean() > 0.2  # the sprites have depth
    assert times == [0.0, float(f"{1 / 30:.6f}"), float(f"{2 / 30:.6f}")]


@pytest.mark.parametrize("leg", ["rgbd", "stereo_loop"])
def test_short_rgbd_and_loop_legs_on_the_cpu(leg):
    """3 frames of the RGB-D leg (the facade's track_rgbd, host-solved) and
    of the loop leg (EigenPlaces and the async worker on; no revisit in 3
    frames, so no closure, and the gate's closure count is not applied to
    a partial lap)."""
    row = acc.run_leg(leg, (acc.render_rgbd_circuit if leg == "rgbd" else acc.render_circuit)(3),
                      "cpu")
    assert row["mode"] == {"depth": 3, "batch": 1, "device_tracking": False, "device_kf": False}
    assert row["loop_enabled"] == (leg == "stereo_loop") and row["loop_closures"] == 0
    assert row["frames"] == 3 and row["host_solves"] >= 2 and np.isfinite(row["ate_rmse_m"])


@pytest.mark.slow
def test_gated_legs_150_frames_cpu():
    """The three gated legs over the whole lap on the CPU: many minutes, so
    marked ``slow`` (run it with ``-m slow``); chip_smoke.py runs the same
    legs on the card every time."""
    suite = acc.run_suite(["stereo", "stereo_sync", "stereo_devkf"], 150, "cpu")
    for row in suite["legs"]:
        assert row["passed"], row

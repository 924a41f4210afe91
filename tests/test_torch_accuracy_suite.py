"""scripts/accuracy_suite_torch.py on the CPU.

- Its render of the circuit is bit for bit the JAX package's: the first 3
  frames of scripts/make_synthetic_sequence.py's 150-frame lap through
  superslam_tpu/eval/synthetic_sequence.py (world seed 0, 300 sprites,
  render seed 1, 640x352, fx 320, baseline 0.3), quantized as
  write_kitti_sequence writes its PNGs, and the same ground truth.
- A 4-frame stereo_sync leg runs through the runner's command line and
  writes the artifact's keys.
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


@pytest.mark.slow
def test_gated_legs_150_frames_cpu():
    """The three gated legs over the whole lap on the CPU: many minutes, so
    marked ``slow`` (run it with ``-m slow``); chip_smoke.py runs the same
    legs on the card every time."""
    suite = acc.run_suite(["stereo", "stereo_sync", "stereo_devkf"], 150, "cpu")
    for row in suite["legs"]:
        assert row["passed"], row

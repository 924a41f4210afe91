"""``bench_torch.py`` against ``bench.py``: the rendered frames byte for
byte and the tracker configuration, built on the CPU without rendering or
compiling anything; and ``main()`` on the CPU with its settle and measure
cut to 0 and its device-only counts to 1, 2 and 1, on a 12-frame lap at
320x128 with 96 keypoints."""

import functools
import json
import os
import sys
import tempfile

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

KP = 96


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """The test workers share the host's cores: a torch process on all of
    them oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    monkeypatch.setenv("SUPERSLAM_NO_LOG_FILE", "1")
    for knob in ("SUPERSLAM_DEVICE_TRACKER", "SUPERSLAM_PIPELINE", "SUPERSLAM_DEVICE_KF",
                 "BENCH_DEPTH", "BENCH_BATCH"):
        monkeypatch.delenv(knob, raising=False)


def test_bench_frames_match_bench_py(tmp_path, monkeypatch):
    import bench
    import bench_torch

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    monkeypatch.setattr(np, "savez_compressed", lambda *a, **k: None)  # no caches
    ours, theirs = bench_torch.synth_sequence(2), bench.synth_sequence(2)
    assert len(ours) == len(theirs) == 2
    for (l0, r0), (l1, r1) in zip(ours, theirs):
        assert l0.shape == (bench.HEIGHT, bench.WIDTH) and l0.dtype == np.uint8
        np.testing.assert_array_equal(l0, l1)
        np.testing.assert_array_equal(r0, r1)


class _Built(Exception):
    pass


def test_bench_configuration_matches_bench_py(monkeypatch):
    """bench.py's main() up to its tracker (no frame is rendered, nothing
    compiled) against bench_torch.py's make_slam and make_tracker on the
    CPU."""
    import bench
    import bench_torch
    import superslam_tpu.frontend.pipelined as jax_pipelined
    import superslam_tpu.slam as jax_slam

    seen = {}

    def capture(pipeline, estimator, **kw):
        seen.update(pipeline=pipeline, estimator=estimator, **kw)
        raise _Built

    monkeypatch.setattr(jax_slam, "_enable_compilation_cache", lambda: None)
    monkeypatch.setattr(jax_pipelined, "PipelinedStereoTracker", capture)
    with pytest.raises(_Built):
        bench.main()
    tracker = bench_torch.make_tracker(*bench_torch.make_slam("cpu"), "cpu")
    pl, jpl = tracker.pipeline, seen["pipeline"]
    est, jest = tracker.estimator, seen["estimator"]
    assert (tracker.depth, tracker.batch) == (seen["depth"], seen["batch"]) == (3, 4)
    assert tracker.device_tracking == seen["device_tracking"]
    assert (pl.K, pl.keypoint_threshold, pl.width, pl.height) == (
        jpl.K, jpl.keypoint_threshold, jpl.width, jpl.height)
    assert vars(pl.calib) == vars(jpl.calib)
    assert est.smoother.window_size == jest.smoother.window_size == 10
    assert (est._covisibility_ratio, est._max_keyframe_frames) == (
        jest._covisibility_ratio, jest._max_keyframe_frames) == (0.75, 20)
    assert bench_torch.BASELINE_FPS == bench.BASELINE_FPS
    assert (bench_torch.N_WARMUP, bench_torch.N_FRAMES) == (bench.N_WARMUP, bench.N_FRAMES)


def test_device_loop_start_state():
    """The device-only loop's start state: ``pose_carry``'s identity carry,
    its four views in one buffer, and a keyframe state of no keyframe."""
    from types import SimpleNamespace

    import bench_torch
    from superslam_tpu_torch.frontend.pipelined import pose_carry
    from superslam_tpu_torch.geometry.se3 import Pose3

    cpu = torch.device("cpu")
    carry = bench_torch.identity_carry(cpu)
    ref = pose_carry(SimpleNamespace(to_device=torch.from_numpy), Pose3(), Pose3())
    for a, b in zip(carry, ref, strict=True):
        assert a.shape == b.shape and a.dtype == b.dtype and torch.equal(a, b)
    assert len({t.untyped_storage().data_ptr() for t in carry}) == 1
    kf = bench_torch.zero_kf_state(7, cpu)
    assert [(tuple(t.shape), t.dtype) for t in kf] == [
        ((7, 2), torch.float32), ((7, 256), torch.float32), ((7,), torch.bool),
        ((7, 3), torch.float32), ((7,), torch.bool), ((), torch.int32)]
    assert not any(t.any() for t in kf)


@pytest.mark.parametrize("device_tracker", ["0", "1"], ids=["host_solved", "device_kf"])
def test_bench_run_prints_the_result_line(tmp_path, monkeypatch, capsys, device_tracker):
    """main() on the CPU with settle and measure 0 and device-only counts
    1, 2, 1, on a 12-frame lap at 320x128 with 96 keypoints: bench.py's
    JSON last, every tracked frame in the trajectory."""
    import bench_torch

    monkeypatch.setenv("SUPERSLAM_DEVICE_TRACKER", device_tracker)
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    for name, value in (("WIDTH", 320), ("HEIGHT", 128), ("CX", 160.0), ("CY", 64.0),
                        ("MAX_KP", KP), ("N_FRAMES", 12)):
        monkeypatch.setattr(bench_torch, name, value)
    results, stages = [], []

    def cut_run(*a, **kw):
        def observe(stage, tracker):
            stages.append((stage, len(tracker.estimator.corrected_trajectory())))

        results.append(run("cpu", settle_s=0.0, measure_s=0.0, device_lo=1, device_hi=2,
                           device_samples=1, observe=observe))
        return results[-1]

    run = bench_torch.run
    monkeypatch.setattr(bench_torch, "run", cut_run)
    bench_torch.main()
    out = capsys.readouterr()
    line = json.loads(out.out.strip().splitlines()[-1])
    assert set(line) == {"metric", "value", "unit", "vs_baseline"}
    assert line["metric"] == "kitti00_stereo_tracking_fps" and line["value"] > 0
    assert "[bench] device-only per-frame program" in out.err
    res = results[0]
    tracker = res["tracker"]
    assert (tracker.depth, tracker.batch, tracker.device_kf) == (3, 4, device_tracker == "1")
    first, end = res["measured"]
    assert first == bench_torch.N_WARMUP and end == first + len(res["lat_ms"])
    assert stages == [("measure", first), ("measured", end)]
    traj = tracker.estimator.corrected_trajectory()
    assert len(traj) == end
    assert all(np.isfinite(p.t).all() for p in traj)


def test_bench_needs_a_card(monkeypatch):
    import bench_torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(bench_torch, "synth_sequence",
                        functools.partial(pytest.fail, "rendered before the device check"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench_torch.main()

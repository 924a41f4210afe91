"""The port's viewer (io/viewer.py) and the facade's use_viewer, on the
CPU: tests/test_viewer.py's cases on the port (the recorder's poses and its
Agg plot on close(), the rerun SDK branch against a mock of the names it
uses), and SuperSLAM(cfg, use_viewer=True) forcing the synchronous loop
(depth 0) and drawing every frame."""

import sys
import types

import numpy as np

from superslam_tpu_torch.core.frame import StereoFrame
from superslam_tpu_torch.geometry import Pose3, StereoCalib


def _calib():
    return StereoCalib(fx=500.0, fy=500.0, cx=320.0, cy=240.0, baseline=0.5)


def _frame(n=3):
    return StereoFrame(
        keypoints_left=np.zeros((n, 2), np.float32),
        stereo=np.array([[320.0, 300.0, 240.0]] * n),
        has_depth=np.ones(n, bool),
    )


def test_viewer_records_and_plots(tmp_path, monkeypatch):
    monkeypatch.setenv("SUPERSLAM_VIEWER_PLOT", str(tmp_path / "traj.png"))
    monkeypatch.delitem(sys.modules, "rerun", raising=False)
    from superslam_tpu_torch.io.viewer import RerunViewer

    v = RerunViewer()
    for i in range(5):
        v.draw_frame(_frame(), Pose3(t=np.array([0.1 * i, 0, 0])), _calib())
        v.plot("loop_score", 0.5 + 0.01 * i)
    v.log_info("test", "hello")
    assert len(v._traj) == 5 and len(v._scalars["loop_score"]) == 5
    v.close()
    out = tmp_path / "traj.png"
    assert out.exists() and out.stat().st_size > 1000


def test_sdk_branch_call_sequence(tmp_path, monkeypatch):
    calls = []
    rr = types.ModuleType("rerun")

    def rec(name):
        return lambda *a, **k: calls.append((name, a, k))

    for fn in ("init", "save", "spawn", "log_static", "set_time_sequence", "log"):
        setattr(rr, fn, rec(fn))
    for cls in ("SeriesLine", "LineStrips3D", "Points3D", "TextLog", "Scalar"):
        setattr(rr, cls, rec(cls))
    monkeypatch.setitem(sys.modules, "rerun", rr)
    monkeypatch.setenv("SUPERSLAM_RRD", str(tmp_path / "run.rrd"))
    from superslam_tpu_torch.io.viewer import RerunViewer

    v = RerunViewer()
    assert any(c[0] == "save" for c in calls) and not any(c[0] == "spawn" for c in calls)
    assert sum(c[0] == "log_static" for c in calls) == 2
    v.draw_frame(_frame(), Pose3(t=np.array([1.0, 0, 0])), _calib())
    v.plot("loop_deep_score", 0.7)
    v.log_info("loop", "accepted")
    v.close()
    paths = [c[1][0] for c in calls if c[0] == "log"]
    assert "world/trajectory" in paths and "world/cloud" in paths
    assert "plots/loop_deep_score" in paths and "logs/loop" in paths
    assert not list(tmp_path.glob("*.png"))  # SDK active: no fallback plot


def test_facade_use_viewer_forces_depth_0_and_draws(tmp_path, monkeypatch):
    from superslam_tpu_torch.slam import SuperSLAM

    monkeypatch.setenv("SUPERSLAM_VIEWER_PLOT", str(tmp_path / "traj.png"))
    monkeypatch.delenv("SUPERSLAM_PIPELINE", raising=False)  # the default depth 3
    monkeypatch.delitem(sys.modules, "rerun", raising=False)
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text("\n".join([
        "Camera.fx: 80.0", "Camera.fy: 80.0", "Camera.cx: 80.0", "Camera.cy: 60.0",
        "Camera.bf: 8.0", "Camera.width: 160", "Camera.height: 120",
        "superpoint:", "  max_keypoints: 96", "  keypoint_threshold: 0.0005",
        "lightglue:", "  image_width: 160", "  image_height: 120",
        "Backend.window_size: 4",
    ]))
    assert SuperSLAM(str(cfg), device="cpu")._tracker is not None  # without it: pipelined
    slam = SuperSLAM(str(cfg), use_viewer=True, device="cpu")
    assert slam.viewer is not None and slam._tracker is None
    rng = np.random.default_rng(0)
    base = rng.uniform(0, 255, (152, 192)).astype(np.uint8)
    for i in range(3):
        left = base[i : i + 120, 2 * i : 2 * i + 160]
        slam.track_stereo(left, np.roll(left, -4, axis=1), 0.1 * i)
    assert len(slam.viewer._traj) == 3
    ratios = [v for _, v in slam.viewer._scalars["frontend_inlier_ratio"]]
    assert len(ratios) == 3 and all(0.0 <= v <= 1.0 for v in ratios)
    slam.shutdown()
    assert (tmp_path / "traj.png").exists()

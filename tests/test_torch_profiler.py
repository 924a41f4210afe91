"""The port's host scopes (``utils/profiler.py``): the accumulator under
``SUPERSLAM_PROFILE`` and its switch, the span recording (parents, roots,
threads, the clock it shares with the profiler's trace), the scope's cost
with both off, and the span tree one fused step records on the CPU."""

import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from superslam_tpu_torch.utils import profiler as prof

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def quiet():
    """Switch off, no recording, an empty accumulator; restored after."""
    was = prof.Profiler.enabled()
    acc = prof.Profiler.instance()
    saved = acc.stats()
    prof.set_enabled(False)
    prof.stop_recording()
    with acc._lock:
        acc._acc.clear()
    yield acc
    prof.stop_recording()
    prof.set_enabled(was)
    with acc._lock:
        acc._acc.clear()
        acc._acc.update(saved)


def test_off_scope_records_nothing_and_reads_no_environment(quiet, monkeypatch):
    def no_env(*_a, **_k):
        raise AssertionError("a scope read the environment")

    monkeypatch.setattr(os.environ, "get", no_env)
    monkeypatch.setattr(os, "getenv", no_env)
    first = prof.profile_scope("a")
    with first:
        with prof.profile_scope("b"):
            pass
    assert prof.profile_scope("c") is first  # one shared no-op object
    assert quiet.stats() == {}
    assert prof.stop_recording() == []


def test_set_enabled_switches_the_accumulator(quiet):
    prof.set_enabled(True)
    assert prof.Profiler.enabled()
    with prof.profile_scope("on"):
        pass
    prof.set_enabled(False)
    assert not prof.Profiler.enabled()
    with prof.profile_scope("off"):
        pass
    stats = quiet.stats()
    assert set(stats) == {"on"} and stats["on"][1] == 1 and stats["on"][0] >= 0.0


def test_nested_spans_parent_root_and_threads(quiet):
    gate = threading.Barrier(2, timeout=30)

    def worker():
        with prof.profile_scope("w.outer"):
            gate.wait()  # inside main's "outer" span: must not nest into it
            with prof.profile_scope("w.inner"):
                gate.wait()

    prof.start_recording()
    t = threading.Thread(target=worker)
    with prof.profile_scope("outer"):
        t.start()
        with prof.profile_scope("mid"):
            gate.wait()
            with prof.profile_scope("inner"):
                gate.wait()
        with prof.profile_scope("mid2"):
            pass
    t.join(timeout=30)
    assert not t.is_alive()
    with prof.profile_scope("second"):
        pass
    spans = prof.stop_recording()
    by = {s[0]: (i, s) for i, s in enumerate(spans)}
    assert set(by) == {"outer", "mid", "inner", "mid2", "w.outer", "w.inner", "second"}
    assert [s[1] for s in spans] == sorted(s[1] for s in spans)  # start order

    def check(name, parent, root):
        i, (_n, a, b, p, r, _th) = by[name]
        assert a <= b
        assert p == (by[parent][0] if parent else -1), name
        assert r == (by[root][0] if root else i), name

    check("outer", None, None)
    check("mid", "outer", "outer")
    check("inner", "mid", "outer")
    check("mid2", "outer", "outer")
    check("w.outer", None, None)
    check("w.inner", "w.outer", "w.outer")
    check("second", None, None)
    assert by["w.inner"][1][5] == by["w.outer"][1][5] == t.ident
    assert by["outer"][1][5] == threading.get_ident()
    # every child lies inside its parent
    for _n, a, b, p, _r, _th in spans:
        if p >= 0:
            assert spans[p][1] <= a <= b <= spans[p][2]
    assert quiet.stats() == {}  # a recording adds nothing to the accumulator


def test_recording_turns_scopes_on_without_the_variable(quiet):
    assert not prof.Profiler.enabled()
    prof.start_recording()
    with prof.profile_scope("x"):
        pass
    spans = prof.stop_recording()
    assert [s[0] for s in spans] == ["x"]
    assert prof.stop_recording() == []
    assert quiet.stats() == {}
    # off again: the shared no-op
    assert prof.profile_scope("z") is prof.profile_scope("w")


def test_accumulator_and_recording_together(quiet):
    prof.set_enabled(True)
    prof.start_recording()
    with prof.profile_scope("both"):
        time.sleep(0.002)
    spans = prof.stop_recording()
    total, n = quiet.stats()["both"]
    assert n == 1 and total >= 1.5
    assert len(spans) == 1 and spans[0][2] - spans[0][1] >= 1_500_000


def test_stats_and_the_dump_at_exit_under_the_variable():
    code = (
        "import time\n"
        "from superslam_tpu_torch.utils.profiler import Profiler, profile_scope\n"
        "assert Profiler.enabled()\n"
        "for _ in range(3):\n"
        "    with profile_scope('vo_track_total'):\n"
        "        time.sleep(0.001)\n"
        "total, n = Profiler.instance().stats()['vo_track_total']\n"
        "assert n == 3 and total >= 2.5, (total, n)\n"
        "print('body done')\n"
    )
    env = {**os.environ, "SUPERSLAM_PROFILE": "1", "PYTHONPATH": REPO}
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0] == "body done"
    assert lines[1] == "== superslam_tpu profile =="
    assert lines[2].split()[0] == "vo_track_total" and "n=3" in lines[2]
    # without the variable, scopes are off and nothing is dumped
    env.pop("SUPERSLAM_PROFILE")
    code_off = code.replace("assert Profiler.enabled()\n", "assert not Profiler.enabled()\n")
    code_off = code_off.replace("total, n = Profiler.instance().stats()['vo_track_total']\n"
                                "assert n == 3 and total >= 2.5, (total, n)\n",
                                "assert Profiler.instance().stats() == {}\n")
    out = subprocess.run([sys.executable, "-c", code_off], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.splitlines() == ["body done"]


def test_spans_share_the_profilers_clock(quiet):
    """A ``record_function`` event opened inside a span lies inside the
    span's [start_ns, end_ns] on the profiler's own timestamps."""
    from torch.profiler import ProfilerActivity, profile, record_function

    prof.start_recording()
    with profile(activities=[ProfilerActivity.CPU]) as p:
        with prof.profile_scope("span"):
            with record_function("inside"):
                time.sleep(0.001)
    (_n, a, b, *_), = prof.stop_recording()
    events = [e for e in p.profiler.kineto_results.events() if e.name() == "inside"]
    assert len(events) == 1
    assert a <= events[0].start_ns() <= events[0].end_ns() <= b


# -- the span tree of one fused step on the CPU ---------------------------------

W, H, K = 64, 48, 32


@pytest.fixture
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _weights():
    from superslam_tpu_torch.models.weights import load_safetensors

    return (load_safetensors(os.path.join(REPO, "weights", "superpoint_render.safetensors")),
            load_safetensors(os.path.join(REPO, "weights", "lightglue_synth.safetensors")))


def _tree(spans):
    """(depth, name) of each span in start order."""
    depth = []
    for _n, _a, _b, p, _r, _t in spans:
        depth.append(0 if p < 0 else depth[p] + 1)
    return [(d, s[0]) for d, s in zip(depth, spans)]


def _images(n, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, 256, (n, H, W), dtype=np.uint8))


def _kf():
    return torch.rand(K, 2) * torch.tensor([W, H]), torch.randn(K, 256), torch.ones(K, dtype=bool)


STEP_TREE = [
    (0, "step"), (1, "detect"), (1, "select"), (1, "match"), (2, "match.assign"),
    (1, "extract"), (1, "pack"),
]


def test_fused_stereo_step_multi_span_tree(quiet, two_threads):
    from superslam_tpu_torch.ops.frontend_step import fused_stereo_step_multi

    sp, lg = _weights()
    prof.start_recording()
    fused_stereo_step_multi(
        sp, lg, _images(4), *_kf(), max_keypoints=K, keypoint_threshold=0.005,
        remove_borders=4, nms_radius=4, true_width=W, true_height=H, min_disparity=1.0,
        match_threshold=0.1)
    spans = prof.stop_recording()
    # the stereo gates and the packing are two ``pack`` spans
    assert _tree(spans) == STEP_TREE + [(1, "pack")]
    assert len({s[4] for s in spans}) == 1  # one root: the step


def test_fused_rgbd_step_multi_span_tree(quiet, two_threads):
    from superslam_tpu_torch.ops.rgbd_step import fused_rgbd_step_multi

    sp, lg = _weights()
    prof.start_recording()
    fused_rgbd_step_multi(
        sp, lg, _images(2, seed=1), *_kf(), max_keypoints=K, keypoint_threshold=0.005,
        remove_borders=4, nms_radius=4, true_width=W, true_height=H, match_threshold=0.1)
    spans = prof.stop_recording()
    assert _tree(spans) == STEP_TREE


def test_fused_rgbd_track_step_multi_span_tree(quiet, two_threads):
    """The device-tracked RGB-D step: its own ``step`` around the front
    end's and the pose chain's ``track``."""
    from superslam_tpu_torch.ops.rgbd_step import fused_rgbd_track_step_multi

    sp, lg = _weights()
    eye, zero = torch.eye(3), torch.zeros(3)
    xw = torch.cat([torch.randn(K, 2), torch.full((K, 1), 5.0)], dim=1)
    prof.start_recording()
    fused_rgbd_track_step_multi(
        sp, lg, _images(2, seed=2), *_kf(), xw, torch.ones(K, dtype=bool), eye, zero, eye, zero,
        max_keypoints=K, keypoint_threshold=0.005, remove_borders=4, nms_radius=4,
        true_width=W, true_height=H, match_threshold=0.1,
        calib=(50.0, 50.0, W / 2, H / 2, 0.1), min_matches=10, track_sigma_px=10.0)
    spans = prof.stop_recording()
    assert _tree(spans) == [(0, "step")] + [(d + 1, n) for d, n in STEP_TREE] + [(1, "track")]
    assert len({s[4] for s in spans}) == 1

"""The port's pipelined stereo tracker (frontend/pipelined.py) on the CPU.

Fixture: tests/test_device_kf.py's, in both packages: a rendered sprite
room at 160x120 close enough for real stereo disparity, 12 frames of a
sideways-sliding camera, K = 128, SuperPoint from init_superpoint_params(0)
(the same weights in both packages, tests/test_torch_weights.py) and the
analytic passthrough LightGlue.

- Host-solved, the pipelined trajectory (depth 2 and 3, batch 1 and 2)
  agrees with the synchronous loop's within the bounds the JAX package
  holds its own pair to (tests/test_fused_pipeline.py: 0.2 m at batch 1,
  0.25 m batched); the gap is printed.
- Device keyframes against the JAX package's tracker on the same frames,
  both steps bound to f32 and the unfused LightGlue route: the same
  keyframes, inserted at the same frames by the same promotion bits, and
  per-frame positions within POSITION_GAP_M wherever the two device solves
  made the same accept decision. Random SuperPoint weights track poorly
  (every mode lands metres from ground truth on this fixture), so the
  comparison is package against package. The two f32 front ends differ by
  the order of their sums only, but a frame here keeps 5-8 usable matches
  against a floor of 5, so one support count that flips (2 of 5 against 3
  of 5) turns a solve from accepted to coasted and moves that frame's pose
  by up to ~1 m: at most MAX_ACCEPT_FLIPS frames may differ in that bit
  (one does, frame 4). On identical inputs the two scans agree to 1e-4
  (tests/test_torch_frontend_step.py).
- The lockstep contract of tests/test_device_kf.py: promotions drive the
  insertions after the first, and set_keyframe_world never runs.
- Dispatch-frozen mode (SUPERSLAM_DEVICE_KF=0) runs, re-anchors its carry
  on host poses at every dispatch and uploads every keyframe's world points.
- A failing device-keyframe dispatch raises: there is no fallback.
"""

import functools

import numpy as np
import pytest
import torch

from superslam_tpu_torch.core.vo_estimator import VoEstimator
from superslam_tpu_torch.eval.synthetic_sequence import make_room_world, render_stereo
from superslam_tpu_torch.frontend.fused import FusedStereoPipeline
from superslam_tpu_torch.frontend.matcher import LightGlueMatcher
from superslam_tpu_torch.frontend.pipelined import PipelinedStereoTracker
from superslam_tpu_torch.geometry.se3 import Pose3
from superslam_tpu_torch.geometry.stereo_camera import StereoCalib
from superslam_tpu_torch.models.lightglue import init_lightglue_params
from superslam_tpu_torch.models.superpoint import init_superpoint_params

W, H, K, N_FRAMES = 160, 120, 128, 12
POSITION_GAP_M = 1e-3
MAX_ACCEPT_FLIPS = 1


@pytest.fixture(scope="module")
def setup():
    calib = StereoCalib(fx=80.0, fy=80.0, cx=80.0, cy=60.0, baseline=0.5)
    sp = init_superpoint_params(0)
    lg = init_lightglue_params(0, passthrough=True)
    matcher = LightGlueMatcher(lg, image_width=W, image_height=H, max_keypoints=K, device="cpu")
    world = make_room_world(
        np.random.default_rng(0), half_x=3.0, half_z=3.0, n_sprites=240, sprite_half=(0.18, 0.3)
    )
    poses = [Pose3(t=np.array([0.12 * i, 0.0, -1.5 + 0.08 * i])) for i in range(N_FRAMES)]
    seq = []
    for p in poses:
        left, right = render_stereo(world, p, calib, H, W)
        seq.append(((left * 255).astype(np.uint8), (right * 255).astype(np.uint8)))
    return calib, sp, lg, matcher, seq


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads: the suite runs several workers on one host, and
    more threads than cores slow every worker down."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def synchronous(setup):
    """The synchronous loop's trajectory and keyframe count (the floor of 5
    matches set here, as low_floor does)."""
    calib, _, _, matcher, seq = setup
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SUPERSLAM_TRACK_MIN_MATCHES", "5")
        fused = _pipeline(setup)
        est = VoEstimator(matcher, calib, window_size=4)
        for i, (left, right) in enumerate(seq):
            frame, m = fused.process(left, right, 0.1 * i)
            est.track(frame, kf_matches=m)
            if est._last_keyframe is frame:
                fused.set_keyframe(frame.descriptors_left)
    return est.corrected_trajectory(), est._next_keyframe_id


@pytest.fixture()
def low_floor(monkeypatch):
    # ~20 depth-valid keypoints a rendered frame at this tiny resolution;
    # the default floor of 10 would coast through legitimate solves.
    monkeypatch.setenv("SUPERSLAM_TRACK_MIN_MATCHES", "5")


def _pipeline(setup):
    calib, sp, lg, _, _ = setup
    return FusedStereoPipeline(
        sp, lg, calib, width=W, height=H, max_keypoints=K, keypoint_threshold=5e-4, device="cpu"
    )


def _run_tracker(tracker, seq):
    for i, (left, right) in enumerate(seq):
        tracker.track(left, right, 0.1 * i)
    tracker.flush()
    return tracker.estimator.corrected_trajectory()


def _spy_insertions(est, accepts=None):
    """Record (frame index, device_promote) of every frame that became a
    keyframe, and each frame's device_accept into ``accepts``."""
    inserted, calls = [], []
    orig = est.track

    def spy(frame, *a, **kw):
        r = orig(frame, *a, **kw)
        if est._last_keyframe is frame:
            inserted.append((len(calls), bool(kw.get("device_promote"))))
        calls.append(1)
        if accepts is not None:
            accepts.append(kw.get("device_accept"))
        return r

    est.track = spy
    return inserted


@pytest.mark.parametrize("depth,batch", [(2, 1), (3, 1), (2, 2), (3, 2)])
def test_host_solved_pipelined_equals_synchronous(setup, synchronous, low_floor, depth, batch):
    calib, _, _, matcher, seq = setup
    ta, n_kf = synchronous
    est_b = VoEstimator(matcher, calib, window_size=4)
    tracker = PipelinedStereoTracker(_pipeline(setup), est_b, depth=depth, batch=batch)
    assert not tracker.device_tracking
    assert est_b._kf_store_size >= depth * batch + 2
    tb = _run_tracker(tracker, seq)
    gap = [float(np.linalg.norm(a.t - b.t)) for a, b in zip(ta, tb)]
    print(f"depth {depth} batch {batch}: pipelined vs synchronous position gap max "
          f"{max(gap):.3g} m; keyframes {n_kf} / {est_b._next_keyframe_id}")
    assert len(ta) == len(tb) == len(seq)
    assert max(gap) < (0.2 if batch == 1 else 0.25), gap


def _f32_steps(monkeypatch):
    """Bind both packages' steps to f32 models on the unfused LightGlue
    route (module attributes rebound for the test; JAX retraces)."""
    import jax
    import jax.numpy as jnp

    import superslam_tpu.ops.frontend_step as jstep
    import superslam_tpu_torch.ops.frontend_step as tstep

    for mod, dtype in ((jstep, jnp.float32), (tstep, torch.float32)):
        monkeypatch.setattr(
            mod, "superpoint_dense", functools.partial(mod.superpoint_dense, compute_dtype=dtype))
        monkeypatch.setattr(
            mod, "lightglue_forward",
            functools.partial(mod.lightglue_forward, compute_dtype=dtype, fused=False))
    jax.clear_caches()


def test_device_kf_matches_jax(setup, low_floor, monkeypatch):
    from superslam_tpu.core.vo_estimator import VoEstimator as JaxVoEstimator
    from superslam_tpu.frontend.fused import FusedStereoPipeline as JaxPipeline
    from superslam_tpu.frontend.matcher import LightGlueMatcher as JaxMatcher
    from superslam_tpu.frontend.pipelined import PipelinedStereoTracker as JaxTracker
    from superslam_tpu.geometry import StereoCalib as JaxCalib
    from superslam_tpu.models.lightglue import init_lightglue_params as jax_lg_init
    from superslam_tpu.models.superpoint import init_superpoint_params as jax_sp_init

    import jax

    calib, _, _, matcher, seq = setup
    _f32_steps(monkeypatch)

    est = VoEstimator(matcher, calib, window_size=4)
    acc = []
    ins = _spy_insertions(est, acc)
    tracker = PipelinedStereoTracker(_pipeline(setup), est, depth=2, device_tracking=True)
    assert tracker.device_kf
    traj = _run_tracker(tracker, seq)

    jcalib = JaxCalib(fx=80.0, fy=80.0, cx=80.0, cy=60.0, baseline=0.5)
    jlg = jax_lg_init(0, passthrough=True)
    jest = JaxVoEstimator(
        JaxMatcher(jlg, image_width=W, image_height=H, max_keypoints=K), jcalib, window_size=4
    )
    jacc = []
    jins = _spy_insertions(jest, jacc)
    jpipe = JaxPipeline(
        jax_sp_init(0), jlg, jcalib, width=W, height=H, max_keypoints=K, keypoint_threshold=5e-4
    )
    jtracker = JaxTracker(jpipe, jest, depth=2, device_tracking=True)
    jtraj = _run_tracker(jtracker, seq)
    jax.clear_caches()  # drop the f32-bound traces

    gap = [float(np.linalg.norm(a.t - b.t)) for a, b in zip(traj, jtraj)]
    flips = [i for i, (a, b) in enumerate(zip(acc, jacc)) if a != b]
    same = [g for i, g in enumerate(gap) if i not in flips]
    print(f"device keyframes, port vs JAX: insertions {ins} / {jins}; accept bits {acc} / "
          f"{jacc}; per-frame position gap max {max(same):.3g} m where they agree, "
          f"{[round(gap[i], 4) for i in flips]} m where they differ")
    assert jtracker.device_kf, "the JAX tracker fell back to dispatch-frozen tracking"
    assert len(traj) == len(jtraj) == len(seq)
    assert ins == jins
    assert any(promo for _, promo in ins), "no device promotion fired"
    assert len(flips) <= MAX_ACCEPT_FLIPS, flips
    assert max(same) <= POSITION_GAP_M, gap


@pytest.mark.parametrize("batch", [1, 2])
def test_device_kf_lockstep(setup, low_floor, batch):
    """Every keyframe after lockstep is established is device-promoted, and
    the per-insertion keyframe upload never runs (the keyframe stays on the
    device; the only host-built keyframe state is _seed_kf_state)."""
    calib, _, _, matcher, seq = setup
    fused = _pipeline(setup)
    uploads = []
    orig_upload = fused.set_keyframe_world
    fused.set_keyframe_world = lambda f: uploads.append(1) or orig_upload(f)
    est = VoEstimator(matcher, calib, window_size=4)
    ins = _spy_insertions(est)
    tracker = PipelinedStereoTracker(fused, est, depth=2, batch=batch, device_tracking=True)
    traj = _run_tracker(tracker, seq)

    assert not uploads
    assert len(traj) == len(seq) and all(np.isfinite(p.t).all() for p in traj)
    promoted = [p for _, p in ins]
    assert len(promoted) >= 2, ins  # the first keyframe + at least one promotion
    assert promoted[0] is False  # the bootstrap insertion is the host's
    first_dev = promoted.index(True)
    assert all(promoted[first_dev:]), f"host-initiated insertion after lockstep: {ins}"
    assert tracker.reseeds >= 1


def test_dispatch_frozen_reanchors(setup, low_floor, monkeypatch):
    """SUPERSLAM_DEVICE_KF=0: every dispatch re-anchors the device pose chain
    on host poses, and every keyframe's world points are uploaded."""
    monkeypatch.setenv("SUPERSLAM_DEVICE_KF", "0")
    calib, _, _, matcher, seq = setup
    fused = _pipeline(setup)
    uploads = []
    orig_upload = fused.set_keyframe_world
    fused.set_keyframe_world = lambda f: uploads.append(1) or orig_upload(f)
    est = VoEstimator(matcher, calib, window_size=4)
    ins = _spy_insertions(est)
    tracker = PipelinedStereoTracker(fused, est, depth=2, device_tracking=True)
    assert tracker.device_tracking and not tracker.device_kf
    anchors = []
    orig_carry = tracker._pose_carry
    tracker._pose_carry = lambda: anchors.append(tracker._last_pose) or orig_carry()
    traj = _run_tracker(tracker, seq)

    assert len(traj) == len(seq) and all(np.isfinite(p.t).all() for p in traj)
    assert len(anchors) == len(seq)  # one dispatch a frame at batch 1
    assert len(uploads) == len(ins) >= 2
    assert tracker.reseeds == 0


def test_failing_kf_dispatch_raises(setup, low_floor, monkeypatch):
    import superslam_tpu_torch.ops.frontend_step as tstep

    def broken(*a, **kw):
        raise RuntimeError("device-kf step failed")

    monkeypatch.setattr(tstep, "fused_stereo_track_kf_step_multi", broken)
    calib, _, _, matcher, seq = setup
    tracker = PipelinedStereoTracker(
        _pipeline(setup), VoEstimator(matcher, calib, window_size=4), depth=2,
        device_tracking=True,
    )
    with pytest.raises(RuntimeError, match="device-kf step failed"):
        _run_tracker(tracker, seq)
    assert tracker.device_kf  # no silent switch to dispatch-frozen tracking

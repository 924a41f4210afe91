"""The port's pose-only LM and tracking chain (ops/pose_solver.py,
ops/frontend_step.py::track_scan) against the JAX package's on the same
numpy inputs, in f32 on the CPU, and against the port's own f64 host
tracker (core/frame_tracker.py), mirroring tests/test_pose_solver.py and
the stereo cases of tests/test_track_scan.py.

Port against JAX: translation within 1e-4 m and rotation within 1e-4 rad
(both run the same f32 algorithm; sums and the 6x6 solve round in another
order), match counts equal. The outlier-laden LM case is held to 1e-3:
Huber's reweighting amplifies f32 rounding there."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from superslam_tpu.ops.frontend_step import track_scan as jax_track_scan
from superslam_tpu.ops.pose_solver import pose_only_lm as jax_pose_only_lm
from superslam_tpu_torch.core.factors import stereo_diag_sigmas
from superslam_tpu_torch.core.frame_tracker import FrameTracker
from superslam_tpu_torch.geometry import Pose3, StereoCalib, stereo_project
from superslam_tpu_torch.ops.frontend_step import TRACK_COLS, track_scan
from superslam_tpu_torch.ops.pose_solver import pose_only_lm_impl

BIG = StereoCalib(fx=500.0, fy=500.0, cx=320.0, cy=240.0, baseline=0.5)
CAL = StereoCalib(fx=80.0, fy=80.0, cx=80.0, cy=60.0, baseline=0.1)
CALT = (80.0, 80.0, 80.0, 60.0, 0.1)
K = 64


def _pose(R, t) -> Pose3:
    return Pose3(np.asarray(R, np.float64).reshape(3, 3), np.asarray(t, np.float64))


def _gap(a: Pose3, b: Pose3) -> tuple[float, float]:
    """(translation gap in m, rotation gap in rad)."""
    return float(np.linalg.norm(a.t - b.t)), float(np.linalg.norm(a.between(b).logmap()[:3]))


def _assert_close(a: Pose3, b: Pose3, tol=1e-4):
    dt, dr = _gap(a, b)
    assert dt < tol and dr < tol, (dt, dr)


@pytest.fixture
def numpy_tracker(monkeypatch):
    monkeypatch.setenv("SUPERSLAM_NATIVE", "0")  # the numpy oracle, not the C++ core


# -- pose_only_lm ---------------------------------------------------------------


def _solve_both(init: Pose3, Xw, meas, n_pad=128):
    n = Xw.shape[0]
    sig = stereo_diag_sigmas(10.0, meas[:, 0] - meas[:, 1], BIG.bf)
    Xp = np.zeros((n_pad, 3), np.float32)
    Mp = np.zeros((n_pad, 3), np.float32)
    Sp = np.ones((n_pad, 3), np.float32)
    Vp = np.zeros(n_pad, np.float32)
    Xp[:n], Mp[:n], Sp[:n], Vp[:n] = Xw, meas, 1.0 / sig, 1.0
    args = [init.R.astype(np.float32), init.t.astype(np.float32), Xp, Mp, Sp, Vp]
    calib = (BIG.fx, BIG.fy, BIG.cx, BIG.cy, BIG.baseline)
    jR, jt = jax_pose_only_lm(*(jnp.asarray(a) for a in args), calib)
    tR, tt = pose_only_lm_impl(*(torch.from_numpy(a) for a in args), calib)
    assert tR.dtype == torch.float32 and tt.shape == (3,)
    return _pose(tR.numpy(), tt.numpy()), _pose(jR, jt)


def test_pose_only_lm_matches_jax_and_numpy_tracker_clean():
    rng = np.random.default_rng(0)
    true_pose = Pose3.expmap(np.array([0.02, -0.01, 0.03, 0.4, -0.1, 0.2]))
    Xw = true_pose.transform_from(rng.uniform([-4, -3, 4], [4, 3, 25], size=(50, 3)))
    meas = np.stack([stereo_project(true_pose, BIG, x) for x in Xw])
    got, ref = _solve_both(Pose3(), Xw, meas)
    _assert_close(got, ref)
    est_np = FrameTracker(BIG).track_arrays(Pose3(), Xw, meas)
    assert np.linalg.norm(got.t - true_pose.t) < 1e-3
    assert np.linalg.norm(got.t - est_np.t) < 1e-3
    assert np.abs(got.R - est_np.R).max() < 1e-4


def test_pose_only_lm_matches_jax_and_numpy_tracker_with_outliers():
    rng = np.random.default_rng(1)
    true_pose = Pose3(t=np.array([0.5, 0.0, 0.1]))
    Xw = true_pose.transform_from(rng.uniform([-4, -3, 4], [4, 3, 25], size=(60, 3)))
    meas = np.stack([stereo_project(true_pose, BIG, x) for x in Xw])
    meas[::6] += rng.uniform(40, 80, meas[::6].shape) * rng.choice([-1, 1], meas[::6].shape)
    got, ref = _solve_both(Pose3(), Xw, meas)
    _assert_close(got, ref, tol=1e-3)
    est_np = FrameTracker(BIG).track_arrays(Pose3(), Xw, meas)
    # f32 tensors vs the f64 host solve: same basin, centimetre agreement.
    assert np.linalg.norm(got.t - est_np.t) < 2e-2


def test_pose_only_lm_padding_mask_ignored():
    """Garbage rows behind the validity mask must not change the solve."""
    rng = np.random.default_rng(2)
    true_pose = Pose3(t=np.array([0.3, 0.1, 0.0]))
    Xw = true_pose.transform_from(rng.uniform([-4, -3, 4], [4, 3, 20], size=(30, 3)))
    meas = np.stack([stereo_project(true_pose, BIG, x) for x in Xw])
    a, ja = _solve_both(Pose3(), Xw, meas, n_pad=64)
    b, _ = _solve_both(Pose3(), Xw, meas, n_pad=256)
    assert np.linalg.norm(a.t - b.t) < 1e-4
    _assert_close(a, ja)


# -- track_scan -----------------------------------------------------------------


def project(pose: Pose3, Xw: np.ndarray) -> np.ndarray:
    p = pose.transform_to(Xw)
    z = p[:, 2]
    uL = CAL.fx * p[:, 0] / z + CAL.cx
    uR = CAL.fx * (p[:, 0] - CAL.baseline) / z + CAL.cx
    v = CAL.fy * p[:, 1] / z + CAL.cy
    return np.stack([uL, uR, v], axis=1)


def scan_both(frames_meas, track_ms, xw, depth_ok=None, carry=None, min_matches=10, **kw):
    """Run both packages' track_scan on per-frame (K, 3) stereo measurements
    in FRAME keypoint order. Returns (port rows, JAX rows, port carry, JAX
    carry) as numpy; asserts the two agree within 1e-4 and count the same
    matches."""
    kl = np.stack([np.stack([m[:, 0], m[:, 2]], 1) for m in frames_meas]).astype(np.float32)
    disp = np.stack([m[:, 0] - m[:, 1] for m in frames_meas]).astype(np.float32)
    if kw.get("mono") and "disparity" in kw:
        disp = kw.pop("disparity")
    ok = np.ones(disp.shape, bool)
    tm = np.stack(track_ms).astype(np.int32)
    depth_ok = np.ones(K, bool) if depth_ok is None else depth_ok
    if carry is None:
        eye, zero = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
        carry = (eye, zero, eye, zero)
    args = [kl, disp, ok, tm, np.asarray(xw, np.float32), depth_ok]
    kw = dict(
        dict(calib=CALT, min_matches=min_matches, track_sigma_px=10.0, disp_sigma0=8.0,
             disp_cond=CAL.bf / 40.0), **kw)
    jout, jcarry = jax_track_scan(
        *(jnp.asarray(a) for a in args), tuple(jnp.asarray(c) for c in carry), **kw)
    tout, tcarry = track_scan(
        *(torch.from_numpy(a) for a in args), tuple(torch.from_numpy(np.array(c)) for c in carry),
        **kw)
    tout, jout = tout.numpy(), np.asarray(jout)
    assert tout.shape == jout.shape == (len(frames_meas), TRACK_COLS)
    np.testing.assert_array_equal(tout[:, 12], jout[:, 12])
    for trow, jrow in zip(tout, jout):
        _assert_close(rows_to_pose(trow), rows_to_pose(jrow))
    tcarry = tuple(c.numpy() for c in tcarry)
    jcarry = tuple(np.asarray(c) for c in jcarry)
    for tc, jc in zip(tcarry, jcarry):
        np.testing.assert_allclose(tc, jc, atol=1e-4, rtol=0)
    return tout, jout, tcarry, jcarry


def rows_to_pose(row) -> Pose3:
    return _pose(row[:9], row[9:12])


def test_track_scan_recovers_chained_poses():
    rng = np.random.default_rng(3)
    Xw = rng.uniform([-4, -3, 6], [4, 3, 18], (K, 3))
    true = [
        Pose3.expmap(np.array([0.0, 0.01, 0.0, 0.15, 0.0, 0.02])),
        Pose3.expmap(np.array([0.01, 0.02, 0.0, 0.30, -0.05, 0.04])),
        Pose3.expmap(np.array([0.02, 0.03, -0.01, 0.45, -0.1, 0.06])),
    ]
    # Frame keypoint order is a per-frame shuffle of the landmark order;
    # track_m[i] = where landmark i landed in the frame's keypoint list.
    metas, tms = [], []
    for pose in true:
        perm = rng.permutation(K)
        inv = np.empty(K, np.int64)
        inv[perm] = np.arange(K)
        metas.append(project(pose, Xw)[perm])
        tms.append(inv)
    out, _, carry, _ = scan_both(metas, tms, Xw)
    for s, pose in enumerate(true):
        assert int(out[s, 12]) == K
        assert np.linalg.norm(pose.between(rows_to_pose(out[s])).logmap()) < 1e-3
    np.testing.assert_allclose(carry[1], true[-1].t, atol=1e-3)


def test_track_scan_matches_host_tracker_with_noise(numpy_tracker):
    """With pixel noise the tensor solve must agree with FrameTracker (the
    f64 oracle), gating disabled on both sides: this pins the core LM."""
    rng = np.random.default_rng(4)
    Xw = rng.uniform([-4, -3, 6], [4, 3, 18], (K, 3))
    true = Pose3.expmap(np.array([0.0, 0.02, 0.0, 0.2, -0.05, 0.03]))
    meas = project(true, Xw) + rng.normal(0, 0.5, (K, 3))
    out, *_ = scan_both([meas], [np.arange(K)], Xw, gate_px=0.0, chi2_rounds=0)
    ref = FrameTracker(CAL).track_arrays(Pose3(), Xw, meas)
    assert np.linalg.norm(ref.between(rows_to_pose(out[0])).logmap()) < 2e-3


def test_track_scan_gated_matches_host_track_gated(numpy_tracker):
    """The prior gate + chi2 re-rounds against the numpy oracle recipe
    (FrameTracker.track_gated) on data with noise and structured
    mismatches: same kept-set decisions, same optimum."""
    rng = np.random.default_rng(9)
    Xw = rng.uniform([-4, -3, 6], [4, 3, 18], (K, 3))
    true = Pose3.expmap(np.array([0.0, 0.02, 0.0, 0.2, -0.05, 0.03]))
    meas = project(true, Xw) + rng.normal(0, 0.3, (K, 3))
    bad = rng.choice(K, K // 4, replace=False)
    meas[bad] = meas[(bad + K // 2) % K]  # coherent mismatches
    out, *_ = scan_both([meas], [np.arange(K)], Xw, gate_px=10.0, chi2_px=2.0, chi2_rounds=2)
    got = rows_to_pose(out[0])
    ref, _keep = FrameTracker(CAL).track_gated(
        Pose3(), Xw, meas, gate_px=10.0, chi2_px=2.0, chi2_rounds=2, min_keep=10)
    assert np.linalg.norm(ref.between(got).logmap()) < 2e-3
    assert np.linalg.norm(true.between(got).logmap()) < 2e-2


def test_track_scan_gate_rejects_structured_outliers():
    """With ~35% coherent mismatches the ungated solve lands far off; the
    gated solve stays at the true pose."""
    rng = np.random.default_rng(10)
    Xw = rng.uniform([-4, -3, 6], [4, 3, 18], (K, 3))
    true = Pose3.expmap(np.array([0.01, 0.02, 0.0, 0.3, -0.05, 0.05]))
    meas = project(true, Xw)
    bad = rng.choice(K, int(0.35 * K), replace=False)
    meas[bad] = meas[(bad + K // 2) % K]
    out_g, *_ = scan_both([meas], [np.arange(K)], Xw, gate_px=10.0, chi2_px=2.0, chi2_rounds=2)
    out_u, *_ = scan_both([meas], [np.arange(K)], Xw, gate_px=0.0, chi2_rounds=0)
    e_gated = np.linalg.norm(true.between(rows_to_pose(out_g[0])).logmap())
    e_plain = np.linalg.norm(true.between(rows_to_pose(out_u[0])).logmap())
    assert e_gated < 5e-3, e_gated
    assert e_gated < 0.2 * max(e_plain, 1e-9), (e_plain, e_gated)


def test_track_scan_long_run_carry_stability():
    """60 frames in 10-frame calls with the carry threaded across calls:
    the chain must follow a long trajectory without drift blow-up and the
    carry rotation must stay on SO(3). Each package threads its own carry."""
    rng = np.random.default_rng(7)
    tcarry = None
    pose_prev = Pose3()
    lms = None
    worst = 0.0
    for dispatch in range(6):
        if dispatch % 2 == 0:  # "keyframe insertion": refresh the landmarks
            lms = pose_prev.transform_from(rng.uniform([-4, -3, 6], [4, 3, 18], (K, 3)))
        metas, truths = [], []
        for s in range(10):
            i = dispatch * 10 + s
            true = Pose3.expmap(np.array([0.0, 0.002 * i, 0.0, 0.08 * i, 0.01 * i, 0.0]))
            truths.append(true)
            metas.append(project(true, lms))
            pose_prev = true
        out, _, tcarry, _ = scan_both(metas, [np.arange(K)] * 10, lms, carry=tcarry)
        for s, true in enumerate(truths):
            worst = max(worst, np.linalg.norm(true.between(rows_to_pose(out[s])).logmap()))
    assert worst < 5e-3, worst
    R = np.asarray(tcarry[0], np.float64)
    assert np.abs(R.T @ R - np.eye(3)).max() < 1e-5


def test_track_scan_mono_ignores_uR():
    """mono=True: the uR residual row is weighted zero, so corrupting the
    disparity channel must not move the solution."""
    rng = np.random.default_rng(6)
    Xw = rng.uniform([-4, -3, 6], [4, 3, 18], (K, 3))
    true = Pose3.expmap(np.array([0.0, 0.02, 0.01, 0.25, -0.05, 0.03]))
    meas = project(true, Xw)
    kw = dict(mono=True, disp_sigma0=1.0, disp_cond=1.0)
    out1, *_ = scan_both([meas], [np.arange(K)], Xw, **kw)
    out2, *_ = scan_both(
        [meas], [np.arange(K)], Xw, disparity=np.zeros((1, K), np.float32), **kw)
    got1, got2 = rows_to_pose(out1[0]), rows_to_pose(out2[0])
    assert np.linalg.norm(true.between(got1).logmap()) < 1e-3
    assert np.linalg.norm(got1.between(got2).logmap()) < 1e-6


def test_track_scan_coasts_below_min_matches():
    rng = np.random.default_rng(5)
    Xw = rng.uniform([-4, -3, 6], [4, 3, 18], (K, 3))
    p1 = Pose3.expmap(np.array([0.0, 0.0, 0.0, 0.2, 0.0, 0.0]))
    m1 = project(p1, Xw)
    # Frame 2: tracking lost (no matches) -> constant velocity: pose = p1 * rel
    # where rel = identity.between(p1) = p1.
    m2 = np.zeros((K, 3))
    m2[:, 0] = 1.0  # disparity 1, irrelevant (masked)
    tms = [np.arange(K), np.full(K, -1, np.int64)]
    out, *_ = scan_both([m1, m2], tms, Xw)
    assert int(out[1, 12]) == 0
    assert np.linalg.norm((p1 * p1).between(rows_to_pose(out[1])).logmap()) < 1e-3
    # Depth-invalid KF features must not count as correspondences.
    depth_ok = np.ones(K, bool)
    depth_ok[: K // 2] = False
    out2, *_ = scan_both([m1, m2], tms, Xw, depth_ok=depth_ok)
    assert int(out2[0, 12]) == K - K // 2

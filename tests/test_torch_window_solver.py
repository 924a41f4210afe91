"""The port's device window solver (ops/window_solver.py) and the
smoother's SUPERSLAM_XLA_SMOOTHER=1 route against the JAX package's, on the
CPU.

Inputs: the `problem` fixture of tests/test_window_solver.py (copied), a
4-keyframe window of 24 landmarks seen from ground-truth poses 1 m apart,
the later three seeded off by one shared offset; tests/test_window_smoother
.py's 6-landmark window; tests/test_vo_loop_closure.py's square loop. Both
packages solve in f32 and sum in other orders (XLA against PyTorch's CPU
kernels), so results agree to f32 rounding of the solve's conditioning:
1e-4 (of max |.| for the reduced system) where the JAX tests hold the
f32 solver to its f64 oracle at 2e-3 to 2e-2.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from superslam_tpu.core.window_smoother import StereoObs as JStereoObs
from superslam_tpu.core.window_smoother import WindowSmoother as JWindowSmoother
from superslam_tpu.geometry import Pose3 as JPose3
from superslam_tpu.geometry import stereo_project
from superslam_tpu.ops import window_solver as jws
from superslam_tpu_torch.core.window_smoother import StereoObs, WindowSmoother
from superslam_tpu_torch.geometry import Pose3, StereoCalib
from superslam_tpu_torch.ops import window_solver as tws
from superslam_tpu_torch.ops.pose_solver import _retract, _se3_log

from helpers import make_calib

ATOL = 1e-4


@pytest.fixture
def problem():
    rng = np.random.default_rng(7)
    calib = make_calib()
    gt = [JPose3(t=np.array([float(i), 0.0, 0.0])) for i in range(4)]
    offset = JPose3.expmap(np.array([0.0, 0.0, 0.01, 0.05, -0.02, 0.04]))
    poses = [gt[0]] + [p * offset for p in gt[1:]]
    lms = rng.uniform([-5, -3, 6], [5, 3, 20], size=(24, 3))
    m = len(gt)
    views = np.tile(np.arange(m), (len(lms), 1)).astype(np.int32)
    meas = np.stack(
        [[stereo_project(g, calib, X) for g in gt] for X in lms]
    ).astype(np.float32)
    return calib, poses, lms, views, meas


def _ct(calib):
    return (calib.fx, calib.fy, calib.cx, calib.cy, calib.baseline)


def _Rt(poses):
    return (np.stack([p.R for p in poses]).astype(np.float32),
            np.stack([p.t for p in poses]).astype(np.float32))


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def test_triangulate_matches_jax(problem):
    calib, poses, _lms, views, meas = problem
    R, t = _Rt(poses)
    Xj, okj = jws.triangulate(*(jnp.asarray(a) for a in (R, t, views, meas)), _ct(calib))
    Xt, okt = tws.triangulate(*_t(R, t, views, meas), _ct(calib))
    assert okt.all() and np.array_equal(okt.numpy(), np.asarray(okj))
    np.testing.assert_allclose(Xt.numpy(), np.asarray(Xj), atol=ATOL)


@pytest.mark.parametrize("huber_k", [0.0, 1.0])
def test_reduced_system_matches_jax(problem, huber_k):
    calib, poses, lms, views, meas = problem
    R, t = _Rt(poses)
    lm_valid = np.ones(len(lms), bool)
    kw = dict(inv_sigma=1.0, dyn_outlier_px=1e9, num_poses=len(poses), huber_k=huber_k)
    Hj, bj, ej = jws.build_reduced_system(
        *(jnp.asarray(a) for a in (R, t, views, meas, lm_valid)), _ct(calib), **kw)
    Ht, bt, et = tws.build_reduced_system(*_t(R, t, views, meas, lm_valid), _ct(calib), **kw)
    Hj, bj = np.asarray(Hj), np.asarray(bj)
    np.testing.assert_allclose(Ht.numpy() / np.abs(Hj).max(), Hj / np.abs(Hj).max(), atol=ATOL)
    np.testing.assert_allclose(bt.numpy() / np.abs(bj).max(), bj / np.abs(bj).max(), atol=ATOL)
    assert float(et) == pytest.approx(float(ej), rel=ATOL)


def _solve_args(problem):
    calib, poses, lms, views, meas = problem
    R0, t0 = _Rt(poses)
    L, m = views.shape
    arrays = (R0, t0, views, meas, np.ones(L, bool), np.ones((L, m), bool))
    kw = dict(inv_sigma=1.0, dyn_outlier_px=1e9, prior_info=1e8, num_poses=4)
    return arrays, _ct(calib), kw


def test_solve_window_matches_jax_and_ground_truth(problem):
    arrays, ct, kw = _solve_args(problem)
    Rj, tj = jws.solve_window(*(jnp.asarray(a) for a in arrays), ct, max_iters=8, **kw)
    Rt, tt = tws.solve_window(*_t(*arrays), ct, max_iters=8, **kw)
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=ATOL)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=ATOL)
    for k in range(4):
        gt = np.array([float(k), 0.0, 0.0])
        for R, t in ((np.asarray(Rj), np.asarray(tj)), (Rt.numpy(), tt.numpy())):
            assert np.linalg.norm(t[k] - gt) < 0.05, (k, t[k])
            assert np.abs(R[k] - np.eye(3)).max() < 0.05


def test_obs_mask_equals_shorter_tracks(problem):
    """A padded (L, m) group with masked tail observations equals the exact
    shorter-track system (tests/test_window_solver.py's case on the port)."""
    calib, poses, _lms, views, meas = problem
    R, t = _Rt(poses)
    L = views.shape[0]
    kw = dict(inv_sigma=1.0, dyn_outlier_px=1e9, num_poses=4)
    H3, b3, _ = tws.build_reduced_system(
        *_t(R, t, views[:, :3], meas[:, :3], np.ones(L, bool)), _ct(calib), **kw)
    ov = np.ones((L, 4), bool)
    ov[:, 3] = False
    H4, b4, _ = tws.build_reduced_system(
        *_t(R, t, views, meas, np.ones(L, bool)), _ct(calib), obs_valid=torch.from_numpy(ov),
        **kw)
    scale = max(float(H3.abs().max()), 1.0)
    np.testing.assert_allclose(H4.numpy() / scale, H3.numpy() / scale, atol=2e-3)
    np.testing.assert_allclose(b4.numpy(), b3.numpy(), rtol=2e-2, atol=2.0)


def _early_exit_solve(R0, t0, views, meas, lm_valid, obs_valid, ct, *, inv_sigma,
                      dyn_outlier_px, prior_info, num_poses, max_iters):
    """The JAX package's lax.while_loop written with a host read of `done`
    each iteration, on the port's building blocks; returns (R, t, bodies)."""
    K = num_poses

    def prior(R, t):
        dxi = _se3_log(R0[0].T @ R[0], R0[0].T @ (t[0] - t0[0]))
        return 0.5 * prior_info * (dxi @ dxi), dxi

    def total(R, t):
        return prior(R, t)[0] + tws._window_error(
            R, t, views, meas, lm_valid, obs_valid, ct, inv_sigma, dyn_outlier_px)

    R, t, lam, err, done, i = R0, t0, torch.tensor(1e-5), total(R0, t0), False, 0
    while i < max_iters and not done:
        H, b, _ = tws.build_reduced_system(R, t, views, meas, lm_valid, ct, inv_sigma,
                                           dyn_outlier_px, num_poses=K, obs_valid=obs_valid)
        H, b = H.clone(), b.clone()
        H[:6, :6] += prior_info * torch.eye(6)
        b[:6] += prior_info * prior(R, t)[1]
        delta = tws._solve(H + torch.diag(lam * (torch.diagonal(H) + 1.0)), -b)
        ok = bool(torch.isfinite(delta).all()) and float(torch.linalg.vector_norm(delta)) < 1e3
        step = delta if ok else torch.zeros_like(delta)
        Rn = torch.stack([_retract(R[k], t[k], step[6 * k:6 * k + 6])[0] for k in range(K)])
        tn = torch.stack([_retract(R[k], t[k], step[6 * k:6 * k + 6])[1] for k in range(K)])
        new_err = total(Rn, tn)
        accept = ok and bool(new_err < err)
        improvement = err - new_err
        if accept:
            R, t, err = Rn, tn, new_err
            lam = torch.clamp(lam * 0.1, min=1e-10)
        else:
            lam = lam * 10.0
        done = (accept and bool(improvement < 1e-3 * torch.clamp(err, min=1.0))) or bool(lam > 1e8)
        i += 1
    return R, t, i


def test_masked_loop_equals_early_exit(problem):
    """The masked max_iters loop gives the early-exit loop's R and t on a
    window whose loop stops after its second body; bit for bit, since both
    run the same operations on the CPU."""
    calib, poses, lms, views, meas = problem
    gt = [JPose3(t=np.array([float(i), 0.0, 0.0])) for i in range(4)]
    # Seeds 5 mm off ground truth: the first step lands, the second's
    # improvement is below the 1e-3 tolerance.
    small = JPose3.expmap(np.array([0.0, 0.0, 1e-3, 5e-3, -2e-3, 4e-3]))
    seeded = (calib, [gt[0]] + [p * small for p in gt[1:]], lms, views, meas)
    arrays, ct, kw = _solve_args(seeded)
    tensors = _t(*arrays)
    R_e, t_e, bodies = _early_exit_solve(*tensors, ct, max_iters=8, **kw)
    assert bodies == 2
    R_m, t_m = tws.solve_window(*tensors, ct, max_iters=8, **kw)
    assert torch.equal(R_m, R_e) and torch.equal(t_m, t_e)
    Rj, tj = jws.solve_window(*(jnp.asarray(a) for a in arrays), ct, max_iters=8, **kw)
    np.testing.assert_allclose(t_m.numpy(), np.asarray(tj), atol=ATOL)


def _observe(pose, lms, calib, obs_cls):
    obs = []
    for lm_id, X in enumerate(lms):
        try:
            m = stereo_project(pose, calib, X)
        except Exception:
            continue
        obs.append(obs_cls(lm_id, m))
    return obs


def _smoother_window(smoother, pose_cls, obs_cls):
    """tests/test_window_smoother.py::test_xla_smoother_matches_numpy's window."""
    calib = make_calib()
    gt = [JPose3(t=np.array([float(i), 0.0, 0.0])) for i in range(4)]
    lms = np.array(
        [[0, 0, 8], [2, 1, 10], [-1, -1, 7], [3, 2, 12], [1, -2, 9], [-2, 1, 11]], dtype=float
    )
    offset = JPose3.expmap(np.array([0.0, 0.0, 0.02, 0.1, -0.05, 0.08]))
    for k, tp in enumerate(gt):
        seed = tp if k == 0 else tp * offset
        smoother.add_keyframe(k, pose_cls(R=seed.R, t=seed.t), _observe(tp, lms, calib, obs_cls))
    smoother.optimize()
    return [smoother.pose_of(k) for k in range(4)]


def _port_calib():
    c = make_calib()
    return StereoCalib(fx=c.fx, fy=c.fy, cx=c.cx, cy=c.cy, baseline=c.baseline)


def test_xla_smoother_matches_jax_and_numpy(monkeypatch):
    monkeypatch.delenv("SUPERSLAM_XLA_SMOOTHER", raising=False)
    ref = _smoother_window(WindowSmoother(_port_calib(), 4, device="cpu"), Pose3, StereoObs)
    monkeypatch.setenv("SUPERSLAM_XLA_SMOOTHER", "1")
    got = _smoother_window(WindowSmoother(_port_calib(), 4, device="cpu"), Pose3, StereoObs)
    jax_got = _smoother_window(JWindowSmoother(make_calib(), 4), JPose3, JStereoObs)
    for a, b, j in zip(ref, got, jax_got):
        assert np.linalg.norm(b.t - j.t) < ATOL and np.abs(b.R - j.R).max() < ATOL
        assert np.linalg.norm(a.t - b.t) < 0.02 and np.abs(a.R - b.R).max() < 0.02


def test_xla_smoother_without_a_device_raises_without_a_card(monkeypatch):
    """No device given: the knob solves on CUDA, and with no card it raises
    instead of falling back to the host LM."""
    monkeypatch.setenv("SUPERSLAM_XLA_SMOOTHER", "1")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _smoother_window(WindowSmoother(_port_calib(), 4), Pose3, StereoObs)


def _port_frame(jframe):
    from superslam_tpu_torch.core.frame import StereoFrame

    kw = {f.name: getattr(jframe, f.name) for f in dataclasses.fields(jframe)}
    kw["pose"] = Pose3(R=jframe.pose.R, t=jframe.pose.t)
    return StereoFrame(**kw)


class _PortMatcher:
    def __init__(self, jmatcher):
        from superslam_tpu_torch.core.interfaces import MatchResult

        r = jmatcher._result
        self._result = MatchResult(matches=r.matches, scores=r.scores)

    def match(self, kp0, d0, kp1, d1):
        return self._result

    def descriptors_to_host(self, d):
        return np.zeros((0, 256), dtype=np.float32)


def test_square_loop_with_xla_smoother_matches_jax(monkeypatch):
    """tests/test_vo_loop_closure.py's square loop through both packages'
    VoEstimators with the knob and loop closure: the corrected trajectories
    within 1e-3 m of each other."""
    from superslam_tpu.core.vo_estimator import VoEstimator as JVoEstimator
    from superslam_tpu_torch.core.loop_closer import LoopCloser, LoopParams
    from superslam_tpu_torch.core.vo_estimator import VoEstimator

    import test_vo_loop_closure as jloop
    from helpers import (
        IdentityMatcher, StubRecognizer, make_frame, place_desc, square_loop_path,
        world_landmarks,
    )

    monkeypatch.setenv("SUPERSLAM_XLA_SMOOTHER", "1")
    calib, lms = make_calib(), world_landmarks()
    jm = IdentityMatcher(len(lms))
    jvo = JVoEstimator(jm, calib, window_size=6)
    jvo.enable_loop_closure(jloop.make_loop_closer(jm, calib), async_=False)
    jloop.drive_square_loop(jvo, calib, lms)
    jvo.stop_loop_worker()

    pm = _PortMatcher(jm)
    params = LoopParams(required_votes=1, exclude_recent=1, min_score=0.5, min_inliers=8)
    vo = VoEstimator(pm, _port_calib(), window_size=6, device="cpu")
    vo.enable_loop_closure(
        LoopCloser(pm, _port_calib(), StubRecognizer(min_score=0.5), params), async_=False)
    path = square_loop_path()
    for i, p in enumerate(path):
        place = 0 if i + 1 == len(path) else i
        vo.track(_port_frame(make_frame(JPose3(t=p), lms, calib, 0.1 * i)), place_desc(place))
    vo.stop_loop_worker()

    ref, got = jvo.corrected_trajectory(), vo.corrected_trajectory()
    assert len(ref) == len(got) == len(path)
    assert vo.loop_closure_count() == jvo.loop_closure_count() >= 1
    gap = max(float(np.linalg.norm(a.t - b.t)) for a, b in zip(ref, got))
    assert gap < 1e-3, gap

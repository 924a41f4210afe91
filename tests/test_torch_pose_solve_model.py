"""CPU design tests of the per-frame pose-solve kernel (ops/cuda/pose_solve.cu).

The kernel runs only on the card. Here:
- a numpy transcription of its arithmetic that the card does not share
  with PyTorch: the block reduction's order (each thread's four points in
  sequence, a butterfly over the warp's lanes, then the eight warps in
  order) and the one-thread 6 x 6 LU with partial pivoting (the first
  largest pivot), both in f32, held against torch.linalg.solve in f64 on
  random SPD + lambda I systems (within 1e-4 relative: f32 elimination on
  systems of condition <= 1e3) and on general systems that pivot, and
  giving a non-finite step on a singular system (which the LM rejects);
- the plain twin's semantics that the kernel mirrors, on constructed
  cases: the prior gate and its fallback, a frame below min_matches that
  coasts in the tracking chain, a chi2 round that ends the re-solves, the
  LM's early exit, and the rejection of non-finite steps, each held to the
  JAX package's _frame_solve (1e-4 on poses, exact on counts).
"""

import numpy as np
import pytest
import torch

from superslam_tpu_torch.ops.cuda import pose_solve as ps
from superslam_tpu_torch.ops import pose_solver

THREADS, PPT, WARPS = 256, 4, 8
CALIB = (320.0, 320.0, 320.0, 176.0, 0.3)
KW = dict(calib=CALIB, min_matches=10, inv_sig_uLv=0.1, disp_sigma0=1.0,
          disp_cond=320.0 * 0.3 / 40.0, mono=False, gate_px=10.0, chi2_px=2.0, chi2_rounds=2,
          track_iters=20)


def block_sum_model(c: np.ndarray) -> np.float32:
    """The kernel's sum of per-point values c (K <= 1024) in its order."""
    c = np.asarray(c, np.float32)
    part = np.zeros(THREADS, np.float32)
    for k in range(PPT):
        idx = np.arange(THREADS) + k * THREADS
        vals = np.where(idx < c.size, c[np.minimum(idx, c.size - 1)], np.float32(0))
        part = (part + vals).astype(np.float32)
    lanes = part.reshape(WARPS, 32)
    for o in (16, 8, 4, 2, 1):
        lanes = (lanes + lanes[:, np.arange(32) ^ o]).astype(np.float32)
    total = np.float32(0)
    for w in range(WARPS):
        total = np.float32(total + lanes[w, 0])
    return total


def lu_solve_model(A: np.ndarray, b: np.ndarray) -> np.ndarray:
    """The kernel's one-thread solve: Gaussian elimination with partial
    pivoting (the first largest |pivot|), then back substitution, in f32."""
    A = np.array(A, np.float32)
    b = np.array(b, np.float32)
    n = A.shape[0]
    with np.errstate(all="ignore"):
        for c in range(n):
            p = c
            for r in range(c + 1, n):
                if abs(A[r, c]) > abs(A[p, c]):
                    p = r
            A[[c, p]] = A[[p, c]]
            b[[c, p]] = b[[p, c]]
            for r in range(c + 1, n):
                f = np.float32(A[r, c] / A[c, c])
                A[r, c + 1:] = (A[r, c + 1:] - f * A[c, c + 1:]).astype(np.float32)
                b[r] = np.float32(b[r] - f * b[c])
        x = np.zeros(n, np.float32)
        for r in range(n - 1, -1, -1):
            acc = b[r]
            for k in range(r + 1, n):
                acc = np.float32(acc - A[r, k] * x[k])
            x[r] = np.float32(acc / A[r, r])
    return x


def normal_equations_model(J: np.ndarray, r: np.ndarray):
    """H (6, 6) and g (6,) from per-point weighted rows, each of the 21 + 6
    sums in the kernel's reduction order."""
    H = np.zeros((6, 6), np.float32)
    for j in range(6):
        for k in range(j, 6):
            H[j, k] = H[k, j] = block_sum_model(np.sum(J[:, :, j] * J[:, :, k], axis=1))
    g = np.array([block_sum_model(np.sum(J[:, :, j] * r, axis=1)) for j in range(6)], np.float32)
    return H, g


@pytest.mark.parametrize("k", [1, 255, 600, 1024])
def test_block_sum_model(k):
    c = np.random.default_rng(k).normal(size=k).astype(np.float32)
    got = block_sum_model(c)
    assert abs(float(got) - float(np.sum(c.astype(np.float64)))) <= 1e-5 * max(
        1.0, float(np.abs(c).sum()))


@pytest.mark.parametrize("seed", range(4))
def test_lu_solve_model_on_normal_equations(seed):
    """Random Jacobian rows of 600 points -> H + lambda I: the modelled f32
    sums and solve against torch.linalg.solve in f64 on the exact sums."""
    rng = np.random.default_rng(seed)
    J = rng.normal(size=(600, 3, 6)).astype(np.float32) * rng.uniform(0.1, 10, 6).astype(
        np.float32)
    r = rng.normal(size=(600, 3)).astype(np.float32)
    H, g = normal_equations_model(J, r)
    lam = np.float32(10.0 ** rng.uniform(-5, 1))
    x = lu_solve_model(H + lam * np.eye(6, dtype=np.float32), -g)
    J64, r64 = torch.from_numpy(J).double(), torch.from_numpy(r).double()
    H64 = torch.einsum("nij,nik->jk", J64, J64) + float(lam) * torch.eye(6, dtype=torch.float64)
    g64 = torch.einsum("nij,ni->j", J64, r64)
    want = torch.linalg.solve(H64, -g64).numpy()
    assert np.linalg.cond(H64.numpy()) <= 1e3
    assert np.abs(x - want).max() <= 1e-4 * np.abs(want).max()


@pytest.mark.parametrize("seed", range(4))
def test_lu_solve_model_pivots(seed):
    """General (non-symmetric) systems whose elimination has to swap rows:
    the model against torch.linalg.solve."""
    rng = np.random.default_rng(100 + seed)
    A = rng.normal(size=(6, 6)).astype(np.float32)
    A[0, 0] = 1e-6  # the first column's pivot is not on the diagonal
    b = rng.normal(size=6).astype(np.float32)
    x = lu_solve_model(A, b)
    want = torch.linalg.solve(torch.from_numpy(A).double(), torch.from_numpy(b).double()).numpy()
    cond = np.linalg.cond(A.astype(np.float64))
    assert np.abs(x - want).max() <= 1e-6 * cond * max(1.0, np.abs(want).max())


def test_lu_solve_model_singular_step_is_not_finite():
    """H = 0 at lambda = 0 (no kept point): the step is not finite, so the
    kernel rejects it, as torch.linalg.solve_ex's result is in the twin."""
    x = lu_solve_model(np.zeros((6, 6), np.float32), np.ones(6, np.float32))
    assert not np.isfinite(x).all()
    twin, _ = torch.linalg.solve_ex(torch.zeros(6, 6), torch.ones(6))
    assert not torch.isfinite(twin).all()


# -- the twin's semantics on constructed frames ---------------------------------


def _frame(rng, k=128, usable=100, noise_px=0.3, t_true=(0.1, 0.0, 0.2)):
    """A keyframe's world points and one frame's exact stereo projections of
    them from (I, t_true) plus noise; the first ``usable`` matched."""
    fx, fy, cx, cy, b = CALIB
    z = rng.uniform(3.0, 12.0, k)
    xw = np.stack([(rng.uniform(20, 620, k) - cx) * z / fx, (rng.uniform(20, 332, k) - cy) * z / fy,
                   z], 1)
    p = xw - np.asarray(t_true)
    kl = np.stack([fx * p[:, 0] / p[:, 2] + cx, fy * p[:, 1] / p[:, 2] + cy], 1)
    kl += rng.normal(0, noise_px, kl.shape)
    disp = fx * b / p[:, 2] + rng.normal(0, noise_px, k)
    tm = np.where(np.arange(k) < usable, np.arange(k), -1)
    return dict(kl=kl.astype(np.float32), disp=disp.astype(np.float32), stereo_ok=np.ones(k, bool),
                tm=tm.astype(np.int32), kf_xw=xw.astype(np.float32), kf_dok=np.ones(k, bool))


def _poses(t_prev=(0.0, 0.0, 0.0), t_pred=(0.1, 0.0, 0.2)):
    eye = np.eye(3, dtype=np.float32)
    return (eye, np.asarray(t_prev, np.float32), eye, np.asarray(t_pred, np.float32))


def _twin(frame, poses, **over):
    kw = {**KW, **over}
    args = [torch.from_numpy(a) for a in poses] + [
        torch.from_numpy(frame[n]) for n in ("kl", "disp", "stereo_ok", "tm", "kf_xw", "kf_dok")]
    R, t, n, ok, kept, uv = ps.pose_solve(*args, **kw)
    return R.numpy(), t.numpy(), int(n), ok.numpy(), int(kept)


def _jax(frame, poses, **over):
    import jax.numpy as jnp

    from superslam_tpu.ops.frontend_step import _frame_solve

    kw = {**KW, **over}
    args = [jnp.asarray(a) for a in poses] + [
        jnp.asarray(frame[n]) for n in ("kl", "disp", "stereo_ok", "tm", "kf_xw", "kf_dok")]
    R, t, n, ok, _ = _frame_solve(*args, **kw)
    return np.asarray(R), np.asarray(t), int(n), np.asarray(ok)


def _holds_jax(frame, poses, **over):
    R, t, n, ok, kept = _twin(frame, poses, **over)
    jR, jt, jn, jok = _jax(frame, poses, **over)
    np.testing.assert_allclose(R, jR, atol=1e-4)
    np.testing.assert_allclose(t, jt, atol=1e-4)
    assert n == jn
    np.testing.assert_array_equal(ok, jok)
    return R, t, n, ok, kept


def _count_solves(monkeypatch):
    """Count the LM's iterations (its _system calls) per pose_only_lm_impl."""
    runs = []
    orig_lm, orig_sys = pose_solver.pose_only_lm_impl, pose_solver._system

    def sys_spy(*a, **kw):
        runs[-1] += 1
        return orig_sys(*a, **kw)

    def lm_spy(*a, **kw):
        runs.append(0)
        return orig_lm(*a, **kw)

    monkeypatch.setattr(pose_solver, "_system", sys_spy)
    monkeypatch.setattr(ps, "pose_only_lm_impl", lm_spy)
    return runs


def test_clean_frame_solves_and_exits_early(monkeypatch):
    runs = _count_solves(monkeypatch)
    frame = _frame(np.random.default_rng(0))
    R, t, n, ok, kept = _holds_jax(frame, _poses())
    assert n == 100 and ok.sum() == 100
    np.testing.assert_allclose(t, [0.1, 0.0, 0.2], atol=5e-3)
    assert len(runs) == 3, runs  # the first solve and both chi2 rounds
    assert all(0 < r < KW["track_iters"] for r in runs), runs  # each stops on 1e-4 improvement
    assert 10 <= kept <= 100


def test_gate_falls_back_to_every_usable_match():
    """A prediction 2 m off keeps fewer than min_matches within gate_px: the
    gate falls back to ok, and the solve still finds the pose."""
    frame = _frame(np.random.default_rng(1))
    R, t, n, ok, kept = _holds_jax(frame, _poses(t_pred=(2.0, 0.0, 0.2)))
    np.testing.assert_allclose(t, [0.1, 0.0, 0.2], atol=5e-3)


def test_below_min_matches_coasts():
    """Six usable matches against a floor of ten: the solve runs on what
    there is, and the tracking chain coasts on the prediction."""
    from superslam_tpu_torch.ops.frontend_step import track_scan

    frame = _frame(np.random.default_rng(2), usable=6)
    _R, _t, n, ok, _kept = _holds_jax(frame, _poses())
    assert n == 6
    carry = tuple(torch.from_numpy(a) for a in (np.eye(3, dtype=np.float32),
                                                np.zeros(3, np.float32),
                                                np.eye(3, dtype=np.float32),
                                                np.array([0.05, 0.0, 0.0], np.float32)))
    out, _ = track_scan(
        *(torch.from_numpy(frame[n][None]) for n in ("kl", "disp", "stereo_ok", "tm")),
        torch.from_numpy(frame["kf_xw"]), torch.from_numpy(frame["kf_dok"]), carry,
        calib=CALIB, min_matches=10, track_sigma_px=10.0, disp_sigma0=1.0,
        disp_cond=KW["disp_cond"])
    assert out[0, 12] == 6
    np.testing.assert_allclose(out[0, 9:12].numpy(), [0.05, 0.0, 0.0], atol=1e-6)


def test_chi2_round_below_min_matches_ends_the_rounds(monkeypatch):
    """3 px noise against chi2_px 2 and 12 usable matches: the first round
    keeps fewer than ten inliers, so no re-solve runs and the kept set stays
    the gated one."""
    runs = _count_solves(monkeypatch)
    frame = _frame(np.random.default_rng(3), usable=12, noise_px=3.0)
    R, t, n, ok, kept = _holds_jax(frame, _poses())
    assert len(runs) == 1, runs
    assert kept >= 10


def _iterations_to_lambda_stop() -> int:
    lam, i = np.float32(1e-5), 0
    while True:
        i += 1
        lam = np.float32(lam * np.float32(10))
        if lam > 1e8:
            return i


def test_non_finite_steps_are_rejected(monkeypatch):
    """A NaN measurement of a kept match makes the normal equations and every
    error NaN: every step is non-finite and rejected, lambda grows x10 an
    iteration from 1e-5 until it passes 1e8, and the pose stays where it
    started. (A NaN world point would not do: the cheirality escape hatch
    turns its residual into a finite outlier.)"""
    runs = _count_solves(monkeypatch)
    frame = _frame(np.random.default_rng(4))
    frame["kl"][5] = np.nan
    R, t, n, ok, kept = _twin(frame, _poses(t_prev=(0.03, 0.0, 0.05)), gate_px=0.0,
                              chi2_rounds=0)
    assert runs == [_iterations_to_lambda_stop()], runs
    np.testing.assert_array_equal(R, np.eye(3, dtype=np.float32))
    np.testing.assert_array_equal(t, np.array([0.03, 0.0, 0.05], np.float32))

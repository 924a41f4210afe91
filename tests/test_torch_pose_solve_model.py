"""CPU design tests of the per-frame pose-solve kernel (ops/cuda/pose_solve.cu
and its engine pose_solve.cuh, which track_frame.cu runs too).

The kernel runs only on the card. Here:
- a numpy transcription of its arithmetic that the card does not share
  with PyTorch: the block reduction's order (each thread's four points in
  sequence, a reduce-scatter over the warp's lanes that leaves lane L with
  value L, then the eight warps in order), held against an f64 sum within
  f32 rounding and shown to give the butterfly's bits; the 6 x 6 LU with
  partial pivoting (the first largest pivot, one reciprocal a pivot) that
  every thread runs, in f32, held against torch.linalg.solve in f64 on random SPD + lambda I
  systems (within 1e-4 relative: f32 elimination on systems of condition
  <= 1e3) and on general systems that pivot, and giving a non-finite step
  on a singular system (which the LM rejects);
- a numpy f32 model of the kernel's LM schedule (one pass over the points
  a step, at the trial pose, for its error and its system together; the
  kept system re-solved after a rejection), shown on one arithmetic to
  take pose_only_lm_impl's steps to the same bits (a transcription of the
  JAX loop, two passes a step), and held to the JAX package's
  pose_only_lm_impl run step by step, in f32 and in f64: every LM solve of
  a frame takes the same accept / reject steps up to the first one that
  rounding decides, the lambda stop and the non-finite steps every step,
  poses within 1e-4 (f32) and 1e-9 (f64), on the clean frame's early
  exit, the lambda > 1e8 stop after rejections, non-finite steps and a
  chi2 round that ends the rounds;
- the plain twin's semantics that the kernel mirrors, on constructed
  cases: the prior gate and its fallback, a frame below min_matches that
  coasts in the tracking chain, a chi2 round that ends the re-solves, the
  LM's early exit, and the rejection of non-finite steps, each held to the
  JAX package's _frame_solve (1e-4 on poses, exact on counts);
- the premise of chip_smoke.py's mono check: in f64 the twin's answer does
  not depend on the order of the correspondences.
JAX is imported inside the tests that call it: tests/test_torch_kernels_gpu.py
takes this file's frames on a GPU host without JAX.
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


NRED = 28  # the LM's sums: H's upper triangle (21), g (6), the robust error


def thread_partials(c: np.ndarray) -> np.ndarray:
    """(THREADS, n) in c's type (f32 as the kernel's): each thread's running
    sum of its points' values c (K, n), point threadIdx.x + k * THREADS for
    k = 0..PPT-1 in turn."""
    c = np.asarray(c)
    part = np.zeros((THREADS, c.shape[1]), c.dtype)
    for k in range(PPT):
        idx = np.arange(THREADS) + k * THREADS
        take = idx < c.shape[0]
        part[take] = (part[take] + c[idx[take]]).astype(c.dtype)
    return part


def reduce_scatter_model(lanes: np.ndarray) -> np.ndarray:
    """A warp's reduce-scatter of 32 values a lane: lanes (WARPS, 32, 32)
    -> (WARPS, 32), lane L with the warp's sum of value L. At stage o a lane
    holds 2 o values; the lane whose bit o is set keeps the upper o and sends
    the lower, its partner the reverse; each adds what it receives to what
    it kept (Reducer::sum, scatter_stage)."""
    v = np.asarray(lanes)
    lane = np.arange(32)
    for o in (16, 8, 4, 2, 1):
        hi = (lane & o) != 0
        lo_half, hi_half = v[:, :, :o], v[:, :, o:2 * o]
        keep = np.where(hi[None, :, None], hi_half, lo_half)
        send = np.where(hi[None, :, None], lo_half, hi_half)
        v = (keep + send[:, lane ^ o]).astype(lanes.dtype)
    return v[:, :, 0]


def block_sums_model(c: np.ndarray) -> np.ndarray:
    """The kernel's totals of per-point values c (K, n <= 32), K <= 1024:
    thread partials, the reduce-scatter in each warp, the warps' partials
    added in warp order."""
    c = np.asarray(c)
    n = c.shape[1]
    part = np.zeros((THREADS, 32), c.dtype)
    part[:, :n] = thread_partials(c)
    warp = reduce_scatter_model(part.reshape(WARPS, 32, 32))
    total = warp[0].copy()
    for w in range(1, WARPS):
        total = (total + warp[w]).astype(c.dtype)
    return total[:n]


def block_sum_model(c: np.ndarray) -> np.float32:
    """The kernel's sum of one per-point value c (K,)."""
    return block_sums_model(np.asarray(c, np.float32)[:, None])[0]


def butterfly_model(c: np.ndarray) -> np.ndarray:
    """The same totals by a butterfly over the lanes (x += shfl_xor(x, o)
    for o = 16 .. 1, every lane ending with the sum), then the warps in
    order."""
    part = thread_partials(np.asarray(c, np.float32)).reshape(WARPS, 32, -1)
    for o in (16, 8, 4, 2, 1):
        part = (part + part[:, np.arange(32) ^ o]).astype(np.float32)
    total = part[0, 0].copy()
    for w in range(1, WARPS):
        total = (total + part[w, 0]).astype(np.float32)
    return total


def lu_solve_model(A: np.ndarray, b: np.ndarray, dtype=np.float32) -> np.ndarray:
    """The kernel's solve, which every thread runs on the same bits:
    Gaussian elimination with partial pivoting (the first largest |pivot|),
    the multipliers and the unknowns scaled by one reciprocal a pivot, then
    back substitution, in f32 (dtype)."""
    f = dtype
    A = np.array(A, f)
    b = np.array(b, f)
    n = A.shape[0]
    inv = np.zeros(n, f)
    with np.errstate(all="ignore"):
        for c in range(n):
            p = c
            for r in range(c + 1, n):
                if abs(A[r, c]) > abs(A[p, c]):
                    p = r
            A[[c, p]] = A[[p, c]]
            b[[c, p]] = b[[p, c]]
            inv[c] = f(f(1) / A[c, c])
            for r in range(c + 1, n):
                m = f(A[r, c] * inv[c])
                A[r, c + 1:] = (A[r, c + 1:] - m * A[c, c + 1:]).astype(f)
                b[r] = f(b[r] - m * b[c])
        x = np.zeros(n, f)
        for r in range(n - 1, -1, -1):
            acc = b[r]
            for k in range(r + 1, n):
                acc = f(acc - A[r, k] * x[k])
            x[r] = f(acc * inv[r])
    return x


def normal_equations_model(J: np.ndarray, r: np.ndarray):
    """H (6, 6) and g (6,) from per-point weighted rows, the 21 + 6 sums in
    the kernel's reduction order."""
    cols = [np.sum(J[:, :, j] * J[:, :, k], axis=1) for j in range(6) for k in range(j, 6)]
    cols += [np.sum(J[:, :, j] * r, axis=1) for j in range(6)]
    return _system_from(block_sums_model(np.stack(cols, 1).astype(np.float32)))


def _system_from(sums: np.ndarray):
    """H (6, 6) and g (6,) from the 21 + 6 totals (H's upper triangle row
    by row, then g), as the kernel fetches them from the lanes."""
    H = np.zeros((6, 6), sums.dtype)
    idx = 0
    for j in range(6):
        for k in range(j, 6):
            H[j, k] = H[k, j] = sums[idx]
            idx += 1
    return H, np.asarray(sums[21:27])


@pytest.mark.parametrize("k", [1, 2, 31, 255, 256, 257, 600, 1000, 1023, 1024])
def test_block_sum_model(k):
    """The 28 totals of the reduce-scatter and the warp order against f64
    sums, within f32 rounding."""
    c = np.random.default_rng(k).normal(size=(k, NRED)).astype(np.float32)
    got = block_sums_model(c)
    want = c.astype(np.float64).sum(0)
    bound = 1e-5 * np.maximum(1.0, np.abs(c).astype(np.float64).sum(0))
    assert np.all(np.abs(got - want) <= bound)
    assert abs(float(block_sum_model(c[:, 0])) - want[0]) <= bound[0]


@pytest.mark.parametrize("k", [1, 255, 600, 1024])
def test_reduce_scatter_gives_the_butterfly_bits(k):
    """Lane L of the reduce-scatter pairs the lanes as the butterfly does
    (by bit 4, then 3, ..., 0; a + b == b + a exactly), so each total has
    the butterfly's bits: the reduction adds in the earlier kernel's order."""
    c = (np.random.default_rng(k).normal(size=(k, NRED)) * 10.0 ** np.arange(-3, 4, 0.25)[:NRED])
    c = c.astype(np.float32)
    np.testing.assert_array_equal(block_sums_model(c), butterfly_model(c))


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


# -- the kernel's LM schedule --------------------------------------------------

HUBER_K = 2.7955
# |new_err - err| / max(err, 1) within which the order of the sums decides a
# step: a converged solve's last steps (and every step of a solve that opens
# converged) change the error by its rounding alone.
NEAR_TIE = {np.float32: 1e-5, np.float64: 1e-12}


def point_values_model(R, t, pts, calib, inv_sig_uLv, dtype=np.float32):
    """(K, 28) in f32 (dtype): each point's 21 + 6 normal-equation terms and
    robust error at the pose (R, t) (pose_solve.cuh::point_sums, whose
    Jacobian leaves out the products with the zeros of Jp and D written out
    here: the same sums). pts: X (K, 3), meas (K, 3) (uL, uR, v), su (K,),
    keep (K,)."""
    f = dtype
    fx, fy, cx, cy, b = (f(c) for c in calib)
    hk = f(HUBER_K)
    X, meas, su, keep = pts
    with np.errstate(all="ignore"):
        p = ((X - t).astype(f) @ R).astype(f)
        p0, p1, p2 = p[:, 0], p[:, 1], p[:, 2]
        good = p2 > f(1e-9)
        iz = (f(1) / np.where(good, p2, f(1))).astype(f)
        r = np.stack([fx * p0 * iz + cx - meas[:, 0], fx * (p0 - b) * iz + cx - meas[:, 1],
                      fy * p1 * iz + cy - meas[:, 2]], 1).astype(f)
        r = np.where(good[:, None], r, f(2) * fx)
        iz2, zero, one = iz * iz, np.zeros_like(iz), np.ones_like(iz)
        Jp = np.stack([np.stack([fx * iz, zero, -fx * p0 * iz2], 1),
                       np.stack([fx * iz, zero, -fx * (p0 - b) * iz2], 1),
                       np.stack([zero, fy * iz, -fy * p1 * iz2], 1)], 1).astype(f)
        D = np.stack([np.stack([zero, -p2, p1, -one, zero, zero], 1),
                      np.stack([p2, zero, -p0, zero, -one, zero], 1),
                      np.stack([-p1, p0, zero, zero, zero, -one], 1)], 1).astype(f)
        sig = np.stack([np.full_like(su, inv_sig_uLv), su, np.full_like(su, inv_sig_uLv)], 1)
        Jw = (np.where(good[:, None, None], np.einsum("nij,njk->nik", Jp, D), f(0))
              * sig[:, :, None]).astype(f)
        rw = (r * sig).astype(f)
        nrm = np.sqrt((rw * rw).sum(1)).astype(f)
        w = (np.where(nrm <= hk, f(1), hk / np.maximum(nrm, f(1e-12))) * keep).astype(f)
        terms = [w * (Jw[:, :, j] * Jw[:, :, k]).sum(1) for j in range(6) for k in range(j, 6)]
        terms += [w * (Jw[:, :, j] * rw).sum(1) for j in range(6)]
        terms.append(np.where(nrm <= hk, f(0.5) * nrm * nrm, hk * nrm - f(0.5) * hk * hk) * keep)
    return np.stack(terms, 1).astype(f)


def retract_model(R, t, x, dtype=np.float32):
    """The pose retracted by the step x (pose_solve.cuh::retract)."""
    f = dtype
    x = np.asarray(x, f)
    w0, w1, w2 = x[:3]
    th2 = f(w0 * w0 + w1 * w1 + w2 * w2)
    W = np.array([[0, -w2, w1], [w2, 0, -w0], [-w1, w0, 0]], f)
    W2 = (W @ W).astype(f)
    th = np.sqrt(th2 + f(1e-20))
    small = th2 < f(1e-12)
    a = f(1) if small else f(np.sin(th) / th)
    bb = f(0.5) if small else f((f(1) - np.cos(th)) / th2)
    cc = f(1 / 6) if small else f((th - np.sin(th)) / (th2 * th))
    eye = np.eye(3, dtype=f)
    dR = (eye + a * W + bb * W2).astype(f)
    V = (eye + bb * W + cc * W2).astype(f)
    dt = (V @ x[3:]).astype(f)
    return (R @ dR).astype(f), (R @ dt + t).astype(f)


def lm_model(R, t, pts, calib, inv_sig_uLv, track_iters, dtype=np.float32):
    """The kernel's LM (pose_solve.cuh::lm): one pass at the start for its
    error and system, then a step: solve the held system at lambda (f32,
    as the JAX loop's), one pass at the trial pose (a non-finite step's is
    the pose retracted by zero) for its error and system together; an
    accepted step moves the pose and takes the trial's system, a rejection
    keeps both (only lambda moves). Returns (R, t, the accept / reject
    sequence, each step's (new_err - err) / max(err, 1), the passes over
    the points)."""
    f, f32 = dtype, np.float32

    def sums_at(R, t):
        return block_sums_model(point_values_model(R, t, pts, calib, inv_sig_uLv, f))

    sums = sums_at(R, t)
    err, lam, steps, gaps, passes = sums[27], f32(1e-5), [], [], 1
    for _ in range(track_iters):
        H, g = _system_from(sums)
        x = lu_solve_model(H + lam * np.eye(6, dtype=f), -g, f)
        finite = bool(np.isfinite(x).all())
        Rn, tn = retract_model(R, t, x if finite else np.zeros(6, f), f)
        trial = sums_at(Rn, tn)
        passes += 1
        new_err = trial[27]
        accept = finite and bool(new_err < err)
        steps.append(accept)
        gaps.append(float(new_err - err) / max(float(err), 1.0))
        improvement = f(err - new_err)
        if accept:
            R, t, sums, err = Rn, tn, trial, new_err
        lam = max(f32(lam * f32(0.1)), f32(1e-10)) if accept else f32(lam * f32(10))
        if (accept and improvement < f(1e-4) * max(err, f(1))) or lam > 1e8:
            break
    return R, t, steps, gaps, passes


def two_pass_lm_model(R, t, pts, calib, inv_sig_uLv, track_iters, dtype=np.float32):
    """pose_only_lm_impl's loop as the JAX package writes it, on the model's
    arithmetic: the system rebuilt at the current pose every iteration, the
    step retracted by where(finite, delta, 0) and the trial's error from a
    second pass. Returns (R, t, the accept / reject sequence, passes)."""
    f, f32 = dtype, np.float32

    def sums_at(R, t):
        return block_sums_model(point_values_model(R, t, pts, calib, inv_sig_uLv, f))

    err, lam, steps, passes = sums_at(R, t)[27], f32(1e-5), [], 1
    for _ in range(track_iters):
        H, g = _system_from(sums_at(R, t))
        x = lu_solve_model(H + lam * np.eye(6, dtype=f), -g, f)
        ok = bool(np.isfinite(x).all())
        Rn, tn = retract_model(R, t, x if ok else np.zeros(6, f), f)
        new_err = sums_at(Rn, tn)[27]
        passes += 2
        accept = ok and bool(new_err < err)
        steps.append(accept)
        improvement = f(err - new_err)
        if accept:
            R, t, err = Rn, tn, new_err
        lam = max(f32(lam * f32(0.1)), f32(1e-10)) if accept else f32(lam * f32(10))
        if (accept and improvement < f(1e-4) * max(err, f(1))) or lam > 1e8:
            break
    return R, t, steps, passes


def solve_model(frame, poses, *, calib, min_matches, inv_sig_uLv, disp_sigma0, disp_cond, mono,
                gate_px, chi2_px, chi2_rounds, track_iters, dtype=np.float32, lm=None):
    """The kernel's whole solve (pose_solve.cuh::solve): the gate, the LM,
    the chi2 rounds, the first round below min_matches ending them. Returns
    (R, t, n, kept, and for each LM solve its accept / reject sequence, its
    steps' error gaps and its passes). lm: another LM on the same arithmetic
    (two_pass_lm_model), whose solves then hold (steps, passes)."""
    f = dtype
    fx, fy, cx, cy, _ = (f(c) for c in calib)
    R, t, R_pred, t_pred = (np.asarray(a, f) for a in poses)
    tm = frame["tm"]
    fi = np.maximum(tm, 0)
    kl, d = frame["kl"].astype(f), frame["disp"][fi].astype(f)
    u, v = kl[fi, 0], kl[fi, 1]
    ok = (tm >= 0) & frame["stereo_ok"][fi] & frame["kf_dok"]
    with np.errstate(all="ignore"):
        ratio = (f(disp_cond) / np.maximum(d, f(1e-3))).astype(f)
        su = (np.zeros_like(d) if mono
              else f(1) / (f(disp_sigma0) * np.sqrt(f(1) + ratio * ratio))).astype(f)
    meas = np.stack([u, u - d, v], 1).astype(f)
    X = frame["kf_xw"].astype(f)

    def within(R, t, px):
        with np.errstate(all="ignore"):
            p = ((X - t) @ R).astype(f)
            zok = p[:, 2] > f(0.1)
            zs = np.where(zok, p[:, 2], f(1))
            r = np.hypot(fx * p[:, 0] / zs + cx - u, fy * p[:, 1] / zs + cy - v)
        return ok & zok & (r < f(px))

    runs, lm_fn = [], lm or lm_model

    def lm(R, t, keep):
        R, t, *run = lm_fn(R, t, (X, meas, su, keep.astype(f)), calib, f(inv_sig_uLv),
                           track_iters, f)
        runs.append(run)
        return R, t

    keep = ok
    if gate_px > 0:
        k0 = within(R_pred, t_pred, gate_px)
        if k0.sum() >= min_matches:
            keep = k0
    R, t = lm(R, t, keep)
    for _ in range(chi2_rounds):
        k2 = within(R, t, chi2_px)
        if k2.sum() < min_matches:
            break
        keep = k2
        R, t = lm(R, t, keep)
    return R, t, int(ok.sum()), int(keep.sum()), runs


def _jax_lm_steps(monkeypatch, frame, poses, x64=False, **over):
    """The JAX package's _frame_solve with lax.while_loop run step by step
    (in f64 with x64): its pose, n, and for each pose_only_lm_impl call the
    accept / reject sequence read from its states (a rejection multiplies
    lambda, f32 in either mode, by 10; an acceptance does not)."""
    import jax

    runs = []

    def stepwise(cond, body, state):
        states = [state]
        while bool(cond(states[-1])):
            states.append(body(states[-1]))
        runs.append([not np.float32(b[3]) == np.float32(np.float32(a[3]) * np.float32(10))
                     for a, b in zip(states, states[1:])])
        return states[-1]

    monkeypatch.setattr(jax.lax, "while_loop", stepwise)
    if not x64:
        R, t, n, _ok = _jax(frame, poses, **over)
        return R, t, n, runs
    wide = lambda a: a.astype(np.float64) if a.dtype == np.float32 else a  # noqa: E731
    with jax.enable_x64(True):
        R, t, n, _ok = _jax({k: wide(a) for k, a in frame.items()}, [wide(a) for a in poses],
                            **over)
    return R, t, n, runs


SCHEDULE_CASES = ["early_exit", "lambda_stop", "non_finite", "chi2_stop"]


def _schedule_case(case):
    """(frame, poses, overrides) of an LM case."""
    over, t_prev = {}, (0.0, 0.0, 0.0)
    if case == "early_exit":
        frame = _frame(np.random.default_rng(0))
    elif case == "lambda_stop":  # no usable match: H = 0, every zero step rejected
        frame = _frame(np.random.default_rng(6), usable=0)
    elif case == "non_finite":  # a NaN measurement: every step non-finite
        frame = _frame(np.random.default_rng(4))
        frame["kl"][5] = np.nan
        over, t_prev = dict(gate_px=0.0, chi2_rounds=0), (0.03, 0.0, 0.05)
    elif case == "chi2_stop":
        frame = _frame(np.random.default_rng(3), usable=12, noise_px=3.0)
    elif case == "k600":
        frame = _frame(np.random.default_rng(7), k=600, usable=520, noise_px=0.5)
    else:  # mono at K 1000
        frame = _frame(np.random.default_rng(8), k=1000, usable=900, noise_px=0.5)
        over = dict(mono=True)
    return frame, _poses(t_prev=t_prev), over


def _schedule_shape(case, runs, jruns, n, kept, t, t_prev):
    """What each case is: the early exit of every solve, the lambda stop,
    the non-finite steps, the round that ends the rounds (the JAX solve
    runs every chi2 round and discards those after a round below
    min_matches; the kernel stops there); one pass to open a solve and one
    a finite step."""
    steps = [r[0] for r in runs]
    lam_stop = _iterations_to_lambda_stop()
    for s, (_, gaps, passes) in zip(steps, runs):
        assert passes == 1 + len(s) and len(gaps) == len(s)
    if case == "early_exit":
        assert len(steps) == 1 + KW["chi2_rounds"]
        assert all(0 < len(s) < KW["track_iters"] and s[-1] for s in steps), steps
    elif case == "lambda_stop":
        assert n == 0 and steps[0] == [False] * lam_stop and runs[0][2] == 1 + lam_stop
    elif case == "non_finite":
        assert steps == [[False] * lam_stop] and runs[0][2] == 1 + lam_stop
        np.testing.assert_array_equal(t, t_prev)
    else:
        assert len(steps) == 1 and len(jruns) == 1 + KW["chi2_rounds"] and kept >= 10


@pytest.mark.parametrize("case", SCHEDULE_CASES + ["k600", "mono_k1000"])
def test_one_pass_schedule_is_the_two_pass_loop(case):
    """The schedule's claim on one arithmetic: the kernel's LM (one pass a
    step; the held system re-solved after a rejection) and
    pose_only_lm_impl's loop (the system rebuilt at the pose every
    iteration, the trial's error from a second pass) take the same steps,
    over as many iterations, to the same bits, in every solve of the
    frame; the kernel with one pass to open a solve and one a step, the
    loop with two a step."""
    frame, poses, over = _schedule_case(case)
    R, t, n, kept, runs = solve_model(frame, poses, **{**KW, **over})
    R2, t2, n2, kept2, runs2 = solve_model(frame, poses, **{**KW, **over}, lm=two_pass_lm_model)
    assert (n, kept) == (n2, kept2)
    assert [r[0] for r in runs] == [r[0] for r in runs2]
    np.testing.assert_array_equal(R, R2)
    np.testing.assert_array_equal(t, t2)
    for (steps, _gaps, passes), (_, passes2) in zip(runs, runs2):
        assert passes2 == 1 + 2 * len(steps) and passes == 1 + len(steps)
    assert sum(r[2] for r in runs) < sum(r[1] for r in runs2)


def _held_to_jax(monkeypatch, case, dtype, atol):
    """The model in dtype against the JAX package's _frame_solve in the same
    type: n exact, poses within atol, and in every LM solve the same steps
    up to the first one decided within rounding (NEAR_TIE; from there the
    two run apart by rounding alone, as chip_smoke.py's allowances say),
    every step where no step is."""
    frame, poses, over = _schedule_case(case)
    R, t, n, kept, runs = solve_model(frame, poses, **{**KW, **over}, dtype=dtype)
    jR, jt, jn, jruns = _jax_lm_steps(monkeypatch, frame, poses, x64=dtype == np.float64, **over)
    assert n == jn
    np.testing.assert_allclose(R, jR, atol=atol, rtol=0)
    np.testing.assert_allclose(t, jt, atol=atol, rtol=0)
    for (steps, gaps, _), jsteps in zip(runs, jruns):
        tie = next((i for i, d in enumerate(gaps) if 0 < abs(d) <= NEAR_TIE[dtype]), None)
        if tie is None:
            assert steps == jsteps
        else:
            assert steps[:tie] == jsteps[:tie]
    if case in ("lambda_stop", "non_finite"):  # every step decided exactly
        assert [r[0] for r in runs] == jruns[:len(runs)]
    _schedule_shape(case, runs, jruns, n, kept, t, poses[1])
    return runs, jruns


@pytest.mark.parametrize("case", SCHEDULE_CASES)
def test_lm_schedule_model_matches_pose_only_lm_impl(monkeypatch, case):
    """The kernel's arithmetic: the model in f32 against the JAX package's
    pose_only_lm_impl in f32, poses within 1e-4."""
    _held_to_jax(monkeypatch, case, np.float32, 1e-4)


@pytest.mark.parametrize("case", SCHEDULE_CASES)
def test_lm_schedule_in_f64_matches_pose_only_lm_impl(monkeypatch, case):
    """With f32 rounding out of the way (both in f64, lambda f32 in both):
    poses within 1e-9, and the early exit's first solve, a chi2 round and
    the chi2 stop's solve decided step for step."""
    runs, jruns = _held_to_jax(monkeypatch, case, np.float64, 1e-9)
    if case in ("early_exit", "chi2_stop"):
        assert runs[0][0] == jruns[0]


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


def test_twin_in_f64_does_not_depend_on_the_order_of_correspondences():
    """chip_smoke.py's mono check measures each frame's allowance by running
    the f32 twin over permutations of the keyframe features: a permutation
    changes only the order of the sums. Run in f64 on a mono frame at K 1000
    the twin gives the same pose (within 1e-9) and kept count under every
    permutation, so what the f32 runs spread is rounding alone."""
    rng = np.random.default_rng(5)
    frame = _frame(rng, k=1000, usable=900, noise_px=0.5)
    kw = {**KW, "mono": True}
    args = [torch.from_numpy(a).double() for a in _poses()] + [
        torch.from_numpy(frame[n]) for n in ("kl", "disp", "stereo_ok", "tm", "kf_xw", "kf_dok")]
    args[4], args[5], args[8] = args[4].double(), args[5].double(), args[8].double()
    outs = []
    for seed in range(4):
        perm = torch.from_numpy(np.random.default_rng(seed).permutation(1000)) if seed else (
            torch.arange(1000))
        a = [*args[:7], args[7][perm], args[8][perm], args[9][perm]]
        R, t, n, _ok, kept, _uv = ps.pose_solve_plain(*a, **kw)
        outs.append((R.numpy(), t.numpy(), int(n), int(kept)))
    R0, t0, n0, kept0 = outs[0]
    assert n0 == 900 and kept0 >= 10
    np.testing.assert_allclose(t0, [0.1, 0.0, 0.2], atol=2e-2)
    for R, t, n, kept in outs[1:]:
        assert (n, kept) == (n0, kept0)
        np.testing.assert_allclose(R, R0, atol=1e-9, rtol=0)
        np.testing.assert_allclose(t, t0, atol=1e-9, rtol=0)

"""CPU design tests of the per-frame tracking kernel (ops/cuda/track_frame.cu).

The kernel runs only on the card. Here:
- the plain twin (ops/cuda/track_frame.py::track_frame_plain), one frame at
  a time, held to the JAX package's scan steps on constructed frames:
  track_kf_scan's (accept, reject on support, reject a non-finite solve,
  coast, the keyframe gate by max frames, by min matches and by the covis
  ratio, with a promotion's world points grounded through the new pose)
  and track_scan's (solve and coast, stereo and mono), each a one-frame
  scan on the JAX side: poses within 1e-4, counts and bits exact;
- a numpy model of what the kernel adds to the solve, in f32: the counts
  of the support set and of the keyframe's depth-valid features (a ballot
  a point of each thread, each warp's population counts, the warps' counts
  added in warp order after one barrier), and thread 0's epilogue (the
  acceptance floor, the select, the one-thread Gram-Schmidt with its 1e-20,
  the carry, the gate and the new since) and the promoted world points,
  held to the twin's epilogue on random solves: bits exact, poses and
  world points to f32 rounding.

JAX is imported inside the tests that call it: tests/test_torch_kernels_gpu.py
takes this file's frames on a GPU host without JAX.
"""

import numpy as np
import pytest
import torch

from superslam_tpu_torch.ops.cuda import track_frame as tf
from test_torch_pose_solve_model import CALIB, KW, THREADS, PPT, _frame

SOLVE_KW = dict(KW)
GATE = dict(accept_frac=0.4, support_px=4.0, kf_min_frames=2, kf_max_frames=99,
            kf_min_matches=30, covis_ratio=0.5)
D = 32  # descriptor width: the copy does not care


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """Two intra-op threads: the suite runs several workers on one host."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _case(seed, k=128, usable=100, noise_px=0.3, since=0, t_prev=(0.05, 0.0, 0.1),
          rel_t=(0.05, 0.0, 0.1)):
    """A frame of tests/test_torch_pose_solve_model.py (the camera at (0.1,
    0, 0.2), keyframe at the origin) with the keyframe-side and frame-side
    features the promotion copies, and the pose carry (previous pose at
    t_prev, constant-velocity step rel_t)."""
    rng = np.random.default_rng(seed)
    f = _frame(rng, k=k, usable=usable, noise_px=noise_px)
    frame = dict(kl=f["kl"], nkl=((f["kl"] - 320.0) / 320.0).astype(np.float32),
                 dl=rng.normal(size=(k, D)).astype(np.float32), vl=rng.uniform(size=k) < 0.9,
                 disp=f["disp"], stereo_ok=f["stereo_ok"])
    frame["stereo_ok"][::9] = False
    kf = dict(nk=rng.normal(size=(k, 2)).astype(np.float32),
              desc=rng.normal(size=(k, D)).astype(np.float32), valid=np.ones(k, bool),
              xw=f["kf_xw"], dok=f["kf_dok"], since=np.asarray(since, np.int32))
    eye = np.eye(3, dtype=np.float32)
    carry = [eye, np.asarray(t_prev, np.float32), eye, np.asarray(rel_t, np.float32)]
    return frame, kf, carry, f["tm"]


_FRAME = ("kl", "nkl", "dl", "vl", "disp", "stereo_ok")
_KF = ("nk", "desc", "valid", "xw", "dok", "since")


def _twin(frame, kf, carry, tm, keyframes=GATE, **over):
    kw = {**SOLVE_KW, **over}
    t = torch.from_numpy
    return tf.track_frame(
        tuple(t(c) for c in carry), tuple(t(frame[n]) for n in _FRAME), t(tm),
        tuple(t(kf[n]) for n in _KF), keyframes=keyframes, **kw)


def _jax_kf(frame, kf, carry, tm, gate=GATE, **over):
    import jax.numpy as jnp

    from superslam_tpu.ops.frontend_step import track_kf_scan

    kw = {**SOLVE_KW, **over}
    j = jnp.asarray
    out, m, state, pose = track_kf_scan(
        None, *(j(frame[n][None]) for n in _FRAME), tuple(j(kf[n]) for n in _KF),
        tuple(j(c) for c in carry), track_m0=j(tm[None]), calib=kw["calib"],
        min_matches=kw["min_matches"], track_sigma_px=1.0 / kw["inv_sig_uLv"],
        disp_sigma0=kw["disp_sigma0"], disp_cond=kw["disp_cond"], match_threshold=0.1,
        track_iters=kw["track_iters"], gate_px=kw["gate_px"], chi2_px=kw["chi2_px"],
        chi2_rounds=kw["chi2_rounds"], **gate)
    return np.asarray(out[0]), np.asarray(m[0]), [np.asarray(a) for a in state], [
        np.asarray(a) for a in pose]


def _holds_jax_kf(frame, kf, carry, tm, gate=GATE, **over):
    row, used, pose, state, fresh, raw = _twin(frame, kf, carry, tm, keyframes=gate, **over)
    jrow, jm, jstate, jpose = _jax_kf(frame, kf, carry, tm, gate, **over)
    row = row.numpy()
    np.testing.assert_allclose(row[:12], jrow[:12], atol=1e-4, rtol=0)
    np.testing.assert_array_equal(row[12:], jrow[12:])  # n, support, accept, promo
    np.testing.assert_array_equal(used.numpy(), jm)
    for a, b in zip(pose, jpose):
        np.testing.assert_allclose(a.numpy(), b, atol=1e-4, rtol=0)
    for name, a, b in zip(_KF, state, jstate):
        if name == "xw":  # grounded through the new pose: relative to |xw|
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-4, atol=1e-4)
        else:
            np.testing.assert_array_equal(a.numpy(), b)
    assert bool(fresh) == (row[15] == 0)
    return row, [a.numpy() for a in state]


def test_accepts_a_clean_frame():
    frame, kf, carry, tm = _case(0)
    row, state = _holds_jax_kf(frame, kf, carry, tm)
    assert row[12] > 80 and row[14] == 1 and row[15] == 0  # accepted, since 1 < 2
    np.testing.assert_allclose(row[9:12], [0.1, 0.0, 0.2], atol=5e-3)
    assert int(state[5]) == 1
    np.testing.assert_array_equal(state[1], kf["desc"])  # the keyframe stays


def test_rejects_on_support():
    """3 px noise against support_px 1: fewer than accept_frac x n of the
    usable matches reproject within it, so the frame coasts."""
    frame, kf, carry, tm = _case(1, noise_px=3.0)
    row, _ = _holds_jax_kf(frame, kf, carry, tm, gate={**GATE, "support_px": 1.0})
    assert row[12] >= 10 and row[13] < 0.4 * row[12] and row[14] == 0
    np.testing.assert_allclose(row[9:12], [0.1, 0.0, 0.2], atol=1e-6)  # the prediction


def test_rejects_a_non_finite_solve():
    """A NaN in the previous position: the LM rejects every step, the solve
    stays non-finite, the frame is not accepted and the carry takes the
    prediction (non-finite too), as torch.where and jnp.where select it."""
    frame, kf, carry, tm = _case(2, t_prev=(np.nan, 0.0, 0.1))
    row, _ = _holds_jax_kf(frame, kf, carry, tm)
    assert row[14] == 0 and row[15] == 0 and np.isnan(row[9])
    assert np.isfinite(row[:9]).all()


def test_coasts_below_min_matches():
    frame, kf, carry, tm = _case(3, usable=6)
    row, _ = _holds_jax_kf(frame, kf, carry, tm)
    assert row[12] < 10 and row[14] == 0


@pytest.mark.parametrize("why", ["max_frames", "min_matches", "covis_ratio"])
def test_promotes_and_grounds_the_new_keyframe(why):
    """The gate fires on each of its three reasons (and not before
    kf_min_frames); the frame's features become the keyframe, with world
    points Xw = R_new Xc + t_new from its disparity."""
    gate = dict(GATE, kf_max_frames=99, kf_min_matches=30, covis_ratio=0.5)
    since = 1
    if why == "max_frames":
        gate["kf_max_frames"], since = 5, 4
    elif why == "min_matches":
        gate["kf_min_matches"] = 200
    else:
        gate["covis_ratio"] = 0.9  # ~90 usable of 128 depth-valid features
    frame, kf, carry, tm = _case(4, since=since)
    row, state = _holds_jax_kf(frame, kf, carry, tm, gate=gate)
    assert row[14] == 1 and row[15] == 1
    np.testing.assert_array_equal(state[0], frame["nkl"])
    np.testing.assert_array_equal(state[1], frame["dl"])
    np.testing.assert_array_equal(state[4], frame["stereo_ok"])
    assert int(state[5]) == 0
    # The promoted points land where the keyframe's were (the same world).
    fx, fy, cx, cy, b = CALIB
    z = fx * b / frame["disp"]
    assert np.abs(state[3][:, 2] - (z + 0.2)).max() < 0.05 * z.max()


def test_gate_waits_for_min_frames():
    frame, kf, carry, tm = _case(5, since=0)
    row, _ = _holds_jax_kf(frame, kf, carry, tm, gate=dict(GATE, kf_min_matches=200))
    assert row[14] == 1 and row[15] == 0


@pytest.mark.parametrize("case", ["solve", "coast", "mono"])
def test_track_scan_body_matches_jax(case):
    import jax.numpy as jnp

    from superslam_tpu.ops.frontend_step import track_scan

    frame, kf, carry, tm = _case(6, usable=6 if case == "coast" else 100)
    over = {"mono": case == "mono"}
    row, used, pose, state, fresh, raw = _twin(frame, kf, carry, tm, keyframes=None, **over)
    j = jnp.asarray
    jout, jpose = track_scan(
        *(j(frame[n][None]) for n in ("kl", "disp", "stereo_ok")), j(tm[None]), j(kf["xw"]),
        j(kf["dok"]), tuple(j(c) for c in carry), calib=CALIB, min_matches=10,
        track_sigma_px=1.0 / KW["inv_sig_uLv"], disp_sigma0=KW["disp_sigma0"],
        disp_cond=KW["disp_cond"], mono=over["mono"], gate_px=KW["gate_px"],
        chi2_px=KW["chi2_px"], chi2_rounds=KW["chi2_rounds"])
    row, jrow = row.numpy(), np.asarray(jout[0])
    assert row.shape == (tf.TRACK_COLS,) and fresh is None
    np.testing.assert_allclose(row[:12], jrow[:12], atol=1e-4, rtol=0)
    assert row[12] == jrow[12]
    for a, b in zip(pose, jpose):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4, rtol=0)
    if case == "coast":
        np.testing.assert_allclose(row[9:12], [0.1, 0.0, 0.2], atol=1e-6)


def test_hybrid_selects_the_rematch_once_the_keyframe_moved():
    """fresh False: the frame solves on the re-match, not the entry match."""
    frame, kf, carry, tm = _case(7)
    t = torch.from_numpy
    stale = np.full_like(tm, -1)
    args = (tuple(t(c) for c in carry), tuple(t(frame[n]) for n in _FRAME))
    state = tuple(t(kf[n]) for n in _KF)
    got = tf.track_frame(*args, t(stale), state, keyframes=GATE, rematch=t(tm),
                         fresh=torch.tensor(False), **SOLVE_KW)
    ref = tf.track_frame(*args, t(tm), state, keyframes=GATE, **SOLVE_KW)
    np.testing.assert_array_equal(got[0].numpy(), ref[0].numpy())
    np.testing.assert_array_equal(got[1].numpy(), tm)
    assert not bool(got[4])
    got = tf.track_frame(*args, t(tm), state, keyframes=GATE, rematch=t(stale),
                         fresh=torch.tensor(True), **SOLVE_KW)
    np.testing.assert_array_equal(got[0].numpy(), ref[0].numpy())


# -- a numpy model of what the kernel adds to the solve ------------------------


def count_model(b: np.ndarray) -> int:
    """The kernel's count of a per-feature predicate (pose_solve.cuh's
    Reducer::count): each warp's ballot of its threads' point k, k = 0..3,
    features past K voting 0, their population counts summed in the warp,
    then the warps' counts (exact in f32) added in warp order."""
    bits = np.zeros((PPT, THREADS), bool)
    for k in range(PPT):
        idx = np.arange(THREADS) + k * THREADS
        bits[k] = np.where(idx < b.size, b[np.minimum(idx, b.size - 1)], False)
    ballots = np.packbits(bits.reshape(PPT, -1, 32), axis=-1, bitorder="little").view(np.uint32)
    per_warp = np.array([sum(bin(int(x)).count("1") for x in ballots[:, w, 0])
                         for w in range(THREADS // 32)], np.float32)
    total = np.float32(0)
    for c in per_warp:
        total = np.float32(total + c)
    return int(total)


def reorthonormalize_model(R: np.ndarray) -> np.ndarray:
    """Thread 0's Gram-Schmidt in f32 (track_frame.cu::reorthonormalize)."""
    f = np.float32
    R = R.astype(f)
    with np.errstate(all="ignore"):
        c0 = R[:, 0].copy()
        n0 = np.sqrt(f(c0[0] * c0[0] + c0[1] * c0[1] + c0[2] * c0[2]) + f(1e-20))
        c0 = (c0 / n0).astype(f)
        d = f(c0[0] * R[0, 1] + c0[1] * R[1, 1] + c0[2] * R[2, 1])
        c1 = (R[:, 1] - d * c0).astype(f)
        n1 = np.sqrt(f(c1[0] * c1[0] + c1[1] * c1[1] + c1[2] * c1[2]) + f(1e-20))
        c1 = (c1 / n1).astype(f)
        c2 = np.array([c0[1] * c1[2] - c0[2] * c1[1], c0[2] * c1[0] - c0[0] * c1[2],
                       c0[0] * c1[1] - c0[1] * c1[0]], f)
    return np.stack([c0, c1, c2], axis=1)


def epilogue_model(raw, carry, n, support, nref_count, since, gate, min_matches=10):
    """Thread 0 of the kernel (KF epilogue) in f32: returns (R_new, t_new,
    Rr, tr, accept, promo, since_new)."""
    f = np.float32
    R_s, t_s = raw
    R_prev, t_prev, Rr, tr = (c.astype(f) for c in carry)
    R_pred = (R_prev @ Rr).astype(f)
    t_pred = (R_prev @ tr + t_prev).astype(f)
    finite = bool(np.isfinite(R_s).all() and np.isfinite(t_s).all())
    accept = n >= min_matches and finite
    if gate["accept_frac"] > 0:
        floor = max(f(gate["accept_frac"]) * f(n), f(min_matches))
        accept = accept and f(support) >= floor
    R_new = reorthonormalize_model(R_s if accept else R_pred)
    t_new = t_s if accept else t_pred
    if accept:
        Rr, tr = (R_prev.T @ R_new).astype(f), (R_prev.T @ (t_new - t_prev)).astype(f)
    since1 = since + 1
    ratio_low = f(n) < f(gate["covis_ratio"]) * f(max(nref_count, 1))
    g = since1 >= gate["kf_min_frames"] and (
        since1 >= gate["kf_max_frames"] or n < gate["kf_min_matches"] or ratio_low)
    promo = accept and g
    return R_new, t_new, Rr, tr, accept, promo, 0 if promo else since1


def promoted_points_model(kl, disp, R, t, calib):
    """Each copying rank's promoted world points, in f32."""
    f = np.float32
    fx, fy, cx, cy, b = (f(c) for c in calib)
    z = f(f(CALIB[0] * CALIB[4])) / np.maximum(disp.astype(f), f(1e-3))
    x = (kl[:, 0] - cx) * z / fx
    y = (kl[:, 1] - cy) * z / fy
    return (np.stack([x, y, z], 1).astype(f) @ R.T.astype(f) + t).astype(f)


@pytest.mark.parametrize("k", [1, 31, 255, 256, 600, 1000, 1024])
def test_count_model(k):
    b = np.random.default_rng(k).uniform(size=k) < 0.3
    assert count_model(b) == int(b.sum())


def test_reorthonormalize_model_against_the_twin():
    rng = np.random.default_rng(0)
    for _ in range(20):
        w = rng.normal(size=3) * rng.uniform(0, 2)
        R = torch.linalg.matrix_exp(torch.tensor(
            [[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]], dtype=torch.float64))
        R = (R.numpy() + rng.normal(size=(3, 3)) * 1e-3).astype(np.float32)
        got = reorthonormalize_model(R)
        want = tf._reorthonormalize(torch.from_numpy(R)).numpy()
        np.testing.assert_allclose(got, want, atol=2e-7, rtol=0)
        np.testing.assert_allclose(got.T @ got, np.eye(3), atol=1e-6)
    # A zero first column stays finite through the 1e-20 (0 / 1e-10), as in
    # the twin; without it the column would be 0 / 0.
    R = np.eye(3, dtype=np.float32)
    R[:, 0] = 0
    got = reorthonormalize_model(R)
    want = tf._reorthonormalize(torch.from_numpy(R)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", range(8))
def test_epilogue_model_against_the_twin(seed):
    """Random solves around the prediction, random counts near the floor and
    gates: the model's bits equal the twin epilogue's, its poses and
    promoted points agree to f32 rounding."""
    rng = np.random.default_rng(seed)
    frame, kf, carry, tm = _case(10 + seed, since=int(rng.integers(0, 6)))
    w = rng.normal(size=3) * 0.002
    R_s = torch.linalg.matrix_exp(torch.tensor(
        [[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])).numpy().astype(np.float32)
    t_s = (np.array([0.1, 0.0, 0.2]) + rng.normal(size=3) * 0.003).astype(np.float32)
    if seed == 7:
        t_s[1] = np.nan
    gate = dict(GATE, accept_frac=float(rng.choice([0.0, 0.4, 0.9])),
                support_px=float(rng.choice([0.5, 4.0])), kf_max_frames=int(rng.integers(2, 8)),
                covis_ratio=float(rng.uniform(0.3, 1.0)))
    kf["dok"] = rng.uniform(size=tm.size) < 0.8
    t = torch.from_numpy
    n = int(((tm >= 0) & frame["stereo_ok"][np.maximum(tm, 0)] & kf["dok"]).sum())
    raw = (t(R_s), t(t_s), torch.tensor(n), torch.tensor(n))
    row, _used, pose, state, _fresh = tf.track_frame_epilogue_plain(
        raw, tuple(t(c) for c in carry), tuple(t(frame[x]) for x in _FRAME), t(tm),
        tuple(t(kf[x]) for x in _KF), calib=CALIB, min_matches=10, keyframes=gate)
    row = row.numpy()
    support = int(row[13])
    R_new, t_new, Rr, tr, accept, promo, since_new = epilogue_model(
        (R_s, t_s), carry, n, support, count_model(kf["dok"]), int(kf["since"]), gate)
    assert (row[14], row[15]) == (float(accept), float(promo))
    assert int(state[5]) == since_new
    np.testing.assert_allclose(row[:9], R_new.reshape(9), atol=1e-6, rtol=0)
    np.testing.assert_allclose(row[9:12], t_new, atol=1e-6, rtol=0)
    np.testing.assert_allclose(pose[2].numpy(), Rr, atol=1e-6, rtol=0)
    np.testing.assert_allclose(pose[3].numpy(), tr, atol=1e-6, rtol=0)
    if promo:
        xw = promoted_points_model(frame["kl"], frame["disp"], R_new, t_new, CALIB)
        np.testing.assert_allclose(state[3].numpy(), xw, rtol=1e-5, atol=1e-5)

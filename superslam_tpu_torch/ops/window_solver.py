"""Windowed-BA reduced camera system as batched tensor linear algebra.

Port of ``superslam_tpu/ops/window_solver.py``: the device re-expression of
WindowSmoother's variable-projection smart-stereo linearization
(``core/window_smoother.py``): batched point triangulation (Gauss-Newton,
poses fixed), per-landmark 3x3 Schur elimination and scatter-assembly of
the dense 6K x 6K reduced system, all in f32 under
``precision.highest_f32_matmuls``.

The host numpy path is the accuracy oracle (f64) and stays the default:
each solve here is a chain of a few thousand small launches (5
triangulation iterations, one assembly and one trial error per LM
iteration), several milliseconds of host time for a window's small
FLOP count. ``SUPERSLAM_XLA_SMOOTHER=1`` selects it
(``WindowSmoother._lm_xla``).

The JAX package's ``lax.while_loop`` is ``max_iters`` iterations whose
updates are masked by ``done`` (``torch.where`` on R, t, lam and err):
once ``done`` is set nothing changes, as the JAX loop stops running its
body, and nothing is read back until the caller's copy of the result.
Linear solves are ``torch.linalg.solve_ex``: a singular system gives
non-finite values (as ``jnp.linalg.solve``) instead of raising, and the
``ok`` test rejects the step.

Layout: a window of K poses (R (K, 3, 3), t (K, 3)) and one landmark group
of track length m: views (L, m) integer, meas (L, m, 3) f32, lm_valid (L,)
bool. Isotropic measurement sigma; dynamic outlier threshold in px.
"""

from __future__ import annotations

import torch

from .pose_solver import _retract, _se3_log
from .precision import highest_f32_matmuls


def _proj_residuals(p, iz, meas, fx, fy, cx, cy, baseline):
    proj_uL = fx * p[..., 0] * iz + cx
    proj_uR = fx * (p[..., 0] - baseline) * iz + cx
    proj_v = fy * p[..., 1] * iz + cy
    return torch.stack([proj_uL, proj_uR, proj_v], dim=-1) - meas


def _proj_jacobian(p, iz, fx, fy, baseline):
    iz2 = iz * iz
    z = torch.zeros_like(iz)
    row0 = torch.stack([fx * iz, z, -fx * p[..., 0] * iz2], dim=-1)
    row1 = torch.stack([fx * iz, z, -fx * (p[..., 0] - baseline) * iz2], dim=-1)
    row2 = torch.stack([z, fy * iz, -fy * p[..., 1] * iz2], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)  # (..., 3, 3)


def _obs_weights(views, obs_valid):
    if obs_valid is None:
        return torch.ones(views.shape, dtype=torch.float32, device=views.device)
    return obs_valid.to(torch.float32)


def _camera_points(Rv, tv, X):
    return torch.einsum("lmji,lmj->lmi", Rv, X[:, None, :] - tv)


def _solve(A, b):
    """A x = b without raising on a singular A (LU; non-finite x then)."""
    return torch.linalg.solve_ex(A, b)[0]


@highest_f32_matmuls()
def triangulate(R, t, views, meas, calib, iters: int = 5, obs_valid=None):
    """Batched GN point triangulation. Returns (X (L, 3), ok (L,)).

    obs_valid (L, m) optionally masks padded observations (tracks shorter
    than the group length); the FIRST observation of every landmark must be
    valid (callers sort valid observations first)."""
    fx, fy, cx, cy, baseline = calib
    views = views.long()
    Rv = R[views]  # (L, m, 3, 3)
    tv = t[views]  # (L, m, 3)
    ov = _obs_weights(views, obs_valid)

    uL0, uR0, v0 = meas[:, 0, 0], meas[:, 0, 1], meas[:, 0, 2]
    disp0 = uL0 - uR0
    ok = disp0 > 1e-6
    z0 = fx * baseline / torch.where(ok, disp0, torch.ones_like(disp0))
    cam0 = torch.stack([(uL0 - cx) * z0 / fx, (v0 - cy) * z0 / fy, z0], dim=1)
    X = torch.einsum("lij,lj->li", Rv[:, 0], cam0) + tv[:, 0]
    eye = torch.eye(3, dtype=X.dtype, device=X.device)

    # The JAX package's fori_loop: a fixed count, no value read back.
    for _ in range(iters):
        p = _camera_points(Rv, tv, X)
        z = p[..., 2]
        ok = ok & torch.all((z > 1e-9) | (ov < 0.5), dim=1)
        iz = 1.0 / torch.where(z > 1e-9, z, torch.ones_like(z))
        r = _proj_residuals(p, iz, meas, fx, fy, cx, cy, baseline) * ov[..., None]
        Jp = _proj_jacobian(p, iz, fx, fy, baseline) * ov[..., None, None]
        Jx = torch.einsum("lmij,lmkj->lmik", Jp, Rv)
        A = torch.einsum("lmij,lmik->ljk", Jx, Jx) + 1e-9 * eye
        g = torch.einsum("lmij,lmi->lj", Jx, r)
        delta = -_solve(A, g[..., None])[..., 0]
        X = X + torch.where(ok[:, None], delta, torch.zeros_like(delta))

    p = _camera_points(Rv, tv, X)
    ok = ok & torch.all((p[..., 2] > 1e-9) | (ov < 0.5), dim=1)
    ok = ok & torch.isfinite(X).all(dim=1)
    return X, ok


def _keep_and_residuals(R, t, views, meas, lm_valid, obs_valid, calib, dyn_outlier_px):
    """Triangulate, project and gate: (p, iz, r, ov, keep, Rv)."""
    fx, fy, cx, cy, baseline = calib
    views = views.long()
    ov = _obs_weights(views, obs_valid)
    X, ok = triangulate(R, t, views, meas, calib, obs_valid=obs_valid)
    Rv, tv = R[views], t[views]
    p = _camera_points(Rv, tv, X)
    z = p[..., 2]
    iz = 1.0 / torch.where(z > 1e-9, z, torch.ones_like(z))
    r = _proj_residuals(p, iz, meas, fx, fy, cx, cy, baseline) * ov[..., None]
    maxerr = torch.amax(torch.linalg.vector_norm(r, dim=-1), dim=-1)
    # dyn_outlier_px <= 0 disables the dynamic gate (the smoother pre-filters
    # outliers at the seed poses and passes 0 down; window_smoother.py).
    keep = ok & lm_valid
    if dyn_outlier_px > 0:
        keep = keep & (maxerr < dyn_outlier_px)
    return p, iz, r, ov, keep, Rv


@highest_f32_matmuls()
def build_reduced_system(
    R: torch.Tensor,  # (K, 3, 3)
    t: torch.Tensor,  # (K, 3)
    views: torch.Tensor,  # (L, m) integer
    meas: torch.Tensor,  # (L, m, 3)
    lm_valid: torch.Tensor,  # (L,) bool (padding mask)
    calib: tuple,  # (fx, fy, cx, cy, baseline)
    inv_sigma: float,
    dyn_outlier_px: float,
    num_poses: int,
    obs_valid: torch.Tensor | None = None,  # (L, m) per-observation mask
    huber_k: float = 0.0,
):
    """Returns (H (6K, 6K), b (6K,), error scalar), Schur-reduced over the
    landmark group, with ZERO_ON_DEGENERACY + dynamic outlier rejection
    folded in as masks. With obs_valid, one padded (L, m_max) group covers
    mixed track lengths (valid observations must come first per landmark)."""
    fx, fy, _cx, _cy, baseline = calib
    K = num_poses
    views = views.long()
    p, iz, r, ov, keep, Rv = _keep_and_residuals(
        R, t, views, meas, lm_valid, obs_valid, calib, dyn_outlier_px
    )
    wl = keep.to(torch.float32)  # (L,)

    Jp = _proj_jacobian(p, iz, fx, fy, baseline) * ov[..., None, None]
    L, m = views.shape
    # d p_cam / d xi = [skew(p_cam), -I] (right retraction, rotation-first).
    zeros = torch.zeros_like(p[..., 0])
    one = -torch.ones_like(zeros)
    Dcam = torch.stack(
        [
            torch.stack([zeros, -p[..., 2], p[..., 1], one, zeros, zeros], -1),
            torch.stack([p[..., 2], zeros, -p[..., 0], zeros, one, zeros], -1),
            torch.stack([-p[..., 1], p[..., 0], zeros, zeros, zeros, one], -1),
        ],
        dim=-2,
    )  # (L, m, 3, 6)
    U = torch.einsum("lmij,lmjk->lmik", Jp, Dcam) * inv_sigma
    Jx = torch.einsum("lmij,lmkj->lmik", Jp, Rv) * inv_sigma
    rw = r * inv_sigma
    # IRLS Huber (huber_k > 0): scale each view's whitened residual and
    # Jacobians by sqrt(min(1, k / e)), as WindowSmoother._build_reduced_system.
    if huber_k > 0:
        e = torch.linalg.vector_norm(rw, dim=-1)  # (L, m); padded views give e = 0
        sw = torch.sqrt(torch.clamp(huber_k / torch.clamp(e, min=1e-12), max=1.0))
        U = U * sw[..., None, None]
        Jx = Jx * sw[..., None, None]
        rw = rw * sw[..., None]

    # Zero dropped landmarks so their Schur terms vanish.
    U = U * wl[:, None, None, None]
    rw = rw * wl[:, None, None]

    A = torch.einsum("lmij,lmik->ljk", Jx, Jx) + 1e-6 * torch.eye(
        3, dtype=Jx.dtype, device=Jx.device
    )
    Ainv = torch.linalg.inv_ex(A)[0]
    W = torch.einsum("lmij,lmik->lmjk", U, Jx)  # (L, m, 6, 3)
    gx = torch.einsum("lmij,lmi->lj", Jx, rw)
    Ainv_gx = torch.einsum("lij,lj->li", Ainv, gx)

    Hdiag = torch.einsum("lmij,lmik->lmjk", U, U)  # (L, m, 6, 6)
    gdiag = torch.einsum("lmij,lmi->lmj", U, rw)
    gcorr = torch.einsum("lmjk,lk->lmj", W, Ainv_gx)
    WAinv = torch.einsum("lmjk,lki->lmji", W, Ainv)
    corr = torch.einsum("lmji,lnki->lmnjk", WAinv, W)  # (L, m, m, 6, 6)

    Hblk = torch.zeros((K, K, 6, 6), dtype=U.dtype, device=U.device)
    bblk = torch.zeros((K, 6), dtype=U.dtype, device=U.device)
    bblk.index_put_((views,), gdiag - gcorr, accumulate=True)
    Hblk.index_put_((views, views), Hdiag, accumulate=True)
    vj_b = views[:, :, None].expand(L, m, m)
    vk_b = views[:, None, :].expand(L, m, m)
    Hblk.index_put_((vj_b, vk_b), -corr, accumulate=True)

    H = Hblk.permute(0, 2, 1, 3).reshape(6 * K, 6 * K)
    b = bblk.reshape(6 * K)
    err = 0.5 * torch.sum(rw * rw)
    return H, b, err


def _window_error(R, t, views, meas, lm_valid, obs_valid, calib, inv_sigma, dyn_px,
                  huber_k=0.0):
    _p, _iz, r, _ov, keep, _Rv = _keep_and_residuals(
        R, t, views, meas, lm_valid, obs_valid, calib, dyn_px
    )
    rw = r * inv_sigma * keep.to(torch.float32)[:, None, None]
    e = torch.linalg.vector_norm(rw, dim=-1)  # (L, m) whitened per-view norms
    if huber_k > 0:
        rho = torch.where(e > huber_k, huber_k * e - 0.5 * huber_k * huber_k, 0.5 * e * e)
    else:
        rho = 0.5 * e * e
    return torch.sum(rho)


@torch.no_grad()
@highest_f32_matmuls()
def solve_window(
    R0: torch.Tensor,  # (K, 3, 3) seed rotations (Twc)
    t0: torch.Tensor,  # (K, 3) seed translations
    views: torch.Tensor,  # (L, m) integer
    meas: torch.Tensor,  # (L, m, 3) f32
    lm_valid: torch.Tensor,  # (L,) bool
    obs_valid: torch.Tensor,  # (L, m) bool (valid observations FIRST per row)
    calib: tuple,
    inv_sigma: float,
    dyn_outlier_px: float,
    prior_info: float,
    num_poses: int,
    max_iters: int = 4,
    huber_k: float = 0.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The full smart-stereo window LM on the device (WindowSmoother._lm
    semantics: gauge prior on pose 0, accept/reject damping, tol 1e-3) as
    ``max_iters`` masked iterations. Returns (R, t) on R0's device."""
    K = num_poses
    views = views.long()

    def prior_err(R, t):
        # Log(prior^-1 * pose0); prior = the seed pose of pose 0.
        dR = R0[0].T @ R[0]
        dt = R0[0].T @ (t[0] - t0[0])
        dxi = _se3_log(dR, dt)
        return 0.5 * prior_info * (dxi @ dxi), dxi

    def total_error(R, t):
        e, _ = prior_err(R, t)
        return e + _window_error(R, t, views, meas, lm_valid, obs_valid, calib, inv_sigma,
                                 dyn_outlier_px, huber_k)

    def retract_all(R, t, delta):
        Rs, ts = [], []
        for i in range(K):  # K is small
            Ri, ti = _retract(R[i], t[i], delta[6 * i : 6 * i + 6])
            Rs.append(Ri)
            ts.append(ti)
        return torch.stack(Rs), torch.stack(ts)

    eye6 = torch.eye(6, dtype=R0.dtype, device=R0.device)
    R, t = R0, t0
    err = total_error(R0, t0)
    lam = torch.tensor(1e-5, dtype=torch.float32, device=R0.device)
    done = torch.tensor(False, device=R0.device)
    for _ in range(max_iters):
        H, b, _ = build_reduced_system(
            R, t, views, meas, lm_valid, calib, inv_sigma, dyn_outlier_px,
            num_poses=K, obs_valid=obs_valid, huber_k=huber_k,
        )
        _, dxi0 = prior_err(R, t)
        H = H.clone()
        H[:6, :6] += prior_info * eye6
        b = b.clone()
        b[:6] += prior_info * dxi0
        # Marquardt damping (lam * diag(H)) plus an absolute floor: in f32 a
        # pose block can be near-singular when the dynamic outlier gate
        # rejects most landmarks at a poor seed, and pure additive damping
        # then turns numerical residue into a huge step that the masked
        # error spuriously accepts (fewer surviving landmarks, smaller error).
        damp = lam * (torch.diagonal(H) + 1.0)
        delta = _solve(H + torch.diag(damp), -b)
        ok = torch.isfinite(delta).all() & (torch.linalg.vector_norm(delta) < 1e3)
        Rn, tn = retract_all(R, t, torch.where(ok, delta, torch.zeros_like(delta)))
        new_err = total_error(Rn, tn)
        # Once done, the JAX loop runs no more bodies: nothing moves.
        accept = ok & (new_err < err) & ~done
        R = torch.where(accept, Rn, R)
        t = torch.where(accept, tn, t)
        improvement = err - new_err
        err = torch.where(accept, new_err, err)
        lam_next = torch.where(accept, torch.clamp(lam * 0.1, min=1e-10), lam * 10.0)
        lam = torch.where(done, lam, lam_next)
        done = done | (accept & (improvement < 1e-3 * torch.clamp(err, min=1.0))) | (lam > 1e8)
    return R, t

"""Pose-only stereo Levenberg-Marquardt on PyTorch tensors.

Port of ``superslam_tpu/ops/pose_solver.py``: the tensor re-expression of
FrameTracker (``core/frame_tracker.py`` / the C++ core's pose-only LM). N
pose-only stereo factors with Huber over the disparity-aware diagonal
noise, solved by LM in f32 on padded, masked inputs, so it can run on the
frames' device inside the per-frame tracking step. The JAX package's
``lax.while_loop`` is a Python loop here; its exit test reads one boolean
from the device per iteration. The numpy / C++ solvers remain the f64
oracles (``tests/test_torch_pose_solver.py``).

SE(3) is (R (3, 3), t (3,)) with the same rotation-first right retraction
as ``geometry/se3.py``. This is the plain version of the solve: on the card
the tracking chains run the whole per-frame body, this loop included, as
one kernel (``ops/cuda/track_frame.py``).
"""

from __future__ import annotations

import torch

from .precision import highest_f32_matmuls

HUBER_K = 2.7955  # sqrt(7.815)


def _skew(w):
    z = torch.zeros((), dtype=w.dtype, device=w.device)
    return torch.stack(
        [
            torch.stack([z, -w[2], w[1]]),
            torch.stack([w[2], z, -w[0]]),
            torch.stack([-w[1], w[0], z]),
        ]
    )


def _eye(like):
    return torch.eye(3, dtype=like.dtype, device=like.device)


def _so3_exp(w):
    th2 = w @ w
    W = _skew(w)
    W2 = W @ W
    th = torch.sqrt(th2 + 1e-20)
    small = th2 < 1e-12
    a = torch.where(small, torch.ones_like(th), torch.sin(th) / th)
    b = torch.where(small, torch.full_like(th, 0.5), (1.0 - torch.cos(th)) / th2)
    return _eye(w) + a * W + b * W2


def _se3_exp(xi):
    w, v = xi[:3], xi[3:]
    th2 = w @ w
    W = _skew(w)
    W2 = W @ W
    th = torch.sqrt(th2 + 1e-20)
    small = th2 < 1e-12
    b = torch.where(small, torch.full_like(th, 0.5), (1.0 - torch.cos(th)) / th2)
    c = torch.where(small, torch.full_like(th, 1.0 / 6.0), (th - torch.sin(th)) / (th2 * th))
    V = _eye(xi) + b * W + c * W2
    return _so3_exp(w), V @ v


def _so3_log(R):
    tr = R[0, 0] + R[1, 1] + R[2, 2]
    c = torch.clamp((tr - 1.0) * 0.5, -1.0, 1.0)
    th = torch.arccos(c)
    v = torch.stack([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    f = torch.where(
        th < 1e-6, torch.full_like(th, 0.5), th / (2.0 * torch.sin(torch.clamp(th, min=1e-9)))
    )
    return f * v  # not valid within ~1e-6 of pi (fine for residual use)


def _se3_log(R, t):
    w = _so3_log(R)
    th2 = w @ w
    W = _skew(w)
    W2 = W @ W
    th = torch.sqrt(th2 + 1e-20)
    half = 0.5 * th
    cot_term = torch.where(
        th2 < 1e-12,
        torch.full_like(th, 1.0 / 12.0),
        (1.0 - half / torch.tan(torch.clamp(half, min=1e-9))) / th2,
    )
    Vi = _eye(R) - 0.5 * W + cot_term * W2
    return torch.cat([w, Vi @ t])


def _retract(R, t, xi):
    dR, dt = _se3_exp(xi)
    return R @ dR, R @ dt + t


def _residuals(R, t, Xw, meas, calib):
    """(N, 3) residuals, camera-frame points, 1/z and the (N,) cheirality
    mask. calib = (fx, fy, cx, cy, baseline)."""
    fx, fy, cx, cy, baseline = calib
    p = (Xw - t) @ R  # (N, 3) camera frame
    z = p[:, 2]
    good = z > 1e-9
    iz = 1.0 / torch.where(good, z, torch.ones_like(z))
    r = torch.stack(
        [
            fx * p[:, 0] * iz + cx - meas[:, 0],
            fx * (p[:, 0] - baseline) * iz + cx - meas[:, 1],
            fy * p[:, 1] * iz + cy - meas[:, 2],
        ],
        dim=1,
    )
    r = torch.where(good[:, None], r, torch.full_like(r, 2.0 * fx))  # cheirality escape hatch
    return r, p, iz, good


def _huber(norms):
    return torch.where(
        norms <= HUBER_K, 0.5 * norms**2, HUBER_K * norms - 0.5 * HUBER_K**2
    )


def _system(R, t, Xw, meas, inv_sig, valid, calib):
    """Huber-IRLS normal equations: (H (6, 6), g (6,), robust error)."""
    fx, fy, _, _, baseline = calib
    r, p, iz, good = _residuals(R, t, Xw, meas, calib)
    iz2 = iz * iz
    zeros = torch.zeros_like(iz)
    Jp = torch.stack(
        [
            torch.stack([fx * iz, zeros, -fx * p[:, 0] * iz2], 1),
            torch.stack([fx * iz, zeros, -fx * (p[:, 0] - baseline) * iz2], 1),
            torch.stack([zeros, fy * iz, -fy * p[:, 1] * iz2], 1),
        ],
        dim=1,
    )  # (N, 3, 3)
    ones = torch.ones_like(zeros)
    Dcam = torch.stack(
        [
            torch.stack([zeros, -p[:, 2], p[:, 1], -ones, zeros, zeros], 1),
            torch.stack([p[:, 2], zeros, -p[:, 0], zeros, -ones, zeros], 1),
            torch.stack([-p[:, 1], p[:, 0], zeros, zeros, zeros, -ones], 1),
        ],
        dim=1,
    )  # (N, 3, 6)
    J = torch.einsum("nij,njk->nik", Jp, Dcam)
    J = torch.where(good[:, None, None], J, torch.zeros_like(J))

    rw = r * inv_sig
    Jw = J * inv_sig[:, :, None]
    norms = torch.linalg.norm(rw, dim=1)
    w = torch.where(
        norms <= HUBER_K, torch.ones_like(norms), HUBER_K / torch.clamp(norms, min=1e-12)
    )
    w = w * valid
    H = torch.einsum("n,nij,nik->jk", w, Jw, Jw)
    g = torch.einsum("n,nij,ni->j", w, Jw, rw)
    err = torch.sum(_huber(norms) * valid)
    return H, g, err


def _error(R, t, Xw, meas, inv_sig, valid, calib):
    r, _, _, _ = _residuals(R, t, Xw, meas, calib)
    norms = torch.linalg.norm(r * inv_sig, dim=1)
    return torch.sum(_huber(norms) * valid)


@torch.no_grad()
@highest_f32_matmuls()
def pose_only_lm_impl(
    R0: torch.Tensor,  # (3, 3) initial rotation (Twc)
    t0: torch.Tensor,  # (3,)
    Xw: torch.Tensor,  # (N, 3) world points, padded
    meas: torch.Tensor,  # (N, 3) (uL, uR, v)
    inv_sig: torch.Tensor,  # (N, 3) inverse diagonal sigmas
    valid: torch.Tensor,  # (N,) 0/1 padding mask
    calib: tuple,  # (fx, fy, cx, cy, baseline) floats
    max_iters: int = 20,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (R, t). LM with multiplicative damping adaptation: each
    iteration solves once at the current lambda and accepts or rejects, up
    to ``max_iters`` iterations, stopping once an accepted step improves
    the error by less than 1e-4 of it or lambda passes 1e8."""
    valid = valid.to(torch.float32)
    R, t = R0, t0
    lam = torch.tensor(1e-5, dtype=torch.float32, device=R0.device)
    err = _error(R, t, Xw, meas, inv_sig, valid, calib)
    eye6 = torch.eye(6, dtype=torch.float32, device=R0.device)
    for _ in range(max_iters):
        H, g, _ = _system(R, t, Xw, meas, inv_sig, valid, calib)
        # solve_ex reports a singular system through non-finite values and
        # `info` instead of raising, as jnp.linalg.solve does.
        delta, _info = torch.linalg.solve_ex(H + lam * eye6, -g)
        ok = torch.isfinite(delta).all()
        Rn, tn = _retract(R, t, torch.where(ok, delta, torch.zeros_like(delta)))
        new_err = _error(Rn, tn, Xw, meas, inv_sig, valid, calib)
        accept = ok & (new_err < err)
        R = torch.where(accept, Rn, R)
        t = torch.where(accept, tn, t)
        improvement = err - new_err
        err = torch.where(accept, new_err, err)
        lam = torch.where(accept, torch.clamp(lam * 0.1, min=1e-10), lam * 10.0)
        done = (accept & (improvement < 1e-4 * torch.clamp(err, min=1.0))) | (lam > 1e8)
        if bool(done):
            break
    return R, t


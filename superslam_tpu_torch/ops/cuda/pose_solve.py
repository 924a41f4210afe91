"""One frame's prior-gated pose-only LM solve in one launch.

``pose_solve`` is the solve of each frame of the device tracking chains
(``ops/frontend_step.py::track_scan``, ``track_kf_scan``): the port of
``superslam_tpu/ops/frontend_step.py::_frame_solve`` around
``superslam_tpu/ops/pose_solver.py::pose_only_lm_impl`` (XLA there, the LM
a ``lax.while_loop``). The chains run it inside their whole per-frame body,
one launch of ``track_frame.cu`` (``ops/cuda/track_frame.py``); this is
its own entry point. On a CUDA tensor it launches the kernel
``pose_solve.cu`` (the solve of ``pose_solve.cuh``, whose header says how
the block computes it): the whole solve, early exits included, on the
device, with no value read by the host. A CPU tensor goes through the
plain version ``pose_solve_plain``, the same function in PyTorch, whose
LM reads its exit test from the tensor once an iteration; the tracking
kernel's twin calls it.

The kernel sums in another order than PyTorch, so it agrees with the plain
version to f32 rounding: chip_smoke.py and tests/test_torch_kernels_gpu.py
state the tolerances.
"""

from __future__ import annotations

import torch

from ..pose_solver import pose_only_lm_impl
from . import _build

MAX_K = 1024  # pose_solve.cu's KMAX: 256 threads x 4 points


def pose_solve_plain(
    R_prev, t_prev, R_pred, t_pred, kl, disp, stereo_ok, tm, kf_xw, kf_dok, *, calib,
    min_matches, inv_sig_uLv, disp_sigma0, disp_cond, mono, gate_px, chi2_px, chi2_rounds,
    track_iters,
):
    """The plain version (arguments and results as ``pose_solve``)."""
    fx, fy, cx, cy, _ = calib
    fi = torch.clamp(tm, min=0).to(torch.int64)
    uL = kl[:, 0][fi]
    v = kl[:, 1][fi]
    d = disp[fi]
    ok = (tm >= 0) & stereo_ok[fi] & kf_dok
    meas = torch.stack([uL, uL - d, v], dim=1)
    dc = torch.clamp(d, min=1e-3)
    ratio = disp_cond / dc
    if mono:
        inv_sig_uR = torch.zeros_like(dc)
    else:
        inv_sig_uR = 1.0 / (disp_sigma0 * torch.sqrt(1.0 + ratio * ratio))
    uLv = torch.full_like(dc, inv_sig_uLv)
    inv_sig = torch.stack([uLv, inv_sig_uR, uLv], dim=1)
    n = torch.sum(ok)
    uv = torch.stack([uL, v], dim=1)

    def solve(R, t, keep):
        return pose_only_lm_impl(
            R, t, kf_xw, meas, inv_sig, keep.to(torch.float32), calib, track_iters
        )

    keep = ok
    if gate_px > 0:
        r0, zok0 = reprojection(R_pred, t_pred, kf_xw, uv, calib)
        k0 = ok & zok0 & (r0 < gate_px)
        keep = torch.where(torch.sum(k0) >= min_matches, k0, ok)
    R_s, t_s = solve(R_prev, t_prev, keep)
    for _ in range(chi2_rounds):
        r, zok = reprojection(R_s, t_s, kf_xw, uv, calib)
        k2 = ok & zok & (r < chi2_px)
        # A round without enough inliers ends the re-solves (the JAX scan
        # body runs and discards the remaining rounds instead).
        if int(torch.sum(k2)) < min_matches:
            break
        keep = k2
        R_s, t_s = solve(R_s, t_s, keep)
    return R_s, t_s, n, ok, torch.sum(keep), uv


def reprojection(R, t, xw, uv, calib):
    """Left-image reprojection distance of the world points xw at the pose
    (R, t) against uv (K, 2), and z > 0.1 (the gate's, chi2's and the support
    count's residual)."""
    fx, fy, cx, cy, _ = calib
    p = (xw - t) @ R  # rows are R^T (X - t), camera frame
    z = p[:, 2]
    zok = z > 0.1
    zs = torch.where(zok, z, torch.ones_like(z))
    uL_hat = fx * p[:, 0] / zs + cx
    v_hat = fy * p[:, 1] / zs + cy
    return torch.hypot(uL_hat - uv[:, 0], v_hat - uv[:, 1]), zok


def pose_solve(
    R_prev, t_prev, R_pred, t_pred, kl, disp, stereo_ok, tm, kf_xw, kf_dok, *, calib,
    min_matches, inv_sig_uLv, disp_sigma0, disp_cond, mono, gate_px, chi2_px, chi2_rounds,
    track_iters,
):
    """One frame's solve (the semantics are documented on
    ``ops/frontend_step.py::track_scan``).

    R_prev, R_pred (3, 3) and t_prev, t_pred (3,) f32: the previous pose (the
    LM's start) and the constant-velocity prediction (the gate's pose); kl
    (K, 2) f32 the frame's left keypoints in pixels; disp (K,) f32; stereo_ok
    (K,) bool; tm (K,) integer, the frame keypoint each keyframe feature
    matched or -1; kf_xw (K, 3) f32 keyframe world points; kf_dok (K,) bool.

    Returns (R_s (3, 3), t_s (3,), n, ok (K,) bool, kept, uv (K, 2)): the
    solved pose, the usable-match count, the usable-match mask, the size of
    the last kept set and each keyframe feature's matched (uL, v)."""
    if kl.device.type == "cpu":
        return pose_solve_plain(
            R_prev, t_prev, R_pred, t_pred, kl, disp, stereo_ok, tm, kf_xw, kf_dok,
            calib=calib, min_matches=min_matches, inv_sig_uLv=inv_sig_uLv,
            disp_sigma0=disp_sigma0, disp_cond=disp_cond, mono=mono, gate_px=gate_px,
            chi2_px=chi2_px, chi2_rounds=chi2_rounds, track_iters=track_iters,
        )
    if kl.device.type != "cuda":
        raise ValueError(f"pose_solve: unsupported device {kl.device}")
    k = kl.shape[0]
    if not 1 <= k <= MAX_K:
        raise ValueError(f"pose_solve: {k} correspondences, the kernel takes 1..{MAX_K}")
    f32 = (R_prev, t_prev, R_pred, t_pred, kl, disp, kf_xw)
    if any(t.dtype != torch.float32 or t.device != kl.device for t in f32):
        raise ValueError("pose_solve: poses, keypoints, disparities and world points must be "
                         "f32 on one device")
    if stereo_ok.dtype != torch.bool or kf_dok.dtype != torch.bool:
        raise ValueError("pose_solve: stereo_ok and kf_dok must be bool")
    if tm.dtype != torch.int32:
        tm = tm.to(torch.int32)
    ins = [t.contiguous() for t in (R_prev, t_prev, R_pred, t_pred, kl, disp, stereo_ok, tm,
                                    kf_xw, kf_dok)]
    dev = kl.device
    pose = torch.empty(12, dtype=torch.float32, device=dev)
    stats = torch.empty(2, dtype=torch.int32, device=dev)
    ok = torch.empty(k, dtype=torch.bool, device=dev)
    uv = torch.empty((k, 2), dtype=torch.float32, device=dev)
    fx, fy, cx, cy, baseline = (float(c) for c in calib)
    err = _build.library().ssl_pose_solve(
        *(t.data_ptr() for t in ins), pose.data_ptr(), stats.data_ptr(), ok.data_ptr(),
        uv.data_ptr(), k, fx, fy, cx, cy, baseline, int(min_matches), float(inv_sig_uLv),
        float(disp_sigma0), float(disp_cond), int(bool(mono)), float(gate_px), float(chi2_px),
        int(chi2_rounds), int(track_iters), _build.stream_of(kl),
    )
    _build.check(err, "pose_solve")
    _build.count("pose_solve")
    return pose[:9].view(3, 3), pose[9:], stats[0], ok, stats[1], uv

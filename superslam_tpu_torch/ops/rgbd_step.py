"""The fused per-frame step of the RGB-D path.

Port of ``superslam_tpu/ops/rgbd_step.py``. RGB-D needs no stereo match
(depth comes from the sensor), but the frame-to-keyframe track match is
still a per-frame LightGlue call, so the step fuses: normalize ->
SuperPoint -> top-K select -> LightGlue KF<->frame match -> one packed
(3, K) int16 block (kpt x with -1 marking invalid, kpt y, track match idx).
Depth sampling, undistortion and uR synthesis stay on the host: the depth
image never goes to the device (the reference's RgbdFrontEnd split,
src/RgbdFrontEnd.cc:23-58).

It reuses the stereo step's pieces (``ops/frontend_step.py``): SuperPoint
with the conv-pair and NMS kernels, the selection, LightGlue on the fused
blocks, ``extract_matches``, ``PACK_SCALE`` and ``track_scan``, whose
per-frame body is one ``track_frame`` launch on the card. On the card
nothing in these steps reads a value back to the host.
"""

from __future__ import annotations

import torch

from ..models.lightglue import extract_matches, lightglue_forward
from ..models.superpoint import select_keypoints, superpoint_dense
from ..utils.env import env_flag
from ..utils.profiler import profile_scope
from .frontend_step import PACK_SCALE, _norm_frame, track_scan
from .precision import highest_f32_matmuls

# int16 rows: [kpt x (<0 = invalid), kpt y, track match idx]; x and y in
# 1/PACK_SCALE px fixed point (sub-pixel refined keypoints).
RGBD_PACK_ROWS = 3


@torch.inference_mode()
@highest_f32_matmuls()
def fused_rgbd_step_multi(
    sp_params,
    lg_params,
    images_u8: torch.Tensor,  # (S, H, W) uint8, padded
    kf_kpts: torch.Tensor,  # (K, 2) f32 pixel coords of the last keyframe
    kf_desc: torch.Tensor,  # (K, D)
    kf_valid: torch.Tensor,  # (K,) bool
    max_keypoints: int,
    keypoint_threshold: float,
    remove_borders: int,
    nms_radius: int,
    true_width: int,
    true_height: int,
    match_threshold: float,
):
    """S consecutive frames in one step: S track matches against the shared
    keyframe state in one LightGlue forward, one packed (S*RGBD_PACK_ROWS, K)
    block. Frame s owns rows [s*RGBD_PACK_ROWS, (s+1)*RGBD_PACK_ROWS).

    Returns (packed int16, desc (S, K, D), kpts (S, K, 2), valid (S, K))."""
    with profile_scope("step"):
        S = images_u8.shape[0]
        with profile_scope("detect"):
            images = images_u8.float() / 255.0
            subpixel = env_flag("SUPERSLAM_SP_SUBPIXEL", True)
            out = superpoint_dense(
                sp_params, images, nms_radius=nms_radius, return_pre_nms=subpixel
            )
        with profile_scope("select"):
            kpts, _scores, valid, desc = select_keypoints(
                out[0], out[1], max_keypoints, keypoint_threshold, remove_borders, true_width,
                true_height, raw_scores=out[2] if subpixel else None,
            )
            center, scale = _norm_frame(true_width, true_height, kpts.device)
            nk = (kpts - center) / scale
        with profile_scope("match"):
            kf_k = ((kf_kpts - center) / scale)[None].expand(S, -1, -1)
            kf_d = kf_desc[None].to(desc.dtype).expand(S, -1, -1)
            kf_v = kf_valid[None].expand(S, -1)
            la = lightglue_forward(lg_params, kf_k, kf_d, nk, desc, kf_v, valid)
        with profile_scope("extract"):
            track_m, _ = extract_matches(la, kf_v, valid, match_threshold)

        with profile_scope("pack"):
            neg = torch.full_like(kpts[..., 0], -1.0)
            packed = torch.stack(
                [
                    torch.where(valid, kpts[..., 0] * PACK_SCALE, neg),
                    kpts[..., 1] * PACK_SCALE,
                    track_m.float(),
                ],
                dim=1,
            )  # (S, 3, K)
            # torch.round rounds half to even, as jnp.round does.
            packed = torch.round(packed).to(torch.int16)
            return packed.reshape(S * RGBD_PACK_ROWS, -1), desc, kpts, valid


def fused_rgbd_step(
    sp_params,
    lg_params,
    image_u8: torch.Tensor,  # (1, H, W) uint8, padded
    kf_kpts: torch.Tensor,
    kf_desc: torch.Tensor,
    kf_valid: torch.Tensor,
    **kw,
):
    """One frame: returns (packed (RGBD_PACK_ROWS, K), desc (K, D),
    kpts (K, 2), valid (K,))."""
    packed, desc, kpts, valid = fused_rgbd_step_multi(
        sp_params, lg_params, image_u8, kf_kpts, kf_desc, kf_valid, **kw
    )
    return packed, desc[0], kpts[0], valid[0]


def undistort_points(
    uv: torch.Tensor, calib: tuple, dist: tuple, iterations: int = 8
) -> torch.Tensor:
    """Radtan undistortion on the device: the torch mirror of
    ``io/undistort.py::undistort_points`` (cv::undistortPoints semantics,
    src/RgbdFrontEnd.cc:36-40), elementwise, a fixed number of fixed-point
    iterations. uv (..., 2) pixels -> (..., 2) pixels."""
    fx, fy, cx, cy, _b = calib
    k1, k2, p1, p2, k3 = dist
    xd = (uv[..., 0] - cx) / fx
    yd = (uv[..., 1] - cy) / fy
    x, y = xd, yd
    for _ in range(iterations):
        r2 = x * x + y * y
        radial = 1.0 + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2
        dx = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
        dy = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
        x = x + (xd - dx)
        y = y + (yd - dy)
    return torch.stack([x * fx + cx, y * fy + cy], dim=-1)


@torch.no_grad()
@highest_f32_matmuls()
def fused_rgbd_track_step_multi(
    sp_params,
    lg_params,
    images_u8: torch.Tensor,  # (S, H, W) uint8, padded
    kf_kpts: torch.Tensor,
    kf_desc: torch.Tensor,
    kf_valid: torch.Tensor,
    kf_xw: torch.Tensor,  # (K, 3) world points of the KF features
    kf_depth_ok: torch.Tensor,  # (K,) bool
    carry_R: torch.Tensor,
    carry_t: torch.Tensor,
    rel_R: torch.Tensor,
    rel_t: torch.Tensor,
    max_keypoints: int,
    keypoint_threshold: float,
    remove_borders: int,
    nms_radius: int,
    true_width: int,
    true_height: int,
    match_threshold: float,
    calib: tuple,
    min_matches: int,
    track_sigma_px: float,
    track_iters: int = 20,
    dist: tuple | None = None,
):
    """fused_rgbd_step_multi + the device pose chain with mono factors.

    The sensor depth never goes to the device, so each frame's solve uses
    (uL, v) reprojection residuals only: ``track_scan`` with mono=True,
    disparity 0 and stereo_ok = valid; the keyframe's world points
    (backprojected from sensor depth when it was inserted, uploaded once a
    keyframe) carry the metric scale. With ``dist`` (radtan k1, k2, p1, p2,
    k3) the frame keypoints are undistorted on the device before the solve,
    into the host estimator's coordinates.

    Returns (packed, desc, kpts, valid, track_out (S, TRACK_COLS) f32,
    (carry_R, carry_t, rel_R, rel_t))."""
    with profile_scope("step"):
        packed, desc, kpts, valid = fused_rgbd_step_multi(
            sp_params, lg_params, images_u8, kf_kpts, kf_desc, kf_valid,
            max_keypoints=max_keypoints, keypoint_threshold=keypoint_threshold,
            remove_borders=remove_borders, nms_radius=nms_radius, true_width=true_width,
            true_height=true_height, match_threshold=match_threshold,
        )
        S = images_u8.shape[0]
        track_m = packed.reshape(S, RGBD_PACK_ROWS, -1)[:, 2]
        kl = kpts if dist is None else undistort_points(kpts, calib, dist)
        track_out, carry = track_scan(
            kl, torch.zeros_like(kl[..., 0]), valid, track_m, kf_xw, kf_depth_ok,
            (carry_R, carry_t, rel_R, rel_t),
            calib=calib, min_matches=min_matches, track_sigma_px=track_sigma_px,
            disp_sigma0=1.0, disp_cond=1.0,  # unused in mono mode
            track_iters=track_iters, mono=True,
        )
        return packed, desc, kpts, valid, track_out, carry

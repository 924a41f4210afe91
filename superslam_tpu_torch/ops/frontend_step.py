"""The fused per-frame step: uint8 stereo pair in, one packed int16 block out.

Port of the synchronous, host-solved part of
``superslam_tpu/ops/frontend_step.py``:

    uint8 stereo pair -> normalize -> SuperPoint (B=2) -> select top-K
    -> LightGlue over 2S pair problems: L<->R (stereo) and KF<->L (track)
    -> stereo disparity / row gates
    -> pack what the host estimator needs into ONE int16 (4*S, K) block

The host copies the packed block once per frame; the frame's left
features stay on the device and become the next keyframe's inputs when
the keyframe gate fires.

Packed row layout (int16, shape (PACK_ROWS, K)):
  0: kpt x (left) in 1/PACK_SCALE px fixed point, <0 for invalid rows
     (valid rows form a prefix)
  1: kpt y (left), same fixed point
  2: stereo disparity (uL - uR), same fixed point, <0 when the stereo
     gates failed
  3: track match index into the KF set (-1 = none; plain integer)
"""

from __future__ import annotations

import torch

from ..models.lightglue import extract_matches, lightglue_forward
from ..models.superpoint import select_keypoints, superpoint_dense
from ..utils.env import env_flag
from .precision import highest_f32_matmuls

PACK_ROWS = 4
PACK_SCALE = 16.0  # 1/16 px fixed point in the int16 readback


def _superpoint_stereo_features(
    sp_params,
    images_u8: torch.Tensor,  # (2S, H, W) uint8 [L0, R0, L1, R1, ...], padded
    max_keypoints: int,
    keypoint_threshold: float,
    remove_borders: int,
    nms_radius: int,
    true_width: int,
    true_height: int,
):
    """SuperPoint over the interleaved L/R batch + top-K selection + L/R
    split + LightGlue-frame normalization. Returns (kl, kr, dl, dr, vl, vr,
    nkl, nkr)."""
    images = images_u8.float() / 255.0
    # Sub-pixel peaks (env-gated, default on): disparity noise converts to
    # depth noise as Z^2/(fx*b) per px.
    subpixel = env_flag("SUPERSLAM_SP_SUBPIXEL", True)
    out = superpoint_dense(sp_params, images, nms_radius=nms_radius, return_pre_nms=subpixel)
    kpts, _scores, valid, desc = select_keypoints(
        out[0], out[1], max_keypoints, keypoint_threshold, remove_borders,
        true_width, true_height, raw_scores=out[2] if subpixel else None,
    )
    kl, kr = kpts[0::2], kpts[1::2]  # (S, K, 2)
    dl, dr = desc[0::2], desc[1::2]
    vl, vr = valid[0::2], valid[1::2]
    center, scale = _norm_frame(true_width, true_height, kpts.device)
    return kl, kr, dl, dr, vl, vr, (kl - center) / scale, (kr - center) / scale


def _norm_frame(true_width: int, true_height: int, device):
    scale = max(true_width, true_height) / 2.0
    center = torch.tensor(
        [true_width / 2.0, true_height / 2.0], dtype=torch.float32, device=device
    )
    return center, scale


def _stereo_gates(kl, kr, vl, stereo_m, min_disparity: float):
    """Disparity floor and rectified-row check. Returns (disparity (S,K),
    stereo_ok (S,K))."""
    j = torch.clamp(stereo_m, min=0).to(torch.int64)
    uR = torch.gather(kr[..., 0], 1, j)
    vR = torch.gather(kr[..., 1], 1, j)
    disparity = kl[..., 0] - uR
    row_ok = torch.abs(kl[..., 1] - vR) <= 2.0
    stereo_ok = (stereo_m >= 0) & (disparity >= min_disparity) & row_ok & vl
    return disparity, stereo_ok


def _frontend_core(
    sp_params,
    lg_params,
    images_u8: torch.Tensor,  # (2S, H, W) uint8, padded
    kf_kpts: torch.Tensor,  # (K, 2) f32 pixel coords of the last keyframe
    kf_desc: torch.Tensor,  # (K, D)
    kf_valid: torch.Tensor,  # (K,) bool
    max_keypoints: int,
    keypoint_threshold: float,
    remove_borders: int,
    nms_radius: int,
    true_width: int,
    true_height: int,
    min_disparity: float,
    match_threshold: float,
):
    """Extraction + stereo/track matching + stereo gates.

    Returns (kl (S,K,2), nkl (S,K,2), dl (S,K,D), vl (S,K), disparity (S,K),
    stereo_ok (S,K), track_m (S,K))."""
    S = images_u8.shape[0] // 2
    kl, kr, dl, dr, vl, vr, nkl, nkr = _superpoint_stereo_features(
        sp_params, images_u8, max_keypoints, keypoint_threshold, remove_borders,
        nms_radius, true_width, true_height,
    )
    center, scale = _norm_frame(true_width, true_height, kl.device)
    nkf = (kf_kpts - center) / scale

    # 2S pair problems in one LightGlue forward: S stereo matches (L_s, R_s)
    # and S track matches (KF, L_s). kf_* may be shared (K, ...) or
    # per-sequence (S, K, ...).
    if kf_kpts.dim() == 2:
        kf_k = nkf[None].expand(S, -1, -1)
        kf_d = kf_desc[None].to(dl.dtype).expand(S, -1, -1)
        kf_v = kf_valid[None].expand(S, -1)
    else:
        kf_k, kf_d, kf_v = nkf, kf_desc.to(dl.dtype), kf_valid
    q_kpts = torch.cat([nkl, kf_k], dim=0)
    q_desc = torch.cat([dl, kf_d], dim=0)
    q_valid = torch.cat([vl, kf_v], dim=0)
    t_kpts = torch.cat([nkr, nkl], dim=0)
    t_desc = torch.cat([dr, dl], dim=0)
    t_valid = torch.cat([vr, vl], dim=0)
    la = lightglue_forward(lg_params, q_kpts, q_desc, t_kpts, t_desc, q_valid, t_valid)
    matches, _mscores = extract_matches(la, q_valid, t_valid, match_threshold)
    stereo_m = matches[:S]  # (S, K)
    track_m = matches[S:]  # match confidence is not consumed downstream

    disparity, stereo_ok = _stereo_gates(kl, kr, vl, stereo_m, min_disparity)
    return kl, nkl, dl, vl, disparity, stereo_ok, track_m


def _pack(kl, vl, disparity, stereo_ok, track_m):
    S, K = kl.shape[0], kl.shape[1]
    neg = torch.full_like(disparity, -1.0)
    packed = torch.stack(
        [
            torch.where(vl, kl[..., 0] * PACK_SCALE, neg),
            kl[..., 1] * PACK_SCALE,
            torch.where(stereo_ok, disparity * PACK_SCALE, neg),
            track_m.float(),
        ],
        dim=1,
    )
    # torch.round rounds half to even, as jnp.round does.
    packed = torch.round(packed).to(torch.int16)
    return packed.reshape(S * PACK_ROWS, K)


@torch.inference_mode()
@highest_f32_matmuls()
def fused_stereo_step_multi(
    sp_params,
    lg_params,
    images_u8: torch.Tensor,  # (2S, H, W) uint8 [L0, R0, L1, R1, ...], padded
    kf_kpts: torch.Tensor,  # (K, 2) f32 pixel coords of the last keyframe
    kf_desc: torch.Tensor,  # (K, D)
    kf_valid: torch.Tensor,  # (K,) bool
    max_keypoints: int,
    keypoint_threshold: float,
    remove_borders: int,
    nms_radius: int,
    true_width: int,
    true_height: int,
    min_disparity: float,
    match_threshold: float,
):
    """Process S consecutive stereo frames in one step.

    Returns (packed (S*PACK_ROWS, K) int16, desc (S, K, D), kpts (S, K, 2),
    valid (S, K)), all on the images' device: the packed block is the
    single host readback for all S frames (frame s owns rows
    [s*PACK_ROWS, (s+1)*PACK_ROWS)); every frame's track match refers to the
    same keyframe state."""
    kl, _nkl, dl, vl, disparity, stereo_ok, track_m = _frontend_core(
        sp_params, lg_params, images_u8, kf_kpts, kf_desc, kf_valid, max_keypoints,
        keypoint_threshold, remove_borders, nms_radius, true_width, true_height,
        min_disparity, match_threshold,
    )
    return _pack(kl, vl, disparity, stereo_ok, track_m), dl, kl, vl


def fused_stereo_step(
    sp_params,
    lg_params,
    images_u8: torch.Tensor,  # (2, H, W) uint8 [L, R], padded
    kf_kpts: torch.Tensor,
    kf_desc: torch.Tensor,
    kf_valid: torch.Tensor,
    **kw,
):
    """Single-frame wrapper over fused_stereo_step_multi.

    Returns (packed (PACK_ROWS, K), desc (K, D), kpts (K, 2), valid (K,))."""
    packed, dl, kl, vl = fused_stereo_step_multi(
        sp_params, lg_params, images_u8, kf_kpts, kf_desc, kf_valid, **kw
    )
    return packed, dl[0], kl[0], vl[0]

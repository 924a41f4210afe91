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

``track_scan`` (with ``_frame_solve`` and ``_reorthonormalize``) is the
port of the JAX package's on-device tracking chain: the prior-gated
pose-only LM per frame with coast-on-loss, held against the JAX function
and the host tracker in ``tests/test_torch_pose_solver.py``; each frame's
solve is one launch of ``ops/cuda/pose_solve.cu`` on the card.
``track_kf_scan`` is its zero-lag form with the keyframe in the carry, and
``fused_stereo_track_step_multi`` / ``fused_stereo_track_kf_step_multi`` are
the device-tracked steps built on the two (extraction + matching + pose in
one call), held against the JAX functions in
``tests/test_torch_frontend_step.py`` and dispatched by
``frontend/pipelined.py``. On the card nothing in them reads a value back
to the host: the only host read of a frame is the pipeline's packed
readback.
"""

from __future__ import annotations

import functools

import torch

from ..models.lightglue import extract_matches, lightglue_forward
from ..models.superpoint import select_keypoints, superpoint_dense
from ..utils.env import env_flag, env_float, env_int
from .cuda.pose_solve import pose_solve, reprojection
from .precision import highest_f32_matmuls

PACK_ROWS = 4
PACK_SCALE = 16.0  # 1/16 px fixed point in the int16 readback
TRACK_COLS = 13  # R row-major (9) + t (3) + n_matches (1)
TRACK_KF_COLS = 16  # R row-major (9) + t (3) + n + support + accept + promo


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
    return _norm_center(true_width, true_height, torch.device(device)), (
        max(true_width, true_height) / 2.0
    )


@functools.lru_cache(maxsize=None)
def _norm_center(true_width: int, true_height: int, device: torch.device) -> torch.Tensor:
    """The LightGlue frame's center, made once per size and device: a tensor
    built from a Python list is a copy from pageable memory, which on the
    card waits for every queued kernel."""
    return torch.tensor([true_width / 2.0, true_height / 2.0], dtype=torch.float32, device=device)


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
    kf_prenormalized: bool = False,
):
    """Extraction + stereo/track matching + stereo gates.

    Returns (kl (S,K,2), nkl (S,K,2), dl (S,K,D), vl (S,K), disparity (S,K),
    stereo_ok (S,K), track_m (S,K)).

    kf_prenormalized=True means kf_kpts is already in the LightGlue
    normalized frame (the device keyframe carry stores normalized
    coordinates)."""
    S = images_u8.shape[0] // 2
    kl, kr, dl, dr, vl, vr, nkl, nkr = _superpoint_stereo_features(
        sp_params, images_u8, max_keypoints, keypoint_threshold, remove_borders,
        nms_radius, true_width, true_height,
    )
    center, scale = _norm_frame(true_width, true_height, kl.device)
    nkf = kf_kpts if kf_prenormalized else (kf_kpts - center) / scale

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


# -- the tracking chain ---------------------------------------------------------


def _reorthonormalize(R):
    """Project a near-rotation back onto SO(3) (Gram-Schmidt). The tracking
    carry multiplies thousands of f32 exponentials across a run; without
    this the prior drifts off the manifold linearly in frame count."""
    c0 = R[:, 0]
    c0 = c0 / torch.sqrt(c0 @ c0 + 1e-20)
    c1 = R[:, 1] - (c0 @ R[:, 1]) * c0
    c1 = c1 / torch.sqrt(c1 @ c1 + 1e-20)
    c2 = torch.linalg.cross(c0, c1)
    return torch.stack([c0, c1, c2], dim=1)


def _frame_solve(
    R_prev,
    t_prev,
    R_pred,
    t_pred,
    kl_s,  # (K, 2) this frame's left keypoints (pixels)
    disp_s,  # (K,)
    ok_s,  # (K,) bool stereo-gate pass
    tm_s,  # (K,) integer: frame keypoint matched to KF feature i, or -1
    kf_xw,  # (K, 3) world points of the KF features
    kf_depth_ok,  # (K,) bool
    **solve_kw,
):
    """One frame's prior-gated pose solve (the solve semantics are
    documented on track_scan), through ``ops/cuda/pose_solve.py``: one
    kernel launch on the card, the plain version on the CPU. Returns
    (R_s, t_s, n, ok, resid): the solved pose, the usable-match count, the
    usable-match mask, and the reprojection-residual closure
    ``resid(R, t) -> (px_dist (K,), z_ok (K,))`` for support counting."""
    R_s, t_s, n, ok, _kept, uv = pose_solve(
        R_prev, t_prev, R_pred, t_pred, kl_s, disp_s, ok_s, tm_s, kf_xw, kf_depth_ok,
        **solve_kw,
    )

    def resid(R, t):
        return reprojection(R, t, kf_xw, uv, solve_kw["calib"])

    return R_s, t_s, n, ok, resid


@torch.no_grad()
@highest_f32_matmuls()
def track_scan(
    kl,  # (S, K, 2) left keypoints (pixels)
    disparity,  # (S, K)
    stereo_ok,  # (S, K) bool
    track_m,  # (S, K) integer: frame keypoint matched to KF feature i, or -1
    kf_xw,  # (K, 3) world points of the KF features
    kf_depth_ok,  # (K,) bool
    carry,  # (R (3,3), t (3,), rel_R (3,3), rel_t (3,))
    *,
    calib: tuple,
    min_matches: int,
    track_sigma_px: float,
    disp_sigma0: float,
    disp_cond: float,
    track_iters: int = 20,
    mono: bool = False,
    gate_px: float | None = None,
    chi2_px: float | None = None,
    chi2_rounds: int | None = None,
):
    """The tracking chain over S frames: the pose-only LM per frame with
    coast-on-loss, the host estimator's solve semantics
    (core.vo_estimator._track / core.frame_tracker); the JAX package's
    ``lax.scan`` is a Python loop. Returns (track_out (S, TRACK_COLS) f32,
    new carry).

    The solve is prior-gated, mirroring FrameTracker.track_gated steps 1-4:
    matches are rejected against the constant-velocity predicted pose
    (reprojection distance > gate_px) before the LM, which still starts at
    the PREVIOUS pose, then ``chi2_rounds`` re-solves run on shrinking chi2
    inlier sets. gate_px / chi2_px / chi2_rounds default from
    SUPERSLAM_TRACK_GATE{,_PX} / SUPERSLAM_TRACK_CHI2_{PX,ROUNDS};
    gate_px=0 disables the pre-gate, chi2_rounds=0 the re-rounds.
    min_matches doubles as the minimum kept-set size. Frames with fewer
    than min_matches usable correspondences coast on the constant-velocity
    carry.

    mono=True zeroes the uR residual weight (an RGB-D step has no
    frame-side depth): pass disparity=0 and stereo_ok=valid in that mode."""
    gate_px, chi2_px, chi2_rounds = _track_gate_defaults(gate_px, chi2_px, chi2_rounds)

    R_prev, t_prev, Rr, tr = carry
    rows = []
    for s in range(kl.shape[0]):
        # Constant-velocity prediction: the GATING pose, and the coast.
        R_pred = R_prev @ Rr
        t_pred = R_prev @ tr + t_prev
        R_s, t_s, n, _ok, _resid = _frame_solve(
            R_prev, t_prev, R_pred, t_pred, kl[s], disparity[s], stereo_ok[s], track_m[s],
            kf_xw, kf_depth_ok,
            calib=calib, min_matches=min_matches, inv_sig_uLv=1.0 / track_sigma_px,
            disp_sigma0=disp_sigma0, disp_cond=disp_cond, mono=mono, gate_px=gate_px,
            chi2_px=chi2_px, chi2_rounds=chi2_rounds, track_iters=track_iters,
        )
        use = n >= min_matches
        R_new = _reorthonormalize(torch.where(use, R_s, R_pred))
        t_new = torch.where(use, t_s, t_pred)
        Rr = torch.where(use, R_prev.T @ R_new, Rr)
        tr = torch.where(use, R_prev.T @ (t_new - t_prev), tr)
        rows.append(torch.cat([R_new.reshape(9), t_new, n.to(torch.float32)[None]]))
        R_prev, t_prev = R_new, t_new
    return torch.stack(rows), (R_prev, t_prev, Rr, tr)


def _track_gate_defaults(gate_px, chi2_px, chi2_rounds):
    """The prior gate's settings from SUPERSLAM_TRACK_GATE{,_PX} and
    SUPERSLAM_TRACK_CHI2_{PX,ROUNDS} where the caller gave none."""
    gate_on = env_flag("SUPERSLAM_TRACK_GATE", True)
    if gate_px is None:
        gate_px = env_float("SUPERSLAM_TRACK_GATE_PX", 10.0) if gate_on else 0.0
    if chi2_px is None:
        chi2_px = env_float("SUPERSLAM_TRACK_CHI2_PX", 2.0)
    if chi2_rounds is None:
        chi2_rounds = env_int("SUPERSLAM_TRACK_CHI2_ROUNDS", 2) if gate_on else 0
    return gate_px, chi2_px, chi2_rounds


@torch.no_grad()
@highest_f32_matmuls()
def fused_stereo_track_step_multi(
    sp_params,
    lg_params,
    images_u8: torch.Tensor,  # (2S, H, W) uint8 [L0, R0, ...], padded
    kf_kpts: torch.Tensor,  # (K, 2) f32 pixel coords of the last keyframe
    kf_desc: torch.Tensor,  # (K, D)
    kf_valid: torch.Tensor,  # (K,) bool
    kf_xw: torch.Tensor,  # (K, 3) f32 WORLD points of the KF's stereo features
    kf_depth_ok: torch.Tensor,  # (K,) bool: the KF feature has stereo depth
    carry_R: torch.Tensor,  # (3,3) previous frame pose Twc (device-resident)
    carry_t: torch.Tensor,  # (3,)
    rel_R: torch.Tensor,  # (3,3) constant-velocity model (prev.between(cur))
    rel_t: torch.Tensor,  # (3,)
    max_keypoints: int,
    keypoint_threshold: float,
    remove_borders: int,
    nms_radius: int,
    true_width: int,
    true_height: int,
    min_disparity: float,
    match_threshold: float,
    calib: tuple,  # (fx, fy, cx, cy, baseline)
    min_matches: int,
    track_sigma_px: float,
    disp_sigma0: float,
    disp_cond: float,
    track_iters: int = 20,
):
    """The per-frame step with the pose in it: everything
    fused_stereo_step_multi does, plus ``track_scan`` over the S frames on
    the KF->frame track matches, so tracking never leaves the device.
    Correspondences: track_m[i] = frame keypoint matched to KF feature i;
    Xw = kf_xw[i]; meas = the frame keypoint's (uL, uR, v) from the stereo
    gate. Frames with fewer than ``min_matches`` usable correspondences
    coast on the constant-velocity carry.

    Returns (packed, dl, kl, vl, track_out (S, TRACK_COLS) f32,
    (carry_R, carry_t, rel_R, rel_t)): the carry stays on the device and
    feeds the next call; only ``packed`` and ``track_out`` are read back."""
    if kf_kpts.dim() != 2:
        raise ValueError(
            "device tracking is single-sequence: the pose chain carry and the (K, 3) "
            "keyframe world points have no per-sequence axis"
        )
    kl, _nkl, dl, vl, disparity, stereo_ok, track_m = _frontend_core(
        sp_params, lg_params, images_u8, kf_kpts, kf_desc, kf_valid, max_keypoints,
        keypoint_threshold, remove_borders, nms_radius, true_width, true_height,
        min_disparity, match_threshold,
    )
    track_out, carry = track_scan(
        kl, disparity, stereo_ok, track_m, kf_xw, kf_depth_ok,
        (carry_R, carry_t, rel_R, rel_t),
        calib=calib, min_matches=min_matches, track_sigma_px=track_sigma_px,
        disp_sigma0=disp_sigma0, disp_cond=disp_cond, track_iters=track_iters,
    )
    return _pack(kl, vl, disparity, stereo_ok, track_m), dl, kl, vl, track_out, carry


def _extract_stereo(
    sp_params,
    lg_params,
    images_u8: torch.Tensor,  # (2S, H, W) uint8 [L0, R0, ...], padded
    max_keypoints: int,
    keypoint_threshold: float,
    remove_borders: int,
    nms_radius: int,
    true_width: int,
    true_height: int,
    min_disparity: float,
    match_threshold: float,
):
    """Extraction + stereo matching WITHOUT the keyframe track match: the
    front half of _frontend_core for steps that match against a keyframe
    carried inside their own loop (track_kf_scan). Returns
    (kl (S,K,2) px, nkl (S,K,2) normalized, dl (S,K,D), vl (S,K),
    disparity (S,K), stereo_ok (S,K))."""
    kl, kr, dl, dr, vl, vr, nkl, nkr = _superpoint_stereo_features(
        sp_params, images_u8, max_keypoints, keypoint_threshold, remove_borders,
        nms_radius, true_width, true_height,
    )
    la = lightglue_forward(lg_params, nkl, dl, nkr, dr, vl, vr)
    stereo_m, _ = extract_matches(la, vl, vr, match_threshold)
    disparity, stereo_ok = _stereo_gates(kl, kr, vl, stereo_m, min_disparity)
    return kl, nkl, dl, vl, disparity, stereo_ok


@torch.no_grad()
@highest_f32_matmuls()
def track_kf_scan(
    lg_params,
    kl,  # (S, K, 2) left keypoints (pixels)
    nkl,  # (S, K, 2) normalized left keypoints (LightGlue frame)
    dl,  # (S, K, D) left descriptors
    vl,  # (S, K) bool
    disparity,  # (S, K)
    stereo_ok,  # (S, K) bool
    kf_state,  # (kf_nk (K,2), kf_desc (K,D), kf_valid (K,), kf_xw (K,3),
    #             kf_depth_ok (K,), since (int32 scalar))
    pose_carry,  # (R (3,3), t (3,), rel_R (3,3), rel_t (3,))
    *,
    calib: tuple,
    min_matches: int,
    track_sigma_px: float,
    disp_sigma0: float,
    disp_cond: float,
    match_threshold: float,
    accept_frac: float,
    support_px: float,
    kf_min_frames: int,
    kf_max_frames: int,
    kf_min_matches: int,
    covis_ratio: float,
    track_iters: int = 20,
    gate_px: float | None = None,
    chi2_px: float | None = None,
    chi2_rounds: int | None = None,
    track_m0=None,  # (S, K) integer batched matches vs the ENTRY keyframe
):
    """Zero-lag on-device tracking: the keyframe lives in the loop's carry.

    track_scan matches every frame of a call against the keyframe state
    frozen when the call was made. Here each frame matches the CARRIED
    keyframe, solves, and, when the keyframe gate fires, promotes itself to
    be the keyframe for the very next frame. The host follows the readback's
    promo bit, so its map bookkeeping stays in lockstep and the keyframe
    never leaves the device.

    Gate semantics mirror core.keyframe_gate.should_insert_keyframe with
    reference_features = the carried keyframe's depth-valid count; solve
    acceptance mirrors VoEstimator's support-based rule (support and accept
    ride the readback row so the host adopts the same decision). Promotion
    grounds the new keyframe's world points through the ACCEPTED device
    solve. Stereo-only.

    Speculative hybrid (track_m0 is not None): the caller already matched
    every frame against the ENTRY keyframe in one batched LightGlue forward.
    Those matches are exact until the first promotion inside this call; only
    frames after one need the pair-batch-1 forward. The JAX package
    selects with ``lax.cond`` on a carried flag. Here nothing is read from
    the device: on the card every frame after the first in a call runs the
    re-match (9 + 9 block launches) and ``torch.where`` selects with the
    carried bit; the CPU plain path reads the bit and skips the re-match it
    would discard. The promotion likewise selects the new keyframe state
    with the device's promo bit.

    Returns (track_out (S, TRACK_KF_COLS) f32, track_m (S, K) int32,
    new_kf_state, new_pose_carry)."""
    gate_px, chi2_px, chi2_rounds = _track_gate_defaults(gate_px, chi2_px, chi2_rounds)
    R_prev, t_prev, Rr, tr = pose_carry
    kf_nk, kf_d, kf_v, kf_xw, kf_dok, since = kf_state
    hybrid = track_m0 is not None
    on_card = kl.device.type != "cpu"
    # Whether the carried keyframe is still the one track_m0 was matched
    # against: a device bit, never read on the card.
    fresh = torch.ones((), dtype=torch.bool, device=kl.device)
    rows, matches = [], []
    for s in range(kl.shape[0]):
        if hybrid and (s == 0 or (not on_card and bool(fresh))):
            # Frame 0 always matches the entry keyframe; the CPU twin reads
            # the bit and skips the re-match it would discard.
            tm_s = track_m0[s].to(torch.int32)
        else:
            la = lightglue_forward(
                lg_params, kf_nk[None], kf_d[None], nkl[s][None], dl[s][None], kf_v[None],
                vl[s][None],
            )
            tm_s = extract_matches(la, kf_v[None], vl[s][None], match_threshold)[0][0]
            if hybrid:
                tm_s = torch.where(fresh, track_m0[s].to(torch.int32), tm_s)

        R_pred = R_prev @ Rr
        t_pred = R_prev @ tr + t_prev
        R_s, t_s, n, ok, resid = _frame_solve(
            R_prev, t_prev, R_pred, t_pred, kl[s], disparity[s], stereo_ok[s], tm_s, kf_xw,
            kf_dok,
            calib=calib, min_matches=min_matches, inv_sig_uLv=1.0 / track_sigma_px,
            disp_sigma0=disp_sigma0, disp_cond=disp_cond, mono=False, gate_px=gate_px,
            chi2_px=chi2_px, chi2_rounds=chi2_rounds, track_iters=track_iters,
        )

        # Support-based acceptance: VoEstimator._attempt's rule.
        r, zok = resid(R_s, t_s)
        support = torch.sum(ok & zok & (r < support_px))
        finite = torch.isfinite(t_s).all() & torch.isfinite(R_s).all()
        accept = (n >= min_matches) & finite
        if accept_frac > 0:
            floor = torch.clamp(accept_frac * n.float(), min=float(min_matches))
            accept = accept & (support.float() >= floor)

        R_new = _reorthonormalize(torch.where(accept, R_s, R_pred))
        t_new = torch.where(accept, t_s, t_pred)
        Rr = torch.where(accept, R_prev.T @ R_new, Rr)
        tr = torch.where(accept, R_prev.T @ (t_new - t_prev), tr)

        # Keyframe gate (should_insert_keyframe, exact semantics).
        since1 = since + 1
        nref = torch.clamp(torch.sum(kf_dok), min=1)
        ratio_low = n.float() < covis_ratio * nref.float()
        gate = (since1 >= kf_min_frames) & (
            (since1 >= kf_max_frames) | (n < kf_min_matches) | ratio_low
        )
        promo = accept & gate
        rows.append(
            torch.cat(
                [R_new.reshape(9), t_new,
                 torch.stack([n.float(), support.float(), accept.float(), promo.float()])]
            )
        )
        matches.append(tm_s)

        kf_nk, kf_d, kf_v, kf_xw, kf_dok = promote(
            promo, (kl[s], nkl[s], dl[s], vl[s], disparity[s], stereo_ok[s]), R_new, t_new,
            (kf_nk, kf_d, kf_v, kf_xw, kf_dok), calib,
        )
        since = torch.where(promo, torch.zeros_like(since1), since1)
        fresh = fresh & ~promo
        R_prev, t_prev = R_new, t_new

    new_kf_state = (kf_nk, kf_d, kf_v, kf_xw, kf_dok, since)
    return torch.stack(rows), torch.stack(matches), new_kf_state, (R_prev, t_prev, Rr, tr)


def promote(promo, frame, R_new, t_new, kf, calib):
    """The promotion of track_kf_scan: where the device bit ``promo`` is
    set, the frame's features (kl, nkl, dl, vl, disparity, stereo_ok) become
    the keyframe (nk, desc, valid, xw, depth_ok), their world points
    grounded through the accepted solve (Xw = R Xc + t); elsewhere the
    keyframe stays. Selected on the device, as the JAX scan does: nothing
    is read back."""
    fx, fy, cx, cy, baseline = calib
    kl_s, nkl_s, dl_s, vl_s, disp_s, sok_s = frame
    kf_nk, kf_d, kf_v, kf_xw, kf_dok = kf
    z = (fx * baseline) / torch.clamp(disp_s, min=1e-3)
    x = (kl_s[:, 0] - cx) * z / fx
    y = (kl_s[:, 1] - cy) * z / fy
    xw_new = torch.stack([x, y, z], dim=1) @ R_new.T + t_new
    return (
        torch.where(promo, nkl_s, kf_nk),
        torch.where(promo, dl_s, kf_d),
        torch.where(promo, vl_s, kf_v),
        torch.where(promo, xw_new, kf_xw),
        torch.where(promo, sok_s, kf_dok),
    )


@torch.no_grad()
@highest_f32_matmuls()
def fused_stereo_track_kf_step_multi(
    sp_params,
    lg_params,
    images_u8: torch.Tensor,  # (2S, H, W) uint8 [L0, R0, ...], padded
    kf_state: tuple,  # see track_kf_scan
    pose_carry: tuple,  # (R, t, rel_R, rel_t)
    max_keypoints: int,
    keypoint_threshold: float,
    remove_borders: int,
    nms_radius: int,
    true_width: int,
    true_height: int,
    min_disparity: float,
    match_threshold: float,
    calib: tuple,
    min_matches: int,
    track_sigma_px: float,
    disp_sigma0: float,
    disp_cond: float,
    accept_frac: float,
    support_px: float,
    kf_min_frames: int,
    kf_max_frames: int,
    kf_min_matches: int,
    covis_ratio: float,
    track_iters: int = 20,
    hybrid: bool | None = None,
):
    """fused_stereo_track_step_multi with zero-lag keyframe promotion: the
    keyframe state rides the carry (track_kf_scan docstring).

    hybrid=True (the default, SUPERSLAM_DEVICE_KF_HYBRID): the KF<->frame
    match runs batched with the stereo match in one 2S-pair LightGlue
    forward against the entry keyframe, and the pair-batch-1 forward runs
    only for frames that follow a promotion inside this call (never at
    S = 1). hybrid=False: every frame re-matches inside the loop.

    Returns (packed, dl, kl, vl, track_out (S, TRACK_KF_COLS),
    new_kf_state, new_pose_carry)."""
    if hybrid is None:
        hybrid = env_flag("SUPERSLAM_DEVICE_KF_HYBRID", True)
    front = (
        sp_params, lg_params, images_u8, max_keypoints, keypoint_threshold, remove_borders,
        nms_radius, true_width, true_height, min_disparity, match_threshold,
    )
    if hybrid:
        kl, nkl, dl, vl, disparity, stereo_ok, track_m0 = _frontend_core(
            *front[:3], kf_state[0], kf_state[1], kf_state[2], *front[3:],
            kf_prenormalized=True,
        )
    else:
        kl, nkl, dl, vl, disparity, stereo_ok = _extract_stereo(*front)
        track_m0 = None
    track_out, track_m, kf_state2, pose_carry2 = track_kf_scan(
        lg_params, kl, nkl, dl, vl, disparity, stereo_ok, kf_state, pose_carry,
        track_m0=track_m0, calib=calib, min_matches=min_matches,
        track_sigma_px=track_sigma_px, disp_sigma0=disp_sigma0, disp_cond=disp_cond,
        match_threshold=match_threshold, accept_frac=accept_frac, support_px=support_px,
        kf_min_frames=kf_min_frames, kf_max_frames=kf_max_frames,
        kf_min_matches=kf_min_matches, covis_ratio=covis_ratio, track_iters=track_iters,
    )
    packed = _pack(kl, vl, disparity, stereo_ok, track_m)
    return packed, dl, kl, vl, track_out, kf_state2, pose_carry2

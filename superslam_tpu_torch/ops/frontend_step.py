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

``track_scan`` is the port of the JAX package's on-device tracking chain:
the prior-gated pose-only LM per frame with coast-on-loss, held against
the JAX function and the host tracker in ``tests/test_torch_pose_solver.py``.
``track_kf_scan`` is its zero-lag form with the keyframe in the carry. The
body of each frame of both, the solve with everything around it, is one
launch of ``ops/cuda/track_frame.cu`` on the card (``track_frame``); and
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
from ..utils.profiler import profile_scope
from .cuda.track_frame import TRACK_COLS, TRACK_KF_COLS, track_frame
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
    split + LightGlue-frame normalization (spans ``detect``, ``select``).
    Returns (kl, kr, dl, dr, vl, vr, nkl, nkr)."""
    with profile_scope("detect"):
        images = images_u8.float() / 255.0
        # Sub-pixel peaks (env-gated, default on): disparity noise converts to
        # depth noise as Z^2/(fx*b) per px.
        subpixel = env_flag("SUPERSLAM_SP_SUBPIXEL", True)
        out = superpoint_dense(sp_params, images, nms_radius=nms_radius, return_pre_nms=subpixel)
    with profile_scope("select"):
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
    with profile_scope("match"):
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
    with profile_scope("extract"):
        matches, _mscores = extract_matches(la, q_valid, t_valid, match_threshold)
        stereo_m = matches[:S]  # (S, K)
        track_m = matches[S:]  # match confidence is not consumed downstream

    with profile_scope("pack"):
        disparity, stereo_ok = _stereo_gates(kl, kr, vl, stereo_m, min_disparity)
    return kl, nkl, dl, vl, disparity, stereo_ok, track_m


def _pack(kl, vl, disparity, stereo_ok, track_m):
    S, K = kl.shape[0], kl.shape[1]
    with profile_scope("pack"):
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
    with profile_scope("step"):
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
    solve_kw = dict(
        calib=calib, min_matches=min_matches, inv_sig_uLv=1.0 / track_sigma_px,
        disp_sigma0=disp_sigma0, disp_cond=disp_cond, mono=mono, gate_px=gate_px,
        chi2_px=chi2_px, chi2_rounds=chi2_rounds, track_iters=track_iters,
    )
    with profile_scope("track"):
        track_out = torch.empty((kl.shape[0], TRACK_COLS), dtype=torch.float32,
                                device=kl.device)
        kf_state = (None, None, None, kf_xw, kf_depth_ok, None)
        tm = track_m.to(torch.int32)
        for s in range(kl.shape[0]):
            _row, _tm, carry, _kf, _fresh, _raw = track_frame(
                carry, (kl[s], None, None, None, disparity[s], stereo_ok[s]), tm[s], kf_state,
                out=(track_out[s], None), **solve_kw,
            )
    return track_out, carry


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
    with profile_scope("step"):
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
    with profile_scope("match"):
        la = lightglue_forward(lg_params, nkl, dl, nkr, dr, vl, vr)
    with profile_scope("extract"):
        stereo_m, _ = extract_matches(la, vl, vr, match_threshold)
    with profile_scope("pack"):
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
    re-match (9 + 9 block launches) and the frame's kernel selects with the
    carried bit; the CPU plain path reads the bit and skips the re-match it
    would discard. The kernel likewise writes the new keyframe state from
    the frame or the old keyframe by its own promo bit.

    Each frame's body after the match is one ``track_frame`` call: one
    launch of ``ops/cuda/track_frame.cu`` on the card, its plain twin on
    the CPU.

    Returns (track_out (S, TRACK_KF_COLS) f32, track_m (S, K) int32,
    new_kf_state, new_pose_carry)."""
    gate_px, chi2_px, chi2_rounds = _track_gate_defaults(gate_px, chi2_px, chi2_rounds)
    solve_kw = dict(
        calib=calib, min_matches=min_matches, inv_sig_uLv=1.0 / track_sigma_px,
        disp_sigma0=disp_sigma0, disp_cond=disp_cond, mono=False, gate_px=gate_px,
        chi2_px=chi2_px, chi2_rounds=chi2_rounds, track_iters=track_iters,
        keyframes=dict(accept_frac=accept_frac, support_px=support_px,
                       kf_min_frames=kf_min_frames, kf_max_frames=kf_max_frames,
                       kf_min_matches=kf_min_matches, covis_ratio=covis_ratio),
    )
    hybrid = track_m0 is not None
    on_card = kl.device.type != "cpu"
    S, K = kl.shape[0], kl.shape[1]
    track_out = torch.empty((S, TRACK_KF_COLS), dtype=torch.float32, device=kl.device)
    matches = torch.empty((S, K), dtype=torch.int32, device=kl.device)
    # Whether the carried keyframe is still the one track_m0 was matched
    # against: a device bit, never read on the card; None is the entry
    # keyframe.
    fresh = None
    for s in range(S):
        rematch = None
        if hybrid and (s == 0 or (not on_card and bool(fresh))):
            # Frame 0 always matches the entry keyframe; the CPU twin reads
            # the bit and skips the re-match it would discard.
            tm_s = track_m0[s].to(torch.int32)
        else:
            kf_nk, kf_d, kf_v = kf_state[:3]
            with profile_scope("match"):
                la = lightglue_forward(
                    lg_params, kf_nk[None], kf_d[None], nkl[s][None], dl[s][None], kf_v[None],
                    vl[s][None],
                )
            with profile_scope("extract"):
                tm_s = extract_matches(la, kf_v[None], vl[s][None], match_threshold)[0][0]
            if hybrid:
                # The kernel selects with the carried bit.
                tm_s, rematch = track_m0[s].to(torch.int32), tm_s
        with profile_scope("track"):
            _row, _tm, pose_carry, kf_state, fresh, _raw = track_frame(
                pose_carry, (kl[s], nkl[s], dl[s], vl[s], disparity[s], stereo_ok[s]), tm_s,
                kf_state, rematch=rematch, fresh=fresh, out=(track_out[s], matches[s]),
                **solve_kw,
            )
    return track_out, matches, kf_state, pose_carry


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
    with profile_scope("step"):
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

"""Multi-sequence batched tracking: S independent camera streams in one
front-end call and one pose chain launch a frame index.

Port of ``superslam_tpu/parallel/batched_tracking.py`` (BASELINE config 5,
"multi-sequence batched tracking"). The JAX package vmaps its jitted
programs over the sequence axis and shards that axis over the mesh's
``data`` axis; here the sequence axis is a batch dimension written out.
On one card the data axis has size 1 (``parallel/mesh.py``): there is no
cross-sequence communication to place.

- ``batched_stereo_frontend``: SuperPoint over all 2S images, top-K, and
  S left-right LightGlue problems in one forward. On the card it launches
  the conv pairs, the NMS kernel's logits mode (batch 2S) and the fused
  LightGlue blocks (S pair problems).
- ``batched_track_scan``: ``ops/frontend_step.py::track_scan`` for Q
  sequences. Each frame index is one launch of ``track_frame_batched``, a
  grid of Q blocks (``ops/cuda/track_frame.cu``), so a (Q, S) call makes S
  launches where a loop over sequences would make Q x S.
"""

from __future__ import annotations

import torch

from ..models.lightglue import extract_matches, lightglue_forward
from ..models.superpoint import select_keypoints, superpoint_dense
from ..ops.cuda.track_frame import TRACK_COLS, track_frame_batched
from ..ops.frontend_step import _norm_frame, _track_gate_defaults
from ..ops.precision import highest_f32_matmuls


@torch.inference_mode()
@highest_f32_matmuls()
def batched_stereo_frontend(
    sp_params,
    lg_params,
    left: torch.Tensor,  # (S, H, W) f32 in [0, 1]
    right: torch.Tensor,  # (S, H, W) f32
    max_keypoints: int = 512,
    keypoint_threshold: float = 0.005,
    remove_borders: int = 4,
):
    """S stereo pairs -> keypoints, descriptors and L<->R matches, on the
    images' device."""
    s, h, w = left.shape
    images = torch.cat([left, right], dim=0)  # (2S, H, W)
    scores, desc_grid = superpoint_dense(sp_params, images)
    kpts, kp_scores, valid, desc = select_keypoints(
        scores, desc_grid, max_keypoints, keypoint_threshold, remove_borders
    )
    kl, kr = kpts[:s], kpts[s:]
    dl, dr = desc[:s], desc[s:]
    vl, vr = valid[:s], valid[s:]

    center, scale = _norm_frame(w, h, kl.device)
    la = lightglue_forward(
        lg_params, (kl - center) / scale, dl, (kr - center) / scale, dr, vl, vr
    )
    matches0, mscores0 = extract_matches(la, vl, vr)
    return {
        "kpts_left": kl,
        "kpts_right": kr,
        "scores_left": kp_scores[:s],
        "desc_left": dl,
        "valid_left": vl,
        "matches0": matches0,
        "mscores0": mscores0,
    }


@torch.no_grad()
@highest_f32_matmuls()
def batched_track_scan(
    kl: torch.Tensor,  # (Q, S, K, 2): Q sequences, S frames each
    disparity: torch.Tensor,  # (Q, S, K)
    stereo_ok: torch.Tensor,  # (Q, S, K) bool
    track_m: torch.Tensor,  # (Q, S, K) integer
    kf_xw: torch.Tensor,  # (Q, K, 3) per-sequence keyframe world points
    kf_depth_ok: torch.Tensor,  # (Q, K) bool
    carry,  # (R (Q, 3, 3), t (Q, 3), rel_R (Q, 3, 3), rel_t (Q, 3))
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
    """``track_scan`` over the sequence axis: each sequence's pose chain
    runs its own LM to its own convergence, with no cross-sequence state.
    Arguments as ``ops/frontend_step.py::track_scan`` with a leading Q.

    Returns (track_out (Q, S, TRACK_COLS), carry with a leading Q)."""
    gate_px, chi2_px, chi2_rounds = _track_gate_defaults(gate_px, chi2_px, chi2_rounds)
    Q, S = kl.shape[0], kl.shape[1]
    R, t, rel_R, rel_t = carry
    c = torch.cat([R.reshape(Q, 9), t, rel_R.reshape(Q, 9), rel_t], dim=1).to(torch.float32)
    track_out = torch.empty((Q, S, TRACK_COLS), dtype=torch.float32, device=kl.device)
    tm = track_m.to(torch.int32)
    for s in range(S):
        _rows, c, _stats = track_frame_batched(
            c, kl[:, s], disparity[:, s], stereo_ok[:, s], tm[:, s], kf_xw, kf_depth_ok,
            calib=calib, min_matches=min_matches, inv_sig_uLv=1.0 / track_sigma_px,
            disp_sigma0=disp_sigma0, disp_cond=disp_cond, mono=mono, gate_px=gate_px,
            chi2_px=chi2_px, chi2_rounds=chi2_rounds, track_iters=track_iters,
            row_out=track_out[:, s],
        )
    new = (c[:, :9].reshape(Q, 3, 3), c[:, 9:12], c[:, 12:21].reshape(Q, 3, 3), c[:, 21:24])
    return track_out, new

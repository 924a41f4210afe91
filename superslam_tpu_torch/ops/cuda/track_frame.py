"""The per-frame body of the device tracking scans in one launch.

``track_frame`` is what ``ops/frontend_step.py::track_scan`` and
``track_kf_scan`` run for each frame: the constant-velocity prediction, the
prior-gated pose solve, the acceptance and the carry update and, for the
scan with the keyframe in its carry, the keyframe gate and the promotion.
It is the port of the step of the JAX package's two ``lax.scan``s
(``superslam_tpu/ops/frontend_step.py::track_scan`` :539-580,
``track_kf_scan`` :719-849), which XLA compiles into one program. On a CUDA
tensor it launches the kernel ``track_frame.cu`` (its header says what
bounds it on the H100 and how the design answers that): one launch a
frame, no value read by the host. A CPU tensor goes through the plain
version ``track_frame_plain``: ``pose_solve_plain`` and the epilogue
``track_frame_epilogue_plain``, the scans' former Python body.

``track_frame_batched`` is track_scan's body for Q sequences in one
launch (``parallel/batched_tracking.py::batched_track_scan``, the JAX
package's vmap of track_scan): the same kernel in track_scan mode as a
grid of Q blocks, one a sequence, each at its own strides; its plain
version ``track_frame_batched_plain`` is ``track_frame_plain`` a sequence.

The kernel's solve sums in another order than PyTorch, so its poses agree
with the plain version to f32 rounding; on its own solve (the raw solve is
an output) the plain epilogue gives the same counts and bits:
chip_smoke.py and tests/test_torch_kernels_gpu.py state the tolerances.
"""

from __future__ import annotations

import torch

from . import _build
from .pose_solve import MAX_K, pose_solve_plain, reprojection

TRACK_COLS = 13  # R row-major (9) + t (3) + n_matches (1)
TRACK_KF_COLS = 16  # R row-major (9) + t (3) + n + support + accept + promo
_SMALL = 36  # the kernel's f32 outputs: R_new, t_new, Rr, tr, R_s, t_s


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


def _select(tm, rematch, fresh):
    """The match a frame uses: ``tm`` (the entry keyframe's batched match)
    while the carried keyframe is still the entry one, else ``rematch``."""
    if rematch is None:
        return tm
    return tm if fresh is None else torch.where(fresh, tm, rematch)


def track_frame_epilogue_plain(raw, pose_carry, frame, tm, kf_state, *, calib, min_matches,
                               keyframes=None, rematch=None, fresh=None):
    """Everything of a frame's body after the solve, on the solve ``raw`` =
    (R_s, t_s, n, kept): the acceptance, the carry and, with ``keyframes``,
    the gate and the promotion. Arguments and results as ``track_frame``;
    chip_smoke runs it on the kernel's own raw solve."""
    R_prev, t_prev, Rr, tr = pose_carry
    kl_s, nkl_s, dl_s, vl_s, disp_s, sok_s = frame
    kf_nk, kf_d, kf_v, kf_xw, kf_dok, since = kf_state
    R_s, t_s, n, _kept = raw
    tm = _select(tm, rematch, fresh)
    R_pred = R_prev @ Rr
    t_pred = R_prev @ tr + t_prev
    if keyframes is None:
        use = n >= min_matches
        R_new = _reorthonormalize(torch.where(use, R_s, R_pred))
        t_new = torch.where(use, t_s, t_pred)
        Rr = torch.where(use, R_prev.T @ R_new, Rr)
        tr = torch.where(use, R_prev.T @ (t_new - t_prev), tr)
        row = torch.cat([R_new.reshape(9), t_new, n.to(torch.float32)[None]])
        return row, tm, (R_new, t_new, Rr, tr), kf_state, fresh

    accept_frac, support_px, kf_min_frames, kf_max_frames, kf_min_matches, covis_ratio = (
        keyframes[k] for k in ("accept_frac", "support_px", "kf_min_frames", "kf_max_frames",
                               "kf_min_matches", "covis_ratio"))
    fi = torch.clamp(tm, min=0).to(torch.int64)
    ok = (tm >= 0) & sok_s[fi] & kf_dok
    uv = torch.stack([kl_s[:, 0][fi], kl_s[:, 1][fi]], dim=1)

    # Support-based acceptance: VoEstimator._attempt's rule.
    r, zok = reprojection(R_s, t_s, kf_xw, uv, calib)
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
    row = torch.cat([R_new.reshape(9), t_new,
                     torch.stack([n.float(), support.float(), accept.float(), promo.float()])])

    # The promotion: where promo is set, the frame's features become the
    # keyframe, their world points grounded through the accepted solve
    # (Xw = R Xc + t); elsewhere the keyframe stays. Selected on the
    # device, as the JAX scan does: nothing is read back.
    fx, fy, cx, cy, baseline = calib
    z = (fx * baseline) / torch.clamp(disp_s, min=1e-3)
    x = (kl_s[:, 0] - cx) * z / fx
    y = (kl_s[:, 1] - cy) * z / fy
    xw_new = torch.stack([x, y, z], dim=1) @ R_new.T + t_new
    new_state = (
        torch.where(promo, nkl_s, kf_nk),
        torch.where(promo, dl_s, kf_d),
        torch.where(promo, vl_s, kf_v),
        torch.where(promo, xw_new, kf_xw),
        torch.where(promo, sok_s, kf_dok),
        torch.where(promo, torch.zeros_like(since1), since1),
    )
    fresh = ~promo if fresh is None else fresh & ~promo
    return row, tm, (R_new, t_new, Rr, tr), new_state, fresh


def track_frame_plain(pose_carry, frame, tm, kf_state, *, calib, min_matches, inv_sig_uLv,
                      disp_sigma0, disp_cond, mono, gate_px, chi2_px, chi2_rounds, track_iters,
                      keyframes=None, rematch=None, fresh=None):
    """The plain version (arguments and results as ``track_frame``)."""
    R_prev, t_prev, Rr, tr = pose_carry
    kl_s, _nkl, _dl, _vl, disp_s, sok_s = frame
    _nk, _d, _v, kf_xw, kf_dok, _since = kf_state
    # Constant-velocity prediction: the GATING pose, and the coast.
    R_pred = R_prev @ Rr
    t_pred = R_prev @ tr + t_prev
    R_s, t_s, n, _ok, kept, _uv = pose_solve_plain(
        R_prev, t_prev, R_pred, t_pred, kl_s, disp_s, sok_s, _select(tm, rematch, fresh), kf_xw,
        kf_dok, calib=calib, min_matches=min_matches, inv_sig_uLv=inv_sig_uLv,
        disp_sigma0=disp_sigma0, disp_cond=disp_cond, mono=mono, gate_px=gate_px,
        chi2_px=chi2_px, chi2_rounds=chi2_rounds, track_iters=track_iters,
    )
    raw = (R_s, t_s, n, kept)
    out = track_frame_epilogue_plain(
        raw, pose_carry, frame, tm, kf_state, calib=calib, min_matches=min_matches,
        keyframes=keyframes, rematch=rematch, fresh=fresh,
    )
    return (*out, raw)


def track_frame(pose_carry, frame, tm, kf_state, *, calib, min_matches, inv_sig_uLv,
                disp_sigma0, disp_cond, mono, gate_px, chi2_px, chi2_rounds, track_iters,
                keyframes=None, rematch=None, fresh=None, out=None):
    """One frame of a tracking scan (the semantics are documented on
    ``ops/frontend_step.py::track_scan`` and ``track_kf_scan``).

    pose_carry (R_prev (3, 3), t_prev (3,), Rr (3, 3), tr (3,)) f32: the
    previous pose and the constant-velocity model. frame (kl (K, 2) px,
    nkl (K, 2), dl (K, D), vl (K,) bool, disp (K,), stereo_ok (K,) bool);
    kf_state (nk (K, 2), desc (K, D), valid (K,) bool, xw (K, 3) f32,
    depth_ok (K,) bool, since (int32 scalar)). tm (K,) int32: the frame
    keypoint each keyframe feature matched, or -1. The solve reads only kl,
    disp, stereo_ok, xw and depth_ok: without ``keyframes`` (track_scan's
    body) the others may be None.

    keyframes: None for track_scan's epilogue (coast below min_matches, a
    TRACK_COLS row); else a dict of accept_frac, support_px, kf_min_frames,
    kf_max_frames, kf_min_matches and covis_ratio for track_kf_scan's (the
    support-based acceptance, the keyframe gate, the promotion, a
    TRACK_KF_COLS row). rematch (K,) int32 and fresh (bool scalar), the
    hybrid's: the frame uses ``tm`` while ``fresh`` is set, else
    ``rematch``; fresh None means the entry keyframe. out: (row, matches)
    tensors to write the row and the match used into, matches None when
    the caller does not keep them (on the card the scans pass their
    (S, cols) and (S, K) outputs' rows).

    Returns (row, the match used (K,), new pose_carry, new kf_state, new
    fresh bit (None without keyframes), raw solve (R_s, t_s, n, kept))."""
    if frame[0].device.type == "cpu":
        got = track_frame_plain(
            pose_carry, frame, tm, kf_state, calib=calib, min_matches=min_matches,
            inv_sig_uLv=inv_sig_uLv, disp_sigma0=disp_sigma0, disp_cond=disp_cond, mono=mono,
            gate_px=gate_px, chi2_px=chi2_px, chi2_rounds=chi2_rounds, track_iters=track_iters,
            keyframes=keyframes, rematch=rematch, fresh=fresh,
        )
        for dst, src in zip(out or (), got[:2]):
            if dst is not None:
                dst.copy_(src)
        return got
    return _launch(pose_carry, frame, tm, kf_state, calib=calib, min_matches=min_matches,
                   inv_sig_uLv=inv_sig_uLv, disp_sigma0=disp_sigma0, disp_cond=disp_cond,
                   mono=mono, gate_px=gate_px, chi2_px=chi2_px, chi2_rounds=chi2_rounds,
                   track_iters=track_iters, keyframes=keyframes, rematch=rematch, fresh=fresh,
                   out=out)


def _launch(pose_carry, frame, tm, kf_state, *, calib, min_matches, inv_sig_uLv, disp_sigma0,
            disp_cond, mono, gate_px, chi2_px, chi2_rounds, track_iters, keyframes, rematch,
            fresh, out):
    kl, nkl, dl, vl, disp, sok = frame
    kf_nk, kf_d, kf_v, kf_xw, kf_dok, since = kf_state
    dev = kl.device
    if dev.type != "cuda":
        raise ValueError(f"track_frame: unsupported device {dev}")
    k = kl.shape[0]
    if not 1 <= k <= MAX_K:
        raise ValueError(f"track_frame: {k} correspondences, the kernel takes 1..{MAX_K}")
    kf = keyframes is not None
    f32 = [*pose_carry, kl, disp, kf_xw] + ([nkl, kf_nk] if kf else [])
    if any(t.dtype != torch.float32 or t.device != dev for t in f32):
        raise ValueError("track_frame: poses, keypoints, disparities and world points must be "
                         "f32 on one device")
    bools = [sok, kf_dok] + ([vl, kf_v] if kf else []) + ([fresh] if fresh is not None else [])
    if any(t.dtype != torch.bool or t.device != dev for t in bools):
        raise ValueError("track_frame: stereo_ok, depth_ok, valid and fresh must be bool on the "
                         "frame's device")
    matches = [tm] + ([rematch] if rematch is not None else [])
    if any(t.dtype != torch.int32 or t.device != dev or t.shape != (k,) for t in matches):
        raise ValueError("track_frame: the matches must be (K,) int32 on the frame's device")
    if kf and (dl.dtype != kf_d.dtype or dl.shape != kf_d.shape or dl.shape[0] != k
               or since.dtype != torch.int32):
        raise ValueError("track_frame: the frame's and the keyframe's descriptors must be "
                         "(K, D) of one type, since int32")
    R_prev, t_prev, Rr, tr = pose_carry
    # One (24,) carry: the caller's is a view of the last frame's output (or
    # of one upload), so this is no copy.
    carry = _flat_carry(R_prev, t_prev, Rr, tr)
    cols = TRACK_KF_COLS if kf else TRACK_COLS
    row, match_out = out if out is not None else (
        torch.empty(cols, dtype=torch.float32, device=dev),
        torch.empty(k, dtype=torch.int32, device=dev))
    if (row.shape != (cols,) or row.dtype != torch.float32 or not row.is_contiguous()
            or match_out is not None and (match_out.shape != (k,)
                                          or match_out.dtype != torch.int32)):
        raise ValueError(f"track_frame: out must be a ({cols},) f32 row and (K,) int32 matches")
    if match_out is None and rematch is not None:
        raise ValueError("track_frame: a re-match needs the matches out: which one was used is "
                         "decided on the device")
    small = torch.empty(_SMALL + (5 * k if kf else 0), dtype=torch.float32, device=dev)
    stats = torch.empty(3, dtype=torch.int32, device=dev)
    ins = [t.contiguous() for t in (kl, disp, sok, tm, kf_xw, kf_dok)]
    rm = rematch.contiguous() if rematch is not None else None
    null = 0
    if kf:
        new_desc = torch.empty_like(dl, memory_format=torch.contiguous_format)
        flags = torch.empty(2 * k + 1, dtype=torch.bool, device=dev)
        kin = [t.contiguous() for t in (nkl, dl, vl, kf_nk, kf_d, kf_v, since)]
        new_nk, new_xw = small[_SMALL:_SMALL + 2 * k].view(k, 2), small[_SMALL + 2 * k:].view(k, 3)
        new_v, new_dok, new_fresh = flags[:k], flags[k:2 * k], flags[2 * k]
        kf_ptrs = [t.data_ptr() for t in kin]
        kf_ptrs.append(fresh.data_ptr() if fresh is not None else null)
        out_ptrs = [t.data_ptr() for t in (new_nk, new_desc, new_v, new_xw, new_dok, new_fresh)]
        desc_bytes = new_desc.numel() * new_desc.element_size()
        gate = (float(keyframes["accept_frac"]), float(keyframes["support_px"]),
                int(keyframes["kf_min_frames"]), int(keyframes["kf_max_frames"]),
                int(keyframes["kf_min_matches"]), float(keyframes["covis_ratio"]))
    else:
        kf_ptrs, out_ptrs, desc_bytes = [null] * 8, [null] * 6, 0
        gate = (0.0, 0.0, 0, 0, 0, 0.0)
    fx, fy, cx, cy, baseline = (float(c) for c in calib)
    err = _build.library().ssl_track_frame(
        carry.data_ptr(), *(t.data_ptr() for t in ins[:4]),
        rm.data_ptr() if rm is not None else null,
        ins[4].data_ptr(), ins[5].data_ptr(), *kf_ptrs, row.data_ptr(),
        match_out.data_ptr() if match_out is not None else null,
        small.data_ptr(), stats.data_ptr(), *out_ptrs, k, desc_bytes, fx, fy, cx, cy, baseline,
        int(min_matches), float(inv_sig_uLv), float(disp_sigma0), float(disp_cond),
        int(bool(mono)), float(gate_px), float(chi2_px), int(chi2_rounds), int(track_iters),
        int(kf), *gate, fx * baseline, _build.stream_of(kl),
    )
    _build.check(err, "track_frame")
    _build.count("track_frame")
    used = match_out if match_out is not None else ins[3]
    new_carry = (small[:9].view(3, 3), small[9:12], small[12:21].view(3, 3), small[21:24])
    raw = (small[24:33].view(3, 3), small[33:36], stats[0], stats[1])
    if kf:
        new_state = (new_nk, new_desc, new_v, new_xw, new_dok, stats[2])
        return row, used, new_carry, new_state, new_fresh, raw
    return row, used, new_carry, kf_state, None, raw


def _flat_carry(R_prev, t_prev, Rr, tr):
    """The carry as one contiguous (24,) tensor: the storage it already
    views when the four lie back to back in it (a previous frame's output,
    or the tracker's one upload), else a copy."""
    base = R_prev
    if all(t.is_contiguous() for t in (R_prev, t_prev, Rr, tr)):
        ptr, size = R_prev.data_ptr(), R_prev.element_size()
        if (t_prev.data_ptr() == ptr + 9 * size and Rr.data_ptr() == ptr + 12 * size
                and tr.data_ptr() == ptr + 21 * size
                and R_prev.untyped_storage().data_ptr() == tr.untyped_storage().data_ptr()):
            return torch.as_strided(base, (24,), (1,))
    return torch.cat([R_prev.reshape(9), t_prev, Rr.reshape(9), tr])


def track_frame_batched_plain(carry, kl, disp, stereo_ok, tm, kf_xw, kf_dok, *, calib,
                              min_matches, inv_sig_uLv, disp_sigma0, disp_cond, mono, gate_px,
                              chi2_px, chi2_rounds, track_iters):
    """The plain version of ``track_frame_batched``: ``track_frame_plain``
    (track_scan's epilogue) for each sequence in turn."""
    rows, smalls, stats = [], [], []
    for q in range(carry.shape[0]):
        c = carry[q]
        pose_carry = (c[:9].reshape(3, 3), c[9:12], c[12:21].reshape(3, 3), c[21:24])
        row, _tm, new, _kf, _fresh, raw = track_frame_plain(
            pose_carry, (kl[q], None, None, None, disp[q], stereo_ok[q]), tm[q],
            (None, None, None, kf_xw[q], kf_dok[q], None), calib=calib, min_matches=min_matches,
            inv_sig_uLv=inv_sig_uLv, disp_sigma0=disp_sigma0, disp_cond=disp_cond, mono=mono,
            gate_px=gate_px, chi2_px=chi2_px, chi2_rounds=chi2_rounds, track_iters=track_iters,
        )
        R_s, t_s, n, kept = raw
        rows.append(row)
        smalls.append(torch.cat([new[0].reshape(9), new[1], new[2].reshape(9), new[3],
                                 R_s.reshape(9), t_s]))
        stats.append(torch.stack([n.to(torch.int32), torch.as_tensor(kept).to(torch.int32)]))
    return torch.stack(rows), torch.stack(smalls), torch.stack(stats)


def track_frame_batched(carry, kl, disp, stereo_ok, tm, kf_xw, kf_dok, *, calib, min_matches,
                        inv_sig_uLv, disp_sigma0, disp_cond, mono, gate_px, chi2_px, chi2_rounds,
                        track_iters, row_out=None):
    """One frame of track_scan for Q sequences in one launch (the body of
    ``parallel/batched_tracking.py::batched_track_scan``).

    carry (Q, >=24) f32, rows R_prev (9, row-major), t_prev, Rr, tr (a
    previous call's ``small`` is one); kl (Q, K, 2) f32 px, disp (Q, K) f32,
    stereo_ok (Q, K) bool, tm (Q, K) int32, kf_xw (Q, K, 3) f32, kf_dok (Q,
    K) bool: any stride between sequences, each sequence's rows contiguous
    (a frame index of (Q, S, ...) inputs is one). row_out: a (Q, TRACK_COLS)
    f32 tensor with contiguous rows to write into, or None.

    Returns (rows (Q, TRACK_COLS), small (Q, 36): the new carry in its first
    24 columns then the raw solve R_s, t_s, stats (Q, 2) int32: n and
    kept)."""
    kw = dict(calib=calib, min_matches=min_matches, inv_sig_uLv=inv_sig_uLv,
              disp_sigma0=disp_sigma0, disp_cond=disp_cond, mono=mono, gate_px=gate_px,
              chi2_px=chi2_px, chi2_rounds=chi2_rounds, track_iters=track_iters)
    if kl.device.type == "cpu":
        rows, small, stats = track_frame_batched_plain(
            carry, kl, disp, stereo_ok, tm, kf_xw, kf_dok, **kw)
        if row_out is not None:
            row_out.copy_(rows)
            rows = row_out
        return rows, small, stats
    return _launch_batched(carry, kl, disp, stereo_ok, tm, kf_xw, kf_dok, row_out=row_out, **kw)


def _seq_stride(name, t, shape, dtype, dev):
    """The stride between sequences of a (Q, ...) input whose per-sequence
    block is contiguous."""
    if t.dtype != dtype or t.device != dev or tuple(t.shape) != shape:
        raise ValueError(f"track_frame_batched: {name} must be {shape} {dtype} on {dev}, "
                         f"got {tuple(t.shape)} {t.dtype} on {t.device}")
    inner = 1
    for size, stride in zip(reversed(t.shape[1:]), reversed(t.stride()[1:])):
        if size > 1 and stride != inner:
            raise ValueError(f"track_frame_batched: {name}'s rows must be contiguous")
        inner *= size
    return t.stride(0)


def _launch_batched(carry, kl, disp, stereo_ok, tm, kf_xw, kf_dok, *, calib, min_matches,
                    inv_sig_uLv, disp_sigma0, disp_cond, mono, gate_px, chi2_px, chi2_rounds,
                    track_iters, row_out):
    dev = kl.device
    if dev.type != "cuda":
        raise ValueError(f"track_frame_batched: unsupported device {dev}")
    if kl.dim() != 3 or kl.shape[2] != 2:
        raise ValueError(f"track_frame_batched: kl must be (Q, K, 2), got {tuple(kl.shape)}")
    Q, k = kl.shape[0], kl.shape[1]
    if Q < 1 or not 1 <= k <= MAX_K:
        raise ValueError(f"track_frame_batched: Q {Q}, K {k}; the kernel takes Q >= 1 and "
                         f"K 1..{MAX_K}")
    if carry.dim() != 2 or carry.shape[0] != Q or carry.shape[1] < 24:
        raise ValueError(f"track_frame_batched: carry must be (Q, >=24), got {tuple(carry.shape)}")
    strides = [
        _seq_stride("carry", carry[:, :24], (Q, 24), torch.float32, dev),
        _seq_stride("kl", kl, (Q, k, 2), torch.float32, dev),
        _seq_stride("disp", disp, (Q, k), torch.float32, dev),
        _seq_stride("stereo_ok", stereo_ok, (Q, k), torch.bool, dev),
        _seq_stride("tm", tm, (Q, k), torch.int32, dev),
        _seq_stride("kf_xw", kf_xw, (Q, k, 3), torch.float32, dev),
        _seq_stride("kf_dok", kf_dok, (Q, k), torch.bool, dev),
    ]
    rows = row_out if row_out is not None else torch.empty(
        (Q, TRACK_COLS), dtype=torch.float32, device=dev)
    small = torch.empty((Q, _SMALL), dtype=torch.float32, device=dev)
    stats = torch.empty((Q, 3), dtype=torch.int32, device=dev)
    strides += [_seq_stride("row_out", rows, (Q, TRACK_COLS), torch.float32, dev), _SMALL, 3]
    ptrs = [t.data_ptr() for t in (carry, kl, disp, stereo_ok, tm, kf_xw, kf_dok, rows, small,
                                   stats)]
    args = [a for pair in zip(ptrs, strides) for a in pair]
    fx, fy, cx, cy, baseline = (float(c) for c in calib)
    err = _build.library().ssl_track_frame_batched(
        Q, *args, k, fx, fy, cx, cy, baseline, int(min_matches), float(inv_sig_uLv),
        float(disp_sigma0), float(disp_cond), int(bool(mono)), float(gate_px), float(chi2_px),
        int(chi2_rounds), int(track_iters), _build.stream_of(kl),
    )
    _build.check(err, "track_frame_batched")
    _build.count("track_frame_batched")
    return rows, small, stats[:, :2]

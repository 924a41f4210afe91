"""What decides ``correct``: the program's answers against the reference's.

A unit is one stream-frame that a timed step produced: its images, the
program's packed block as it reached the host (keypoints in 1/16 px, the
stereo disparity or -1, and for each keyframe feature the index of the
frame keypoint it matched or -1), the program's descriptors, and the
keyframe's packed rows and images. The reference works every feature and
every match out again from the images (``reference.Reference``), the
keyframe's included. Keypoints correspond where each is the other's
nearest within 0.5 px; no two keypoints lie that close (NMS radius 4).

Numbers (each held against its own limit in ``limits/<cell>.json``):
- ``kpt_miss_pct``: keypoints of either side with no counterpart, in % of
  all keypoints of both sides;
- ``desc_err``: the largest 1 - cos between the descriptors of
  corresponding keypoints in the same descriptor cell (a sub-pixel
  position on either side of a cell edge takes another cell's row);
- ``stereo_disagree_pct``: left keypoints whose stereo verdict (ok or not,
  and the disparity within 0.5 px) differs, in % (stereo cells);
- ``track_disagree_pct``: keyframe features whose match (a frame keypoint
  or none) differs, in %;
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from slambench.reference import stereo_gates

PACK_SCALE = 16.0
NEAR_PX = 0.5
CELL = 8  # pixels a descriptor cell side


@dataclass
class Unit:
    left: np.ndarray  # (h, w) uint8
    right: np.ndarray | None  # stereo cells
    packed: np.ndarray  # (rows, K) int16: x, y, [disparity,] track match
    desc: torch.Tensor  # (K, D) f32 program descriptors
    kf_left: np.ndarray | None  # the keyframe's image (None: no keyframe yet)
    kf_packed: np.ndarray | None  # the keyframe's packed rows


def _positions(packed: np.ndarray):
    x = packed[0].astype(np.float64)
    n = int((x >= 0).sum())
    return np.stack([x[:n], packed[1, :n].astype(np.float64)], 1) / PACK_SCALE


def correspond(p: np.ndarray, r: np.ndarray):
    """Mutual nearest neighbours within NEAR_PX. Returns (p2r, r2p), -1 where
    a keypoint has no counterpart."""
    p2r = np.full(len(p), -1, np.int64)
    r2p = np.full(len(r), -1, np.int64)
    if len(p) == 0 or len(r) == 0:
        return p2r, r2p
    d = torch.cdist(torch.from_numpy(p), torch.from_numpy(r)).numpy()
    pj, ri = d.argmin(1), d.argmin(0)
    for i, j in enumerate(pj):
        if ri[j] == i and d[i, j] <= NEAR_PX:
            p2r[i], r2p[j] = j, i
    return p2r, r2p


def judge(units: list[Unit], ref, cfg: dict) -> dict[str, float]:
    """The numbers of the module docstring over ``units``."""
    sp, lg, cam = cfg["superpoint"], cfg["lightglue"], cfg["camera"]
    w, h = cam["width"], cam["height"]
    stereo = units[0].right is not None
    imgs = [u.left for u in units]
    if stereo:
        imgs += [u.right for u in units]
    kf_units = [i for i, u in enumerate(units) if u.kf_left is not None]
    imgs += [units[i].kf_left for i in kf_units]
    feats = ref.features(np.stack(imgs), sp, w, h)
    n = len(units)
    L = tuple(t[:n] for t in feats)
    if stereo:
        R = tuple(t[n : 2 * n] for t in feats)
        _, m_st = ref.match(L, R, lg, w, h)
        disp, ok = stereo_gates(L[0].to(m_st.device), R[0].to(m_st.device), L[1].to(m_st.device),
                                m_st, cfg["stereo"]["min_disparity"])
        disp, ok = disp.cpu().numpy(), ok.cpu().numpy()
    base = 2 * n if stereo else n
    KF = tuple(t[base:] for t in feats)
    if kf_units:
        _, m_tr = ref.match(KF, tuple(t[kf_units] for t in L), lg, w, h)
        m_tr = m_tr.cpu().numpy()

    miss = total = 0
    desc_err = 0.0
    st_dis = st_n = tr_dis = tr_n = 0
    for u_i, u in enumerate(units):
        pos = _positions(u.packed)
        rv = L[1][u_i].cpu().numpy()
        rpos = L[0][u_i].cpu().numpy()[rv].astype(np.float64)
        ridx = np.flatnonzero(rv)  # reference rows of its valid keypoints (a prefix)
        p2r, r2p = correspond(pos, rpos)
        miss += int((p2r < 0).sum() + (r2p < 0).sum())
        total += len(pos) + len(rpos)
        has = np.flatnonzero(p2r >= 0)
        rpix = L[3][u_i].cpu().numpy()[ridx[p2r[has]]]
        same = has[(np.floor(np.rint(pos[has]) / CELL) == rpix // CELL).all(1)
                   & (np.abs(pos[has] - np.rint(pos[has])) < 0.5).all(1)]
        if len(same):
            dp = u.desc[: len(pos)][torch.from_numpy(same)].float().cpu()
            dr = L[2][u_i][torch.from_numpy(ridx[p2r[same]])].cpu()
            desc_err = max(desc_err, float((1.0 - (dp * dr).sum(-1)).max()))
        if stereo:
            prog_ok = u.packed[2, : len(pos)] >= 0
            prog_d = u.packed[2, : len(pos)].astype(np.float64) / PACK_SCALE
            for i in has:
                j = ridx[p2r[i]]
                st_n += 1
                if prog_ok[i] != ok[u_i, j] or (prog_ok[i] and abs(prog_d[i] - disp[u_i, j]) > NEAR_PX):
                    st_dis += 1
        if u.kf_left is None:
            continue
        k_i = kf_units.index(u_i)
        kpos = _positions(u.kf_packed)
        kv = KF[1][k_i].cpu().numpy()
        k2r, _ = correspond(kpos, KF[0][k_i].cpu().numpy()[kv].astype(np.float64))
        kidx = np.flatnonzero(kv)
        ans = u.packed[-1].astype(np.int64)
        # Rows past the keyframe's valid prefix are padding: only "none" is right there.
        bad_pad = int((ans[len(kpos) :] != -1).sum())
        tr_dis += bad_pad
        tr_n += bad_pad
        for i in np.flatnonzero(k2r >= 0):
            ref_a = int(m_tr[k_i, kidx[k2r[i]]])
            a = int(ans[i])
            if a < 0 and ref_a >= 0 and r2p[ref_a] < 0:
                continue  # the reference matched a keypoint the program does not have
            tr_n += 1
            if a < 0:
                tr_dis += ref_a >= 0
            elif a >= len(pos) or p2r[a] < 0:
                tr_dis += 1
            else:
                tr_dis += ref_a != ridx[p2r[a]]
    out = {
        "kpt_miss_pct": 100.0 * miss / max(total, 1),
        "desc_err": desc_err,
        "track_disagree_pct": 100.0 * tr_dis / max(tr_n, 1),
    }
    if stereo:
        out["stereo_disagree_pct"] = 100.0 * st_dis / max(st_n, 1)
    return out


def verdict(numbers: dict[str, float], limits: dict[str, float]) -> bool:
    """Every number at or under its limit; a number without a limit, or a
    limit without a number, fails."""
    if set(numbers) != set(limits):
        return False
    return all(numbers[k] <= limits[k] for k in limits)


def program_like(ref, units: list[Unit], cfg: dict) -> list[Unit]:
    """The reference put in the program's place: the same units with packed
    blocks and descriptors computed by ``ref`` (the control runs it at
    float8). The keyframe's rows come from ``ref`` too."""
    sp, lg, cam = cfg["superpoint"], cfg["lightglue"], cfg["camera"]
    w, h = cam["width"], cam["height"]
    stereo = units[0].right is not None
    n = len(units)
    imgs = [u.left for u in units] + ([u.right for u in units] if stereo else [])
    kf_units = [i for i, u in enumerate(units) if u.kf_left is not None]
    imgs += [units[i].kf_left for i in kf_units]
    feats = ref.features(np.stack(imgs), sp, w, h)
    L = tuple(t[:n] for t in feats)
    base = 2 * n if stereo else n
    KF = tuple(t[base:] for t in feats)
    rows = []
    if stereo:
        R = tuple(t[n : 2 * n] for t in feats)
        _, m = ref.match(L, R, lg, w, h)
        d, ok = stereo_gates(L[0].to(m.device), R[0].to(m.device), L[1].to(m.device), m,
                             cfg["stereo"]["min_disparity"])
        disp_row = torch.where(ok, d * PACK_SCALE, torch.full_like(d, -1.0)).cpu()
    track = torch.full((n, L[0].shape[1]), -1, dtype=torch.int64)
    if kf_units:
        _, m_tr = ref.match(KF, tuple(t[kf_units] for t in L), lg, w, h)
        track[kf_units] = m_tr.cpu()

    def pack(k, v):
        x = torch.where(v, k[..., 0] * PACK_SCALE, torch.full_like(k[..., 0], -1.0))
        return [x, k[..., 1] * PACK_SCALE]

    out = []
    for i, u in enumerate(units):
        k, v = L[0][i].cpu(), L[1][i].cpu()
        r = pack(k, v) + ([disp_row[i]] if stereo else []) + [track[i].float()]
        packed = torch.round(torch.stack(r)).to(torch.int16).numpy()
        kf_packed = None
        if u.kf_left is not None:
            j = kf_units.index(i)
            kf_packed = torch.round(torch.stack(pack(KF[0][j].cpu(), KF[1][j].cpu()))).to(torch.int16).numpy()
        out.append(Unit(u.left, u.right, packed, L[2][i], u.kf_left, kf_packed))
    return out

"""Matcher supervision harvested from the sprite-world renderer.

Port of the matcher half of ``superslam_tpu/train/render_domain.py``:
``harvest_matching_pair`` renders two views of a sprite world with exact
sprite-id maps, extracts keypoints and descriptors through SuperPoint and
derives the ground-truth assignment by ray-plane intersection,
reprojection and sprite-id agreement; ``match_prf`` and ``mutual_nn_prf``
score predicted matches against it. The geometry is numpy, as in the JAX
package; only the extraction runs on ``device``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..eval.synthetic_sequence import SpriteWorld, render_view
from ..geometry import Pose3, StereoCalib
from ..models.superpoint import superpoint_extract


def harvest_matching_pair(
    sp_params,
    world: SpriteWorld,
    pose0: Pose3,
    pose1: Pose3,
    calib: StereoCalib,
    h: int,
    w: int,
    cap: int,
    rng: np.random.Generator,
    keypoint_threshold: float = 0.012,
    device="cuda",
):
    """One matcher-training sample: SuperPoint features of two rendered
    views + the ground-truth assignment (sprite-plane lift -> reprojection
    -> sprite-id agreement; one-to-one by nearest). Returns None when too
    few covisible keypoints survive. Keypoints are normalized exactly as
    the production matcher wrapper does (frontend/matcher.py). ``sp_params``
    must already lie on ``device``."""
    img0, ids0 = render_view(world, pose0, calib, h, w, rng, return_ids=True)
    img1, ids1 = render_view(world, pose1, calib, h, w, rng, return_ids=True)
    image = torch.from_numpy(np.stack([img0, img1]).astype(np.float32)).to(device)
    kpts, _, valid, desc = superpoint_extract(
        sp_params, image, max_keypoints=cap, keypoint_threshold=keypoint_threshold
    )
    kpts = kpts.cpu().numpy()
    valid = valid.cpu().numpy()
    desc = desc.float().cpu().numpy()
    n0, n1 = int(valid[0].sum()), int(valid[1].sum())
    if n0 < 16 or n1 < 16:
        return None

    def sprite_id_at(ids, pts):
        xi = np.clip(np.round(pts[:, 0]).astype(int), 0, w - 1)
        yi = np.clip(np.round(pts[:, 1]).astype(int), 0, h - 1)
        return ids[yi, xi]

    K = np.array([[calib.fx, 0, calib.cx], [0, calib.fy, calib.cy], [0, 0, 1]])
    Kinv = np.linalg.inv(K)
    p0 = kpts[0][:n0]
    s0 = sprite_id_at(ids0, p0)
    rays = (Kinv @ np.concatenate([p0, np.ones((n0, 1))], 1).T).T
    d_w = rays @ pose0.R.T
    o = pose0.t
    gt = np.full(cap, -1, np.int32)
    p1 = kpts[1][:n1]
    s1 = sprite_id_at(ids1, p1)
    nrm = np.cross(world.ax_u, world.ax_v)
    R1, t1 = pose1.R, pose1.t
    taken = np.full(n1, False)
    for i in range(n0):
        sp = s0[i]
        if sp < 0:
            continue
        n_s = nrm[sp]
        denom = d_w[i] @ n_s
        if abs(denom) < 1e-9:
            continue
        lam = ((world.centers[sp] - o) @ n_s) / denom
        if lam <= 0:
            continue
        X = o + lam * d_w[i]
        pc = R1.T @ (X - t1)
        if pc[2] < 0.2:
            continue
        u = calib.fx * pc[0] / pc[2] + calib.cx
        v = calib.fy * pc[1] / pc[2] + calib.cy
        d = np.hypot(p1[:, 0] - u, p1[:, 1] - v)
        cand = np.flatnonzero((d < 3.0) & (s1 == sp) & ~taken)
        if cand.size:
            j = cand[np.argmin(d[cand])]
            gt[i] = j
            taken[j] = True

    if (gt >= 0).sum() < 8:
        return None
    center = np.array([w / 2.0, h / 2.0], np.float32)
    scale = np.float32(max(w, h) / 2.0)
    kn = (kpts - center) / scale
    mask = np.stack([np.arange(cap) < n0, np.arange(cap) < n1])
    return {
        "kpts0": kn[0].astype(np.float32),
        "desc0": desc[0].astype(np.float32),
        "kpts1": kn[1].astype(np.float32),
        "desc1": desc[1].astype(np.float32),
        "mask0": mask[0],
        "mask1": mask[1],
        "gt_indices": gt,
    }


def match_prf(matches: np.ndarray, gt: np.ndarray) -> tuple[float, float]:
    """Precision/recall of predicted (i, j) pairs vs a GT assignment."""
    pred = {(int(i), int(j)) for i, j in matches}
    truth = {(int(i), int(j)) for i, j in enumerate(gt) if j >= 0}
    if not pred or not truth:
        return 0.0, 0.0
    tp = len(pred & truth)
    return tp / len(pred), tp / len(truth)


def mutual_nn_prf(sample: dict[str, np.ndarray]) -> tuple[float, float]:
    """Descriptor-only mutual-NN precision/recall on a harvested sample:
    the gate for the analytic passthrough matcher."""
    n0 = int(sample["mask0"].sum())
    n1 = int(sample["mask1"].sum())
    sim = sample["desc0"][:n0] @ sample["desc1"][:n1].T
    a01 = sim.argmax(1)
    a10 = sim.argmax(0)
    mut = np.flatnonzero(a10[a01] == np.arange(n0))
    return match_prf(np.stack([mut, a01[mut]], 1), sample["gt_indices"])

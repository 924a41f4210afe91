"""SuperPoint pretraining losses and the train step.

Port of ``superslam_tpu/train/superpoint_train.py``: the training objective
of "SuperPoint: Self-Supervised Interest Point Detection and Description"
(DeTone et al. 2018) over the procedural data of ``train.synthetic_shapes``
and the sprite-world renders of ``train.render_domain``:

- detector: per-cell 65-way softmax cross-entropy against the known corner
  positions, on BOTH views of the pair;
- descriptor: dense cell-pair hinge loss with the correspondence matrix
  derived on the device from the sampled homography (or, for two-view
  renders, from per-cell reprojection targets, with a hardest-negative
  ranking term).

The forward is ``models/superpoint.py::superpoint_raw`` (cuDNN convs in f32;
the JAX package's training forward never runs its Pallas kernels either).
``sp_train_step`` runs under ``highest_f32_matmuls``, so the card computes
in f32 as the JAX package does, not in cuDNN's default TF32. Parameters are
a flat dict of leaf tensors that require grad, updated in place by a
``torch.optim`` optimizer. The losses take the JAX package's NHWC layouts.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.superpoint import superpoint_raw
from ..ops.precision import highest_f32_matmuls
from .synthetic_shapes import CELL

Params = dict[str, torch.Tensor]


def _detector_ce(logits: torch.Tensor, labels: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Masked mean softmax cross-entropy. logits (B, gh, gw, 65),
    labels (B, gh, gw) int, valid (B, gh, gw) f32."""
    logp = torch.log_softmax(logits, dim=-1)
    picked = torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    return -torch.sum(picked * valid) / torch.clamp(torch.sum(valid), min=1.0)


def _descriptor_hinge(
    desc0: torch.Tensor,
    desc1: torch.Tensor,
    corr: torch.Tensor,
    valid1: torch.Tensor,
    row_valid: torch.Tensor | None = None,
    margin_pos: float = 1.0,
    margin_neg: float = 0.2,
    lambda_d: float = 250.0,
) -> torch.Tensor:
    """Dense hinge over all cell pairs (the paper's L_desc).

    desc0/1: (B, gh, gw, D) normalized; corr: (B, gh*gw, gh*gw) f32 with
    corr[b, i, j] = 1 when cell i of view0 maps into cell j of view1;
    valid1: (B, gh, gw) f32 masking border cells of the warped view;
    row_valid: optional (B, gh*gw) f32 masking view0 cells (two-view render
    pairs exclude the rows without a correspondence)."""
    b, gh, gw, d = desc0.shape
    n = gh * gw
    dot = torch.einsum("bid,bjd->bij", desc0.reshape(b, n, d), desc1.reshape(b, n, d))
    pos = corr * torch.clamp(margin_pos - dot, min=0.0)
    neg = (1.0 - corr) * torch.clamp(dot - margin_neg, min=0.0)
    pair_valid = valid1.reshape(b, 1, n)
    if row_valid is not None:
        pair_valid = pair_valid * row_valid[:, :, None]
    loss = (lambda_d * pos + neg) * pair_valid
    # Mean over the contributing (i, j) pairs.
    denom = torch.sum(pair_valid.expand(b, n, n))
    return torch.sum(loss) / torch.clamp(denom, min=1.0)


def _cell_centers(h: int, w: int, device) -> torch.Tensor:
    """(gh * gw, 2) pixel (x, y) centers of the 8 x 8 cells, row-major."""
    ys = torch.arange(h // CELL, dtype=torch.float32, device=device) * CELL + CELL / 2 - 0.5
    xs = torch.arange(w // CELL, dtype=torch.float32, device=device) * CELL + CELL / 2 - 0.5
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([gx.reshape(-1), gy.reshape(-1)], 1)


def _project(M: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """M (B, 3, 3), pts (m, 2) -> (B, m, 2)."""
    p = torch.cat([pts, torch.ones_like(pts[:, :1])], 1)
    q = torch.einsum("bij,mj->bmi", M, p)
    return q[..., :2] / (q[..., 2:3] + 1e-12)


def pair_targets_from_h(
    H: torch.Tensor, h: int, w: int, radius: float = 8.0
) -> tuple[torch.Tensor, torch.Tensor]:
    """Device-side descriptor targets from the pair homography (B, 3, 3).

    Returns (corr (B, n, n) f32, valid1 (B, gh, gw) f32): corr is 1 where
    cell i of view0 warps within ``radius`` px of cell j of view1; valid1 is
    1 where the whole cell of the warped view is real content (its corners'
    preimages under H^-1 lie inside the source image). The inverse is
    ``inv_ex``: no host read for a singularity check."""
    gh, gw = h // CELL, w // CELL
    H = H.float()
    centers = _cell_centers(h, w, H.device)
    warped = _project(H, centers)  # view0 cell centers in view1 pixels
    d2 = torch.sum((warped[:, :, None, :] - centers[None, None]) ** 2, dim=-1)
    corr = (d2 <= radius * radius).float()

    # Cell corners of view1, pulled back into view0 by H^-1.
    cy = torch.arange(gh, dtype=torch.float32, device=H.device) * CELL
    cx = torch.arange(gw, dtype=torch.float32, device=H.device) * CELL
    cyg, cxg = torch.meshgrid(cy, cx, indexing="ij")
    corners = torch.stack(
        [
            torch.stack([cxg + ox, cyg + oy], -1)
            for ox, oy in ((0.0, 0.0), (CELL - 1, 0.0), (0.0, CELL - 1), (CELL - 1, CELL - 1))
        ],
        0,
    ).reshape(4 * gh * gw, 2)
    back = _project(torch.linalg.inv_ex(H).inverse, corners).reshape(-1, 4, gh, gw, 2)
    inside = (
        (back[..., 0] >= 0.0)
        & (back[..., 0] <= w - 1.0)
        & (back[..., 1] >= 0.0)
        & (back[..., 1] <= h - 1.0)
    )
    return corr, torch.all(inside, dim=1).float()


def pair_targets_from_points(
    corr_pts: torch.Tensor,
    h: int,
    w: int,
    radius: float = 8.0,
    excl_radius: float = 20.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Device-side correspondence matrix from per-cell target points.

    ``corr_pts`` (B, n, 2): where each view0 cell center lands in view1
    pixels (invisible cells carry a far-away sentinel). Returns (corr,
    excl): corr marks cells within ``radius`` of the target (positives);
    excl also covers the ``excl_radius`` ring whose patches overlap the
    target, excluded from hardest-negative mining."""
    centers = _cell_centers(h, w, corr_pts.device)
    d2 = torch.sum((corr_pts[:, :, None, :] - centers[None, None]) ** 2, dim=-1)
    return (d2 <= radius * radius).float(), (d2 <= excl_radius * excl_radius).float()


def _hardest_negative_loss(
    desc0: torch.Tensor,
    desc1: torch.Tensor,
    corr: torch.Tensor,
    excl: torch.Tensor,
    row_valid: torch.Tensor,
    margin: float = 0.4,
) -> torch.Tensor:
    """HardNet-style ranking loss: the true cell must beat the hardest
    non-overlapping distractor by ``margin`` in cosine (the matcher's gate
    is positive against the MAX over all candidates)."""
    b, gh, gw, d = desc0.shape
    n = gh * gw
    dot = torch.einsum("bid,bjd->bij", desc0.reshape(b, n, d), desc1.reshape(b, n, d))
    lo = torch.full_like(dot, -2.0)
    pos = torch.amax(torch.where(corr > 0, dot, lo), dim=2)  # (b, n)
    hard = torch.amax(torch.where(excl > 0, lo, dot), dim=2)
    per_row = torch.clamp(margin + hard - pos, min=0.0) * row_valid
    return torch.sum(per_row) / torch.clamp(torch.sum(row_valid), min=1.0)


def _image_f32(x: torch.Tensor) -> torch.Tensor:
    if x.dtype == torch.uint8:
        return x.float() / 255.0
    return x.float()


def sp_loss(
    params: Params,
    batch: dict[str, torch.Tensor],
    lambda_desc: float = 1e-4,
    lambda_hard: float = 1.0,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Total loss = CE(view0) + CE(view1) + lambda * descriptor hinge
    (+ lambda_hard * hardest-negative term for two-view renders).

    ``batch`` carries one of three forms: the host targets (``corr``,
    ``valid1``, ``valid0``: synthetic_shapes.training_batch); the wire format
    (``H`` only, uint8 images: scripts/train_superpoint_torch.py), with the
    targets derived on the device by ``pair_targets_from_h``; or a two-view
    render (``corr_pts``: RenderDomainSource.two_view_compact)."""
    img0, img1 = _image_f32(batch["img0"]), _image_f32(batch["img1"])
    logits0, desc0 = superpoint_raw(params, img0)
    logits1, desc1 = superpoint_raw(params, img1)
    row_valid = None
    hard = torch.zeros((), dtype=torch.float32, device=img0.device)
    h_, w_ = img0.shape[1], img0.shape[2]
    if "corr" in batch:
        corr, valid1, valid0 = batch["corr"], batch["valid1"], batch["valid0"]
    elif "corr_pts" in batch:
        # Two-view render pair: exact reprojection targets, full frames.
        corr, excl = pair_targets_from_points(batch["corr_pts"], h_, w_)
        valid1 = torch.ones((img0.shape[0], h_ // CELL, w_ // CELL), device=img0.device)
        valid0 = valid1
        row_valid = (batch["corr_pts"][..., 0] > -1e5).float()
        hard = _hardest_negative_loss(desc0, desc1, corr, excl, row_valid)
    else:
        corr, valid1 = pair_targets_from_h(batch["H"], h_, w_)
        valid0 = torch.ones_like(valid1)
    ce0 = _detector_ce(logits0, batch["labels0"], valid0)
    ce1 = _detector_ce(logits1, batch["labels1"], valid1)
    dh = _descriptor_hinge(desc0, desc1, corr, valid1, row_valid)
    total = ce0 + ce1 + lambda_desc * dh + lambda_hard * hard
    return total, {"ce0": ce0, "ce1": ce1, "desc": dh, "hard": hard}


def make_sp_optimizer(params: Params, lr: float = 1e-3) -> torch.optim.Optimizer:
    """Adam as the JAX package's ``optax.adam(lr)``: betas (0.9, 0.999),
    eps 1e-8. Marks the parameters as requiring grad."""
    for p in params.values():
        p.requires_grad_(True)
    return torch.optim.Adam(list(params.values()), lr=lr, betas=(0.9, 0.999), eps=1e-8)


def sp_train_step(
    params: Params, optimizer: torch.optim.Optimizer, batch: dict[str, torch.Tensor]
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """One optimizer step on ``sp_loss``, in f32 (``highest_f32_matmuls``).
    Returns (loss, aux) before the step as 0-d tensors on the parameters'
    device; the step itself reads nothing back to the host."""
    optimizer.zero_grad(set_to_none=True)
    with highest_f32_matmuls():
        loss, aux = sp_loss(params, batch)
        loss.backward()
    optimizer.step()
    return loss.detach(), {k: v.detach() for k, v in aux.items()}


def evaluate_detector(
    params: Params,
    rng: np.random.Generator,
    n_images: int = 8,
    h: int = 120,
    w: int = 160,
    threshold: float = 0.015,
    max_keypoints: int = 256,
    image_fn=None,
) -> dict[str, float]:
    """Detection quality on fresh synthetic images through the PRODUCTION
    extraction (``superpoint_extract``: on the card the conv1a1b, conv_pair
    and scores_nms kernels, then top-K), plus a descriptor discriminability
    margin (mean cosine at corresponding keypoints minus mean cosine over
    all pairs) across a homographic warp. Runs on the parameters' device.

    ``image_fn(rng) -> (img, corners)`` overrides the image source (default
    procedural shapes; pass RenderDomainSource.labeled_image to score the
    sprite-world domain)."""
    import cv2

    from ..models.superpoint import superpoint_extract
    from .synthetic_shapes import render_shapes, sample_homography, warp_points

    device = next(iter(params.values())).device
    if image_fn is None:
        image_fn = lambda r: render_shapes(r, h, w)  # noqa: E731

    def extract(img):
        image = torch.from_numpy(np.ascontiguousarray(img, np.float32))[None].to(device)
        kpts, _, valid, desc = superpoint_extract(
            params, image, max_keypoints=max_keypoints, keypoint_threshold=threshold
        )
        valid = valid[0].cpu().numpy()
        return kpts[0].cpu().numpy()[valid], desc[0].float().cpu().numpy()[valid]

    ps, rs, fs, margins = [], [], [], []
    for _ in range(n_images):
        img, corners = image_fn(rng)
        h, w = img.shape
        if len(corners) == 0:
            continue
        det0, dsc0 = extract(img)
        p, r, f1 = detection_prf(det0, corners)
        ps.append(p)
        rs.append(r)
        fs.append(f1)

        # Descriptor margin across a homographic warp.
        H = sample_homography(rng, h, w)
        det1, dsc1 = extract(cv2.warpPerspective(img, H.astype(np.float32), (w, h)))
        if len(det0) and len(det1):
            w0 = warp_points(H, det0)
            dist = np.linalg.norm(w0[:, None] - det1[None], axis=2)
            j = dist.argmin(1)
            close = dist[np.arange(len(det0)), j] < 4.0
            if close.sum() >= 3:
                cos = np.sum(dsc0 * dsc1[j], axis=1)
                margins.append(float(cos[close].mean()) - float((dsc0 @ dsc1.T).mean()))
    return {
        "precision": float(np.mean(ps)) if ps else 0.0,
        "recall": float(np.mean(rs)) if rs else 0.0,
        "f1": float(np.mean(fs)) if fs else 0.0,
        "desc_margin": float(np.mean(margins)) if margins else 0.0,
    }


def detection_prf(
    detected: np.ndarray, gt: np.ndarray, tol_px: float = 4.0
) -> tuple[float, float, float]:
    """Precision / recall / F1 of detected (N, 2) vs ground-truth (M, 2)
    corner locations with a pixel tolerance: the pretraining quality gate."""
    if len(detected) == 0 or len(gt) == 0:
        return 0.0, 0.0, 0.0
    d = np.linalg.norm(detected[:, None, :] - gt[None, :, :], axis=2)
    prec = float(np.mean(d.min(axis=1) <= tol_px))
    rec = float(np.mean(d.min(axis=0) <= tol_px))
    f1 = 2 * prec * rec / max(prec + rec, 1e-9)
    return prec, rec, f1

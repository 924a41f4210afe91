"""Procedural corner-supervision data (MagicPoint-style synthetic shapes).

Renders random geometric primitives — segments, convex polygons, stars,
checkerboards, plus corner-free ellipses as negatives — on smooth noisy
backgrounds, with the EXACT corner pixel locations as labels, then derives
the SuperPoint training targets:

- per-8x8-cell 65-way detector classes (64 in-cell positions + dustbin);
- a homographically warped second view with the cell-to-cell correspondence
  matrix for the descriptor hinge loss.

Everything is numpy + cv2 on the host; batches feed the train step in
``train.superpoint_train``. A copy of ``superslam_tpu/train/synthetic_shapes.py``
(the port imports nothing of the JAX package): for one seed both give the
same bytes.
"""

from __future__ import annotations

import numpy as np

CELL = 8
N_CLASSES = 65  # 64 positions + dustbin


# --------------------------------------------------------------------------
# Primitive renderers. Each draws into `img` (uint8 HxW) and returns the
# float (x, y) corner locations it created.


def _rand_gray(rng: np.random.Generator, lo: int = 0, hi: int = 255) -> int:
    return int(rng.integers(lo, hi + 1))


def _background(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    """Smooth blotchy background: upscaled low-res noise, mid-gray range so
    both darker and brighter shapes have contrast."""
    import cv2

    coarse = rng.uniform(70, 190, (max(2, h // 32), max(2, w // 32)))
    img = cv2.resize(coarse, (w, h), interpolation=cv2.INTER_CUBIC)
    img += rng.normal(0, 4.0, (h, w))
    return np.clip(img, 0, 255).astype(np.uint8)


def _draw_segments(img, rng) -> np.ndarray:
    import cv2

    h, w = img.shape
    pts = []
    for _ in range(int(rng.integers(1, 4))):
        p0 = rng.uniform([4, 4], [w - 4, h - 4])
        p1 = rng.uniform([4, 4], [w - 4, h - 4])
        if np.linalg.norm(p1 - p0) < 12:
            continue
        cv2.line(
            img,
            tuple(np.round(p0).astype(int)),
            tuple(np.round(p1).astype(int)),
            _rand_gray(rng),
            int(rng.integers(1, 3)),
            cv2.LINE_AA,
        )
        pts += [p0, p1]
    return np.array(pts, np.float32).reshape(-1, 2)


def _convex_polygon(rng, h, w, n_min=3, n_max=6):
    cx, cy = rng.uniform(0.2 * w, 0.8 * w), rng.uniform(0.2 * h, 0.8 * h)
    rad = rng.uniform(0.08, 0.28) * min(h, w)
    n = int(rng.integers(n_min, n_max + 1))
    angles = np.sort(rng.uniform(0, 2 * np.pi, n))
    # Enforce angular separation so vertices are distinct corners.
    keep = np.concatenate([[True], np.diff(angles) > 0.5])
    angles = angles[keep]
    if angles.size < 3:
        return None
    r = rad * rng.uniform(0.7, 1.0, angles.size)
    xy = np.stack([cx + r * np.cos(angles), cy + r * np.sin(angles)], 1)
    return xy.astype(np.float32)


def _draw_polygon(img, rng) -> np.ndarray:
    import cv2

    h, w = img.shape
    xy = _convex_polygon(rng, h, w)
    if xy is None:
        return np.zeros((0, 2), np.float32)
    cv2.fillPoly(img, [np.round(xy).astype(np.int32)], _rand_gray(rng))
    inb = (
        (xy[:, 0] > 3) & (xy[:, 0] < w - 3) & (xy[:, 1] > 3) & (xy[:, 1] < h - 3)
    )
    return xy[inb]


def _draw_star(img, rng) -> np.ndarray:
    import cv2

    h, w = img.shape
    cx, cy = rng.uniform(0.25 * w, 0.75 * w), rng.uniform(0.25 * h, 0.75 * h)
    n = int(rng.integers(3, 6))
    col = _rand_gray(rng)
    pts = [np.array([cx, cy], np.float32)]
    angles = np.sort(rng.uniform(0, 2 * np.pi, n))
    if np.any(np.diff(angles) < 0.4):
        return np.zeros((0, 2), np.float32)
    for a in angles:
        r = rng.uniform(0.08, 0.22) * min(h, w)
        p = np.array([cx + r * np.cos(a), cy + r * np.sin(a)], np.float32)
        cv2.line(
            img,
            (int(round(cx)), int(round(cy))),
            tuple(np.round(p).astype(int)),
            col,
            int(rng.integers(1, 3)),
            cv2.LINE_AA,
        )
        if 3 < p[0] < w - 3 and 3 < p[1] < h - 3:
            pts.append(p)
    return np.stack(pts)


def _draw_checkerboard(img, rng) -> np.ndarray:
    import cv2

    h, w = img.shape
    rows, cols = int(rng.integers(2, 4)), int(rng.integers(2, 4))
    sq = rng.uniform(12, 24)
    ox, oy = rng.uniform(6, w - cols * sq - 6), rng.uniform(6, h - rows * sq - 6)
    if ox <= 4 or oy <= 4:
        return np.zeros((0, 2), np.float32)
    c0, c1 = _rand_gray(rng, 0, 100), _rand_gray(rng, 155, 255)
    for r in range(rows):
        for c in range(cols):
            x0, y0 = ox + c * sq, oy + r * sq
            cv2.rectangle(
                img,
                (int(round(x0)), int(round(y0))),
                (int(round(x0 + sq)), int(round(y0 + sq))),
                c0 if (r + c) % 2 == 0 else c1,
                -1,
            )
    # Corners: every lattice point of the grid.
    xs = ox + sq * np.arange(cols + 1)
    ys = oy + sq * np.arange(rows + 1)
    gx, gy = np.meshgrid(xs, ys)
    pts = np.stack([gx.ravel(), gy.ravel()], 1).astype(np.float32)
    inb = (
        (pts[:, 0] > 3)
        & (pts[:, 0] < w - 3)
        & (pts[:, 1] > 3)
        & (pts[:, 1] < h - 3)
    )
    return pts[inb]


def _draw_ellipse(img, rng) -> np.ndarray:
    import cv2

    h, w = img.shape
    center = (int(rng.uniform(0.2 * w, 0.8 * w)), int(rng.uniform(0.2 * h, 0.8 * h)))
    axes = (int(rng.uniform(6, 0.2 * w)), int(rng.uniform(6, 0.2 * h)))
    cv2.ellipse(
        img, center, axes, float(rng.uniform(0, 360)), 0, 360, _rand_gray(rng), -1
    )
    return np.zeros((0, 2), np.float32)  # smooth boundary: no corners


_PRIMITIVES = (
    _draw_segments,
    _draw_polygon,
    _draw_star,
    _draw_checkerboard,
    _draw_ellipse,
)


def render_shapes(
    rng: np.random.Generator, h: int, w: int, n_shapes: tuple[int, int] = (4, 9)
) -> tuple[np.ndarray, np.ndarray]:
    """One synthetic training image.

    Returns (image f32 (h, w) in [0, 1], corners (N, 2) f32 (x, y))."""
    import cv2

    img = _background(rng, h, w)
    pts = [np.zeros((0, 2), np.float32)]
    for _ in range(int(rng.integers(*n_shapes))):
        fn = _PRIMITIVES[int(rng.integers(len(_PRIMITIVES)))]
        pts.append(fn(img, rng))
    if rng.uniform() < 0.7:
        img = cv2.GaussianBlur(img, (3, 3), 0)
    img = img.astype(np.float32) + rng.normal(0, 2.0, (h, w)).astype(np.float32)
    corners = np.concatenate(pts, 0)
    return np.clip(img / 255.0, 0.0, 1.0).astype(np.float32), corners


def corners_to_labels(corners: np.ndarray, h: int, w: int) -> np.ndarray:
    """(N, 2) float corners -> (h/8, w/8) int32 65-way cell classes.

    Class = (y%8)*8 + x%8 of the (rounded) corner pixel; cells with no
    corner get the dustbin class 64. When several corners land in one cell
    the last write wins (matches the original training recipe's arbitrary
    pick)."""
    gh, gw = h // CELL, w // CELL
    labels = np.full((gh, gw), N_CLASSES - 1, np.int32)
    if corners.size == 0:
        return labels
    xy = np.round(corners).astype(np.int64)
    ok = (xy[:, 0] >= 0) & (xy[:, 0] < w) & (xy[:, 1] >= 0) & (xy[:, 1] < h)
    xy = xy[ok]
    cy, cx = xy[:, 1] // CELL, xy[:, 0] // CELL
    labels[cy, cx] = (xy[:, 1] % CELL) * CELL + (xy[:, 0] % CELL)
    return labels


# --------------------------------------------------------------------------
# Homographic warping (the descriptor self-supervision signal).


def sample_homography(
    rng: np.random.Generator,
    h: int,
    w: int,
    perspective: float = 0.1,
    scale: tuple[float, float] = (0.8, 1.2),
    rotation: float = 0.25,
    translation: float = 0.08,
) -> np.ndarray:
    """Random in-plane homography (pixel coords), biased toward mild views
    so a useful fraction of the image stays covisible."""
    import cv2

    c = np.array([w / 2.0, h / 2.0])
    src = np.array([[0, 0], [w, 0], [w, h], [0, h]], np.float32)
    ang = rng.uniform(-rotation, rotation)
    s = rng.uniform(*scale)
    R = s * np.array(
        [[np.cos(ang), -np.sin(ang)], [np.sin(ang), np.cos(ang)]], np.float32
    )
    t = rng.uniform(-translation, translation, 2) * [w, h]
    dst = (src - c) @ R.T + c + t
    dst += rng.uniform(-perspective, perspective, (4, 2)).astype(np.float32) * [w, h]
    H, _ = cv2.findHomography(src, dst.astype(np.float32))
    return H.astype(np.float64)


def warp_points(H: np.ndarray, pts: np.ndarray) -> np.ndarray:
    if pts.size == 0:
        return pts
    p = np.concatenate([pts, np.ones((len(pts), 1), pts.dtype)], 1) @ H.T
    return (p[:, :2] / p[:, 2:3]).astype(np.float32)


def _cell_correspondence(
    H: np.ndarray, h: int, w: int, radius: float = CELL
) -> np.ndarray:
    """(gh*gw, gh*gw) bool: S[i, j] = cell i of view0 corresponds to cell j
    of view1 (warped center within `radius` px — the SuperPoint paper's
    rule)."""
    gh, gw = h // CELL, w // CELL
    ys, xs = np.meshgrid(np.arange(gh), np.arange(gw), indexing="ij")
    centers = np.stack(
        [xs.ravel() * CELL + CELL / 2 - 0.5, ys.ravel() * CELL + CELL / 2 - 0.5], 1
    ).astype(np.float32)
    warped = warp_points(H, centers)  # view0 centers in view1 pixels
    d = warped[:, None, :] - centers[None, :, :]
    return (np.sum(d * d, axis=2) <= radius * radius).astype(np.float32)


def pair_from_image(
    rng: np.random.Generator, img0: np.ndarray, corners: np.ndarray
) -> dict[str, np.ndarray]:
    """Homographic training pair from ANY labeled image.

    The warp machinery is source-agnostic: procedural shapes
    (``training_pair``) and rendered sprite-world views
    (train/render_domain.py) both feed through here, so the descriptor
    correspondence targets and label warping are identical across domains."""
    import cv2

    h, w = img0.shape
    H = sample_homography(rng, h, w)
    img1 = cv2.warpPerspective(img0, H.astype(np.float32), (w, h))
    cov = cv2.warpPerspective(np.ones((h, w), np.float32), H.astype(np.float32), (w, h))
    gh, gw = h // CELL, w // CELL
    # A cell of view1 is valid when fully covered by warped real content.
    valid1 = (
        cov.reshape(gh, CELL, gw, CELL).min(axis=(1, 3)) > 0.99
    ).astype(np.float32)
    corners1 = warp_points(H, corners)
    labels1 = corners_to_labels(corners1, h, w)
    return {
        "img0": img0,
        "img1": img1,
        "labels0": corners_to_labels(corners, h, w),
        "labels1": labels1,
        "valid0": np.ones((gh, gw), np.float32),
        "valid1": valid1,
        "corr": _cell_correspondence(H, h, w),
        "H": H.astype(np.float32),
    }


def training_pair(
    rng: np.random.Generator, h: int, w: int
) -> dict[str, np.ndarray]:
    """One (view0, warped view1) procedural-shapes sample with every
    training target.

    Keys: img0/img1 (h, w) f32; labels0/labels1 (gh, gw) int32;
    valid0/valid1 (gh, gw) f32 cell-validity (1 inside real content);
    corr (gh*gw, gh*gw) f32 descriptor correspondence; H (3, 3) f32."""
    img0, corners = render_shapes(rng, h, w)
    return pair_from_image(rng, img0, corners)


def training_batch(
    rng: np.random.Generator, batch: int, h: int, w: int
) -> dict[str, np.ndarray]:
    samples = [training_pair(rng, h, w) for _ in range(batch)]
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


def compact_from_pair(p: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """Wire-format view of a training pair: uint8 images, int32 labels, and
    the 3x3 H — descriptor targets are reconstructed on device by
    ``superpoint_train.pair_targets_from_h``."""
    return {
        "img0": np.round(p["img0"] * 255).astype(np.uint8),
        "img1": np.round(p["img1"] * 255).astype(np.uint8),
        "labels0": p["labels0"],
        "labels1": p["labels1"],
        "H": p["H"],
    }


def compact_pair(rng: np.random.Generator, h: int, w: int) -> dict[str, np.ndarray]:
    """Wire-format procedural-shapes sample (see ``compact_from_pair``)."""
    return compact_from_pair(training_pair(rng, h, w))

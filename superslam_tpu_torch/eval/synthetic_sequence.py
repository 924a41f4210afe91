"""Rendered stereo sequences with ground-truth trajectories.

The reference validates accuracy on downloaded datasets (KITTI/EuRoC/TUM,
``scripts/benchmarks/_eval_common.py``); this zero-egress
environment cannot fetch any of them, so this module renders one: a world of
textured planar sprites (each a unique high-contrast corner pattern the
synthetic-shapes-trained SuperPoint fires on), projected through a real
pinhole stereo rig along a scripted trajectory, written to disk in KITTI
odometry layout (image_0/ image_1/ times.txt + ground-truth poses). The
existing KITTI runner and evaluators then consume it unchanged —
pixels -> CNN -> matcher -> estimator -> ATE, the full accuracy axis with
no downloaded artifact anywhere in the loop.

Rendering is exact perspective: each sprite is a textured quad; its
texture->image homography is composed analytically per frame and rasterized
with cv2.warpPerspective, far-to-near for occlusion.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..geometry import Pose3, StereoCalib


def _sprite_texture(
    rng: np.random.Generator, t: int = 32
) -> tuple[np.ndarray, np.ndarray]:
    """One sprite: a distinctive high-contrast corner pattern on a backing
    square — a random bright/dark quadrilateral plus a 2x2 checker block,
    over a per-sprite mid-gray. Corners galore for the detector, a unique
    layout for the descriptor.

    Returns (texture (t, t) f32, corners (N, 2) f32 in texture (x, y)
    pixels) — the exact corner ground truth used to supervise SuperPoint on
    the render domain (train/render_domain.py)."""
    import cv2

    back = float(rng.uniform(0.25, 0.75))
    img = np.full((t, t), back, np.float32)
    dark = rng.uniform() < 0.5
    fill = rng.uniform(0.0, 0.15) if dark else rng.uniform(0.85, 1.0)
    c = t / 2.0
    n = int(rng.integers(3, 6))
    ang = np.sort(rng.uniform(0, 2 * np.pi, n))
    if np.any(np.diff(ang) < 0.35):
        ang = np.linspace(0, 2 * np.pi, n, endpoint=False) + rng.uniform(0, 2 * np.pi)
    r = rng.uniform(0.55, 0.92, n) * (t / 2 - 2)
    poly = np.stack([c + r * np.cos(ang), c + r * np.sin(ang)], 1)
    poly_px = np.round(poly).astype(np.int32)
    cv2.fillPoly(img, [poly_px], fill)
    corners = [poly_px.astype(np.float32)]
    # A quadrant checker block inside the polygon for extra identity bits.
    bs = t // 5
    ox, oy = int(rng.integers(t // 4, t // 2)), int(rng.integers(t // 4, t // 2))
    for i in range(2):
        for j in range(2):
            v = fill if (i + j) % 2 else back
            img[oy + i * bs : oy + (i + 1) * bs, ox + j * bs : ox + (j + 1) * bs] = v
    # The 3x3 junction grid of the checker block (every point where two
    # differently-shaded cells meet), plus the texture-quad corners (sprite
    # edge against the world background).
    gx, gy = np.meshgrid(ox + bs * np.arange(3), oy + bs * np.arange(3))
    corners.append(np.stack([gx.ravel(), gy.ravel()], 1).astype(np.float32))
    corners.append(
        np.array(
            [[0, 0], [t - 1, 0], [0, t - 1], [t - 1, t - 1]], np.float32
        )
    )
    return img, np.concatenate(corners, 0)


@dataclass
class SpriteWorld:
    """Planar textured sprites: center (N, 3), two in-plane unit axes
    (N, 3) each, half-extent (N,) meters, and per-sprite textures."""

    centers: np.ndarray
    ax_u: np.ndarray
    ax_v: np.ndarray
    half: np.ndarray
    textures: list = field(default_factory=list)
    tex_corners: list = field(default_factory=list)  # (Ni, 2) texture px
    background: float = 0.45

    @property
    def n(self) -> int:
        return len(self.centers)


def make_room_world(
    rng: np.random.Generator,
    half_x: float = 8.0,
    half_z: float = 8.0,
    height: float = 2.4,
    n_sprites: int = 260,
    sprite_half: tuple[float, float] = (0.28, 0.55),
) -> SpriteWorld:
    """Sprites on the four walls of a rectangular room (y up is -y in camera
    convention; we keep y as the vertical axis with the camera at y=0).
    A circuit trajectory inside the room sees every wall and revisits the
    start — the loop-closure scenario."""
    walls = [
        # (point on wall, outward normal): sprites face inward (-normal).
        (np.array([0.0, 0.0, half_z]), np.array([0.0, 0.0, 1.0])),
        (np.array([0.0, 0.0, -half_z]), np.array([0.0, 0.0, -1.0])),
        (np.array([half_x, 0.0, 0.0]), np.array([1.0, 0.0, 0.0])),
        (np.array([-half_x, 0.0, 0.0]), np.array([-1.0, 0.0, 0.0])),
    ]
    centers, ax_u, ax_v, half, tex, tex_c = [], [], [], [], [], []
    for i in range(n_sprites):
        p0, nrm = walls[int(rng.integers(4))]
        # In-wall coordinates.
        u = np.cross(np.array([0.0, 1.0, 0.0]), nrm)
        u /= np.linalg.norm(u)
        v = np.array([0.0, 1.0, 0.0])
        extent = half_x if abs(nrm[2]) > 0.5 else half_z
        c = (
            p0
            + u * rng.uniform(-extent * 0.95, extent * 0.95)
            + v * rng.uniform(-height, height)
        )
        centers.append(c)
        # Face inward: in-plane axes span the wall; slight random roll.
        roll = rng.uniform(-0.4, 0.4)
        cu = np.cos(roll) * u + np.sin(roll) * v
        cv_ = -np.sin(roll) * u + np.cos(roll) * v
        ax_u.append(cu)
        ax_v.append(cv_)
        half.append(rng.uniform(*sprite_half))
        t_img, t_cor = _sprite_texture(rng)
        tex.append(t_img)
        tex_c.append(t_cor)
    return SpriteWorld(
        np.asarray(centers),
        np.asarray(ax_u),
        np.asarray(ax_v),
        np.asarray(half),
        tex,
        tex_c,
    )


def circuit_trajectory(
    n_frames: int,
    radius_x: float = 4.5,
    radius_z: float = 4.5,
    laps: float = 1.06,
    step_noise: float = 0.0,
    rng: np.random.Generator | None = None,
) -> list[Pose3]:
    """Camera circuit inside the room: an ellipse in the x-z plane, camera
    looking along the tangent (forward = +z in camera frame). `laps` > 1
    revisits the start — the loop-closure trigger."""
    poses = []
    for i in range(n_frames):
        th = 2 * np.pi * laps * i / n_frames
        c = np.array([radius_x * np.sin(th), 0.0, -radius_z * np.cos(th)])
        if rng is not None and step_noise > 0:
            c = c + rng.normal(0, step_noise, 3) * [1.0, 0.3, 1.0]
        # Tangent direction (d c / d th).
        fwd = np.array([radius_x * np.cos(th), 0.0, radius_z * np.sin(th)])
        fwd /= np.linalg.norm(fwd)
        up = np.array([0.0, -1.0, 0.0])  # camera +y points down (vision conv.)
        right = np.cross(up, fwd)
        right /= np.linalg.norm(right)
        up2 = np.cross(fwd, right)
        R = np.stack([right, up2, fwd], 1)  # columns: cam axes in world
        poses.append(Pose3(R, c))
    return poses


def straight_trajectory(n_frames: int, step: float = 0.12) -> list[Pose3]:
    """Forward motion down the room's z axis (pure-VO scenario)."""
    return [Pose3(t=np.array([0.0, 0.0, -6.0 + step * i])) for i in range(n_frames)]


def random_interior_pose(
    rng: np.random.Generator,
    radius: float = 4.5,
    y_jitter: float = 0.3,
    yaw_jitter: float = 0.5,
    pitch_jitter: float = 0.15,
) -> Pose3:
    """A random viewpoint on the circuit annulus, looking roughly along the
    tangent with yaw/pitch jitter — the viewpoint distribution the training
    harvesters (train/render_domain.py, scripts/train_lightglue_synth.py)
    sample so the learned models see the trajectory's own image statistics."""
    th = rng.uniform(0, 2 * np.pi)
    c = np.array(
        [radius * np.sin(th), rng.uniform(-y_jitter, y_jitter), -radius * np.cos(th)]
    )
    fwd = np.array([np.cos(th), 0.0, np.sin(th)])
    up = np.array([0.0, -1.0, 0.0])
    right = np.cross(up, fwd)
    R = np.stack([right / np.linalg.norm(right), np.cross(fwd, right), fwd], 1)
    jit = np.array(
        [
            rng.uniform(-pitch_jitter, pitch_jitter),
            rng.uniform(-yaw_jitter, yaw_jitter),
            rng.uniform(-0.1, 0.1),
        ]
    )
    return Pose3(R, c) * Pose3.expmap(np.concatenate([jit, np.zeros(3)]))


def render_view(
    world: SpriteWorld,
    Twc: Pose3,
    calib: StereoCalib,
    h: int,
    w: int,
    rng: np.random.Generator | None = None,
    return_ids: bool = False,
    return_corners: bool = False,
    return_depth: bool = False,
):
    """Render one camera view (grayscale f32 in [0, 1]).

    With ``return_ids`` also returns an (h, w) int32 sprite-id map (-1 =
    background) — exact ground-truth data association for correspondence
    harvesting (scripts/train_lightglue_synth.py). With ``return_corners``
    also returns the visible projected sprite corners ((N, 2) f32 (x, y)
    image pixels) — exact detector supervision on the render domain
    (train/render_domain.py). With ``return_depth`` also returns an (h, w)
    f32 metric Z-depth map (0 = background/no data — the TUM sensor
    convention) from exact ray/sprite-plane intersection, occlusion
    resolved by the same painter order as the intensity image — the RGB-D
    ground-truth leg (write_tum_sequence). Each sprite's warp is
    rasterized only over its projected bounding box, not the full
    canvas."""
    import cv2

    K = np.array(
        [[calib.fx, 0, calib.cx], [0, calib.fy, calib.cy], [0, 0, 1]], np.float64
    )
    R_cw = Twc.R.T
    t_cw = -R_cw @ Twc.t

    img = np.full((h, w), world.background, np.float32)
    # Mild background vignette so the frame is not perfectly flat.
    yy, xx = np.mgrid[0:h, 0:w]
    img += 0.03 * np.cos(2 * np.pi * xx / w) * np.cos(2 * np.pi * yy / h)

    want_ids = return_ids or return_corners
    ids = np.full((h, w), -1, np.int32) if want_ids else None
    depth = np.zeros((h, w), np.float32) if return_depth else None
    corner_uv: list[np.ndarray] = []
    corner_sprite: list[np.ndarray] = []
    # Depth-sort far to near (painter's algorithm).
    z = (world.centers @ R_cw.T + t_cw)[:, 2]
    order = np.argsort(-z)
    for i in order:
        zc = z[i]
        if zc < 0.4:
            continue
        t_px = world.textures[i].shape[0]
        scale = 2.0 * world.half[i] / t_px  # meters per texel
        A = np.stack([world.ax_u[i] * scale, world.ax_v[i] * scale], 1)  # (3,2)
        M = R_cw @ A  # (3, 2)
        m3 = R_cw @ world.centers[i] + t_cw
        # Texture pixel (s, t) with center at (t_px-1)/2 maps to
        # K @ (M @ [s - c, t - c] + m3).
        c0 = (t_px - 1) / 2.0
        Hm = K @ np.column_stack([M[:, 0], M[:, 1], m3 - M @ np.array([c0, c0])])
        # Cull: project the 4 texture corners; skip if none lands near frame.
        quad = np.array(
            [[0, 0, 1], [t_px - 1, 0, 1], [0, t_px - 1, 1], [t_px - 1, t_px - 1, 1]],
            np.float64,
        )
        pc = quad @ Hm.T
        if np.any(pc[:, 2] <= 1e-6):
            continue
        uv = pc[:, :2] / pc[:, 2:3]
        # The homographic image of the texture square is the quad spanned by
        # these four projected corners; rasterize only its bounding box.
        x0 = max(0, int(np.floor(uv[:, 0].min())) - 1)
        x1 = min(w, int(np.ceil(uv[:, 0].max())) + 2)
        y0 = max(0, int(np.floor(uv[:, 1].min())) - 1)
        y1 = min(h, int(np.ceil(uv[:, 1].max())) + 2)
        if x1 <= x0 or y1 <= y0:
            continue
        shift = np.array([[1, 0, -x0], [0, 1, -y0], [0, 0, 1]], np.float64)
        patch = cv2.warpPerspective(
            world.textures[i],
            shift @ Hm,
            (x1 - x0, y1 - y0),
            flags=cv2.INTER_LINEAR,
            borderMode=cv2.BORDER_CONSTANT,
            borderValue=-1.0,
        )
        mask = patch >= 0.0
        sub = img[y0:y1, x0:x1]
        sub[mask] = patch[mask]
        if ids is not None:
            ids[y0:y1, x0:x1][mask] = i
        if depth is not None:
            # Exact ray/plane intersection: the sprite plane passes through
            # m3 (center, camera frame) spanned by M's columns; a pixel ray
            # d = ((x-cx)/fx, (y-cy)/fy, 1) hits it at Z = n.m3 / n.d.
            n = np.cross(M[:, 0], M[:, 1])
            gy, gx = np.mgrid[y0:y1, x0:x1]
            dx = (gx - calib.cx) / calib.fx
            dy = (gy - calib.cy) / calib.fy
            nd = n[0] * dx + n[1] * dy + n[2]
            zpx = (n @ m3) / np.where(np.abs(nd) > 1e-12, nd, 1e-12)
            dsub = depth[y0:y1, x0:x1]
            ok_z = mask & (zpx > 0.0)
            dsub[ok_z] = zpx[ok_z].astype(np.float32)
        if return_corners:
            cs = world.tex_corners[i]
            p = np.concatenate([cs, np.ones((len(cs), 1), np.float64)], 1) @ Hm.T
            ok = p[:, 2] > 1e-6
            corner_uv.append((p[ok, :2] / p[ok, 2:3]).astype(np.float32))
            corner_sprite.append(np.full(int(ok.sum()), i, np.int32))

    corners_out = None
    if return_corners:
        if corner_uv:
            alluv = np.concatenate(corner_uv, 0)
            allsp = np.concatenate(corner_sprite, 0)
            xi = np.round(alluv[:, 0]).astype(int)
            yi = np.round(alluv[:, 1]).astype(int)
            inb = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
            # Visible = the sprite still owns a pixel in the 3x3 around the
            # projection (boundary corners may round onto the background).
            vis = np.zeros(len(alluv), bool)
            for dy in (-1, 0, 1):
                for dx in (-1, 0, 1):
                    xq = np.clip(xi + dx, 0, w - 1)
                    yq = np.clip(yi + dy, 0, h - 1)
                    vis |= inb & (ids[yq, xq] == allsp)
            corners_out = alluv[vis]
        else:
            corners_out = np.zeros((0, 2), np.float32)

    if rng is not None:
        img = img + rng.normal(0, 0.004, (h, w)).astype(np.float32)
    img = np.clip(img, 0.0, 1.0)
    out = [img]
    if return_ids:
        out.append(ids)
    if return_corners:
        out.append(corners_out)
    if return_depth:
        out.append(depth)
    return out[0] if len(out) == 1 else tuple(out)


def render_stereo(
    world: SpriteWorld,
    Twc: Pose3,
    calib: StereoCalib,
    h: int,
    w: int,
    rng: np.random.Generator | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    right = Twc * Pose3(t=np.array([calib.baseline, 0.0, 0.0]))
    return (
        render_view(world, Twc, calib, h, w, rng),
        render_view(world, right, calib, h, w, rng),
    )


def write_kitti_sequence(
    out_dir: str,
    world: SpriteWorld,
    poses: list[Pose3],
    calib: StereoCalib,
    h: int,
    w: int,
    fps: float = 10.0,
    seed: int = 0,
    progress: bool = False,
) -> None:
    """Write KITTI odometry layout: image_0/, image_1/, times.txt, plus
    poses_gt.txt (KITTI 3x4 row-major Twc — the evaluators' GT format)."""
    import os

    import cv2

    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(out_dir, "image_0"), exist_ok=True)
    os.makedirs(os.path.join(out_dir, "image_1"), exist_ok=True)
    times, gt_rows = [], []
    for i, p in enumerate(poses):
        left, right = render_stereo(world, p, calib, h, w, rng)
        cv2.imwrite(
            os.path.join(out_dir, "image_0", f"{i:06d}.png"),
            np.round(left * 255).astype(np.uint8),
        )
        cv2.imwrite(
            os.path.join(out_dir, "image_1", f"{i:06d}.png"),
            np.round(right * 255).astype(np.uint8),
        )
        times.append(f"{i / fps:.6e}")
        m = np.hstack([p.R, p.t.reshape(3, 1)])
        gt_rows.append(" ".join(f"{v:.9e}" for v in m.ravel()))
        if progress and (i + 1) % 25 == 0:
            print(f"  rendered {i + 1}/{len(poses)}", flush=True)
    with open(os.path.join(out_dir, "times.txt"), "w") as f:
        f.write("\n".join(times) + "\n")
    with open(os.path.join(out_dir, "poses_gt.txt"), "w") as f:
        f.write("\n".join(gt_rows) + "\n")


def write_tum_sequence(
    out_dir: str,
    world: SpriteWorld,
    poses: list[Pose3],
    calib: StereoCalib,
    h: int,
    w: int,
    fps: float = 30.0,
    seed: int = 0,
    depth_factor: float = 5000.0,
    progress: bool = False,
) -> None:
    """Write TUM RGB-D layout: rgb/, depth/ (uint16 = Z * depth_factor, the
    fr-sequence 5000 convention), rgb.txt, depth.txt, groundtruth.txt
    (``t tx ty tz qx qy qz qw``) — everything examples/tum_rgbd.py's
    associate() and scripts/evaluate_tum.py consume. The depth image is the
    exact per-pixel ray/plane Z (render_view return_depth), so the RGB-D
    accuracy loop closes offline with zero sensor noise beyond the
    renderer's own quantization."""
    import os

    import cv2

    from ..io.trajectory import rotation_to_quaternion

    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(out_dir, "rgb"), exist_ok=True)
    os.makedirs(os.path.join(out_dir, "depth"), exist_ok=True)
    rgb_rows, depth_rows, gt_rows = [], [], []
    for i, p in enumerate(poses):
        img, depth = render_view(world, p, calib, h, w, rng, return_depth=True)
        t = i / fps
        rgb_name = f"rgb/{t:.6f}.png"
        depth_name = f"depth/{t:.6f}.png"
        cv2.imwrite(
            os.path.join(out_dir, rgb_name),
            np.round(img * 255).astype(np.uint8),
        )
        d16 = np.clip(depth * depth_factor, 0, 65535).astype(np.uint16)
        cv2.imwrite(os.path.join(out_dir, depth_name), d16)
        rgb_rows.append(f"{t:.6f} {rgb_name}")
        depth_rows.append(f"{t:.6f} {depth_name}")
        q = rotation_to_quaternion(p.R)
        gt_rows.append(
            f"{t:.6f} " + " ".join(f"{v:.9f}" for v in p.t) + " "
            + " ".join(f"{v:.9f}" for v in q)
        )
        if progress and (i + 1) % 25 == 0:
            print(f"  rendered {i + 1}/{len(poses)}", flush=True)
    for name, rows in (
        ("rgb.txt", rgb_rows),
        ("depth.txt", depth_rows),
        ("groundtruth.txt", gt_rows),
    ):
        with open(os.path.join(out_dir, name), "w") as f:
            f.write("# synthetic sprite-world sequence\n")
            f.write("\n".join(rows) + "\n")

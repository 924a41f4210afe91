"""The benchmark's frames: a rendered room of textured sprites.

A copy of the port's renderer (``superslam_tpu_torch/eval/synthetic_sequence.py``:
``_sprite_texture``, ``make_room_world``, ``circuit_trajectory`` and the
intensity half of ``render_view``, as ``bench_torch.py::synth_sequence``
drives them), kept here so that a change to the program cannot move the
yardstick. A configuration's ``assumed.world`` names the room, the circuit
and the camera; ``frame_set`` renders the arc once per checkout into
``slambench/.cache/frames`` (keyed by a hash of this file and of every
parameter) and returns it as uint8.
"""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np

CACHE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), ".cache", "frames")


def _sprite_texture(rng: np.random.Generator, t: int = 32) -> np.ndarray:
    """A high-contrast corner pattern: a random quadrilateral and a 2x2
    checker block over a per-sprite mid-gray."""
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
    cv2.fillPoly(img, [np.round(poly).astype(np.int32)], fill)
    bs = t // 5
    ox, oy = int(rng.integers(t // 4, t // 2)), int(rng.integers(t // 4, t // 2))
    for i in range(2):
        for j in range(2):
            v = fill if (i + j) % 2 else back
            img[oy + i * bs : oy + (i + 1) * bs, ox + j * bs : ox + (j + 1) * bs] = v
    return img


def make_room_world(rng, half_x, half_z, height, n_sprites, sprite_half):
    """Sprites on the four walls of a rectangular room, facing inward.
    Returns (centers (N, 3), ax_u (N, 3), ax_v (N, 3), half (N,), textures)."""
    walls = [
        (np.array([0.0, 0.0, half_z]), np.array([0.0, 0.0, 1.0])),
        (np.array([0.0, 0.0, -half_z]), np.array([0.0, 0.0, -1.0])),
        (np.array([half_x, 0.0, 0.0]), np.array([1.0, 0.0, 0.0])),
        (np.array([-half_x, 0.0, 0.0]), np.array([-1.0, 0.0, 0.0])),
    ]
    centers, ax_u, ax_v, half, tex = [], [], [], [], []
    for _ in range(n_sprites):
        p0, nrm = walls[int(rng.integers(4))]
        u = np.cross(np.array([0.0, 1.0, 0.0]), nrm)
        u /= np.linalg.norm(u)
        v = np.array([0.0, 1.0, 0.0])
        extent = half_x if abs(nrm[2]) > 0.5 else half_z
        centers.append(
            p0 + u * rng.uniform(-extent * 0.95, extent * 0.95) + v * rng.uniform(-height, height)
        )
        roll = rng.uniform(-0.4, 0.4)
        ax_u.append(np.cos(roll) * u + np.sin(roll) * v)
        ax_v.append(-np.sin(roll) * u + np.cos(roll) * v)
        half.append(rng.uniform(*sprite_half))
        tex.append(_sprite_texture(rng))
    return np.asarray(centers), np.asarray(ax_u), np.asarray(ax_v), np.asarray(half), tex


def circuit_pose(i: int, n: int, radius_x: float, radius_z: float):
    """Frame i of an n-frame elliptic lap: (R camera-to-world, camera centre),
    looking along the tangent."""
    th = 2 * np.pi * i / n
    c = np.array([radius_x * np.sin(th), 0.0, -radius_z * np.cos(th)])
    fwd = np.array([radius_x * np.cos(th), 0.0, radius_z * np.sin(th)])
    fwd /= np.linalg.norm(fwd)
    up = np.array([0.0, -1.0, 0.0])
    right = np.cross(up, fwd)
    right /= np.linalg.norm(right)
    return np.stack([right, np.cross(fwd, right), fwd], 1), c


def render_view(world, R, c, cam: dict, h: int, w: int) -> np.ndarray:
    """One grayscale view in [0, 1] of the camera (R, c), painter's order."""
    import cv2

    centers, ax_u, ax_v, half, textures = world
    K = np.array([[cam["fx"], 0, cam["cx"]], [0, cam["fy"], cam["cy"]], [0, 0, 1]], np.float64)
    R_cw = R.T
    t_cw = -R_cw @ c
    img = np.full((h, w), 0.45, np.float32)
    yy, xx = np.mgrid[0:h, 0:w]
    img += 0.03 * np.cos(2 * np.pi * xx / w) * np.cos(2 * np.pi * yy / h)
    z = (centers @ R_cw.T + t_cw)[:, 2]
    for i in np.argsort(-z):
        if z[i] < 0.4:
            continue
        t_px = textures[i].shape[0]
        scale = 2.0 * half[i] / t_px
        M = R_cw @ np.stack([ax_u[i] * scale, ax_v[i] * scale], 1)
        m3 = R_cw @ centers[i] + t_cw
        c0 = (t_px - 1) / 2.0
        Hm = K @ np.column_stack([M[:, 0], M[:, 1], m3 - M @ np.array([c0, c0])])
        quad = np.array(
            [[0, 0, 1], [t_px - 1, 0, 1], [0, t_px - 1, 1], [t_px - 1, t_px - 1, 1]], np.float64
        )
        pc = quad @ Hm.T
        if np.any(pc[:, 2] <= 1e-6):
            continue
        uv = pc[:, :2] / pc[:, 2:3]
        x0 = max(0, int(np.floor(uv[:, 0].min())) - 1)
        x1 = min(w, int(np.ceil(uv[:, 0].max())) + 2)
        y0 = max(0, int(np.floor(uv[:, 1].min())) - 1)
        y1 = min(h, int(np.ceil(uv[:, 1].max())) + 2)
        if x1 <= x0 or y1 <= y0:
            continue
        shift = np.array([[1, 0, -x0], [0, 1, -y0], [0, 0, 1]], np.float64)
        patch = cv2.warpPerspective(
            textures[i], shift @ Hm, (x1 - x0, y1 - y0), flags=cv2.INTER_LINEAR,
            borderMode=cv2.BORDER_CONSTANT, borderValue=-1.0,
        )
        mask = patch >= 0.0
        img[y0:y1, x0:x1][mask] = patch[mask]
    return np.clip(img, 0.0, 1.0)


def _render(world_cfg: dict, cam: dict, views: int) -> np.ndarray:
    s = world_cfg["scale"]
    world = make_room_world(
        np.random.default_rng(world_cfg["world_seed"]),
        half_x=world_cfg["half_x"] * s, half_z=world_cfg["half_z"] * s,
        height=world_cfg["height"] * s, n_sprites=world_cfg["n_sprites"],
        sprite_half=(world_cfg["sprite_half"][0] * s, world_cfg["sprite_half"][1] * s),
    )
    h, w = cam["height"], cam["width"]
    out = np.empty((world_cfg["frames"], views, h, w), np.uint8)
    baseline = cam["bf"] / cam["fx"]
    for i in range(world_cfg["frames"]):
        R, c = circuit_pose(i, world_cfg["lap_frames"], world_cfg["radius"] * s,
                            world_cfg["radius"] * s)
        for v in range(views):
            # The right camera sits `baseline` along the left camera's x axis.
            cv = c + R @ np.array([baseline * v, 0.0, 0.0])
            out[i, v] = np.round(render_view(world, R, cv, cam, h, w) * 255).astype(np.uint8)
    return out


def cache_key(world_cfg: dict, cam: dict, views: int) -> str:
    with open(os.path.abspath(__file__), "rb") as f:
        h = hashlib.sha1(f.read())
    h.update(json.dumps([world_cfg, cam, views], sort_keys=True).encode())
    return h.hexdigest()[:16]


def frame_set(config: dict, views: int, cache_dir: str | None = None) -> tuple[np.ndarray, bool]:
    """The configuration's rendered arc, (frames, views, H, W) uint8, and
    whether it came from the cache. Rendered once per checkout; a torn file
    is rendered again."""
    world_cfg, cam = config["assumed"]["world"], config["camera"]
    cache_dir = cache_dir or CACHE_DIR
    path = os.path.join(cache_dir, f"{config['name']}-{views}-{cache_key(world_cfg, cam, views)}.npy")
    if os.path.exists(path):
        try:
            arr = np.load(path)
            if arr.shape == (world_cfg["frames"], views, cam["height"], cam["width"]):
                return arr, True
        except (OSError, ValueError):
            pass
    arr = _render(world_cfg, cam, views)
    os.makedirs(cache_dir, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        np.save(f, arr)
    os.replace(tmp, path)
    return arr, False


def cache_bytes(cache_dir: str | None = None) -> int:
    cache_dir = cache_dir or CACHE_DIR
    if not os.path.isdir(cache_dir):
        return 0
    return sum(os.path.getsize(os.path.join(cache_dir, f)) for f in os.listdir(cache_dir))


def pingpong(position: int, n: int) -> int:
    """Frame index at step `position` of a walk that runs the arc forward
    then back, so a stream's motion never jumps."""
    period = 2 * (n - 1)
    p = position % period
    return p if p < n else period - p

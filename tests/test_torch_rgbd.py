"""The port's RGB-D mode against the JAX package's, on the CPU.

- ``undistort_points`` (the device undistortion of ops/rgbd_step.py) in
  f32 within 1e-5 px of the JAX package's ``undistort_points_jnp``, in f64
  within 1e-5 px of ``io/undistort.py`` (numpy, f64), in f32 within 1e-3 px
  of it (f32 rounds a ~300 px coordinate at ~2e-5 px a step);
- the RGB-D steps on rendered 160x120 frames with depth (the committed
  superpoint_render + lightglue_synth weights, K = 128), held as
  tests/test_torch_frontend_step.py holds the stereo steps: >= 95% of the
  JAX keypoints within 1/16 px, >= 90% of the keyframe keypoints with the
  same track match; the device-tracked step on one shared front end (the
  JAX package's), poses within 1e-4, counts exact, with and without
  TUM1's distortion;
- ``decode_packed`` bit for bit on the same packed block;
- the pipelined RGB-D tracker against the synchronous loop, and device
  tracking against host solving (0.2 m a frame), with and without
  distortion, on the JAX end-to-end tests' config (random weights);
- the RGB-D facade against the JAX RGB-D facade on rendered frames.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from superslam_tpu.models.weights import load_safetensors as jax_load
from superslam_tpu.ops import rgbd_step as jrgbd
from superslam_tpu.slam import SuperSLAM as JaxSuperSLAM
from superslam_tpu_torch.eval.metrics import ate
from superslam_tpu_torch.eval.synthetic_sequence import (
    circuit_trajectory,
    make_room_world,
    render_view,
)
from superslam_tpu_torch.geometry import StereoCalib
from superslam_tpu_torch.io.undistort import undistort_points as undistort_np
from superslam_tpu_torch.models.weights import load_safetensors
from superslam_tpu_torch.ops import rgbd_step as trgbd
from superslam_tpu_torch.slam import SuperSLAM

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H, PAD_H, K, FX = 160, 120, 128, 128, 160.0
STEP_KW = dict(
    max_keypoints=K, keypoint_threshold=0.010, remove_borders=4, nms_radius=4,
    true_width=W, true_height=H, match_threshold=0.1,
)
TUM1_DIST = (0.262383, -0.953104, -0.005358, 0.002628, 1.163314)  # configs/TUM1.yaml
DEPTH_FACTOR = 5000.0

# The JAX package's end-to-end tests' config (tests/test_facade_e2e.py):
# random weights, 160x120, K 128.
E2E_CONFIG = """
Camera.fx: 80.0
Camera.fy: 80.0
Camera.cx: 80.0
Camera.cy: 60.0
Camera.bf: 8.0
Camera.width: 160
Camera.height: 120
ThDepth: 35

SuperPoint.model_dir: "/nonexistent-weights/"
superpoint:
  max_keypoints: 128
  keypoint_threshold: 0.0005
  remove_borders: 4
lightglue:
  image_width: 160
  image_height: 120
Backend.window_size: 4
Tracking.min_matches: 10
KeyFrame.covis_ratio: 0.7
KeyFrame.max_frames: 5
DepthMapFactor: 5000.0
"""

# Rendered frames through the committed checkpoints (the facade parity run).
RENDER_CONFIG = """\
Camera.fx: {fx}
Camera.fy: {fx}
Camera.cx: {cx}
Camera.cy: {cy}
Camera.bf: {bf}
Camera.width: {w}
Camera.height: {h}
ThDepth: 40
DepthMapFactor: 5000.0
SuperPoint.model_dir: "{weights}"
superpoint:
  max_keypoints: {k}
  keypoint_threshold: 0.010
  remove_borders: 4
  weights_file: superpoint_render.safetensors
lightglue:
  image_width: {w}
  image_height: {h}
  weights_file: lightglue_synth.safetensors
Backend.window_size: 8
KeyFrame.covis_ratio: 0.75
KeyFrame.max_frames: 20
"""


@pytest.fixture(autouse=True)
def few_torch_threads():
    """The suite runs in several worker processes on one host; two intra-op
    threads each keep them from oversubscribing it."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def rgbd_frames(n: int, width: int = W, height: int = H, fx: float = FX):
    """The accuracy suite's sprite room and circuit seen by a width x height
    RGB-D camera: gray uint8 round(x * 255) and depth uint16 Z * 5000
    clipped, as write_tum_sequence writes them."""
    world = make_room_world(np.random.default_rng(0), n_sprites=300)
    calib = StereoCalib(fx=fx, fy=fx, cx=width / 2, cy=height / 2, baseline=0.3)
    poses = circuit_trajectory(150)[:n]
    rng = np.random.default_rng(1)
    frames = []
    for p in poses:
        img, depth = render_view(world, p, calib, height, width, rng, return_depth=True)
        frames.append((np.round(img * 255).astype(np.uint8),
                       np.clip(depth * DEPTH_FACTOR, 0, 65535).astype(np.uint16)))
    return frames, poses, calib


def distorted_frames(frames, calib, dist):
    """Frames as a camera with radtan distortion ``dist`` sees them: pixel
    (u, v) of the distorted image samples the pinhole frame at
    io/undistort.py's undistortion of (u, v) (gray bilinear, depth nearest;
    0 outside the view)."""
    import cv2

    h, w = frames[0][0].shape
    u, v = np.meshgrid(np.arange(w, dtype=np.float64), np.arange(h, dtype=np.float64))
    src = undistort_np(np.stack([u.ravel(), v.ravel()], 1), calib, np.asarray(dist, np.float64))
    mx = src[:, 0].reshape(h, w).astype(np.float32)
    my = src[:, 1].reshape(h, w).astype(np.float32)
    return [(cv2.remap(g, mx, my, cv2.INTER_LINEAR), cv2.remap(d, mx, my, cv2.INTER_NEAREST))
            for g, d in frames]


@pytest.fixture(scope="module")
def weights():
    """The committed checkpoints in both packages: (JAX SuperPoint, JAX
    LightGlue, port SuperPoint, port LightGlue)."""
    sp = os.path.join(REPO, "weights", "superpoint_render.safetensors")
    lg = os.path.join(REPO, "weights", "lightglue_synth.safetensors")
    return jax_load(sp), jax_load(lg), load_safetensors(sp), load_safetensors(lg)


def _batch(frames):
    batch = np.zeros((len(frames), PAD_H, W), np.uint8)
    for i, (gray, _depth) in enumerate(frames):
        batch[i, :H] = gray
    return batch


def _to_torch(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.kind == "V" or a.dtype.name == "bfloat16":
        a = a.astype(np.float32)
    return torch.from_numpy(np.array(a))


# -- undistortion ------------------------------------------------------------------


def test_undistort_points_matches_jax_and_numpy():
    calib = StereoCalib(fx=517.306408, fy=516.469215, cx=318.64304, cy=255.313989,
                        baseline=40.0 / 517.306408)
    c5 = (calib.fx, calib.fy, calib.cx, calib.cy, calib.baseline)
    rng = np.random.default_rng(0)
    uv = np.stack([rng.uniform(0, 640, 500), rng.uniform(0, 480, 500)], 1)
    ref = undistort_np(uv, calib, np.asarray(TUM1_DIST))
    got32 = trgbd.undistort_points(torch.from_numpy(uv.astype(np.float32)), c5, TUM1_DIST)
    got64 = trgbd.undistort_points(torch.from_numpy(uv), c5, TUM1_DIST)
    jax32 = np.asarray(jrgbd.undistort_points_jnp(jnp.asarray(uv, jnp.float32), c5, TUM1_DIST))
    e_jax = np.abs(got32.numpy() - jax32).max()
    e_np64 = np.abs(got64.numpy() - ref).max()
    e_np32 = np.abs(got32.numpy() - ref).max()
    print(f"undistort: f32 vs JAX {e_jax:.3g} px, f64 vs numpy {e_np64:.3g} px, "
          f"f32 vs numpy {e_np32:.3g} px; largest correction {np.abs(ref - uv).max():.1f} px")
    assert got32.dtype == torch.float32 and got32.shape == (500, 2)
    assert e_jax <= 1e-5 and e_np64 <= 1e-5 and e_np32 <= 1e-3


# -- the steps ---------------------------------------------------------------------


def _nearest(a: np.ndarray, b: np.ndarray):
    d = np.abs(a[:, None, :] - b[None, :, :]).max(-1)
    return d.argmin(1), d.min(1)


def _keypoints(p: np.ndarray) -> np.ndarray:
    n = int((p[0].astype(np.int32) >= 0).sum())
    return np.stack([p[0, :n], p[1, :n]], 1).astype(np.float64) / 16.0


def _assert_rgbd_blocks_agree(jp, tp, jkf, tkf):
    """The stereo steps' statistical contract on one frame's (3, K) block:
    >= 95% of the JAX keypoints within 1/16 px in the port's, and of the
    keyframe keypoints the two keyframes share >= 90% matched to the same
    frame keypoint (within 1/16 px) or unmatched in both."""
    assert tp.shape == jp.shape == (trgbd.RGBD_PACK_ROWS, K) and tp.dtype == np.int16
    jk, tk = _keypoints(jp), _keypoints(tp)
    assert len(jk) > 60 and len(tk) > 60
    _, dist = _nearest(jk, tk)
    assert (dist <= 1.0 / 16).mean() >= 0.95, (dist <= 1.0 / 16).mean()
    k2t, kdist = _nearest(jkf, tkf)
    same, matched = [], 0
    for i in np.flatnonzero(kdist <= 1.0 / 16):
        a, b = int(jp[2, i]), int(tp[2, k2t[i]])
        matched += a >= 0
        if a < 0 or b < 0:
            same.append(a < 0 and b < 0)
        else:
            same.append(np.abs(jk[a] - tk[b]).max() <= 1.0 / 16)
    assert matched > 40 and len(same) > 60
    assert np.mean(same) >= 0.90, np.mean(same)


def test_fused_rgbd_step_matches_jax(monkeypatch, weights):
    """fused_rgbd_step on frames 0 and 1 (each package's frame 0 the
    keyframe of its frame 1), both packages on the unfused LightGlue
    route."""
    monkeypatch.setenv("SUPERSLAM_PALLAS_LG", "0")
    frames, _, _ = rgbd_frames(2)
    jsp, jlg, tsp, tlg = weights
    jkf = (jnp.zeros((K, 2)), jnp.zeros((K, 256)), jnp.zeros((K,), bool))
    tkf = (torch.zeros(K, 2), torch.zeros(K, 256), torch.zeros(K, dtype=torch.bool))
    for i, frame in enumerate(frames):
        batch = _batch([frame])
        jp, jd, jk, jv = jrgbd.fused_rgbd_step(jsp, jlg, jnp.asarray(batch), *jkf, **STEP_KW)
        tp, td, tk, tv = trgbd.fused_rgbd_step(tsp, tlg, torch.from_numpy(batch), *tkf, **STEP_KW)
        jp, tp = np.asarray(jp), tp.numpy()
        if i == 0:  # nothing to track against
            assert (jp[2] < 0).all() and (tp[2] < 0).all()
            assert (_nearest(_keypoints(jp), _keypoints(tp))[1] <= 1.0 / 16).mean() >= 0.95
        else:
            jkv = np.asarray(jkf[0])[: int(np.asarray(jkf[2]).sum())]
            tkv = tkf[0].numpy()[: int(tkf[2].sum())]
            _assert_rgbd_blocks_agree(jp, tp, jkv, tkv)
        jkf, tkf = (jk, jd, jv), (tk, td, tv)


def _jax_keyframe(weights, frame, calib):
    """Frame 0 through the JAX package's step: its keypoints, descriptors and
    valid mask, and world points from the rendered depth at the raw pixel
    (identity pose)."""
    empty = (jnp.zeros((K, 2)), jnp.zeros((K, 256)), jnp.zeros((K,), bool))
    _, kd, kk, kv = jrgbd.fused_rgbd_step(weights[0], weights[1], jnp.asarray(_batch([frame])),
                                          *empty, **STEP_KW)
    kk, kd, kv = np.array(kk), np.array(kd, np.float32), np.array(kv)
    depth = frame[1].astype(np.float64) / DEPTH_FACTOR
    u = np.clip(np.rint(kk[:, 0]).astype(int), 0, W - 1)
    v = np.clip(np.rint(kk[:, 1]).astype(int), 0, H - 1)
    z = depth[v, u]
    ok = kv & (z > 0) & (z < 12.0)
    xw = np.stack(
        [(kk[:, 0] - calib.cx) * z / calib.fx, (kk[:, 1] - calib.cy) * z / calib.fy, z], 1)
    return kk.astype(np.float32), kd, kv, np.where(ok[:, None], xw, 0).astype(np.float32), ok


def test_fused_rgbd_step_multi_fused_route_matches_jax(monkeypatch, weights):
    """S = 2 on the fused layer route in both packages (the JAX package's
    Pallas blocks in interpret mode): frames 1 and 2 in one step against
    frame 0 as the shared keyframe. The port's rows go through the fused
    blocks: 9 self + 9 cross calls of 4 rows (2 pair problems x 2 sides)."""
    from superslam_tpu_torch.models import lightglue as tlg_mod

    frames, _, calib = rgbd_frames(3)
    jsp, jlg, tsp, tlg = weights
    monkeypatch.setenv("SUPERSLAM_PALLAS_LG", "0")
    kk, kd, kv, _, _ = _jax_keyframe(weights, frames[0], calib)
    kf_valid = kk[: int(kv.sum())]
    rows = []
    for name in ("fused_self_block", "fused_cross_block"):
        real = getattr(tlg_mod, name)
        monkeypatch.setattr(
            tlg_mod, name, lambda x, *a, _real=real: (rows.append(x.shape[0]), _real(x, *a))[1])
    monkeypatch.setenv("SUPERSLAM_PALLAS_LG", "1")
    batch = _batch(frames[1:])
    jp = np.asarray(jrgbd.fused_rgbd_step_multi(
        jsp, jlg, jnp.asarray(batch), jnp.asarray(kk), jnp.asarray(kd), jnp.asarray(kv),
        **STEP_KW)[0])
    tp = trgbd.fused_rgbd_step_multi(
        tsp, tlg, torch.from_numpy(batch), torch.from_numpy(kk), torch.from_numpy(kd),
        torch.from_numpy(kv), **STEP_KW)[0].numpy()
    assert rows == [4] * 18
    assert tp.shape == jp.shape == (2 * trgbd.RGBD_PACK_ROWS, K)
    for s in range(2):
        r = slice(s * trgbd.RGBD_PACK_ROWS, (s + 1) * trgbd.RGBD_PACK_ROWS)
        _assert_rgbd_blocks_agree(jp[r], tp[r], kf_valid, kf_valid)


@pytest.mark.parametrize("dist", [None, TUM1_DIST], ids=["pinhole", "tum1_dist"])
def test_fused_rgbd_track_step_multi_matches_jax(monkeypatch, weights, dist):
    """The device-tracked step (mono track_scan, with the device
    undistortion when the calibration is distorted) on one shared front
    end: the JAX package's S = 2 step on frames 1 and 2 against frame 0,
    handed to both packages' track steps in place of their own front half
    (test_torch_frontend_step.py's shared_front_end says why). The packed
    blocks are identical, the track rows' poses within 1e-4 and their
    counts exact, and the carries within 1e-4."""
    monkeypatch.setenv("SUPERSLAM_PALLAS_LG", "0")
    frames, _, calib = rgbd_frames(3)
    jsp, jlg, tsp, tlg = weights
    kk, kd, kv, xw, dok = _jax_keyframe(weights, frames[0], calib)
    batch = _batch(frames[1:])
    front = [np.asarray(a) for a in jrgbd.fused_rgbd_step_multi(
        jsp, jlg, jnp.asarray(batch), jnp.asarray(kk), jnp.asarray(kd), jnp.asarray(kv),
        **STEP_KW)]
    jfront = tuple(jnp.asarray(a) for a in front)
    tfront = tuple(_to_torch(a) for a in front)

    def jax_front(*_a, **_k):
        return jfront

    jax_front.__wrapped__ = jax_front
    monkeypatch.setattr(jrgbd, "fused_rgbd_step_multi", jax_front)
    monkeypatch.setattr(trgbd, "fused_rgbd_step_multi", lambda *a, **k: tfront)
    carry = [np.eye(3, dtype=np.float32), np.zeros(3, np.float32)] * 2
    kw = dict(calib=(calib.fx, calib.fy, calib.cx, calib.cy, calib.baseline), min_matches=10,
              track_sigma_px=10.0, dist=dist, **STEP_KW)
    args = [kk, kd, kv, xw, dok, *carry]
    ref = jrgbd.fused_rgbd_track_step_multi.__wrapped__(
        jsp, jlg, jnp.asarray(batch), *(jnp.asarray(a) for a in args), **kw)
    got = trgbd.fused_rgbd_track_step_multi(
        tsp, tlg, torch.from_numpy(batch), *(torch.from_numpy(a) for a in args), **kw)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    out_t, out_j = got[4].numpy(), np.asarray(ref[4])
    print(f"track rows ({'distorted' if dist else 'pinhole'}): n {out_j[:, 12].tolist()}, "
          f"|dpose| {np.abs(out_t[:, :12] - out_j[:, :12]).max():.3g}")
    assert out_t.shape == out_j.shape == (2, 13)
    assert (out_j[:, 12] >= 30).all()  # every frame really tracked
    np.testing.assert_array_equal(out_t[:, 12:], out_j[:, 12:])
    np.testing.assert_allclose(out_t[:, :12], out_j[:, :12], atol=1e-4, rtol=0)
    for a, b in zip(got[5], ref[5]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4, rtol=0)


# -- the host decode ---------------------------------------------------------------


@pytest.mark.parametrize("dist", [None, TUM1_DIST], ids=["pinhole", "tum1_dist"])
def test_decode_packed_matches_jax(dist):
    """Both pipelines decode one packed block (a valid prefix of 90 of 128
    keypoints, sub-pixel fixed point, 40 track matches) with one uint16
    depth image into bit-equal frames and matches. (fx 160 at 160x120:
    TUM1's distortion model diverges past the normalized radius its own
    lens sees.)"""
    from superslam_tpu.frontend.fused_rgbd import FusedRgbdPipeline as JaxPipeline
    from superslam_tpu.geometry import StereoCalib as JaxCalib
    from superslam_tpu.models.lightglue import init_lightglue_params as jax_lg_init
    from superslam_tpu.models.superpoint import init_superpoint_params as jax_sp_init
    from superslam_tpu_torch.frontend.features import PaddedFeatures
    from superslam_tpu_torch.frontend.fused_rgbd import FusedRgbdPipeline
    from superslam_tpu_torch.models.lightglue import init_lightglue_params
    from superslam_tpu_torch.models.superpoint import init_superpoint_params

    rng = np.random.default_rng(5)
    n = 90
    p = np.full((3, K), -1, np.int16)
    p[0, :n] = rng.integers(0, W * 16, n)
    p[1, :n] = rng.integers(0, H * 16, n)
    p[1, n:] = rng.integers(0, H * 16, K - n)
    p[2, rng.choice(K, 40, replace=False)] = rng.integers(0, n, 40)
    depth = (rng.uniform(0.0, 3.0, (H, W)) * DEPTH_FACTOR).astype(np.uint16)
    depth[rng.uniform(size=(H, W)) < 0.2] = 0  # holes
    cal = dict(fx=160.0, fy=160.0, cx=80.0, cy=60.0, baseline=0.1)
    kw = dict(width=W, height=H, depth_factor=DEPTH_FACTOR, max_depth=2.5, max_keypoints=K,
              dist_coeffs=None if dist is None else np.asarray(dist))
    jpl = JaxPipeline(jax_sp_init(0), jax_lg_init(0), JaxCalib(**cal), **kw)
    tpl = FusedRgbdPipeline(init_superpoint_params(0), init_lightglue_params(0),
                            StereoCalib(**cal), device="cpu", **kw)
    feats = [PaddedFeatures(kpts=None, desc=None, n=0, width=W, height=H) for _ in range(2)]
    jfr, jm = jpl.decode_packed(p, depth, 0.5, feats[0])
    tfr, tm = tpl.decode_packed(p, depth, 0.5, feats[1])
    assert feats[0].n == feats[1].n == n and len(tfr) == n
    for name in ("keypoints_left", "stereo", "has_depth", "scores"):
        np.testing.assert_array_equal(getattr(tfr, name), getattr(jfr, name), err_msg=name)
    assert 0 < tfr.has_depth.sum() < n
    np.testing.assert_array_equal(tm.matches, jm.matches)
    np.testing.assert_array_equal(tm.scores, jm.scores)


# -- the trackers and the facade -----------------------------------------------------


@pytest.mark.parametrize("dist", [None, (-0.2, 0.05, 0.001, -0.002, 0.0)],
                         ids=["pinhole", "distorted"])
def test_rgbd_frontend_matches_jax(weights, dist):
    """The unfused RGB-D front end (frontend/rgbd_frontend.py: the port's
    extractor, then host undistortion and depth sampling) against the JAX
    package's on one rendered frame: >= 95% of the JAX keypoints have a
    port keypoint within 1/16 px (the extractors' sub-pixel refinement);
    on those that sample the same depth pixel, the depth flag is the same
    and the synthesized disparity uL - uR (bf / Z) agrees within 1e-6 px."""
    from superslam_tpu.frontend.extractor import SuperPointExtractor as JaxExtractor
    from superslam_tpu.frontend.rgbd_frontend import RgbdFrontEnd as JaxRgbdFrontEnd
    from superslam_tpu.geometry import StereoCalib as JaxCalib
    from superslam_tpu_torch.frontend.extractor import SuperPointExtractor
    from superslam_tpu_torch.frontend.rgbd_frontend import RgbdFrontEnd

    jsp, _, tsp, _ = weights
    (gray, depth), = rgbd_frames(1)[0]
    kw = dict(width=W, height=H, max_keypoints=K, keypoint_threshold=0.010)
    ckw = dict(fx=FX, fy=FX, cx=W / 2, cy=H / 2, baseline=0.3)
    d = None if dist is None else np.asarray(dist)
    jfe, tfe = JaxExtractor(jsp, **kw), SuperPointExtractor(tsp, device="cpu", **kw)
    jf = JaxRgbdFrontEnd(jfe, JaxCalib(**ckw), DEPTH_FACTOR, 12.0, d).process(gray, depth, 0.0)
    tf = RgbdFrontEnd(tfe, StereoCalib(**ckw), DEPTH_FACTOR, 12.0, d).process(gray, depth, 0.0)
    idx, dist_px = _nearest(np.asarray(jf.keypoints_left), np.asarray(tf.keypoints_left))
    near = dist_px <= 1.0 / 16
    assert len(jf) > 60 and near.mean() >= 0.95
    # Depth is sampled at the rounded raw pixel: compare where both round
    # to the same one.
    jraw = np.rint(jfe.extract(gray).keypoints).astype(int)
    traw = np.rint(tfe.extract(gray).keypoints).astype(int)
    same = near & (jraw == traw[idx]).all(1)
    assert same.mean() >= 0.9
    jd, td = jf.has_depth[same], tf.has_depth[idx[same]]
    assert (jd == td).all() and jd.sum() > 30
    j_disp = (jf.stereo[:, 0] - jf.stereo[:, 1])[same][jd]
    t_disp = (tf.stereo[:, 0] - tf.stereo[:, 1])[idx[same]][jd]
    np.testing.assert_allclose(t_disp, j_disp, atol=1e-6, rtol=0)


@pytest.fixture(scope="module")
def e2e_config(tmp_path_factory):
    p = tmp_path_factory.mktemp("cfg") / "rgbd.yaml"
    p.write_text(E2E_CONFIG)
    return str(p)


def _slid_sequence(seed: int, n: int):
    """The JAX end-to-end tests' RGB-D sequence: a textured random image and
    a random depth image, windows sliding 1 px down and 2 px right a frame."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(0, 255, (152, 192)).astype(np.uint8)
    dbase = (rng.uniform(0.5, 3.0, (152, 192)) * 5000).astype(np.uint16)
    return [(base[i:i + 120, 2 * i:2 * i + 160], dbase[i:i + 120, 2 * i:2 * i + 160])
            for i in range(n)]


def _run_rgbd(slam, seq):
    """Drive a facade over seq; returns the corrected trajectory, the index
    of the frame of every host pose solve (the frame the estimator is
    tracking when it solves), and the keyframe count."""
    host_solves, tracked = [], []
    est = slam.estimator
    orig, track = est.tracker.track_arrays, est.track
    est.tracker.track_arrays = lambda *a, **k: host_solves.append(len(tracked) - 1) or orig(*a, **k)
    est.track = lambda *a, **k: tracked.append(1) or track(*a, **k)
    for i, (g, d) in enumerate(seq):
        Tcw = slam.track_rgbd(g, d, 0.1 * i)
        assert Tcw.shape == (4, 4) and np.isfinite(Tcw).all()
    if slam._tracker is not None:
        slam._tracker.flush()
    slam.estimator.stop_loop_worker()
    traj = slam.estimator.corrected_trajectory()
    n_kf = len(slam.estimator.anchors())
    slam.shutdown()
    return traj, host_solves, n_kf


def test_rgbd_pipelined_matches_synchronous(e2e_config, monkeypatch):
    """The pipelined RGB-D tracker (depth 3, batch 2, host-solved on the
    CPU) gives the synchronous loop's trajectory within 0.2 m a frame, as
    the JAX package's test_rgbd_pipelined_matches_synchronous holds its
    pair."""
    monkeypatch.setenv("SUPERSLAM_PIPELINE_BATCH", "2")
    monkeypatch.delenv("SUPERSLAM_DEVICE_TRACKER", raising=False)
    seq = _slid_sequence(4, 6)
    runs = {}
    for depth in ("0", "3"):
        monkeypatch.setenv("SUPERSLAM_PIPELINE", depth)
        slam = SuperSLAM(e2e_config, device="cpu")
        assert (slam._tracker is None) == (depth == "0")
        if slam._tracker is not None:
            assert slam._tracker.batch == 2 and not slam._tracker.device_tracking
        runs[depth] = _run_rgbd(slam, seq)[0]
    assert len(runs["0"]) == len(runs["3"]) == len(seq)
    for a, b in zip(runs["0"], runs["3"]):
        assert np.linalg.norm(a.t - b.t) < 0.2


@pytest.fixture(scope="module")
def render_config(tmp_path_factory):
    """RENDER_CONFIG at the steps' 160x120, K 128 (``path``) and at the
    stereo facade parity run's 640x352, fx 320, K 512 (``path_wide``)."""
    d = tmp_path_factory.mktemp("cfg")
    out = {}
    for key, (w, h, fx, k) in {"path": (W, H, FX, K), "path_wide": (640, 352, 320.0, 512)}.items():
        p = d / f"render_rgbd_{w}.yaml"
        p.write_text(RENDER_CONFIG.format(
            fx=fx, cx=w / 2, cy=h / 2, bf=fx * 0.3, w=w, h=h, k=k,
            weights=os.path.join(REPO, "weights") + os.sep))
        out[key] = str(p)
    return out


# Device-tracked RGB-D against host-solved and against the JAX package's
# device-tracked facade: the JAX end-to-end tests' tolerance (a frame's
# motion on the rendered lap is ~0.2 m).
DEVTRACK_GAP_M = 0.2


@pytest.mark.parametrize("distorted", [False, True], ids=["pinhole", "k1k2"])
@pytest.mark.parametrize("inputs", ["e2e", "rendered"])
def test_rgbd_device_tracking_matches_host(e2e_config, render_config, tmp_path, monkeypatch,
                                           inputs, distorted):
    """Device-tracked RGB-D (the mono chain in the step, depth 2) against
    host solving and against the JAX package's device-tracked facade, with
    and without distortion (k1 -0.2, k2 0.05: the device undistorts before
    the solve), on two inputs. A frame whose device row coasts (fewer than
    min_matches correspondences inside the prior gate) is solved on the host
    in both packages (frontend/pipelined_rgbd.py), the reference's fault R1;
    the reference's <= 2 host solves is not pinned here.

    - 10 frames of the rendered lap at the RGB-D facade parity run's
      geometry (640x352, fx 320, K 512, the committed checkpoints; the
      distorted case sees them through the distortion,
      ``distorted_frames``): the device solves most frames (fewer host
      solves than the host-solved run), and its camera positions lie within
      DEVTRACK_GAP_M of the host-solved run's and of the JAX package's
      device-tracked run's, frame by frame. Which frames coast is printed
      beside the JAX package's, not held: the count inside the gate sits
      near min_matches on some frames, so one keypoint more or less (the
      packages' front ends differ in ~8% of them by 1/16 px or in the last
      selected ones) flips a frame to the host in one package.
    - The JAX package's test_rgbd_device_tracking_{matches_host,
      with_distortion} sequence and config (random weights): a frame finds
      0 or 1 matches there, so every device row coasts. This case holds the
      coast rule: the device-tracked facade makes exactly the host-solved
      run's host solves, and its trajectory is that run's within
      DEVTRACK_GAP_M, as those tests hold theirs."""
    base = open(e2e_config if inputs == "e2e" else render_config["path_wide"]).read()
    p = tmp_path / "rgbd.yaml"
    p.write_text(base + ("Camera.k1: -0.2\nCamera.k2: 0.05\n" if distorted else ""))
    if inputs == "e2e":
        seq, gt = _slid_sequence(6 if distorted else 4, 10), None
    else:
        seq, gt, calib = rgbd_frames(10, 640, 352, 320.0)
        if distorted:
            seq = distorted_frames(seq, calib, (-0.2, 0.05, 0.0, 0.0, 0.0))
    monkeypatch.setenv("SUPERSLAM_PIPELINE", "2")
    monkeypatch.setenv("SUPERSLAM_PIPELINE_BATCH", "1")
    monkeypatch.setenv("SUPERSLAM_PALLAS_LG", "0")
    if inputs == "e2e":
        monkeypatch.setenv("SUPERSLAM_TRACK_MIN_MATCHES", "2")
    runs = {}
    for mode in ("0", "1"):
        monkeypatch.setenv("SUPERSLAM_DEVICE_TRACKER", mode)
        slam = SuperSLAM(str(p), device="cpu")
        assert slam._tracker.device_tracking == (mode == "1")
        assert (slam.rgbd_pipeline.dist_coeffs is not None) == distorted
        runs[mode] = _run_rgbd(slam, seq)
    jax_traj, jax_solves, _ = _run_rgbd(JaxSuperSLAM(str(p)), seq)  # device-tracked
    (host_traj, host_solves, _), (dev_traj, dev_solves, _) = runs["0"], runs["1"]
    gap = max(float(np.linalg.norm(a.t - b.t)) for a, b in zip(host_traj, dev_traj))
    jax_gap = max(float(np.linalg.norm(a.t - b.t)) for a, b in zip(jax_traj, dev_traj))
    ates = "" if gt is None else (
        f", ATE device {ate(dev_traj, gt).rmse:.4f} m (JAX package {ate(jax_traj, gt).rmse:.4f}), "
        f"host {ate(host_traj, gt).rmse:.4f} m")
    print(f"RGB-D device tracking ({inputs}, {'distorted' if distorted else 'pinhole'}): host "
          f"solves {len(dev_solves)} in {len(seq)} frames, on frames {sorted(set(dev_solves))} "
          f"(JAX package on the same inputs: {len(jax_solves)}, on frames "
          f"{sorted(set(jax_solves))}; the host-solved run {len(host_solves)}), largest gap "
          f"{gap:.3g} m to host-solved, {jax_gap:.3g} m to the JAX package's device-tracked run"
          + ates)
    assert host_solves and len(host_traj) == len(dev_traj) == len(jax_traj) == len(seq)
    assert all(np.isfinite(p.t).all() for p in dev_traj)
    assert gap <= DEVTRACK_GAP_M
    if inputs == "e2e":
        assert dev_solves == host_solves  # every device row coasted
    else:
        assert len(dev_solves) < len(host_solves)
        assert jax_gap <= DEVTRACK_GAP_M


FACADE_GAP_M = 0.03


def test_rgbd_facade_matches_jax_facade(render_config, monkeypatch):
    """Both facades on 10 rendered RGB-D frames at the stereo facade parity
    run's geometry (640x352, fx 320, K 512: at 160x120 both drift ~0.3 m in
    10 frames and rounding moves them apart as far), synchronous and
    host-solved, both in their default bf16 on the unfused LightGlue route:
    the same keyframes, per-frame camera positions within FACADE_GAP_M (the
    stereo facades' tolerance, tests/test_torch_facade.py)."""
    monkeypatch.setenv("SUPERSLAM_PALLAS_LG", "0")
    monkeypatch.setenv("SUPERSLAM_PIPELINE", "0")
    monkeypatch.setenv("SUPERSLAM_DEVICE_TRACKER", "0")
    monkeypatch.delenv("SUPERSLAM_ENABLE_LOOP", raising=False)
    frames, gt, _ = rgbd_frames(10, 640, 352, 320.0)
    jtraj, _, jkf = _run_rgbd(JaxSuperSLAM(render_config["path_wide"]), frames)
    ttraj, _, tkf = _run_rgbd(SuperSLAM(render_config["path_wide"], device="cpu"), frames)
    gap = [float(np.linalg.norm(a.t - b.t)) for a, b in zip(jtraj, ttraj)]
    print(f"RGB-D facades: ATE jax {ate(jtraj, gt).rmse:.4f} m, port {ate(ttraj, gt).rmse:.4f} m; "
          f"per-frame position gap max {max(gap):.4f} m; keyframes {jkf} / {tkf}")
    assert len(ttraj) == len(jtraj) == 10
    assert tkf == jkf
    assert max(gap) <= FACADE_GAP_M, gap

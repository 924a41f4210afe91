"""The slice's device step: the port's fused_stereo_step against the JAX
package's, both in their default bf16, on a rendered 160x120 stereo pair
with the committed superpoint_render + lightglue_synth weights, K=128.
Frame 0 runs against an empty keyframe and becomes the keyframe of frame 1.
Once with both packages on the unfused LightGlue route
(SUPERSLAM_PALLAS_LG=0), single frames; once with both on the fused layer
route (SUPERSLAM_PALLAS_LG=1: the JAX package's Pallas blocks in interpret
mode, the port's plain blocks), two frames in one S = 2 step.

Not exact, by design: XLA's and oneDNN's bf16 convolutions and matmuls
round at different places, which moves sub-pixel peaks by a 1/16 px step
now and then and flips near-tied matches (keypoints that share a
descriptor cell). The contract is statistical: >= 95% of the JAX valid
left keypoints appear in the port's within 1/16 px, and of those >= 90%
have the same stereo match and (per keyframe keypoint) the same track
match."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from superslam_tpu.models.weights import load_safetensors as jax_load
from superslam_tpu.ops.frontend_step import fused_stereo_step as jax_step
from superslam_tpu.ops.frontend_step import fused_stereo_step_multi as jax_step_multi
from superslam_tpu_torch.eval.synthetic_sequence import (
    circuit_trajectory,
    make_room_world,
    render_stereo,
)
from superslam_tpu_torch.frontend.fused import decode_packed
from superslam_tpu_torch.frontend.features import PaddedFeatures
from superslam_tpu_torch.geometry import StereoCalib
from superslam_tpu_torch.models.weights import load_safetensors
from superslam_tpu_torch.ops.frontend_step import (
    PACK_ROWS,
    fused_stereo_step,
    fused_stereo_step_multi,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H, PAD_H, K = 160, 120, 128, 128
STEP_KW = dict(
    max_keypoints=K, keypoint_threshold=0.010, remove_borders=4, nms_radius=4,
    true_width=W, true_height=H, min_disparity=1.0, match_threshold=0.1,
)


def rendered_frames(n: int, width: int, height: int, fx: float):
    """The accuracy suite's sprite room and circuit (make_synthetic_sequence
    defaults), seen through a width x height rig with focal length fx."""
    world = make_room_world(np.random.default_rng(0), n_sprites=300)
    calib = StereoCalib(fx=fx, fy=fx, cx=width / 2, cy=height / 2, baseline=0.3)
    poses = circuit_trajectory(150)[:n]
    rng = np.random.default_rng(1)
    frames = []
    for p in poses:
        left, right = render_stereo(world, p, calib, height, width, rng)
        frames.append((np.round(left * 255).astype(np.uint8), np.round(right * 255).astype(np.uint8)))
    return frames, poses, calib


def _weights():
    sp = os.path.join(REPO, "weights", "superpoint_render.safetensors")
    lg = os.path.join(REPO, "weights", "lightglue_synth.safetensors")
    return jax_load(sp), jax_load(lg), load_safetensors(sp), load_safetensors(lg)


def _batch(frames):
    """Rendered (left, right) pairs -> (2S, PAD_H, W) uint8 [L0, R0, L1, ...]."""
    batch = np.zeros((2 * len(frames), PAD_H, W), np.uint8)
    for i, (left, right) in enumerate(frames):
        batch[2 * i, :H], batch[2 * i + 1, :H] = left, right
    return batch


@pytest.fixture(scope="module")
def packed_blocks():
    frames, _, _ = rendered_frames(2, W, H, 160.0)
    jsp, jlg, tsp, tlg = _weights()
    jkf = (jnp.zeros((K, 2)), jnp.zeros((K, 256)), jnp.zeros((K,), bool))
    tkf = (torch.zeros(K, 2), torch.zeros(K, 256), torch.zeros(K, dtype=torch.bool))
    out = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SUPERSLAM_PALLAS_LG", "0")  # both packages unfused
        for frame in frames:
            batch = _batch([frame])
            jp, jd, jk, jv = jax_step(jsp, jlg, jnp.asarray(batch), *jkf, **STEP_KW)
            tp, td, tk, tv = fused_stereo_step(tsp, tlg, torch.from_numpy(batch), *tkf, **STEP_KW)
            # The keyframe's valid prefix (its track matches index into it).
            jkv = np.asarray(jkf[0])[: int(np.asarray(jkf[2]).sum())]
            tkv = tkf[0].numpy()[: int(tkf[2].sum())]
            out.append((np.asarray(jp), tp.numpy(), jkv, tkv))
            jkf, tkf = (jk, jd, jv), (tk, td, tv)
    return out


def _nearest(a: np.ndarray, b: np.ndarray):
    """For each row of a, the index of the nearest row of b and the
    Chebyshev distance to it."""
    d = np.abs(a[:, None, :] - b[None, :, :]).max(-1)
    return d.argmin(1), d.min(1)


@pytest.mark.parametrize("frame", [0, 1])
def test_fused_step_matches_jax(packed_blocks, frame):
    _assert_blocks_agree(*packed_blocks[frame], has_keyframe=frame > 0)


def _assert_blocks_agree(jp, tp, jkf, tkf, has_keyframe):
    assert tp.shape == jp.shape == (PACK_ROWS, K) and tp.dtype == np.int16
    feats = PaddedFeatures(kpts=None, desc=None, n=0, width=W, height=H)
    jfr, jm = decode_packed(jp, 0.0, feats)
    tfr, tm = decode_packed(tp, 0.0, PaddedFeatures(kpts=None, desc=None, n=0, width=W, height=H))
    assert len(jfr) > 60 and len(tfr) > 60

    j2t, dist = _nearest(jfr.keypoints_left, tfr.keypoints_left)
    found = dist <= 1.0 / 16
    assert found.mean() >= 0.95, found.mean()

    # Stereo: the same right keypoint (within 1/16 px), or unmatched in both.
    js, ts = jfr.stereo[found], tfr.stereo[j2t[found]]
    same_stereo = np.where(
        np.isnan(js[:, 1]) & np.isnan(ts[:, 1]), True,
        np.abs(js[:, 1] - ts[:, 1]) <= 1.0 / 16,
    )
    assert same_stereo.mean() >= 0.90, same_stereo.mean()
    assert np.isfinite(js[:, 1]).sum() > 20

    if not has_keyframe:  # nothing may track
        assert len(jm.matches) == 0 and len(tm.matches) == 0
        return
    # Track, per keyframe keypoint the two keyframes share: the same
    # current-frame keypoint (within 1/16 px), or unmatched in both.
    jt = dict(map(tuple, jm.matches))
    tt = dict(map(tuple, tm.matches))
    assert len(jkf) > 60 and len(tkf) > 60
    k2t, kdist = _nearest(jkf, tkf)
    same = []
    for i in np.flatnonzero(kdist <= 1.0 / 16):
        a, b = jt.get(i), tt.get(k2t[i])
        if a is None or b is None:
            same.append(a is None and b is None)
        else:
            same.append(np.abs(jfr.keypoints_left[a] - tfr.keypoints_left[b]).max() <= 1.0 / 16)
    assert len(jt) > 40 and len(same) > 60
    assert np.mean(same) >= 0.90, np.mean(same)


def test_fused_step_multi_fused_route_matches_jax(monkeypatch):
    """S = 2 (8 LightGlue rows) on the fused layer route in both packages:
    frames 1 and 2 of the circuit in one step against frame 0 as the shared
    keyframe (taken from the JAX package's single step and handed to both),
    held to the same statistical contract as the single step. The port's
    rows must have gone through the fused blocks: 9 self + 9 cross calls of
    8 rows each."""
    from superslam_tpu_torch.models import lightglue as tlg_mod

    frames, _, _ = rendered_frames(3, W, H, 160.0)
    jsp, jlg, tsp, tlg = _weights()
    monkeypatch.setenv("SUPERSLAM_PALLAS_LG", "0")
    empty = (jnp.zeros((K, 2)), jnp.zeros((K, 256)), jnp.zeros((K,), bool))
    _, kd, kk, kv = jax_step(jsp, jlg, jnp.asarray(_batch(frames[:1])), *empty, **STEP_KW)
    kk, kd, kv = (np.array(a) for a in (kk, kd, kv))
    kf_valid = kk[: int(kv.sum())]

    rows = []
    for name in ("fused_self_block", "fused_cross_block"):
        real = getattr(tlg_mod, name)
        monkeypatch.setattr(
            tlg_mod, name, lambda x, *a, _real=real: (rows.append(x.shape[0]), _real(x, *a))[1])
    monkeypatch.setenv("SUPERSLAM_PALLAS_LG", "1")
    batch = _batch(frames[1:])
    jp = np.asarray(jax_step_multi(
        jsp, jlg, jnp.asarray(batch), jnp.asarray(kk), jnp.asarray(kd), jnp.asarray(kv),
        **STEP_KW)[0])
    tp = fused_stereo_step_multi(
        tsp, tlg, torch.from_numpy(batch), torch.from_numpy(kk), torch.from_numpy(kd),
        torch.from_numpy(kv), **STEP_KW)[0].numpy()
    assert rows == [8] * 18
    assert tp.shape == jp.shape == (2 * PACK_ROWS, K)
    for s in range(2):
        rows_s = slice(s * PACK_ROWS, (s + 1) * PACK_ROWS)
        _assert_blocks_agree(jp[rows_s], tp[rows_s], kf_valid, kf_valid, has_keyframe=True)


def test_fused_step_default_route_is_fused(monkeypatch):
    """With SUPERSLAM_PALLAS_LG and SUPERSLAM_PALLAS_ATTN unset the step
    takes the fused layer route (fused=None), on the CPU too."""
    from superslam_tpu_torch.models import lightglue as tlg_mod

    monkeypatch.delenv("SUPERSLAM_PALLAS_LG", raising=False)
    monkeypatch.delenv("SUPERSLAM_PALLAS_ATTN", raising=False)
    calls = []
    real = tlg_mod.fused_cross_block
    monkeypatch.setattr(
        tlg_mod, "fused_cross_block", lambda *a: (calls.append(1), real(*a))[1])
    frames, _, _ = rendered_frames(1, W, H, 160.0)
    _, _, tsp, tlg = _weights()
    tkf = (torch.zeros(K, 2), torch.zeros(K, 256), torch.zeros(K, dtype=torch.bool))
    packed = fused_stereo_step(tsp, tlg, torch.from_numpy(_batch(frames)), *tkf, **STEP_KW)[0]
    assert packed.shape == (PACK_ROWS, K) and len(calls) == 9


def test_extractor_and_matcher_match_jax(monkeypatch):
    """The extractor and matcher backends (VoEstimator's re-match path) on
    one rendered pair, both packages in bf16 and on the unfused LightGlue
    route: >= 95% of the JAX keypoints within 1/16 px, and of the JAX
    matches between the two images whose keypoints both have a
    counterpart, >= 90% found by the port too."""
    monkeypatch.setenv("SUPERSLAM_PALLAS_LG", "0")
    from superslam_tpu.frontend.extractor import SuperPointExtractor as JaxExtractor
    from superslam_tpu.frontend.matcher import LightGlueMatcher as JaxMatcher
    from superslam_tpu_torch.frontend.extractor import SuperPointExtractor
    from superslam_tpu_torch.frontend.matcher import LightGlueMatcher

    (left, right), = rendered_frames(1, W, H, 160.0)[0]
    kw = dict(width=W, height=H, max_keypoints=K, keypoint_threshold=0.010)
    jfe = JaxExtractor(jax_load(os.path.join(REPO, "weights", "superpoint_render.safetensors")), **kw)
    tfe = SuperPointExtractor(
        load_safetensors(os.path.join(REPO, "weights", "superpoint_render.safetensors")),
        device="cpu", **kw,
    )
    jl, jr = jfe.extract_stereo(left, right)
    tl, tr = tfe.extract_stereo(left, right)
    maps = []
    for jf, tf in ((jl, tl), (jr, tr)):
        idx, dist = _nearest(jf.keypoints, tf.keypoints)
        assert len(jf.keypoints) > 60 and (dist <= 1.0 / 16).mean() >= 0.95
        maps.append(np.where(dist <= 1.0 / 16, idx, -1))

    mkw = dict(image_width=W, image_height=H, max_keypoints=K)
    lg = os.path.join(REPO, "weights", "lightglue_synth.safetensors")
    jm = JaxMatcher(jax_load(lg), **mkw).match(jl.keypoints, jl.descriptors, jr.keypoints, jr.descriptors)
    tm = LightGlueMatcher(load_safetensors(lg), device="cpu", **mkw).match(
        tl.keypoints, tl.descriptors, tr.keypoints, tr.descriptors
    )
    port = set(map(tuple, tm.matches))
    both = [(maps[0][q], maps[1][t]) for q, t in jm.matches if maps[0][q] >= 0 and maps[1][t] >= 0]
    assert len(both) > 30
    assert np.mean([p in port for p in both]) >= 0.90

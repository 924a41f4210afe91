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
match.

The device-tracked steps (track_kf_scan, fused_stereo_track_step_multi,
fused_stereo_track_kf_step_multi) are held to the JAX functions on inputs
both packages get bit for bit: exact projections of 128 landmarks with the
passthrough matcher for the scan, and for the steps one shared front end
(the shared_front_end fixture says why). Poses within 1e-4 (m and
rotation-matrix entries), the same counts, promotion bits and matches;
test_fused_stereo_track_kf_step_multi_matches_jax states the one
exception."""

import functools
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


# -- the device-tracked steps -----------------------------------------------------

TRACK_KW = dict(min_matches=10, track_sigma_px=10.0, disp_sigma0=8.0, track_iters=20)
KF_KW = dict(accept_frac=0.4, support_px=4.0, kf_min_frames=2, kf_max_frames=99,
             kf_min_matches=30, covis_ratio=2.0)  # the gate rides kf_min_frames only


@pytest.fixture
def few_torch_threads():
    """The suite runs in several worker processes on one host. torch's
    default of one thread per core in each of them oversubscribes it, and
    tests made of thousands of tiny ops (gradcheck, optimizer steps) then
    slow down a hundredfold. Two threads here; restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _both(arrays, jax_cast=jnp.asarray):
    return [jax_cast(a) for a in arrays], [torch.from_numpy(np.array(a)) for a in arrays]


def _to_np(tree):
    return [np.asarray(a) if not isinstance(a, torch.Tensor) else a.numpy() for a in tree]


@pytest.mark.parametrize("hybrid", [False, True])
def test_track_kf_scan_matches_jax(hybrid, few_torch_threads):
    """The scene of tests/test_device_kf.py::test_track_kf_scan...: a camera
    sliding past 128 fixed landmarks, exact projections, identical
    descriptors and the passthrough matcher (identity assignment). Four
    frames in one call; frame 2 promotes itself, frame 4 has no stereo and
    coasts. With hybrid, the entry-keyframe matches are handed in and frames
    after the promotion re-match."""
    from superslam_tpu.models.lightglue import init_lightglue_params as jax_init
    from superslam_tpu.ops.frontend_step import track_kf_scan as jax_scan
    from superslam_tpu_torch.models.lightglue import init_lightglue_params
    from superslam_tpu_torch.ops.frontend_step import TRACK_KF_COLS, track_kf_scan

    k, d, s_frames = 128, 256, 4
    fx, cx, cy, base, wd, hd = 100.0, 64.0, 48.0, 0.3, 128, 96
    rng = np.random.default_rng(7)
    z0 = rng.uniform(4.0, 10.0, k)
    xw = np.stack([(rng.uniform(10, wd - 10, k) - cx) * z0 / fx,
                   (rng.uniform(10, hd - 10, k) - cy) * z0 / fx, z0], axis=1)

    def project(t):
        p = xw - t
        return fx * p[:, 0] / p[:, 2] + cx, fx * p[:, 1] / p[:, 2] + cy, fx * base / p[:, 2]

    kl = np.zeros((s_frames, k, 2), np.float32)
    disp = np.zeros((s_frames, k), np.float32)
    for s in range(s_frames):
        kl[s, :, 0], kl[s, :, 1], disp[s] = project(np.array([0.05 * (s + 1), 0.0, 0.03 * (s + 1)]))
    ok = np.ones((s_frames, k), bool)
    ok[3] = False
    valid = np.ones((s_frames, k), bool)
    desc = rng.normal(0, 1, (k, d)).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=1, keepdims=True)
    dl = np.broadcast_to(desc, (s_frames, k, d)).copy()
    center, scale = np.array([wd / 2.0, hd / 2.0], np.float32), max(wd, hd) / 2.0
    nkl = ((kl - center) / scale).astype(np.float32)
    u0, v0, _ = project(np.zeros(3))
    kf_nk = ((np.stack([u0, v0], 1) - center) / scale).astype(np.float32)

    jframes, tframes = _both([kl, nkl, dl, valid, disp, ok])
    state = [kf_nk, desc, np.ones(k, bool), xw.astype(np.float32), np.ones(k, bool),
             np.zeros((), np.int32)]
    carry = [np.eye(3, dtype=np.float32), np.zeros(3, np.float32)] * 2
    jstate, tstate = _both(state)
    jcarry, tcarry = _both(carry)
    m0 = np.tile(np.arange(k, dtype=np.int32), (s_frames, 1))  # vs the entry keyframe
    kw = dict(calib=(fx, fx, cx, cy, base), disp_cond=fx * base / 40.0, match_threshold=0.1,
              **TRACK_KW, **KF_KW)
    ref = jax_scan(jax_init(0, passthrough=True), *jframes, tuple(jstate), tuple(jcarry),
                   track_m0=jnp.asarray(m0) if hybrid else None, **kw)
    got = track_kf_scan(init_lightglue_params(0, passthrough=True), *tframes, tuple(tstate),
                        tuple(tcarry), track_m0=torch.from_numpy(m0) if hybrid else None, **kw)

    out_j, out_t = np.asarray(ref[0]), got[0].numpy()
    assert out_t.shape == (s_frames, TRACK_KF_COLS)
    np.testing.assert_allclose(out_t[:, :12], out_j[:, :12], atol=1e-4, rtol=0)
    np.testing.assert_array_equal(out_t[:, 12:], out_j[:, 12:])  # n, support, accept, promo
    assert list(out_t[:, 15]) == [0.0, 1.0, 0.0, 0.0] and list(out_t[:, 14]) == [1.0, 1.0, 1.0, 0.0]
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    for a, b in zip(_to_np(got[2]), _to_np(ref[2])):  # the promoted keyframe state
        if a.dtype == bool or a.dtype.kind == "i":
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, atol=1e-4 if a.shape == (k, 3) else 1e-6, rtol=0)
    for a, b in zip(_to_np(got[3]), _to_np(ref[3])):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=0)


@pytest.fixture
def shared_front_end(monkeypatch, few_torch_threads):
    """Both packages' device-tracked steps on ONE front end. The extraction
    and matching half of a step is already held to the JAX package
    statistically (above): f32 rounding moves a sub-pixel peak or flips a
    near-tied match now and then, and a pose solved from ~40 matches feels
    that at 1e-2. So here the JAX package's front end runs once and its
    outputs are handed to both packages' steps in place of their own
    ``_frontend_core`` / ``_extract_stereo``; what is compared is the rest of
    each step: the keyframe bookkeeping, the solves, the promotion, the
    in-loop re-match (LightGlue bound to f32 on the unfused route on both
    sides) and the packing. The JAX steps are called un-jitted, so the
    substituted front end cannot be shadowed by an earlier trace."""
    from superslam_tpu.ops import frontend_step as jstep
    from superslam_tpu_torch.ops import frontend_step as tstep

    monkeypatch.setenv("SUPERSLAM_PALLAS_LG", "0")
    for mod, dtype in ((jstep, jnp.float32), (tstep, torch.float32)):
        monkeypatch.setattr(
            mod, "lightglue_forward",
            functools.partial(mod.lightglue_forward, compute_dtype=dtype, fused=False))
    jsp, jlg, tsp, tlg = _weights()

    def install(batch, kf_k, kf_d, kf_v, prenormalized):
        out = [np.asarray(a) for a in jstep._frontend_core(
            jsp, jlg, jnp.asarray(batch), jnp.asarray(kf_k), jnp.asarray(kf_d),
            jnp.asarray(kf_v), *STEP_KW.values(), kf_prenormalized=prenormalized)]
        jout, tout = _both(out)
        monkeypatch.setattr(jstep, "_frontend_core", lambda *a, **k: tuple(jout))
        monkeypatch.setattr(tstep, "_frontend_core", lambda *a, **k: tuple(tout))
        monkeypatch.setattr(jstep, "_extract_stereo", lambda *a, **k: tuple(jout[:6]))
        monkeypatch.setattr(tstep, "_extract_stereo", lambda *a, **k: tuple(tout[:6]))

    return jstep, tstep, (jsp, jlg, tsp, tlg), install


def _keyframe_from_frame0(jstep, jsp, jlg, frame, calib):
    """Frame 0 through the JAX package's host-solved step: its keypoints,
    descriptors and stereo depth as the keyframe (identity pose) for both
    packages."""
    empty = (jnp.zeros((K, 2)), jnp.zeros((K, 256)), jnp.zeros((K,), bool))
    packed, kd, kk, kv = jstep.fused_stereo_step(
        jsp, jlg, jnp.asarray(_batch([frame])), *empty, **STEP_KW)
    packed, kk, kd, kv = (np.array(a) for a in (packed, kk, kd, kv))
    disp = packed[2].astype(np.float32) / 16.0
    depth_ok = packed[2] >= 0
    z = calib.fx * calib.baseline / np.maximum(disp, 1e-3)
    xw = np.stack([(kk[:, 0] - calib.cx) * z / calib.fx, (kk[:, 1] - calib.cy) * z / calib.fy, z], 1)
    return kk.astype(np.float32), kd.astype(np.float32), kv, xw.astype(np.float32), depth_ok


def _assert_track_rows_agree(got, ref, cols):
    assert got.shape == ref.shape == (ref.shape[0], cols)
    np.testing.assert_allclose(got[:, :12], ref[:, :12], atol=1e-4, rtol=0)
    np.testing.assert_array_equal(got[:, 12:], ref[:, 12:])  # counts and decision bits
    assert (ref[:, 12] >= 30).all()  # every frame really tracked


def test_fused_stereo_track_step_multi_matches_jax(shared_front_end):
    """Frames 1 and 2 of the rendered circuit in one S = 2 device-tracked
    step against frame 0 as the keyframe."""
    jstep, tstep, (jsp, jlg, tsp, tlg), install = shared_front_end
    frames, _, calib = rendered_frames(3, W, H, 160.0)
    kf = _keyframe_from_frame0(jstep, jsp, jlg, frames[0], calib)
    carry = [np.eye(3, dtype=np.float32), np.zeros(3, np.float32)] * 2
    batch = _batch(frames[1:])
    install(batch, *kf[:3], prenormalized=False)
    kw = dict(calib=(calib.fx, calib.fy, calib.cx, calib.cy, calib.baseline),
              disp_cond=calib.fx * calib.baseline / 40.0, **STEP_KW, **TRACK_KW)
    jargs, targs = _both([*kf, *carry])
    ref = jstep.fused_stereo_track_step_multi.__wrapped__(
        jsp, jlg, jnp.asarray(batch), *jargs, **kw)
    got = tstep.fused_stereo_track_step_multi(tsp, tlg, torch.from_numpy(batch), *targs, **kw)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))  # the packed block
    _assert_track_rows_agree(got[4].numpy(), np.asarray(ref[4]), 13)
    for a, b in zip(_to_np(got[5]), _to_np(ref[5])):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=0)


@pytest.mark.parametrize("hybrid", [True, False])
def test_fused_stereo_track_kf_step_multi_matches_jax(shared_front_end, hybrid):
    """Frames 1..3 in one S = 3 step with the keyframe in the carry: frame 2
    promotes itself (kf_min_frames 2), so frame 3 matches the new keyframe
    (re-matched inside the loop on both routes).

    A match made inside the loop comes from each package's own LightGlue
    forward. Two keypoints in one 8x8 descriptor cell carry the same
    descriptor, and which of the twins a keyframe point takes is decided in
    the last f32 digit: measured, 1 to 6 of 128 matches name the other twin
    (same counts, same support). So: the packed keypoints and disparities
    are identical, at least 90% of the track matches are identical (the
    contract of this file), the counts and the accept and promotion bits are
    identical, and the poses agree within 1e-4 for a frame whose matches are
    identical and within 1e-2 otherwise (measured 3e-3)."""
    jstep, tstep, (jsp, jlg, tsp, tlg), install = shared_front_end
    frames, _, calib = rendered_frames(4, W, H, 160.0)
    kk, kd, kv, xw, depth_ok = _keyframe_from_frame0(jstep, jsp, jlg, frames[0], calib)
    center, scale = np.array([W / 2.0, H / 2.0], np.float32), max(W, H) / 2.0
    state = [((kk - center) / scale).astype(np.float32), kd, kv, xw, depth_ok,
             np.zeros((), np.int32)]
    carry = [np.eye(3, dtype=np.float32), np.zeros(3, np.float32)] * 2
    batch = _batch(frames[1:])
    install(batch, *state[:3], prenormalized=True)
    kw = dict(calib=(calib.fx, calib.fy, calib.cx, calib.cy, calib.baseline),
              disp_cond=calib.fx * calib.baseline / 40.0, hybrid=hybrid,
              **STEP_KW, **TRACK_KW, **KF_KW)
    jstate, tstate = _both(state)
    jcarry, tcarry = _both(carry)
    ref = jstep.fused_stereo_track_kf_step_multi.__wrapped__(
        jsp, jlg, jnp.asarray(batch), tuple(jstate), tuple(jcarry), **kw)
    got = tstep.fused_stereo_track_kf_step_multi(
        tsp, tlg, torch.from_numpy(batch), tuple(tstate), tuple(tcarry), **kw)
    gp, rp = got[0].numpy(), np.asarray(ref[0])
    track_rows = np.arange(3) * PACK_ROWS + 3
    np.testing.assert_array_equal(np.delete(gp, track_rows, 0), np.delete(rp, track_rows, 0))
    same = gp[track_rows] == rp[track_rows]  # (3, K) track matches
    assert same.mean() >= 0.90, same.mean()
    out_t, out_j = got[4].numpy(), np.asarray(ref[4])
    assert out_t.shape == out_j.shape == (3, 16)
    np.testing.assert_array_equal(out_t[:, 12:], out_j[:, 12:])  # n, support, accept, promo
    assert list(out_j[:, 15]) == [0.0, 1.0, 0.0] and (out_j[:, 12] >= 30).all()
    for s_ in range(3):
        tol = 1e-4 if same[s_].all() else 1e-2
        np.testing.assert_allclose(out_t[s_, :12], out_j[s_, :12], atol=tol, rtol=0)
    assert same[0].all() or not hybrid  # the handed-in entry matches are used as they are
    assert int(got[5][5]) == int(ref[5][5]) == 1
    for i in (0, 1, 2, 4):  # the promoted keyframe is frame 2's features
        np.testing.assert_array_equal(got[5][i].numpy(), np.asarray(ref[5][i]))
    # World points, where the feature has stereo depth (the others sit at a
    # clamped disparity, ~5e4 m away, and nothing reads them).
    has_depth = np.asarray(ref[5][4])
    np.testing.assert_allclose(
        got[5][3].numpy()[has_depth], np.asarray(ref[5][3])[has_depth], atol=1e-3, rtol=0)
    for a, b in zip(_to_np(got[6]), _to_np(ref[6])):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=0)

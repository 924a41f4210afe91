"""The port's StereoFrontEnd (frontend/stereo_frontend.py, a copy of the
JAX package's numpy module) against the JAX package's: both fed the same
extractor and matcher outputs give the same StereoFrame, exactly; and the
port's over its own SuperPoint extractor and LightGlue matcher on a
rendered pair against the JAX package's over its own, at the extractor
and matcher parity test's bf16 tolerance."""

import os

import numpy as np

from superslam_tpu.frontend.stereo_frontend import StereoFrontEnd as JStereoFrontEnd
from superslam_tpu_torch.core.interfaces import MatchResult
from superslam_tpu_torch.frontend.stereo_frontend import StereoFrontEnd

from test_torch_frontend_step import REPO, _nearest, rendered_frames


class _Features:
    def __init__(self, kpts, desc):
        self.keypoints, self.descriptors = kpts, desc
        self.scores = np.ones(len(kpts), np.float32)


class _Extractor:
    def __init__(self, left, right):
        self.out = (left, right)

    def extract_stereo(self, _l, _r):
        return self.out


class _Matcher:
    def __init__(self, matches):
        self.m = MatchResult(matches=matches, scores=np.ones(len(matches), np.float32))

    def match(self, *_):
        return self.m


def test_same_inputs_give_the_same_frame():
    rng = np.random.default_rng(2)
    n = 40
    kl = rng.uniform([0, 0], [640, 480], (n, 2)).astype(np.float32)
    kr = kl - np.stack([rng.uniform(-3, 40, n), rng.uniform(-3, 3, n)], 1).astype(np.float32)
    pairs = np.stack([np.arange(n), rng.permutation(n)], 1).astype(np.int32)
    pairs[:30, 1] = np.arange(30)
    pairs[35, 1] = -1
    calib = None  # StereoFrontEnd keeps it and never reads it
    frames = [
        cls(_Extractor(_Features(kl, None), _Features(kr, None)), _Matcher(pairs), calib).process(
            None, None, 1.5)
        for cls in (JStereoFrontEnd, StereoFrontEnd)
    ]
    j, t = frames
    assert t.timestamp == j.timestamp == 1.5
    np.testing.assert_array_equal(t.keypoints_left, j.keypoints_left)
    np.testing.assert_array_equal(t.stereo, j.stereo)
    np.testing.assert_array_equal(t.has_depth, j.has_depth)
    assert 0 < t.has_depth.sum() < n


def test_real_backends_match_jax(monkeypatch):
    """Both front ends over their own package's extractor and matcher in
    bf16 on the unfused LightGlue route: >= 95% of the JAX frame's
    keypoints within 1/16 px of the port's, and of the JAX stereo points
    whose keypoint has a counterpart, >= 90% stereo in the port's too with
    uR within 1/16 px."""
    monkeypatch.setenv("SUPERSLAM_PALLAS_LG", "0")
    from superslam_tpu.frontend.extractor import SuperPointExtractor as JExtractor
    from superslam_tpu.frontend.matcher import LightGlueMatcher as JMatcher
    from superslam_tpu.models.weights import load_safetensors as jax_load
    from superslam_tpu_torch.frontend.extractor import SuperPointExtractor
    from superslam_tpu_torch.frontend.matcher import LightGlueMatcher
    from superslam_tpu_torch.models.weights import load_safetensors

    W, H, K = 160, 120, 128
    ((left, right),), _, calib = rendered_frames(1, W, H, 160.0)
    sp = os.path.join(REPO, "weights", "superpoint_render.safetensors")
    lg = os.path.join(REPO, "weights", "lightglue_synth.safetensors")
    ekw = dict(width=W, height=H, max_keypoints=K, keypoint_threshold=0.010)
    mkw = dict(image_width=W, image_height=H, max_keypoints=K)
    jf = JStereoFrontEnd(JExtractor(jax_load(sp), **ekw), JMatcher(jax_load(lg), **mkw),
                         calib).process(left, right, 0.0)
    tf = StereoFrontEnd(SuperPointExtractor(load_safetensors(sp), device="cpu", **ekw),
                        LightGlueMatcher(load_safetensors(lg), device="cpu", **mkw),
                        calib).process(left, right, 0.0)
    idx, dist = _nearest(jf.keypoints_left, tf.keypoints_left)
    assert len(jf.keypoints_left) > 60 and (dist <= 1.0 / 16).mean() >= 0.95
    both = [(i, idx[i]) for i in np.flatnonzero(jf.has_depth) if dist[i] <= 1.0 / 16]
    assert len(both) > 30
    agree = [tf.has_depth[k] and abs(tf.stereo[k, 1] - jf.stereo[i, 1]) <= 1.0 / 16
             for i, k in both]
    assert np.mean(agree) >= 0.90, np.mean(agree)

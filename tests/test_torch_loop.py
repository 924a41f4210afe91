"""The port's loop closure against the JAX package's, on the CPU.

- EigenPlaces (models/eigenplaces.py) with the committed
  eigenplaces_resnet18_512 checkpoint, loaded by each package's loader,
  at 64x64 and 128x128 through both the host-image path
  (preprocess_image + eigenplaces_descriptor) and the device-gray path:
  descriptors within 2e-3 of the JAX package's (max abs; the two round to
  bf16 after every conv, batch norm and residual sum, at the same points
  but in different convolution code: measured 1.2e-3 to 1.5e-3, and the
  backbone in f32 agrees within 1e-4 of its largest feature) and cosine
  >= 0.9999; the
  preprocessed images within 1e-5 (bilinear resize with antialiasing
  against jax.image.resize);
- ``DeviceCosineIndex`` against the JAX package's and the host index: the
  same ids in the same order, scores within 1e-5, and the empty, excluded,
  tie and ring-wrap cases;
- the loop facade (synchronous, and pipelined at depth 2 with device
  tracking, as the JAX package's test_device_tracking_with_async_loop_worker):
  every keyframe indexed with a global descriptor, records kept as
  PaddedFeatures on the device;
- a failing loop init raises.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from superslam_tpu.models import eigenplaces as jep
from superslam_tpu.models.weights import load_safetensors as jax_load
from superslam_tpu.ops.retrieval import DeviceCosineIndex as JaxDeviceIndex
from superslam_tpu_torch.core.place_recognition import CosineDescriptorIndex
from superslam_tpu_torch.eval.synthetic_sequence import (
    circuit_trajectory,
    make_room_world,
    render_view,
)
from superslam_tpu_torch.frontend.features import PaddedFeatures
from superslam_tpu_torch.geometry import StereoCalib
from superslam_tpu_torch.models import eigenplaces as tep
from superslam_tpu_torch.models.weights import load_safetensors
from superslam_tpu_torch.ops.retrieval import DeviceCosineIndex
from superslam_tpu_torch.slam import SuperSLAM

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EP_FILE = os.path.join(REPO, "weights", "eigenplaces_resnet18_512.safetensors")
DESC_ATOL, DESC_COS = 2e-3, 0.9999

# The JAX package's end-to-end tests' config (tests/test_facade_e2e.py) with
# their loop block (test_device_tracking_with_async_loop_worker).
LOOP_CONFIG = """
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
loop:
  image_width: 64
  image_height: 64
  min_inliers: 8
  min_score: 0.5
"""


@pytest.fixture(autouse=True)
def few_torch_threads():
    """Two intra-op threads: the suite runs several workers on one host."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ep_params():
    """The committed EigenPlaces checkpoint in both packages."""
    return jax_load(EP_FILE), load_safetensors(EP_FILE)


@pytest.fixture(scope="module")
def gray_frame():
    """One rendered 160x120 frame of the accuracy suite's room."""
    world = make_room_world(np.random.default_rng(0), n_sprites=300)
    calib = StereoCalib(fx=160.0, fy=160.0, cx=80.0, cy=60.0, baseline=0.3)
    img = render_view(world, circuit_trajectory(150)[3], calib, 120, 160, np.random.default_rng(1))
    return np.round(img * 255).astype(np.uint8)


def _close(got: np.ndarray, ref: np.ndarray, label: str) -> None:
    err = np.abs(got - ref).max()
    cos = float(got @ ref / (np.linalg.norm(got) * np.linalg.norm(ref)))
    print(f"eigenplaces {label}: max abs {err:.3g}, cosine {cos:.7f}")
    assert got.shape == ref.shape == (512,)
    assert err <= DESC_ATOL and cos >= DESC_COS
    assert abs(np.linalg.norm(got) - 1.0) <= 1e-4


@pytest.mark.parametrize("size", [64, 128])
def test_preprocess_image_matches_jax(gray_frame, size):
    """Gray (160x120: width down, height up) and BGR inputs."""
    bgr = np.random.default_rng(2).uniform(0, 255, (90, 70, 3)).astype(np.uint8)
    for img in (gray_frame, bgr):
        got = tep.preprocess_image(img, size).numpy()
        ref = np.asarray(jep.preprocess_image(img, size)).transpose(0, 3, 1, 2)
        assert got.shape == ref.shape == (1, 3, size, size) and got.dtype == np.float32
        np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("size", [64, 128])
def test_eigenplaces_host_path_matches_jax(ep_params, gray_frame, size):
    jparams, tparams = ep_params
    ref = np.asarray(jep.eigenplaces_descriptor(
        jparams, jnp.asarray(jep.preprocess_image(gray_frame, size))))[0]
    got = tep.eigenplaces_descriptor(tparams, tep.preprocess_image(gray_frame, size))[0].numpy()
    _close(got, ref, f"host path at {size}")


@pytest.mark.parametrize("size", [64, 128])
def test_eigenplaces_device_gray_path_matches_jax(ep_params, gray_frame, size):
    """The padded (128, 160) upload, sliced to 120 rows on the device."""
    jparams, tparams = ep_params
    padded = np.zeros((128, 160), np.uint8)
    padded[:120] = gray_frame
    ref = np.asarray(jep.eigenplaces_descriptor_from_device_gray(
        jparams, jnp.asarray(padded), true_height=120, true_width=160, size=size))
    got = tep.eigenplaces_descriptor_from_device_gray(
        tparams, torch.from_numpy(padded), true_height=120, true_width=160, size=size).numpy()
    _close(got, ref, f"device-gray path at {size}")
    host = tep.eigenplaces_descriptor(tparams, tep.preprocess_image(gray_frame, size))[0].numpy()
    np.testing.assert_allclose(got, host, atol=1e-6, rtol=0)  # the same image, the same net


def test_resnet_features_in_f32_match_jax(ep_params, gray_frame):
    """The backbone in f32 in both packages: within 1e-4 of max |feature|,
    so the bf16 descriptors' 2e-3 is rounding, not the architecture."""
    jparams, tparams = ep_params
    x = tep.preprocess_image(gray_frame, 64)
    ref = np.asarray(jep.resnet18_features(
        jparams, jnp.asarray(x.numpy().transpose(0, 2, 3, 1)), dtype=jnp.float32)
    ).transpose(0, 3, 1, 2)
    got = tep.resnet18_features(tparams, x, dtype=torch.float32).numpy()
    assert got.shape == ref.shape == (1, 512, 2, 2)
    err = np.abs(got - ref).max() / np.abs(ref).max()
    print(f"eigenplaces backbone in f32: max error / max |feature| {err:.3g}")
    assert err <= 1e-4


def test_recognizer_paths_agree(ep_params, gray_frame):
    from superslam_tpu_torch.frontend.recognizer import EigenPlacesRecognizer

    rec = EigenPlacesRecognizer(ep_params[1], image_size=64, device="cpu")
    host = rec.compute_global_descriptor(gray_frame)
    padded = torch.zeros((128, 160), dtype=torch.uint8)
    padded[:120] = torch.from_numpy(gray_frame)
    dev = rec.compute_global_descriptor_from_device(padded, 120, 160)
    assert host.dtype == dev.dtype == np.float32
    np.testing.assert_allclose(dev, host, atol=1e-6, rtol=0)


# -- retrieval -----------------------------------------------------------------------


def _ids_scores(res):
    ids = [c.keyframe_id if hasattr(c, "keyframe_id") else c[0] for c in res]
    scores = [c.score if hasattr(c, "score") else c[1] for c in res]
    return ids, scores


def _fill(indexes, descs, first_id=0):
    for i, d in enumerate(descs):
        for idx in indexes:
            idx.add(first_id + i, d)


@pytest.mark.parametrize("n", [20, 200])
def test_device_index_matches_jax_and_host(n):
    rng = np.random.default_rng(n)
    dim = 32 if n == 20 else 512
    host, jdev, tdev = CosineDescriptorIndex(), JaxDeviceIndex(256, dim), DeviceCosineIndex(
        256, dim, device="cpu")
    descs = rng.standard_normal((n, dim)).astype(np.float32)
    _fill((host, jdev, tdev), descs)
    for q_at, exclude, topk, min_score in [(7, 0, 5, -1.0), (7, 3, 3, 0.0), (11, 5, 10, 0.05),
                                           (3, 0, 0, -1.0)]:
        q = descs[q_at] + rng.normal(0, 0.05, dim).astype(np.float32)
        h_ids, h_s = _ids_scores(host.query(q, exclude, topk, min_score))
        j_ids, j_s = _ids_scores(jdev.query(q, exclude, topk, min_score))
        t_ids, t_s = _ids_scores(tdev.query(q, exclude, topk, min_score))
        assert t_ids == h_ids == j_ids and len(t_ids) > 0
        np.testing.assert_allclose(t_s, h_s, atol=1e-5, rtol=0)
        np.testing.assert_allclose(t_s, j_s, atol=1e-5, rtol=0)


def test_device_index_empty_excluded_and_ties():
    idx = DeviceCosineIndex(capacity=8, dim=4, device="cpu")
    assert idx.query(np.ones(4), 0, 3, 0.0) == [] and len(idx) == 0
    idx.add(0, np.ones(4))
    assert idx.query(np.ones(4), 1, 3, 0.0) == []  # nothing old enough
    out = idx.query(np.ones(4), 0, 3, 0.0)
    assert out and out[0][0] == 0
    # Duplicate descriptors: the oldest insertion first, as the host index.
    rng = np.random.default_rng(3)
    host, dev = CosineDescriptorIndex(), DeviceCosineIndex(32, 16, device="cpu")
    dup = rng.standard_normal(16).astype(np.float32)
    for i in range(12):
        d = dup if i in (1, 6, 9) else rng.standard_normal(16).astype(np.float32)
        host.add(200 + i, d)
        dev.add(200 + i, d)
    assert _ids_scores(dev.query(dup, 0, 4, 0.5))[0] == _ids_scores(host.query(dup, 0, 4, 0.5))[0]
    assert _ids_scores(dev.query(dup, 0, 4, 0.5))[0][:3] == [201, 206, 209]


def test_device_index_ring_wrap_matches_jax():
    """Past capacity the oldest entries are overwritten: the ring keeps the
    newest `capacity` insertions, and ties still break by insertion order
    though the rows' slot order no longer is."""
    rng = np.random.default_rng(4)
    cap, dim = 8, 16
    jdev, tdev = JaxDeviceIndex(cap, dim), DeviceCosineIndex(cap, dim, device="cpu")
    dup = rng.standard_normal(dim).astype(np.float32)
    descs = [dup if i in (6, 9, 13) else rng.standard_normal(dim).astype(np.float32)
             for i in range(14)]
    _fill((jdev, tdev), descs, first_id=100)
    assert len(tdev) == cap and tdev.total_added == 14
    for exclude in (0, 2, 5):
        t_ids, t_s = _ids_scores(tdev.query(dup, exclude, 0, -1.0))
        j_ids, j_s = _ids_scores(jdev.query(dup, exclude, 0, -1.0))
        assert t_ids == j_ids and len(t_ids) == cap - exclude
        assert all(i >= 106 for i in t_ids)  # 100..105 aged out
        np.testing.assert_allclose(t_s, j_s, atol=1e-5, rtol=0)
    assert _ids_scores(tdev.query(dup, 0, 3, 0.5))[0] == [106, 109, 113]


# -- the facade ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def loop_config(tmp_path_factory):
    p = tmp_path_factory.mktemp("cfg") / "loop.yaml"
    p.write_text(LOOP_CONFIG)
    return str(p)


def _records(slam):
    slam.flush()
    slam.estimator.stop_loop_worker()
    return slam.estimator._loop_closer.db.records()


@pytest.mark.parametrize("mode", ["sync", "pipelined_device"])
def test_loop_facade_indexes_every_keyframe(loop_config, monkeypatch, mode):
    """SUPERSLAM_ENABLE_LOOP wires EigenPlaces (random init: the config's
    weights directory does not exist), a dedicated loop matcher and the
    async worker. Synchronous: the worker gets host gray copies; pipelined
    at depth 2 with device tracking (the JAX package's
    test_device_tracking_with_async_loop_worker): it gets descriptors over
    the device uploads. Either way every keyframe is indexed with a finite,
    unit global descriptor, and its record keeps the descriptors as
    PaddedFeatures (on the device on the card)."""
    from superslam_tpu_torch.frontend.features import host_descriptors

    monkeypatch.setenv("SUPERSLAM_ENABLE_LOOP", "1")
    if mode == "sync":
        monkeypatch.setenv("SUPERSLAM_PIPELINE", "0")
    else:
        monkeypatch.setenv("SUPERSLAM_PIPELINE", "2")
        monkeypatch.setenv("SUPERSLAM_DEVICE_TRACKER", "1")
    slam = SuperSLAM(loop_config, device="cpu")
    assert slam.loop_enabled and slam.estimator._loop_closer.matcher is not slam.matcher
    if mode == "sync":
        assert slam._tracker is None
    else:
        assert slam._tracker.device_tracking and slam._tracker.loop_descriptor_fn is not None
    rng = np.random.default_rng(8)
    base = rng.uniform(0, 255, (140, 180)).astype(np.uint8)
    for i in range(8):
        left = base[i:i + 120, 2 * i:2 * i + 160]
        Tcw = slam.track_stereo(left, np.roll(left, -4, axis=1), 0.1 * i)
        assert np.isfinite(Tcw).all()
    records = _records(slam)
    assert len(records) == len(slam.estimator.anchors()) >= 1
    for rec in records:
        d = rec.global_descriptor
        assert d is not None and d.shape == (512,) and np.isfinite(d).all()
        assert abs(np.linalg.norm(d) - 1.0) <= 1e-4
        assert isinstance(rec.descriptors_left, PaddedFeatures)
        assert host_descriptors(rec.descriptors_left).shape == (rec.descriptors_left.n, 256)
    slam.shutdown()


def test_loop_facade_rgbd(loop_config, monkeypatch):
    """Loop closure on the RGB-D path, pipelined: descriptors over the
    (1, H, W) uploads."""
    monkeypatch.setenv("SUPERSLAM_ENABLE_LOOP", "1")
    monkeypatch.setenv("SUPERSLAM_PIPELINE", "2")
    cfg = os.path.join(os.path.dirname(loop_config), "loop_rgbd.yaml")
    with open(cfg, "w") as f:
        f.write(LOOP_CONFIG + "DepthMapFactor: 5000.0\n")
    slam = SuperSLAM(cfg, device="cpu")
    assert slam.loop_enabled and slam._tracker.loop_descriptor_fn is not None
    rng = np.random.default_rng(9)
    base = rng.uniform(0, 255, (152, 192)).astype(np.uint8)
    dbase = (rng.uniform(0.5, 3.0, (152, 192)) * 5000).astype(np.uint16)
    for i in range(6):
        slam.track_rgbd(base[i:i + 120, 2 * i:2 * i + 160], dbase[i:i + 120, 2 * i:2 * i + 160],
                        0.1 * i)
    records = _records(slam)
    assert len(records) >= 1 and all(r.global_descriptor is not None for r in records)
    slam.shutdown()


def test_failing_loop_init_raises(loop_config, tmp_path, monkeypatch):
    """The JAX facade catches a loop-init error and runs VO-only; the port
    raises (a failed load on the card must not pass unnoticed). A missing
    weights file is not a failure: it falls back to a random init."""
    monkeypatch.setenv("SUPERSLAM_ENABLE_LOOP", "1")
    monkeypatch.setenv("SUPERSLAM_PIPELINE", "0")
    bad = tmp_path / "eigenplaces_broken.safetensors"
    bad.write_bytes(b"not a checkpoint")
    cfg = tmp_path / "loop_bad.yaml"
    cfg.write_text(LOOP_CONFIG.replace(
        'SuperPoint.model_dir: "/nonexistent-weights/"', f'SuperPoint.model_dir: "{tmp_path}/"')
        + "  weights_file: eigenplaces_broken.safetensors\n")
    with pytest.raises(Exception) as err:
        SuperSLAM(str(cfg), device="cpu")
    assert not isinstance(err.value, NotImplementedError)
    missing = tmp_path / "loop_missing.yaml"
    missing.write_text(LOOP_CONFIG + "  weights_file: __random_init_ablation__\n")
    assert SuperSLAM(str(missing), device="cpu").loop_enabled

"""The descriptor gather on the port's main path.

On the card the main path's gather is the hand-written kernel
(``ops/cuda/gather.py::gather_normalize``), where the JAX package's default
is XLA's gather with the bf16 -> f32 conversion fused into it. On the CPU
the wrapper runs its plain version, so the port's CPU results stay those of
the JAX package's ``select_keypoints(use_pallas=False)``.

- ``select_keypoints``, the fused stereo step (single and S = 2, the
  multi-sequence step) and the fused RGB-D step call the wrapper, never the
  plain version directly, by default (a spy on ``models/superpoint.py``'s
  names), and the extractor's default takes the kernel route;
- ``select_keypoints``' default on bf16 and f32 grids equals the JAX
  package's ``select_keypoints(use_pallas=False)`` (atol 1e-6: both
  gather in the grid's values, widen exactly, and normalize in f32);
- the wrapper on the CPU, with int32 and int64 cells and bf16 and f32
  grids, equals the Pallas gather in interpret mode, as
  ``tests/test_pallas_gather.py`` runs it (atol 1e-6).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from superslam_tpu.models import superpoint as jsp
from superslam_tpu.ops.pallas.gather import gather_normalize as pallas_gather
from superslam_tpu_torch.models import superpoint as tsp
from superslam_tpu_torch.models.lightglue import init_lightglue_params
from superslam_tpu_torch.ops.cuda.gather import gather_normalize

H, W, K = 64, 96, 48
GH, GW = H // 8, W // 8


@pytest.fixture
def spy(monkeypatch):
    """Counts the calls select_keypoints makes of the wrapper and of the
    plain version by their names in models/superpoint.py."""
    calls = {"kernel": 0, "plain": 0}
    wrapper, plain = tsp.gather_normalize, tsp.gather_normalize_plain

    def counted(name, fn):
        def call(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return call

    monkeypatch.setattr(tsp, "gather_normalize", counted("kernel", wrapper))
    monkeypatch.setattr(tsp, "gather_normalize_plain", counted("plain", plain))
    return calls


def _dense(rng, b: int, dtype):
    """Seeded (B, H, W) heatmaps with ties and sub-threshold cells, and a
    (B, GH, GW, 256) unit descriptor grid in ``dtype``."""
    scores = rng.uniform(0, 1, (b, H, W)).astype(np.float32)
    scores[scores < 0.6] = 0.0
    scores[:, 10, 10] = scores[:, 20, 30] = 0.9  # a tie
    grid = rng.standard_normal((b, GH, GW, 256)).astype(np.float32)
    grid /= np.linalg.norm(grid, axis=-1, keepdims=True)
    tgrid = torch.from_numpy(grid).to(dtype)
    return scores, tgrid, tgrid.float().numpy()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_select_keypoints_default_is_the_kernel_route_and_matches_jax(spy, dtype):
    scores, tgrid, jgrid = _dense(np.random.default_rng(3), 2, dtype)
    kw = dict(max_keypoints=K, keypoint_threshold=0.005, remove_borders=4,
              true_width=W - 6, true_height=H - 4)
    tk, tsc, tv, td = tsp.select_keypoints(torch.from_numpy(scores), tgrid, **kw)
    assert spy == {"kernel": 1, "plain": 0}
    jk, jsc, jv, jd = (np.asarray(a) for a in jsp.select_keypoints(
        jnp.asarray(scores), jnp.asarray(jgrid), use_pallas=False, **kw))
    assert jv.sum() > 20 and td.dtype == torch.float32
    np.testing.assert_array_equal(tv.numpy(), jv)
    np.testing.assert_array_equal(tsc.numpy(), jsc)
    np.testing.assert_array_equal(tk.numpy(), jk)
    np.testing.assert_allclose(td.numpy(), jd, atol=1e-6, rtol=0)
    # The explicit plain route: the same bits, through the plain version.
    plain = tsp.select_keypoints(torch.from_numpy(scores), tgrid, use_kernel=False, **kw)[3]
    assert spy == {"kernel": 1, "plain": 1}
    assert torch.equal(plain, td)


@pytest.mark.parametrize("cells_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_wrapper_on_the_cpu_matches_pallas(dtype, cells_dtype):
    """(2, 12*16, 256) grids, 64 cells an image with repeats and both
    corners, against the Pallas gather in interpret mode (one image a call
    there)."""
    rng = np.random.default_rng(5)
    grid = torch.from_numpy(rng.standard_normal((2, 12 * 16, 256)).astype(np.float32)).to(dtype)
    cells = rng.integers(0, 12 * 16, size=(2, 64))
    cells[:, :4] = [0, 0, 191, 191]
    got = gather_normalize(grid, torch.from_numpy(cells).to(cells_dtype))
    assert got.shape == (2, 64, 256) and got.dtype == torch.float32
    jgrid = grid.float().numpy().reshape(2, 12, 16, 256)
    ref = np.stack([np.asarray(pallas_gather(jnp.asarray(jgrid[i]),
                                             jnp.asarray(cells[i], jnp.int32), interpret=True))
                    for i in range(2)])
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6, rtol=0)


def _step_inputs(n_images: int):
    rng = np.random.default_rng(9)
    images = torch.from_numpy(rng.integers(0, 256, (n_images, H, W), dtype=np.uint8))
    kf = (torch.zeros(K, 2), torch.zeros(K, 256), torch.zeros(K, dtype=torch.bool))
    kw = dict(max_keypoints=K, keypoint_threshold=0.005, remove_borders=4, nms_radius=4,
              true_width=W, true_height=H, match_threshold=0.1)
    return tsp.init_superpoint_params(0), init_lightglue_params(0), images, kf, kw


@pytest.mark.parametrize("pairs", [1, 2])
def test_fused_stereo_step_calls_the_wrapper(spy, pairs):
    """One gather for all 2S images of the step (S = 2: the multi-sequence
    step's)."""
    from superslam_tpu_torch.ops.frontend_step import fused_stereo_step_multi

    sp, lg, images, kf, kw = _step_inputs(2 * pairs)
    packed, desc, _, _ = fused_stereo_step_multi(sp, lg, images, *kf, min_disparity=1.0, **kw)
    assert spy == {"kernel": 1, "plain": 0}
    assert desc.shape == (pairs, K, 256) and torch.isfinite(packed.float()).all()


def test_fused_rgbd_step_calls_the_wrapper(spy):
    from superslam_tpu_torch.ops.rgbd_step import fused_rgbd_step

    sp, lg, images, kf, kw = _step_inputs(1)
    packed, desc, _, _ = fused_rgbd_step(sp, lg, images, *kf, **kw)
    assert spy == {"kernel": 1, "plain": 0}
    assert desc.shape == (K, 256) and torch.isfinite(packed.float()).all()


def test_extractor_default_is_the_kernel_route(spy):
    from superslam_tpu_torch.frontend.extractor import SuperPointExtractor

    rng = np.random.default_rng(11)
    img = rng.integers(0, 256, (H, W), dtype=np.uint8)
    ext = SuperPointExtractor(tsp.init_superpoint_params(0), width=W, height=H,
                              max_keypoints=K, device="cpu")
    assert ext.use_kernel
    feats = ext.extract_stereo(img, img)
    assert spy == {"kernel": 1, "plain": 0} and len(feats) == 2

"""Each hand-written CUDA kernel against its plain PyTorch version, on a
card, at small shapes. Skips without a CUDA device. Imports nothing of
JAX, so on the GPU host it runs without the JAX package's conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py

Tolerances: conv pairs within 2e-2 of max|plain| (the kernel rounds the
conv_a tile to bf16), NMS exact, bf16 attention atol 2e-2."""

import numpy as np
import pytest
import torch

from superslam_tpu_torch.ops.cuda.attention import masked_attention, masked_attention_plain
from superslam_tpu_torch.ops.cuda.conv import conv_pair_pool, conv_pair_pool_plain
from superslam_tpu_torch.ops.cuda.nms import nms_plain, nms_suppress


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("cin,h,w", [(1, 32, 96), (64, 32, 96), (64, 18, 70)])
def test_conv_pair_pool_kernel(cuda, cin, h, w):
    """Includes a shape that is not a multiple of the 16 x 32 tile."""
    rng = np.random.default_rng(cin + h)
    if cin == 1:
        x = rng.uniform(0, 1, (2, 1, h, w))
    else:
        x = np.maximum(rng.normal(size=(2, cin, h, w)), 0)
    wa = rng.normal(size=(64, cin, 3, 3)) * (0.3 if cin == 1 else 0.1)
    ba, bb = rng.normal(size=(64,)) * 0.1, rng.normal(size=(64,)) * 0.1
    wb = rng.normal(size=(64, 64, 3, 3)) * 0.1
    args = [torch.from_numpy(a.astype(np.float32)).to(cuda) for a in (x, wa, ba, wb, bb)]
    for out_dtype in (torch.bfloat16, torch.float32):
        got = conv_pair_pool(*args, out_dtype=out_dtype)
        ref = conv_pair_pool_plain(*args, out_dtype=out_dtype)
        assert got.shape == ref.shape == (2, 64, h // 2, w // 2) and got.dtype == out_dtype
        assert (got.float() - ref.float()).abs().max() <= 2e-2 * ref.float().abs().max()


@pytest.mark.gpu
def test_nms_kernel(cuda):
    rng = np.random.default_rng(3)
    s = np.abs(rng.normal(size=(2, 40, 72))).astype(np.float32)
    s[s < 0.5] = 0.0
    s[:, 10, 20:24] = 1.5
    s = torch.from_numpy(s).to(cuda)
    assert torch.equal(nms_suppress(s), nms_plain(s))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_masked_attention_kernel(cuda, dtype):
    rng = np.random.default_rng(4)
    q, k, v = (
        torch.from_numpy(rng.standard_normal((2, 4, 70, 64)).astype(np.float32)).to(cuda, dtype)
        for _ in range(3)
    )
    mask = torch.from_numpy(rng.uniform(size=(2, 70)) > 0.3).to(cuda)
    mask[1] = False  # fully masked: the uniform mean of v
    got = masked_attention(q, k, v, mask)
    assert got.dtype == dtype
    err = (got.float() - masked_attention_plain(q, k, v, mask).float()).abs().max()
    assert err <= (2e-2 if dtype == torch.bfloat16 else 1e-5)
    mean_v = v[1].float().mean(dim=1, keepdim=True).expand_as(got[1])
    assert (got[1].float() - mean_v).abs().max() <= (2e-2 if dtype == torch.bfloat16 else 1e-5)

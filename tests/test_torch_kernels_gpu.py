"""Each hand-written CUDA kernel against its plain PyTorch version, on a
card, at small shapes. Skips without a CUDA device. Imports nothing of
JAX, so on the GPU host it runs without the JAX package's conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py

Tolerances: conv pairs within 2e-2 of max|plain| (the kernel rounds the
conv_a tile to bf16) and bit-equal between prepared and OIHW weights, NMS
exact (from logits: the probabilities within 1e-6 of the plain softmax's,
the suppression of them exact), bf16 attention atol 2e-2, the fused
LightGlue blocks within 2e-2 of max|plain| in bf16 and atol 1e-3 in f32,
the descriptor gather atol 1e-5, the attention backward within 1e-4 of
max|plain| in f32 (2e-2 in bf16) on the forward's residuals, the f32
forward within 1e-4 of max|plain| at every length, and the forward's row
statistics within 1e-5 of the plain softmax's, the per-frame pose solve
within 1e-3 (m and rotation-matrix entries; f32 sums in another order, and
the LM's stop on a 1e-4 relative improvement may fall one iteration apart)
with n and the usable mask exact and the kept count within 1% of n; the
per-frame tracking kernel (track_frame: the solve, the acceptance, the
carry, the keyframe gate and the promotion) the same on its solve, and on
that solve every count, bit and copied keyframe array exactly the twin's
epilogue's (each world point within 1e-5 of its norm). The tracking chains
(track_scan, track_kf_scan: one track_frame launch a frame) run on the
card against their own CPU results."""

import numpy as np
import pytest
import torch

from superslam_tpu_torch.ops.cuda.attention import (
    attention_row_stats_plain,
    masked_attention,
    masked_attention_backward,
    masked_attention_backward_plain,
    masked_attention_plain,
    masked_attention_with_stats,
)
from superslam_tpu_torch.ops.cuda.conv import (
    conv3x3,
    conv3x3_operands,
    conv3x3_plain,
    conv_pair,
    conv_pair_plain,
    conv_pair_pool,
    conv_pair_pool_plain,
    pair_operands,
)
from superslam_tpu_torch.ops.cuda.gather import gather_normalize, gather_normalize_plain
from superslam_tpu_torch.ops.cuda import _build
from superslam_tpu_torch.ops.cuda import lightglue_layer as lgl
from superslam_tpu_torch.models.lightglue import init_lightglue_params
from superslam_tpu_torch.ops.cuda.nms import nms_plain, nms_suppress, scores_nms, scores_nms_plain


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels run only on the card")
    return torch.device("cuda")


def _pair_case(cuda, cin, b, h, w):
    rng = np.random.default_rng(cin + b + h)
    if cin == 1:
        x = rng.uniform(0, 1, (b, 1, h, w))
    else:
        x = np.maximum(rng.normal(size=(b, cin, h, w)), 0)
    wa = rng.normal(size=(64, cin, 3, 3)) * (0.3 if cin == 1 else 0.1)
    ba, bb = rng.normal(size=(64,)) * 0.1, rng.normal(size=(64,)) * 0.1
    wb = rng.normal(size=(64, 64, 3, 3)) * 0.1
    return [torch.from_numpy(a.astype(np.float32)).to(cuda) for a in (x, wa, ba, wb, bb)]


# Both CINs (the mma.sync kernel): H off the 16-row tile and W off the
# 32-column tile, W < 32, batch 1 and 3 (the grid's z), the real shape.
@pytest.mark.gpu
@pytest.mark.parametrize(
    "cin,b,h,w",
    [(1, 2, 32, 96), (64, 2, 32, 96), (64, 2, 18, 70), (64, 2, 34, 98), (64, 2, 16, 20),
     (64, 1, 18, 70), (64, 3, 34, 98), (64, 2, 192, 624), (1, 2, 18, 70), (1, 2, 34, 98),
     (1, 2, 16, 20), (1, 1, 18, 70), (1, 3, 34, 98), (1, 2, 384, 1248),
     # the training slice's evaluation shapes: 120 and 60 rows leave a
     # partial 16-row tile, 80 columns a partial 32-column one
     (1, 1, 120, 160), (64, 1, 60, 80), (1, 1, 240, 320), (64, 1, 120, 160)],
)
def test_conv_pair_pool_kernel(cuda, cin, b, h, w):
    """Includes shapes that are not a multiple of the 16 x 32 tile."""
    args = _pair_case(cuda, cin, b, h, w)
    for out_dtype in (torch.bfloat16, torch.float32):
        got = conv_pair_pool(*args, out_dtype=out_dtype)
        ref = conv_pair_pool_plain(*args, out_dtype=out_dtype)
        assert got.shape == ref.shape == (b, 64, h // 2, w // 2) and got.dtype == out_dtype
        assert (got.float() - ref.float()).abs().max() <= 2e-2 * ref.float().abs().max()


@pytest.mark.gpu
@pytest.mark.parametrize(
    "cin,b,h,w",
    [(1, 2, 32, 96), (64, 2, 32, 96), (64, 2, 17, 71), (64, 2, 34, 98), (64, 2, 16, 20),
     (64, 1, 17, 71), (64, 3, 18, 70), (64, 2, 192, 624), (1, 2, 17, 71), (1, 2, 34, 98),
     (1, 2, 16, 20), (1, 1, 17, 71), (1, 3, 18, 70), (1, 2, 384, 1248)],
)
def test_conv_pair_kernel(cuda, cin, b, h, w):
    """The unpooled pair; includes odd sizes off the 16 x 32 tile."""
    args = _pair_case(cuda, cin, b, h, w)
    for out_dtype in (torch.bfloat16, torch.float32):
        got = conv_pair(*args, out_dtype=out_dtype)
        ref = conv_pair_plain(*args, out_dtype=out_dtype)
        assert got.shape == ref.shape == (b, 64, h, w) and got.dtype == out_dtype
        assert (got.float() - ref.float()).abs().max() <= 2e-2 * ref.float().abs().max()


@pytest.mark.gpu
@pytest.mark.parametrize("pool", [True, False])
@pytest.mark.parametrize("cin", [1, 64])
def test_conv_pair_prepared_operands_match_oihw(cuda, cin, pool):
    """Operands prepared once give the same bits as OIHW weights laid out in
    the call; operands of the other CIN raise before any launch."""
    args = _pair_case(cuda, cin, 2, 34, 98)
    fn, name = (conv_pair_pool, "conv_pair") if pool else (conv_pair, "conv_pair_full")
    name = name.replace("conv_pair", "conv1a1b") if cin == 1 else name
    ops = pair_operands(*args[1:])
    for out_dtype in (torch.bfloat16, torch.float32):
        assert torch.equal(fn(*args, out_dtype=out_dtype, operands=ops),
                           fn(*args, out_dtype=out_dtype))
    other = pair_operands(*_pair_case(cuda, 65 - cin, 1, 2, 2)[1:])
    before = _build.launch_counts()[name]
    with pytest.raises(ValueError, match="prepared operands"):
        fn(*args, operands=other)
    assert _build.launch_counts()[name] == before


@pytest.mark.gpu
@pytest.mark.parametrize("pool", [True, False])
def test_conv_pair_refuses_a_misaligned_input(cuda, pool):
    """The mma.sync kernel's cp.async copies read 16-byte chunks: an input
    one element off 16-byte alignment raises before any launch."""
    _, wa, ba, wb, bb = _pair_case(cuda, 64, 1, 18, 70)
    flat = torch.zeros(1 + 18 * 70 * 64, dtype=torch.bfloat16, device=cuda)
    x = flat[1:].view(1, 18, 70, 64).permute(0, 3, 1, 2)
    assert x.is_contiguous(memory_format=torch.channels_last) and x.storage_offset() == 1
    fn, name = (conv_pair_pool, "conv_pair") if pool else (conv_pair, "conv_pair_full")
    before = _build.launch_counts()[name]
    with pytest.raises(ValueError, match="16-byte aligned"):
        fn(x, wa, ba, wb, bb)
    assert _build.launch_counts()[name] == before


def _conv3x3_case(cuda, cin, cout, b, h, w):
    rng = np.random.default_rng(cin + cout + h + b)
    x = rng.normal(size=(b, cin, h, w))
    wt = rng.normal(size=(cout, cin, 3, 3)) * (0.3 if cin == 1 else 0.1)
    bias = rng.normal(size=(cout,)) * 0.1
    return [torch.from_numpy(a.astype(np.float32)).to(cuda) for a in (x, wt, bias)]


# Both CINs and COUTs; H off the 16-row tile (odd), W off the 32-column
# tile and W < 32, batch 1 and 3 (the grid's z), conv2a's real shape.
@pytest.mark.gpu
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize(
    "cin,cout,b,h,w",
    [(64, 64, 2, 32, 96), (1, 64, 2, 17, 71), (64, 128, 2, 17, 71), (64, 64, 2, 17, 20),
     (64, 128, 1, 33, 98), (64, 64, 3, 18, 70), (1, 128, 3, 19, 20), (64, 64, 2, 192, 624)],
)
def test_conv3x3_kernel(cuda, cin, cout, b, h, w, relu):
    args = _conv3x3_case(cuda, cin, cout, b, h, w)
    for out_dtype in (torch.bfloat16, torch.float32):
        got = conv3x3(*args, relu=relu, out_dtype=out_dtype)
        ref = conv3x3_plain(*args, relu=relu, out_dtype=out_dtype)
        assert got.shape == ref.shape == (b, cout, h, w) and got.dtype == out_dtype
        assert (got.float() - ref.float()).abs().max() <= 2e-2 * ref.float().abs().max()
        assert relu == bool((got.float() >= 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("cin,cout", [(64, 64), (64, 128), (1, 64)])
def test_conv3x3_prepared_operands_match_oihw(cuda, cin, cout):
    """Operands prepared once give the same bits as OIHW weights laid out in
    the call; operands of another COUT raise before any launch."""
    args = _conv3x3_case(cuda, cin, cout, 2, 34, 98)
    ops = conv3x3_operands(*args[1:])
    for out_dtype in (torch.bfloat16, torch.float32):
        assert torch.equal(conv3x3(*args, out_dtype=out_dtype, operands=ops),
                           conv3x3(*args, out_dtype=out_dtype))
    other = conv3x3_operands(*_conv3x3_case(cuda, cin, 192 - cout, 1, 2, 2)[1:])
    before = _build.launch_counts()["conv3x3"]
    with pytest.raises(ValueError, match="prepared operands"):
        conv3x3(*args, operands=other)
    assert _build.launch_counts()["conv3x3"] == before


@pytest.mark.gpu
def test_conv3x3_refuses_a_misaligned_input(cuda):
    """The mma.sync kernel's cp.async copies read 16-byte chunks: an input
    one element off 16-byte alignment raises before any launch."""
    _, wt, bias = _conv3x3_case(cuda, 64, 64, 1, 18, 70)
    flat = torch.zeros(1 + 18 * 70 * 64, dtype=torch.bfloat16, device=cuda)
    x = flat[1:].view(1, 18, 70, 64).permute(0, 3, 1, 2)
    assert x.is_contiguous(memory_format=torch.channels_last) and x.storage_offset() == 1
    before = _build.launch_counts()["conv3x3"]
    with pytest.raises(ValueError, match="16-byte aligned"):
        conv3x3(x, wt, bias)
    assert _build.launch_counts()["conv3x3"] == before


@pytest.mark.gpu
def test_nms_kernel(cuda):
    rng = np.random.default_rng(3)
    s = np.abs(rng.normal(size=(2, 40, 72))).astype(np.float32)
    s[s < 0.5] = 0.0
    s[:, 10, 20:24] = 1.5
    s = torch.from_numpy(s).to(cuda)
    assert torch.equal(nms_suppress(s), nms_plain(s))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1, 37, 70), (3, 40, 64), (2, 50, 130)])
def test_nms_kernel_partial_tiles(cuda, shape):
    """Map mode off the 32 x 64 tile, with rows that are not 16-byte
    aligned (W = 70, 130: the scalar stores) and aligned (W = 64)."""
    rng = np.random.default_rng(sum(shape))
    s = rng.uniform(0, 1, shape) ** 6
    s = torch.from_numpy((np.round(s * 256) / 256).astype(np.float32)).to(cuda)
    for radius in (0, 1, 4, 8):
        assert torch.equal(nms_suppress(s, radius), nms_plain(s, radius) if radius else s)


def _check_scores_nms(logits, radius):
    """The logits mode against its plain twin: pre within 1e-6 of the plain
    softmax's, out exactly the suppression of the kernel's own pre (and pre
    itself at radius 0), the same out without pre."""
    before = _build.launch_counts()["scores_nms"]
    out, pre = scores_nms(logits, radius, return_pre=True)
    out_only, none = scores_nms(logits, radius)
    _, ref_pre = scores_nms_plain(logits, radius, return_pre=True)
    torch.cuda.synchronize()
    assert _build.launch_counts()["scores_nms"] == before + 2
    assert none is None and torch.equal(out_only, out)
    assert pre.shape == out.shape == ref_pre.shape
    assert (pre - ref_pre).abs().max().item() <= 1e-6
    assert torch.equal(out, nms_plain(pre, radius) if radius else pre)
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("radius", [0, 1, 4, 8])
@pytest.mark.parametrize("b,h,w", [(1, 5, 13), (3, 8, 20), (2, 48, 156), (1, 4, 8), (2, 1, 1),
                                   (1, 15, 20), (1, 30, 40)])
def test_scores_nms_kernel(cuda, b, h, w, radius):
    """Cells (5, 13) and (48, 156) leave partial tiles both ways, (4, 8) is
    one whole tile, (1, 1) a single cell, (15, 20) and (30, 40) are the
    training slice's 120x160 and 240x320; logits with peaks, channels_last
    as the detector head gives them."""
    rng = np.random.default_rng(b * 1000 + h * 10 + w + radius)
    x = rng.standard_normal((b, 65, h, w)) * 4
    logits = torch.from_numpy(x.astype(np.float32)).to(cuda)
    _check_scores_nms(logits.contiguous(memory_format=torch.channels_last), radius)


@pytest.mark.gpu
def test_scores_nms_kernel_seams_and_layouts(cuda):
    """A peak on the last pixel of a tile with its equal across the seam (a
    two-pixel plateau straddling it, both kept), a uniform plateau over a
    tile corner, and NCHW logits giving the same bits as channels_last."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 65, 10, 20)).astype(np.float32)
    # Pixel (31, 63) is channel 63 of cell (3, 7), the last of tile (0, 0);
    # pixel (31, 64) is channel 56 of cell (3, 8), the first of tile (0, 1).
    x[:, :, 3, 7] = 0.0
    x[:, 63, 3, 7] = 12.0
    x[:, :, 3, 8] = 0.0
    x[:, 56, 3, 8] = 12.0
    x[:, :, 3:6, 14:18] = 1.0  # uniform probabilities across the corner of four tiles
    nchw = torch.from_numpy(x).to(cuda)
    out = _check_scores_nms(nchw.contiguous(memory_format=torch.channels_last), 4)
    assert out[0, 31, 63].item() > 0 and out[0, 31, 64].item() == out[0, 31, 63].item()
    assert (out[:, 28:44, 116:140] > 0).all()  # the plateau's interior: every pixel a tie
    got, pre = scores_nms(nchw, 4, return_pre=True)
    ref, ref_pre = scores_nms(nchw.contiguous(memory_format=torch.channels_last), 4, True)
    assert torch.equal(got, ref) and torch.equal(pre, ref_pre)


@pytest.mark.gpu
def test_scores_nms_kernel_refuses_what_it_cannot_take(cuda):
    x = torch.zeros((1, 65, 4, 8), device=cuda)
    before = _build.launch_counts()["scores_nms"]
    for bad in (x.to(torch.bfloat16), x[:, :64], x[0]):
        with pytest.raises(ValueError):
            scores_nms(bad)
    with pytest.raises(ValueError):
        scores_nms(x, 9)
    assert _build.launch_counts()["scores_nms"] == before


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


@pytest.mark.gpu
@pytest.mark.parametrize("n", [256, 70, 600])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_masked_attention_backward_kernel(cuda, dtype, n):
    """dq, dk, dv on the forward's residuals against the plain version and,
    through the Function, against autograd through the plain forward (and
    bit-equal to the standalone call); ragged masks, a key tile with no
    real key and one fully-masked batch row (only dv is non-zero there)."""
    rng = np.random.default_rng(n)
    q, k, v, g = (
        torch.from_numpy(rng.standard_normal((3, 4, n, 64)).astype(np.float32)).to(cuda, dtype)
        for _ in range(4)
    )
    mask = torch.from_numpy(rng.uniform(size=(3, n)) > 0.3).to(cuda)
    mask[1] = False
    mask[2, n // 2 :] = False  # a ragged prefix
    mask[0, :64] = False  # the first key tile holds no real key
    mask[0, -1] = True
    out, stats = masked_attention_with_stats(q, k, v, mask)
    assert torch.equal(out, masked_attention(q, k, v, mask))
    got = masked_attention_backward(q, k, v, mask, g, out, stats)
    ref = masked_attention_backward_plain(q, k, v, mask, g)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for a, b in zip(got, ref):
        assert a.dtype == dtype and torch.isfinite(a.float()).all()
        assert (a.float() - b.float()).abs().max() <= tol * b.float().abs().max()
    assert got[0][1].abs().max() == 0 and got[1][1].abs().max() == 0
    assert got[1][0, :, :64].abs().max() == 0 and got[2][0, :, :64].abs().max() == 0

    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out_f = masked_attention(*leaves, mask)
    assert out_f.grad_fn is not None
    out_f.backward(g)
    assert all(torch.equal(leaf.grad, want) for leaf, want in zip(leaves, got))
    plain = [t.clone().requires_grad_() for t in (q, k, v)]
    masked_attention_plain(*plain, mask).backward(g)
    for a, b in zip(leaves, plain):
        assert (a.grad.float() - b.grad.float()).abs().max() <= tol * b.grad.float().abs().max()


@pytest.mark.gpu
@pytest.mark.parametrize("n", [70, 600])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_masked_attention_row_stats(cuda, dtype, n):
    """The forward's row statistics (maximum, 1 / sum) against the plain
    softmax's: the maximum within 1e-5 of max(|m|, 1), 1 / sum within 1e-5
    relative; the fully-masked row has -1e9 and 1 / N. Writing them
    changes no bit of the output."""
    rng = np.random.default_rng(n + 1)
    q, k, v = (
        torch.from_numpy(rng.standard_normal((2, 4, n, 64)).astype(np.float32)).to(cuda, dtype)
        for _ in range(3)
    )
    mask = torch.from_numpy(rng.uniform(size=(2, n)) > 0.3).to(cuda)
    mask[1] = False
    out, stats = masked_attention_with_stats(q, k, v, mask)
    assert torch.equal(out, masked_attention(q, k, v, mask))
    ref = attention_row_stats_plain(q, k, mask)
    assert stats.shape == (2, 2, 4, n) and stats.dtype == torch.float32
    assert ((stats[0] - ref[0]).abs() <= 1e-5 * ref[0].abs().clamp_min(1.0)).all()
    assert ((stats[1] - ref[1]).abs() <= 1e-5 * ref[1].abs()).all()
    assert (stats[0, 1] == -1e9).all()
    torch.testing.assert_close(stats[1, 1], torch.full_like(stats[1, 1], 1.0 / n), rtol=1e-6, atol=0)


@pytest.mark.gpu
def test_masked_attention_backward_needs_the_residuals(cuda):
    """On the card the backward takes the forward's output and row
    statistics; without them it raises before any launch."""
    q = torch.zeros((1, 4, 8, 64), device=cuda)
    mask = torch.ones((1, 8), dtype=torch.bool, device=cuda)
    before = _build.launch_counts()["masked_attention_bwd"]
    with pytest.raises(ValueError, match="out"):
        masked_attention_backward(q, q, q, mask, q, None, None)
    with pytest.raises(ValueError, match="stats"):
        masked_attention_backward(q, q, q, mask, q, q, torch.zeros((3, 1, 4, 8), device=cuda))
    assert _build.launch_counts()["masked_attention_bwd"] == before


def _block_case(cuda, dtype, k, b=4):
    """(b, k, 256) activations, rotary angles, ragged masks with one
    fully-masked row, and one random layer with non-trivial biases."""
    rng = np.random.default_rng(k + 1000 * (b != 4))
    params = init_lightglue_params(seed=2)
    for name in list(params):
        if name.endswith(".bias") or ".ffn.1." in name:
            params[name] = params[name] + torch.from_numpy(
                rng.normal(0, 0.1, tuple(params[name].shape)).astype(np.float32))
    params = {n: t.to(cuda) for n, t in params.items()}
    x = torch.from_numpy(rng.standard_normal((b, k, 256)).astype(np.float32)).to(cuda, dtype)
    proj = torch.from_numpy(rng.uniform(-3, 3, (b, k, 32)).astype(np.float32)).to(cuda)
    mask = torch.from_numpy(rng.uniform(size=(b, k)) < 0.7).to(cuda)
    mask[1] = False
    return params, x, torch.cos(proj), torch.sin(proj), mask


def _block_close(got, ref, dtype):
    assert got.shape == ref.shape and got.dtype == dtype
    assert torch.isfinite(got.float()).all()
    err = (got.float() - ref.float()).abs().max().item()
    if dtype == torch.bfloat16:
        assert err <= 2e-2 * ref.float().abs().max().item(), err
    else:
        assert err <= 1e-3, err


@pytest.mark.gpu
@pytest.mark.parametrize("k", [600, 77])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_fused_self_block_kernel(cuda, dtype, k):
    params, x, cos, sin, mask = _block_case(cuda, dtype, k)
    w = lgl.prep_self_weights(params, "transformers.0.self_attn", dtype)
    got = lgl.fused_self_block(x, cos, sin, mask, w)
    _block_close(got, lgl.fused_self_block_plain(x, cos, sin, mask, w), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("k", [600, 77])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_fused_cross_block_kernel(cuda, dtype, k):
    params, x, _, _, mask = _block_case(cuda, dtype, k)
    w = lgl.prep_cross_weights(params, "transformers.0.cross_attn", dtype)
    got = lgl.fused_cross_block(x, mask, w)
    _block_close(got, lgl.fused_cross_block_plain(x, mask, w), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 37, 600])
@pytest.mark.parametrize("b", [2, 4])
@pytest.mark.parametrize("kind", ["self", "cross"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_fused_blocks_at_ragged_row_counts(cuda, dtype, kind, b, k):
    """B x K rows that are not a multiple of the linears' row tile (one key,
    37, the serving 600; 2 and 4 batch rows): the projection's rotary
    epilogue, attention's merged context (and, in the cross block, its
    partner rows b ^ 1) and the tail, against the plain version."""
    params, x, cos, sin, mask = _block_case(cuda, dtype, k, b)
    prefix = f"transformers.0.{kind}_attn"
    if kind == "self":
        w = lgl.prep_self_weights(params, prefix, dtype)
        got = lgl.fused_self_block(x, cos, sin, mask, w)
        ref = lgl.fused_self_block_plain(x, cos, sin, mask, w)
    else:
        w = lgl.prep_cross_weights(params, prefix, dtype)
        got = lgl.fused_cross_block(x, mask, w)
        ref = lgl.fused_cross_block_plain(x, mask, w)
    _block_close(got, ref, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 15, 70, 256, 600])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_masked_attention_forward_lengths(cuda, dtype, n):
    """The forward at one key, under one 64-key tile, across tiles, the
    training and the serving length: a batch row whose first key tile holds
    no real key (skipped), a fully-masked one (every key, the mean of v)
    and a ragged prefix; bf16 within 2e-2, f32 within 1e-4 of max|plain|;
    with and without the row statistics the same bits, and the statistics
    within 1e-5 of the plain softmax's."""
    rng = np.random.default_rng(n + 7)
    q, k, v = (
        torch.from_numpy(rng.standard_normal((3, 4, n, 64)).astype(np.float32)).to(cuda, dtype)
        for _ in range(3)
    )
    mask = torch.from_numpy(rng.uniform(size=(3, n)) > 0.3).to(cuda)
    mask[0, :64] = False
    mask[0, -1] = True
    mask[1] = False
    mask[2] = torch.arange(n, device=cuda) <= n // 3
    out, stats = masked_attention_with_stats(q, k, v, mask)
    assert torch.equal(out, masked_attention(q, k, v, mask)) and out.dtype == dtype
    ref = masked_attention_plain(q, k, v, mask).float()
    err = (out.float() - ref).abs().max().item()
    assert err <= (2e-2 if dtype == torch.bfloat16 else 1e-4 * ref.abs().max().item()), err
    sref = attention_row_stats_plain(q, k, mask)
    assert ((stats[0] - sref[0]).abs() <= 1e-5 * sref[0].abs().clamp_min(1.0)).all()
    assert ((stats[1] - sref[1]).abs() <= 1e-5 * sref[1].abs()).all()


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 2, 8])
@pytest.mark.parametrize("k", [600, 1000, 77])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_gather_normalize_kernel(cuda, dtype, k, b):
    """B 1, 2 and 8 (RGB-D, serving, batch 4), K 600, 1000 and 77 (not a
    multiple of a block's keypoints), the corner cells 0 and G - 1, int64
    and int32 cells: atol 1e-5 against the plain version."""
    rng = np.random.default_rng(k + b)
    grid = torch.from_numpy(rng.standard_normal((b, 48 * 156, 256)).astype(np.float32))
    grid = grid.to(cuda, dtype)
    cells = torch.from_numpy(rng.integers(0, 48 * 156, size=(b, k))).to(cuda)
    cells[:, :2] = torch.tensor([0, 48 * 156 - 1], device=cuda)
    for c in (cells, cells.to(torch.int32)):
        got = gather_normalize(grid, c)
        assert got.shape == (b, k, 256) and got.dtype == torch.float32
        assert (got - gather_normalize_plain(grid, c)).abs().max() <= 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("cells_dtype", [torch.int64, torch.int32])
def test_gather_normalize_kernel_clamps_out_of_range_cells(cuda, cells_dtype):
    """Cell ids below 0 and at or past G read row 0 and row G - 1 (the
    plain version raises on them); D 8, 128, 512 and 1000 beside 256 (above
    256 a lane's chunks past its registers go through the strided loop)."""
    rng = np.random.default_rng(4)
    for d in (8, 128, 256, 512, 1000):
        grid = torch.from_numpy(rng.standard_normal((2, 100, d)).astype(np.float32)).to(cuda)
        cells = torch.tensor([[-5, -1, 0, 99, 100, 1 << 20], [7, -1 << 20, 101, 50, 99, 0]],
                             device=cuda, dtype=cells_dtype)
        got = gather_normalize(grid.to(torch.bfloat16), cells)
        ref = gather_normalize_plain(grid.to(torch.bfloat16), cells.clamp(0, 99))
        assert (got - ref).abs().max() <= 1e-5


@pytest.mark.gpu
def test_gather_normalize_kernel_is_the_main_path_default(cuda):
    """select_keypoints on CUDA tensors launches the kernel once, and
    use_kernel=False launches nothing of it; the rows agree within 1e-5."""
    from superslam_tpu_torch.models.superpoint import select_keypoints

    rng = np.random.default_rng(6)
    scores = torch.from_numpy(rng.uniform(0, 1, (2, 64, 96)).astype(np.float32)).to(cuda)
    desc = torch.nn.functional.normalize(
        torch.from_numpy(rng.standard_normal((2, 8, 12, 256)).astype(np.float32)), dim=-1)
    desc = desc.to(cuda, torch.bfloat16)
    _build.reset_launch_counts()
    got = select_keypoints(scores, desc, 48)[3]
    assert _build.launch_counts()["gather_normalize"] == 1
    ref = select_keypoints(scores, desc, 48, use_kernel=False)[3]
    assert _build.launch_counts()["gather_normalize"] == 1
    assert (got - ref).abs().max() <= 1e-5


@pytest.mark.gpu
def test_track_scan_on_the_card_matches_cpu(cuda):
    """Two frames of exact projections of 64 landmarks: the chain on CUDA
    tensors gives the CPU result within 1e-4 and the same match counts."""
    from superslam_tpu_torch.ops.frontend_step import track_scan

    rng = np.random.default_rng(3)
    k, fx, cx, cy, base = 64, 80.0, 80.0, 60.0, 0.1
    xw = rng.uniform([-4, -3, 6], [4, 3, 18], (k, 3))
    kl, disp = [], []
    for shift in (0.15, 0.30):
        p = xw - np.array([shift, 0.0, 0.02])
        kl.append(np.stack([fx * p[:, 0] / p[:, 2] + cx, fx * p[:, 1] / p[:, 2] + cy], 1))
        disp.append(fx * base / p[:, 2])
    args = [
        np.stack(kl).astype(np.float32), np.stack(disp).astype(np.float32),
        np.ones((2, k), bool), np.tile(np.arange(k, dtype=np.int32), (2, 1)),
        xw.astype(np.float32), np.ones(k, bool),
    ]
    carry = [np.eye(3, dtype=np.float32), np.zeros(3, np.float32)] * 2
    kw = dict(calib=(fx, fx, cx, cy, base), min_matches=10, track_sigma_px=10.0,
              disp_sigma0=8.0, disp_cond=fx * base / 40.0)
    outs = []
    for dev in ("cpu", cuda):
        out, _ = track_scan(
            *(torch.from_numpy(a).to(dev) for a in args),
            tuple(torch.from_numpy(c).to(dev) for c in carry), **kw)
        outs.append(out.cpu().numpy())
    assert outs[1].shape == (2, 13) and (outs[1][:, 12] == k).all()
    np.testing.assert_allclose(outs[1], outs[0], atol=1e-4, rtol=0)
    np.testing.assert_allclose(outs[1][1, 9:12], [0.30, 0.0, 0.02], atol=1e-3)


def _kf_scan_scene(seed, s_frames, since):
    """s_frames frames of exact projections of 64 landmarks (the camera
    sliding 0.05 m a frame), their keyframe at the origin in the carry with
    identical descriptors for the passthrough matcher, and the scan's
    settings (the gate fires on the covis ratio once since + 1 reaches 2)."""
    rng = np.random.default_rng(seed)
    k, fx, cx, cy, base, wd, hd = 64, 100.0, 64.0, 48.0, 0.3, 128, 96
    z0 = rng.uniform(4.0, 10.0, k)
    xw = np.stack([(rng.uniform(10, wd - 10, k) - cx) * z0 / fx,
                   (rng.uniform(10, hd - 10, k) - cy) * z0 / fx, z0], axis=1)
    center, scale = np.array([wd / 2.0, hd / 2.0]), max(wd, hd) / 2.0

    def project(shift):
        p = xw - np.array([shift, 0.0, 0.6 * shift])
        return (np.stack([fx * p[:, 0] / p[:, 2] + cx, fx * p[:, 1] / p[:, 2] + cy], 1),
                fx * base / p[:, 2])

    views = [project(0.05 * (s + 1)) for s in range(s_frames)]
    kl = np.stack([v[0] for v in views]).astype(np.float32)
    desc = rng.normal(0, 1, (k, 256)).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=1, keepdims=True)
    frames = [
        kl, ((kl - center) / scale).astype(np.float32), np.tile(desc, (s_frames, 1, 1)),
        np.ones((s_frames, k), bool), np.stack([v[1] for v in views]).astype(np.float32),
        np.ones((s_frames, k), bool),
    ]
    state = [((project(0.0)[0] - center) / scale).astype(np.float32), desc, np.ones(k, bool),
             xw.astype(np.float32), np.ones(k, bool), np.asarray(since, np.int32)]
    carry = [np.eye(3, dtype=np.float32), np.zeros(3, np.float32)] * 2
    kw = dict(calib=(fx, fx, cx, cy, base), min_matches=10, track_sigma_px=10.0, disp_sigma0=8.0,
              disp_cond=fx * base / 40.0, match_threshold=0.1, accept_frac=0.4, support_px=4.0,
              kf_min_frames=2, kf_max_frames=99, kf_min_matches=30, covis_ratio=2.0)
    return frames, state, carry, kw


@pytest.mark.gpu
def test_track_kf_scan_on_the_card_matches_cpu(cuda):
    """Three frames of exact projections of 64 landmarks with the keyframe
    in the carry and the passthrough matcher: the chain on CUDA tensors
    gives the CPU result within 1e-4, the same counts and decision bits
    (frame 2 promotes itself) and the same matches."""
    from superslam_tpu_torch.ops.frontend_step import track_kf_scan

    frames, state, carry, kw = _kf_scan_scene(3, 3, since=0)
    outs = []
    for dev in ("cpu", cuda):
        params = init_lightglue_params(0, passthrough=True, device=dev)
        out, tm, _, _ = track_kf_scan(
            params, *(torch.from_numpy(a).to(dev) for a in frames),
            tuple(torch.from_numpy(a).to(dev) for a in state),
            tuple(torch.from_numpy(a).to(dev) for a in carry), **kw)
        outs.append((out.cpu().numpy(), tm.cpu().numpy()))
    (ref, ref_m), (got, got_m) = outs
    assert got.shape == (3, 16) and list(got[:, 15]) == [0.0, 1.0, 0.0]
    np.testing.assert_allclose(got[:, :12], ref[:, :12], atol=1e-4, rtol=0)
    np.testing.assert_array_equal(got[:, 12:], ref[:, 12:])
    np.testing.assert_array_equal(got_m, ref_m)


@pytest.mark.gpu
@pytest.mark.parametrize(
    "case", ["clean", "gate_fallback", "coast", "chi2_stop", "nan_measurement", "mono",
             "no_gate", "k1", "k1024"],
)
def test_pose_solve_kernel(cuda, case):
    """The per-frame pose solve against its plain twin on the constructed
    frames of tests/test_torch_pose_solve_model.py."""
    from superslam_tpu_torch.ops.cuda.pose_solve import pose_solve, pose_solve_plain
    from test_torch_pose_solve_model import KW, _frame, _poses

    rng = np.random.default_rng(7)
    kw, poses = dict(KW), _poses()
    if case == "k1":
        frame = _frame(rng, k=1, usable=0)  # one feature, unmatched: no step is taken
    elif case == "k1024":
        frame = _frame(rng, k=1024, usable=900, noise_px=0.5)
    elif case == "coast":
        frame = _frame(rng, usable=6)
    elif case == "chi2_stop":
        frame = _frame(rng, usable=12, noise_px=3.0)
    else:
        frame = _frame(rng, k=600, usable=500, noise_px=0.5)
        frame["tm"][::7] = (frame["tm"][::7] + 101) % 600  # outliers
    if case == "gate_fallback":
        poses = _poses(t_pred=(2.0, 0.0, 0.2))
    if case == "nan_measurement":
        frame["kl"][5] = np.nan
    if case == "mono":
        kw["mono"] = True
    if case == "no_gate":
        kw.update(gate_px=0.0, chi2_rounds=0)
    names = ("kl", "disp", "stereo_ok", "tm", "kf_xw", "kf_dok")
    args = [torch.from_numpy(a) for a in poses] + [torch.from_numpy(frame[n]) for n in names]
    ref = pose_solve_plain(*args, **kw)
    before = _build.launch_counts()["pose_solve"]
    got = pose_solve(*(a.to(cuda) for a in args), **kw)
    torch.cuda.synchronize()
    assert _build.launch_counts()["pose_solve"] == before + 1
    R, t, n, ok, kept, uv = (x.cpu() for x in got)
    assert int(n) == int(ref[2])
    assert torch.equal(ok, ref[3])
    torch.testing.assert_close(uv, ref[5], rtol=0, atol=0, equal_nan=True)
    torch.testing.assert_close(R, ref[0], rtol=0, atol=1e-3)
    torch.testing.assert_close(t, ref[1], rtol=0, atol=1e-3)
    assert abs(int(kept) - int(ref[4])) <= max(1, int(ref[2]) // 100)
    if case in ("nan_measurement", "k1"):
        assert torch.equal(R, args[0]) and torch.equal(t, args[1])  # every step rejected


@pytest.mark.gpu
def test_pose_solve_rejects_what_the_kernel_does_not_take(cuda):
    from superslam_tpu_torch.ops.cuda.pose_solve import pose_solve
    from test_torch_pose_solve_model import KW, _frame, _poses

    frame = _frame(np.random.default_rng(0), k=1025, usable=10)
    names = ("kl", "disp", "stereo_ok", "tm", "kf_xw", "kf_dok")
    args = [torch.from_numpy(a).to(cuda) for a in _poses()] + [
        torch.from_numpy(frame[n]).to(cuda) for n in names]
    with pytest.raises(ValueError, match="1024"):
        pose_solve(*args, **KW)


def _track_frame_case(case):
    """The frames of tests/test_torch_track_frame_model.py as the kernel
    and its twin take them, and the epilogue's settings."""
    from test_torch_track_frame_model import GATE, SOLVE_KW, _FRAME, _KF, _case

    kw, gate, k = dict(SOLVE_KW), dict(GATE), 128
    args = dict(seed=20)
    if case in ("coast", "scan_coast"):
        args["usable"] = 6
    elif case == "support":
        args["noise_px"], gate["support_px"] = 3.0, 1.0
    elif case == "nan":
        args["t_prev"] = (np.nan, 0.0, 0.1)
    elif case == "promo_max_frames":
        args["since"], gate["kf_max_frames"] = 4, 5
    elif case == "promo_covis":
        args["since"], gate["covis_ratio"] = 1, 0.9
    elif case == "k600":
        args["k"], args["usable"] = 600, 500
    elif case == "bytewise_desc":
        args["k"] = 127  # 127 x 7 bf16 descriptors: not a whole number of 16-byte vectors
    frame, kf, carry, tm = _case(**args)
    if case == "bytewise_desc":
        rng = np.random.default_rng(0)
        frame["dl"] = rng.normal(size=(args["k"], 7)).astype(np.float32)
        kf["desc"] = rng.normal(size=(args["k"], 7)).astype(np.float32)
    if case == "mono":
        kw["mono"] = True
    t = torch.from_numpy
    tensors = (tuple(t(c) for c in carry), tuple(t(frame[n]) for n in _FRAME), t(tm),
               tuple(t(kf[n]) for n in _KF))
    return tensors, kw, (None if case in ("scan", "scan_coast", "mono") else gate)


def _on(dev, tree):
    if isinstance(tree, tuple):
        return tuple(_on(dev, x) for x in tree)
    return tree.to(dev) if isinstance(tree, torch.Tensor) else tree


def _check_track_frame(got, args, kw, gate, rematch=None, fresh=None):
    """The kernel's outputs against the twin: the raw solve and the poses
    within 1e-3 of the full twin's; n, kept, support, accept, promo, since,
    fresh, the match used and the new keyframe state exactly as the twin's
    epilogue computes them on the kernel's own raw solve (desc, nk, valid,
    depth_ok bit-equal; xw within 1e-5 of |xw|; the poses within 1e-5)."""
    from superslam_tpu_torch.ops.cuda.track_frame import (
        track_frame_epilogue_plain,
        track_frame_plain,
    )

    cpu = lambda x: _on("cpu", x)  # noqa: E731
    got = cpu(got)
    carry, frame, tm, state = args
    ref = track_frame_plain(carry, frame, tm, state, keyframes=gate, rematch=rematch,
                            fresh=fresh, **kw)
    row, used, pose, new_state, new_fresh, raw = got
    assert int(raw[2]) == int(ref[5][2])
    assert abs(int(raw[3]) - int(ref[5][3])) <= max(1, int(ref[5][2]) // 100)
    for a, b in ((raw[0], ref[5][0]), (raw[1], ref[5][1]), (row[:12], ref[0][:12])):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-3, equal_nan=True)
    on_raw = track_frame_epilogue_plain(
        (raw[0], raw[1], raw[2].long(), raw[3]), carry, frame, tm, state, calib=kw["calib"],
        min_matches=kw["min_matches"], keyframes=gate, rematch=rematch, fresh=fresh)
    torch.testing.assert_close(row[12:], on_raw[0][12:], rtol=0, atol=0)
    torch.testing.assert_close(row[:12], on_raw[0][:12], rtol=0, atol=1e-5, equal_nan=True)
    assert torch.equal(used, on_raw[1].to(torch.int32))
    for a, b in zip(pose, on_raw[2]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5, equal_nan=True)
    if gate is None:
        assert new_fresh is None
        return row
    for i, (a, b) in enumerate(zip(new_state, on_raw[3])):
        if i == 3:  # a point's error over its norm (far points: |xw| ~ 1e5 m)
            assert ((a - b).abs().amax(1) / b.norm(dim=1).clamp(min=1.0)).max() <= 1e-5
        else:
            assert a.dtype == b.dtype and torch.equal(a, b), i
    assert bool(new_fresh) == bool(on_raw[4])
    return row


@pytest.mark.gpu
@pytest.mark.parametrize(
    "case", ["clean", "coast", "support", "nan", "promo_max_frames", "promo_covis", "k600",
             "bytewise_desc", "scan", "scan_coast", "mono"],
)
def test_track_frame_kernel(cuda, case):
    """One frame through the kernel (both epilogues) against its twin on the
    constructed frames of tests/test_torch_track_frame_model.py; one
    launch, no pose_solve launch."""
    from superslam_tpu_torch.ops.cuda.track_frame import track_frame

    args, kw, gate = _track_frame_case(case)
    if case == "bytewise_desc":
        carry, frame, tm, state = args
        frame = (*frame[:2], frame[2].to(torch.bfloat16), *frame[3:])
        state = (state[0], state[1].to(torch.bfloat16), *state[2:])
        args = (carry, frame, tm, state)
    before = _build.launch_counts()
    got = track_frame(*_on(cuda, args), keyframes=gate, **kw)
    torch.cuda.synchronize()
    after = _build.launch_counts()
    assert after["track_frame"] == before["track_frame"] + 1
    assert after["pose_solve"] == before["pose_solve"]
    row = _check_track_frame(got, args, kw, gate)
    if case.startswith("promo"):
        assert row[15] == 1
    if case in ("coast", "support", "nan", "scan_coast"):
        assert row[12] < 10 or row[14] == 0


@pytest.mark.gpu
@pytest.mark.parametrize("fresh", [None, True, False])
def test_track_frame_kernel_hybrid_select(cuda, fresh):
    """The hybrid's two match vectors: the entry match while fresh (or with
    no bit, frame 0), the re-match after a promotion."""
    from superslam_tpu_torch.ops.cuda.track_frame import track_frame

    args, kw, gate = _track_frame_case("clean")
    carry, frame, tm, state = args
    entry = torch.where(torch.arange(tm.numel()) % 3 == 0, torch.full_like(tm, -1), tm)
    bit = None if fresh is None else torch.tensor(fresh)
    got = track_frame(*_on(cuda, (carry, frame, entry, state)), keyframes=gate,
                      rematch=tm.to(cuda), fresh=_on(cuda, bit), **kw)
    torch.cuda.synchronize()
    _check_track_frame(got, (carry, frame, entry, state), kw, gate, rematch=tm, fresh=bit)
    assert torch.equal(got[1].cpu(), entry if fresh in (None, True) else tm)


@pytest.mark.gpu
@pytest.mark.parametrize("s_frames", [1, 2])
def test_track_kf_scan_hybrid_on_the_card_matches_cpu(cuda, s_frames):
    """The hybrid scan (batched entry matches handed in) on the card against
    the CPU: one track_frame launch a frame and no pose_solve; at S = 2 the
    first frame promotes, so the second takes the re-match inside its
    kernel."""
    from superslam_tpu_torch.ops.frontend_step import track_kf_scan

    frames, state, carry, kw = _kf_scan_scene(5, s_frames, since=1)
    k = state[0].shape[0]
    m0 = np.tile(np.arange(k, dtype=np.int32), (s_frames, 1))
    m0[:, ::5] = -1  # the entry matches differ from the re-match's identity
    outs = []
    for dev in ("cpu", cuda):
        params = init_lightglue_params(0, passthrough=True, device=dev)
        before = _build.launch_counts()
        out, tm, st, pose = track_kf_scan(
            params, *(torch.from_numpy(a).to(dev) for a in frames),
            tuple(torch.from_numpy(a).to(dev) for a in state),
            tuple(torch.from_numpy(a).to(dev) for a in carry), track_m0=torch.from_numpy(m0).to(dev),
            **kw)
        after = _build.launch_counts()
        outs.append((out.cpu().numpy(), tm.cpu().numpy(), [a.cpu() for a in st]))
    assert after["track_frame"] - before["track_frame"] == s_frames
    assert after["pose_solve"] == before["pose_solve"]
    (ref, ref_m, ref_st), (got, got_m, got_st) = outs
    assert list(got[:, 15]) == [1.0] + [0.0] * (s_frames - 1)
    np.testing.assert_allclose(got[:, :12], ref[:, :12], atol=1e-4, rtol=0)
    np.testing.assert_array_equal(got[:, 12:], ref[:, 12:])
    np.testing.assert_array_equal(got_m, ref_m)
    if s_frames == 2:
        assert (got_m[1][::5] >= 0).any()  # the re-match, not the entry match
    for i, (a, b) in enumerate(zip(got_st, ref_st)):
        if i == 3:
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-4)
        else:
            assert torch.equal(a, b), i


# -- the RGB-D step's shapes: batch 1 at 480x640, K = 1000 (configs/TUM1.yaml) --------


@pytest.mark.gpu
@pytest.mark.parametrize("cin,h,w", [(1, 480, 640), (64, 240, 320)])
def test_conv_pair_pool_kernel_at_the_rgbd_shape(cuda, cin, h, w):
    """One image a step: conv1a1b on the 480x640 gray frame, conv_pair on
    its pooled output's shape."""
    args = _pair_case(cuda, cin, 1, h, w)
    got, ref = conv_pair_pool(*args), conv_pair_pool_plain(*args)
    assert got.shape == ref.shape == (1, 64, h // 2, w // 2)
    assert (got.float() - ref.float()).abs().max() <= 2e-2 * ref.float().abs().max()


@pytest.mark.gpu
def test_scores_nms_kernel_at_the_rgbd_shape(cuda):
    """SuperPoint's logits of one 480x640 frame, (1, 65, 60, 80)
    channels_last."""
    rng = np.random.default_rng(60)
    logits = torch.from_numpy((rng.standard_normal((1, 65, 60, 80)) * 4).astype(np.float32))
    out = _check_scores_nms(logits.to(cuda).contiguous(memory_format=torch.channels_last), 4)
    assert out.shape == (1, 480, 640)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["self", "cross"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_fused_blocks_at_the_rgbd_shape(cuda, dtype, kind):
    """One keyframe-frame pair problem (2 rows) of K = 1000, past the 600 of
    the stereo path, against the plain version."""
    params, x, cos, sin, mask = _block_case(cuda, dtype, 1000, b=2)
    prefix = f"transformers.0.{kind}_attn"
    if kind == "self":
        w = lgl.prep_self_weights(params, prefix, dtype)
        got = lgl.fused_self_block(x, cos, sin, mask, w)
        ref = lgl.fused_self_block_plain(x, cos, sin, mask, w)
    else:
        w = lgl.prep_cross_weights(params, prefix, dtype)
        got = lgl.fused_cross_block(x, mask, w)
        ref = lgl.fused_cross_block_plain(x, mask, w)
    _block_close(got, ref, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dist", [None, (0.262383, -0.953104, -0.005358, 0.002628, 1.163314)],
                         ids=["pinhole", "tum1_dist"])
def test_rgbd_mono_scan_at_k1000_on_the_card_matches_cpu(cuda, dist):
    """The RGB-D step's tracking half at K = 1000: exact projections of 1000
    landmarks (700 of them with keyframe depth, 50 unmatched), TUM1's
    intrinsics, undistorted on the device when distorted (the keypoints
    are then TUM1-distorted projections), track_scan with mono set over two
    frames; the card gives the CPU result within 1e-4, the same counts and
    a pose within 1e-3 of the truth."""
    from superslam_tpu_torch.ops.frontend_step import track_scan
    from superslam_tpu_torch.ops.rgbd_step import undistort_points

    rng = np.random.default_rng(10)
    k, fx, fy, cx, cy = 1000, 517.306408, 516.469215, 318.64304, 255.313989
    calib = (fx, fy, cx, cy, 0.3)
    z = rng.uniform(3, 8, k)  # in view: uniform over the 640x480 image at the origin
    xw = np.stack([(rng.uniform(20, 620, k) - cx) * z / fx, (rng.uniform(20, 460, k) - cy) * z / fy,
                   z], 1)
    truth = [np.array([0.02, 0.0, 0.03]), np.array([0.04, 0.01, 0.06])]
    kl = []
    for t in truth:
        p = xw - t
        x, y = p[:, 0] / p[:, 2], p[:, 1] / p[:, 2]
        if dist is not None:
            k1, k2, p1, p2, k3 = dist
            r2 = x * x + y * y
            radial = 1 + k1 * r2 + k2 * r2 * r2 + k3 * r2 ** 3
            x, y = (x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x),
                    y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y)
        kl.append(np.stack([fx * x + cx, fy * y + cy], 1))
    kl = np.stack(kl).astype(np.float32)
    tm = np.tile(np.arange(k, dtype=np.int32), (2, 1))
    tm[:, 950:] = -1
    dok = np.arange(k) < 700
    carry = [np.eye(3, dtype=np.float32), np.zeros(3, np.float32)] * 2
    outs = []
    for dev in ("cpu", cuda):
        klt = torch.from_numpy(kl).to(dev)
        if dist is not None:
            klt = undistort_points(klt, calib, dist)
        out, _ = track_scan(
            klt, torch.zeros_like(klt[..., 0]), torch.ones((2, k), dtype=torch.bool, device=dev),
            torch.from_numpy(tm).to(dev), torch.from_numpy(xw.astype(np.float32)).to(dev),
            torch.from_numpy(dok).to(dev), tuple(torch.from_numpy(c).to(dev) for c in carry),
            calib=calib, min_matches=10, track_sigma_px=10.0, disp_sigma0=1.0, disp_cond=1.0,
            mono=True)
        outs.append(out.cpu().numpy())
    ref, got = outs
    assert got.shape == (2, 13) and (got[:, 12] == ref[:, 12]).all() and (got[:, 12] >= 600).all()
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)
    np.testing.assert_allclose(got[1, 9:12], truth[1], atol=1e-3)


# -- multi-sequence batching (S = 4 sequences: 2S = 8 images, 4S = 16 pair
# problems), the limits of the single-frame shapes -------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("cin,h,w", [(1, 384, 1248), (64, 192, 624)])
def test_conv_pair_pool_kernel_at_batch_8(cuda, cin, h, w):
    args = _pair_case(cuda, cin, 8, h, w)
    got = conv_pair_pool(*args, out_dtype=torch.bfloat16)
    ref = conv_pair_pool_plain(*args, out_dtype=torch.bfloat16)
    assert got.shape == (8, 64, h // 2, w // 2)
    assert (got.float() - ref.float()).abs().max() <= 2e-2 * ref.float().abs().max()


@pytest.mark.gpu
def test_scores_nms_kernel_at_batch_8(cuda):
    rng = np.random.default_rng(8)
    x = torch.from_numpy((rng.standard_normal((8, 65, 48, 156)) * 4).astype(np.float32)).to(cuda)
    _check_scores_nms(x.contiguous(memory_format=torch.channels_last), 4)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["self", "cross"])
def test_fused_blocks_at_16_pair_problems(cuda, kind):
    params, x, cos, sin, mask = _block_case(cuda, torch.bfloat16, 600, b=16)
    prefix = f"transformers.0.{kind}_attn"
    if kind == "self":
        w = lgl.prep_self_weights(params, prefix, torch.bfloat16)
        got = lgl.fused_self_block(x, cos, sin, mask, w)
        ref = lgl.fused_self_block_plain(x, cos, sin, mask, w)
    else:
        w = lgl.prep_cross_weights(params, prefix, torch.bfloat16)
        got = lgl.fused_cross_block(x, mask, w)
        ref = lgl.fused_cross_block_plain(x, mask, w)
    _block_close(got, ref, torch.bfloat16)


def _batched_scene(q_count, s_frames=3, k=600, seed=11):
    """q_count sequences of s_frames exact projections of k landmarks, each
    sliding at its own speed; the last sequence keeps 6 matches from its
    second frame on (below min_matches: it coasts)."""
    rng = np.random.default_rng(seed)
    fx, cx, cy, base = 700.0, 624.0, 192.0, 0.54
    kls, disps, xws = [], [], []
    for q in range(q_count):
        xw = rng.uniform([-8, -3, 6], [8, 3, 40], (k, 3))
        xws.append(xw)
        kl, disp = [], []
        for s in range(s_frames):
            p = xw - np.array([0.02 * (q + 1) * (s + 1), 0.0, 0.3 * (s + 1)])
            kl.append(np.stack([fx * p[:, 0] / p[:, 2] + cx, fx * p[:, 1] / p[:, 2] + cy], 1))
            disp.append(fx * base / p[:, 2])
        kls.append(kl)
        disps.append(disp)
    tm = np.tile(np.arange(k, dtype=np.int32), (q_count, s_frames, 1))
    tm[-1, 1:, 6:] = -1
    arrays = [np.array(kls, np.float32), np.array(disps, np.float32),
              np.ones((q_count, s_frames, k), bool), tm, np.array(xws, np.float32),
              np.ones((q_count, k), bool)]
    eye = np.broadcast_to(np.eye(3, dtype=np.float32), (q_count, 3, 3)).copy()
    zero = np.zeros((q_count, 3), np.float32)
    kw = dict(calib=(fx, fx, cx, cy, base), min_matches=10, track_sigma_px=10.0,
              disp_sigma0=8.0, disp_cond=fx * base / 40.0)
    return arrays, [eye, zero, eye, zero], kw


@pytest.mark.gpu
@pytest.mark.parametrize("q_count", [1, 4, 16])
def test_batched_track_scan_on_the_card_matches_its_twin(cuda, q_count):
    """batched_track_scan's one launch a frame index (a grid of Q blocks)
    against the plain twin (track_frame_plain a sequence) on the CPU: pose
    columns within 1e-4, counts exact; exactly S launches a call."""
    from superslam_tpu_torch.parallel.batched_tracking import batched_track_scan

    arrays, carry, kw = _batched_scene(q_count)
    outs = []
    for dev in ("cpu", cuda):
        before = _build.launch_counts()["track_frame_batched"]
        out, new = batched_track_scan(*(torch.from_numpy(a).to(dev) for a in arrays),
                                      tuple(torch.from_numpy(c).to(dev) for c in carry), **kw)
        torch.cuda.synchronize()
        launched = _build.launch_counts()["track_frame_batched"] - before
        assert launched == (3 if dev == cuda else 0)
        outs.append((out.cpu().numpy(), [c.cpu().numpy() for c in new]))
    (ref, ref_c), (got, got_c) = outs
    np.testing.assert_allclose(got[..., :12], ref[..., :12], atol=1e-4, rtol=0)
    np.testing.assert_array_equal(got[..., 12], ref[..., 12])
    for a, b in zip(got_c, ref_c):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=0)
    assert (got[-1, 1:, 12] == 6).all()


@pytest.mark.gpu
def test_batched_track_frame_refuses_what_it_cannot_take(cuda):
    from superslam_tpu_torch.ops.cuda.track_frame import track_frame_batched

    arrays, carry, kw = _batched_scene(2, k=64)
    kl, disp, ok, tm, xw, dok = (torch.from_numpy(a).to(cuda) for a in arrays)
    c = torch.cat([torch.from_numpy(carry[0]).reshape(2, 9), torch.from_numpy(carry[1]),
                   torch.from_numpy(carry[2]).reshape(2, 9), torch.from_numpy(carry[3])],
                  1).to(cuda)
    solve_kw = dict(calib=kw["calib"], min_matches=10, inv_sig_uLv=0.1, disp_sigma0=8.0,
                    disp_cond=kw["disp_cond"], mono=False, gate_px=10.0, chi2_px=3.0,
                    chi2_rounds=1, track_iters=20)
    before = _build.launch_counts()["track_frame_batched"]
    with pytest.raises(ValueError, match="tm"):
        track_frame_batched(c, kl[:, 0], disp[:, 0], ok[:, 0], tm[:, 0].long(), xw, dok,
                            **solve_kw)
    with pytest.raises(ValueError, match="contiguous"):
        track_frame_batched(c, kl[:, 0], disp[:, 0], ok[:, 0], tm[:, 0], xw.transpose(1, 2)
                            .contiguous().transpose(1, 2), dok, **solve_kw)
    assert _build.launch_counts()["track_frame_batched"] == before


@pytest.mark.gpu
def test_sharded_train_step_over_the_card_and_the_cpu(cuda):
    """The matcher's step on a model axis of 2 over two distinct devices,
    the card and the CPU (parallel/tensor_parallel.py): the parameter
    slices, activations and LayerNorm statistics are copied between them,
    the all-reduces sum on the card, and autograd carries the gradients
    back through the copies. The CPU shard's heads run the plain attention,
    so against train_step on the card the step is held to the limits that
    hold the kernels against their plain versions (chip_smoke's training
    phase: the loss within 1e-4 relative, each gradient within 1e-3 of its
    tensor's largest); train_step on the CPU, all plain, is printed beside
    it. One attention launch of each kind a block, on the card's shard
    only."""
    from superslam_tpu_torch.parallel.mesh import make_mesh
    from superslam_tpu_torch.parallel.training import (
        make_optimizer,
        sharded_train_step,
        synthetic_matching_batch,
        train_step,
    )

    batch = {k: torch.from_numpy(v) for k, v in
             synthetic_matching_batch(np.random.default_rng(0), 2, 32).items()}
    runs = {}
    for name, dev, mesh in (("card", cuda, None), ("cpu", "cpu", None),
                            ("card+cpu", cuda, make_mesh(2, model_axis=2,
                                                         devices=["cuda", "cpu"]))):
        params = init_lightglue_params(0, device=dev)
        opt = make_optimizer(params, 1e-4)
        on = {k: v.to(dev) for k, v in batch.items()}
        _build.reset_launch_counts()
        loss = (train_step(params, opt, on) if mesh is None
                else sharded_train_step(params, opt, on, mesh))
        counts = _build.launch_counts()
        runs[name] = (float(loss), {k: p.grad.cpu() for k, p in params.items()})
        want = 0 if dev == "cpu" else 18
        assert counts["masked_attention"] == counts["masked_attention_bwd"] == want, name
    ref_loss, ref = runs["card"]

    def gaps(name):
        loss, grads = runs[name]
        return abs(loss - ref_loss) / abs(ref_loss), max(
            float((g - ref[k]).abs().max() / ref[k].abs().max().clamp_min(1e-30))
            for k, g in grads.items())

    (loss_gap, grad_gap), (cpu_loss_gap, cpu_grad_gap) = gaps("card+cpu"), gaps("cpu")
    print(f"card+cpu against the card: loss {loss_gap:.3g}, gradients {grad_gap:.3g}; "
          f"train_step on the CPU: loss {cpu_loss_gap:.3g}, gradients {cpu_grad_gap:.3g}")
    assert loss_gap <= 1e-4 and grad_gap <= 1e-3

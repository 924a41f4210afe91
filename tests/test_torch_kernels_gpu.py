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
with n and the usable mask exact and the kept count within 1% of n. The
last two tests run the tracking chains (track_scan, track_kf_scan: their
per-frame solve is the pose_solve kernel) on the card against their own
CPU results."""

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
     (1, 2, 16, 20), (1, 1, 18, 70), (1, 3, 34, 98), (1, 2, 384, 1248)],
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
@pytest.mark.parametrize("b,h,w", [(1, 5, 13), (3, 8, 20), (2, 48, 156), (1, 4, 8), (2, 1, 1)])
def test_scores_nms_kernel(cuda, b, h, w, radius):
    """Cells (5, 13) and (48, 156) leave partial tiles both ways, (4, 8) is
    one whole tile, (1, 1) a single cell; logits with peaks, channels_last
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
@pytest.mark.parametrize("k", [600, 77])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_gather_normalize_kernel(cuda, dtype, k):
    rng = np.random.default_rng(k)
    grid = torch.from_numpy(rng.standard_normal((2, 48 * 156, 256)).astype(np.float32))
    grid = grid.to(cuda, dtype)
    cells = torch.from_numpy(rng.integers(0, 48 * 156, size=(2, k))).to(cuda)
    cells[:, :2] = torch.tensor([0, 48 * 156 - 1], device=cuda)
    for c in (cells, cells.to(torch.int32)):
        got = gather_normalize(grid, c)
        assert got.shape == (2, k, 256) and got.dtype == torch.float32
        assert (got - gather_normalize_plain(grid, c)).abs().max() <= 1e-5


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


@pytest.mark.gpu
def test_track_kf_scan_on_the_card_matches_cpu(cuda):
    """Three frames of exact projections of 64 landmarks with the keyframe
    in the carry and the passthrough matcher: the chain on CUDA tensors
    gives the CPU result within 1e-4, the same counts and decision bits
    (frame 2 promotes itself) and the same matches."""
    from superslam_tpu_torch.ops.frontend_step import track_kf_scan

    rng = np.random.default_rng(3)
    k, fx, cx, cy, base, wd, hd = 64, 100.0, 64.0, 48.0, 0.3, 128, 96
    z0 = rng.uniform(4.0, 10.0, k)
    xw = np.stack([(rng.uniform(10, wd - 10, k) - cx) * z0 / fx,
                   (rng.uniform(10, hd - 10, k) - cy) * z0 / fx, z0], axis=1)
    center, scale = np.array([wd / 2.0, hd / 2.0]), max(wd, hd) / 2.0

    def project(shift):
        p = xw - np.array([shift, 0.0, 0.6 * shift])
        return np.stack([fx * p[:, 0] / p[:, 2] + cx, fx * p[:, 1] / p[:, 2] + cy], 1), fx * base / p[:, 2]

    views = [project(0.05 * (s + 1)) for s in range(3)]
    kl = np.stack([v[0] for v in views]).astype(np.float32)
    desc = rng.normal(0, 1, (k, 256)).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=1, keepdims=True)
    frames = [
        kl, ((kl - center) / scale).astype(np.float32), np.tile(desc, (3, 1, 1)),
        np.ones((3, k), bool), np.stack([v[1] for v in views]).astype(np.float32),
        np.ones((3, k), bool),
    ]
    state = [((project(0.0)[0] - center) / scale).astype(np.float32), desc, np.ones(k, bool),
             xw.astype(np.float32), np.ones(k, bool), np.zeros((), np.int32)]
    carry = [np.eye(3, dtype=np.float32), np.zeros(3, np.float32)] * 2
    kw = dict(calib=(fx, fx, cx, cy, base), min_matches=10, track_sigma_px=10.0, disp_sigma0=8.0,
              disp_cond=fx * base / 40.0, match_threshold=0.1, accept_frac=0.4, support_px=4.0,
              kf_min_frames=2, kf_max_frames=99, kf_min_matches=30, covis_ratio=2.0)
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

"""Each port kernel's plain PyTorch version against the JAX package's Pallas
entry point, run in interpret mode on the CPU as tests/test_pallas_*.py
run it (the CUDA kernels against these plain versions on a card:
tests/test_torch_kernels_gpu.py and chip_smoke.py).

The plain versions are what the CUDA kernels are held to on the card
(chip_smoke.py), so pinning them to the Pallas kernels closes the chain.
Comparisons are in f32 (interpret mode computes in f32)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from superslam_tpu.models import lightglue as jlg
from superslam_tpu.ops.pallas.attention import masked_attention as pallas_attention
from superslam_tpu.ops.pallas.conv import (
    PAD_ROWS,
    conv1a1b_chw,
    conv3x3_chw,
    conv_pair_chw,
    hpool_canvas,
    to_canvas,
)
from superslam_tpu.ops.pallas import lightglue_layer as pallas_lg
from superslam_tpu.ops.pallas.gather import gather_normalize as pallas_gather
from superslam_tpu.ops.pallas.nms import nms_suppress as pallas_nms
from superslam_tpu_torch.models.weights import from_jax_params
from superslam_tpu_torch.ops.cuda import lightglue_layer as port_lg
from superslam_tpu_torch.ops.cuda.attention import masked_attention, masked_attention_backward
from superslam_tpu_torch.ops.cuda.conv import conv3x3, conv_pair, conv_pair_pool
from superslam_tpu_torch.ops.cuda.gather import gather_normalize
from superslam_tpu_torch.ops.cuda.nms import nms_suppress


def _hwio(w_oihw: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(w_oihw.transpose(2, 3, 1, 0))


def _conv_inputs(rng, cin, b, h, w):
    if cin == 1:
        x = rng.uniform(0, 1, (b, 1, h, w)).astype(np.float32)
        wa = (rng.normal(size=(64, 1, 3, 3)) * 0.3).astype(np.float32)
    else:
        x = np.maximum(rng.normal(size=(b, cin, h, w)), 0).astype(np.float32)
        wa = (rng.normal(size=(64, cin, 3, 3)) * 0.1).astype(np.float32)
    ba = (rng.normal(size=(64,)) * 0.1).astype(np.float32)
    wb = (rng.normal(size=(64, 64, 3, 3)) * 0.1).astype(np.float32)
    bb = (rng.normal(size=(64,)) * 0.1).astype(np.float32)
    return x, wa, ba, wb, bb


@pytest.mark.parametrize("cin", [1, 64])
def test_conv_pair_pool_plain_matches_pallas(cin):
    """(2, CIN, 32, 256): the plain conv pair + 2x2 pool against
    conv1a1b_chw / conv_pair_chw(pool_vert=True) + hpool_canvas, sliced to
    the image; atol 1e-4 (two f32 3x3 convs of O(1) values summed in
    different orders)."""
    rng = np.random.default_rng(cin)
    b, h, w = 2, 32, 256
    x, wa, ba, wb, bb = _conv_inputs(rng, cin, b, h, w)
    if cin == 1:
        canvas = to_canvas(jnp.asarray(x[:, 0]), w)
        fn = conv1a1b_chw
    else:
        canvas = jnp.pad(jnp.asarray(x), ((0, 0), (0, 0), (PAD_ROWS, PAD_ROWS), (0, 0)))
        fn = conv_pair_chw
    out = fn(
        canvas, jnp.asarray(_hwio(wa)), jnp.asarray(ba), jnp.asarray(_hwio(wb)),
        jnp.asarray(bb), w_img=w, interpret=True, out_dtype=jnp.float32, pool_vert=True,
    )
    ref = np.asarray(hpool_canvas(out))[:, :, PAD_ROWS : PAD_ROWS + h // 2, : w // 2]

    got = conv_pair_pool(
        *(torch.from_numpy(a) for a in (x, wa, ba, wb, bb)),
        out_dtype=torch.float32, compute_dtype=torch.float32,
    )
    assert got.shape == (b, 64, h // 2, w // 2)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4, rtol=0)


def _rel_err(got, ref):
    return np.abs(got - ref).max() / (np.abs(ref).max() + 1e-9)


@pytest.mark.parametrize("cin", [1, 64])
def test_conv_pair_plain_matches_pallas(cin):
    """(2, CIN, 16, 256) with image width 250: the plain unpooled conv pair
    against conv1a1b_chw / conv_pair_chw without pool_vert, the canvas cut
    to the image interior; relative error <= 2e-2 (the limit of
    tests/test_pallas_conv.py; measured ~1e-6, both sides f32)."""
    rng = np.random.default_rng(10 + cin)
    b, h, w, wimg = 2, 16, 256, 250
    x, wa, ba, wb, bb = _conv_inputs(rng, cin, b, h, w)
    x[..., wimg:] = 0.0
    canvas = jnp.pad(jnp.asarray(x), ((0, 0), (0, 0), (PAD_ROWS, PAD_ROWS), (0, 0)))
    fn = conv1a1b_chw if cin == 1 else conv_pair_chw
    out = fn(
        canvas, jnp.asarray(_hwio(wa)), jnp.asarray(ba), jnp.asarray(_hwio(wb)),
        jnp.asarray(bb), w_img=wimg, interpret=True, out_dtype=jnp.float32,
    )
    ref = np.asarray(out)[:, :, PAD_ROWS : PAD_ROWS + h, :wimg]
    got = conv_pair(
        *(torch.from_numpy(a) for a in (x[..., :wimg], wa, ba, wb, bb)),
        out_dtype=torch.float32, compute_dtype=torch.float32,
    )
    assert got.shape == (b, 64, h, wimg)
    assert _rel_err(got.numpy(), ref) <= 2e-2
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4, rtol=0)


@pytest.mark.parametrize(
    "b,cin,h,w,cout,wimg,relu",
    [(2, 64, 16, 256, 64, 250, True), (1, 1, 8, 128, 64, 120, True),
     (2, 64, 16, 256, 128, 256, True), (1, 64, 8, 128, 64, 128, False)],
)
def test_conv3x3_plain_matches_pallas(b, cin, h, w, cout, wimg, relu):
    """The shapes of tests/test_pallas_conv.py::test_conv3x3_matches_xla
    (and one without ReLU) against conv3x3_chw in interpret mode, the canvas
    cut to the image interior; relative error <= 2e-2."""
    rng = np.random.default_rng(cin + cout + wimg)
    x = rng.normal(size=(b, cin, h, w)).astype(np.float32)
    x[..., wimg:] = 0.0
    wt = (rng.normal(size=(cout, cin, 3, 3)) * 0.1).astype(np.float32)
    bias = (rng.normal(size=(cout,)) * 0.1).astype(np.float32)
    canvas = jnp.pad(jnp.asarray(x), ((0, 0), (0, 0), (PAD_ROWS, PAD_ROWS), (0, 0)))
    out = conv3x3_chw(
        canvas, jnp.asarray(_hwio(wt)), jnp.asarray(bias), relu=relu, w_img=wimg,
        interpret=True, out_dtype=jnp.float32,
    )
    ref = np.asarray(out)[:, :, PAD_ROWS : PAD_ROWS + h, :wimg]
    got = conv3x3(
        *(torch.from_numpy(a) for a in (x[..., :wimg], wt, bias)), relu=relu,
        out_dtype=torch.float32, compute_dtype=torch.float32,
    )
    assert got.shape == (b, cout, h, wimg)
    assert relu == bool((got >= 0).all())
    assert _rel_err(got.numpy(), ref) <= 2e-2
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4, rtol=0)


def test_nms_plain_matches_pallas():
    """(2, 32, 200) with exact zeros and ties: identical, bit for bit."""
    rng = np.random.default_rng(5)
    s = np.abs(rng.normal(size=(2, 32, 200))).astype(np.float32)
    s[s < 0.5] = 0.0
    s[:, 10, 20:24] = 1.5  # a plateau: ties keep their score
    ref = np.asarray(pallas_nms(jnp.asarray(s), 4, interpret=True))
    got = nms_suppress(torch.from_numpy(s), 4).numpy()
    np.testing.assert_array_equal(got, ref)


def test_masked_attention_plain_matches_pallas():
    """(2, 4, 100, 64) with ragged key masks and one fully-masked row.

    Rows with at least one real key: atol 1e-5 against the Pallas kernel
    (f32 softmax over 100 keys). The fully-masked row gets the uniform mean
    of v over the N real keys, which is what the XLA route
    (models/lightglue.py::_attention) gives; the Pallas kernel instead
    averages over its 128-padded keys (n/n_pad times that mean), so that
    row is held to the XLA route."""
    rng = np.random.default_rng(7)
    b, h, n, d = 2, 4, 100, 64
    q, k, v = (rng.standard_normal((b, h, n, d)).astype(np.float32) for _ in range(3))
    mask = rng.uniform(size=(b, n)) > 0.4
    mask[1] = False  # every key of batch row 1 masked
    got = masked_attention(*(torch.from_numpy(a) for a in (q, k, v, mask))).numpy()

    ref = np.asarray(
        pallas_attention(*(jnp.asarray(a) for a in (q, k, v, mask)), interpret=True)
    )
    np.testing.assert_allclose(got[0], ref[0], atol=1e-5, rtol=0)

    xla = np.asarray(jlg._attention(*(jnp.asarray(a) for a in (q, k, v, mask))))
    np.testing.assert_allclose(got[1], xla[1], atol=1e-5, rtol=0)
    np.testing.assert_allclose(
        got[1], np.broadcast_to(v[1].mean(axis=1, keepdims=True), got[1].shape), atol=1e-5
    )


def _block_inputs(k):
    """(4, k, 256) activations, rotary angles and ragged key masks (every
    row keeps real keys: a fully-masked row depends on the JAX route's K
    padding), plus one random layer in both packages' layouts."""
    rng = np.random.default_rng(k)
    b = 4
    x = rng.standard_normal((b, k, 256)).astype(np.float32)
    proj = rng.uniform(-3, 3, (b, k, 32)).astype(np.float32)
    mask = np.arange(k)[None] < np.array([[k], [k - 7], [k // 2], [k - 1]])
    jparams = jlg.init_lightglue_params(seed=3)
    for name in list(jparams):  # non-trivial biases and LayerNorm parameters
        if name.endswith(".bias") or ".ffn.1." in name:
            jparams[name] = jparams[name] + jnp.asarray(
                rng.normal(0, 0.1, jparams[name].shape).astype(np.float32))
    tparams = from_jax_params({n: np.asarray(v) for n, v in jparams.items()})
    return x, proj, mask, jparams, tparams


def _mask8(mask):
    return jnp.broadcast_to(jnp.asarray(mask, jnp.float32)[:, None, :], (mask.shape[0], 8, mask.shape[1]))


@pytest.mark.parametrize("k", [128, 136])
def test_fused_self_block_plain_matches_pallas(k):
    """(4, K, 256) f32 against the Pallas self block in interpret mode with
    the JAX package's own weight preparation and its permuted (K, 256)
    cos/sin tiles; the port takes (K, 32) angles and unpermuted weights.
    atol 2e-4: f32 products of O(1) values over 256-512 terms summed in
    different orders, erf against the kernel's polynomial (1.5e-7)."""
    x, proj, mask, jparams, tparams = _block_inputs(k)
    prefix = "transformers.1.self_attn"
    cos_p = jnp.tile(jnp.concatenate([jnp.cos(proj)] * 2, -1), (1, 1, 4))
    sin_p = jnp.tile(jnp.concatenate([jnp.sin(proj)] * 2, -1), (1, 1, 4))
    ref = np.asarray(pallas_lg.fused_self_block(
        jnp.asarray(x), cos_p, sin_p, _mask8(mask),
        pallas_lg.prep_self_weights(jparams, prefix, jnp.float32), interpret=True))
    got = port_lg.fused_self_block(
        torch.from_numpy(x), torch.from_numpy(np.cos(proj)), torch.from_numpy(np.sin(proj)),
        torch.from_numpy(mask), port_lg.prep_self_weights(tparams, prefix, torch.float32))
    assert got.shape == (4, k, 256) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-4, rtol=0)


@pytest.mark.parametrize("k", [128, 136])
def test_fused_cross_block_plain_matches_pallas(k):
    """(4, K, 256) f32, two pairs, against the Pallas cross block in
    interpret mode; atol 2e-4 as for the self block."""
    x, _, mask, jparams, tparams = _block_inputs(k)
    prefix = "transformers.1.cross_attn"
    ref = np.asarray(pallas_lg.fused_cross_block(
        jnp.asarray(x), _mask8(mask),
        pallas_lg.prep_cross_weights(jparams, prefix, jnp.float32), interpret=True))
    got = port_lg.fused_cross_block(
        torch.from_numpy(x), torch.from_numpy(mask),
        port_lg.prep_cross_weights(tparams, prefix, torch.float32))
    assert got.shape == (4, k, 256) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-4, rtol=0)


def test_augment_fused_layer_params_serves_the_prepared_operands():
    """The operands cached at construction are the ones a forward gets, for
    the dtype they were prepared in; another dtype is prepared afresh."""
    tparams = from_jax_params(
        {n: np.asarray(v) for n, v in jlg.init_lightglue_params(seed=1).items()})
    aug = port_lg.augment_fused_layer_params(tparams, torch.bfloat16)
    for kind, prep in (("self_attn", port_lg.prep_self_weights),
                       ("cross_attn", port_lg.prep_cross_weights)):
        prefix = f"transformers.8.{kind}"
        cached = prep(aug, prefix, torch.bfloat16)
        assert cached is aug[f"{prefix}.__fused"] and cached[0].dtype == torch.bfloat16
        fresh = prep(aug, prefix, torch.float32)
        assert fresh[0].dtype == torch.float32
        for a, b in zip(cached, prep(tparams, prefix, torch.bfloat16)):
            assert torch.equal(a, b)
    assert port_lg.augment_fused_layer_params({"x": torch.zeros(1)}).keys() == {"x"}


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_gather_normalize_plain_matches_pallas(dtype):
    """(2, 12*16, 256) grids, 64 cells per image with repeats and both
    corners, against the Pallas gather in interpret mode (one image per
    call there); atol 1e-6, unit rows."""
    rng = np.random.default_rng(0)
    grid = rng.standard_normal((2, 12, 16, 256)).astype(np.float32)
    cells = rng.integers(0, 12 * 16, size=(2, 64))
    cells[:, :4] = [0, 0, 191, 191]
    tgrid = torch.from_numpy(grid).reshape(2, 192, 256)
    if dtype == "bfloat16":
        tgrid = tgrid.to(torch.bfloat16)
        grid = tgrid.float().numpy().reshape(grid.shape)
    ref = np.stack([
        np.asarray(pallas_gather(jnp.asarray(grid[i]), jnp.asarray(cells[i], jnp.int32), interpret=True))
        for i in range(2)
    ])
    got = gather_normalize(tgrid, torch.from_numpy(cells)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-6)


@pytest.mark.parametrize(
    "which",
    ["conv", "conv_pair", "conv3x3", "nms", "attention", "attention_backward",
     "fused_self_block", "fused_cross_block", "gather"],
)
def test_wrappers_do_not_fall_back_off_cpu(which):
    """Only a CPU tensor takes the plain version; any other device launches
    the kernel or raises (here: the meta device raises)."""
    meta = torch.device("meta")
    with pytest.raises(ValueError):
        if which == "conv":
            w = torch.empty(64, 64, 3, 3, device=meta)
            bias = torch.empty(64, device=meta)
            conv_pair_pool(torch.empty(1, 64, 8, 8, device=meta), w, bias, w, bias)
        elif which == "conv_pair":
            w = torch.empty(64, 64, 3, 3, device=meta)
            bias = torch.empty(64, device=meta)
            conv_pair(torch.empty(1, 64, 8, 8, device=meta), w, bias, w, bias)
        elif which == "conv3x3":
            conv3x3(
                torch.empty(1, 64, 8, 8, device=meta),
                torch.empty(64, 64, 3, 3, device=meta),
                torch.empty(64, device=meta),
            )
        elif which == "nms":
            nms_suppress(torch.empty(1, 8, 8, device=meta))
        elif which == "attention":
            t = torch.empty(1, 4, 8, 64, device=meta)
            masked_attention(t, t, t, torch.ones(1, 8, dtype=torch.bool, device=meta))
        elif which == "attention_backward":
            t = torch.empty(1, 4, 8, 64, device=meta)
            mask = torch.ones(1, 8, dtype=torch.bool, device=meta)
            masked_attention_backward(t, t, t, mask, t, t, None)
        elif which == "gather":
            gather_normalize(
                torch.empty(1, 16, 256, device=meta),
                torch.zeros(1, 4, dtype=torch.int64, device=meta),
            )
        else:
            x = torch.empty(2, 8, 256, device=meta)
            mask = torch.ones(2, 8, dtype=torch.bool, device=meta)
            angle = torch.empty(2, 8, 32, device=meta)
            if which == "fused_self_block":
                port_lg.fused_self_block(x, angle, angle, mask, [])
            else:
                port_lg.fused_cross_block(x, mask, [])

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
    conv_pair_chw,
    hpool_canvas,
    to_canvas,
)
from superslam_tpu.ops.pallas.nms import nms_suppress as pallas_nms
from superslam_tpu_torch.ops.cuda.attention import masked_attention
from superslam_tpu_torch.ops.cuda.conv import conv_pair_pool
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


@pytest.mark.parametrize("which", ["conv", "nms", "attention"])
def test_wrappers_do_not_fall_back_off_cpu(which):
    """Only a CPU tensor takes the plain version; any other device launches
    the kernel or raises (here: the meta device raises)."""
    meta = torch.device("meta")
    with pytest.raises(ValueError):
        if which == "conv":
            w = torch.empty(64, 64, 3, 3, device=meta)
            bias = torch.empty(64, device=meta)
            conv_pair_pool(torch.empty(1, 64, 8, 8, device=meta), w, bias, w, bias)
        elif which == "nms":
            nms_suppress(torch.empty(1, 8, 8, device=meta))
        else:
            t = torch.empty(1, 4, 8, 64, device=meta)
            masked_attention(t, t, t, torch.ones(1, 8, dtype=torch.bool, device=meta))

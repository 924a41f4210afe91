"""The port's SuperPoint and LightGlue against the JAX package's, in f32 on
the CPU (the JAX side on its XLA route or, for the fused layer route and
the kernel gather, its Pallas kernels in interpret mode; the port on its
plain versions), with the same parameters carried over by from_jax_params."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from superslam_tpu.models import lightglue as jlg
from superslam_tpu.models import superpoint as jsp
from superslam_tpu.models.weights import load_safetensors as jax_load
from superslam_tpu_torch.models import lightglue as tlg
from superslam_tpu_torch.models import superpoint as tsp
from superslam_tpu_torch.models.weights import (
    from_jax_params,
    load_safetensors,
    save_params,
    to_jax_params,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _dense_inputs():
    """The JAX package's init(0) parameters in both layouts and a (2, 64,
    160) image."""
    jparams = jsp.init_superpoint_params(0)
    tparams = from_jax_params({k: np.asarray(v) for k, v in jparams.items()})
    img = np.random.default_rng(0).uniform(0, 1, (2, 64, 160)).astype(np.float32)
    return jparams, tparams, img


@pytest.fixture(scope="module")
def dense_pair():
    """Both packages' dense SuperPoint heads on the same (2, 64, 160) image."""
    jparams, tparams, img = _dense_inputs()
    jout = jsp.superpoint_dense(
        jparams, jnp.asarray(img), compute_dtype=jnp.float32,
        use_pallas_convs=False, return_pre_nms=True,
    )
    tout = tsp.superpoint_dense(
        tparams, torch.from_numpy(img), compute_dtype=torch.float32, return_pre_nms=True
    )
    return [np.asarray(a) for a in jout], [t.numpy() for t in tout]


def test_superpoint_dense_matches_jax(dense_pair):
    """Scores and descriptors atol 1e-4 (f32 convs in another summation
    order); the NMS'd peak set is identical."""
    (js, jd, jpre), (ts, td, tpre) = dense_pair
    assert ts.shape == js.shape == (2, 64, 160) and td.shape == jd.shape == (2, 8, 20, 256)
    np.testing.assert_allclose(tpre, jpre, atol=1e-4, rtol=0)
    np.testing.assert_allclose(ts, js, atol=1e-4, rtol=0)
    np.testing.assert_allclose(td, jd, atol=1e-4, rtol=0)
    np.testing.assert_array_equal(ts > 0, js > 0)


def test_prepared_superpoint_params_leave_dense_unchanged(dense_pair):
    """prepare_superpoint_params adds each conv pair's kernel operands (the
    OIHW weights laid out as the kernel reads them); on the CPU
    superpoint_dense reads the OIHW weights, so its outputs are the same
    bits as without them, and still match the JAX package (atol 1e-4)."""
    (js, jd, jpre), port = dense_pair
    _, tparams, img = _dense_inputs()
    ready = tsp.prepare_superpoint_params(tparams, "cpu")
    assert set(ready) - set(tparams) == {"conv1.__kernel", "conv2.__kernel"}
    assert set(tsp.prepare_superpoint_params(ready, "cpu")) == set(ready)
    got = tsp.superpoint_dense(
        ready, torch.from_numpy(img), compute_dtype=torch.float32, return_pre_nms=True
    )
    for g, t, j in zip(got, port, (js, jd, jpre)):
        np.testing.assert_array_equal(g.numpy(), t)
        np.testing.assert_allclose(g.numpy(), j, atol=1e-4, rtol=0)
    # conv1a f32 (64, 9); conv1b, conv2a, conv2b bf16 (tap, co, ci); f32 biases.
    (wa1, ba1, wb1, bb1), (wa2, _, wb2, _) = ready["conv1.__kernel"], ready["conv2.__kernel"]
    assert torch.equal(wa1, tparams["conv1a.weight"].reshape(64, 9))
    assert ba1.dtype == bb1.dtype == torch.float32 and torch.equal(bb1, tparams["conv1b.bias"])
    for name, wk in (("conv1b", wb1), ("conv2a", wa2), ("conv2b", wb2)):
        assert wk.shape == (9, 64, 64) and wk.dtype == torch.bfloat16 and wk.is_contiguous()
        oihw = tparams[f"{name}.weight"].to(torch.bfloat16)
        for tap in range(9):
            assert torch.equal(wk[tap], oihw[:, :, tap // 3, tap % 3])


def test_prepared_superpoint_operands_are_not_saved(tmp_path):
    """The derived kernel operands are left out by save_params and
    to_jax_params: a prepared dict saves and converts as the raw one."""
    params = tsp.init_superpoint_params(0)
    ready = tsp.prepare_superpoint_params(params, "cpu")
    path = str(tmp_path / "sp.safetensors")
    save_params(ready, path)
    assert load_safetensors(path).keys() == params.keys()
    assert to_jax_params(ready).keys() == params.keys()


def test_select_keypoints_matches_jax(dense_pair):
    """Same dense inputs into both selections: identical indices and valid
    mask, sub-pixel keypoints atol 1e-5, descriptors atol 1e-6."""
    (js, jd, jpre), _ = dense_pair
    kw = dict(max_keypoints=96, keypoint_threshold=0.005, remove_borders=4,
              true_width=150, true_height=60)
    js, jd, jpre = (np.array(a) for a in (js, jd, jpre))  # writable copies
    jk, jsc, jv, jdd = (np.asarray(a) for a in jsp.select_keypoints(
        jnp.asarray(js), jnp.asarray(jd), raw_scores=jnp.asarray(jpre), **kw))
    tk, tsc, tv, tdd = (t.numpy() for t in tsp.select_keypoints(
        torch.from_numpy(js), torch.from_numpy(jd), raw_scores=torch.from_numpy(jpre), **kw))
    assert jv.sum() > 20  # a real selection, not an all-padding one
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tsc, jsc)
    np.testing.assert_array_equal(np.round(tk), np.round(np.asarray(jk)))
    np.testing.assert_allclose(tk, jk, atol=1e-5, rtol=0)
    np.testing.assert_allclose(tdd, jdd, atol=1e-6, rtol=0)


def _lightglue_inputs(k):
    """Set 1 is a noisy permutation of set 0 (positions and descriptors),
    with ragged validity masks."""
    rng = np.random.default_rng(2)
    b = 2
    perm = rng.permutation(k)
    k0 = rng.uniform(-1, 1, (b, k, 2))
    k1 = np.clip(k0[:, perm] + rng.normal(0, 0.01, (b, k, 2)), -1, 1)
    d0 = rng.standard_normal((b, k, 256))
    d1 = d0[:, perm] + 0.2 * rng.standard_normal((b, k, 256))
    d0 /= np.linalg.norm(d0, axis=-1, keepdims=True)
    d1 /= np.linalg.norm(d1, axis=-1, keepdims=True)
    m0 = np.arange(k)[None] < np.array([[50], [k]])
    m1 = np.arange(k)[None] < np.array([[41], [k - 3]])
    f32 = [a.astype(np.float32) for a in (k0, d0, k1, d1)]
    return [f32[0], f32[1], f32[2], f32[3], m0, m1]


def test_lightglue_forward_matches_jax():
    """K=64, 9 layers, the committed lightglue_synth weights, f32 on both
    sides, both on the unfused route (fused=False). atol 1e-3 on the valid pairs with log P > -50
    (the entries a match decision can read); rtol 1e-5 on the rest, whose
    f32 rounding through the 9 layers scales with the logit's magnitude
    (~800 on valid pairs, -1e9 on masked ones)."""
    path = os.path.join(REPO, "weights", "lightglue_synth.safetensors")
    jparams = jax_load(path)
    tparams = from_jax_params({k: np.asarray(v) for k, v in jparams.items()})
    ins = _lightglue_inputs(64)
    ref = np.asarray(jlg.lightglue_forward(
        jparams, *(jnp.asarray(a) for a in ins), compute_dtype=jnp.float32, fused=False))
    got = tlg.lightglue_forward(
        tparams, *(torch.from_numpy(a) for a in ins), compute_dtype=torch.float32,
        fused=False).numpy()
    both = ins[4][:, :, None] & ins[5][:, None, :]
    near = both & (ref > -50)
    assert near.sum() > 50
    np.testing.assert_allclose(got[near], ref[near], atol=1e-3, rtol=0)
    np.testing.assert_allclose(got, ref, atol=1e-3, rtol=1e-5)

    jm, js = jlg.extract_matches(jnp.asarray(ref), jnp.asarray(ins[4]), jnp.asarray(ins[5]))
    tm, ts = tlg.extract_matches(torch.from_numpy(ref), torch.from_numpy(ins[4]),
                                 torch.from_numpy(ins[5]))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6, atol=0)  # exp ulps
    assert (tm.numpy() >= 0).sum() > 20


def _padded_inputs(n0, n1, pad_to):
    """tests/test_lightglue.py's fused-route case: random unit descriptors,
    n0 / n1 real keypoints, both sets zero-padded to pad_to with masks."""
    rng = np.random.default_rng(5)
    k0 = rng.uniform(-1, 1, (1, n0, 2)).astype(np.float32)
    k1 = rng.uniform(-1, 1, (1, n1, 2)).astype(np.float32)
    d0 = rng.standard_normal((1, n0, 256)).astype(np.float32)
    d1 = rng.standard_normal((1, n1, 256)).astype(np.float32)
    d0 /= np.linalg.norm(d0, axis=-1, keepdims=True)
    d1 /= np.linalg.norm(d1, axis=-1, keepdims=True)

    def pad(a, n):
        return np.pad(a, [(0, 0), (0, pad_to - n)] + [(0, 0)] * (a.ndim - 2))

    m0, m1 = np.ones((1, n0), bool), np.ones((1, n1), bool)
    return [pad(k0, n0), pad(d0, n0), pad(k1, n1), pad(d1, n1), pad(m0, n0), pad(m1, n1)]


@pytest.mark.parametrize("pad_to", [48, 44])
def test_lightglue_forward_fused_matches_jax_fused(monkeypatch, pad_to):
    """40 / 36 keypoints padded to 48 (and to 44, not a multiple of 8),
    random-init weights, f32: the port's fused layer route (plain blocks on
    the CPU) against the JAX package under SUPERSLAM_PALLAS_LG=1 (its
    Pallas blocks in interpret mode, K padded to 128 there; the port takes
    K as it is). On the valid 40 x 36 block: |exp diff| < 1e-3 and the same
    row argmax on >= 0.99 of the rows."""
    jparams = jlg.init_lightglue_params(seed=0)
    tparams = from_jax_params({k: np.asarray(v) for k, v in jparams.items()})
    ins = _padded_inputs(40, 36, pad_to)
    monkeypatch.setenv("SUPERSLAM_PALLAS_LG", "1")
    ref = np.asarray(jlg.lightglue_forward(
        jparams, *(jnp.asarray(a) for a in ins), compute_dtype=jnp.float32))
    got = tlg.lightglue_forward(
        tparams, *(torch.from_numpy(a) for a in ins), compute_dtype=torch.float32,
        fused=True).numpy()
    assert got.shape == ref.shape == (1, pad_to, pad_to)
    v, g = ref[:, :40, :36], got[:, :40, :36]
    assert np.abs(np.exp(v) - np.exp(g)).max() < 1e-3
    assert (np.argmax(v, axis=2) == np.argmax(g, axis=2)).mean() >= 0.99


@pytest.mark.parametrize(
    "env,fused,want",
    [
        ({}, None, True),
        ({"SUPERSLAM_PALLAS_LG": "0"}, None, False),
        ({"SUPERSLAM_PALLAS_LG": "false"}, None, False),
        ({"SUPERSLAM_PALLAS_LG": ""}, None, False),
        ({"SUPERSLAM_PALLAS_ATTN": "0"}, None, False),
        ({"SUPERSLAM_PALLAS_ATTN": "0", "SUPERSLAM_PALLAS_LG": "1"}, None, True),
        ({"SUPERSLAM_PALLAS_LG": "0"}, True, True),
        ({}, False, False),
    ],
)
def test_lightglue_route_selection(monkeypatch, env, fused, want):
    """The default route is fused on every device; SUPERSLAM_PALLAS_LG and
    SUPERSLAM_PALLAS_ATTN select as in the JAX package; an explicit
    argument wins. Counted by the calls that reach the fused blocks."""
    for name in ("SUPERSLAM_PALLAS_LG", "SUPERSLAM_PALLAS_ATTN"):
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    calls = []
    real = tlg.fused_self_block
    monkeypatch.setattr(
        tlg, "fused_self_block", lambda *a: (calls.append(1), real(*a))[1])
    tparams = tlg.init_lightglue_params(seed=0)
    ins = [torch.from_numpy(a) for a in _padded_inputs(6, 5, 8)]
    out = tlg.lightglue_forward(tparams, *ins, fused=fused)
    assert out.shape == (1, 8, 8) and torch.isfinite(out[:, :6, :5]).all()
    assert len(calls) == (tlg.NUM_LAYERS if want else 0)


def test_select_keypoints_kernel_route_matches_jax(dense_pair, monkeypatch):
    """use_kernel=True (the plain gather on the CPU) against the JAX
    package's use_pallas=True (its Pallas gather, in interpret mode, once
    per image): the same rows within 1e-6, and the port's default route
    within 1e-6 of its kernel route."""
    (js, jd, jpre), _ = dense_pair
    kw = dict(max_keypoints=96, keypoint_threshold=0.005, remove_borders=4,
              true_width=150, true_height=60)
    js, jd = np.array(js), np.array(jd)
    import superslam_tpu.ops.pallas.gather as pallas_gather_mod

    # select_keypoints offers no interpret switch: bind it for this test.
    real = pallas_gather_mod.gather_normalize
    monkeypatch.setattr(
        pallas_gather_mod, "gather_normalize", lambda g, c: real(g, c, interpret=True))
    jv, jdd = (np.asarray(a) for a in jsp.select_keypoints(
        jnp.asarray(js), jnp.asarray(jd), use_pallas=True, **kw)[2:])
    tv, tdd = (t.numpy() for t in tsp.select_keypoints(
        torch.from_numpy(js), torch.from_numpy(jd), use_kernel=True, **kw)[2:])
    tdd_default = tsp.select_keypoints(torch.from_numpy(js), torch.from_numpy(jd), **kw)[3].numpy()
    assert jv.sum() > 20
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_allclose(tdd, jdd, atol=1e-6, rtol=0)
    np.testing.assert_allclose(tdd, tdd_default, atol=1e-6, rtol=0)


def test_extract_matches_tie_safety_matches_jax():
    """Rows 1 and 3 tie exactly on column 2: only the first row claims it
    (first-occurrence mutual argmax), in both packages."""
    p = np.full((1, 4, 4), -10.0, np.float32)
    p[0, 1, 2] = np.log(0.8)
    p[0, 3, 2] = np.log(0.8)
    m = np.ones((1, 4), bool)
    tm, _ = tlg.extract_matches(torch.from_numpy(p), torch.from_numpy(m), torch.from_numpy(m), 0.1)
    jm, _ = jlg.extract_matches(jnp.asarray(p), jnp.asarray(m), jnp.asarray(m), 0.1)
    tm = tm.numpy()
    assert tm[0, 1] == 2 and tm[0, 3] == -1
    np.testing.assert_array_equal(tm, np.asarray(jm))


def test_normalize_keypoints_matches_jax():
    k = np.random.default_rng(4).uniform(0, 300, (3, 2)).astype(np.float32)
    np.testing.assert_array_equal(
        tlg.normalize_keypoints(torch.from_numpy(k), 320, 240).numpy(),
        np.asarray(jlg.normalize_keypoints(jnp.asarray(k), 320, 240)),
    )

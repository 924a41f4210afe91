"""The port's SuperPoint pretraining (procedural shapes, sprite-world
renders, the training forward, the losses in their three batch forms, the
Adam step, the detector evaluation, the script) against the JAX package's,
on the CPU at small sizes. Inputs come from numpy with a seed and go
through both packages.

Tolerances: the data generators give the same bytes; superpoint_raw's
logits within 1e-5 of their largest and its descriptors within 1e-6 (one
f32 network, two summation orders); the discrete targets exactly (their
counts are printed: a border cell could flip on the last bit of an f32
inverse, and none does on these seeds); sp_loss and its aux within 1e-5
relative and its gradients within 1e-3 of each tensor's largest (1e-5
once the images are dithered: see test_sp_loss_and_gradient_match_jax); three
Adam steps' losses within 1e-4 relative, and their parameters as
test_torch_training.py holds the matcher's (Adam turns a gradient below
f32 noise into a full-size step of either sign); the detector's P/R/F1 on
the committed checkpoint within 0.02 (bf16 extraction in both packages:
a keypoint near the threshold can flip)."""

import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from superslam_tpu.models import superpoint as jsp
from superslam_tpu.models.weights import load_params as jax_load_params
from superslam_tpu.train import render_domain as jrender
from superslam_tpu.train import superpoint_train as jst
from superslam_tpu.train import synthetic_shapes as jss
from superslam_tpu_torch.models import superpoint as tsp
from superslam_tpu_torch.models.weights import (
    from_jax_params,
    load_safetensors,
    to_jax_params,
)
from superslam_tpu_torch.train import render_domain as trender
from superslam_tpu_torch.train import superpoint_train as tst
from superslam_tpu_torch.train import synthetic_shapes as tss

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SP_FILE = os.path.join(REPO, "weights", "superpoint_render.safetensors")
H, W = 96, 128  # the smallest multiple of 32 the shape generator fits


@pytest.fixture(autouse=True)
def few_torch_threads():
    """The suite runs in several worker processes on one host: two torch
    threads each (as tests/test_torch_training.py); restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _equal_dicts(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for k in a:
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("which", ["render_shapes", "training_batch", "compact_pair"])
def test_synthetic_shapes_give_the_same_bytes(which):
    def run(mod):
        rng = np.random.default_rng(21)
        if which == "render_shapes":
            img, corners = mod.render_shapes(rng, H, W)
            return {"img": img, "corners": corners}
        if which == "training_batch":
            return mod.training_batch(rng, 2, H, W)
        return mod.compact_pair(rng, H, W)

    _equal_dicts(run(tss), run(jss))


@pytest.fixture(scope="module")
def sources():
    """One RenderDomainSource per package from one seed (2 worlds, 48x64)."""
    return (
        jrender.RenderDomainSource(np.random.default_rng(4), 48, 64, fx=64.0, n_worlds=2),
        trender.RenderDomainSource(np.random.default_rng(4), 48, 64, fx=64.0, n_worlds=2),
    )


@pytest.mark.parametrize("which", ["two_view_compact", "compact_pair", "labeled_image"])
def test_render_domain_source_gives_the_same_bytes(sources, which):
    jsrc, tsrc = sources

    def run(src):
        out = getattr(src, which)(np.random.default_rng(8))
        return out if isinstance(out, dict) else {"img": out[0], "corners": out[1]}

    got, ref = run(tsrc), run(jsrc)
    _equal_dicts(got, ref)
    if which == "two_view_compact":
        assert (ref["corr_pts"][:, 0] > -1e5).sum() > 0  # some cells correspond


def _params(seed=3):
    jparams = jsp.init_superpoint_params(seed)
    return jparams, from_jax_params({k: np.asarray(v) for k, v in jparams.items()})


def test_superpoint_raw_matches_jax():
    """32x48 f32, two images: the JAX package's NHWC layouts."""
    jparams, tparams = _params()
    x = np.random.default_rng(0).uniform(0, 1, (2, 32, 48)).astype(np.float32)
    jl, jd = jsp.superpoint_raw(jparams, jnp.asarray(x))
    tl, td = tsp.superpoint_raw(tparams, torch.from_numpy(x))
    assert tl.shape == (2, 4, 6, 65) and td.shape == (2, 4, 6, 256)
    assert tl.dtype == td.dtype == torch.float32
    jl, jd = np.asarray(jl), np.asarray(jd)
    np.testing.assert_allclose(tl.detach().numpy(), jl, atol=1e-5 * np.abs(jl).max(), rtol=0)
    np.testing.assert_allclose(td.detach().numpy(), jd, atol=1e-6, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(td.detach().numpy(), axis=-1), 1.0, atol=1e-5)


def test_pair_targets_from_h_matches_jax():
    """Four sampled homographies at 96x128 (192 cells): corr and valid1
    equal, their counts printed."""
    rng = np.random.default_rng(5)
    hs = np.stack([jss.sample_homography(rng, H, W) for _ in range(4)]).astype(np.float32)
    jc, jv = jst.pair_targets_from_h(jnp.asarray(hs), H, W)
    tc, tv = tst.pair_targets_from_h(torch.from_numpy(hs), H, W)
    jc, jv = np.asarray(jc), np.asarray(jv)
    print(f"corr {int(jc.sum())} / {int(tc.sum())}, valid1 {int(jv.sum())} / {int(tv.sum())}")
    assert tc.shape == (4, 192, 192) and tv.shape == (4, 12, 16)
    assert 0 < jc.sum() and 0 < jv.sum() < jv.size
    np.testing.assert_array_equal(tc.numpy(), jc)
    np.testing.assert_array_equal(tv.numpy(), jv)
    # The device derivation equals the host's targets of the same pair.
    pair = tss.training_pair(np.random.default_rng(6), H, W)
    c, _ = tst.pair_targets_from_h(torch.from_numpy(pair["H"])[None], H, W)
    np.testing.assert_array_equal(c[0].numpy(), pair["corr"])


def test_pair_targets_from_points_matches_jax(sources):
    jsrc, _ = sources
    rng = np.random.default_rng(9)
    pts = np.stack([jsrc.two_view_compact(rng)["corr_pts"] for _ in range(2)])
    ref = jst.pair_targets_from_points(jnp.asarray(pts), 48, 64)
    got = tst.pair_targets_from_points(torch.from_numpy(pts), 48, 64)
    for g, r in zip(got, ref):
        print(f"count {int(np.asarray(r).sum())}")
        assert np.asarray(r).sum() > 0
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def _batch(form: str) -> dict[str, np.ndarray]:
    """Two samples of one of sp_loss's batch forms."""
    if form == "corr":
        return jss.training_batch(np.random.default_rng(1), 2, H, W)
    if form == "H":
        samples = [jss.compact_pair(np.random.default_rng(s), H, W) for s in (2, 3)]
    else:
        src = jrender.RenderDomainSource(np.random.default_rng(4), H, W, fx=96.0, n_worlds=1)
        rng = np.random.default_rng(12)
        samples = [src.two_view_compact(rng) for _ in range(2)]
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


def _dithered(b: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """The uint8 images as f32 with +-1e-4 of uniform noise: no 2x2 pooling
    window of the network holds two values within an f32 rounding."""
    rng = np.random.default_rng(0)
    out = dict(b)
    for k in ("img0", "img1"):
        out[k] = (b[k] / 255.0 + rng.uniform(-1e-4, 1e-4, b[k].shape)).astype(np.float32)
    return out


@pytest.mark.parametrize("form", ["corr", "H", "corr_pts", "H_dithered"])
def test_sp_loss_and_gradient_match_jax(form):
    """The loss and its aux in each batch form, and the gradient of every
    parameter against jax.grad. The images are uint8 (/255): their flat
    regions give 2x2 pooling windows whose largest values lie within an
    f32 rounding of each other, and a summation order decides which one
    takes the gradient, so the gradient holds within 1e-3 of each tensor's
    largest (chip_smoke's limit on the card); dithered by 1e-4 the windows
    have no near-ties and it holds within 1e-5."""
    import jax

    jparams, tparams = _params()
    b = _batch(form.removesuffix("_dithered"))
    if form == "H_dithered":
        b = _dithered(b)
    jl, ja = jst.sp_loss(jparams, {k: jnp.asarray(v) for k, v in b.items()})
    for p in tparams.values():
        p.requires_grad_(True)
    tl, ta = tst.sp_loss(tparams, {k: torch.from_numpy(v) for k, v in b.items()})
    assert ta.keys() == ja.keys() == {"ce0", "ce1", "desc", "hard"}
    for k in ja:
        got, ref = float(ta[k].detach()), float(ja[k])
        assert abs(got - ref) <= 1e-5 * max(abs(ref), 1e-3), (k, got, ref)
    assert (float(ja["hard"]) > 0) == (form == "corr_pts")
    assert abs(float(tl.detach()) - float(jl)) <= 1e-5 * abs(float(jl))
    tl.backward()
    grads = to_jax_params({k: p.grad for k, p in tparams.items()})
    ref = jax.grad(lambda p: jst.sp_loss(p, {k: jnp.asarray(v) for k, v in b.items()})[0])(jparams)
    tol = 1e-5 if form == "H_dithered" else 1e-3
    worst = max(np.abs(g - np.asarray(ref[k])).max() / np.abs(np.asarray(ref[k])).max()
                for k, g in grads.items())
    print(f"{form}: worst gradient error / max {worst:.3g}")
    assert worst <= tol


def test_three_sp_train_steps_match_jax():
    """Three Adam steps at lr 1e-3 on one wire-format batch (dithered, so
    that pooling near-ties do not route gradients apart): the losses within
    1e-4 relative; at least 99.99% of parameter elements within 1e-5, none
    further than Adam's 2 * lr a step."""
    lr, steps = 1e-3, 3
    jparams, tparams = _params()
    b = _dithered(_batch("H"))
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    tx = jst.make_sp_optimizer(lr)
    opt_state = tx.init(jparams)
    optimizer = tst.make_sp_optimizer(tparams, lr)
    for _ in range(steps):
        jparams, opt_state, jloss, jaux = jst.sp_train_step(jparams, opt_state, jb, tx)
        tloss, taux = tst.sp_train_step(tparams, optimizer, tb)
        assert tloss.grad_fn is None and taux["desc"].grad_fn is None
        assert abs(float(tloss) - float(jloss)) <= 1e-4 * abs(float(jloss))
    got = to_jax_params(tparams)
    total = far = 0
    for k in got:
        diff = np.abs(got[k] - np.asarray(jparams[k]))
        assert diff.max() <= 2 * lr * steps * 1.01, k
        total += diff.size
        far += int((diff > 1e-5).sum())
    print(f"{far} of {total} elements more than 1e-5 apart")
    assert far <= 1e-4 * total, (far, total)


def test_sp_optimizer_is_optax_adam():
    opt = tst.make_sp_optimizer({"w": torch.zeros(3)}, 2e-3)
    assert isinstance(opt, torch.optim.Adam)
    group = opt.param_groups[0]
    assert group["lr"] == 2e-3 and group["betas"] == (0.9, 0.999) and group["eps"] == 1e-8


def test_evaluate_detector_matches_jax():
    """Two 120x160 shape images through the committed checkpoint, the
    production extraction (bf16) in both packages."""
    jparams = jax_load_params(SP_FILE, lambda: pytest.fail("checkpoint not found"))
    tparams = load_safetensors(SP_FILE)
    ref = jst.evaluate_detector(jparams, np.random.default_rng(3), n_images=2)
    got = tst.evaluate_detector(tparams, np.random.default_rng(3), n_images=2)
    print(json.dumps({"port": got, "jax": ref}))
    assert got.keys() == ref.keys()
    assert ref["f1"] > 0.3
    for k in ("precision", "recall", "f1", "desc_margin"):
        assert abs(got[k] - ref[k]) <= 0.02, (k, got[k], ref[k])


def test_detection_prf_matches_jax():
    rng = np.random.default_rng(1)
    det, gt = rng.uniform(0, 50, (30, 2)), rng.uniform(0, 50, (20, 2))
    assert tst.detection_prf(det, gt) == jst.detection_prf(det, gt)
    assert tst.detection_prf(det[:0], gt) == (0.0, 0.0, 0.0)


def test_train_superpoint_script_on_cpu(tmp_path):
    """The script at a tiny size on the CPU, shapes and renders: finite
    losses, the metadata beside the checkpoint, and the checkpoint read by
    the JAX package's loader into the parameters the port wrote (fp16)."""
    from scripts import train_superpoint_torch as script

    out = str(tmp_path / "sp.safetensors")
    meta = script.main([
        "--device", "cpu", "--steps", "2", "--batch", "2", "--height", str(H),
        "--width", str(W), "--pool", "4", "--eval-every", "2", "--render-frac", "0.5",
        "--render-pool", "2", "--render-height", "48", "--render-width", "64",
        "--render-batch", "2", "--out", out,
    ])
    assert len(meta["losses"]) == 2 and np.all(np.isfinite(meta["losses"]))
    assert meta["evals"] and set(meta["evals"][0]) == {"step", "eval", "render_eval", "match"}
    with open(out + ".json") as f:
        assert json.load(f)["image"] == [H, W]
    port = load_safetensors(out)
    loaded = jax_load_params(out, lambda: pytest.fail("checkpoint not found"))
    want = to_jax_params(port)
    assert loaded.keys() == want.keys() == set(tsp.init_superpoint_params(0))
    for k in want:
        np.testing.assert_array_equal(np.asarray(loaded[k], np.float32), want[k], err_msg=k)


def test_train_superpoint_script_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default would train on it")
    from scripts import train_superpoint_torch as script

    with pytest.raises(RuntimeError, match="device='cpu'"):
        script.main(["--steps", "1", "--pool", "1"])

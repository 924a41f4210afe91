"""The port's matcher training (attention backward, loss, optimizer step,
schedule, harvest, checkpoints) against the JAX package's, on the CPU at
small sizes. Inputs come from numpy with a seed and go through both
packages; the JAX side runs as its own tests run it (the XLA attention
route on the CPU, the Pallas attention in interpret mode where named).

Tolerances: attention gradients atol 1e-4 against jax.grad through the
Pallas forward (the limit of tests/test_pallas_attention.py) and 1e-5
against torch autograd through the plain forward (one f32 formula in two
summation orders); the loss within 1e-5 from equal parameters; three AdamW
steps at lr 3e-4 as test_three_train_steps_match_jax states (Adam turns a
gradient below f32 noise into a full-size step of either sign)."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from superslam_tpu.eval import synthetic_sequence as jsynth
from superslam_tpu.geometry import Pose3 as JPose3, StereoCalib as JStereoCalib
from superslam_tpu.models import lightglue as jlg
from superslam_tpu.models import superpoint as jsp
from superslam_tpu.models.weights import load_params as jax_load_params
from superslam_tpu.ops.pallas.attention import masked_attention as pallas_attention
from superslam_tpu.parallel import training as jtrain
from superslam_tpu.train import render_domain as jrender
from superslam_tpu_torch.eval import synthetic_sequence as tsynth
from superslam_tpu_torch.geometry import Pose3, StereoCalib
from superslam_tpu_torch.models import lightglue as tlg
from superslam_tpu_torch.models import superpoint as tsp
from superslam_tpu_torch.models.weights import (
    from_jax_params,
    load_safetensors,
    save_params,
    to_jax_params,
)
from superslam_tpu_torch.ops.cuda import lightglue_layer as port_lg
from superslam_tpu_torch.ops.cuda.attention import (
    masked_attention,
    masked_attention_backward,
    masked_attention_backward_plain,
    masked_attention_plain,
    masked_attention_with_stats,
)
from superslam_tpu_torch.parallel import training as ttrain
from superslam_tpu_torch.train import render_domain as trender


@pytest.fixture(autouse=True)
def few_torch_threads():
    """The suite runs in several worker processes on one host. torch's
    default of one thread per core in each of them oversubscribes it, and
    tests made of thousands of tiny ops (gradcheck, optimizer steps) then
    slow down a hundredfold. Two threads here; restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _qkvg(seed, shape):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(4)], rng


def test_attention_backward_plain_matches_jax_grad():
    """(1, 2, 24, 64) f32, random mask: the plain backward against jax.grad
    through the Pallas forward in interpret mode (i.e. through _sdpa_bwd)."""
    (q, k, v, w), rng = _qkvg(3, (1, 2, 24, 64))
    mask = rng.uniform(size=(1, 24)) > 0.25
    jm = jnp.asarray(mask)

    def loss(q, k, v):
        return jnp.sum(pallas_attention(q, k, v, jm, interpret=True) * jnp.asarray(w))

    ref = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    got = masked_attention_backward_plain(*(torch.from_numpy(a) for a in (q, k, v, mask, w)))
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4, rtol=0)


def test_attention_backward_matches_autograd_through_plain_forward():
    """Ragged masks and one fully-masked batch row: the backward entry point
    and the Function against torch autograd through masked_attention_plain.
    In the fully-masked row the forward is the mean of v, so dq = dk = 0."""
    (q, k, v, g), rng = _qkvg(4, (3, 2, 24, 64))
    mask = rng.uniform(size=(3, 24)) > 0.4
    mask[1] = False
    q, k, v, g, mask = (torch.from_numpy(a) for a in (q, k, v, g, mask))

    plain = [t.clone().requires_grad_() for t in (q, k, v)]
    masked_attention_plain(*plain, mask).backward(g)
    got = masked_attention_backward(q, k, v, mask, g, *masked_attention_with_stats(q, k, v, mask))
    for a, leaf in zip(got, plain):
        np.testing.assert_allclose(a.numpy(), leaf.grad.numpy(), atol=1e-5, rtol=0)
    assert got[0][1].abs().max() == 0 and got[1][1].abs().max() == 0
    assert got[2][1].abs().max() > 0

    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = masked_attention(*leaves, mask)
    assert out.grad_fn is not None
    out.backward(g)
    for leaf, want in zip(leaves, plain):
        np.testing.assert_allclose(leaf.grad.numpy(), want.grad.numpy(), atol=1e-5, rtol=0)
    with torch.no_grad():
        assert masked_attention(*leaves, mask).grad_fn is None


def test_attention_function_gradcheck_f64():
    (q, k, v, _), rng = _qkvg(5, (2, 2, 6, 64))
    mask = torch.from_numpy(rng.uniform(size=(2, 6)) > 0.3)
    mask[0, 0] = True
    leaves = [torch.from_numpy(a).double().requires_grad_() for a in (q, k, v)]
    assert torch.autograd.gradcheck(masked_attention, (*leaves, mask), eps=1e-6, atol=1e-6)


def _both_params(seed):
    jparams = jlg.init_lightglue_params(seed)
    tparams = tlg.init_lightglue_params(seed)
    return jparams, tparams


def _batches(seed, b, k):
    batch = jtrain.synthetic_matching_batch(np.random.default_rng(seed), b, k)
    return (
        {n: jnp.asarray(a) for n, a in batch.items()},
        {n: torch.from_numpy(a) for n, a in batch.items()},
    )


def test_synthetic_matching_batch_is_the_same_numpy():
    a = jtrain.synthetic_matching_batch(np.random.default_rng(9), 2, 24)
    b = ttrain.synthetic_matching_batch(np.random.default_rng(9), 2, 24)
    assert a.keys() == b.keys()
    for n in a:
        assert a[n].dtype == b[n].dtype
        np.testing.assert_array_equal(a[n], b[n])


_KEYS = ("kpts0", "desc0", "kpts1", "desc1", "mask0", "mask1", "gt_indices")


def test_matching_loss_matches_jax():
    jparams, tparams = _both_params(1)
    jb, tb = _batches(5, 2, 24)
    # Unmatched rows as well: drop some ground truth.
    gt = np.asarray(jb["gt_indices"]).copy()
    gt[:, ::5] = -1
    jb["gt_indices"], tb["gt_indices"] = jnp.asarray(gt), torch.from_numpy(gt)
    ref = float(jtrain.matching_loss(jparams, *(jb[n] for n in _KEYS)))
    got = float(ttrain.matching_loss(tparams, *(tb[n] for n in _KEYS)))
    assert abs(got - ref) <= 1e-5, (got, ref)


def test_unfused_route_is_differentiable_in_every_parameter_it_reads():
    """Every parameter gets a finite gradient, non-zero except where the
    forward does not read it (the assignment heads of layers 0..7)."""
    _, tparams = _both_params(2)
    for p in tparams.values():
        p.requires_grad_(True)
    _, tb = _batches(6, 2, 24)
    ttrain.matching_loss(tparams, *(tb[n] for n in _KEYS)).backward()
    for name, p in tparams.items():
        unread = name.startswith("log_assignment.") and not name.startswith("log_assignment.8.")
        if unread:
            assert p.grad is None, name
        else:
            assert p.grad is not None and torch.isfinite(p.grad).all(), name
            assert p.grad.abs().max() > 0, name


@pytest.mark.parametrize("which", ["self", "cross", "forward"])
def test_fused_route_refuses_tensors_that_require_grad(which):
    _, tparams = _both_params(2)
    x = torch.zeros(2, 8, 256)
    mask = torch.ones(2, 8, dtype=torch.bool)
    angle = torch.zeros(2, 8, 32)
    if which == "forward":
        for p in tparams.values():
            p.requires_grad_(True)
        kp, d = torch.zeros(1, 8, 2), torch.zeros(1, 8, 256)
        with pytest.raises(RuntimeError, match="inference-only"):
            tlg.lightglue_forward(tparams, kp, d, kp, d, mask[:1], mask[:1], fused=True)
        with torch.no_grad():  # inference is untouched
            tlg.lightglue_forward(tparams, kp, d, kp, d, mask[:1], mask[:1], fused=True)
        return
    x.requires_grad_(True)
    with pytest.raises(RuntimeError, match="inference-only"):
        if which == "self":
            w = port_lg.prep_self_weights(tparams, "transformers.0.self_attn", torch.float32)
            port_lg.fused_self_block(x, angle, angle, mask, w)
        else:
            w = port_lg.prep_cross_weights(tparams, "transformers.0.cross_attn", torch.float32)
            port_lg.fused_cross_block(x, mask, w)


def test_three_train_steps_match_jax():
    """Three AdamW steps at lr 3e-4 from one parameter dict on one batch,
    compared through to_jax_params.

    The first loss (same parameters) agrees within 1e-5 and the gradients
    behind it within 1e-5 of each tensor's largest. Adam then normalises
    every element: the first update is lr * g / (|g| + 1e-8), so an element
    whose gradient lies below the two packages' f32 summation noise (about
    1e-6 here) can take opposite signs and then sits 2 * lr apart. That is
    a property of Adam on f32 gradients, not of either package; measured,
    216 of 11.9 M elements end up more than 1e-5 apart. So: at least
    99.99% of all elements within 1e-5, none further apart than Adam's own
    bound of 2 * lr a step, and the later losses, which feel those
    elements, within 1e-3 of their value. The heads the loss never reads
    (zero gradient) are decayed exactly as optax decays them."""
    lr, steps = 3e-4, 3
    jparams, tparams = _both_params(1)
    jb, tb = _batches(5, 2, 24)
    start = {n: np.asarray(a).copy() for n, a in jparams.items()}
    tx = jtrain.make_optimizer(lr)
    opt_state = tx.init(jparams)
    optimizer = ttrain.make_optimizer(tparams, lr)
    for step in range(steps):
        jparams, opt_state, jloss = jtrain.train_step(jparams, opt_state, jb, tx)
        tloss = ttrain.train_step(tparams, optimizer, tb)
        tol = 1e-5 if step == 0 else 1e-3 * abs(float(jloss))
        assert abs(float(tloss) - float(jloss)) <= tol, (step, float(tloss), float(jloss))
        if step == 0:
            grads = to_jax_params({n: p.grad for n, p in tparams.items()})
            ref = jax.grad(jtrain.matching_loss)(start, *(jb[n] for n in _KEYS))
            for n, g in grads.items():
                r = np.asarray(ref[n])
                assert np.abs(g - r).max() <= 1e-4 * max(np.abs(r).max(), 1e-12), n
    got = to_jax_params(tparams)
    assert got.keys() == jparams.keys()
    total = far = 0
    for n in got:
        diff = np.abs(got[n] - np.asarray(jparams[n]))
        assert diff.max() <= 2 * lr * steps * 1.01, n
        total += diff.size
        far += int((diff > 1e-5).sum())
    assert far <= 1e-4 * total, (far, total)
    unread = "log_assignment.0.final_proj.weight"
    assert np.abs(got[unread] - start[unread]).max() > 0  # decayed
    np.testing.assert_allclose(got[unread], np.asarray(jparams[unread]), atol=1e-7, rtol=0)
    np.testing.assert_allclose(got[unread], start[unread] * (1 - lr * 1e-4) ** steps, atol=1e-7)


def test_training_converges_on_fixed_batch():
    """The twin of tests/test_parallel.py::test_training_converges_on_fixed_batch."""
    _, tparams = _both_params(1)
    _, tb = _batches(5, 2, 24)
    optimizer = ttrain.make_optimizer(tparams, 3e-4)
    losses = [float(ttrain.train_step(tparams, optimizer, tb)) for _ in range(6)]
    assert losses[-1] < losses[0] * 0.7, losses


def test_train_step_takes_a_scheduled_learning_rate():
    _, tparams = _both_params(1)
    _, tb = _batches(5, 2, 24)
    optimizer = ttrain.make_optimizer(tparams, 3e-4)
    before = tparams["input_proj.weight"].detach().clone()
    ttrain.train_step(tparams, optimizer, tb, lr=0.0)
    assert torch.equal(tparams["input_proj.weight"], before)
    assert optimizer.param_groups[0]["lr"] == 0.0


def test_cosine_schedule_matches_optax():
    kw = dict(init_value=5e-6, peak_value=5e-5, warmup_steps=30, decay_steps=300, end_value=2.5e-6)
    ref = optax.warmup_cosine_decay_schedule(**kw)
    ours = ttrain.warmup_cosine_schedule(**kw)
    for step in (0, 1, 15, 29, 30, 31, 150, 299, 300, 450):
        assert abs(ours(step) - float(ref(step))) <= 1e-6 * kw["peak_value"], step


def test_harvest_matching_pair_matches_jax(monkeypatch):
    """One world, poses and rng seed at 160x120, cap 64, f32 SuperPoint on
    both sides: the same masks and ground-truth assignment, keypoints within
    1e-3 px (normalized: / 80), descriptors within 1e-4."""
    monkeypatch.setattr(
        jsp, "superpoint_dense", functools.partial(jsp.superpoint_dense, compute_dtype=jnp.float32))
    monkeypatch.setattr(
        tsp, "superpoint_dense", functools.partial(tsp.superpoint_dense, compute_dtype=torch.float32))
    h, w, cap = 120, 160, 64
    path = "weights/superpoint_render.safetensors"
    jparams = jax_load_params(path, lambda: jsp.init_superpoint_params())
    tparams = load_safetensors(path)
    xi = np.array([0.01, -0.02, 0.015, 0.08, -0.03, 0.05])
    samples = []
    for synth, pose_t, calib_t, harvest, params, extra in (
        (jsynth, JPose3, JStereoCalib, jrender.harvest_matching_pair, jparams, {}),
        (tsynth, Pose3, StereoCalib, trender.harvest_matching_pair, tparams, {"device": "cpu"}),
    ):
        rng = np.random.default_rng(11)
        world = synth.make_room_world(rng, n_sprites=240)
        pose0 = synth.random_interior_pose(rng, yaw_jitter=0.2)
        pose1 = pose0 * pose_t.expmap(xi)
        calib = calib_t(fx=160.0, fy=160.0, cx=w / 2.0, cy=h / 2.0, baseline=0.3)
        samples.append(harvest(params, world, pose0, pose1, calib, h, w, cap, rng, **extra))
    ref, got = samples
    assert ref is not None and got is not None
    for n in ("mask0", "mask1", "gt_indices"):
        np.testing.assert_array_equal(got[n], ref[n], err_msg=n)
    assert (ref["gt_indices"] >= 0).sum() >= 8
    for n in ("kpts0", "kpts1"):
        np.testing.assert_allclose(got[n], ref[n], atol=1e-3 / 80.0, rtol=0, err_msg=n)
    for n in ("desc0", "desc1"):
        np.testing.assert_allclose(got[n], ref[n], atol=1e-4, rtol=0, err_msg=n)
    assert trender.match_prf(np.array([[0, 1], [2, 3]]), np.array([1, -1, 3])) == \
        jrender.match_prf(np.array([[0, 1], [2, 3]]), np.array([1, -1, 3])) == (1.0, 1.0)
    assert trender.mutual_nn_prf(got) == pytest.approx(jrender.mutual_nn_prf(ref))


def test_save_params_round_trips_through_the_jax_loader(tmp_path):
    """save_params -> the JAX package's load_params equals to_jax_params
    within fp16 rounding, and the port loads its own file back the same."""
    _, tparams = _both_params(4)
    aug = port_lg.augment_fused_layer_params(tparams)  # derived operands are not saved
    path = str(tmp_path / "lg.safetensors")
    save_params(aug, path)
    loaded = jax_load_params(path, lambda: pytest.fail("checkpoint not found"))
    want = to_jax_params(aug)
    assert loaded.keys() == want.keys() == {n: 0 for n in tparams}.keys()
    for n in want:
        assert loaded[n].shape == want[n].shape, n
        np.testing.assert_allclose(
            np.asarray(loaded[n]), want[n], atol=1e-3, rtol=1e-3, err_msg=n)
    back = load_safetensors(path)
    for n in tparams:
        torch.testing.assert_close(back[n], tparams[n].half().float(), rtol=0, atol=0)
    # to_jax_params is the inverse of from_jax_params.
    again = from_jax_params(want)
    for n in tparams:
        torch.testing.assert_close(again[n], tparams[n], rtol=0, atol=0)

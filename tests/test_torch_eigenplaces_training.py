"""The port's EigenPlaces training (the batch-statistics forward, the
InfoNCE loss with its angular mask, optax's clip and schedule, the BN
EMA, the script) against the JAX package's, on the CPU at small sizes.
The JAX step is a closure inside scripts/train_eigenplaces.py::main, so
the JAX side here is written from eigenplaces_descriptor_train and optax
as that closure is.

Tolerances: in f32 the descriptors within 1e-5 and every batch statistic
within 1e-4 of its tensor's largest; in bf16 (the training default) the
descriptors within 1e-2 and every batch statistic within 3e-2 of its
tensor's largest (two bf16 networks round 20 convolutions in two
summation orders; the measured worst are 1.3e-2 for a mean and 2.9e-2
for a variance, in layer4, where the drift of the activations is
largest and a variance doubles it); two f32 steps' losses within 1e-4
relative (the temperature of 0.07 scales the descriptors' f32 noise by
14) and the first clipped gradient within 1e-3 of each tensor's largest
(measured 1.6e-4); the first update on the port's own clipped gradient
within two f32 roundings of the parameter plus 2e-5 of itself of optax's
Adam at the schedule's value (torch computes Adam's bias corrections in
f64, optax in f32, where 1 - 0.999 is 0.00099998713: 6.4e-6 of the
update); after two steps the
parameters within 1e-6 for 99% of the elements (measured 99.76%: Adam
turns a gradient below f32 noise into a full step of either sign, and
ResNet18 under batch norm has many) and all within Adam's 2 * lr, the
running statistics within 1e-4 of their largest."""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from scripts import train_eigenplaces as jscript
from scripts import train_eigenplaces_torch as tscript
from superslam_tpu.eval import synthetic_sequence as jsynth
from superslam_tpu.geometry import StereoCalib as JStereoCalib
from superslam_tpu.models import eigenplaces as jep
from superslam_tpu.models.weights import load_params as jax_load_params
from superslam_tpu_torch.eval import synthetic_sequence as tsynth
from superslam_tpu_torch.geometry import StereoCalib
from superslam_tpu_torch.models import eigenplaces as tep
from superslam_tpu_torch.models.weights import from_jax_params, load_safetensors, to_jax_params
from superslam_tpu_torch.parallel.training import warmup_cosine_schedule
from superslam_tpu_torch.train.superpoint_train import make_sp_optimizer

SIZE = 64


@pytest.fixture(autouse=True)
def few_torch_threads():
    """Two torch threads per worker process (as tests/test_torch_training.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _params(seed=7):
    jparams = jep.init_eigenplaces_params(seed)
    return jparams, from_jax_params({k: np.asarray(v) for k, v in jparams.items()})


def _images(seed=11, b=4):
    """(B, SIZE, SIZE, 3) NHWC for the JAX package, (B, 3, SIZE, SIZE) for the port."""
    x = np.random.default_rng(seed).standard_normal((b, SIZE, SIZE, 3)).astype(np.float32)
    return x, torch.from_numpy(x).permute(0, 3, 1, 2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_eigenplaces_descriptor_train_matches_jax(dtype):
    jparams, tparams = _params()
    xj, xt = _images()
    ref, ref_stats = jax.jit(
        lambda p, x: jep.eigenplaces_descriptor_train(p, x, getattr(jnp, dtype))
    )(jparams, jnp.asarray(xj))
    got, stats = tep.eigenplaces_descriptor_train(tparams, xt, getattr(torch, dtype))
    assert got.shape == (4, 512) and got.dtype == torch.float32
    assert stats.keys() == ref_stats.keys() == {k for k in tparams if "running_" in k}
    bf16 = dtype == "bfloat16"
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), atol=1e-2 if bf16 else 1e-5)
    np.testing.assert_allclose(np.linalg.norm(got.detach().numpy(), axis=1), 1.0, atol=1e-4)
    worst = {}
    for k, r in ref_stats.items():
        r = np.asarray(r)
        err = np.abs(stats[k].numpy() - r).max() / np.abs(r).max()
        kind = "var" if k.endswith("running_var") else "mean"
        worst[kind] = max(worst.get(kind, 0.0), err)
        limit = 3e-2 if bf16 else 1e-4
        assert err <= limit, (k, err)
    print(f"{dtype}: worst batch statistic error / max {worst}")


def test_train_forward_matches_inference_at_batch_stats():
    """The twin of tests/test_eigenplaces.py::test_train_forward_matches_inference_at_batch_stats:
    with the running statistics set to the batch's, the inference forward
    computes the training forward."""
    _, tparams = _params()
    _, xt = _images()
    desc, stats = tep.eigenplaces_descriptor_train(tparams, xt)
    merged = {**tparams, **stats}
    np.testing.assert_allclose(
        tep.eigenplaces_descriptor(merged, xt).numpy(), desc.detach().numpy(), atol=1e-2)


def test_batch_norm_statistics_are_the_biased_ones():
    """F.batch_norm's running update would EMA the unbiased variance."""
    _, tparams = _params()
    x = torch.randn(2, 64, 5, 5)
    stats = {}
    tep._bn_batch(x, tparams, "backbone.bn1", torch.float32, stats)
    torch.testing.assert_close(stats["backbone.bn1.running_var"], x.var(dim=(0, 2, 3), unbiased=False))
    torch.testing.assert_close(stats["backbone.bn1.running_mean"], x.mean(dim=(0, 2, 3)))


@pytest.mark.parametrize("scale", [0.01, 10.0])
def test_clip_by_global_norm_matches_optax(scale):
    """Below the limit the gradients pass unchanged, above it they are
    scaled by max_norm / norm (optax's rule)."""
    rng = np.random.default_rng(3)
    grads = [np.asarray(rng.standard_normal(s) * scale, np.float32) for s in ((4, 5), (7,), ())]
    ref, _ = optax.clip_by_global_norm(1.0).update([jnp.asarray(g) for g in grads], None)
    got = [torch.from_numpy(g.copy()) for g in grads]
    tscript.clip_by_global_norm(got, 1.0)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6, atol=0)
    if scale < 1:
        assert all(np.array_equal(g.numpy(), a) for g, a in zip(got, grads))


def _step_inputs():
    """8 images of 4 places (the script's pairing), uint8 on the CPU."""
    rng = np.random.default_rng(5)
    data = rng.integers(0, 256, (8, SIZE, SIZE), dtype=np.uint8)
    idx = np.array([0, 2, 4, 6, 1, 3, 5, 7])
    theta_b = np.tile(np.array([0.0, 0.1, 2.0, 4.0], np.float32), 2)  # places 0, 1 too close
    pair_to = np.concatenate([np.arange(4) + 4, np.arange(4)])
    return data, idx, theta_b, pair_to


def _jax_step(tx, temperature, margin, momentum, dtype):
    """scripts/train_eigenplaces.py's loss_fn and train_step, written out."""
    mean, std = jnp.asarray(jep.IMAGENET_MEAN), jnp.asarray(jep.IMAGENET_STD)

    def loss_fn(params, data, idx, theta_b, pair_to):
        x = data[idx].astype(jnp.float32) / 255.0
        x = (jnp.repeat(x[..., None], 3, axis=-1) - mean) / std
        desc, stats = jep.eigenplaces_descriptor_train(params, x, dtype)
        logits = (desc @ desc.T) / temperature
        b = logits.shape[0]
        dth = jnp.abs(theta_b[:, None] - theta_b[None, :])
        dth = jnp.minimum(dth, 2 * jnp.pi - dth)
        eye = jnp.eye(b, dtype=bool)
        is_pos = jnp.zeros((b, b), bool).at[jnp.arange(b), pair_to].set(True)
        valid = is_pos | ((dth > margin) & ~eye)
        masked = jnp.where(valid, logits, -jnp.inf)
        loss = -jnp.mean(
            jnp.take_along_axis(masked, pair_to[:, None], axis=1)[:, 0]
            - jax.nn.logsumexp(masked, axis=1)
        )
        return loss, stats

    @jax.jit
    def step(params, opt, run_stats, data, idx, theta_b, pair_to):
        (loss, stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params, data, idx, theta_b, pair_to)
        upd, opt = tx.update(grads, opt, params)
        params = optax.apply_updates(params, upd)
        run_stats = {k: (1.0 - momentum) * run_stats[k] + momentum * stats[k] for k in run_stats}
        return params, opt, run_stats, loss

    return step, loss_fn


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_eigenplaces_steps_match_jax(dtype):
    """Two steps of the script's loss and optimizer (clip 1.0, Adam, the
    warm-up cosine schedule at updates 0 and 1, the BN EMA). In f32 they
    agree as the module docstring states; in bf16 (the script's default)
    the first loss within 1e-2 relative."""
    lr, steps, temperature, margin, momentum = 3e-4, 30, 0.07, 0.30, 0.1
    sched_kw = dict(init_value=lr / 10.0, peak_value=lr, warmup_steps=max(1, steps // 15),
                    decay_steps=steps, end_value=lr / 20.0)
    tx = optax.chain(optax.clip_by_global_norm(1.0),
                     optax.adam(optax.warmup_cosine_decay_schedule(**sched_kw)))
    schedule = warmup_cosine_schedule(**sched_kw)
    jinit, tinit = _params(2)
    jtrain = {k: v for k, v in jinit.items() if "running_" not in k}
    jrun = {k: v for k, v in jinit.items() if "running_" in k}
    ttrain = {k: v for k, v in tinit.items() if "running_" not in k}
    trun = {k: v.clone() for k, v in tinit.items() if "running_" in k}
    data, idx, theta_b, pair_to = _step_inputs()
    step, jloss_fn = _jax_step(tx, temperature, margin, momentum, getattr(jnp, dtype))
    opt = tx.init(jtrain)
    optimizer = make_sp_optimizer(ttrain, lr)
    jin = [jnp.asarray(a) for a in (data, idx, theta_b, pair_to)]
    tin = (tscript.batch_images(torch.from_numpy(data), torch.from_numpy(idx)),
           torch.from_numpy(theta_b), torch.from_numpy(pair_to))
    start = {k: v.copy() for k, v in to_jax_params(ttrain).items()}
    for i in range(2):
        if i == 0 and dtype == "float32":
            grads = jax.jit(jax.grad(lambda p: jloss_fn(p, *jin)[0]))(jtrain)
            clipped, _ = optax.clip_by_global_norm(1.0).update(grads, None)
        jtrain, opt, jrun, jloss = step(jtrain, opt, jrun, *jin)
        tloss = tscript.train_step(ttrain, optimizer, trun, *tin, schedule(i), temperature,
                                   margin, momentum, getattr(torch, dtype))
        assert optimizer.param_groups[0]["lr"] == schedule(i)
        print(f"{dtype} step {i}: loss {float(tloss):.7f} vs {float(jloss):.7f}")
        if dtype == "bfloat16":
            assert abs(float(tloss) - float(jloss)) <= 1e-2 * abs(float(jloss))
            return
        assert abs(float(tloss) - float(jloss)) <= 1e-4 * abs(float(jloss))
        if i == 0:
            # The clipped gradient the first update took, against optax's.
            got = to_jax_params({k: p.grad for k, p in ttrain.items()})
            worst = max(np.abs(g - np.asarray(clipped[k])).max() / np.abs(np.asarray(clipped[k])).max()
                        for k, g in got.items())
            print(f"clipped gradient: worst error / max {worst:.3g}")
            assert worst <= 1e-3
            # The update on that gradient, against optax's Adam at the
            # schedule's first value (no gradient noise in between).
            adam = optax.adam(optax.warmup_cosine_decay_schedule(**sched_kw))
            want, _ = adam.update({k: jnp.asarray(g) for k, g in got.items()},
                                  adam.init(jtrain), None)
            now = to_jax_params(ttrain)
            for k in now:
                want_k = np.asarray(want[k])
                err = np.abs(now[k] - start[k] - want_k)
                ulp = np.spacing(np.maximum(np.abs(start[k]), np.abs(now[k])))
                assert np.all(err <= 2 * ulp + 2e-5 * np.abs(want_k)), k
    got = to_jax_params(ttrain)
    total = far = 0
    for k, v in got.items():
        diff = np.abs(v - np.asarray(jtrain[k]))
        assert diff.max() <= 2 * lr * 1.01, k
        total += diff.size
        far += int((diff > 1e-6).sum())
    print(f"{far} of {total} elements more than 1e-6 apart")
    assert far <= 1e-2 * total
    for k, v in trun.items():
        r = np.asarray(jrun[k])
        assert np.abs(v.numpy() - r).max() <= 1e-4 * np.abs(r).max(), k


def test_render_place_views_matches_jax():
    views = []
    for synth, calib_t, fn in ((jsynth, JStereoCalib, jscript.render_place_views),
                               (tsynth, StereoCalib, tscript.render_place_views)):
        rng = np.random.default_rng(6)
        world = synth.make_room_world(rng, n_sprites=60)
        anchors = [synth.random_interior_pose(rng) for _ in range(2)]
        calib = calib_t(fx=32.0, fy=32.0, cx=32.0, cy=24.0, baseline=0.3)
        views.append(fn(world, anchors, 2, calib, 48, 64, 32, rng, (0.08, 0.3)))
    assert views[0].shape == (2, 2, 32, 32) and views[0].dtype == np.uint8
    np.testing.assert_array_equal(views[1], views[0])


def test_train_eigenplaces_script_on_cpu(tmp_path):
    """The script at a tiny size on the CPU: finite losses, recall in
    [0, 1], the metadata beside the checkpoint, and the checkpoint read by
    the JAX package's loader into the parameters the port wrote (fp16),
    running statistics included."""
    out = str(tmp_path / "ep.safetensors")
    meta = tscript.main([
        "--device", "cpu", "--steps", "2", "--places", "4", "--views", "2",
        "--eval-places", "2", "--batch-places", "2", "--size", str(SIZE),
        "--height", "48", "--width", "64", "--out", out,
    ])
    assert len(meta["losses"]) == 2 and np.all(np.isfinite(meta["losses"]))
    assert 0.0 <= meta["recall_at_1"] <= 1.0 and meta["platform"] == "cpu"
    with open(out + ".json") as f:
        assert json.load(f)["steps"] == 2
    port = load_safetensors(out)
    assert port.keys() == tep.init_eigenplaces_params(0).keys()
    assert not torch.equal(port["backbone.bn1.running_var"], torch.ones(64))  # EMA'd
    loaded = jax_load_params(out, lambda: pytest.fail("checkpoint not found"))
    want = to_jax_params(port)
    assert loaded.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(np.asarray(loaded[k], np.float32).reshape(want[k].shape),
                                      want[k], err_msg=k)


def test_train_eigenplaces_script_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default would train on it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tscript.main(["--steps", "1", "--places", "2", "--eval-places", "1"])

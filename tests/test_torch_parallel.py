"""The port's parallel/ package against the JAX package's on the CPU: the
mesh and its placements, batched_stereo_frontend, batched_track_scan,
MultiSequenceTracker, the matcher's train step over the mesh and
LightGlue's forward split over the model axis (tests/test_parallel.py's
cases, with the JAX side on its 8 virtual CPU devices and the port's mesh
over 8 `cpu` entries).

Tolerances:
- batched_track_scan: pose columns within 1e-4 (m and rotation-matrix
  entries; the two f32 LMs sum in other orders), counts exact;
- batched_stereo_frontend in the default bf16 on both sides: the
  keypoints (whole pixels, no sub-pixel step here) exact; XLA's and
  oneDNN's bf16 matmuls round at other places, which flips near-tied
  matches, so, as the step's parity tests allow
  (tests/test_torch_frontend_step.py), >= 90% of the matches agree;
- MultiSequenceTracker with both packages' steps bound to f32 (the
  rounding gap removed): every sequence's trajectory within 1e-3 m of the
  JAX tracker's; sequence 0 within 1e-4 m of the port's own
  single-sequence run on the same frames (the same arithmetic per
  sequence).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from superslam_tpu.models.lightglue import init_lightglue_params as jax_lg_init
from superslam_tpu.models.superpoint import init_superpoint_params as jax_sp_init
from superslam_tpu.parallel import mesh as jmesh
from superslam_tpu_torch.models.weights import from_jax_params
from superslam_tpu_torch.parallel import mesh as tmesh

CPU8 = ["cpu"] * 8


@pytest.fixture(autouse=True)
def few_torch_threads():
    """Two torch threads per worker process (as tests/test_torch_training.py):
    the suite runs in several workers on one host, and the train steps here
    slow down manyfold when each worker takes every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np_params(params):
    return {k: np.asarray(v) for k, v in params.items()}


def test_mesh_default_axes_match_jax():
    for n in (1, 2, 3, 4, 8):
        j = jmesh.make_mesh(n)
        t = tmesh.make_mesh(n, devices=CPU8)
        assert t.devices.shape == j.devices.shape
        assert t.axis_names == tuple(j.axis_names)
        assert t.shape == dict(j.shape)
    assert tmesh.make_mesh(8, model_axis=1, devices=CPU8).shape == {"data": 8, "model": 1}


def test_lightglue_rules_match_jax():
    """Every LightGlue parameter's spec: the JAX rule on its (in, out)
    weight, reversed on the port's (out, in) one; biases and the rest as
    they are."""
    mesh_j, mesh_t = jmesh.make_mesh(8), tmesh.make_mesh(8, devices=CPU8)
    params = jax_lg_init(0)
    sh_j = jmesh.lightglue_param_sharding(mesh_j, params)
    sh_t = tmesh.lightglue_param_sharding(mesh_t, from_jax_params(_np_params(params)))
    assert set(sh_j) == set(sh_t)
    n_split = 0
    for name, s in sh_j.items():
        spec = tuple(s.spec)
        want = tuple(reversed(spec)) if np.ndim(params[name]) == 2 and spec else spec
        assert sh_t[name].spec == want, name
        n_split += bool(spec)
    assert n_split > 0
    assert not sh_t["transformers.0.self_attn.ffn.0.weight"].is_fully_replicated
    assert sh_t["log_assignment.8.matchability.weight"].is_fully_replicated
    assert tmesh.data_sharding(mesh_t).spec == tuple(jmesh.data_sharding(mesh_j).spec)
    assert tmesh.data_sharding(mesh_t, 2).spec == tuple(jmesh.data_sharding(mesh_j, 2).spec)
    assert tmesh.replicate(mesh_t).spec == tuple(jmesh.replicate(mesh_j).spec) == ()


def test_make_mesh_fails_loudly_when_too_few_devices():
    with pytest.raises(ValueError, match="needs 16 devices"):
        tmesh.make_mesh(16)  # no CUDA device here
    with pytest.raises(ValueError, match="needs 9 devices"):
        tmesh.make_mesh(9, devices=CPU8)


@pytest.fixture
def unfused_lightglue(monkeypatch):
    """Both packages on the unfused LightGlue route (the JAX fused route
    on the CPU is Pallas in interpret mode)."""
    monkeypatch.setenv("SUPERSLAM_PALLAS_LG", "0")
    jax.clear_caches()
    yield
    jax.clear_caches()


def test_batched_stereo_frontend_matches_jax(unfused_lightglue):
    from superslam_tpu.parallel.batched_tracking import batched_stereo_frontend as jfront
    from superslam_tpu_torch.parallel.batched_tracking import batched_stereo_frontend

    rng = np.random.default_rng(1)
    S, H, W, K = 2, 48, 64, 64
    left = rng.uniform(0, 1, (S, H, W)).astype(np.float32)
    right = np.roll(left, -3, axis=2)
    jsp, jlg = jax_sp_init(0), jax_lg_init(0)
    jo = jfront(jsp, jlg, jnp.asarray(left), jnp.asarray(right), max_keypoints=K)
    to = batched_stereo_frontend(
        from_jax_params(_np_params(jsp)), from_jax_params(_np_params(jlg)),
        torch.from_numpy(left), torch.from_numpy(right), max_keypoints=K,
    )
    assert to["matches0"].shape == (S, K) and to["kpts_left"].shape == (S, K, 2)
    assert torch.isfinite(to["mscores0"]).all()
    same_kp = same_match = n_kp = n_match = 0
    for s in range(S):
        jk = np.asarray(jo["kpts_left"][s])[np.asarray(jo["valid_left"][s])]
        tk = to["kpts_left"][s][to["valid_left"][s]].numpy()
        n_kp += len(jk)
        same_kp += sum(bool((np.abs(tk - p).max(axis=1) == 0).any()) for p in jk)
        jm, tm = np.asarray(jo["matches0"][s]), to["matches0"][s].numpy()
        jv = np.asarray(jo["valid_left"][s])
        n_match += int(jv.sum())
        same_match += int((jm[jv] == tm[jv]).sum())
    print(f"keypoints {same_kp}/{n_kp} exact, matches {same_match}/{n_match} identical")
    assert n_kp > 0 and same_kp == n_kp
    assert same_match >= 0.9 * n_match


def _track_inputs():
    """tests/test_parallel.py's batched_track_scan inputs (Q 4, S 3, K 48):
    exact projections of per-sequence landmarks under known motions."""
    from superslam_tpu.geometry import Pose3, StereoCalib

    cal = StereoCalib(fx=80.0, fy=80.0, cx=80.0, cy=60.0, baseline=0.1)
    kw = dict(calib=(80.0, 80.0, 80.0, 60.0, 0.1), min_matches=10, track_sigma_px=10.0,
              disp_sigma0=8.0, disp_cond=cal.bf / 40.0)
    rng = np.random.default_rng(9)
    Q, S, K = 4, 3, 48
    kls, disps, xws, truths = [], [], [], []
    for q in range(Q):
        Xw = rng.uniform([-4, -3, 6], [4, 3, 18], (K, 3))
        xws.append(Xw)
        seq_true, seq_meas = [], []
        for s in range(S):
            true = Pose3.expmap(
                np.array([0.0, 0.01 * (s + 1), 0.0, 0.1 * (s + 1) * (q + 1), 0.0, 0.0]))
            p = true.transform_to(Xw)
            uL = cal.fx * p[:, 0] / p[:, 2] + cal.cx
            uR = cal.fx * (p[:, 0] - cal.baseline) / p[:, 2] + cal.cx
            v = cal.fy * p[:, 1] / p[:, 2] + cal.cy
            seq_meas.append(np.stack([uL, uR, v], 1))
            seq_true.append(true)
        truths.append(seq_true)
        kls.append(np.stack([np.stack([m[:, 0], m[:, 2]], 1) for m in seq_meas]))
        disps.append(np.stack([m[:, 0] - m[:, 1] for m in seq_meas]))
    tm = np.tile(np.arange(K), (Q, S, 1)).astype(np.int32)
    ok = np.ones((Q, S, K), bool)
    # Sequence 3 coasts: below min_matches from its second frame on.
    tm[3, 1:, 6:] = -1
    arrays = (np.stack(kls).astype(np.float32), np.stack(disps).astype(np.float32), ok, tm,
              np.stack(xws).astype(np.float32), np.ones((Q, K), bool))
    eye = np.broadcast_to(np.eye(3, dtype=np.float32), (Q, 3, 3)).copy()
    zero = np.zeros((Q, 3), np.float32)
    return arrays, (eye, zero, eye, zero), kw, truths


def test_batched_track_scan_matches_jax():
    from superslam_tpu.parallel.batched_tracking import batched_track_scan as jscan
    from superslam_tpu_torch.ops.frontend_step import track_scan
    from superslam_tpu_torch.parallel.batched_tracking import batched_track_scan

    arrays, carry, kw, truths = _track_inputs()
    jout, jcarry = jscan(*(jnp.asarray(a) for a in arrays),
                         tuple(jnp.asarray(c) for c in carry), **kw)
    tt = [torch.from_numpy(a) for a in arrays]
    tout, tcarry = batched_track_scan(*tt, tuple(torch.from_numpy(c) for c in carry), **kw)
    jout, tout = np.asarray(jout), tout.numpy()
    assert tout.shape == jout.shape == (4, 3, 13)
    np.testing.assert_allclose(tout[..., :12], jout[..., :12], atol=1e-4)
    np.testing.assert_array_equal(tout[..., 12], jout[..., 12])
    assert (tout[3, 1:, 12] < kw["min_matches"]).all()  # the coasting sequence
    for a, b in zip(tcarry, jcarry):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4)
    # Each sequence alone through the port's track_scan: the same rows.
    for q in range(4):
        ref, _ = track_scan(*(t[q] for t in tt),
                            tuple(torch.from_numpy(c[q]) for c in carry), **kw)
        np.testing.assert_array_equal(tout[q], ref.numpy())
    for q in range(3):
        for s, true in enumerate(truths[q]):
            assert np.abs(tout[q, s, 9:12] - true.t).max() < 1e-3


# -- MultiSequenceTracker -----------------------------------------------------------

W, H, K = 160, 120, 96


def _sequences():
    """tests/test_parallel.py::test_multi_sequence_tracker's two streams."""
    rng = np.random.default_rng(4)
    base = [rng.uniform(0, 255, (H + 16, W + 16)).astype(np.uint8) for _ in range(2)]
    seqs = []
    for s in range(2):
        frames = []
        for i in range(4):
            left = base[s][i : i + H, 2 * i : 2 * i + W]
            frames.append((left, np.roll(left, -4, axis=1)))
        seqs.append(frames)
    return seqs


@pytest.fixture
def f32_steps(monkeypatch):
    """Both packages' steps with SuperPoint and LightGlue bound to f32 on
    the unfused route (module attributes rebound; JAX retraces)."""
    import superslam_tpu.ops.frontend_step as jstep
    import superslam_tpu_torch.ops.frontend_step as tstep

    for mod, dtype in ((jstep, jnp.float32), (tstep, torch.float32)):
        monkeypatch.setattr(
            mod, "superpoint_dense", functools.partial(mod.superpoint_dense, compute_dtype=dtype))
        monkeypatch.setattr(
            mod, "lightglue_forward",
            functools.partial(mod.lightglue_forward, compute_dtype=dtype, fused=False))
    jax.clear_caches()
    yield
    jax.clear_caches()


def _run_multi(tracker, seqs):
    for i in range(4):
        poses = tracker.step([s[i][0] for s in seqs], [s[i][1] for s in seqs], [0.1 * i] * 2)
        assert len(poses) == len(seqs)
    return tracker.trajectories()


def test_multi_sequence_tracker_matches_jax(f32_steps):
    from superslam_tpu.geometry import StereoCalib as JCalib
    from superslam_tpu.parallel.multi_tracker import MultiSequenceTracker as JTracker
    from superslam_tpu_torch.core.vo_estimator import VoEstimator
    from superslam_tpu_torch.frontend.fused import FusedStereoPipeline
    from superslam_tpu_torch.geometry import StereoCalib
    from superslam_tpu_torch.parallel.multi_tracker import MultiSequenceTracker

    seqs = _sequences()
    jsp, jlg = jax_sp_init(0), jax_lg_init(0)
    sp, lg = from_jax_params(_np_params(jsp)), from_jax_params(_np_params(jlg))
    kw = dict(num_sequences=2, width=W, height=H, max_keypoints=K, keypoint_threshold=5e-4,
              window_size=4)
    jcal = JCalib(fx=80.0, fy=80.0, cx=80.0, cy=60.0, baseline=0.1)
    cal = StereoCalib(fx=80.0, fy=80.0, cx=80.0, cy=60.0, baseline=0.1)
    jtraj = _run_multi(JTracker(jsp, jlg, jcal, **kw), seqs)
    mesh = tmesh.make_mesh(2, model_axis=1, devices=CPU8)  # both shards on the CPU: one step
    tracker = MultiSequenceTracker(sp, lg, cal, mesh=mesh, device="cpu", **kw)
    assert len(tracker.groups) == 1
    ttraj = _run_multi(tracker, seqs)
    for s in range(2):
        assert len(ttraj[s]) == len(jtraj[s]) == 4
        gap = max(float(np.linalg.norm(a.t - b.t)) for a, b in zip(ttraj[s], jtraj[s]))
        assert gap < 1e-3, (s, gap)

    # Sequence 0 alone through the single-sequence path: its keyframe state
    # did not leak into sequence 1's or back.
    pipe = FusedStereoPipeline(sp, lg, cal, width=W, height=H, max_keypoints=K,
                               keypoint_threshold=5e-4, device="cpu")
    est = VoEstimator(None, cal, 4, device="cpu")
    for i, (left, right) in enumerate(seqs[0]):
        frame, m = pipe.process(left, right, 0.1 * i)
        est.track(frame, kf_matches=m)
        if est._last_keyframe is frame:
            pipe.set_keyframe(frame.descriptors_left)
    ref = est.corrected_trajectory()
    for a, b in zip(ttraj[0], ref):
        assert np.linalg.norm(a.t - b.t) < 1e-4, (a.t, b.t)

    # A data axis over two distinct devices ("cpu" and "cpu:0" compare
    # unequal): one step a device, each with its own sequence.
    split = MultiSequenceTracker(sp, lg, cal, mesh=tmesh.make_mesh(
        2, model_axis=1, devices=["cpu", "cpu:0"]), device="cpu", **kw)
    assert [g.seqs for g in split.groups] == [[0], [1]]
    for a_seq, b_seq in zip(_run_multi(split, seqs), ttraj):
        for a, b in zip(a_seq, b_seq):
            assert np.linalg.norm(a.t - b.t) < 1e-4, (a.t, b.t)


def test_multi_sequence_tracker_rejects_a_mesh_that_does_not_divide():
    from superslam_tpu_torch.geometry import StereoCalib
    from superslam_tpu_torch.models.lightglue import init_lightglue_params
    from superslam_tpu_torch.models.superpoint import init_superpoint_params
    from superslam_tpu_torch.parallel.multi_tracker import MultiSequenceTracker

    cal = StereoCalib(fx=80.0, fy=80.0, cx=80.0, cy=60.0, baseline=0.1)
    mesh = tmesh.make_mesh(8, devices=CPU8)  # data axis 4
    with pytest.raises(ValueError, match="multiple of the mesh data axis"):
        MultiSequenceTracker(init_superpoint_params(0), init_lightglue_params(0), cal,
                             num_sequences=6, width=W, height=H, mesh=mesh, device="cpu")


# -- the matcher's step over the mesh ------------------------------------------------

LR = 1e-4
REPLICAS = ["cpu:0"] * 8  # another device name: the replica path (a copy, its gradient summed back)
STEP_KEYS = ("kpts0", "desc0", "kpts1", "desc1", "mask0", "mask1", "gt_indices")


def _step_batch(batch=8, k=32):
    """tests/test_parallel.py's batch: B 8, K 32, seed 0."""
    from superslam_tpu_torch.parallel.training import synthetic_matching_batch

    return {name: torch.from_numpy(v) for name, v in
            synthetic_matching_batch(np.random.default_rng(0), batch, k).items()}


def _grad_gap(got, ref):
    """The worst over tensors of max |got - ref| / max |ref|."""
    return max(float((got[k].double() - ref[k].double()).abs().max()
                     / max(float(ref[k].abs().max()), 1e-30)) for k in ref)


def _f64_gradients(mesh, batch):
    """The step's gradient in f64 through the split forward on ``mesh``
    (the whole batch on its first data shard: in f64 the data split moves
    nothing)."""
    from superslam_tpu_torch.models.lightglue import init_lightglue_params
    from superslam_tpu_torch.parallel import training as ttrain
    from superslam_tpu_torch.parallel.tensor_parallel import tensor_parallel_forward

    params = init_lightglue_params(0, dtype=torch.float64)
    for p in params.values():
        p.requires_grad_(True)
    b = {k: v.double() if v.is_floating_point() else v for k, v in batch.items()}
    la = tensor_parallel_forward(params, *(b[k] for k in STEP_KEYS[:6]), mesh,
                                 compute_dtype=torch.float64)
    loss = ttrain._assignment_nll(la, b["mask0"], b["gt_indices"]) / ttrain._denominator(b["mask0"])
    loss.backward()
    return {k: torch.zeros_like(p) if p.grad is None else p.grad for k, p in params.items()}


@pytest.fixture(scope="module")
def single_device_step():
    """train_step on the batch (loss, gradients before the AdamW step,
    parameters after it) and the f64 gradient of the same step with the
    single-device f32 gradient's distance from it."""
    from superslam_tpu_torch.models.lightglue import init_lightglue_params
    from superslam_tpu_torch.parallel import training as ttrain

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        batch = _step_batch()
        params = init_lightglue_params(0)
        loss = ttrain.train_step(params, ttrain.make_optimizer(params, LR), batch)
        grads = {k: p.grad.clone() for k, p in params.items()}
        f64 = _f64_gradients(tmesh.make_mesh(1, devices=["cpu"]), batch)
    finally:
        torch.set_num_threads(n)
    return dict(batch=batch, loss=float(loss), grads=grads, params=params, f64=f64,
                f32_gap=_grad_gap(grads, f64))


@pytest.mark.parametrize(
    "model_axis, devices",
    [(2, CPU8), (2, REPLICAS), (4, CPU8), (4, REPLICAS), (1, CPU8), (1, REPLICAS)],
    ids=["in_place", "replicas", "in_place_2x4", "replicas_2x4", "in_place_8x1",
         "replicas_8x1"],
)
def test_sharded_train_step_matches_train_step_and_jax(single_device_step, model_axis, devices):
    """tests/test_parallel.py::test_sharded_train_step_runs_and_matches_unsharded
    on the port's meshes of 8 CPU entries: (4, 2) (the JAX test's), (2, 4)
    and (8, 1), the data axis splitting B 8 (K 32, lr 1e-4) and the model
    axis LightGlue's heads and FFN units (parallel/tensor_parallel.py).
    ``cpu`` shards differentiate the parameters in place; ``cpu:0`` is
    another device name, so those data shards take the replica path (a
    copy on their device, the gradient summed back).

    Against train_step on the same batch, the gradients taken before the
    AdamW step: the loss within 1e-6 relative (the global sum(mask0)
    denominator); each gradient within 1e-5 of its tensor's largest at
    M = 1, and at M > 1 (the all-reduces and the split LayerNorm sum in
    another order) within 1e-4 (measured: 2.1e-5 at M = 2, 1.9e-5 at
    M = 4) and no further from an f64 run of the same split step than
    twice train_step's own distance from the f64 step (measured 1.8e-5
    and 1.1e-5 against 2.0e-5). After the step all but 0.01% of the
    elements within 1e-7 (Adam turns a gradient below f32 noise into a full
    step of either sign; measured 7e-6 of them at M = 1, 6.2e-5 at M > 1),
    none further than 2 * lr. Against the JAX package's sharded step on
    the same mesh shape (in the in-place cases): the loss within
    test_parallel.py's rel=3e-2."""
    from superslam_tpu.parallel import training as jtrain
    from superslam_tpu_torch.models.lightglue import init_lightglue_params
    from superslam_tpu_torch.parallel import training as ttrain

    ref = single_device_step
    batch = ref["batch"]
    mesh = tmesh.make_mesh(8, model_axis=model_axis, devices=devices)
    assert mesh.shape == {"data": 8 // model_axis, "model": model_axis}
    params = init_lightglue_params(0)
    before = {k: p.clone() for k, p in params.items()}
    opt = ttrain.make_optimizer(params, LR)
    loss = ttrain.sharded_train_step(params, opt, batch, mesh)
    assert loss.shape == () and loss.grad_fn is None
    assert abs(float(loss) - ref["loss"]) <= 1e-6 * abs(ref["loss"])
    grads = {k: p.grad for k, p in params.items()}
    limit = 1e-5 if model_axis == 1 else 1e-4
    for k, g in grads.items():
        r = ref["grads"][k]
        assert (g - r).abs().max() <= limit * max(r.abs().max(), 1e-30), k
    if model_axis > 1:
        gap = _grad_gap(grads, _f64_gradients(mesh, batch))
        print(f"M = {model_axis}: gradient gap to f64 {gap:.3g}, train_step's {ref['f32_gap']:.3g}")
        assert gap <= 2 * ref["f32_gap"]
    total = far = 0
    for k, p in params.items():
        diff = (p - ref["params"][k]).abs()
        assert diff.max() <= 2 * LR * 1.01, k
        total += diff.numel()
        far += int((diff > 1e-7).sum())
    assert far <= 1e-4 * total, (far, total)
    assert (params["input_proj.weight"] - before["input_proj.weight"]).abs().max() > 0
    if devices != CPU8:
        return  # the JAX package's step once a mesh

    jm = jmesh.make_mesh(8, model_axis=model_axis)
    jparams = jax_lg_init(0)
    sh = jmesh.lightglue_param_sharding(jm, jparams)
    jparams = {k: jax.device_put(v, sh[k]) for k, v in jparams.items()}
    tx = jtrain.make_optimizer(LR)
    bshard = jmesh.data_sharding(jm)
    jbatch = {k: jax.device_put(jnp.asarray(v.numpy()), bshard) for k, v in batch.items()}
    _, _, jloss = jtrain.train_step(jparams, tx.init(jparams), jbatch, tx)
    assert float(loss) == pytest.approx(float(jloss), rel=3e-2)


def _data_parallel_step(params, optimizer, batch, mesh):
    """The data-parallel step as it was before the model axis computed
    anything: each data shard through the single-device loss's numerator
    (lightglue_forward), its gradient summed onto the parameters."""
    from superslam_tpu_torch.parallel import training as ttrain

    n = mesh.shape["data"]
    home = next(iter(params.values())).device
    optimizer.zero_grad(set_to_none=True)
    denom = ttrain._denominator(batch["mask0"])
    total = torch.zeros(())
    for i, shard in enumerate(zip(*(batch[k].chunk(n) for k in STEP_KEYS))):
        dev = mesh.devices[i, 0]
        local = params if dev == home else {
            k: p.detach().to(dev).requires_grad_(True) for k, p in params.items()}
        loss = ttrain._nll_sum(local, *(t.to(dev) for t in shard)) / denom.to(dev)
        loss.backward()
        if local is not params:
            for k, p in params.items():
                g = local[k].grad
                if g is not None:
                    g = g.to(home)
                    p.grad = g if p.grad is None else p.grad + g
        total = total + loss.detach().to(home)
    ttrain._apply_update(params, optimizer, None)
    return total


@pytest.mark.parametrize("devices", [CPU8, REPLICAS], ids=["in_place", "replicas"])
def test_sharded_train_step_over_model_axis_1_is_the_data_parallel_step(devices):
    """On an (8, 1) mesh the step gives the bits of the data-parallel step
    it was before the model axis split anything: loss, gradients and
    parameters after the AdamW step."""
    from superslam_tpu_torch.models.lightglue import init_lightglue_params
    from superslam_tpu_torch.parallel import training as ttrain

    batch = _step_batch()
    mesh = tmesh.make_mesh(8, model_axis=1, devices=devices)
    out = []
    for step in (ttrain.sharded_train_step, _data_parallel_step):
        params = init_lightglue_params(0)
        loss = step(params, ttrain.make_optimizer(params, LR), batch, mesh)
        out.append((loss, {k: p.grad for k, p in params.items()}, params))
    (la, ga, pa), (lb, gb, pb) = out
    assert torch.equal(la, lb)
    for k in pa:
        assert torch.equal(ga[k], gb[k]), k
        assert torch.equal(pa[k], pb[k]), k


def _forward_inputs():
    batch = _step_batch(batch=2)
    return [batch[k] for k in STEP_KEYS[:6]]


@pytest.fixture
def attention_spy(monkeypatch):
    """The heads of every masked_attention call the unfused blocks make."""
    from superslam_tpu_torch.models import lightglue as lgm

    heads = []
    inner = lgm.masked_attention

    def spy(q, k, v, mask):
        heads.append(q.shape[1])
        return inner(q, k, v, mask)

    monkeypatch.setattr(lgm, "masked_attention", spy)
    return heads


@pytest.mark.parametrize("model_axis", [2, 4])
def test_tensor_parallel_forward_matches_single_device(attention_spy, model_axis):
    """The split forward on a (2, M) mesh against lightglue_forward (f32,
    unfused) on the same inputs: every entry of the log-assignment within
    1e-5 of its largest valid entry (measured 1.6e-6: 2.3e-4 of 146).
    masked_attention is called 18·M times, each call with 4/M heads (the
    single-device route: 18 times with 4)."""
    from superslam_tpu_torch.models.lightglue import init_lightglue_params, lightglue_forward
    from superslam_tpu_torch.parallel.tensor_parallel import tensor_parallel_forward

    ins = _forward_inputs()
    params = init_lightglue_params(0)
    ref = lightglue_forward(params, *ins, compute_dtype=torch.float32, fused=False)
    assert attention_spy == [4] * 18
    attention_spy.clear()
    mesh = tmesh.make_mesh(2 * model_axis, model_axis=model_axis, devices=CPU8)
    got = tensor_parallel_forward(params, *ins, mesh)
    assert attention_spy == [4 // model_axis] * (18 * model_axis)
    both = ins[4][:, :, None] & ins[5][:, None, :]
    scale = float(ref[both].abs().max())
    gap = float((got - ref).abs().max())
    print(f"M = {model_axis}: {gap:.3g} of {scale:.4g}")
    assert gap <= 1e-5 * scale


@pytest.mark.parametrize("model_axis", [1, 2, 4])
def test_tensor_parallel_passthrough_forward_is_exact(model_axis):
    """With the passthrough init (zeroed message and FFN output
    projections: every layer the residual identity) the split forward
    gives the single-device forward's bits: the JAX dry run's exactness
    argument. At M = 1 so does any init."""
    from superslam_tpu_torch.models.lightglue import init_lightglue_params, lightglue_forward
    from superslam_tpu_torch.parallel.tensor_parallel import tensor_parallel_forward

    ins = _forward_inputs()
    mesh = tmesh.make_mesh(2 * model_axis, model_axis=model_axis, devices=CPU8)
    for passthrough in (True, False) if model_axis == 1 else (True,):
        params = init_lightglue_params(0, passthrough=passthrough)
        ref = lightglue_forward(params, *ins, compute_dtype=torch.float32, fused=False)
        assert torch.equal(tensor_parallel_forward(params, *ins, mesh), ref)


def test_tensor_parallel_forward_matches_jax_on_the_sharded_mesh(unfused_lightglue):
    """The JAX lightglue_forward (f32, unfused) with its parameters placed
    by lightglue_param_sharding on the (4, 2) virtual mesh against the
    split forward on the port's (4, 2) mesh: tests/test_torch_models.py's
    limits (atol 1e-3 on the valid pairs with log P > -50, rtol 1e-5 on
    the rest)."""
    from superslam_tpu.models import lightglue as jlg
    from superslam_tpu_torch.parallel.tensor_parallel import tensor_parallel_forward

    ins = _forward_inputs()
    jm = jmesh.make_mesh(8)
    jparams = jax_lg_init(0)
    sh = jmesh.lightglue_param_sharding(jm, jparams)
    jplaced = {k: jax.device_put(v, sh[k]) for k, v in jparams.items()}
    ref = np.asarray(jlg.lightglue_forward(
        jplaced, *(jnp.asarray(a.numpy()) for a in ins), compute_dtype=jnp.float32, fused=False))
    got = tensor_parallel_forward(from_jax_params(_np_params(jparams)), *ins,
                                  tmesh.make_mesh(8, devices=CPU8)).numpy()
    both = ins[4].numpy()[:, :, None] & ins[5].numpy()[:, None, :]
    near = both & (ref > -50)
    assert near.sum() > 20
    np.testing.assert_allclose(got[near], ref[near], atol=1e-3, rtol=0)
    np.testing.assert_allclose(got, ref, atol=1e-3, rtol=1e-5)


def test_tensor_parallel_refuses_what_it_cannot_split():
    """A model axis of 3 does not divide the 4 heads: the forward and the
    step raise naming it."""
    from superslam_tpu_torch.models.lightglue import init_lightglue_params
    from superslam_tpu_torch.parallel import training as ttrain
    from superslam_tpu_torch.parallel.tensor_parallel import tensor_parallel_forward

    ins = _forward_inputs()
    params = init_lightglue_params(0)
    m3 = tmesh.make_mesh(6, model_axis=3, devices=CPU8)
    with pytest.raises(ValueError, match="model axis of 3"):
        tensor_parallel_forward(params, *ins, m3)
    with pytest.raises(ValueError, match="model axis of 3"):
        ttrain.sharded_train_step(params, ttrain.make_optimizer(params, LR), _step_batch(6), m3)


def test_tensor_parallel_refuses_a_placement_it_does_not_compute(monkeypatch):
    """A placement that splits a row-sharded linear's bias (each shard
    would add it, M times in all) raises naming the parameter."""
    from superslam_tpu_torch.models.lightglue import init_lightglue_params
    from superslam_tpu_torch.parallel import tensor_parallel as tp

    monkeypatch.setattr(tmesh, "_LG_RULES", [*tmesh._LG_RULES, (".out_proj.bias", ("model",))])
    monkeypatch.setattr(tp, "_PLANS", {})
    with pytest.raises(ValueError, match=r"transformers\.0\.self_attn\.out_proj\.weight"):
        tp.tensor_parallel_forward(init_lightglue_params(0), *_forward_inputs(),
                                   tmesh.make_mesh(8, devices=CPU8))


def test_sharded_train_step_rejects_a_batch_that_does_not_split():
    from superslam_tpu_torch.models.lightglue import init_lightglue_params
    from superslam_tpu_torch.parallel import training as ttrain

    params = init_lightglue_params(0)
    opt = ttrain.make_optimizer(params, 1e-4)
    batch = {k: torch.from_numpy(v) for k, v in
             ttrain.synthetic_matching_batch(np.random.default_rng(0), 6, 16).items()}
    with pytest.raises(ValueError, match="does not split"):
        ttrain.sharded_train_step(params, opt, batch, tmesh.make_mesh(8, devices=CPU8))

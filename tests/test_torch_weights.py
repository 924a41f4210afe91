"""The port's parameter handling against the JAX package's, and the port's
import isolation (superslam_tpu_torch imports neither jax nor superslam_tpu).

Comparisons are exact: loading and layout changes move values, they do
not compute with them."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from superslam_tpu.models import eigenplaces as jep
from superslam_tpu.models import lightglue as jlg
from superslam_tpu.models import superpoint as jsp
from superslam_tpu.models.weights import load_params as jax_load_params
from superslam_tpu.models.weights import load_safetensors as jax_load
from superslam_tpu_torch.models import eigenplaces as tep
from superslam_tpu_torch.models import lightglue as tlg
from superslam_tpu_torch.models import superpoint as tsp
from superslam_tpu_torch.models.weights import (
    from_jax_params,
    load_params,
    load_safetensors,
    to_jax_params,
    to_torch_layout,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKPOINTS = [
    "superpoint_render",
    "lightglue_synth",
    "lightglue_tpu2",
    "lightglue_tpu3",
    "eigenplaces_resnet18_512",
]


@pytest.mark.parametrize("name", CHECKPOINTS)
def test_loader_matches_jax_loader(name):
    path = os.path.join(REPO, "weights", f"{name}.safetensors")
    ours = load_safetensors(path)
    ref = jax_load(path)
    assert set(ours) == set(ref)
    for k, v in ref.items():
        want = to_torch_layout(np.asarray(v))
        assert ours[k].dtype == torch.float32
        np.testing.assert_array_equal(ours[k].numpy(), want, err_msg=k)


@pytest.mark.parametrize(
    "jax_init,port_init",
    [
        (lambda: jsp.init_superpoint_params(0), lambda: tsp.init_superpoint_params(0)),
        (lambda: jlg.init_lightglue_params(0), lambda: tlg.init_lightglue_params(0)),
        (
            lambda: jlg.init_lightglue_params(3, passthrough=True),
            lambda: tlg.init_lightglue_params(3, passthrough=True),
        ),
        (lambda: jep.init_eigenplaces_params(0), lambda: tep.init_eigenplaces_params(0)),
    ],
    ids=["superpoint", "lightglue", "lightglue_passthrough", "eigenplaces"],
)
def test_from_jax_params_equals_port_init(jax_init, port_init):
    carried = from_jax_params({k: np.asarray(v) for k, v in jax_init().items()})
    ours = port_init()
    assert set(carried) == set(ours)
    for k in ours:
        assert carried[k].shape == ours[k].shape, k
        torch.testing.assert_close(carried[k], ours[k], rtol=0, atol=0, msg=k)


def test_load_params_falls_back_to_init(tmp_path):
    missing = str(tmp_path / "absent.safetensors")
    got = load_params(missing, lambda: tsp.init_superpoint_params(1))
    want = tsp.init_superpoint_params(1)
    assert all(torch.equal(got[k], want[k]) for k in want)


@pytest.mark.parametrize("wrap", [None, "model", "state_dict"])
def test_load_params_reads_a_pth_state_dict(tmp_path, wrap):
    """A torch .pth of the committed SuperPoint checkpoint loads through the
    port as the .safetensors does, and through to_jax_params as the JAX
    package's load_params reads the same .pth."""
    path = os.path.join(REPO, "weights", "superpoint_render.safetensors")
    ref = load_safetensors(path)
    state = {**ref, "bn.num_batches_tracked": torch.tensor(7)}
    pth = str(tmp_path / "superpoint_render.pth")
    torch.save(state if wrap is None else {wrap: state}, pth)
    fallback = lambda: tsp.init_superpoint_params(0)  # noqa: E731
    ours = load_params(pth, fallback)
    assert set(ours) == set(ref)
    for k, v in ref.items():
        assert ours[k].dtype == torch.float32
        torch.testing.assert_close(ours[k], v, rtol=0, atol=0, msg=k)
    theirs = jax_load_params(pth, lambda: jsp.init_superpoint_params(0))
    carried = to_jax_params(ours)
    assert set(carried) == set(theirs)
    for k, v in theirs.items():
        np.testing.assert_array_equal(carried[k], np.asarray(v), err_msg=k)


def test_load_params_refuses_other_extensions(tmp_path):
    path = tmp_path / "superpoint.bin"
    path.write_bytes(b"\0")
    with pytest.raises(ValueError, match=".pth"):
        load_params(str(path), lambda: tsp.init_superpoint_params(0))


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import sys\n"
        "import superslam_tpu_torch.slam, superslam_tpu_torch.frontend\n"
        "import superslam_tpu_torch.ops.frontend_step, superslam_tpu_torch.models\n"
        "import superslam_tpu_torch.ops.cuda._build\n"
        "import superslam_tpu_torch.parallel, superslam_tpu_torch.train\n"
        "import scripts.train_lightglue_synth_torch, scripts.profile_stages_torch\n"
        "import scripts.kernel_variants_torch\n"
        "import superslam_tpu_torch.frontend.pipelined, superslam_tpu_torch.ops.cuda.pose_solve\n"
        "import scripts.accuracy_suite_torch\n"
        "import superslam_tpu_torch.ops.rgbd_step, superslam_tpu_torch.ops.retrieval\n"
        "import superslam_tpu_torch.frontend.fused_rgbd, superslam_tpu_torch.frontend.rgbd_frontend\n"
        "import superslam_tpu_torch.frontend.pipelined_rgbd, superslam_tpu_torch.frontend.recognizer\n"
        "import superslam_tpu_torch.models.eigenplaces, superslam_tpu_torch.io.undistort\n"
        "import superslam_tpu_torch.ops.window_solver, superslam_tpu_torch.parallel.mesh\n"
        "import superslam_tpu_torch.parallel.batched_tracking, superslam_tpu_torch.parallel.multi_tracker\n"
        "import superslam_tpu_torch.frontend.stereo_frontend, superslam_tpu_torch.io.viewer\n"
        "import superslam_tpu_torch.io, superslam_tpu_torch.ops\n"
        "from superslam_tpu_torch.ops import ShardedCosineIndex, solve_window, pose_only_lm\n"
        "import superslam_tpu_torch.train.superpoint_train, superslam_tpu_torch.train.synthetic_shapes\n"
        "from superslam_tpu_torch.train import RenderDomainSource, evaluate_detector, sp_train_step\n"
        "from superslam_tpu_torch.models.eigenplaces import eigenplaces_descriptor_train\n"
        "from superslam_tpu_torch.parallel import sharded_train_step\n"
        "import scripts.train_superpoint_torch, scripts.train_eigenplaces_torch\n"
        "scripts.profile_stages_torch.run_stages(['lg_attn'], 'cpu', 32, 64, 16, 0, 1)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'superslam_tpu' or m.startswith('superslam_tpu.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr

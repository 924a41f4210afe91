"""``superslam_tpu_torch/ops/precision.py`` and its ``SUPERSLAM_F32_PRECISION``
override (``superslam_tpu/ops/precision.py``'s kill-switch, highest mode
and its TF32 and bf16 modes, which the port runs as TF32).

The variable is read once, at import, so every case runs in a child
process with the variable set. The TF32 flags are process-wide state that
the CPU build keeps too, so each case reads them before, inside, nested
inside and after ``highest_f32_matmuls()`` there. On the CPU the flags
change no result: a fused stereo step under each TF32 mode gives the
highest mode's bits.
"""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = """
import json, torch
from superslam_tpu_torch.ops import precision

def flags():
    return [torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32]

torch.backends.cudnn.allow_tf32 = {cudnn}
seen = {{"mode": precision.F32_PRECISION_MODE, "before": flags()}}

@precision.highest_f32_matmuls()
def body():
    seen["inside"] = flags()
    with precision.highest_f32_matmuls():
        seen["nested"] = flags()
    seen["after_nested"] = flags()

body()
seen["after"] = flags()
seen["depth"] = precision._state["depth"]
print(json.dumps(seen))
"""


def _probe(value, cudnn=True):
    env = {k: v for k, v in os.environ.items() if k != "SUPERSLAM_F32_PRECISION"}
    if value is not None:
        env["SUPERSLAM_F32_PRECISION"] = value
    return subprocess.run(
        [sys.executable, "-c", PROBE.format(cudnn=cudnn)], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )


def _seen(value, cudnn=True):
    out = _probe(value, cudnn)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("value", [None, "highest", "float32"])
def test_highest_clears_tf32_for_the_body_and_restores_it(value):
    seen = _seen(value)
    assert seen["mode"] == (value or "highest")
    assert seen["before"] == [False, True]
    assert seen["inside"] == seen["nested"] == seen["after_nested"] == [False, False]
    assert seen["after"] == [False, True]
    assert seen["depth"] == 0


@pytest.mark.parametrize("value", ["0", "", "default"])
@pytest.mark.parametrize("cudnn", [True, False])
def test_off_leaves_the_flags_as_they_are(value, cudnn):
    """The kill-switch: set flags stay set, cleared flags stay cleared,
    and the counted state is never touched."""
    seen = _seen(value, cudnn)
    assert seen["mode"] == value
    want = [False, cudnn]
    assert seen["before"] == seen["inside"] == seen["nested"] == seen["after"] == want
    assert seen["depth"] == 0


@pytest.mark.parametrize("value", ["high", "tensorfloat32", "bfloat16"])
@pytest.mark.parametrize("cudnn", [True, False])
def test_tf32_modes_set_tf32_for_the_body_and_restore_it(value, cudnn):
    """TF32 on for matmuls and cuDNN inside the body and a nested body,
    whatever the flags were before, and the flags as they were after the
    outermost body leaves; the count back at 0."""
    seen = _seen(value, cudnn)
    assert seen["mode"] == value
    assert seen["before"] == [False, cudnn]
    assert seen["inside"] == seen["nested"] == seen["after_nested"] == [True, True]
    assert seen["after"] == [False, cudnn]
    assert seen["depth"] == 0


THREADS = """
import json, threading, torch
from superslam_tpu_torch.ops import precision

entered, leave = threading.Barrier(2), threading.Event()
seen = []

def worker():
    with precision.highest_f32_matmuls():
        entered.wait()
        leave.wait()
        seen.append(["worker", torch.backends.cuda.matmul.allow_tf32, precision._state["depth"]])

t = threading.Thread(target=worker)
t.start()
with precision.highest_f32_matmuls():
    entered.wait()
    seen.append(["main", torch.backends.cuda.matmul.allow_tf32, precision._state["depth"]])
seen.append(["main left", torch.backends.cuda.matmul.allow_tf32, precision._state["depth"]])
leave.set()
t.join()
seen.append(["both left", torch.backends.cuda.matmul.allow_tf32, precision._state["depth"],
             torch.backends.cudnn.allow_tf32])
print(json.dumps(seen))
"""


@pytest.mark.parametrize("value", ["high", "bfloat16"])
def test_tf32_modes_nest_across_threads_under_the_lock(value):
    """Two threads in overlapping bodies (the loop worker's matcher beside
    the frame's step): the flags stay set until the last body leaves, then
    come back as they were."""
    env = {**os.environ, "SUPERSLAM_F32_PRECISION": value}
    out = subprocess.run([sys.executable, "-c", THREADS], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    seen = json.loads(out.stdout.strip().splitlines()[-1])
    assert seen == [["main", True, 2], ["main left", True, 1], ["worker", True, 1],
                    ["both left", False, 0, True]]


STEP = """
import hashlib, json, os, numpy as np, torch
torch.set_num_threads(2)
from superslam_tpu_torch.models.lightglue import init_lightglue_params
from superslam_tpu_torch.models.weights import load_safetensors
from superslam_tpu_torch.ops import frontend_step

repo = {repo!r}
sp = load_safetensors(os.path.join(repo, "weights", "superpoint_render.safetensors"))
lg = load_safetensors(os.path.join(repo, "weights", "lightglue_synth.safetensors"))
rng = np.random.default_rng(4)
images = torch.from_numpy(rng.integers(0, 256, (2, 64, 96), dtype=np.uint8))
k = 48
kf = (torch.from_numpy(rng.uniform(0, 90, (k, 2)).astype(np.float32)),
      torch.nn.functional.normalize(torch.from_numpy(rng.standard_normal((k, 256)).astype(np.float32)), dim=-1),
      torch.arange(k) < 40)
flags = []
lightglue = frontend_step.lightglue_forward

def spy(*a, **kw):
    flags.append([torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32])
    return lightglue(*a, **kw)

frontend_step.lightglue_forward = spy
out = frontend_step.fused_stereo_step(
    sp, lg, images, *kf, max_keypoints=k, keypoint_threshold=0.005, remove_borders=4,
    nms_radius=4, true_width=96, true_height=64, min_disparity=1.0, match_threshold=0.1)
digest = hashlib.sha1(b"".join(t.contiguous().view(torch.uint8).numpy().tobytes()
                               for t in out)).hexdigest()
print(json.dumps({{"digest": digest, "inside": flags,
                   "after": [torch.backends.cuda.matmul.allow_tf32,
                             torch.backends.cudnn.allow_tf32]}}))
"""


def _step(value):
    env = {**os.environ, "SUPERSLAM_F32_PRECISION": value}
    out = subprocess.run([sys.executable, "-c", STEP.format(repo=REPO)], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def highest_step():
    return _step("highest")


@pytest.mark.parametrize("value", ["high", "tensorfloat32", "bfloat16"])
def test_a_cpu_fused_step_under_a_tf32_mode_is_the_highest_step(highest_step, value):
    """The committed weights on a seeded 96 x 64 pair, K 48, against a
    keyframe: the same output bytes as under ``highest``, with TF32 on in
    the step's body and the flags restored after it."""
    got = _step(value)
    assert highest_step["inside"] == [[False, False]]
    assert got["inside"] == [[True, True]]
    assert got["after"] == highest_step["after"] == [False, True]
    assert got["digest"] == highest_step["digest"]


@pytest.mark.parametrize("value", ["fp64", "bf16", "tf32"])
def test_a_value_without_a_caller_raises_at_import(value):
    """A value that names none of the modes raises, naming it."""
    out = _probe(value)
    assert out.returncode != 0
    assert "ValueError" in out.stderr and f"{value!r}" in out.stderr

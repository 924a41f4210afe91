"""``superslam_tpu_torch/ops/precision.py`` and its ``SUPERSLAM_F32_PRECISION``
override (``superslam_tpu/ops/precision.py``'s kill-switch and highest mode).

The variable is read once, at import, so every case runs in a child
process with the variable set. The TF32 flags are process-wide state that
the CPU build keeps too, so each case reads them before, inside, nested
inside and after ``highest_f32_matmuls()`` there.
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


@pytest.mark.parametrize("value", ["high", "tensorfloat32", "bfloat16", "fp64"])
def test_a_value_without_a_caller_raises_at_import(value):
    """The JAX package's TF32 and bf16 modes have no caller in the port:
    they raise naming the value, as an unknown value does."""
    out = _probe(value)
    assert out.returncode != 0
    assert "ValueError" in out.stderr and f"{value!r}" in out.stderr

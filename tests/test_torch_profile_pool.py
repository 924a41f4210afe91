"""The port's pool profiler (scripts/profile_pool_torch.py) on the CPU at a
tiny shape: the JAX script's nine formulations under its labels, each equal
to F.max_pool2d with its window, and the folded-pool comparison of the conv
pairs. The times are host times of the plain versions and are not checked:
a formulation's device time comes only from a run on the card."""

import math
import re

import pytest
import torch
import torch.nn.functional as F

from scripts import profile_pool_torch as prof

# scripts/profile_pool.py's labels (its results dict).
JAX_LABELS = [
    "reduce_window 2x2 bf16", "reduce_window 2x2 f32", "rw f32-compute bf16 io",
    "reduce_window nhwc bf16", "reduce_window vert only", "reduce_window horiz only",
    "strided slices", "reshape minor max", "vert rw + strided horiz",
]


@pytest.fixture(autouse=True)
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_main_prints_every_formulation_and_the_fold(capsys):
    assert prof.main(["--device", "cpu", "--shape", "1", "4", "8", "8", "--frame", "16", "32"]) == 0
    out = capsys.readouterr().out
    for label in JAX_LABELS:
        (line,) = [ln for ln in out.splitlines() if ln.strip().startswith(label + " ")]
        assert "DIFFERS" not in line
        assert math.isfinite(float(re.search(r"(-?[\d.]+) ms", line).group(1)))
    assert "host ms (CPU run" in out and "device ms" not in out
    assert len(re.findall(r"CIN +(1|64) at .*folding saves", out)) == 2


def test_each_formulation_equals_max_pool2d():
    assert list(prof.FORMULATIONS) == JAX_LABELS
    times, wrong = prof.pool_table((1, 4, 8, 8), torch.device("cpu"))
    assert wrong == [] and list(times) == JAX_LABELS
    x = torch.randn(1, 4, 8, 8).to(torch.bfloat16)
    for label, (fn, form, window) in prof.FORMULATIONS.items():
        t = {"bf16": x, "f32": x.float(),
             "nhwc": x.contiguous(memory_format=torch.channels_last)}[form]
        want = F.max_pool2d(t, window)
        assert torch.equal(fn(t), want), label
        assert want.shape[-2:] == (8 // window[0], 8 // window[1])


def test_a_wrong_formulation_is_reported(monkeypatch, capsys):
    monkeypatch.setitem(prof.FORMULATIONS, "strided slices",
                        (lambda t: F.avg_pool2d(t, 2), "bf16", (2, 2)))
    assert prof.main(["--device", "cpu", "--shape", "1", "4", "8", "8", "--frame", "16", "32"]) == 1
    assert "strided slices" in capsys.readouterr().out.split("results differ")[1]
